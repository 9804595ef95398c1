"""End-to-end self-test of the port: train -> track -> CLEAR-MOT, on a
synthetic tracking dataset written to disk (JAX: tools/selftest.py).

Generates the JAX selftest's dataset (moving coloured boxes with a white
center dot; ``hard=True`` is the discriminative domain of
docs/parity_mota.json) as the same JPEG files, byte for byte, trains DLA-34 from scratch through
the port's data pipeline and ``Trainer`` (optionally saving at an epoch
through ``CheckpointManager`` and resuming into a fresh model and
trainer), tracks every video with ``FusedDetector`` and scores the
active tracks with ``eval/mot_metrics``. The boxes and dots are drawn as
``cv2.rectangle`` and ``cv2.circle`` draw them filled. The clips of the
ddd and pose checkpoints (``make_dataset_ddd``, ``make_dataset_pose``)
are JAX's too; serving them is what the port does with those tasks (their
training is ROADMAP A9c).

Usage (the card by default; ``--device cpu`` on the CPU):
  python -m centertrack_tpu_torch.tools.selftest [--epochs 30]
      [--dla_node dcn] [--hard] [--resume_at 15] [--mota_floor 0.85]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from centertrack_tpu_torch.utils import image_io


def draw_rectangle(img, pt1, pt2, color):
    """``cv2.rectangle(img, pt1, pt2, color, -1)``: the filled box with
    inclusive integer corners, clipped to the image."""
    h, w = img.shape[:2]
    x1, y1 = max(min(pt1[0], pt2[0]), 0), max(min(pt1[1], pt2[1]), 0)
    x2, y2 = min(max(pt1[0], pt2[0]), w - 1), min(max(pt1[1], pt2[1]), h - 1)
    if x1 <= x2 and y1 <= y2:
        img[y1:y2 + 1, x1:x2 + 1] = color


def draw_circle(img, center, radius, color):
    """``cv2.circle(img, center, radius, color, -1)`` (8-connected, no
    shift): OpenCV's midpoint circle, each octant pair filled as
    horizontal spans, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = center

    def span(y, xa, xb):
        xa, xb = max(xa, 0), min(xb, w - 1)
        if 0 <= y < h and xa <= xb:
            img[y, xa:xb + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def make_dataset(root, num_videos=6, frames=24, width=160, height=96,
                 seed=0, scale=1.0, max_objs=3, hard=False):
    """The JAX selftest's dataset, its draws on the same stream: the
    annotations equal JAX's and each ``v{v}_f{f}.jpg`` holds the bytes of
    JAX's ``cv2.imwrite`` (``image_io.write``, quality 95). ``scale`` multiplies object size, velocity and margins; ``hard=True``
    is the discriminative domain (8-12 objects on crossing paths in fixed
    z-order, births and deaths, size drift). Returns (ann_path,
    img_dir)."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations, videos = [], [], []
    img_id = ann_id = 0
    rng = np.random.RandomState(seed)
    for v in range(num_videos):
        videos.append({"id": v + 1, "file_name": f"video{v + 1}"})
        if hard:
            n_obj = rng.randint(8, 13)
            pos = rng.uniform([2 * scale, 2 * scale],
                              [width - 28 * scale, height - 20 * scale],
                              (n_obj, 2))
            vel = rng.uniform(-3.0 * scale, 3.0 * scale, (n_obj, 2))
            size = rng.uniform([8 * scale, 7 * scale],
                               [30 * scale, 24 * scale], (n_obj, 2))
            growth = rng.uniform(-0.015, 0.02, n_obj)
            t_in = np.where(rng.rand(n_obj) < 0.4,
                            rng.randint(0, max(1, frames // 2), n_obj),
                            0)
            t_out = np.where(rng.rand(n_obj) < 0.4,
                             rng.randint(frames // 2, frames, n_obj),
                             frames)
            t_out = np.maximum(t_out, t_in + 4)
        else:
            n_obj = rng.randint(2, max_objs + 1)
            pos = rng.uniform([10 * scale, 10 * scale],
                              [width - 40 * scale, height - 30 * scale],
                              (n_obj, 2))
            vel = rng.uniform(-2.5 * scale, 2.5 * scale, (n_obj, 2))
            size = rng.uniform([16 * scale, 12 * scale],
                               [30 * scale, 22 * scale], (n_obj, 2))
            growth = np.zeros(n_obj)
            t_in = np.zeros(n_obj, int)
            t_out = np.full(n_obj, frames)
        colors = rng.randint(40, 220, (n_obj, 3))
        for f in range(frames):
            img_id += 1
            fn = f"v{v + 1}_f{f + 1}.jpg"
            img = rng.randint(180, 220, (height, width, 3), np.uint8)
            images.append({
                "id": img_id, "file_name": fn, "width": width,
                "height": height, "video_id": v + 1, "frame_id": f + 1,
            })
            # fixed z-order: later objects draw on top (occluders)
            for o in range(n_obj):
                if not (t_in[o] <= f < t_out[o]):
                    continue
                x, y = pos[o] + vel[o] * (f - t_in[o])
                g = 1.0 + growth[o] * (f - t_in[o])
                w, h = size[o] * g
                x = float(np.clip(x, 0, width - w))
                y = float(np.clip(y, 0, height - h))
                draw_rectangle(img, (int(x), int(y)),
                               (int(x + w), int(y + h)),
                               tuple(int(c) for c in colors[o]))
                draw_circle(img, (int(x + w / 2), int(y + h / 2)),
                            max(2, int(round(3 * scale))), (255, 255, 255))
                ann_id += 1
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": 1,
                    "bbox": [x, y, float(w), float(h)],
                    "area": float(w * h), "iscrowd": 0,
                    "track_id": o + 1,
                })
            image_io.write(os.path.join(img_dir, fn), img)
    ann = {"images": images, "annotations": annotations,
           "videos": videos,
           "categories": [{"id": 1, "name": "box"}]}
    ann_path = os.path.join(root, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return ann_path, img_dir


def make_dataset_ddd(root, num_videos=6, frames=24, width=1600,
                     height=900, focal=1200.0, seed=0, max_objs=8):
    """The JAX selftest's monocular-3D clip (its tools/selftest.py:
    122-228), its draws on the same stream: car-like cuboids on the
    ground plane seen by a pinhole camera at the image centre (the
    nuScenes camera's 1600x900), drawn far to near as filled silhouettes
    (``utils/draw``, OpenCV's hull and convex fill), the +l/2 face
    brightened, a white dot at the projected 3D centre. Annotations hold
    bbox, depth, dim, rotation_y, alpha and amodel_center; the JPEGs are
    JAX's bytes. Returns (ann_path, img_dir)."""
    from centertrack_tpu_torch.utils.ddd import (compute_box_3d,
                                                 project_to_image,
                                                 rot_y2alpha)
    from centertrack_tpu_torch.utils.draw import (convex_hull,
                                                  fill_convex_poly)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    calib = np.array([[focal, 0, width / 2, 0],
                      [0, focal, height / 2, 0],
                      [0, 0, 1, 0]], np.float32)
    images, annotations, videos = [], [], []
    img_id = ann_id = 0
    rng = np.random.RandomState(seed)
    for v in range(num_videos):
        videos.append({"id": v + 1, "file_name": f"video{v + 1}"})
        n_obj = rng.randint(4, max_objs + 1)
        # ground-plane states: x lateral [m], z forward [m], yaw
        x = rng.uniform(-14, 14, n_obj)
        z = rng.uniform(10, 45, n_obj)
        yaw = rng.uniform(-np.pi, np.pi, n_obj)
        vx = rng.uniform(-0.5, 0.5, n_obj)
        vz = rng.uniform(-0.8, 0.8, n_obj)
        dims = np.stack([rng.uniform(1.4, 1.8, n_obj),      # h
                         rng.uniform(1.6, 2.0, n_obj),      # w
                         rng.uniform(3.6, 4.8, n_obj)], 1)  # l
        colors = rng.randint(40, 200, (n_obj, 3))
        for f in range(frames):
            img_id += 1
            fn = f"v{v + 1}_f{f + 1}.jpg"
            img = rng.randint(180, 220, (height, width, 3), np.uint8)
            images.append({
                "id": img_id, "file_name": fn, "width": width,
                "height": height, "video_id": v + 1, "frame_id": f + 1,
                "calib": calib.tolist(),
            })
            xf = x + vx * f
            zf = np.clip(z + vz * f, 6.0, 60.0)
            for o in np.argsort(-zf):      # painter's order: far first
                loc = np.array([xf[o], 1.5, zf[o]], np.float32)
                pts = project_to_image(compute_box_3d(dims[o], loc, yaw[o]),
                                       calib)
                # the silhouette, then the front (+l/2) face
                fill_convex_poly(img, convex_hull(pts.astype(np.int32)),
                                 tuple(int(c) for c in colors[o]))
                front = pts[[0, 1, 5, 4]].astype(np.int32)
                fill_convex_poly(img, convex_hull(front), tuple(
                    int(min(255, c + 60)) for c in colors[o]))
                # the 3D box centre (loc is the bottom face's centre)
                center3d = np.array(
                    [loc[0], loc[1] - dims[o][0] / 2, loc[2]], np.float32)
                amodel_ct = project_to_image(center3d[None], calib)[0]
                ix = int(round(amodel_ct[0]))
                iy = int(round(amodel_ct[1]))
                if 0 <= ix < width and 0 <= iy < height:
                    draw_circle(img, (ix, iy), 4, (255, 255, 255))
                x1, y1 = pts.min(axis=0)
                x2, y2 = pts.max(axis=0)
                bx1 = float(np.clip(x1, 0, width - 1))
                by1 = float(np.clip(y1, 0, height - 1))
                bx2 = float(np.clip(x2, 0, width - 1))
                by2 = float(np.clip(y2, 0, height - 1))
                if bx2 - bx1 < 6 or by2 - by1 < 6:
                    continue
                ann_id += 1
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": 1,
                    "bbox": [bx1, by1, bx2 - bx1, by2 - by1],
                    "area": float((bx2 - bx1) * (by2 - by1)),
                    "iscrowd": 0, "track_id": int(o) + 1,
                    "depth": float(zf[o]),
                    "dim": [float(d) for d in dims[o]],
                    "rotation_y": float(yaw[o]),
                    "alpha": float(rot_y2alpha(
                        yaw[o], amodel_ct[0], calib[0, 2], calib[0, 0])),
                    "amodel_center": [float(amodel_ct[0]),
                                      float(amodel_ct[1])],
                })
            image_io.write(os.path.join(img_dir, fn), img)
    ann = {"images": images, "annotations": annotations,
           "videos": videos,
           "categories": [{"id": 1, "name": "car"}]}
    ann_path = os.path.join(root, "annotations_ddd.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return ann_path, img_dir


# 17 COCO joints at fixed fractions (x, y) of a person's box: nose,
# eyes, ears, shoulders, elbows, wrists, hips, knees, ankles (JAX
# tools/selftest.py:231-242)
POSE_LAYOUT = np.array([
    [0.50, 0.08], [0.42, 0.05], [0.58, 0.05], [0.35, 0.07],
    [0.65, 0.07], [0.30, 0.20], [0.70, 0.20], [0.20, 0.38],
    [0.80, 0.38], [0.15, 0.55], [0.85, 0.55], [0.35, 0.55],
    [0.65, 0.55], [0.35, 0.75], [0.65, 0.75], [0.35, 0.95],
    [0.65, 0.95]], np.float32)

# a fixed BGR colour per joint
POSE_COLORS = [(int(40 + 210 * ((j * 5) % 17) / 16),
                int(40 + 210 * ((j * 7) % 17) / 16),
                int(40 + 210 * ((j * 11) % 17) / 16))
               for j in range(17)]


def make_dataset_pose(root, num_videos=6, frames=24, width=1280,
                      height=720, seed=0, max_objs=5):
    """The JAX selftest's pose clip (its tools/selftest.py:251-304), its
    draws on the same stream: moving 'mannequins', filled rectangles
    with a dot of its own colour at each of 17 joints (POSE_LAYOUT),
    annotated with COCO keypoints [x, y, 2] * 17 and track ids; the
    JPEGs are JAX's bytes. Returns (ann_path, img_dir)."""
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations, videos = [], [], []
    img_id = ann_id = 0
    rng = np.random.RandomState(seed)
    for v in range(num_videos):
        videos.append({"id": v + 1, "file_name": f"video{v + 1}"})
        n_obj = rng.randint(2, max_objs + 1)
        hgt = rng.uniform(110, 220, n_obj)          # person height px
        wdt = hgt * rng.uniform(0.38, 0.5, n_obj)
        px = np.array([rng.uniform(10, width - w - 10) for w in wdt])
        py = np.array([rng.uniform(10, height - h - 10) for h in hgt])
        pos = np.stack([px, py], axis=1)
        vel = rng.uniform(-5, 5, (n_obj, 2))
        colors = rng.randint(60, 200, (n_obj, 3))
        for f in range(frames):
            img_id += 1
            fn = f"v{v + 1}_f{f + 1}.jpg"
            img = rng.randint(180, 220, (height, width, 3), np.uint8)
            images.append({
                "id": img_id, "file_name": fn, "width": width,
                "height": height, "video_id": v + 1, "frame_id": f + 1,
            })
            for o in range(n_obj):
                x, y = pos[o] + vel[o] * f
                w, h = wdt[o], hgt[o]
                x = float(np.clip(x, 0, width - w))
                y = float(np.clip(y, 0, height - h))
                draw_rectangle(img, (int(x), int(y)),
                               (int(x + w), int(y + h)),
                               tuple(int(c) for c in colors[o]))
                kps = []
                for j in range(17):
                    jx = x + POSE_LAYOUT[j, 0] * w
                    jy = y + POSE_LAYOUT[j, 1] * h
                    draw_circle(img, (int(jx), int(jy)), 4, POSE_COLORS[j])
                    kps += [float(jx), float(jy), 2]
                ann_id += 1
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": 1,
                    "bbox": [x, y, float(w), float(h)],
                    "area": float(w * h), "iscrowd": 0,
                    "track_id": o + 1, "keypoints": kps,
                    "num_keypoints": 17,
                })
            image_io.write(os.path.join(img_dir, fn), img)
    ann = {"images": images, "annotations": annotations,
           "videos": videos,
           "categories": [{"id": 1, "name": "person"}]}
    ann_path = os.path.join(root, "annotations_pose.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return ann_path, img_dir


def build_cfg(ann_path: str, img_dir: str, dla_node: str = "dcn_local",
              compute_dtype: str = "float32", batch_size: int = 8,
              lr: float = 5e-4, epochs: int = 30, input_h: int = 96,
              input_w: int = 160, task: str = "tracking",
              num_classes: int = 1, lr_step=(60,), seed: int = 317,
              num_workers: int = 4, process_workers: bool = False):
    """The JAX selftest's configuration (its tools/selftest.py:306), with
    the loader's workers."""
    from centertrack_tpu_torch.config import Config, parse_task, set_heads

    cfg = Config(
        task=task, dataset="custom", pre_hm=True,
        custom_dataset_ann_path=ann_path, custom_dataset_img_path=img_dir,
        num_classes=num_classes, input_h=input_h, input_w=input_w,
        dla_node=dla_node, compute_dtype=compute_dtype,
        batch_size=batch_size, lr=lr, lr_step=tuple(lr_step), seed=seed,
        hm_disturb=0.05, lost_disturb=0.4, fp_disturb=0.1,
        same_aug_pre=True, not_rand_crop=True, flip=0.0,
        track_thresh=0.3, new_thresh=0.3, max_age=3,
        num_epochs=epochs, num_workers=num_workers,
        process_workers=process_workers)
    cfg = parse_task(cfg)
    return set_heads(cfg, type("M", (), {
        "num_categories": 1, "default_resolution": (input_h, input_w),
        "num_joints": 17}))


def train(cfg, log=print, device="cuda", resume_at=None, ckpt_dir=None):
    """Train the selftest model through the port's ``CustomDataset``,
    ``DataLoader`` (``cfg.num_workers``, threads or, with
    ``cfg.process_workers``, fork processes) and ``Trainer`` to epoch
    ``cfg.num_epochs``; returns (model, info).

    The run starts where ``Trainer.start`` puts it (``cfg.load_backbone``,
    ``cfg.load_model``, ``cfg.resume`` over ``ckpt_dir``), else at epoch
    1. ``resume_at=E``: after epoch E the run is saved through
    ``CheckpointManager`` into ``ckpt_dir``, and a fresh model and
    ``Trainer`` resume from the manager, optimizer state included, and go
    on; the loader is kept. ``info``: seconds, the loader's ms per batch
    (its producer's wall time), the ms a step waited for its batch and
    spent in ``train_step``, steps, the resume's epoch and the last
    epoch's stats."""
    from centertrack_tpu_torch.data.datasets import CustomDataset
    from centertrack_tpu_torch.data.loader import DataLoader
    from centertrack_tpu_torch.engine.checkpoint import CheckpointManager
    from centertrack_tpu_torch.engine.trainer import Trainer
    from centertrack_tpu_torch.models.model import create_model

    trainer = Trainer(cfg, create_model(cfg, device), device)
    start = trainer.start(ckpt_dir or "")
    loader = DataLoader(CustomDataset(cfg, "train"), cfg.batch_size,
                        shuffle=True, num_workers=cfg.num_workers,
                        seed=cfg.seed, use_processes=cfg.process_workers)
    batch_s, wait_s, step_s, iters = [], [], [], []
    stats = {}
    t0 = time.perf_counter()

    def on_epoch(epoch, s):
        nonlocal stats
        stats = s
        batch_s.extend(loader.batch_seconds)
        wait_s.append(trainer.epoch_times["data_s"])
        step_s.append(trainer.epoch_times["step_s"])
        iters.append(trainer.epoch_times["iters"])
        if epoch % 5 == 0 or epoch == 1:
            log(f"epoch {epoch}: tot {s['tot']:.4f} hm {s.get('hm', 0):.4f}")

    if resume_at is not None and start < resume_at < cfg.num_epochs:
        trainer.fit(loader, resume_at, start, on_epoch, log_every=1000)
        manager = CheckpointManager(
            ckpt_dir or tempfile.mkdtemp(prefix="ct_selftest_ckpt_"),
            max_to_keep=2)
        manager.save(resume_at, trainer.model, trainer.optimizer,
                     trainer.steps)
        trainer = Trainer(cfg, create_model(cfg, device), device)
        start = trainer.resume(manager, resume_at)
        manager.close()
        log(f"resumed at epoch {start} (step {trainer.steps}) from "
            f"{manager.path(resume_at)}")
    else:
        resume_at = None
    trainer.fit(loader, cfg.num_epochs, start, on_epoch, log_every=1000)
    n = max(sum(iters), 1)
    info = {"seconds": time.perf_counter() - t0, "steps": trainer.steps,
            "loader_ms_per_batch": 1e3 * float(np.mean(batch_s))
            if batch_s else None,
            "wait_ms_per_step": 1e3 * sum(wait_s) / n,
            "step_ms": 1e3 * sum(step_s) / n,
            "resumed_at": resume_at, "last_epoch": stats}
    return trainer.model, info


def selftest_meta(cfg):
    """The selftest dataset's meta as FusedDetector reads it."""
    from centertrack_tpu_torch.data.datasets import CustomDataset

    class Meta:
        num_categories = 1
        default_resolution = (cfg.input_h, cfg.input_w)
        mean = CustomDataset.mean.reshape(3)
        std = CustomDataset.std.reshape(3)

    return Meta


def evaluate(cfg, params, batch_stats, ann_path: str, img_dir: str,
             log=print, device="cuda", detector=None, rows=None):
    """Track every video with ``FusedDetector`` (``reset_tracking`` at
    each video) and CLEAR-MOT score the active tracks; ``params`` and
    ``batch_stats`` are JAX-layout trees (``params_to_jax`` of a model),
    or ``detector`` an existing FusedDetector to use instead. Each
    frame's packed (K, 13) rows are appended to the list ``rows`` where
    one is given. Returns the overall metrics dict."""
    from centertrack_tpu_torch.engine.fused import FusedDetector
    from centertrack_tpu_torch.eval.mot_metrics import (MOTAccumulator,
                                                        combine_metrics)

    det = detector or FusedDetector(cfg, params, batch_stats,
                                    selftest_meta(cfg), device=device)
    with open(ann_path) as f:
        db = json.load(f)
    by_video = {}
    for im in db["images"]:
        by_video.setdefault(im["video_id"], []).append(im)
    gt_by_image = {}
    for a in db["annotations"]:
        gt_by_image.setdefault(a["image_id"], []).append(a)

    accs, summaries = {}, {}
    for vid, ims in sorted(by_video.items()):
        det.reset_tracking()
        acc = MOTAccumulator()
        for im in sorted(ims, key=lambda x: x["frame_id"]):
            frame = image_io.read(os.path.join(img_dir, im["file_name"]))
            packed = det.run(frame)
            if rows is not None:
                rows.append(packed.cpu().numpy().copy())
            hyp_ids, hyp_boxes = [], []
            for r in FusedDetector.fetch(packed, cfg.out_thresh):
                if r["active"] == 0:
                    continue
                b = r["bbox"]
                hyp_ids.append(r["tracking_id"])
                hyp_boxes.append([b[0], b[1], b[2] - b[0], b[3] - b[1]])
            gts = gt_by_image.get(im["id"], [])
            acc.update([g["track_id"] for g in gts],
                       np.array([g["bbox"] for g in gts]).reshape(-1, 4),
                       hyp_ids, np.array(hyp_boxes).reshape(-1, 4))
        accs[f"video{vid}"] = acc
        summaries[f"video{vid}"] = acc.metrics()
        m = summaries[f"video{vid}"]
        log(f"video{vid}: MOTA {m['mota']:.3f} IDF1 {m['idf1']:.3f} "
            f"FP {m['num_false_positives']} FN {m['num_misses']} "
            f"IDSW {m['num_switches']}")
    overall = combine_metrics(summaries, accs)
    log(f"OVERALL: MOTA {overall['mota']:.3f} "
        f"IDF1 {overall['idf1']:.3f}")
    return overall


def main(argv=None):
    from centertrack_tpu_torch.models.model import params_to_jax, save_model

    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--dla_node", default="dcn_local")
    p.add_argument("--compute_dtype", default="float32")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--root", default="")
    p.add_argument("--save_ckpt", default="",
                   help="save the trained checkpoint here")
    p.add_argument("--mota_floor", type=float, default=-10.0,
                   help="exit nonzero if OVERALL MOTA below this")
    p.add_argument("--device", default="cuda")
    p.add_argument("--hard", action="store_true",
                   help="the discriminative domain of docs/parity_mota.json")
    p.add_argument("--num_videos", type=int, default=6)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--resume_at", type=int, default=None,
                   help="save after this epoch and resume into a fresh "
                        "model and trainer")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--process_workers", action="store_true",
                   help="fork loader workers instead of threads")
    args = p.parse_args(argv)

    root = args.root or tempfile.mkdtemp(prefix="ct_selftest_")
    ann_path, img_dir = make_dataset(root, args.num_videos, args.frames,
                                     hard=args.hard)
    print(f"dataset at {root}")

    cfg = build_cfg(ann_path, img_dir, args.dla_node,
                    args.compute_dtype, args.batch_size, args.lr,
                    args.epochs, num_workers=args.num_workers,
                    process_workers=args.process_workers)
    model, info = train(cfg, device=args.device, resume_at=args.resume_at,
                        ckpt_dir=os.path.join(root, "ckpt"))
    if args.save_ckpt:
        save_model(args.save_ckpt, args.epochs, model)
        print(f"saved {args.save_ckpt}")
    overall = evaluate(cfg, *params_to_jax(model), ann_path, img_dir,
                       device=args.device)
    if overall["mota"] < args.mota_floor:
        raise SystemExit(1)
    return overall


if __name__ == "__main__":
    main()
