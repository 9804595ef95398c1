"""End-to-end self-test of the port: train -> track -> CLEAR-MOT, on a
synthetic tracking dataset written to disk (JAX: tools/selftest.py).

Generates the JAX selftest's dataset (moving coloured boxes with a white
center dot; ``hard=True`` is the discriminative domain of
docs/parity_mota.json) as the same JPEG files, byte for byte, trains DLA-34 from scratch through
the port's data pipeline and ``Trainer`` (optionally saving at an epoch
through ``CheckpointManager`` and resuming into a fresh model and
trainer), tracks every video with ``FusedDetector`` and scores the
active tracks with ``eval/mot_metrics``. The boxes and dots are drawn as
``cv2.rectangle`` and ``cv2.circle`` draw them filled.

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
