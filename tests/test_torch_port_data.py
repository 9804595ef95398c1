"""The port's host data pipeline (centertrack_tpu_torch.utils.image_io,
data.coco_api, data.generic, data.datasets, data.loader) and its MOT
evaluation (eval.mot_metrics, eval.mot_eval) against the JAX package
and OpenCV on the CPU.

Tolerances:
- PNG reading: bit for bit with ``cv2.imread`` (JPEG:
  tests/test_torch_port_codec.py);
- the warp: the uint8 result within 1 level of ``cv2.warpAffine``, at
  most 1% of elements differing;
- dataset items: every key but ``image`` and ``pre_img`` exactly; those
  two within 1e-4 where the two warps agree, and within 3/255/min(std)
  (one level through color_aug's largest gain, 1.4^3) at the pixels where
  they differ by a level;
- loader batches: the dataset items' tolerances; the port's batches
  bit for bit across worker counts and kinds;
- MOT metrics: equal (counts exactly, ratios to 1e-12).
"""

import json
import multiprocessing
import os
import struct
import threading
import time
import zlib

import cv2
import numpy as np
import pytest

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import finalize as jfinalize
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.data import coco_api as jcoco_api
from centertrack_tpu.data import datasets as jdatasets
from centertrack_tpu.data import loader as jloader
from centertrack_tpu.eval import mot_eval as jmot_eval
from centertrack_tpu.eval import mot_metrics as jmot_metrics
from centertrack_tpu.ops.affine import get_affine_transform as jaffine
from centertrack_tpu_torch.config import (Config, finalize, parse_task,
                                          set_heads)
from centertrack_tpu_torch.data import coco_api, datasets, generic, loader
from centertrack_tpu_torch.eval import mot_eval, mot_metrics
from centertrack_tpu_torch.utils import image_io

STD_MIN = float(generic.GenericDataset.std.min())
IMAGE_TOL = 1e-4
LEVEL_TOL = 3.0 / 255.0 / STD_MIN


# ---- config -----------------------------------------------------------
@pytest.mark.parametrize("dataset,task", [("mot", "tracking"),
                                          ("coco", "tracking"),
                                          ("coco", "ctdet"),
                                          ("kitti_tracking", "tracking"),
                                          ("crowdhuman", "tracking")])
def test_finalize_matches_jax(dataset, task):
    kw = dict(task=task, dataset=dataset, pre_hm=task == "tracking",
              track_thresh=0.4)
    got, want = finalize(Config(**kw)), jfinalize(JConfig(**kw))
    for field in ("heads", "weights", "input_h", "input_w", "output_h",
                  "output_w", "num_classes", "tracking", "pre_img",
                  "out_thresh", "pre_thresh", "new_thresh", "head_conv"):
        assert getattr(got, field) == getattr(want, field), field
    for field in Config.__dataclass_fields__:
        if field in JConfig.__dataclass_fields__:
            assert (Config.__dataclass_fields__[field].default ==
                    JConfig.__dataclass_fields__[field].default), field


# ---- image I/O --------------------------------------------------------
def _smooth(rng, shape):
    """An image whose rows make cv2's adaptive filter pick Average and
    Paeth as well as None, Sub and Up."""
    base = rng.randint(0, 256, shape).astype(np.float64)
    for axis in (0, 1):
        base = np.cumsum(base, axis=axis)
        base /= np.arange(1, shape[axis] + 1).reshape(
            (-1,) + (1,) * (len(shape) - 1 - axis) if axis == 0 else
            (1, -1) + (1,) * (len(shape) - 2))
    return base.astype(np.uint8)


@pytest.mark.parametrize("kind", ["rgb", "gray", "smooth_rgb",
                                  "smooth_gray", "rgba"])
def test_read_equals_cv2_imread_on_cv2_pngs(kind, tmp_path):
    rng = np.random.RandomState(len(kind))
    shape = {"rgb": (37, 53, 3), "gray": (29, 41), "smooth_rgb": (40, 64, 3),
             "smooth_gray": (33, 47), "rgba": (21, 30, 4)}[kind]
    img = (_smooth(rng, shape) if kind.startswith("smooth")
           else rng.randint(0, 256, shape).astype(np.uint8))
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    got = image_io.read(path)
    assert got.dtype == np.uint8 and got.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(got, cv2.imread(path))


def _png_with_filter(img, kind):
    """An RGB PNG of ``img`` (BGR) whose every row uses filter ``kind``."""
    rgb = img[..., ::-1].reshape(img.shape[0], -1).astype(np.int64)
    bpp = 3
    out = []
    prior = np.zeros(rgb.shape[1], np.int64)
    for row in rgb:
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(np.concatenate([[kind], (row - pred) % 256]))
        prior = row
    raw = np.array(out, np.uint8).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body +
                struct.pack(">I", zlib.crc32(tag + body)))
    return (image_io.PNG_SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1],
                                       img.shape[0], 8, 2, 0, 0, 0)) +
            chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", range(5))
def test_read_undoes_each_filter_type(kind, tmp_path):
    img = np.random.RandomState(kind).randint(0, 256, (19, 23, 3)).astype(
        np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filter(img, kind))
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(image_io.read(path), img)


@pytest.mark.parametrize("shape", [(96, 160, 3), (31, 17, 3), (25, 33)])
def test_own_png_reads_back_in_cv2_and_the_port(shape, tmp_path):
    rng = np.random.RandomState(shape[0])
    img = _smooth(rng, shape)
    img[::3] = rng.randint(0, 256, img[::3].shape)
    path = str(tmp_path / "own.png")
    image_io.write(path, img)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    np.testing.assert_array_equal(cv2.imread(path), want)
    np.testing.assert_array_equal(image_io.read(path), want)


# ---- COCO API ---------------------------------------------------------
def _coco_fixture():
    rng = np.random.RandomState(3)
    images = [{"id": i, "file_name": f"{i}.png", "width": 64, "height": 48}
              for i in (5, 2, 9, 7)]
    anns = []
    for k in range(11):
        x, y = rng.uniform(0, 40, 2)
        anns.append({"id": 100 + k, "image_id": int(rng.choice([5, 2, 9])),
                     "category_id": int(rng.choice([1, 3])),
                     "bbox": [float(x), float(y), 8.0, 6.0]})
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "a"}, {"id": 3, "name": "b"}]}


def test_coco_api_matches_jax(tmp_path):
    path = str(tmp_path / "ann.json")
    with open(path, "w") as f:
        json.dump(_coco_fixture(), f)
    ours, ref = coco_api.COCO(path), jcoco_api.COCO(path)
    assert ours.getImgIds() == ref.getImgIds()
    assert sorted(ours.getImgIds(catIds=[3])) == sorted(
        ref.getImgIds(catIds=[3]))
    assert sorted(ours.getImgIds(imgIds=[2, 7], catIds=[1])) == sorted(
        ref.getImgIds(imgIds=[2, 7], catIds=[1]))
    assert ours.getCatIds() == ref.getCatIds()
    for ids in ([5], [2, 9], 7):
        assert ours.loadImgs(ids) == ref.loadImgs(ids)
        assert ours.getAnnIds(imgIds=ids) == ref.getAnnIds(imgIds=ids)
        assert ours.getAnnIds(imgIds=ids, catIds=1) == ref.getAnnIds(
            imgIds=ids, catIds=1)
    assert ours.getAnnIds() == ref.getAnnIds()
    assert ours.loadAnns(ours.getAnnIds()) == ref.loadAnns(ref.getAnnIds())
    dets = [{"image_id": 5, "category_id": 1, "bbox": [1.0, 2.0, 3.0, 4.0],
             "score": 0.9}, {"image_id": 9, "category_id": 3,
                             "bbox": [0.0, 0.0, 5.0, 5.0], "score": 0.2,
                             "area": 7.0}]
    res, jres = ours.loadRes(dets), ref.loadRes(dets)
    assert res.dataset == jres.dataset
    assert res.getAnnIds(imgIds=[9]) == jres.getAnnIds(imgIds=[9])


# ---- the warp ---------------------------------------------------------
@pytest.mark.parametrize("scale,rot", [(0.6, 0), (0.8, -15), (1.0, 7),
                                       (1.3, 0), (1.1, 12)])
def test_warp_within_one_level_of_cv2(scale, rot):
    rng = np.random.RandomState(int(scale * 10) + rot + 20)
    img = rng.randint(0, 256, (96, 160, 3)).astype(np.uint8)
    c = np.array([80 + rng.randn() * 8, 48 + rng.randn() * 5], np.float32)
    trans = jaffine(c, 160 * scale, rot, [160, 96])
    got = generic.warp_affine(img, trans, 160, 96)
    ref = cv2.warpAffine(img, trans.astype(np.float32), (160, 96),
                         flags=cv2.INTER_LINEAR)
    diff = np.abs(got.astype(np.int32) - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


def test_gray_matches_cv2():
    img = np.random.RandomState(0).rand(17, 29, 3).astype(np.float32)
    np.testing.assert_allclose(generic.bgr_to_gray(img),
                               cv2.cvtColor(img, cv2.COLOR_BGR2GRAY),
                               atol=1e-6, rtol=0)


# ---- datasets ---------------------------------------------------------
H, W = 48, 80


@pytest.fixture(scope="module", params=["png", "jpg"])
def tiny_dataset(request, tmp_path_factory):
    """Two 4-frame videos of boxes at 60x100 written by cv2 as PNG, and
    again as JPEG (cv2.imwrite's defaults, as JAX's own fixtures are
    written), a crowd box and an object leaving the frame."""
    ext = request.param
    root = tmp_path_factory.mktemp("tiny_" + ext)
    rng = np.random.RandomState(11)
    images, anns = [], []
    for v in range(2):
        pos = rng.uniform([0, 0], [80, 45], (4, 2))
        vel = rng.uniform(-6, 6, (4, 2))
        for f in range(4):
            iid = v * 4 + f + 1
            img = rng.randint(150, 230, (60, 100, 3)).astype(np.uint8)
            images.append({"id": iid, "file_name": f"{iid}.{ext}",
                           "width": 100, "height": 60, "video_id": v + 1,
                           "frame_id": f + 1})
            for o in range(4):
                x, y = pos[o] + vel[o] * f
                w, h = 14 + 2 * o, 10 + o
                cv2.rectangle(img, (int(x), int(y)), (int(x + w), int(y + h)),
                              (40 * o, 200 - 30 * o, 90), -1)
                anns.append({"id": len(anns) + 1, "image_id": iid,
                             "category_id": 1, "bbox": [float(x), float(y),
                                                        float(w), float(h)],
                             "iscrowd": int(o == 3 and f == 2),
                             "track_id": o + 1})
            cv2.imwrite(str(root / f"{iid}.{ext}"), img)
    ann = {"images": images, "annotations": anns,
           "videos": [{"id": 1, "file_name": "a"}, {"id": 2, "file_name": "b"}],
           "categories": [{"id": 1, "name": "box"}]}
    with open(root / "ann.json", "w") as f:
        json.dump(ann, f)
    return str(root / "ann.json"), str(root)


AUG = dict(flip=0.5, aug_rot=0.6, rotate=10.0, scale=0.2, shift=0.1,
           hm_disturb=0.05, lost_disturb=0.4, fp_disturb=0.3)
CASES = {
    "train_crop": dict(AUG, same_aug_pre=True),
    "train_jitter": dict(AUG, not_rand_crop=True, same_aug_pre=False),
    "train_jitter_same_pre": dict(AUG, not_rand_crop=True,
                                  same_aug_pre=True, max_frame_dist=2),
    "val": dict(AUG),
}


def _cfgs(paths, **kw):
    ann, img_dir = paths
    kw = {**dict(task="tracking", dataset="custom", pre_hm=True,
                 num_classes=1, input_h=H, input_w=W,
                 custom_dataset_ann_path=ann,
                 custom_dataset_img_path=img_dir), **kw}

    class Meta:
        num_categories = 1
        default_resolution = [H, W]
        num_joints = 17
    return (set_heads(parse_task(Config(**kw)), Meta),
            jset_heads(jparse_task(JConfig(**kw)), Meta))


class _WarpRecorder:
    """Wraps the port's warp: per item index (a thread's current item),
    the inputs and output of each warp call, in call order."""

    def __init__(self, monkeypatch):
        self.calls = {}
        self.local = threading.local()
        warp = generic.warp_affine

        def recorded(img, trans, w, h):
            out = warp(img, trans, w, h)
            self.calls.setdefault(self.local.index, []).append(
                (img.copy(), np.array(trans), out))
            return out
        monkeypatch.setattr(generic, "warp_affine", recorded)

    def wrap_item(self, ds, monkeypatch):
        item = ds.item

        def recorded_item(index, seed):
            self.local.index = index
            return item(index, seed)
        monkeypatch.setattr(ds, "item", recorded_item)

    def masks(self, index):
        """(H, W, 1) masks of the pixels where the port's warp of the
        image and of the previous image differ from cv2's by a level."""
        out = []
        for img, trans, got in self.calls[index]:
            ref = cv2.warpAffine(img, trans.astype(np.float32),
                                 (got.shape[1], got.shape[0]),
                                 flags=cv2.INTER_LINEAR)
            diff = np.abs(got.astype(np.int32) - ref)
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
            out.append((diff > 0).any(axis=2, keepdims=True))
        return out


def _assert_item(got, ref, masks, where=""):
    assert set(got) == set(ref), where
    for k in ref:
        if k in ("image", "pre_img"):
            continue
        assert got[k].dtype == ref[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{where} {k}")
    for k, mask in zip(("image", "pre_img"), masks):
        diff = np.abs(got[k] - ref[k])
        assert diff[~np.broadcast_to(mask, diff.shape)].max(
            initial=0) <= IMAGE_TOL, (where, k)
        assert diff.max() <= LEVEL_TOL, (where, k)


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_item_matches_jax(case, tiny_dataset, monkeypatch):
    cfg, jcfg = _cfgs(tiny_dataset, **CASES[case])
    split = "val" if case == "val" else "train"
    ds = datasets.CustomDataset(cfg, split)
    jds = jdatasets.CustomDataset(jcfg, split)
    rec = _WarpRecorder(monkeypatch)
    n_track = n_pre = 0
    for index in range(len(ds)):
        for s in (3, 1000 + index):
            rec.local.index = (index, s)
            ds.rng = np.random.RandomState(s)
            ds._data_rng = np.random.RandomState(s + 7)
            got = ds[index]
            np.random.seed(s)
            jds._data_rng = np.random.RandomState(s + 7)
            ref = jds[index]
            _assert_item(got, ref, rec.masks((index, s)), f"{case} {index}")
            n_track += int(got["tracking_mask"].sum())
            n_pre += int(got["pre_valid"].sum())
            rec.calls.clear()
    assert n_track > 0 and n_pre > 0


ANN_PATHS = {"coco": "coco/annotations/instances_val2017.json",
             "mot": "mot17/annotations/val_half.json",
             "kitti": "kitti/annotations/kitti_v2_3dop_val.json",
             "kitti_tracking": "kitti_tracking/annotations/tracking_train.json",
             "crowdhuman": "crowdhuman/annotations/val.json"}


@pytest.mark.parametrize("name", list(ANN_PATHS))
def test_dataset_class_builds_as_jax(name, tiny_dataset, tmp_path,
                                     monkeypatch):
    """Each class reads its annotations from its place under
    CENTERTRACK_DATA_DIR as JAX's does; the evaluators not ported raise
    naming ROADMAP A7."""
    ann, _ = tiny_dataset
    path = tmp_path / ANN_PATHS[name]
    path.parent.mkdir(parents=True)
    path.write_text(open(ann).read())
    monkeypatch.setenv("CENTERTRACK_DATA_DIR", str(tmp_path))
    cfg, jcfg = _cfgs(tiny_dataset, dataset=name,
                      dataset_version="17halfval" if name == "mot" else "")
    ds = datasets.get_dataset(name)(cfg, "val")
    jds = jdatasets.get_dataset(name)(jcfg, "val")
    assert type(ds).__name__ == type(jds).__name__
    assert ds.images == jds.images and ds.img_dir == jds.img_dir
    assert ds.video_to_images == jds.video_to_images
    if name != "mot":
        with pytest.raises(NotImplementedError, match="A7"):
            ds.run_eval({}, str(tmp_path))


def test_custom_dataset_and_the_extras(tiny_dataset, tmp_path):
    cfg, _ = _cfgs(tiny_dataset)
    assert datasets.CustomDataset(cfg, "val").run_eval({}, "") is None
    # the ddd and pose datasets give their metas; loading them raises
    for name in ("nuscenes", "coco_hp"):
        with pytest.raises(NotImplementedError, match="A9"):
            datasets.get_dataset(name)(cfg, "val")


def test_mot_save_results_and_run_eval_match_jax(tiny_dataset, tmp_path,
                                                 monkeypatch):
    """MOT's MOTChallenge writer and evaluation on the tiny dataset laid
    out as mot17 (CENTERTRACK_DATA_DIR), results from its own boxes with
    noise, one detection untracked and one inactive."""
    ann, img_dir = tiny_dataset
    root = tmp_path / "data"
    (root / "mot17" / "annotations").mkdir(parents=True)
    with open(ann) as f:
        db = json.load(f)
    with open(root / "mot17" / "annotations" / "val_half.json", "w") as f:
        json.dump(db, f)
    rng = np.random.RandomState(2)
    results = {}
    for video in db["videos"]:
        gt_dir = root / "mot17" / "train" / video["file_name"] / "gt"
        gt_dir.mkdir(parents=True)
        with open(gt_dir / "gt_val_half.txt", "w") as f:
            for a in db["annotations"]:
                im = db["images"][a["image_id"] - 1]
                if im["video_id"] == video["id"]:
                    f.write("{},{},{},{},{},{},1,1,1\n".format(
                        im["frame_id"], a["track_id"], *a["bbox"]))
    for a in db["annotations"]:
        x, y, w, h = np.array(a["bbox"]) + rng.randn(4)
        item = {"bbox": [x, y, x + w, y + h], "active": int(
            rng.rand() > 0.05), "score": 0.9}
        if a["id"] != 7:
            item["tracking_id"] = a["track_id"] + (a["id"] == 12)
        results.setdefault(a["image_id"], []).append(item)
    monkeypatch.setenv("CENTERTRACK_DATA_DIR", str(root))
    cfg, jcfg = _cfgs(tiny_dataset, dataset="mot",
                      dataset_version="17halfval")
    out = {}
    for name, mod, c in (("port", datasets, cfg), ("jax", jdatasets, jcfg)):
        save = tmp_path / name
        save.mkdir()
        np.random.seed(0)
        out[name] = mod.MOT(c, "val").run_eval(results, str(save))
    assert set(out["port"]) == set(out["jax"]) == {"a", "b", "OVERALL"}
    for seq in out["jax"]:
        for k, v in out["jax"][seq].items():
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(out["port"][seq][k])
            else:
                assert out["port"][seq][k] == v, (seq, k)


# ---- loader -----------------------------------------------------------
def test_loader_matches_jax_process_mode(tiny_dataset, monkeypatch):
    """Two shuffled batches of 3 at train_crop: the same items as JAX's
    use_processes=True loader (fork workers), and the port's own batches
    the same with 1 and 3 thread workers and 2 fork workers."""
    cfg, jcfg = _cfgs(tiny_dataset, **CASES["train_crop"])
    jds = jdatasets.CustomDataset(jcfg, "train")
    ref = list(jloader.DataLoader(jds, 3, shuffle=True, num_workers=2,
                                  seed=5, use_processes=True))
    ds = datasets.CustomDataset(cfg, "train")
    rec = _WarpRecorder(monkeypatch)
    rec.wrap_item(ds, monkeypatch)
    runs = {w: list(loader.DataLoader(ds, 3, shuffle=True, num_workers=w,
                                      seed=5)) for w in (1, 3)}
    monkeypatch.undo()
    runs["fork"] = list(loader.DataLoader(ds, 3, shuffle=True, num_workers=2,
                                          seed=5, use_processes=True))
    assert len(ref) == len(runs[1]) == 2
    index_of = {iid: i for i, iid in enumerate(ds.images)}
    for b, (got, want) in enumerate(zip(runs[1], ref)):
        np.testing.assert_array_equal(got["image_id"], want["image_id"])
        for j, iid in enumerate(want["image_id"]):
            _assert_item({k: v[j] for k, v in got.items()},
                         {k: v[j] for k, v in want.items()},
                         rec.masks(index_of[int(iid)]), f"batch {b} {j}")
        for other in (3, "fork"):
            for k in got:
                np.testing.assert_array_equal(runs[other][b][k], got[k],
                                              err_msg=f"{other} {k}")


class _IndexDataset:
    """Items that are their index: enough batches to fill the queue."""

    def __len__(self):
        return 40

    def item(self, idx, seed):
        return {"x": np.full(2, idx)}


@pytest.mark.parametrize("stop", ["break", "raise"])
@pytest.mark.parametrize("use_processes", [False, True],
                         ids=["threads", "fork"])
def test_loader_producer_ends_when_the_consumer_stops(use_processes, stop):
    """The consumer takes one batch, then breaks or raises while the
    producer is blocked handing over a batch to a full queue: once the
    loop is left the producer thread has ended and its workers (fork
    processes too) are shut down."""
    before = set(multiprocessing.active_children())
    dl = loader.DataLoader(_IndexDataset(), 2, num_workers=2, prefetch=1,
                           use_processes=use_processes)

    def consume():
        for batch in dl:
            deadline = time.time() + 30
            # one batch in the queue, the next one built and waiting
            while len(dl.batch_seconds) < 3 and time.time() < deadline:
                time.sleep(0.01)
            assert len(dl.batch_seconds) == 3 and dl.producer.is_alive()
            if stop == "raise":
                raise KeyError("step failed")
            break

    if stop == "raise":
        with pytest.raises(KeyError):
            consume()
    else:
        consume()
    assert not dl.producer.is_alive()
    assert set(multiprocessing.active_children()) <= before


# ---- MOT metrics ------------------------------------------------------
def _sequence(seed, n_frames=25):
    """Ground truth with births and deaths, and hypotheses that miss,
    jitter, add false positives, swap ids and go quiet for some frames
    (fragmentations), with a few empty frames on either side."""
    rng = np.random.RandomState(seed)
    n_gt = rng.randint(3, 8)
    start = rng.randint(0, n_frames // 2, n_gt)
    end = np.minimum(n_frames, start + rng.randint(5, n_frames, n_gt))
    pos = rng.uniform(0, 200, (n_gt, 2))
    vel = rng.uniform(-4, 4, (n_gt, 2))
    frames = []
    hyp_of = {g: 100 + g for g in range(n_gt)}
    for f in range(n_frames):
        gt_ids, gt_boxes, hyp_ids, hyp_boxes = [], [], [], []
        if rng.rand() < 0.08:       # an empty frame
            frames.append((f + 1, [], [], [], []))
            continue
        for g in range(n_gt):
            if not start[g] <= f < end[g]:
                continue
            box = np.r_[pos[g] + vel[g] * f, 20.0, 30.0]
            gt_ids.append(g)
            gt_boxes.append(box)
            if rng.rand() < 0.1:    # a miss
                continue
            if rng.rand() < 0.06:   # an identity switch from here on
                hyp_of[g] = 200 + rng.randint(50)
            hyp_ids.append(hyp_of[g])
            hyp_boxes.append(box + rng.randn(4) * 2.5)
        for _ in range(rng.poisson(0.4)):   # false positives
            hyp_ids.append(300 + rng.randint(100))
            hyp_boxes.append(np.r_[rng.uniform(0, 220, 2), 15.0, 15.0])
        _, keep = np.unique(hyp_ids, return_index=True)
        keep = sorted(keep)
        frames.append((f + 1, gt_ids, np.reshape(gt_boxes, (-1, 4)),
                       [hyp_ids[i] for i in keep],
                       np.reshape(hyp_boxes, (-1, 4))[keep]))
    return frames


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None or (isinstance(v, float) and np.isnan(v)):
            assert got[k] is None or np.isnan(got[k]), k
        elif isinstance(v, float):
            assert abs(got[k] - v) <= 1e-12, k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("seed", range(6))
def test_mot_accumulator_matches_jax(seed):
    seqs = {f"s{i}": _sequence(seed * 10 + i) for i in range(3)}
    accs, jaccs = {}, {}
    for name, frames in seqs.items():
        acc, jacc = mot_metrics.MOTAccumulator(), jmot_metrics.MOTAccumulator()
        for _, gi, gb, hi, hb in frames:
            acc.update(gi, np.reshape(gb, (-1, 4)), hi, np.reshape(hb, (-1, 4)))
            jacc.update(gi, np.reshape(gb, (-1, 4)), hi,
                        np.reshape(hb, (-1, 4)))
            assert acc.prev_frame_match == jacc.prev_frame_match
        accs[name], jaccs[name] = acc, jacc
    per = {k: a.metrics() for k, a in accs.items()}
    jper = {k: a.metrics() for k, a in jaccs.items()}
    for k in per:
        _assert_metrics_equal(per[k], jper[k])
    _assert_metrics_equal(mot_metrics.combine_metrics(per, accs),
                          jmot_metrics.combine_metrics(jper, jaccs))
    total = mot_metrics.combine_metrics(per, accs)
    assert total["num_switches"] > 0 and total["num_false_positives"] > 0


def test_mot_eval_dir_matches_jax(tmp_path):
    gt_root, res_dir = tmp_path / "gt", tmp_path / "res"
    res_dir.mkdir()
    for i in range(3):
        frames = _sequence(40 + i)
        (gt_root / f"seq{i}" / "gt").mkdir(parents=True)
        with open(gt_root / f"seq{i}" / "gt" / "gt.txt", "w") as g, \
                open(res_dir / f"seq{i}.txt", "w") as r:
            for f, gi, gb, hi, hb in frames:
                for t, b in zip(gi, gb):
                    # every 7th row below min_confidence is dropped
                    conf = 0 if (f + t) % 7 == 0 else 1
                    g.write(f"{f},{t},{b[0]:.3f},{b[1]:.3f},{b[2]:.3f},"
                            f"{b[3]:.3f},{conf},1,1\n")
                for t, b in zip(hi, hb):
                    r.write(f"{f},{t},{b[0]:.2f},{b[1]:.2f},{b[2]:.2f},"
                            f"{b[3]:.2f},-1,-1,-1,-1\n")
    (res_dir / "nogt.txt").write_text("1,1,0,0,5,5,-1,-1,-1,-1\n")
    got = mot_eval.evaluate_mot_dir(str(gt_root), str(res_dir))
    want = jmot_eval.evaluate_mot_dir(str(gt_root), str(res_dir))
    assert set(got) == set(want) == {"seq0", "seq1", "seq2", "OVERALL"}
    for k in want:
        _assert_metrics_equal(got[k], want[k])
