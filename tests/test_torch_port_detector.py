"""The port's host Detector (centertrack_tpu_torch/engine/detector.py)
against the JAX package's on the CPU: DLA-34 at dcn_local1 with the
committed assets/selftest_local1_fp16.ckpt weights, a 96x160 input, over
4 JPEG frames of the port's selftest generator, in three configurations
(each compiles JAX's step once): private tracking with greedy matching;
flip_test with nms; keep_res (90x150 frames padded to 96x160) with
zero_pre_hm, zero_tracking and public detections (pre_dets and cur_dets
from the clip's boxes, jittered, some dropped).

Per frame the tracked results must carry the same track ids in the same
order, with ct, bbox and tracking within 1e-3 px and scores within 1e-4
(the warp at float32, warp_precision "highest", as XLA on the CPU runs
it). Also: the fused engine's zero_pre_hm / zero_tracking against JAX's,
flip_merge against JAX's, and the Detector's refusals.
"""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.engine import detector as jdetector
from centertrack_tpu.engine.fused import FusedDetector as JFusedDetector
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.engine import detector
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils import image_io
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
FRAMES = 4
PX_TOL = 1e-3
SCORE_TOL = 1e-4


class Meta:
    num_categories = 1
    default_resolution = [96, 160]
    num_joints = 17
    rest_focal_length = 1200
    flip_idx = []
    mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
    std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)


def _cfgs(**kw):
    args = dict(task="tracking", pre_hm=True, dla_node="dcn_local1",
                max_age=3, warp_precision="highest", **kw)
    return (set_heads(parse_task(Config(**args)), Meta),
            jset_heads(jparse_task(JConfig(**args)), Meta))


@pytest.fixture(scope="module")
def weights():
    return load_jax_ckpt(CKPT)


def _clip(tmp_path_factory, width, height):
    root = str(tmp_path_factory.mktemp(f"clip{width}"))
    ann, img_dir = selftest.make_dataset(root, num_videos=1, frames=FRAMES,
                                         width=width, height=height, seed=3,
                                         hard=True)
    with open(ann) as f:
        data = json.load(f)
    paths = [os.path.join(img_dir, im["file_name"]) for im in data["images"]]
    boxes = [[a["bbox"] for a in data["annotations"] if a["image_id"] ==
              im["id"]] for im in data["images"]]
    return paths, boxes


def _public(boxes, rng):
    """Public detections from the clip's boxes: jittered, 1 in 5 dropped."""
    out = []
    for x, y, w, h in boxes:
        if rng.rand() < 0.2:
            continue
        x1, y1 = x + rng.randn(), y + rng.randn()
        x2, y2 = x + w + rng.randn(), y + h + rng.randn()
        out.append({"bbox": [x1, y1, x2, y2],
                    "ct": [(x1 + x2) / 2, (y1 + y2) / 2],
                    "score": float(rng.uniform(0.5, 1.0)), "class": 1})
    return out


def _compare(got, want):
    assert [d["tracking_id"] for d in got] == [d["tracking_id"]
                                               for d in want]
    for g, w in zip(got, want):
        assert g["active"] == w["active"] and g["age"] == w["age"]
        assert abs(g["score"] - w["score"]) <= SCORE_TOL
        for key in ("ct", "bbox", "tracking"):
            # tracks seeded from pre_dets carry no tracking offset
            assert (key in g) == (key in w), key
            if key not in w:
                continue
            np.testing.assert_allclose(np.asarray(g[key], np.float64),
                                       np.asarray(w[key], np.float64),
                                       atol=PX_TOL, rtol=0, err_msg=key)


def _run_both(cfgs, weights, paths, metas=None, images=False):
    cfg, jcfg = cfgs
    port = detector.Detector(cfg, *weights, Meta, device="cpu")
    ref = jdetector.Detector(jcfg, *weights, Meta)
    n_results = 0
    for f, path in enumerate(paths):
        meta = metas[f] if metas else None
        src = image_io.read(path) if images else path
        got = copy.deepcopy(port.run(src, copy.deepcopy(meta))["results"])
        want = copy.deepcopy(ref.run(src, copy.deepcopy(meta))["results"])
        _compare(got, want)
        n_results += len(got)
    assert n_results >= FRAMES
    return port


def test_detector_private_greedy_matches_jax(weights, tmp_path_factory):
    paths, _ = _clip(tmp_path_factory, 160, 96)
    port = _run_both(_cfgs(), weights, paths)
    # tracks carried over the clip
    assert any(d["active"] > 1 for d in port.tracker.tracks)
    assert port.pre_images.shape == (1, 96, 160, 3)


def test_detector_flip_nms_matches_jax(weights, tmp_path_factory,
                                       monkeypatch):
    paths, _ = _clip(tmp_path_factory, 160, 96)
    kept = []
    nms = detector.batched_nms

    def recording(boxes, scores, classes):
        keep = nms(boxes, scores, classes)
        kept.append(int((~keep).sum()))
        return keep
    monkeypatch.setattr(detector, "batched_nms", recording)
    port = _run_both(_cfgs(flip_test=True, nms=True), weights, paths,
                     images=True)
    assert len(kept) == FRAMES and sum(kept) > 0   # rows were suppressed
    assert port.pre_images.shape == (2, 96, 160, 3)


def test_detector_keep_res_public_zeroed_matches_jax(weights,
                                                     tmp_path_factory):
    paths, boxes = _clip(tmp_path_factory, 150, 90)
    rng = np.random.RandomState(0)
    metas = [{"cur_dets": _public(b, rng)} for b in boxes]
    metas[0]["pre_dets"] = _public(boxes[0], rng)
    cfgs = _cfgs(keep_res=True, zero_pre_hm=True, zero_tracking=True,
                 public_det=True)
    port = _run_both(cfgs, weights, paths, metas)
    # keep_res pads 90x150 to 96x160
    assert port.pre_images.shape == (1, 96, 160, 3)
    assert all(not np.asarray(d.get("tracking", 0)).any()
               for d in port.tracker.tracks if d["active"])


def test_flip_merge_matches_jax():
    rng = np.random.RandomState(1)
    out = {k: rng.randn(2, 6, 8, c).astype(np.float32) for k, c in
           (("hm", 1), ("wh", 2), ("reg", 2), ("tracking", 2),
            ("ltrb_amodal", 4), ("amodel_offset", 2), ("hps", 6),
            ("hm_hp", 3))}
    flip_idx = ((0, 1),)
    got = detector.flip_merge({k: torch.from_numpy(v)
                               for k, v in out.items()}, flip_idx)
    want = jdetector.flip_merge({k: jnp.asarray(v) for k, v in out.items()},
                                flip_idx)
    for k in out:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_fused_zero_flags_match_jax(weights, tmp_path_factory):
    """The fused step reads zero_pre_hm and zero_tracking as JAX's does."""
    cfg, jcfg = _cfgs(zero_pre_hm=True, zero_tracking=True)
    frames = [image_io.read(p) for p in _clip(tmp_path_factory, 160, 96)[0]]
    port = FusedDetector(cfg, *weights, Meta, device="cpu")
    ref = JFusedDetector(jcfg, *weights, dataset_meta=Meta)
    for frame in frames[:2]:
        got = FusedDetector.fetch(port.run(frame), cfg.out_thresh)
        want = JFusedDetector.fetch(ref.run(frame), jcfg.out_thresh)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["tracking_id"] == w["tracking_id"]
            assert abs(g["score"] - w["score"]) <= SCORE_TOL
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-2)
            assert not g["tracking"].any()


def test_detector_refusals(weights):
    cfg, _ = _cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            detector.Detector(cfg, *weights, Meta)
    port = detector.Detector(cfg, *weights, Meta, device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        port.show_results(None, [])
    frame = np.zeros((96, 160, 3), np.uint8)
    port.run(frame)
    keep = detector.Detector(_cfgs(keep_res=True)[0], *weights, Meta,
                             device="cpu")
    keep.run(frame)
    with pytest.raises(ValueError, match="mid-sequence"):
        keep.run(np.zeros((64, 64, 3), np.uint8))
