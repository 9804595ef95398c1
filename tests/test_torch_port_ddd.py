"""Monocular 3D tracking (tracking,ddd) in the port against the JAX
package on the CPU: set_heads, utils/ddd, the ddd decode at 10 classes
(ties across classes), the post-process's lift, FusedDetector,
run_chunk, MultiStreamDetector and set_calib, the host Detector, the
selftest's ddd clip (annotations and JPEG bytes) and its OpenCV
drawing, and the refusals of what is not ported (training, loading
nuScenes).

The serving tests run the committed assets/selftest_ddd_fp16.ckpt at
dla_node dcn_local1 and a 96x160 input over 3 frames of the held-out
clip (1600x900, seed 99). Rows above out_thresh: scores within 1e-4,
boxes and centres within 1e-2 px, ids a bijection, the 3D columns within
1e-4 and one part in 1e6 (angles modulo 2 pi).
"""

import copy
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tasks as tt
from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.engine import detector as jdetector
from centertrack_tpu.engine import post_process as jpost
from centertrack_tpu.engine.fused import FusedDetector as JFusedDetector
from centertrack_tpu.ops import decode as jdecode
from centertrack_tpu.tools import selftest as jselftest
from centertrack_tpu.utils import ddd as jddd
from centertrack_tpu_torch.cli import main as cli_main
from centertrack_tpu_torch.cli import test as cli_test
from centertrack_tpu_torch.config import Config, set_heads
from centertrack_tpu_torch.data import datasets
from centertrack_tpu_torch.data.registry import get_dataset_meta
from centertrack_tpu_torch.engine import detector, post_process
from centertrack_tpu_torch.engine.fused import (FusedDetector,
                                                MultiStreamDetector)
from centertrack_tpu_torch.ops import decode
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils import ddd, draw
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

HW = (96, 160)
DDD_EXTRAS = ("dep", "alpha", "dim", "loc", "rot_y")
DDD_KEYS = {"score", "class", "ct", "tracking", "bbox", "tracking_id", "age",
            "active", *DDD_EXTRAS}


@pytest.fixture(scope="module")
def weights():
    return load_jax_ckpt(tt.ckpt("ddd"))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return tt.clip("ddd", str(tmp_path_factory.mktemp("ddd")))


@pytest.fixture(scope="module")
def jax_rows(weights, clip):
    """JAX's FusedDetector over the clip: fetch_full per frame, then one
    more frame after set_calib with another camera."""
    _, jcfg = tt.cfgs("ddd", HW)
    jdet = JFusedDetector(jcfg, *weights, dataset_meta=tt.meta("ddd", HW))
    frames = clip[0]
    rows = [jdet.fetch_full(jdet.run(f), jcfg.out_thresh) for f in frames]
    jdet.set_calib(_other_calib())
    rows.append(jdet.fetch_full(jdet.run(frames[0]), jcfg.out_thresh))
    return rows


def _other_calib():
    return np.array([[900.0, 0, 780, 5], [0, 950.0, 470, -3], [0, 0, 1, 0.5]],
                    np.float32)


# ---- config ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"nuscenes_att": True}, {"velocity": True},
    {"nuscenes_att": True, "velocity": True, "velocity_weight": 0.5},
    {"dep_weight": 0.0}, {"rot_weight": 0.0, "amodel_offset_weight": 2.0},
    {"dim_weight": 0.0, "nuscenes_att": True, "nuscenes_att_weight": 0.0}])
@pytest.mark.parametrize("task", ["tracking,ddd", "ddd"])
def test_set_heads_matches_jax(task, kw):
    m = get_dataset_meta("nuscenes")
    cfg = set_heads(Config(task=task, **kw), m)
    jcfg = jset_heads(JConfig(task=task, **kw), m)
    assert cfg.heads == jcfg.heads and cfg.weights == jcfg.weights
    assert (cfg.input_h, cfg.input_w) == (448, 800)
    assert (cfg.num_classes, cfg.output_h, cfg.output_w) == (
        jcfg.num_classes, jcfg.output_h, jcfg.output_w)


def test_nuscenes_meta_matches_jax():
    from centertrack_tpu.data.registry import get_dataset_meta as jmeta
    m, j = get_dataset_meta("nuscenes"), jmeta("nuscenes")
    for key in ("num_categories", "default_resolution", "num_joints",
                "flip_idx", "rest_focal_length", "focal_length",
                "class_name", "cat_ids", "max_objs"):
        assert getattr(m, key) == getattr(j, key), key
    np.testing.assert_array_equal(np.asarray(m.mean).ravel(),
                                  np.asarray(j.mean).ravel())
    np.testing.assert_array_equal(np.asarray(m.std).ravel(),
                                  np.asarray(j.std).ravel())


# ---- utils/ddd ------------------------------------------------------------

def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5,
                               atol=1e-5)


def test_ddd_utils_match_jax():
    rng = np.random.RandomState(0)
    calib = np.array([[1200, 0, 800, 10], [0, 1180, 450, -5], [0, 0, 1, 0.2]],
                     np.float32)
    for _ in range(20):
        dim = rng.uniform(1, 5, 3).astype(np.float32)
        loc = np.array([rng.uniform(-10, 10), rng.uniform(0, 2),
                        rng.uniform(5, 60)], np.float32)
        yaw = float(rng.uniform(-4, 4))
        pts = rng.uniform(0, 1600, (6, 3)).astype(np.float32)
        pt, depth = rng.uniform(0, 1600, 2), float(rng.uniform(1, 60))
        for got, want in (
                (ddd.compute_box_3d(dim, loc, yaw),
                 jddd.compute_box_3d(dim, loc, yaw)),
                (ddd.project_to_image(pts, calib),
                 jddd.project_to_image(pts, calib)),
                (ddd.unproject_2d_to_3d(pt, depth, calib),
                 jddd.unproject_2d_to_3d(pt, depth, calib)),
                (ddd.alpha2rot_y(yaw, pt[0], 800, 1200),
                 jddd.alpha2rot_y(yaw, pt[0], 800, 1200)),
                (ddd.rot_y2alpha(yaw, pt[0], 800, 1200),
                 jddd.rot_y2alpha(yaw, pt[0], 800, 1200)),
                (ddd.ddd2locrot(pt, yaw, dim, depth, calib),
                 jddd.ddd2locrot(pt, yaw, dim, depth, calib)),
                (ddd.project_3d_bbox(loc, dim, yaw, calib),
                 jddd.project_3d_bbox(loc, dim, yaw, calib))):
            _same(got, want)
    c = rng.uniform(0, 1600, (30, 2))
    a = rng.uniform(-4, 4, 30)
    dims = rng.uniform(1, 5, (30, 3))
    deps = rng.uniform(1, 60, 30)
    _same(ddd.ddd2locrot_batch(c, a, dims, deps, calib),
          jddd.ddd2locrot_batch(c, a, dims, deps, calib))


# ---- decode and post-process ---------------------------------------------

def _ddd_maps(rng, b=2, h=24, w=40, c=10):
    """Head maps with many exact ties: the hm logits take 6 values, so
    peaks of different classes share scores."""
    hm = rng.choice(np.float32([-4, -2, -1, 0.5, 1.5, 3]), (b, h, w, c))
    out = {"hm": hm.astype(np.float32)}
    for head, ch in (("reg", 2), ("wh", 2), ("tracking", 2), ("dep", 1),
                     ("rot", 8), ("dim", 3), ("amodel_offset", 2),
                     ("nuscenes_att", 8), ("velocity", 3)):
        out[head] = rng.randn(b, h, w, ch).astype(np.float32)
    out["dep"][0, 0, :4, 0] = [-30.0, 30.0, 0.0, -13.8]   # steep ends
    return out


@pytest.mark.parametrize("seed", range(3))
def test_decode_ddd_matches_jax_with_ties_across_classes(seed):
    maps = _ddd_maps(np.random.RandomState(seed))
    got = decode.generic_decode(decode.sigmoid_output(
        {k: torch.from_numpy(v) for k, v in maps.items()}, 2.0), 50, 10)
    want = jdecode.generic_decode(jdecode.sigmoid_output(
        {k: jnp.asarray(v) for k, v in maps.items()}, 2.0), 50, 10)
    assert set(got) == set(want)
    for key in ("inds", "clses"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), key)
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # ties across classes were met
    s = np.asarray(want["scores"])
    assert (np.diff(s, axis=1) == 0).sum() > 10


def test_sigmoid_output_depth_matches_jax():
    x = np.linspace(-16, 16, 257, dtype=np.float32).reshape(1, 1, 257, 1)
    for scale in (1.0, 0.5):
        got = decode.sigmoid_output({"hm": torch.zeros(1, 1, 1, 1),
                                     "dep": torch.from_numpy(x)}, scale)
        want = jdecode.sigmoid_output({"hm": jnp.zeros((1, 1, 1, 1)),
                                       "dep": jnp.asarray(x)}, scale)
        np.testing.assert_allclose(got["dep"].numpy(),
                                   np.asarray(want["dep"]), rtol=1e-5,
                                   atol=1e-5)


def _ddd_dets(rng, b=2, k=40, amodel=True):
    dets = {"scores": -np.sort(-rng.rand(b, k).astype(np.float32), 1),
            "clses": rng.randint(0, 10, (b, k)).astype(np.float32),
            "cts": rng.uniform(0, 40, (b, k, 2)).astype(np.float32),
            "tracking": rng.randn(b, k, 2).astype(np.float32),
            "bboxes": np.sort(rng.uniform(0, 40, (b, k, 2, 2)), 2).reshape(
                b, k, 4).astype(np.float32),
            "dep": rng.uniform(1, 60, (b, k, 1)).astype(np.float32),
            "rot": rng.randn(b, k, 8).astype(np.float32),
            "dim": rng.uniform(1, 5, (b, k, 3)).astype(np.float32),
            "nuscenes_att": rng.randn(b, k, 8).astype(np.float32),
            "velocity": rng.randn(b, k, 3).astype(np.float32)}
    if amodel:
        dets["amodel_offset"] = rng.randn(b, k, 2).astype(np.float32)
    return dets


@pytest.mark.parametrize("amodel", [True, False])
def test_post_process_ddd_matches_jax(amodel):
    cfg, jcfg = tt.cfgs("ddd", HW)
    dets = _ddd_dets(np.random.RandomState(int(amodel)), amodel=amodel)
    c = [np.float32([800, 450]), np.float32([640, 360])]
    s = [1600.0, 1280.0]
    calibs = [np.array([[1200, 0, 800, 0], [0, 1200, 450, 0], [0, 0, 1, 0]],
                       np.float32), _other_calib()]
    got = post_process.generic_post_process(cfg, dets, c, s, 24, 40, calibs)
    want = jpost.generic_post_process(jcfg, dets, c, s, 24, 40, calibs)
    assert sum(map(len, got)) > 20
    for gi, wi in zip(got, want):
        assert len(gi) == len(wi)
        for g, w in zip(gi, wi):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_allclose(
                    np.asarray(g[key], np.float64),
                    np.asarray(w[key], np.float64), rtol=1e-5, atol=1e-5,
                    err_msg=key)


# ---- the serving engines --------------------------------------------------

def test_fused_ddd_matches_jax_and_set_calib(weights, clip, jax_rows):
    """FusedDetector.fetch_full against JAX's over the clip, then one
    frame after set_calib with another camera: loc moves as JAX's does."""
    cfg, _ = tt.cfgs("ddd", HW)
    det = FusedDetector(cfg, *weights, tt.meta("ddd", HW), device="cpu")
    assert det.width == 13 + 11
    id_map, n = {}, 0
    got = []
    for f in clip[0]:
        packed = det.run(f)
        assert packed.shape == (cfg.K, 24)
        got.append(det.fetch_full(packed, cfg.out_thresh))
    det.set_calib(_other_calib())
    got.append(det.fetch_full(det.run(clip[0][0]), cfg.out_thresh))
    for g, w in zip(got, jax_rows):
        n += tt.compare_rows(g, w, id_map, DDD_EXTRAS)
    assert n >= 6 and len(set(id_map.values())) == len(id_map)
    # the new camera was read: the same detections as frame 0's, lifted
    # elsewhere
    locs0 = np.array([r["loc"] for r in got[0]])
    locs3 = np.array([r["loc"] for r in got[3]])
    assert got[3] and not np.allclose(locs0[:len(locs3)], locs3)
    assert all(set(r) == DDD_KEYS for frame in got for r in frame)
    # 'ct' is the amodal centre (packed columns 22-23), not the peak's
    packed = det.run(clip[0][1]).numpy()
    live = packed[(packed[:, 0] > cfg.out_thresh) & (packed[:, 10] > 0)]
    items = det.fetch_full(torch.from_numpy(packed), cfg.out_thresh)
    np.testing.assert_array_equal(items[0]["ct"], live[0, 22:24])
    assert FusedDetector.fetch(torch.from_numpy(packed),
                               cfg.out_thresh)[0]["ct"].tolist() == \
        live[0, 2:4].tolist()


@pytest.fixture(scope="module")
def bf16_maps(weights):
    return tt.bf16_head_maps("ddd", weights)


@pytest.mark.parametrize("head", ["hm", "reg", "wh", "tracking", "dep",
                                  "rot", "dim", "amodel_offset"])
def test_bf16_network_heads_match_jax_bf16(bf16_maps, head):
    """bf16 serving's network (bench.py's precision) head by head
    against JAX's bf16 one (tt.check_bf16_head; measured: 0.87x to
    1.49x JAX's own bf16-vs-float32 distance, at most 1.9e-2 of the
    map's largest value). The rows of the clip
    are not compared at bf16 on the CPU: its weak peaks at this input
    move by an output pixel in either framework's bf16 against its
    float32 (measured 40 px of the frame), which the card's ddd phase
    holds against its plain-DCN path from the same state instead."""
    tt.check_bf16_head(bf16_maps, head)


def test_run_chunk_and_multistream_equal_run(weights, clip):
    """Under one set camera: run_chunk over the clip equals run per frame
    bit for bit, and each stream of a 2-stream MultiStreamDetector
    (stream 1 on the clip reversed) equals a FusedDetector on its
    frames."""
    cfg, _ = tt.cfgs("ddd", HW)
    m = tt.meta("ddd", HW)
    frames = clip[0]
    calib = _other_calib()
    singles = [FusedDetector(cfg, *weights, m, device="cpu")
               for _ in range(3)]
    multi = MultiStreamDetector(cfg, 2, *weights, m, device="cpu")
    for d in singles + [multi]:
        d.set_calib(calib)
    chunked = singles[2].run_chunk(frames)
    assert chunked.shape == (3, cfg.K, 24)
    n, id_maps = 0, [{}, {}]
    for t in range(3):
        pair = [frames[t], frames[2 - t]]
        got = multi.fetch_all_full(multi.run(pair), cfg.out_thresh)
        packed = [d.run(f) for d, f in zip(singles, pair)]
        np.testing.assert_array_equal(chunked[t].numpy(), packed[0].numpy())
        for s in range(2):
            want = singles[s].fetch_full(packed[s], cfg.out_thresh)
            n += tt.compare_rows(got[s], want, id_maps[s], DDD_EXTRAS)
    assert n >= 6
    rows = singles[2].fetch_chunk_full(chunked, cfg.out_thresh)
    assert sum(map(len, rows)) and all(set(r) == DDD_KEYS
                                       for frame in rows for r in frame)


def test_host_detector_ddd_matches_jax(weights, clip):
    """The host Detector with each frame's calib from the clip's
    records, and the default camera (test_focal_length) on the last."""
    cfg, jcfg = tt.cfgs("ddd", HW, test_focal_length=1000)
    m = tt.meta("ddd", HW)
    port = detector.Detector(cfg, *weights, m, device="cpu")
    ref = jdetector.Detector(jcfg, *weights, m)
    assert port.rest_focal_length == ref.rest_focal_length == 1000
    frames, images, _ = clip
    n, id_map = 0, {}
    for f, (frame, im) in enumerate(zip(frames, images)):
        meta = {"calib": im["calib"]} if f < 2 else {}
        got = copy.deepcopy(port.run(frame, copy.deepcopy(meta))["results"])
        want = copy.deepcopy(ref.run(frame, copy.deepcopy(meta))["results"])
        assert [g["tracking_id"] for g in got] == [
            w["tracking_id"] for w in want]
        n += tt.compare_rows(got, want, id_map, DDD_EXTRAS)
    assert n >= 6


# ---- the selftest's clip and its drawing ---------------------------------

def test_make_dataset_ddd_matches_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    pa, pi = selftest.make_dataset_ddd(a, num_videos=1, frames=2, seed=4)
    ja, ji = jselftest.make_dataset_ddd(b, num_videos=1, frames=2, seed=4)
    with open(pa) as f, open(ja) as g:
        assert f.read() == g.read()
    names = sorted(os.listdir(ji))
    assert sorted(os.listdir(pi)) == names and len(names) == 2
    for name in names:
        with open(os.path.join(pi, name), "rb") as f, \
                open(os.path.join(ji, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("kind", ["random", "off_frame", "degenerate"])
def test_fill_convex_poly_matches_cv2(kind):
    """convex_hull then fill_convex_poly against cv2.convexHull and
    cv2.fillConvexPoly bit for bit, and draw_line against cv2.line:
    random polygons on small images, polygons reaching thousands of
    pixels past a 1600x900 frame, and points with duplicates and
    collinear runs."""
    rng = np.random.RandomState(["random", "off_frame",
                                 "degenerate"].index(kind))
    for _ in range(60 if kind == "off_frame" else 400):
        if kind == "off_frame":
            h, w = 900, 1600
            pts = rng.uniform(-4000, 5000, (rng.randint(3, 9), 2))
        elif kind == "random":
            h, w = rng.randint(5, 70, 2)
            pts = rng.randint(-30, 90, (rng.randint(1, 12), 2))
        else:
            h, w = rng.randint(5, 30, 2)
            pts = rng.randint(0, 6, (rng.randint(1, 12), 2))
        pts = pts.astype(np.int32)
        hull = draw.convex_hull(pts)
        np.testing.assert_array_equal(hull, cv2.convexHull(pts))
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        color = tuple(int(c) for c in rng.randint(1, 256, 3))
        cv2.fillConvexPoly(a, hull, color)
        draw.fill_convex_poly(b, hull, color)
        p1, p2 = (tuple(int(v) for v in rng.randint(-2 * w, 3 * w, 2))
                  for _ in range(2))
        cv2.line(a, p1, p2, (9, 8, 7), 1, cv2.LINE_8)
        draw.draw_line(b, p1, p2, (9, 8, 7))
        np.testing.assert_array_equal(a, b)


# ---- what is not ported ---------------------------------------------------

def test_training_ddd_raises_naming_a9c(tmp_path, monkeypatch):
    """cli.main tracking,ddd stops at the Trainer, before any step."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="A9c"):
        cli_main.main(["tracking,ddd", "--dataset", "nuscenes", "--device",
                       "cpu", "--input_h", "64", "--input_w", "64"])
    assert not list(tmp_path.rglob("*.ckpt"))


def test_nuscenes_loading_and_eval_raise_naming_a9c(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg, _ = tt.cfgs("ddd", HW)
    with pytest.raises(NotImplementedError, match="A9c"):
        datasets.get_dataset("nuscenes")(cfg, "val")
    with pytest.raises(NotImplementedError, match="A9c"):
        datasets.NuScenes.run_eval(None, {}, str(tmp_path))
    with pytest.raises(NotImplementedError, match="A9c"):
        cli_test.main(["tracking,ddd", "--dataset", "nuscenes", "--device",
                       "cpu"])
