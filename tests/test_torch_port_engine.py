"""The port's serving path (centertrack_tpu_torch.ops.warp/gaussian,
engine.device_tracker, engine.fused) against the JAX package on the
CPU, and the rule that the port and chip_smoke.py import nothing of
JAX or of the JAX package."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.engine import device_tracker as jdt
from centertrack_tpu.engine.fused import FusedDetector as JFusedDetector
from centertrack_tpu.ops import gaussian as jgaussian
from centertrack_tpu.ops.affine import get_affine_transform as jaffine
from centertrack_tpu.ops.warp import preprocess_frame as jpreprocess
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.engine import device_tracker as dt
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.ops import gaussian
from centertrack_tpu_torch.ops.affine import (get_affine_transform,
                                              invert_affine)
from centertrack_tpu_torch.ops.warp import preprocess_frame
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)


class TrainMeta:
    """The local1 checkpoint's training size."""
    num_categories = 1
    default_resolution = [96, 160]
    num_joints = 17
    rest_focal_length = 1200
    flip_idx = []
    mean = MEAN
    std = STD


@pytest.mark.parametrize("src_hw", [(120, 200), (192, 320), (96, 160)])
def test_affine_matches_jax(src_hw):
    h, w = src_hw
    c = np.array([w / 2.0, h / 2.0], np.float32)
    for inv in (0, 1):
        np.testing.assert_array_equal(
            get_affine_transform(c, max(h, w) * 1.0, 0, [160, 96], inv=inv),
            jaffine(c, max(h, w) * 1.0, 0, [160, 96], inv=inv))


@pytest.mark.parametrize("src_hw", [(120, 200), (200, 150)])
def test_preprocess_frame_matches_jax(src_hw):
    h, w = src_hw
    rng = np.random.RandomState(h)
    frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    c = np.array([w / 2.0, h / 2.0], np.float32)
    inv = invert_affine(get_affine_transform(c, max(h, w) * 1.0, 0,
                                             [160, 96])).astype(np.float32)
    ref = jpreprocess(jnp.asarray(frame), jnp.asarray(inv), 96, 160,
                      jnp.asarray(MEAN), jnp.asarray(STD), axis_aligned=True)
    out = preprocess_frame(torch.from_numpy(frame), torch.from_numpy(inv),
                           96, 160, torch.from_numpy(MEAN),
                           torch.from_numpy(STD))
    assert out.shape == (1, 96, 160, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_gaussian_radius_matches_jax():
    rng = np.random.RandomState(0)
    h = np.ceil(rng.uniform(0, 300, 64)).astype(np.float32)
    w = np.ceil(rng.uniform(0, 300, 64)).astype(np.float32)
    np.testing.assert_allclose(
        gaussian.gaussian_radius(torch.from_numpy(h),
                                 torch.from_numpy(w)).numpy(),
        np.asarray(jgaussian.gaussian_radius_jax(jnp.asarray(h),
                                                 jnp.asarray(w))),
        rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 96), (96, 160), (200, 300)])
def test_render_pre_hm_matches_jax(hw):
    """Dense rendering up to 128x128 pixels, windowed splats above; both
    against the JAX serving render (compact=True), including radii past
    the window cap and dead slots."""
    h, w = hw
    rng = np.random.RandomState(h)
    n = 32
    cts = np.stack([rng.randint(0, w, n), rng.randint(0, h, n)],
                   1).astype(np.int32)
    radii = rng.randint(0, 40, n).astype(np.int32)
    radii[:2] = [150, 300]
    ks = rng.uniform(0.3, 1.0, n).astype(np.float32)
    valid = rng.rand(n) < 0.6
    ref = jgaussian.render_pre_hm(h, w, jnp.asarray(cts), jnp.asarray(radii),
                                  jnp.asarray(ks), jnp.asarray(valid),
                                  compact=True)
    out = gaussian.render_pre_hm(h, w, torch.from_numpy(cts),
                                 torch.from_numpy(radii),
                                 torch.from_numpy(ks),
                                 torch.from_numpy(valid))
    assert out.shape == (h, w, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_render_pre_hm_without_live_tracks_is_zero():
    out = gaussian.render_pre_hm(544, 960, torch.zeros(8, 2, dtype=torch.int32),
                                 torch.ones(8, dtype=torch.int32),
                                 torch.ones(8), torch.zeros(8, dtype=torch.bool))
    assert out.shape == (544, 960, 1) and not out.any()


@pytest.mark.parametrize("seed", range(4))
def test_greedy_assign_matches_jax_including_ties(seed):
    """Integer distances make ties; the first row, then the first
    minimal column, wins in both."""
    rng = np.random.RandomState(seed)
    dist = rng.randint(0, 6, (12, 9)).astype(np.float32)
    dist[rng.rand(12, 9) < 0.3] = 1e18
    ref = np.asarray(jdt.greedy_assign(jnp.asarray(dist)))
    np.testing.assert_array_equal(
        dt.greedy_assign(torch.from_numpy(dist), range(12)).numpy(), ref)
    rows = [i for i in range(12) if (dist[i] < 1e16).any()]
    np.testing.assert_array_equal(
        dt.greedy_assign(torch.from_numpy(dist), rows).numpy(), ref)


def _dets(rng, k, centers, score_hi):
    """Score-sorted (K, ...) detections: the first len(centers) above
    threshold at the given image centers, the rest below."""
    n = len(centers)
    scores = np.ascontiguousarray(np.sort(np.concatenate([
        rng.uniform(0.5, score_hi, n),
        rng.uniform(0.0, 0.2, k - n)]))[::-1], dtype=np.float32)
    cts = np.concatenate([centers, rng.uniform(0, 300, (k - n, 2))]
                         ).astype(np.float32)
    wh = rng.uniform(20, 40, (k, 2)).astype(np.float32)
    bboxes = np.concatenate([cts - wh / 2, cts + wh / 2], 1)
    tracking = rng.uniform(-2, 2, (k, 2)).astype(np.float32)
    classes = np.ones(k, np.int32)
    return scores, classes, cts, tracking, bboxes


def _state_rows(state):
    """Live track rows (id, ct, bbox, class, score, age, active)."""
    v = np.asarray(state.valid)
    cols = [np.asarray(state.ids)[:, None], np.asarray(state.cts),
            np.asarray(state.bboxes), np.asarray(state.classes)[:, None],
            np.asarray(state.scores)[:, None], np.asarray(state.ages)[:, None],
            np.asarray(state.active)[:, None]]
    return np.concatenate([c.astype(np.float64) for c in cols], 1)[v]


def test_tracker_step_matches_jax_over_a_clip():
    """Five steps with births, matches, misses and deaths. Per-detection
    ids/ages/actives agree exactly. The JAX step also keeps, on its CPU
    backend, an aged copy of a track matched from slot 0 (its
    matched-track scatter lets unmatched rows write False to slot 0);
    those copies are dropped from the JAX state before comparing, and
    the port's state must hold no id twice."""
    rng = np.random.RandomState(5)
    k, cap = 12, 16
    base = rng.uniform(40, 260, (6, 2))
    jstate, state = jdt.init_state(cap), dt.init_state(cap, "cpu")
    for f in range(5):
        keep = [i for i in range(6) if (i + f) % 4 != 0]
        centers = base[keep] + f * 3.0
        dets = _dets(rng, k, centers, 0.95)
        jstate, jout = jdt.step(jstate, *map(jnp.asarray, dets), 0.3, 0.3, 2)
        state, out = dt.step(state, *map(torch.from_numpy, dets), 0.3, 0.3, 2)
        for key in ("tracking_id", "age", "active"):
            np.testing.assert_array_equal(out[key].numpy(),
                                          np.asarray(jout[key]), key)
        assert int(state.id_count) == int(jstate.id_count)
        rows, jrows = _state_rows(state), _state_rows(jstate)
        assert len(set(rows[:, 0])) == len(rows)
        n_det = int((np.asarray(jout["tracking_id"]) > 0).sum())
        det_ids = set(jrows[:n_det, 0])
        jrows = np.concatenate([jrows[:n_det], [
            r for r in jrows[n_det:] if r[0] not in det_ids] or
            np.zeros((0, jrows.shape[1]))])
        np.testing.assert_allclose(rows, jrows, atol=0, rtol=0)


def _detector_pair(seed):
    kw = dict(task="tracking", pre_hm=True, track_thresh=0.3,
              new_thresh=0.3, max_age=3, dla_node="dcn_local1")
    cfg = set_heads(parse_task(Config(**kw)), TrainMeta)
    jcfg = jset_heads(jparse_task(JConfig(**kw)), TrainMeta)
    params, batch_stats = load_jax_ckpt(
        os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt"))
    return (FusedDetector(cfg, params, batch_stats, TrainMeta, device="cpu"),
            JFusedDetector(jcfg, params=params, batch_stats=batch_stats,
                           dataset_meta=TrainMeta), cfg)


def test_fused_detector_matches_jax_over_four_frames():
    """Four synthetic frames (the bench generator at 320x192, so objects
    land at the checkpoint's training scale after the warp to 160x96).
    Rows above out_thresh: scores within 1e-4, boxes within 1e-2 px,
    track ids a bijection. Rows below are left out: top-K orders tied
    low scores differently in the two frameworks. 'active' is not
    compared: the JAX step's duplicated aged track (see
    test_tracker_step_matches_jax_over_a_clip) can be matched instead of
    the live one and restart its count."""
    det, jdet, cfg = _detector_pair(0)
    frames = bench.synth_frames(4, height=192, width=320, n_obj=4, seed=0)
    id_map = {}
    n_rows = 0
    for f, frame in enumerate(frames):
        got = FusedDetector.fetch(det.run(frame), cfg.out_thresh)
        ref = JFusedDetector.fetch(jdet.run(frame), cfg.out_thresh)
        assert len(got) == len(ref), f"frame {f}"
        for a, b in zip(got, ref):
            assert abs(a["score"] - b["score"]) <= 1e-4
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-2,
                                       rtol=0)
            np.testing.assert_allclose(a["ct"], b["ct"], atol=1e-2, rtol=0)
            assert a["class"] == b["class"]
            assert id_map.setdefault(a["tracking_id"],
                                     b["tracking_id"]) == b["tracking_id"]
            n_rows += 1
    assert len(set(id_map.values())) == len(id_map)
    assert n_rows >= 6 and len(id_map) >= 2


def test_fused_detector_packs_13_columns_and_resets():
    det, _, cfg = _detector_pair(1)
    frame = bench.synth_frames(1, height=192, width=320, n_obj=3, seed=1)[0]
    packed = det.run(frame)
    assert packed.shape == (cfg.K, 13) and packed.dtype == torch.float32
    assert torch.isfinite(packed).all()
    items = FusedDetector.fetch(packed, cfg.out_thresh)
    assert items and {"score", "class", "ct", "tracking", "bbox",
                      "tracking_id", "age", "active"} <= set(items[0])
    assert det.pre_images is not None
    det.reset_tracking()
    assert not det.track_state.valid.any() and det.pre_images is None


FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "cv2", "centertrack_tpu"}
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(os.path.join(ROOT, "centertrack_tpu_torch"))
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_nothing_of_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and (
                getattr(node.func, "id", None) == "__import__" or
                getattr(node.func, "attr", None) == "import_module"):
            names += [a.value for a in node.args
                      if isinstance(a, ast.Constant)]
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
