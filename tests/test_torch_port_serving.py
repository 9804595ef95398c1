"""The port's serving engine with a stream axis against the JAX package
on the CPU: the tracker kernels' plain versions (ops/tracker.py's
greedy_assign, ops/gaussian.py's splat_pre_hm), the
batched association step, the batched pre_hm render,
``FusedDetector.run_chunk`` and ``MultiStreamDetector``; and the
tracker launchers' ctypes arguments against csrc/tracker.cu."""

import os
import re

import jax
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
from centertrack_tpu.engine.fused import \
    MultiStreamDetector as JMultiStreamDetector
from centertrack_tpu.ops import gaussian as jgaussian
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.engine import device_tracker as dt
from centertrack_tpu_torch.engine.fused import (FusedDetector,
                                                MultiStreamDetector)
from centertrack_tpu_torch.ops import gaussian, tracker
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
DET_KW = dict(task="tracking", pre_hm=True, track_thresh=0.3,
              new_thresh=0.3, max_age=3, dla_node="dcn_local1")
# rows above out_thresh, as tests/test_torch_port_engine.py's
# test_fused_detector_matches_jax_over_four_frames holds them
SCORE_TOL, BOX_TOL = 1e-4, 1e-2


class TrainMeta:
    """The local1 checkpoint's training size."""
    num_categories = 1
    default_resolution = [96, 160]
    num_joints = 17
    rest_focal_length = 1200
    flip_idx = []
    mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
    std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)


# ---- greedy_assign ----------------------------------------------------

def _dist_case(name):
    """(S, K, T) float32 distances of one case, from a numpy seed."""
    rng = np.random.RandomState(len(name))
    if name == "ties":           # integer distances: many ties
        d = rng.randint(0, 4, (3, 12, 9)).astype(np.float32)
        d[rng.rand(*d.shape) < 0.3] = 1e18
    elif name == "invalid_rows":  # whole rows, and one stream, invalid
        d = rng.uniform(0, 50, (3, 10, 16)).astype(np.float32)
        d[:, ::3] = 1e18
        d[2] = 1e18
    elif name == "k_over_t":
        d = rng.randint(0, 6, (2, 40, 5)).astype(np.float32)
    elif name == "t_over_k":     # more slots than a warp has lanes
        d = rng.uniform(0, 9, (2, 6, 300)).astype(np.float32)
        d[rng.rand(*d.shape) < 0.5] = 1e18
    else:                        # nan: a row with a NaN matches nothing
        d = rng.randint(0, 5, (2, 8, 7)).astype(np.float32)
        d[0, 2, 4] = np.nan
        d[1, 0, 0] = np.nan
        d[1, 5, :] = 1e18
        d[1, 5, 3] = np.nan
    return d


@pytest.mark.parametrize("case", ["ties", "invalid_rows", "k_over_t",
                                  "t_over_k", "nan"])
def test_greedy_assign_with_a_stream_axis_matches_jax_vmap(case):
    """The plain version (the CPU path and the kernel's oracle) equals
    ``jax.vmap(greedy_assign)`` exactly: the first row, then the first
    minimal column, wins; a NaN row matches nothing and takes nothing."""
    d = _dist_case(case)
    ref = np.asarray(jax.vmap(jdt.greedy_assign)(jnp.asarray(d)))
    got = tracker.greedy_assign(torch.from_numpy(d))
    assert got.dtype == torch.int32 and got.shape == d.shape[:2]
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref >= 0).any()


# ---- the association step over a stream axis -------------------------

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


def _state_rows(state, s):
    """Stream s's live track rows (id, ct, bbox, class, score, age,
    active)."""
    v = np.asarray(state.valid)[s]
    cols = [np.asarray(state.ids)[s][:, None], np.asarray(state.cts)[s],
            np.asarray(state.bboxes)[s],
            np.asarray(state.classes)[s][:, None],
            np.asarray(state.scores)[s][:, None],
            np.asarray(state.ages)[s][:, None],
            np.asarray(state.active)[s][:, None]]
    return np.concatenate([c.astype(np.float64) for c in cols], 1)[v]


def test_tracker_step_with_three_streams_matches_jax_vmap():
    """Three streams over five frames with births, matches, misses and
    deaths, each stream's detections its own. Per-detection ids, ages
    and actives agree exactly; each stream's live tracks agree exactly
    once JAX's aged duplicates of tracks matched from slot 0 (its
    matched-track scatter lets unmatched rows write slot 0, ROADMAP C3)
    are dropped, and no stream of the port holds an id twice."""
    rng = np.random.RandomState(7)
    s, k, cap = 3, 12, 16
    base = rng.uniform(40, 260, (s, 6, 2))
    jstep = jax.vmap(lambda st, *d: jdt.step(st, *d, 0.3, 0.3, 2))
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (s,) + a.shape), jdt.init_state(cap))
    state = dt.init_state(cap, s, "cpu")
    for f in range(5):
        per = [_dets(rng, k, base[i][[j for j in range(6)
                                      if (i + j + f) % 4 != 0]] + f * 3.0,
                     0.95) for i in range(s)]
        dets = [np.stack([p[n] for p in per]) for n in range(5)]
        jstate, jout = jstep(jstate, *map(jnp.asarray, dets))
        state, out = dt.step(state, *map(torch.from_numpy, dets), 0.3, 0.3,
                             2)
        for key in ("tracking_id", "age", "active"):
            np.testing.assert_array_equal(out[key].numpy(),
                                          np.asarray(jout[key]), key)
        np.testing.assert_array_equal(state.id_count.numpy(),
                                      np.asarray(jstate.id_count))
        for i in range(s):
            rows, jrows = _state_rows(state, i), _state_rows(jstate, i)
            assert len(set(rows[:, 0])) == len(rows)
            n_det = int((np.asarray(jout["tracking_id"])[i] > 0).sum())
            det_ids = set(jrows[:n_det, 0])
            jrows = np.concatenate([jrows[:n_det], [
                r for r in jrows[n_det:] if r[0] not in det_ids] or
                np.zeros((0, jrows.shape[1]))])
            np.testing.assert_allclose(rows, jrows, atol=0, rtol=0)
    assert int(state.valid.sum()) > 0


# ---- pre_hm over a stream axis ----------------------------------------

@pytest.mark.parametrize("hw", [(64, 96), (200, 300)])
def test_render_pre_hm_with_a_stream_axis_matches_jax(hw):
    """Three streams against JAX ``render_pre_hm(..., compact=True)`` per
    stream: the dense render up to 128x128 pixels, the splat (the
    kernel's plain version) above, with radii past the window cap,
    centres on the map's edges and corners, dead slots and one stream
    with none live. Within 1e-6 (exp may differ by an ulp)."""
    h, w = hw
    rng = np.random.RandomState(h)
    s, n = 3, 24
    cts = np.stack([rng.randint(0, w, (s, n)), rng.randint(0, h, (s, n))],
                   -1).astype(np.int32)
    cts[0, :4] = [[0, 0], [w - 1, h - 1], [0, h // 2], [w // 2, h - 1]]
    radii = rng.randint(0, 40, (s, n)).astype(np.int32)
    radii[0, :2] = [150, 300]
    radii[1, 0] = 127
    ks = rng.uniform(0.3, 1.0, (s, n)).astype(np.float32)
    valid = rng.rand(s, n) < 0.6
    valid[0, :4] = True
    valid[2] = False
    out = gaussian.render_pre_hm(h, w, *map(torch.from_numpy,
                                            (cts, radii, ks, valid)))
    assert out.shape == (s, h, w, 1)
    for i in range(s):
        ref = jgaussian.render_pre_hm(
            h, w, jnp.asarray(cts[i]), jnp.asarray(radii[i]),
            jnp.asarray(ks[i]), jnp.asarray(valid[i]), compact=True)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref),
                                   atol=1e-6, rtol=0)
    assert not out[2].any() and out[0].any()


# ---- run_chunk and MultiStreamDetector against JAX ---------------------

def _cfgs():
    return (set_heads(parse_task(Config(**DET_KW)), TrainMeta),
            jset_heads(jparse_task(JConfig(**DET_KW)), TrainMeta))


@pytest.fixture(scope="module")
def frames():
    """The bench generator at 320x192: objects land at the checkpoint's
    training scale after the warp to 160x96."""
    return bench.synth_frames(6, height=192, width=320, n_obj=4, seed=0)


@pytest.fixture(scope="module")
def jax_rows(frames):
    """JAX ``FusedDetector.run`` over frames 0-3 (one compile)."""
    _, jcfg = _cfgs()
    params, batch_stats = load_jax_ckpt(CKPT)
    jdet = JFusedDetector(jcfg, params=params, batch_stats=batch_stats,
                          dataset_meta=TrainMeta)
    return [JFusedDetector.fetch(jdet.run(f), jcfg.out_thresh)
            for f in frames[:4]]


def _compare(got, ref, id_map):
    """Rows above out_thresh in order: scores within SCORE_TOL, boxes and
    centres within BOX_TOL px, classes equal, track ids a consistent
    map. Returns the rows compared."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert abs(a["score"] - b["score"]) <= SCORE_TOL
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=BOX_TOL,
                                   rtol=0)
        np.testing.assert_allclose(a["ct"], b["ct"], atol=BOX_TOL, rtol=0)
        assert a["class"] == b["class"]
        assert id_map.setdefault(a["tracking_id"],
                                 b["tracking_id"]) == b["tracking_id"]
    return len(got)


def test_run_chunk_matches_jax_run_per_frame(frames, jax_rows):
    """``run_chunk`` of two frames, then of one, then a ``run`` that
    continues the state, on ``device="cpu"``: every frame's rows against
    JAX's per-frame ``run`` (JAX's own test_run_chunk_matches_per_frame
    holds its run_chunk to its run), and bit for bit against the port's
    own ``run`` per frame."""
    cfg, _ = _cfgs()
    params, batch_stats = load_jax_ckpt(CKPT)
    det = FusedDetector(cfg, params, batch_stats, TrainMeta, device="cpu")
    packed = [det.run_chunk(frames[0:2]), det.run_chunk([frames[2]]),
              det.run(frames[3])]
    assert packed[0].shape == (2, cfg.K, 13)
    assert packed[1].shape == (1, cfg.K, 13)
    rows = (FusedDetector.fetch_chunk(packed[0], cfg.out_thresh)
            + FusedDetector.fetch_chunk(packed[1], cfg.out_thresh)
            + [FusedDetector.fetch(packed[2], cfg.out_thresh)])
    id_map = {}
    n = sum(_compare(g, r, id_map) for g, r in zip(rows, jax_rows))
    assert len(set(id_map.values())) == len(id_map)
    assert n >= 6 and len(id_map) >= 2

    ref = FusedDetector(cfg, params, batch_stats, TrainMeta, device="cpu")
    per_frame = torch.stack([ref.run(f) for f in frames[:4]])
    chunked = torch.cat([packed[0], packed[1], packed[2][None]])
    assert torch.equal(chunked, per_frame)
    for a, b in zip(det.track_state, ref.track_state):
        assert torch.equal(a, b)


def test_multistream_detector_matches_jax_with_a_stream_reset(frames):
    """Two streams, three steps, stream 1 reset before the third (a
    video boundary; both engines then condition it on its own frame and
    restart its ids): each stream's rows against JAX's
    ``MultiStreamDetector``. A 2D task has no extras: ``fetch_all_full``
    gives ``fetch_all``'s rows, and ``set_calib`` is taken and read by
    nothing."""
    cfg, jcfg = _cfgs()
    params, batch_stats = load_jax_ckpt(CKPT)
    det = MultiStreamDetector(cfg, 2, params, batch_stats, TrainMeta,
                              device="cpu")
    jdet = JMultiStreamDetector(jcfg, 2, params=params,
                                batch_stats=batch_stats,
                                dataset_meta=TrainMeta)
    steps = [[frames[0], frames[3]], [frames[1], frames[4]],
             np.stack([frames[2], frames[0]])]
    id_maps, n = [{}, {}], 0
    for t, images in enumerate(steps):
        if t == 2:
            det.reset_stream(1)
            jdet.reset_stream(1)
        packed = det.run(images)
        assert packed.shape == (2, cfg.K, 13)
        got = MultiStreamDetector.fetch_all(packed, cfg.out_thresh)
        ref = JMultiStreamDetector.fetch_all(jdet.run(images),
                                             jcfg.out_thresh)
        for s in range(2):
            n += _compare(got[s], ref[s], id_maps[s])
        one = MultiStreamDetector.fetch_stream(packed, 1, cfg.out_thresh)
        assert [d["tracking_id"] for d in one] == [
            d["tracking_id"] for d in got[1]]
    for m in id_maps:
        assert len(set(m.values())) == len(m)
    assert n >= 8 and all(id_maps)
    full = det.fetch_all_full(packed, cfg.out_thresh)
    plain = MultiStreamDetector.fetch_all(packed, cfg.out_thresh)
    assert len(full) == 2 and [[set(r) for r in s] for s in full] == [
        [set(r) for r in s] for s in plain]
    for fs, ps in zip(full, plain):
        for f, p in zip(fs, ps):
            assert all(np.array_equal(f[k], p[k]) for k in p)
    det.set_calib(np.eye(3, 4))
    assert packed.shape[-1] == 13 and det.width == 13


# ---- the launchers' arguments -------------------------------------------

def _extern_c_params(name):
    """The parameter list of csrc/tracker.cu's extern "C" ``name``."""
    with open(os.path.join(ROOT, "centertrack_tpu_torch", "csrc",
                           "tracker.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("symbol", ["greedy_assign", "splat_pre_hm"])
def test_tracker_launchers_pass_their_ctypes_arguments(symbol, monkeypatch):
    """Each launcher (ops/tracker.py's greedy_assign, ops/gaussian.py's
    splat_pre_hm) calls its symbol with as many pointers and ints as its
    _SIGNATURES entry says, which are the C entry point's, then the
    stream, and counts the launch (the ctypes call is a stand-in)."""
    mod = tracker if symbol == "greedy_assign" else gaussian
    n_ptr, n_int = mod._SIGNATURES[symbol]
    params = _extern_c_params(symbol)
    assert len(params) == n_ptr + n_int + 1
    assert all("*" in p for p in params[:n_ptr] + params[-1:])
    assert all(p.startswith("int ") for p in params[n_ptr:-1])
    calls = []

    def fake_kernel(name):
        def launch(*argv):
            assert len(argv) == n_ptr + n_int + 1
            calls.append((name, argv[n_ptr:n_ptr + n_int]))
            return 0
        return launch

    monkeypatch.setattr(mod, "_kernel", fake_kernel)
    monkeypatch.setattr(mod, "_stream", lambda t: 0)
    before = dict(mod.LAUNCHES)
    if symbol == "greedy_assign":
        match = tracker.launch_greedy_assign(torch.zeros(2, 5, 7))
        assert match.shape == (2, 5) and match.dtype == torch.int32
        assert calls == [(symbol, (2, 5, 7))]
        with pytest.raises(ValueError, match="track slots"):
            tracker.launch_greedy_assign(torch.zeros(1, 5, 1025))
    else:
        canvas = gaussian.launch_splat_pre_hm(
            40, 60, torch.zeros(3, 8, 2, dtype=torch.int32),
            torch.zeros(3, 8, dtype=torch.int32), torch.zeros(3, 8),
            torch.zeros(3, 8, dtype=torch.bool))
        assert canvas.shape == (3, 40, 60)
        assert calls == [(symbol, (3, 8, 40, 60, gaussian.MAX_RADIUS))]
    after = dict(before, **{symbol: before[symbol] + 1})
    assert mod.LAUNCHES == after
