"""The host Detector's pieces in the port (centertrack_tpu_torch:
ops.nms, engine.post_process, engine.tracker, engine.device_tracker.
init_from_dets, ops.decode's zero_tracking, config's A12 fields) against
the JAX package on the CPU, on seeded inputs.

Tolerances: the NMS keep mask exactly (and the IoU bit for bit), also a
numpy model of the ``nms_keep`` kernel's two passes (csrc/nms.cu) against
the plain version; post-process within 1e-5; the tracker's ids, ages,
``active`` and boxes exactly; ``init_from_dets`` exactly.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.engine import device_tracker as jdt
from centertrack_tpu.engine import post_process as jpost
from centertrack_tpu.engine.tracker import Tracker as JTracker
from centertrack_tpu.ops import decode as jdecode
from centertrack_tpu.ops import nms as jnms
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.engine import device_tracker as dt
from centertrack_tpu_torch.engine import post_process
from centertrack_tpu_torch.engine.tracker import Tracker
from centertrack_tpu_torch.ops import decode, nms

torch.set_num_threads(2)


class Meta:
    num_categories = 2
    default_resolution = [96, 160]
    num_joints = 17


def _cfgs(**kw):
    args = dict(task="tracking", **kw)
    return (set_heads(parse_task(Config(**args)), Meta),
            jset_heads(jparse_task(JConfig(**args)), Meta))


# ---- config --------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {}, dict(keep_res=True, no_pre_img=True), dict(input_res=128),
    dict(input_res=128, input_h=64, test_dataset="mot", dataset="custom",
         flip_test=True, nms=True, hungarian=True, public_det=True,
         zero_pre_hm=True, zero_tracking=True, fix_short=64, trainval=True,
         test_scales=(1.0,), exp_id="x", val_intervals=5, num_iters=3)])
def test_config_a12_fields_derive_as_jax(kw):
    cfg, jcfg = _cfgs(**kw)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


# ---- nms -----------------------------------------------------------------
def _boxes(rng, s, k, spread=200.0, size=(1.0, 60.0)):
    xy = rng.uniform(0, spread, (s, k, 2)).astype(np.float32)
    wh = rng.uniform(*size, (s, k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = -np.sort(-rng.rand(s, k).astype(np.float32), 1)
    return boxes, scores


def _jax_keep(boxes, scores, classes, thresh=0.5):
    if classes is None:
        return np.stack([np.asarray(jnms.nms_suppress(
            jnp.asarray(b), jnp.asarray(s), thresh))
            for b, s in zip(boxes, scores)])
    return np.asarray(jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(
        scores), jnp.asarray(classes), thresh))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("classes", [False, True])
def test_nms_matches_jax_on_seeded_boxes(seed, classes):
    rng = np.random.RandomState(seed)
    boxes, scores = _boxes(rng, 3, 100)
    cls = rng.randint(0, 3, (3, 100)).astype(np.float32) if classes else None
    want = _jax_keep(boxes, scores, cls)
    got = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          None if cls is None else torch.from_numpy(cls))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size      # something is suppressed
    iou = nms.iou_matrix(torch.from_numpy(boxes[0])).numpy()
    jiou = np.asarray(jnms.iou_matrix(jnp.asarray(boxes[0])))
    np.testing.assert_array_equal(iou.view(np.int32), jiou.view(np.int32))


def test_nms_jax_cases():
    """JAX's tests/test_nms.py cases through the port."""
    t = torch.tensor
    keep = nms.nms_suppress_plain(t([[0, 0, 10, 10], [1, 1, 11, 11],
                                     [20, 20, 30, 30]], dtype=torch.float32),
                                  t([0.9, 0.8, 0.7]), 0.5)
    assert keep.tolist() == [True, False, True]
    keep = nms.batched_nms(t([[[0, 0, 10, 10], [4, 0, 14, 10],
                               [9, 0, 19, 10]]], dtype=torch.float32),
                           t([[0.9, 0.8, 0.7]]), None, 0.35)[0]
    assert keep.tolist() == [True, False, True]
    boxes = t([[[0, 0, 10, 10], [1, 1, 11, 11]]], dtype=torch.float32)
    scores = t([[0.9, 0.8]])
    assert nms.batched_nms(boxes, scores, t([[0.0, 0.0]]))[0].tolist() == [
        True, False]
    assert nms.batched_nms(boxes, scores, t([[0.0, 1.0]]))[0].tolist() == [
        True, True]


def _edge_cases(rng):
    """Ties, equal and zero-area boxes, -inf scores, IoUs on the
    threshold, and boxes whose IoU lies within an ulp of it."""
    k = 64
    boxes, scores = _boxes(rng, 1, k, spread=40.0, size=(4.0, 20.0))
    scores[0, 10:20] = scores[0, 10]                 # tied scores
    boxes[0, 20:30] = boxes[0, 20]                   # equal boxes
    boxes[0, 30:34, 2:] = boxes[0, 30:34, :2]        # zero area
    scores[0, 40:44] = -np.inf
    # two pairs of IoU 0.5 exactly, held at 0.5 and at the float32 just
    # below it
    boxes[0, 50] = (100, 100, 102, 101)
    boxes[0, 51] = (100, 100, 101, 101)
    boxes[0, 52] = (200, 200, 203, 201)
    boxes[0, 53] = (201, 200, 204, 201)
    equal = np.tile(np.float32([5, 5, 9, 9]), (1, k, 1))
    return [(boxes, scores, 0.5), (boxes, scores, np.nextafter(
        np.float32(0.5), np.float32(0))), (boxes, scores, 0.0),
            (equal, -np.sort(-rng.rand(1, k).astype(np.float32)), 0.5)]


def test_nms_edge_cases_match_jax():
    rng = np.random.RandomState(7)
    for boxes, scores, thresh in _edge_cases(rng):
        for cls in (None, (np.arange(boxes.shape[1]) % 2)[None].astype(
                np.float32)):
            want = _jax_keep(boxes, scores, cls, float(thresh))
            got = nms.batched_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores),
                                  None if cls is None else torch.from_numpy(
                                      cls), float(thresh)).numpy()
            np.testing.assert_array_equal(got, want)


def _kernel_model(boxes, scores, classes, thresh):
    """The nms_keep kernel's algorithm in numpy: the overlap words of
    each row against the rows above it (32 columns a word, one ballot
    a (row, word)), then the sweep: row i cleared when any word of its
    ANDed with the keep words is non-zero."""
    t = np.float32(thresh)
    iou = nms.iou_matrix(nms._shifted(torch.from_numpy(boxes),
                                      None if classes is None else
                                      torch.from_numpy(classes))).numpy()
    s, k = scores.shape
    words = (k + 31) // 32
    out = np.zeros((s, k), bool)
    for img in range(s):
        kept = np.zeros(words, np.uint64)
        for i in range(k):
            if scores[img, i] > -np.inf:
                kept[i // 32] |= np.uint64(1 << (i % 32))
        over = np.zeros((k, words), np.uint64)
        for i in range(k):
            for w in range(words):
                if 32 * w >= i:
                    continue
                for lane in range(32):
                    j = 32 * w + lane
                    if j < i and iou[img, i, j] > t:
                        over[i, w] |= np.uint64(1 << lane)
        for i in range(1, k):
            above = (i + 31) // 32
            if (over[i, :above] & kept[:above]).any():
                kept[i // 32] &= ~np.uint64(1 << (i % 32))
        out[img] = [(int(kept[i // 32]) >> (i % 32)) & 1 for i in range(k)]
    return out


@pytest.mark.parametrize("k", [1, 31, 33, 100])
def test_nms_kernel_model_matches_plain(k):
    rng = np.random.RandomState(k)
    boxes, scores = _boxes(rng, 2, k, spread=80.0)
    scores[1, k // 2:] = scores[1, k // 2]
    cls = rng.randint(0, 2, (2, k)).astype(np.float32)
    for c in (None, cls):
        want = nms.nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(
            scores), None if c is None else torch.from_numpy(c)).numpy()
        np.testing.assert_array_equal(_kernel_model(boxes, scores, c, 0.5),
                                      want)


def test_nms_kernel_limits():
    boxes = torch.zeros((1, 1025, 4))
    with pytest.raises(ValueError, match="1 to 1024"):
        nms.launch_nms_keep(boxes, torch.zeros((1, 1025)), None, 0.5)
    with pytest.raises(ValueError, match="do not fit"):
        nms.batched_nms(torch.zeros((1, 4, 4)), torch.zeros((1, 5)))


# ---- decode's zero_tracking ----------------------------------------------
def test_decode_zero_tracking_matches_jax():
    rng = np.random.RandomState(3)
    maps = {"hm": rng.rand(1, 24, 40, 2).astype(np.float32),
            "reg": rng.rand(1, 24, 40, 2).astype(np.float32),
            "wh": 20 * rng.rand(1, 24, 40, 2).astype(np.float32),
            "tracking": rng.randn(1, 24, 40, 2).astype(np.float32)}
    got = decode.generic_decode({k: torch.from_numpy(v)
                                 for k, v in maps.items()}, 30, 2, True)
    want = jdecode.generic_decode({k: jnp.asarray(v)
                                   for k, v in maps.items()}, 30, 2, True)
    assert not got["tracking"].any()
    for k in ("scores", "bboxes", "tracking", "cts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)


# ---- post-process ----------------------------------------------------------
def _dets(rng, b=2, k=40, heads=("tracking",)):
    scores = -np.sort(-rng.rand(b, k).astype(np.float32), 1)
    xy = rng.uniform(0, 40, (b, k, 2)).astype(np.float32)
    dets = {"scores": scores,
            "clses": rng.randint(0, 2, (b, k)).astype(np.float32),
            "cts": xy, "xs": xy[..., 0], "ys": xy[..., 1],
            "bboxes": np.concatenate([xy - 3, xy + rng.uniform(
                1, 8, (b, k, 2)).astype(np.float32)], -1)}
    if "tracking" in heads:
        dets["tracking"] = rng.randn(b, k, 2).astype(np.float32)
    if "ltrb_amodal" in heads:
        dets["bboxes_amodal"] = dets["bboxes"] + 1
        dets["bboxes"] = dets["bboxes_amodal"]
    return dets


@pytest.mark.parametrize("heads", [(), ("tracking",),
                                   ("tracking", "ltrb_amodal")])
def test_post_process_matches_jax(heads):
    rng = np.random.RandomState(len(heads))
    cfg, jcfg = _cfgs(track_thresh=0.4)
    dets = _dets(rng, heads=heads)
    c = [np.float32([80, 48]), np.float32([75, 45])]
    s = [160.0, np.float32([160, 96])]
    got = post_process.generic_post_process(cfg, dets, c, s, 24, 40)
    want = jpost.generic_post_process(jcfg, dets, c, s, 24, 40)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert sum(len(g) for g in got) > 0
    for gi, wi in zip(got, want):
        for g, w in zip(gi, wi):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_allclose(np.asarray(g[key], np.float64),
                                           np.asarray(w[key], np.float64),
                                           rtol=1e-5, atol=1e-5)


def test_post_process_ddd_raises():
    """The ddd lift, once not ported and raising, now runs: the rows
    with rot, dep and dim (no amodel_offset: the lift at the box centre)
    against JAX's at the default camera."""
    cfg, jcfg = _cfgs()
    rng = np.random.RandomState(0)
    dets = _dets(rng)
    dets.update(rot=rng.randn(2, 40, 8).astype(np.float32),
                dep=rng.uniform(1, 50, (2, 40, 1)).astype(np.float32),
                dim=np.ones((2, 40, 3), np.float32))
    calib = np.array([[1200, 0, 8, 0], [0, 1200, 8, 0], [0, 0, 1, 0]],
                     np.float32)
    args = (dets, [np.float32([8, 8])] * 2, [16.0] * 2, 24, 40,
            [calib] * 2)
    got = post_process.generic_post_process(cfg, *args)
    want = jpost.generic_post_process(jcfg, *args)
    assert sum(map(len, got)) > 0
    for gi, wi in zip(got, want):
        assert len(gi) == len(wi)
        for g, w in zip(gi, wi):
            assert g.keys() == w.keys() and {"loc", "rot_y"} <= set(g)
            for key in g:
                np.testing.assert_allclose(np.asarray(g[key], np.float64),
                                           np.asarray(w[key], np.float64),
                                           rtol=1e-5, atol=1e-5, err_msg=key)


# ---- the host tracker --------------------------------------------------------
def _clip(seed, frames=8, n_obj=12):
    """Per frame a list of detection dicts of moving boxes: some objects
    missed, some false, two classes, displacements near the motion."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 300, (n_obj, 2))
    vel = rng.uniform(-6, 6, (n_obj, 2))
    size = rng.uniform(10, 40, (n_obj, 2))
    cls = rng.randint(1, 3, n_obj)
    clip = []
    for f in range(frames):
        dets = []
        for o in range(n_obj):
            if rng.rand() < 0.15:
                continue
            ct = (pos[o] + vel[o] * f + rng.randn(2)).astype(np.float32)
            wh = size[o] * (1 + 0.05 * rng.randn(2))
            dets.append({"score": float(rng.uniform(0.2, 1.0)),
                         "class": int(cls[o]), "ct": ct,
                         "tracking": (-vel[o] + rng.randn(2)).astype(
                             np.float32),
                         "bbox": np.concatenate([ct - wh / 2,
                                                 ct + wh / 2]).astype(
                                                     np.float32)})
        for _ in range(rng.randint(0, 3)):
            ct = rng.uniform(0, 300, 2).astype(np.float32)
            dets.append({"score": float(rng.uniform(0.2, 0.6)),
                         "class": int(rng.randint(1, 3)), "ct": ct,
                         "tracking": rng.randn(2).astype(np.float32),
                         "bbox": np.concatenate([ct - 8, ct + 8]).astype(
                             np.float32)})
        dets.sort(key=lambda d: -d["score"])
        clip.append(dets)
    return clip


def _public(dets, rng):
    """Public detections near the frame's, some dropped."""
    return [{"bbox": (d["bbox"] + rng.randn(4)).tolist(),
             "ct": (d["ct"] + rng.randn(2) * 0.5).tolist(),
             "score": d["score"], "class": d["class"]}
            for d in dets if rng.rand() > 0.2]


def _state(ret):
    return [(d["tracking_id"], d["age"], d["active"], d["class"],
             np.asarray(d["bbox"], np.float32).tobytes()) for d in ret]


@pytest.mark.parametrize("mode", ["greedy", "hungarian", "public",
                                  "public_hungarian"])
def test_tracker_matches_jax_over_a_clip(mode):
    kw = dict(track_thresh=0.3, max_age=3,
              hungarian="hungarian" in mode, public_det="public" in mode)
    cfg, jcfg = _cfgs(**kw)
    clip = _clip(11)
    rng = np.random.RandomState(5)
    pubs = [_public(d, rng) for d in clip]
    port, ref = Tracker(cfg), JTracker(jcfg)
    if "public" in mode:
        seed = [dict(d, score=0.9) for d in pubs[0]]
        port.init_track(copy.deepcopy(seed))
        ref.init_track(copy.deepcopy(seed))
    births = 0
    for dets, pub in zip(clip, pubs):
        kept = [d for d in dets if d["score"] > cfg.out_thresh]
        got = port.step(copy.deepcopy(kept),
                        copy.deepcopy(pub) if cfg.public_det else None)
        want = ref.step(copy.deepcopy(kept),
                        copy.deepcopy(pub) if cfg.public_det else None)
        assert _state(got) == _state(want)
        assert _state(port.tracks) == _state(ref.tracks)
        assert port.id_count == ref.id_count
        births = port.id_count
    assert births > 5
    # a matched track's displacement keeps its id across frames
    assert any(d["active"] > 2 for d in port.tracks)


def test_tracker_mutates_its_inputs_as_jax():
    """The returned dicts are the given ones, and a later step ages them
    in place: the tests above deep-copy every frame for that reason."""
    cfg, _ = _cfgs(track_thresh=0.3, max_age=3)
    clip = _clip(2, frames=2)
    port = Tracker(cfg)
    first = [d for d in clip[0] if d["score"] > cfg.out_thresh]
    ret = port.step(first)
    assert all(a is b for a, b in zip(ret, first))
    port.step([])
    assert all(d["active"] == 0 and d["age"] == 2 for d in first)


# ---- init_from_dets ---------------------------------------------------------
@pytest.mark.parametrize("capacity", [8, 32])
def test_init_from_dets_matches_jax(capacity):
    rng = np.random.RandomState(capacity)
    s, k = 3, 20
    scores = rng.rand(s, k).astype(np.float32)
    classes = rng.randint(1, 3, (s, k)).astype(np.int32)
    cts = rng.uniform(0, 100, (s, k, 2)).astype(np.float32)
    bboxes = rng.uniform(0, 100, (s, k, 4)).astype(np.float32)
    got = dt.init_from_dets(capacity, torch.from_numpy(scores),
                            torch.from_numpy(classes), torch.from_numpy(cts),
                            torch.from_numpy(bboxes), 0.3, device="cpu")
    for i in range(s):
        want = jdt.init_from_dets(capacity, jnp.asarray(scores[i]),
                                  jnp.asarray(classes[i]),
                                  jnp.asarray(cts[i]), jnp.asarray(bboxes[i]),
                                  0.3)
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w),
                                          err_msg=name)
    assert int(got.id_count.max()) > capacity or capacity > 8
