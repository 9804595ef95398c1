"""The ltrb and ltrb_amodal heads of MOT17's and CrowdHuman's recipe in
the port (centertrack_tpu_torch: config.set_heads, data.generic targets,
ops.decode.generic_decode, ops.losses, engine.fused, engine.trainer)
against the JAX package on the CPU, with ltrb, ltrb_amodal and both.

The networks carry the committed checkpoints' weights over; each box
head starts from the checkpoint's wh head (its first conv, and sides of
+/-0.5 wh around the peak for ltrb, +/-0.55 wh for ltrb_amodal, plus
seeded noise of 1e-3), so that the boxes and the tracks drawn from them
are real ones.

Tolerances: heads and weights equal; dataset targets exactly (on JAX's
own JPEG fixture, tests/fixtures.py, with the recipe's flags) and the
images within one warp level (tests/test_torch_port_data.py); decode
within rel 1e-5; loss terms within rel 1e-5; the fused step's rows as
tests/test_torch_port_engine.py holds them (scores 1e-4, boxes 1e-2 px,
track ids a bijection), also for MultiStreamDetector, and run_chunk bit
for bit the port's own run. One training step with both heads is held
against JAX's in tests/test_torch_port_ltrb_step.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.data import datasets as jdatasets
from centertrack_tpu.engine.fused import FusedDetector as JFusedDetector
from centertrack_tpu.engine.fused import \
    MultiStreamDetector as JMultiStreamDetector
from centertrack_tpu.ops import decode as jdecode
from centertrack_tpu.ops import losses as jlosses
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.data import datasets, generic
from centertrack_tpu_torch.engine.fused import (FusedDetector,
                                                MultiStreamDetector)
from centertrack_tpu_torch.ops import decode, losses
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils import image_io
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt
from tests.fixtures import make_tiny_tracking_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {"dcn_local": os.path.join(ROOT, "assets",
                                   "selftest_local1_fp16.ckpt"),
         "dcn": os.path.join(ROOT, "assets", "selftest_dcn_fp16.ckpt")}
VARIANTS = {"ltrb": dict(ltrb=True), "ltrb_amodal": dict(ltrb_amodal=True),
            "both": dict(ltrb=True, ltrb_amodal=True)}
BOX_HEADS = ("ltrb", "ltrb_amodal")
# half-sides of each box head, in units of the wh head's output
SIDE_SCALE = {"ltrb": 0.5, "ltrb_amodal": 0.55}
# experiments/mot17_half.sh:3-6 (with the defaults' augmentation)
RECIPE = dict(pre_hm=True, same_aug_pre=True, hm_disturb=0.05,
              lost_disturb=0.4, fp_disturb=0.1)
STD_MIN = float(generic.GenericDataset.std.min())
LEVEL_TOL = 3.0 / 255.0 / STD_MIN


def _meta(h, w):
    class Meta:
        num_categories = 1
        default_resolution = [h, w]
        num_joints = 17
        rest_focal_length = 1200
        flip_idx = []
        mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
        std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)
    return Meta


def _cfgs(variant, h=96, w=160, **kw):
    args = dict(task="tracking", **VARIANTS[variant], **kw)
    meta = _meta(h, w)
    return (set_heads(parse_task(Config(**args)), meta),
            jset_heads(jparse_task(JConfig(**args)), meta))


def with_box_heads(params, heads, seed=0):
    """``params`` with each box head of ``heads`` carried over from its wh
    head (the module docstring's construction)."""
    rng = np.random.RandomState(seed)
    wh = params["heads"]["wh"]
    kernel = np.asarray(wh["out"]["kernel"], np.float32)
    bias = np.asarray(wh["out"]["bias"], np.float32)
    out = dict(params, heads=dict(params["heads"]))
    for name in BOX_HEADS:
        if name not in heads:
            continue
        s = SIDE_SCALE[name]
        k = np.concatenate([-s * kernel, s * kernel], axis=3)
        k = k + 1e-3 * rng.randn(*k.shape).astype(np.float32)
        out["heads"][name] = {
            "conv_0": {n: np.array(v) for n, v in wh["conv_0"].items()},
            "out": {"kernel": k.astype(np.float32),
                    "bias": (np.concatenate([-s * bias, s * bias]) + 0.5
                             ).astype(np.float32)}}
    return out


# ---- config -------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("weights", [{}, {"ltrb_weight": 0.0},
                                     {"ltrb_amodal_weight": 0.3}])
def test_heads_and_weights_match_jax(variant, weights):
    cfg, jcfg = _cfgs(variant, **weights)
    assert list(cfg.heads_dict.items()) == list(jcfg.heads_dict.items())
    assert cfg.weights_dict == jcfg.weights_dict
    for field in ("ltrb", "ltrb_weight", "ltrb_amodal",
                  "ltrb_amodal_weight"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


# ---- dataset targets ------------------------------------------------------
@pytest.fixture(scope="module")
def jpeg_fixture(tmp_path_factory):
    """JAX's own fixture: two 4-frame videos of 96x64 JPEG frames."""
    return make_tiny_tracking_dataset(str(tmp_path_factory.mktemp("fix")))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dataset_targets_match_jax(variant, jpeg_fixture):
    """Every item of both splits at two seeds: each target exactly, the
    images within a warp level; the box targets written, and some
    amodal boxes past the clipped ones (objects cut by the crop)."""
    ann, img_dir = jpeg_fixture
    cfg, jcfg = _cfgs(variant, 64, 96, dataset="custom", num_classes=1,
                      custom_dataset_ann_path=ann,
                      custom_dataset_img_path=img_dir, **RECIPE)
    written = {h: 0 for h in BOX_HEADS if h in cfg.heads_dict}
    amodal_past = 0
    for split in ("train", "val"):
        ds = datasets.CustomDataset(cfg, split)
        jds = jdatasets.CustomDataset(jcfg, split)
        for index in range(len(ds)):
            for s in (3, 100 + index):
                ds.rng = np.random.RandomState(s)
                ds._data_rng = np.random.RandomState(s + 7)
                got = ds[index]
                np.random.seed(s)
                jds._data_rng = np.random.RandomState(s + 7)
                ref = jds[index]
                assert set(got) == set(ref)
                for k in ref:
                    where = f"{split} {index} {s} {k}"
                    if k in ("image", "pre_img"):
                        diff = np.abs(got[k] - ref[k])
                        assert diff.max() <= LEVEL_TOL, where
                        assert (diff > 1e-4).mean() <= 0.01, where
                        continue
                    assert got[k].dtype == ref[k].dtype, where
                    np.testing.assert_array_equal(got[k], ref[k], where)
                for h in written:
                    written[h] += int(got[h + "_mask"].sum())
                if len(written) == 2:
                    amodal_past += int((got["ltrb"] != got["ltrb_amodal"])
                                       .any(axis=1).sum())
    assert all(n > 0 for n in written.values()), written
    if len(written) == 2:
        assert amodal_past > 0


# ---- decode ---------------------------------------------------------------
def _head_maps(heads, seed, b=2, h=12, w=16):
    rng = np.random.RandomState(seed)
    maps = {"hm": rng.rand(b, h, w, 1).astype(np.float32)}
    for name in heads:
        if name != "hm":
            maps[name] = (rng.randn(b, h, w, heads[name]) * 3).astype(
                np.float32)
    return maps


@pytest.mark.parametrize("with_reg", [True, False])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generic_decode_matches_jax(variant, with_reg):
    cfg, _ = _cfgs(variant)
    heads = dict(cfg.heads_dict)
    if not with_reg:
        heads.pop("reg")
    maps = _head_maps(heads, seed=len(heads) + 10 * with_reg)
    ref = jdecode.generic_decode({k: jnp.asarray(v) for k, v in maps.items()},
                                 k=20, num_classes=1)
    got = decode.generic_decode({k: torch.from_numpy(v)
                                 for k, v in maps.items()}, k=20,
                                num_classes=1)
    assert set(got) == set(ref)
    assert ("bboxes_amodal" in got) == ("ltrb_amodal" in heads)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if "ltrb_amodal" in heads:
        assert torch.equal(got["bboxes"], got["bboxes_amodal"])


# ---- losses ---------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_terms_match_jax(variant):
    cfg, jcfg = _cfgs(variant, ltrb_weight=0.2)
    heads = cfg.heads_dict
    rng = np.random.RandomState(len(heads))
    b, h, w, m = 2, 8, 8, 4
    outputs = {k: rng.randn(b, h, w, c).astype(np.float32)
               for k, c in heads.items()}
    outputs["hm"] -= 2
    batch = {"hm": rng.rand(b, h, w, 1).astype(np.float32) ** 6,
             "ind": rng.randint(0, h * w, (b, m)).astype(np.int64),
             "mask": np.ones((b, m), np.float32),
             "cat": np.zeros((b, m), np.int64)}
    for name, c in heads.items():
        if name != "hm":
            batch[name] = rng.randn(b, m, c).astype(np.float32)
            batch[name + "_mask"] = (rng.rand(b, m, c) > 0.2).astype(
                np.float32)
    jtot, jl = jlosses.generic_loss(
        [{k: jnp.asarray(v) for k, v in outputs.items()}],
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg.heads_dict,
        jcfg.weights_dict)
    tot, tl = losses.generic_loss(
        [{k: torch.from_numpy(v) for k, v in outputs.items()}],
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg.heads_dict,
        cfg.weights_dict)
    assert set(tl) == set(jl) and set(BOX_HEADS) & set(tl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                   err_msg=k)


# ---- the fused step -------------------------------------------------------
@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Two videos of three 160x96 JPEG frames of the selftest's hard
    domain (the checkpoints' training domain), read as the port reads
    them: {video id: frames}."""
    root = str(tmp_path_factory.mktemp("clip"))
    ann, img_dir = selftest.make_dataset(root, num_videos=2, frames=3,
                                         hard=True, seed=1)
    with open(ann) as f:
        images = json.load(f)["images"]
    out = {}
    for im in images:
        out.setdefault(im["video_id"], []).append(
            image_io.read(os.path.join(img_dir, im["file_name"])))
    return out


def _compare(got, ref, id_map):
    """Rows above out_thresh in order, as tests/test_torch_port_engine.py
    compares them; returns the rows compared."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert abs(a["score"] - b["score"]) <= 1e-4
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-2, rtol=0)
        np.testing.assert_allclose(a["ct"], b["ct"], atol=1e-2, rtol=0)
        assert id_map.setdefault(a["tracking_id"],
                                 b["tracking_id"]) == b["tracking_id"]
    return len(got)


def _detector_cfgs(node, variant):
    return _cfgs(variant, pre_hm=True, track_thresh=0.3, new_thresh=0.3,
                 max_age=3, dla_node=node)


@pytest.mark.parametrize("node,variant", [("dcn_local", "ltrb"),
                                          ("dcn_local", "ltrb_amodal"),
                                          ("dcn_local", "both"),
                                          ("dcn", "ltrb_amodal")])
def test_fused_rows_match_jax(node, variant, videos):
    """Three frames through both FusedDetectors at float32: the rows
    above out_thresh (the boxes, and so the next frame's pre_hm, are the
    amodal head's where the net has one)."""
    cfg, jcfg = _detector_cfgs(node, variant)
    params, batch_stats = load_jax_ckpt(CKPTS[node])
    params = with_box_heads(params, cfg.heads_dict)
    meta = _meta(96, 160)
    det = FusedDetector(cfg, params, batch_stats, meta, device="cpu")
    jdet = JFusedDetector(jcfg, params=params, batch_stats=batch_stats,
                          dataset_meta=meta)
    id_map, n_rows = {}, 0
    for frame in videos[2]:
        n_rows += _compare(
            FusedDetector.fetch(det.run(frame), cfg.out_thresh),
            JFusedDetector.fetch(jdet.run(frame), jcfg.out_thresh), id_map)
    assert len(set(id_map.values())) == len(id_map)
    assert n_rows >= 4 and len(id_map) >= 2


def test_multistream_and_run_chunk_with_ltrb_amodal(videos):
    """MultiStreamDetector at dcn with ltrb_amodal, the two videos as two
    streams over three steps: each stream's rows against JAX's
    MultiStreamDetector (its amodal boxes, engine/fused.py:623); and
    run_chunk over a video bit for bit the port's run per frame."""
    cfg, jcfg = _detector_cfgs("dcn", "ltrb_amodal")
    params, batch_stats = load_jax_ckpt(CKPTS["dcn"])
    params = with_box_heads(params, cfg.heads_dict)
    meta = _meta(96, 160)
    det = MultiStreamDetector(cfg, 2, params, batch_stats, meta,
                              device="cpu")
    jdet = JMultiStreamDetector(jcfg, 2, params=params,
                                batch_stats=batch_stats, dataset_meta=meta)
    id_maps, n = [{}, {}], 0
    for images in zip(videos[1], videos[2]):
        got = MultiStreamDetector.fetch_all(det.run(np.stack(images)),
                                            cfg.out_thresh)
        ref = JMultiStreamDetector.fetch_all(jdet.run(np.stack(images)),
                                             jcfg.out_thresh)
        for s in range(2):
            n += _compare(got[s], ref[s], id_maps[s])
    assert n >= 8 and all(id_maps)
    chunked = FusedDetector(cfg, params, batch_stats, meta, device="cpu")
    single = FusedDetector(cfg, params, batch_stats, meta, device="cpu")
    packed = chunked.run_chunk(videos[2])
    assert torch.equal(packed, torch.stack([single.run(f)
                                            for f in videos[2]]))
