"""Pose tracking (tracking,multi_pose) in the port against the JAX
package on the CPU: set_heads and the COCO keypoints meta, the keypoint
decode (hm_hp snapping, with and without hp_offset, peaks under the
threshold, without boxes), the post-process, FusedDetector.fetch_full,
the host Detector with the flip test, the selftest's pose clip
(annotations and JPEG bytes), and cli/demo.py.

The serving tests run the committed assets/selftest_pose_fp16.ckpt at
dla_node dcn_local1 and a 256x256 input over 3 frames of the held-out
clip (1280x720, seed 99); rows are held as in test_torch_port_ddd.py,
the keypoints within 1e-4 px and one part in 1e6.
"""

import copy
import json
import os

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
from centertrack_tpu_torch.cli import demo
from centertrack_tpu_torch.config import Config, set_heads
from centertrack_tpu_torch.data import datasets
from centertrack_tpu_torch.data.registry import get_dataset_meta
from centertrack_tpu_torch.engine import detector, post_process
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.ops import decode
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

HW = (256, 256)
POSE_EXTRAS = ("hps", "kps_score")


@pytest.fixture(scope="module")
def weights():
    return load_jax_ckpt(tt.ckpt("pose"))


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pose"))
    return root, tt.clip("pose", root)


# ---- config ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"hp_weight": 0.0}, {"hm_hp_weight": 0.0, "off_weight": 0.5},
    {"velocity": True, "hp_weight": 2.0}, {"off_weight": 0.0}])
@pytest.mark.parametrize("task", ["tracking,multi_pose", "multi_pose"])
def test_set_heads_matches_jax(task, kw):
    m = get_dataset_meta("coco_hp")
    cfg = set_heads(Config(task=task, **kw), m)
    jcfg = jset_heads(JConfig(task=task, **kw), m)
    assert cfg.heads == jcfg.heads and cfg.weights == jcfg.weights
    assert (cfg.input_h, cfg.input_w, cfg.num_classes) == (512, 512, 1)


def test_coco_hp_meta_matches_jax():
    from centertrack_tpu.data.registry import get_dataset_meta as jmeta
    m, j = get_dataset_meta("coco_hp"), jmeta("coco_hp")
    for key in ("num_categories", "default_resolution", "num_joints",
                "flip_idx", "rest_focal_length", "class_name", "cat_ids",
                "max_objs"):
        assert getattr(m, key) == getattr(j, key), key
    np.testing.assert_array_equal(np.asarray(m.mean).ravel(),
                                  np.asarray(j.mean).ravel())


# ---- decode and post-process ---------------------------------------------

def _pose_maps(rng, heads, low, b=2, h=20, w=24, j=5):
    """Pose head maps; ``low``: most hm_hp peaks under the 0.2 snapping
    threshold, so many snapped positions tie at -10000."""
    out = {"hm": rng.randn(b, h, w, 1).astype(np.float32) * 2}
    sizes = {"reg": 2, "wh": 2, "tracking": 2, "hps": 2 * j, "hm_hp": j,
             "hp_offset": 2}
    for head in heads:
        out[head] = (rng.randn(b, h, w, sizes[head]) * 3).astype(np.float32)
    if low:
        out["hm_hp"] = out["hm_hp"] / 3 - 3.5
    return out


@pytest.mark.parametrize("heads,low", [
    (("reg", "wh", "hps", "hm_hp", "hp_offset"), False),
    (("reg", "wh", "hps", "hm_hp", "hp_offset"), True),
    (("reg", "wh", "hps", "hm_hp"), False),
    (("wh", "hps", "hm_hp"), True),
    (("reg", "hps", "hm_hp", "hp_offset"), False),
    (("reg", "wh", "hps"), False)])
def test_keypoint_decode_matches_jax(heads, low):
    rng = np.random.RandomState(len(heads) + 10 * low)
    maps = _pose_maps(rng, heads, low)
    got = decode.generic_decode(decode.sigmoid_output(
        {k: torch.from_numpy(v) for k, v in maps.items()}), 30, 1)
    want = jdecode.generic_decode(jdecode.sigmoid_output(
        {k: jnp.asarray(v) for k, v in maps.items()}), 30, 1)
    assert set(got) == set(want) and "hps" in got
    np.testing.assert_array_equal(got["inds"].numpy(),
                                  np.asarray(want["inds"]))
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    if low:   # most of each joint's K peaks were masked to -10000
        hm_hp = jdecode.sigmoid_output({"hm": jnp.zeros(1), "hm_hp":
                                        jnp.asarray(maps["hm_hp"])})["hm_hp"]
        peaks = jdecode.topk_channel(jdecode.nms_heat(hm_hp), 30)[0]
        assert (np.asarray(peaks) <= 0.2).mean() > 0.5


def test_post_process_pose_matches_jax():
    cfg, jcfg = tt.cfgs("pose", HW)
    rng = np.random.RandomState(3)
    b, k = 2, 30
    dets = {"scores": -np.sort(-rng.rand(b, k).astype(np.float32), 1),
            "clses": np.zeros((b, k), np.float32),
            "cts": rng.uniform(0, 64, (b, k, 2)).astype(np.float32),
            "tracking": rng.randn(b, k, 2).astype(np.float32),
            "bboxes": np.sort(rng.uniform(0, 64, (b, k, 2, 2)), 2).reshape(
                b, k, 4).astype(np.float32),
            "hps": rng.uniform(0, 64, (b, k, 34)).astype(np.float32),
            "kps_score": rng.rand(b, k).astype(np.float32)}
    c = [np.float32([640, 360])] * 2
    s = [1280.0] * 2
    got = post_process.generic_post_process(cfg, dets, c, s, 64, 64)
    want = jpost.generic_post_process(jcfg, dets, c, s, 64, 64)
    assert sum(map(len, got)) > 10
    for gi, wi in zip(got, want):
        assert len(gi) == len(wi)
        for g, w in zip(gi, wi):
            assert g.keys() == w.keys() and g["hps"].shape == (34,)
            for key in g:
                np.testing.assert_allclose(
                    np.asarray(g[key], np.float64),
                    np.asarray(w[key], np.float64), rtol=1e-5, atol=1e-5,
                    err_msg=key)


# ---- the serving engines --------------------------------------------------

def test_fused_pose_matches_jax(weights, clip_dir):
    cfg, jcfg = tt.cfgs("pose", HW)
    m = tt.meta("pose", HW)
    det = FusedDetector(cfg, *weights, m, device="cpu")
    jdet = JFusedDetector(jcfg, *weights, dataset_meta=m)
    assert det.width == 13 + 35
    id_map, n = {}, 0
    for frame in clip_dir[1][0]:
        packed = det.run(frame)
        assert packed.shape == (cfg.K, 48)
        got = det.fetch_full(packed, cfg.out_thresh)
        want = jdet.fetch_full(jdet.run(frame), jcfg.out_thresh)
        n += tt.compare_rows(got, want, id_map, POSE_EXTRAS)
        assert all(set(d) == {"score", "class", "ct", "tracking", "bbox",
                              "tracking_id", "age", "active", "hps",
                              "kps_score"} for d in got)
    assert n >= 3


def test_fused_pose_bf16_matches_jax_bf16(weights, clip_dir):
    """bf16 serving (bench.py's precision) against JAX's bf16 over the
    three frames (tt.compare_bf16; measured: scores 3.1e-3, boxes
    0.46 px, keypoints 0.31 px of the 1280x720 frame, kps_score
    3.3e-3)."""
    assert tt.compare_bf16("pose", weights, HW, clip_dir[1][0],
                           POSE_EXTRAS) >= 3


@pytest.fixture(scope="module")
def bf16_maps(weights):
    return tt.bf16_head_maps("pose", weights)


@pytest.mark.parametrize("head", ["hps", "hm_hp", "hp_offset"])
def test_bf16_network_pose_heads_match_jax_bf16(bf16_maps, head):
    """The pose heads of bf16 serving's network against JAX's bf16 ones
    (tt.check_bf16_head; measured: 1.20x to 1.59x JAX's own
    bf16-vs-float32 distance, at most 1.6e-2 of the map's largest
    value)."""
    tt.check_bf16_head(bf16_maps, head)


def test_host_detector_flip_pose_matches_jax(weights, clip_dir):
    """flip_test merges hps and hm_hp through COCO's flip_idx."""
    cfg, jcfg = tt.cfgs("pose", HW, flip_test=True)
    m = tt.meta("pose", HW)
    port = detector.Detector(cfg, *weights, m, device="cpu")
    ref = jdetector.Detector(jcfg, *weights, m)
    n, id_map = 0, {}
    for frame in clip_dir[1][0]:
        got = copy.deepcopy(port.run(frame)["results"])
        want = copy.deepcopy(ref.run(frame)["results"])
        assert [g["tracking_id"] for g in got] == [
            w["tracking_id"] for w in want]
        n += tt.compare_rows(got, want, id_map, ("hps",))
    assert n >= 3 and port.pre_images.shape == (2, 256, 256, 3)


# ---- the selftest's clip --------------------------------------------------

def test_make_dataset_pose_matches_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    pa, pi = selftest.make_dataset_pose(a, num_videos=1, frames=2, seed=4)
    ja, ji = jselftest.make_dataset_pose(b, num_videos=1, frames=2, seed=4)
    with open(pa) as f, open(ja) as g:
        assert f.read() == g.read()
    names = sorted(os.listdir(ji))
    assert sorted(os.listdir(pi)) == names and len(names) == 2
    for name in names:
        with open(os.path.join(pi, name), "rb") as f, \
                open(os.path.join(ji, name), "rb") as g:
            assert f.read() == g.read(), name


def test_coco_hp_loading_raises_naming_a9c():
    cfg, _ = tt.cfgs("pose", HW)
    with pytest.raises(NotImplementedError, match="A9c"):
        datasets.get_dataset("coco_hp")(cfg, "val")


# ---- cli/demo.py ----------------------------------------------------------

def _demo(folder, *flags):
    return ["tracking,multi_pose", "--demo", folder, "--load_model",
            tt.ckpt("pose"), "--dla_node", "dcn_local1", "--pre_hm",
            "--input_h", "256", "--input_w", "256", "--device", "cpu",
            "--save_results", *flags]


def test_demo_fused_and_chunk_match_the_host_detector(clip_dir, tmp_path,
                                                      monkeypatch):
    """The demo over the clip's 3 JPEGs: --fused and --chunk 2 save the
    host Detector's tracks (ids, boxes, keypoints), keyed by frame."""
    monkeypatch.chdir(tmp_path)
    folder = os.path.join(clip_dir[0], "images")
    saved = {}
    for name, flags in (("host", ()), ("fused", ("--fused",)),
                        ("chunk", ("--chunk", "2"))):
        demo.main(_demo(folder, *flags))
        with open("demo_results_tracking_multi_pose.json") as f:
            saved[name] = json.load(f)
    assert sorted(saved["host"]) == ["1", "2", "3"]
    n = 0
    for name in ("fused", "chunk"):
        assert saved[name].keys() == saved["host"].keys()
        for frame, want in saved["host"].items():
            got = saved[name][frame]
            assert [g["tracking_id"] for g in got] == [
                w["tracking_id"] for w in want]
            for g, w in zip(got, want):
                assert abs(g["score"] - w["score"]) <= tt.SCORE_TOL
                for key in ("bbox", "ct", "hps"):
                    np.testing.assert_allclose(g[key], w[key], atol=1e-3,
                                               rtol=0, err_msg=key)
                n += 1
    assert n >= 6


@pytest.mark.parametrize("flags", [("--demo", "clip.mp4"),
                                   ("--demo", "webcam"),
                                   ("--demo", ".", "--save_video")])
def test_demo_video_raises_naming_a14(flags):
    argv = ["tracking,multi_pose", "--device", "cpu", *flags]
    with pytest.raises(NotImplementedError, match="A14"):
        demo.main(argv)
