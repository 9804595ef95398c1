"""Shared pieces of tests/test_torch_port_ddd.py and
test_torch_port_pose.py: the two tasks' small configurations, their
clips (the port's selftest generators, JAX's bytes) and the comparison
of fetched rows with JAX's."""

import json
import os

import numpy as np

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.data.registry import get_dataset_meta
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils import image_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 2D columns as tests/test_torch_port_engine.py holds them; the
# extras to 1e-4 and one part in 1e6 of their size (image-pixel
# coordinates near 1000 are a few float32 ulps apart at 1e-4)
SCORE_TOL = 1e-4
BOX_TOL = 1e-2
EXTRA_ATOL = 1e-4
EXTRA_RTOL = 1e-6
ANGLES = ("alpha", "rot_y")
# bf16 against JAX's bf16 (tests/test_torch_port_bf16.py's rule for the 2D
# rows, with boxes to half an input pixel: the clips' weak detections at
# a tenth of their frame's size move further than the 2D test's): the
# extras to two bf16 ulps of their heads' outputs carried through the
# lift (dep = exp(-x) of its head's x, so its relative error is x's
# absolute one), the keypoints as the boxes, kps_score as the scores
BF16_SCORE_TOL = 2e-2
BF16_BOX_INPUT_PX = 0.5
BF16_EXTRA_TOL = {"dep": (3e-2, 3e-2), "dim": (3e-2, 3e-2),
                  "loc": (3e-2, 3e-2), "alpha": (0.0, 3e-2),
                  "rot_y": (0.0, 3e-2), "kps_score": (0.0, BF16_SCORE_TOL)}
# the checkpoints' tasks: task string, classes, threshold, input, clip
TASKS = {
    "ddd": dict(task="tracking,ddd", num_classes=10, track_thresh=0.1,
                ckpt="selftest_ddd_fp16.ckpt", make="make_dataset_ddd",
                dataset="nuscenes"),
    "pose": dict(task="tracking,multi_pose", num_classes=1,
                 track_thresh=0.3, ckpt="selftest_pose_fp16.ckpt",
                 make="make_dataset_pose", dataset="coco_hp"),
}


def meta(name, hw):
    """The task's dataset meta (data/datasets.NuScenes, COCOHP) at input
    ``hw``."""
    return type(f"{name}Meta", (get_dataset_meta(TASKS[name]["dataset"]),),
                {"default_resolution": list(hw)})


def cfgs(name, hw, **kw):
    """(port cfg, JAX cfg) of the task at input ``hw``."""
    spec = TASKS[name]
    args = dict(task=spec["task"], pre_hm=True, dla_node="dcn_local1",
                track_thresh=spec["track_thresh"],
                new_thresh=spec["track_thresh"], max_age=3, **kw)
    m = meta(name, hw)
    return (set_heads(parse_task(Config(**args)), m),
            jset_heads(jparse_task(JConfig(**args)), m))


def ckpt(name):
    return os.path.join(ROOT, "assets", TASKS[name]["ckpt"])


def clip(name, root, frames=3, seed=99):
    """The task's clip as (frames, image records, annotations)."""
    ann, img_dir = getattr(selftest, TASKS[name]["make"])(
        root, num_videos=1, frames=frames, seed=seed)
    with open(ann) as f:
        db = json.load(f)
    return ([image_io.read(os.path.join(img_dir, im["file_name"]))
             for im in db["images"]], db["images"], db["annotations"])


def close(a, b, key, atol=EXTRA_ATOL, rtol=EXTRA_RTOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if key in ANGLES:
        # compare modulo 2 pi: rot_y wraps at +/- pi
        a = b + np.remainder(a - b + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=key)


def compare_rows(got, want, id_map, extras=(), score_tol=SCORE_TOL,
                 box_tol=BOX_TOL, extra_tol=None, out_thresh=None):
    """Fetched rows in order: the 2D columns as the engine test holds
    them, each extra within EXTRA_ATOL / EXTRA_RTOL (or ``extra_tol``'s
    (rtol, atol); angles modulo 2 pi), track ids a consistent map. With
    ``out_thresh``, rows within ``score_tol`` of it in either list are
    left out first (a bf16 score that close may fall on either side).
    Returns the rows compared."""
    if out_thresh is not None:
        got, want = ([d for d in rows if abs(d["score"] - out_thresh)
                      > score_tol] for rows in (got, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a["score"] - b["score"]) <= score_tol
        assert a["class"] == b["class"]
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=box_tol,
                                   rtol=0)
        np.testing.assert_allclose(a["ct"], b["ct"], atol=box_tol, rtol=0)
        assert id_map.setdefault(a["tracking_id"],
                                 b["tracking_id"]) == b["tracking_id"]
        assert set(a) == set(b)
        for key in extras:
            if extra_tol is None:
                close(a[key], b[key], key)
            else:
                rtol, atol = extra_tol[key]
                close(a[key], b[key], key, atol=atol, rtol=rtol)
    return len(got)


def bf16_head_maps(name, weights, hw=(64, 96)):
    """Both packages' networks of the task on its committed weights at
    compute_dtype bfloat16, and JAX's at float32, on the same seeded
    inputs (image, previous image, pre_hm) at ``hw``: {"port_bfloat16",
    "jax_bfloat16", "jax_float32"} -> {head: float32 map}."""
    import jax
    import torch
    from centertrack_tpu.models.model import create_model as jcreate
    from centertrack_tpu_torch.models.model import (create_model,
                                                    params_from_jax)
    params, batch_stats = weights
    rng = np.random.RandomState(0)
    ins = (rng.randn(1, *hw, 3).astype(np.float32),
           rng.randn(1, *hw, 3).astype(np.float32),
           rng.rand(1, *hw, 1).astype(np.float32))
    outs = {}
    for dtype in ("bfloat16", "float32"):
        _, jcfg = cfgs(name, hw, compute_dtype=dtype)
        jmodel = jcreate(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                         jcfg)
        jout = jax.jit(lambda v, a, b, c: jmodel.apply(
            v, a, b, c, train=False))(
            {"params": params, "batch_stats": batch_stats}, *ins)[-1]
        outs["jax_" + dtype] = {k: np.asarray(v) for k, v in jout.items()}
    cfg, _ = cfgs(name, hw, compute_dtype="bfloat16")
    model = create_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(params, batch_stats), strict=True)
    with torch.no_grad():
        out = model(*map(torch.from_numpy, ins))[-1]
    outs["port_bfloat16"] = {k: v.contiguous().numpy()
                             for k, v in out.items()}
    return outs


def check_bf16_head(maps, head):
    """tests/test_torch_port_bf16.py's rule for the 2D heads: the port's
    bf16 map within 4e-2 of max|JAX's bf16 map| of it, and within 3x
    the distance of JAX's bf16 map from its float32 one (the two
    frameworks round each layer's bf16 output at other points, and
    one-ulp flips grow through ~40 layers)."""
    ref = maps["jax_bfloat16"][head]
    got = maps["port_bfloat16"][head]
    assert ref.dtype == got.dtype == np.float32 and got.shape == ref.shape
    own = np.abs(ref - maps["jax_float32"][head]).max()
    diff = np.abs(got - ref).max()
    assert own > 0
    assert diff <= 4e-2 * np.abs(ref).max(), (diff, np.abs(ref).max())
    assert diff <= 3 * own, (diff, own)


def compare_bf16(name, weights, hw, frames, extras):
    """The task's FusedDetector at compute_dtype bfloat16 against JAX's
    (both at warp_precision "highest": XLA on the CPU runs the warp in
    float32 whatever its precision) over ``frames``, fetch_full's rows
    held by compare_rows at the BF16_* tolerances. Returns the rows
    compared."""
    from centertrack_tpu.engine.fused import FusedDetector as JFused
    from centertrack_tpu_torch.engine.fused import FusedDetector
    cfg, jcfg = cfgs(name, hw, compute_dtype="bfloat16",
                     warp_precision="highest")
    m = meta(name, hw)
    det = FusedDetector(cfg, *weights, m, device="cpu")
    jdet = JFused(jcfg, *weights, dataset_meta=m)
    assert str(det.model.dtype) == "torch.bfloat16"
    box_tol = BF16_BOX_INPUT_PX * frames[0].shape[1] / hw[1]
    tol = dict(BF16_EXTRA_TOL, hps=(0.0, box_tol))
    id_map, n = {}, 0
    for frame in frames:
        got = det.fetch_full(det.run(frame), cfg.out_thresh)
        want = jdet.fetch_full(jdet.run(frame), jcfg.out_thresh)
        n += compare_rows(got, want, id_map, extras, BF16_SCORE_TOL,
                          box_tol, tol, cfg.out_thresh)
    assert len(set(id_map.values())) == len(id_map)
    return n
