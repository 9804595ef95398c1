"""One training step of the port with MOT17's box heads (ltrb and
ltrb_amodal, both) against JAX's on the CPU: DLA-34 dcn_local1 at 64x64,
B=2, the committed checkpoint's weights with each box head carried over
from its wh head (tests/test_torch_port_ltrb.py's ``with_box_heads``).
Tolerances: every loss term within rel 1e-5, every gradient leaf at the
bound of tests/test_torch_port_train.py."""

import os

import jax
import numpy as np
import torch

from centertrack_tpu.engine.trainer import Trainer as JTrainer
from centertrack_tpu.models.model import create_model as jcreate_model
from centertrack_tpu.parallel.mesh import make_mesh
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models.model import (create_model,
                                                params_from_jax,
                                                params_to_jax)
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt
from tests.test_torch_port_ltrb import BOX_HEADS, _cfgs, with_box_heads

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
SIZE = 64


def _step_batch(b=2, m=4, seed=0):
    """tests/test_torch_port_train.py's descriptor batch with both box
    targets: sides around each centre, the amodal ones past the map."""
    rng = np.random.RandomState(seed)
    out = SIZE // 4
    cts = rng.randint(1, out - 1, (b, m, 2)).astype(np.int32)
    half = rng.uniform(1, out / 4, (b, m, 2)).astype(np.float32)
    ltrb = np.concatenate([-half, half], -1)
    batch = {
        "image": rng.randn(b, SIZE, SIZE, 3).astype(np.float32),
        "pre_img": rng.randn(b, SIZE, SIZE, 3).astype(np.float32),
        "ind": (cts[..., 1] * out + cts[..., 0]).astype(np.int64),
        "cat": np.zeros((b, m), np.int64),
        "mask": np.ones((b, m), np.float32),
        "hm_cts": cts,
        "hm_radii": rng.randint(0, 3, (b, m)).astype(np.int32),
        "hm_valid": np.ones((b, m), bool),
        "ignore_boxes": np.zeros((b, 2, 4), np.float32),
        "ignore_cat": np.zeros((b, 2), np.int32),
        "ignore_valid": np.zeros((b, 2), bool),
        "pre_cts_int": (cts * 4 + rng.randint(-3, 4, (b, m, 2))).astype(
            np.int32),
        "pre_radii": rng.randint(1, 5, (b, m)).astype(np.int32),
        "pre_ks": np.ones((b, m), np.float32),
        "pre_valid": rng.rand(b, m) > 0.2,
        "reg": rng.rand(b, m, 2).astype(np.float32),
        "reg_mask": np.ones((b, m, 2), np.float32),
        "wh": 2 * half,
        "wh_mask": np.ones((b, m, 2), np.float32),
        "tracking": rng.randn(b, m, 2).astype(np.float32),
        "tracking_mask": np.ones((b, m, 2), np.float32),
        "ltrb": ltrb,
        "ltrb_mask": np.ones((b, m, 4), np.float32),
        "ltrb_amodal": ltrb * rng.uniform(1, 1.5, (b, m, 4)).astype(
            np.float32),
        "ltrb_amodal_mask": (rng.rand(b, m, 4) > 0.1).astype(np.float32),
    }
    return batch


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_train_step_matches_jax():
    """One DLA-34 dcn_local1 step at 64x64, B=2, with both box heads:
    every loss term within rel 1e-5, and all 251 gradient leaves within
    1e-4 max|JAX leaf| + 1e-6 max|any gradient| (the bound of
    tests/test_torch_port_train.py)."""
    cfg, jcfg = _cfgs("both", SIZE, SIZE, pre_hm=True,
                      dla_node="dcn_local1", batch_size=2)
    params, batch_stats = load_jax_ckpt(CKPT)
    params = with_box_heads(params, cfg.heads_dict)
    batch = _step_batch()
    jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                           jcfg)
    jt = JTrainer(jcfg, jmodel, params, batch_stats, mesh=make_mesh(1))
    (_, (jl, _)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jt._forward_loss(p, batch_stats, b, True),
        has_aux=True))(params, batch)
    model = create_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(params, batch_stats), strict=True)
    tl = Trainer(cfg, model, device="cpu").train_step(batch, 1.25e-4)
    for k in ("tot", "hm", "wh", "reg", "tracking") + BOX_HEADS:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                   err_msg=k)
    with torch.no_grad():
        for p in model.parameters():   # params -> their gradients
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    tg = dict(_flat(params_to_jax(model)[0]))
    jg = dict(_flat(jax.tree_util.tree_map(np.asarray, jg)))
    assert set(jg) == set(tg) and len(jg) == 251
    assert any(np.abs(jg[("heads", h, "out", "kernel")]).max() > 0
               for h in BOX_HEADS)
    floor = 1e-6 * max(np.abs(v).max() for v in jg.values())
    for path in jg:
        np.testing.assert_allclose(
            tg[path], jg[path], rtol=0,
            atol=1e-4 * np.abs(jg[path]).max() + floor,
            err_msg="/".join(path))
