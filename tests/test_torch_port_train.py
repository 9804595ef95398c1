"""The port's training path (centertrack_tpu_torch: BatchNorm train mode,
GT rendering, losses, optimisers, Trainer, checkpoint writing) against
the JAX package on the CPU, on inputs made from numpy seeds. Tolerances
are stated beside each test."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.data import render as jrender
from centertrack_tpu.engine.trainer import Trainer as JTrainer
from centertrack_tpu.models.model import create_model as jcreate_model
from centertrack_tpu.models.model import load_model as jload_model
from centertrack_tpu.ops import gaussian as jgaussian
from centertrack_tpu.ops import losses as jlosses
from centertrack_tpu.parallel.mesh import make_mesh
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.data import render
from centertrack_tpu_torch.engine.trainer import (Trainer, make_lr_schedule,
                                                  make_optimizer)
from centertrack_tpu_torch.models.layers import BatchNorm
from centertrack_tpu_torch.models.model import (create_model,
                                                params_from_jax,
                                                params_to_jax, save_model)
from centertrack_tpu_torch.ops import gaussian, losses
from centertrack_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
# 64x64, not smaller: at 32x32 the stride-32 map is 1x1, so with B=2
# each BatchNorm there normalises 2 values per channel and amplifies
# fp32 rounding by orders of magnitude per layer in both frameworks
SIZE = 64
CFG_KW = dict(task="tracking", pre_hm=True, dla_node="dcn_local1",
              batch_size=2)


def _meta(size):
    class Meta:
        num_categories = 1
        default_resolution = (size, size)
        num_joints = 17
    return Meta


def _cfgs(size=SIZE, **kw):
    args = dict(CFG_KW, **kw)
    return (set_heads(parse_task(Config(**args)), _meta(size)),
            jset_heads(jparse_task(JConfig(**args)), _meta(size)))


def _batch(b=2, size=SIZE, m=4, seed=0):
    """A descriptor batch as GenericDataset emits it (keys of
    tests/test_trainer.py:tiny_batch), with live objects, one ignore box
    and seeded images."""
    rng = np.random.RandomState(seed)
    out = size // 4
    cts = rng.randint(1, out - 1, (b, m, 2)).astype(np.int32)
    wh = rng.uniform(2, out / 2, (b, m, 2)).astype(np.float32)
    return {
        "image": rng.randn(b, size, size, 3).astype(np.float32),
        "pre_img": rng.randn(b, size, size, 3).astype(np.float32),
        "ind": (cts[..., 1] * out + cts[..., 0]).astype(np.int64),
        "cat": np.zeros((b, m), np.int64),
        "mask": np.ones((b, m), np.float32),
        "hm_cts": cts,
        "hm_radii": rng.randint(0, 3, (b, m)).astype(np.int32),
        "hm_valid": np.ones((b, m), bool),
        "ignore_boxes": np.tile(np.array([[1.5, 2.0, 4.9, 3.2],
                                          [0, 0, 0, 0]], np.float32),
                                (b, 1, 1)),
        "ignore_cat": np.tile(np.array([-1, 0], np.int32), (b, 1)),
        "ignore_valid": np.tile(np.array([True, False]), (b, 1)),
        "pre_cts_int": (cts * 4 + rng.randint(-3, 4, (b, m, 2))).astype(
            np.int32),
        "pre_radii": rng.randint(1, 5, (b, m)).astype(np.int32),
        "pre_ks": np.ones((b, m), np.float32),
        "pre_valid": rng.rand(b, m) > 0.2,
        "reg": rng.rand(b, m, 2).astype(np.float32),
        "reg_mask": np.ones((b, m, 2), np.float32),
        "wh": wh,
        "wh_mask": np.ones((b, m, 2), np.float32),
        "tracking": rng.randn(b, m, 2).astype(np.float32),
        "tracking_mask": np.ones((b, m, 2), np.float32),
    }


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def ckpt():
    return checkpoint.load_jax_ckpt(CKPT)


# --- config --------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"wh_weight": 0.0},
                                {"tracking_weight": 0.5, "hm_weight": 2.0}])
def test_heads_and_weights_match_jax(kw):
    cfg, jcfg = _cfgs(**kw)
    assert cfg.heads_dict == jcfg.heads_dict
    assert cfg.weights_dict == jcfg.weights_dict
    for field in ("optim", "lr", "lr_step", "num_epochs", "batch_size",
                  "grad_accum"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


# --- BatchNorm train mode against flax ----------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (2, 1, 1, 3)])
def test_batchnorm_train_matches_flax(shape):
    """Output, input gradient and the running statistics over two
    train-mode calls (n = 24 and n = 2 values per channel: the unbiased
    variance would be 24/23 and 2x off). rel 1e-5."""
    rng = np.random.RandomState(sum(shape))
    c = shape[-1]
    params = {"scale": rng.rand(c).astype(np.float32) + 0.5,
              "bias": rng.randn(c).astype(np.float32)}
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": rng.rand(c).astype(np.float32) + 0.5}
    bn = BatchNorm(c, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    for _ in range(2):
        x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
        g = rng.randn(*shape).astype(np.float32)
        ref, mutated = flax_bn.apply({"params": params,
                                      "batch_stats": stats}, x,
                                     mutable=["batch_stats"])
        _, pull = jax.vjp(lambda inp: flax_bn.apply(
            {"params": params, "batch_stats": stats}, inp,
            mutable=["batch_stats"])[0], x)
        stats = mutated["batch_stats"]
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        out = bn(xt)
        out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(pull(g)[0]), rtol=1e-5,
                                   atol=1e-5)
        for ours, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(ours.numpy(), np.asarray(stats[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_batchnorm_eval_uses_running_stats():
    bn = BatchNorm(3, eps=1e-5, momentum=0.1).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([1.0, -2.0, 0.5]))
        bn.running_var.copy_(torch.tensor([4.0, 1.0, 0.25]))
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    before = bn.running_mean.clone()
    out = bn(x)
    ref = (x - bn.running_mean[:, None, None]) / torch.sqrt(
        bn.running_var[:, None, None] + 1e-5)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    assert torch.equal(bn.running_mean, before)


def test_bn_cost_tool_times_and_checks_both_variants():
    """The BatchNorm cost script on the CPU at 32x32 (no kernels): both
    variants timed twice, both float32 steps held against the float64
    one with finite errors, and the port's formula back in place
    afterwards, also after an error inside the swap."""
    import torch.nn as nn

    from centertrack_tpu_torch.tools import bn_cost
    formula = BatchNorm.forward
    ms, row = bn_cost.main(["--device", "cpu", "--size", "32", "32",
                            "--steps", "1", "--batch", "2"])
    assert BatchNorm.forward is formula
    assert {k: len(v) for k, v in ms.items()} == {"formula": 2, "fused": 2}
    assert all(t > 0 for v in ms.values() for t in v)
    for variant in ("formula", "fused"):
        assert np.isfinite(row[variant]["rel_l2"])
        assert row[variant]["worst_leaf"].endswith(("weight", "bias"))
    with pytest.raises(ZeroDivisionError):
        with bn_cost.fused_batchnorm():
            assert BatchNorm.forward is nn.BatchNorm2d.forward
            1 / 0
    assert BatchNorm.forward is formula


# --- rendering -----------------------------------------------------------

@pytest.mark.parametrize("num_channels", [1, 3])
def test_render_gaussians_matches_jax(num_channels):
    """Exact: the same float32 expression, max over objects."""
    rng = np.random.RandomState(num_channels)
    n, h, w = 12, 20, 28
    cts = np.stack([rng.randint(-3, w + 3, n), rng.randint(-3, h + 3, n)],
                   1).astype(np.int32)
    radii = rng.randint(0, 6, n).astype(np.int32)
    chans = rng.randint(0, num_channels, n).astype(np.int32)
    ks = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.25
    ref = jgaussian.render_gaussians(h, w, num_channels, cts, radii, chans,
                                     ks, valid)
    got = gaussian.render_gaussians(h, w, num_channels,
                                    *map(torch.from_numpy,
                                         (cts, radii, chans, ks, valid)))
    assert got.shape == (h, w, num_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-7)


def test_ignore_regions_match_jax():
    """Integer box semantics: floor of each coordinate, inclusive."""
    rng = np.random.RandomState(4)
    hm = rng.rand(12, 15, 3).astype(np.float32) * 0.9
    boxes = np.array([[1.5, 2.0, 4.9, 3.2], [10.2, 0.7, 14.0, 11.99],
                      [3, 3, 3, 3], [0, 0, 20, 20]], np.float32)
    cats = np.array([-1, 2, 0, 1], np.int32)
    valid = np.array([True, True, True, False])
    ref = jrender._apply_ignore_regions(jnp.asarray(hm), boxes, cats, valid)
    got = render._apply_ignore_regions(*map(torch.from_numpy,
                                            (hm, boxes, cats, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("size", [64, 160])
def test_render_batch_matches_jax(size):
    """hm with ignore boxes, and pre_hm on a small map (dense render) and
    on one past 128x128 (windowed splats). atol 1e-6."""
    cfg, jcfg = _cfgs(size)
    batch = _batch(size=size, seed=size)
    ref = jrender.render_batch({k: jnp.asarray(v) for k, v in batch.items()},
                               jcfg)
    got = render.render_batch({k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg)
    for key in ("hm", "pre_hm"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-6, err_msg=key)
    assert got["hm"].numpy().max() == 1.0   # the ignore box


def test_render_batch_refuses_the_pose_target():
    cfg, _ = _cfgs()
    import dataclasses
    cfg = dataclasses.replace(cfg, heads=cfg.heads + (("hm_hp", 17),))
    with pytest.raises(NotImplementedError, match="hm_hp"):
        render.render_batch({k: torch.from_numpy(v)
                             for k, v in _batch().items()}, cfg)


# --- losses --------------------------------------------------------------

def _loss_inputs(seed=0, b=2, h=6, w=7, m=5):
    rng = np.random.RandomState(seed)
    ind = rng.randint(0, h * w, (b, m)).astype(np.int64)
    mask = (rng.rand(b, m) > 0.3).astype(np.float32)
    return rng, ind, mask


def _value_and_grad_pair(jfn, tfn, arrays, wrt=0):
    """The loss and its gradient w.r.t. arrays[wrt] in both."""
    jval, jgrad = jax.value_and_grad(
        lambda a: jfn(*arrays[:wrt], a, *arrays[wrt + 1:]))(
            jnp.asarray(arrays[wrt]))
    ts = [torch.from_numpy(np.asarray(a)) for a in arrays]
    ts[wrt] = ts[wrt].clone().requires_grad_()
    val = tfn(*ts)
    val.backward()
    return ((float(jval), np.asarray(jgrad)),
            (float(val.detach()), ts[wrt].grad.numpy()))


def _check_pair(pair, rtol=1e-5):
    (jv, jg), (tv, tg) = pair
    np.testing.assert_allclose(tv, jv, rtol=rtol)
    np.testing.assert_allclose(tg, jg, rtol=0,
                               atol=rtol * max(np.abs(jg).max(), 1e-12))


@pytest.mark.parametrize("no_pos", [False, True])
def test_fast_focal_loss_matches_jax(no_pos):
    rng, ind, mask = _loss_inputs(1)
    if no_pos:
        mask[:] = 0
    out = rng.rand(2, 6, 7, 3).astype(np.float32) * 0.9 + 0.05
    target = rng.rand(2, 6, 7, 3).astype(np.float32) ** 4
    cat = rng.randint(0, 3, (2, 5)).astype(np.int64)
    _check_pair(_value_and_grad_pair(jlosses.fast_focal_loss,
                                     losses.fast_focal_loss,
                                     [out, target, ind, mask, cat]))


def test_reg_l1_and_bce_match_jax():
    rng, ind, mask = _loss_inputs(2)
    out = rng.randn(2, 6, 7, 4).astype(np.float32)
    fmask = np.repeat(mask[..., None], 4, -1)
    target = rng.randn(2, 5, 4).astype(np.float32)
    _check_pair(_value_and_grad_pair(jlosses.reg_weighted_l1_loss,
                                     losses.reg_weighted_l1_loss,
                                     [out, fmask, ind, target]))
    target01 = (rng.rand(2, 5, 4) > 0.5).astype(np.float32)
    _check_pair(_value_and_grad_pair(jlosses.weighted_bce_loss,
                                     losses.weighted_bce_loss,
                                     [out, fmask, ind, target01]))


def test_bin_rot_loss_matches_jax():
    rng, ind, mask = _loss_inputs(3)
    out = rng.randn(2, 6, 7, 8).astype(np.float32)
    rotbin = rng.randint(0, 2, (2, 5, 2)).astype(np.int64)
    rotres = rng.uniform(-np.pi, np.pi, (2, 5, 2)).astype(np.float32)
    _check_pair(_value_and_grad_pair(jlosses.bin_rot_loss,
                                     losses.bin_rot_loss,
                                     [out, mask, ind, rotbin, rotres]))


def test_generic_loss_matches_jax():
    """Every head of the tracking task, with the config's weights."""
    cfg, jcfg = _cfgs(32)
    rng = np.random.RandomState(5)
    b, h, w, m = 2, 8, 8, 4
    outputs = {"hm": rng.randn(b, h, w, 1).astype(np.float32) - 2,
               "reg": rng.rand(b, h, w, 2).astype(np.float32),
               "wh": rng.rand(b, h, w, 2).astype(np.float32) * 5,
               "tracking": rng.randn(b, h, w, 2).astype(np.float32)}
    batch = {"hm": rng.rand(b, h, w, 1).astype(np.float32) ** 6,
             "ind": rng.randint(0, h * w, (b, m)).astype(np.int64),
             "mask": np.ones((b, m), np.float32),
             "cat": np.zeros((b, m), np.int64)}
    for head in ("reg", "wh", "tracking"):
        batch[head] = rng.randn(b, m, 2).astype(np.float32)
        batch[head + "_mask"] = (rng.rand(b, m, 2) > 0.2).astype(np.float32)
    jtot, jl = jlosses.generic_loss(
        [{k: jnp.asarray(v) for k, v in outputs.items()}],
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg.heads_dict,
        jcfg.weights_dict)
    tot, tl = losses.generic_loss(
        [{k: torch.from_numpy(v) for k, v in outputs.items()}],
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg.heads_dict,
        cfg.weights_dict)
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                   err_msg=k)


# --- optimisers ----------------------------------------------------------

@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_optimizer_matches_optax(optim):
    """Three steps from the same params on the same gradients (some
    below 1e-7, where Adam's first step is ~ lr * sign(g)), lr changed
    between steps as the schedule does. Within 1e-5 of the largest
    update plus 2 float32 ulps of the parameter."""
    cfg, jcfg = _cfgs(lr=1e-3, optim=optim)
    rng = np.random.RandomState(9)
    p0 = {"a": rng.randn(5, 4).astype(np.float32),
          "b": rng.randn(7).astype(np.float32)}
    grads = [{"a": (rng.randn(5, 4) * 10.0 ** rng.randint(-8, 1, (5, 4))
                    ).astype(np.float32),
              "b": rng.randn(7).astype(np.float32)} for _ in range(3)]
    lrs = [1e-3, 1e-3, 1e-4]
    from centertrack_tpu.engine.trainer import make_optimizer as jmake
    tx = jmake(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(cfg, list(tp.values()))
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = lr
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    for k in p0:
        # the final p + update rounds in another order: 2 ulp of |p|
        moved = np.abs(np.asarray(jp[k]) - p0[k]).max()
        ulp2 = 2 * np.finfo(np.float32).eps * np.abs(p0[k]).max()
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-5 * moved + ulp2,
                                   err_msg=k)


def test_lr_schedule_and_optimizer_choice():
    cfg, _ = _cfgs(lr=1e-3, lr_step=(3, 5))
    lr = make_lr_schedule(cfg)
    assert lr(1) == 1e-3
    np.testing.assert_allclose([lr(3), lr(5)], [1e-4, 1e-5])
    cfg, _ = _cfgs(optim="rmsprop")
    with pytest.raises(ValueError, match="rmsprop"):
        make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(1))])


# --- one DLA-34 dcn_local1 training step, port against JAX ---------------

def _port_model(cfg, ckpt):
    model = create_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(*ckpt), strict=True)
    return model


@pytest.fixture(scope="module")
def step_pair(ckpt):
    """Both packages' step on the committed local1 checkpoint and one
    seeded batch: JAX's Trainer loss and its value_and_grad (the
    gradient its train step feeds optax) and new batch_stats; the
    port's Trainer.train_step and the gradients it leaves."""
    params, batch_stats = ckpt
    cfg, jcfg = _cfgs()
    batch = _batch()
    jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                           jcfg)
    jt = JTrainer(jcfg, jmodel, params, batch_stats, mesh=make_mesh(1))
    (_, (jl, jbs)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jt._forward_loss(p, batch_stats, b, True),
        has_aux=True))(params, batch)
    model = _port_model(cfg, ckpt)
    tl = Trainer(cfg, model, device="cpu").train_step(batch, 1.25e-4)
    with torch.no_grad():
        for p in model.parameters():   # params -> their gradients
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    tg, tbs = params_to_jax(model)
    return ({k: float(v) for k, v in jl.items()},
            {k: float(v) for k, v in tl.items()},
            dict(_flat(jax.tree_util.tree_map(np.asarray, jg))),
            dict(_flat(tg)),
            dict(_flat(jax.tree_util.tree_map(np.asarray, jbs))),
            dict(_flat(tbs)))


@pytest.mark.parametrize("head", ["tot", "hm", "reg", "wh", "tracking"])
def test_train_step_loss_matches_jax(step_pair, head):
    jl, tl = step_pair[:2]
    np.testing.assert_allclose(tl[head], jl[head], rtol=1e-5)


def test_train_step_every_gradient_matches_jax(step_pair):
    """All 243 gradient leaves: |port - JAX| <= 1e-4 max|JAX leaf| +
    1e-6 max|any gradient|. The floor covers the DCN biases, whose
    gradient is 0 up to rounding (a train-mode BatchNorm follows them);
    a gradient a tree discards (level3/4 project) is None in the port
    and 0 in JAX."""
    jg, tg = step_pair[2:4]
    assert set(jg) == set(tg) and len(jg) == 243
    floor = 1e-6 * max(np.abs(v).max() for v in jg.values())
    for path in jg:
        np.testing.assert_allclose(
            tg[path], jg[path], rtol=0,
            atol=1e-4 * np.abs(jg[path]).max() + floor,
            err_msg="/".join(path))


def test_train_step_batch_stats_match_jax(step_pair):
    """All 114 running statistics after the step, within 1e-5 of each
    leaf's largest value."""
    jbs, tbs = step_pair[4:6]
    assert set(jbs) == set(tbs) and len(jbs) == 114
    for path in jbs:
        np.testing.assert_allclose(tbs[path], jbs[path], rtol=0,
                                   atol=1e-5 * np.abs(jbs[path]).max(),
                                   err_msg="/".join(path))


def test_grad_accum_matches_monolithic(ckpt):
    """grad_accum=2 on [mb; mb] against one step on [mb; mb]: the same
    loss and gradients (each micro-batch's BN statistics equal the full
    batch's), and the running statistics advanced twice. rel 1e-5."""
    cfg, _ = _cfgs(batch_size=4)
    cfg_acc, _ = _cfgs(batch_size=4, grad_accum=2)
    mb = _batch(seed=3)
    batch = {k: np.concatenate([v, v]) for k, v in mb.items()}
    mono, acc = _port_model(cfg, ckpt), _port_model(cfg_acc, ckpt)
    bn0 = mono.backbone.base.level2.root.conv.bn.running_mean.clone()
    l_mono = Trainer(cfg, mono, device="cpu").train_step(batch, 1e-4)
    t_acc = Trainer(cfg_acc, acc, device="cpu")
    assert t_acc.accum == 2
    l_acc = t_acc.train_step(batch, 1e-4)
    np.testing.assert_allclose(float(l_acc["tot"]), float(l_mono["tot"]),
                               rtol=1e-5)
    gmax = max(p.grad.abs().max() for p in mono.parameters()
               if p.grad is not None)
    for (name, a), b in zip(acc.named_parameters(), mono.parameters()):
        if b.grad is None:
            assert a.grad is None, name
            continue
        torch.testing.assert_close(a.grad, b.grad, rtol=0,
                                   atol=1e-4 * b.grad.abs().max()
                                   + 1e-6 * gmax, msg=name)
    # ra1 = 0.9 ra0 + 0.1 m after one step; two chained: 0.9 ra1 + 0.1 m
    ra1 = mono.backbone.base.level2.root.conv.bn.running_mean
    m = (ra1 - 0.9 * bn0) / 0.1
    torch.testing.assert_close(
        acc.backbone.base.level2.root.conv.bn.running_mean,
        0.9 * ra1 + 0.1 * m, rtol=1e-5, atol=1e-6)


def test_grad_accum_refuses_an_indivisible_batch(ckpt):
    cfg, _ = _cfgs(grad_accum=2)
    t = Trainer(cfg, _port_model(cfg, ckpt), device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        t.train_step(_batch(b=3), 1e-4)


def test_run_epoch_trains_and_validates(ckpt, capsys):
    """Two train iterations (num_iters cuts a longer loader) move the
    parameters and advance the statistics; val changes neither."""
    cfg, _ = _cfgs(32)
    model = _port_model(cfg, ckpt)
    t = Trainer(cfg, model, device="cpu")
    loader = [_batch(size=32, seed=s) for s in range(3)]
    w0 = model.heads["hm"].out.weight.detach().clone()
    ret = t.train(0, loader, num_iters=2, log_every=1)
    assert set(ret) == {"tot", "hm", "reg", "wh", "tracking", "time"}
    assert np.isfinite(ret["tot"])
    assert not torch.equal(model.heads["hm"].out.weight, w0)
    assert capsys.readouterr().out.count("train e0 it") == 2
    assert int(model.backbone.base.base_layer.bn.num_batches_tracked) == 2
    state = {k: v.clone() for k, v in model.state_dict().items()}
    val = t.val(0, loader[:1], log_every=0)
    assert np.isfinite(val["tot"]) and not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_trainer_refuses_cuda_without_a_gpu(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the trainer runs there")
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="no GPU"):
        Trainer(cfg, torch.nn.Linear(1, 1))


# --- checkpoints -----------------------------------------------------------

def test_params_to_jax_inverts_params_from_jax(ckpt):
    params, batch_stats = ckpt
    p2, b2 = params_to_jax(_port_model(_cfgs()[0], ckpt))
    for tree, ref in ((p2, params), (b2, batch_stats)):
        got, want = dict(_flat(tree)), dict(_flat(ref))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_saved_checkpoint_loads_in_jax_and_the_port(ckpt, tmp_path):
    """A port-trained model (one step) written by save_model and read
    back by JAX load_model onto its templates and by load_jax_ckpt."""
    cfg, jcfg = _cfgs(32)
    model = _port_model(cfg, ckpt)
    Trainer(cfg, model, device="cpu").train_step(_batch(size=32), 1e-3)
    path = str(tmp_path / "port.ckpt")
    save_model(path, 3, model)
    params, batch_stats = params_to_jax(model)
    loaded = jload_model(path, ckpt[0], ckpt[1], verbose=False)
    assert loaded["epoch"] == 3
    for tree, ref in ((loaded["params"], params),
                      (loaded["batch_stats"], batch_stats)):
        got, want = dict(_flat(tree)), dict(_flat(ref))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    again = _port_model(cfg, checkpoint.load_jax_ckpt(path))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again.state_dict()[k], v), k
