"""The port's training step at the exact DCNv2 nodes of dla_node "dcn"
(both packages' default; "dcn_mix" in
tests/test_torch_port_train_exact_mix.py) against the JAX package on the
CPU: one DLA-34 step at 64x64, B=2, on the committed exact-trained
checkpoint (``assets/selftest_dcn_fp16.ckpt``) and the float32 slice's
seeded batch, the port's ``Trainer.train_step`` against JAX's
value_and_grad of its Trainer's loss (every head's loss, all 243
gradient leaves, the batch statistics) at the float32 step's tolerances
of tests/test_torch_port_train.py; and the exact op's plain bf16
backward (the bf16 kernels' oracle) against JAX's float32 vjp, as close
as JAX's own bf16 vjp is. On the CPU the exact op is its plain version,
whose autograd is JAX's vjp; on the card the same step runs
``DCNExact`` (chip_smoke.py's train_dcn phases)."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
from jax._src import compiler as jcompiler
import numpy as np
import pytest
import torch

from centertrack_tpu.engine.trainer import Trainer as JTrainer
from centertrack_tpu.models.model import create_model as jcreate_model
from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu.parallel.mesh import make_mesh
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models.model import params_to_jax
from centertrack_tpu_torch.ops import dcn
from centertrack_tpu_torch.utils import checkpoint
# the float32 slice's 64x64 configs, seeded batch, tree flattening and
# checkpoint-loaded model
from test_torch_port_train import ROOT, _batch, _cfgs, _flat, _port_model

torch.set_num_threads(2)

CKPT_DCN = os.path.join(ROOT, "assets", "selftest_dcn_fp16.ckpt")
HEADS = ("tot", "hm", "reg", "wh", "tracking")
BF16 = ml_dtypes.bfloat16


@pytest.fixture(scope="module")
def ckpt_dcn():
    return checkpoint.load_jax_ckpt(CKPT_DCN)


_STEPS = {}


def step_pair(node, ckpt, jit=True):
    """Both packages' step at ``node`` on the float32 slice's seeded
    batch: JAX's loss, gradients and new batch_stats (value_and_grad
    under jax.jit, or op by op with ``jit`` False); the port's losses, the
    gradients Trainer.train_step leaves, its batch_stats and the kinds of
    its DCN layers. Cached per node.

    JAX compiles this step with XLA's optimizations on, as it runs
    outside the tests (tests/conftest.py turns most of them off to save
    compile time): the exact op's gradients jump where a sample position
    crosses an integer (floor' = 0), so the step's gradients move by more
    than the bound below between JAX's two builds of the same step, with
    the port matching the optimized one."""
    if node in _STEPS:
        return _STEPS[node]
    params, batch_stats = ckpt
    cfg, jcfg = _cfgs(dla_node=node)
    batch = _batch()
    jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                           jcfg)
    jt = JTrainer(jcfg, jmodel, params, batch_stats, mesh=make_mesh(1))
    grad_fn = jax.value_and_grad(
        lambda p, b: jt._forward_loss(p, batch_stats, b, True), has_aux=True)
    was = jcompiler._DISABLE_MOST_OPTIMIZATIONS.value
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        (_, (jl, jbs)), jg = (jax.jit(grad_fn) if jit else grad_fn)(params,
                                                                    batch)
    finally:
        jax.config.update("jax_disable_most_optimizations", was)
    model = _port_model(cfg, ckpt)
    kinds = {type(m).__name__ + ":" + m.mode for m in model.modules()
             if hasattr(m, "mode")}
    tl = Trainer(cfg, model, device="cpu").train_step(batch, 1.25e-4)
    with torch.no_grad():
        for p in model.parameters():   # params -> their gradients
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    tg, tbs = params_to_jax(model)
    _STEPS[node] = (
        {k: float(v) for k, v in jl.items()},
        {k: float(v) for k, v in tl.items()},
        dict(_flat(jax.tree_util.tree_map(np.asarray, jg))),
        dict(_flat(tg)),
        dict(_flat(jax.tree_util.tree_map(np.asarray, jbs))),
        dict(_flat(tbs)), kinds)
    return _STEPS[node]


NODE = "dcn"


def test_step_runs_the_exact_nodes(ckpt_dcn):
    """The port's network at dcn holds exact (gather) DCN layers only."""
    assert step_pair(NODE, ckpt_dcn)[6] == {"DCNLayer:gather"}


@pytest.mark.parametrize("head", HEADS)
def test_exact_train_step_loss_matches_jax(ckpt_dcn, head):
    """Each head's loss, rel 1e-5."""
    jl, tl = step_pair(NODE, ckpt_dcn)[:2]
    np.testing.assert_allclose(tl[head], jl[head], rtol=1e-5)


def test_exact_train_step_every_gradient_matches_jax(ckpt_dcn):
    """All 243 gradient leaves: |port - JAX| <= 1e-4 max|JAX leaf| +
    1e-6 max|any gradient| (tests/test_torch_port_train.py's bound: the
    floor covers the DCN biases, whose gradient is 0 up to rounding
    before a train-mode BatchNorm)."""
    jg, tg = step_pair(NODE, ckpt_dcn)[2:4]
    assert set(jg) == set(tg) and len(jg) == 243
    floor = 1e-6 * max(np.abs(v).max() for v in jg.values())
    for path in jg:
        np.testing.assert_allclose(
            tg[path], jg[path], rtol=0,
            atol=1e-4 * np.abs(jg[path]).max() + floor,
            err_msg="/".join(path))


def test_exact_train_step_batch_stats_match_jax(ckpt_dcn):
    """All 114 running statistics after the step, within 1e-5 of each
    leaf's largest value."""
    jbs, tbs = step_pair(NODE, ckpt_dcn)[4:6]
    assert set(jbs) == set(tbs) and len(jbs) == 114
    for path in jbs:
        np.testing.assert_allclose(tbs[path], jbs[path], rtol=0,
                                   atol=1e-5 * np.abs(jbs[path]).max(),
                                   err_msg="/".join(path))


# --- the exact op's plain bf16 backward ------------------------------------

def _rel_l2(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(((a - ref) ** 2).sum() / (ref ** 2).sum())


def _exact_case(seed, hw, offsets):
    """bf16 values (as numpy float32): x, offset, mask, weight, bias and
    an output grad; offsets ~N(0, 3) or all zero."""
    rng = np.random.RandomState(seed)
    q = lambda a: np.asarray(a, np.float32).astype(BF16).astype(np.float32)
    b, (h, w), cin, cout = 1, hw, 16, 24
    off = (rng.randn(b, h, w, 18) * 3 if offsets == "n3"
           else np.zeros((b, h, w, 18)))
    return [q(a) for a in (rng.randn(b, h, w, cin), off,
                           rng.rand(b, h, w, 9),
                           rng.randn(3, 3, cin, cout) * 0.1,
                           rng.randn(cout), rng.randn(b, h, w, cout))]


def _jax_vjp(args, dtype):
    *ins, g = [jnp.asarray(a, dtype) for a in args]
    _, pull = jax.vjp(lambda *a: jdcn.deform_conv2d(*a), *ins)
    grads = pull(g)
    assert all(t.dtype == dtype for t in grads)
    return [np.asarray(t, np.float32) for t in grads]


@pytest.mark.parametrize("offsets", ["n3", "zero"])
@pytest.mark.parametrize("hw", [(13, 16), (64, 72)])
def test_plain_exact_bf16_backward_is_as_close_to_jax_as_jax_bf16_is(
        hw, offsets):
    """For each gradient, autograd of the port's plain exact op at bf16
    (float32 inside, each gradient rounded to bf16 once) lies within 3x
    the relative L2 distance of JAX's bf16 vjp of ``deform_conv2d`` from
    JAX's float32 vjp (on the same bf16 values) from that float32 vjp,
    the bound tests/test_torch_port_train_bf16.py holds the clamped op
    to. 13x16 takes JAX's onehot form, 64x72 its slot form."""
    args = _exact_case(30 + hw[0], hw, offsets)
    fp32 = _jax_vjp(args, jnp.float32)
    jax_bf16 = _jax_vjp(args, jnp.bfloat16)
    *ins, g = [torch.from_numpy(a).bfloat16().requires_grad_()
               for a in args]
    out = dcn.deform_conv2d_plain(*ins)
    assert out.dtype == torch.bfloat16
    out.backward(g.detach())
    assert all(t.grad.dtype == torch.bfloat16 for t in ins)
    port = [t.grad.float().numpy() for t in ins]
    for name, a, j, f in zip(("x", "offset", "mask", "weight", "bias"),
                             port, jax_bf16, fp32):
        own = _rel_l2(j, f)
        assert own > 0, name
        assert _rel_l2(a, f) <= 3 * own, name
