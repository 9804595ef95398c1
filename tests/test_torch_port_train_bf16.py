"""The port's bfloat16 training path (centertrack_tpu_torch with
``compute_dtype="bfloat16"``) against the JAX package on the CPU, on
inputs made from numpy seeds: the plain bf16 DCN backward against its
own definition and against the Pallas kernels' custom_vjp (K3, K4 in
interpret mode) and XLA's vjp; BatchNorm in train mode at bf16 against
flax's; one DLA-34 dcn_local1 training step against JAX's Trainer at
bf16; gradient accumulation at bf16; and the wiring of the bf16 autograd
function to its two backward kernels (stand-in launchers: the CUDA
kernels run only on the card, where chip_smoke.py holds them against
the plain version).

bf16 results are compared by distance, not bit for bit: JAX's bf16 vjp
rounds at every bf16 operation, the port's at the inputs only. The
yardstick is how far JAX's own bf16 result lies from JAX's float32 one.
Each tolerance is stated beside its test with the value it measured."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from centertrack_tpu.engine.trainer import Trainer as JTrainer
from centertrack_tpu.models.model import create_model as jcreate_model
from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu.ops.dcn_pallas_halo import deform_conv2d_local_halo
from centertrack_tpu.ops.dcn_pallas_shift import deform_conv2d_local_pallas
from centertrack_tpu.parallel.mesh import make_mesh
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models.layers import BatchNorm
from centertrack_tpu_torch.models.model import params_to_jax
from centertrack_tpu_torch.ops import dcn
from centertrack_tpu_torch.utils import checkpoint
# the float32 slice's helpers: its 64x64 DLA-34 configs (32x32 leaves
# 1x1 maps), its seeded descriptor batch, the JAX-tree flattening, the
# checkpoint-loaded model; and the bf16 ulp
from test_torch_port_bf16 import ulp
from test_torch_port_train import CKPT, _batch, _cfgs, _flat, _port_model

torch.set_num_threads(2)

BF16 = ml_dtypes.bfloat16


def _rel_l2(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(((a - ref) ** 2).sum() / (ref ** 2).sum())


# --- the plain bf16 DCN backward -------------------------------------------

def _dcn_case(seed, shape, r, offsets):
    """bf16 values (as numpy float32): x, offset, mask, weight, bias and
    an output grad; ``offsets`` "random" spreads them past the clamp,
    "zero" puts every tap on the kinks."""
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    q = lambda a: np.asarray(a, np.float32).astype(BF16).astype(np.float32)
    off = (rng.uniform(-(r + 1.5), r + 1.5, (b, h, w, 18))
           if offsets == "random" else np.zeros((b, h, w, 18)))
    return [q(rng.randn(b, h, w, cin)), q(off), q(rng.rand(b, h, w, 9)),
            q(rng.randn(3, 3, cin, cout) * 0.1), q(rng.randn(cout)),
            q(rng.randn(b, h, w, cout))]


def _torch_vjp(args, r, dtype):
    """Autograd of the port's plain version at ``dtype`` -> float32
    numpy grads of x, offset, mask, weight, bias."""
    *ins, g = [torch.from_numpy(a).to(dtype) for a in args]
    ins = [t.requires_grad_() for t in ins]
    out = dcn.deform_conv2d_local_plain(*ins, r)
    assert out.dtype == dtype
    out.backward(g)
    assert all(t.grad.dtype == dtype for t in ins)
    return [t.grad.float().numpy() for t in ins]


def _forward_samples(args, r):
    """The bf16 samples A_t = bf16(m_t S_t) the plain bf16 forward
    contracts, (9, B, H, W, Cin), read back through the forward itself:
    with tap t's weight the identity and the others zero, its output is
    A_t exactly (one non-zero term per output, already in bf16)."""
    x, offset, mask = (torch.from_numpy(a).bfloat16() for a in args[:3])
    cin = x.shape[3]
    samples = []
    for t in range(9):
        w = torch.zeros(9, cin, cin)
        w[t] = torch.eye(cin)
        samples.append(dcn.deform_conv2d_local_plain(
            x, offset, mask, w.reshape(3, 3, cin, cin).bfloat16(), None, r))
    return torch.stack(samples).double().numpy()


SHAPES = [(1, 7, 9, 8, 5), (2, 5, 6, 16, 24), (1, 13, 16, 16, 24)]


@pytest.mark.parametrize("offsets", ["random", "zero"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_backward_is_the_fp32_vjp_rounded_once(shape, r, offsets):
    """grad x, offset, mask and bias: the float32 plain backward on the
    upcast inputs, rounded to bf16, within 1 bf16 ulp (measured: equal).
    grad weight: sum_p A_t(p)^T g(p) over the bf16 sample A_t the
    forward contracted, in float64 and rounded, within 1 ulp + 1e-5 of
    max|grad w| (measured: within 1 ulp). It is not the float32 vjp's
    weight grad rounded: the sample's rounding moves each of its terms
    by up to 2^-9, and those add up (measured up to 5.6e-3 of max|grad
    w| from it; held within 2 ulps + 1e-2 of max)."""
    args = _dcn_case(sum(shape) + r, shape, r, offsets)
    got = _torch_vjp(args, r, torch.bfloat16)
    fp32 = _torch_vjp(args, r, torch.float32)
    ref = [torch.from_numpy(a).bfloat16().float().numpy() for a in fp32]
    for name, a, b in zip(("x", "offset", "mask", "bias"),
                          got[:3] + got[4:], ref[:3] + ref[4:]):
        assert (np.abs(a - b) <= ulp(b)).all(), name
    cin, cout = shape[3:]
    exact = np.einsum("tpc,po->tco",
                      _forward_samples(args, r).reshape(9, -1, cin),
                      args[5].reshape(-1, cout).astype(np.float64))
    exact = torch.from_numpy(exact.reshape(3, 3, cin, cout)).bfloat16()
    exact = exact.float().numpy()
    assert (np.abs(got[3] - exact) <= ulp(exact)
            + 1e-5 * np.abs(exact).max()).all()
    assert (np.abs(got[3] - ref[3]) <= 2 * ulp(ref[3])
            + 1e-2 * np.abs(ref[3]).max()).all()


def _jax_vjp(fn, args, r, dtype):
    *ins, g = [jnp.asarray(a, dtype) for a in args]
    _, pull = jax.vjp(lambda *a: fn(*a, r), *ins)
    grads = pull(g)
    assert all(t.dtype == dtype for t in grads)
    return [np.asarray(t, np.float32) for t in grads]


# the JAX bf16 vjps the port's is held against: the Pallas kernels'
# custom_vjp (each jax.vjp of the XLA op at the inputs' dtype) and XLA's
# own vjp of the taploop schedule that training resolves to
JAX_BWD = {
    "K3_dcn_pallas_shift": lambda x, o, m, w, b, r:
        deform_conv2d_local_pallas(x, o, m, w, b, r, 8, 8, True),
    "K4_dcn_pallas_halo": lambda x, o, m, w, b, r: deform_conv2d_local_halo(
        x, o, m, w, b, r, None, None, True),
    "xla_taploop_train": lambda x, o, m, w, b, r: jdcn.deform_conv2d_local(
        x, o, m, w, b, max_offset=r, train=True),
}


@pytest.mark.parametrize("offsets", ["random", "zero"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("ref", sorted(JAX_BWD))
def test_plain_bf16_backward_is_as_close_to_jax_as_jax_bf16_is(
        ref, r, offsets):
    """For each gradient, the port's bf16 vjp lies within 3x the relative
    L2 distance of JAX's bf16 vjp from JAX's float32 vjp (XLA, on the
    same bf16 values) from that float32 vjp. Measured ratios 0.03 to
    1.0: the port rounds once, JAX at every bf16 operation; 1.0 where
    both round the same values once (the weight grad at zero offsets,
    whose sample is m x in both; the bias grad against K3/K4). H = 13
    is not a multiple of the Pallas row tile."""
    args = _dcn_case(20 + r, (1, 13, 16, 16, 24), r, offsets)
    fp32 = _jax_vjp(JAX_BWD["xla_taploop_train"], args, r, jnp.float32)
    jax_bf16 = _jax_vjp(JAX_BWD[ref], args, r, jnp.bfloat16)
    port = _torch_vjp(args, r, torch.bfloat16)
    for name, a, j, f in zip(("x", "offset", "mask", "weight", "bias"),
                             port, jax_bf16, fp32):
        own = _rel_l2(j, f)
        assert own > 0, name
        assert _rel_l2(a, f) <= 3 * own, name


# --- BatchNorm train mode at bf16 ------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (2, 1, 1, 3)])
def test_batchnorm_train_bf16_matches_flax(shape):
    """flax BatchNorm(dtype=bf16) in train mode over two calls: float32
    statistics of the bf16 input, y in float32 rounded once. The output
    and the bf16 input grad within 1 bf16 ulp + 1e-6 of their max (the
    port casts the input twice, as flax does, so its vjp adds the two
    branches' bf16 cotangents as JAX's does; measured: equal), the
    float32 scale and bias grads and the running statistics rel 1e-5
    (measured: within 1.8e-7 of max and 2.4e-7)."""
    rng = np.random.RandomState(sum(shape) + 1)
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
                            epsilon=1e-5, dtype=jnp.bfloat16)
    for _ in range(2):
        x = (rng.randn(*shape) * 3 + 1).astype(BF16)
        g = rng.randn(*shape).astype(BF16)

        def apply(p, inp):
            return flax_bn.apply({"params": p, "batch_stats": stats}, inp,
                                 mutable=["batch_stats"])

        ref, mutated = apply(params, x)
        _, pull = jax.vjp(lambda p, inp: apply(p, inp)[0], params, x)
        jgp, jgx = pull(jnp.asarray(g))
        assert ref.dtype == jnp.bfloat16 and jgx.dtype == jnp.bfloat16
        stats = mutated["batch_stats"]
        xt = torch.from_numpy(x.astype(np.float32)).bfloat16().permute(
            0, 3, 1, 2).requires_grad_()
        bn.weight.grad = bn.bias.grad = None
        out = bn(xt)
        assert out.dtype == torch.bfloat16
        out.backward(torch.from_numpy(g.astype(np.float32)).bfloat16()
                     .permute(0, 3, 1, 2))
        got = out.detach().float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(ref, np.float32)
        assert (np.abs(got - want) <= ulp(want)
                + 1e-6 * np.abs(want).max()).all()
        gx = xt.grad.float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(jgx, np.float32)
        assert (np.abs(gx - want) <= ulp(want)
                + 1e-6 * np.abs(want).max()).all()
        for ours, key in ((bn.weight.grad, "scale"), (bn.bias.grad, "bias")):
            assert ours.dtype == torch.float32
            np.testing.assert_allclose(ours.numpy(), np.asarray(jgp[key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        for ours, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            assert ours.dtype == torch.float32
            np.testing.assert_allclose(ours.numpy(), np.asarray(stats[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


# --- one DLA-34 dcn_local1 training step at bf16 ---------------------------

@pytest.fixture(scope="module")
def ckpt():
    return checkpoint.load_jax_ckpt(CKPT)


def _jax_step(jcfg, ckpt, batch):
    """JAX's Trainer loss, gradient and new batch_stats of one step, as
    its train step computes them (tests/test_torch_port_train.py)."""
    params, batch_stats = ckpt
    jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                           jcfg)
    jt = JTrainer(jcfg, jmodel, params, batch_stats, mesh=make_mesh(1))
    (_, (jl, jbs)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jt._forward_loss(p, batch_stats, b, True),
        has_aux=True))(params, batch)
    return ({k: float(v) for k, v in jl.items()},
            dict(_flat(jax.tree_util.tree_map(np.asarray, jg))),
            dict(_flat(jax.tree_util.tree_map(np.asarray, jbs))))


def _port_step(cfg, ckpt, batch):
    """The port's Trainer.train_step: its losses, the float32 gradients
    it leaves on the float32 parameters, and its new batch stats."""
    model = _port_model(cfg, ckpt)
    tl = Trainer(cfg, model, device="cpu").train_step(batch, 1.25e-4)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters()
               if p.grad is not None)
    with torch.no_grad():
        for p in model.parameters():   # params -> their gradients
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    tg, tbs = params_to_jax(model)
    return ({k: float(v) for k, v in tl.items()}, dict(_flat(tg)),
            dict(_flat(tbs)))


@pytest.fixture(scope="module")
def bf16_steps(ckpt):
    """One seeded batch through JAX's float32 and bf16 steps and the
    port's bf16 step: {name: (losses, gradients, batch stats)}."""
    batch = _batch()
    cfg, jcfg = _cfgs(compute_dtype="bfloat16")
    _, jcfg32 = _cfgs()
    return {"jax_fp32": _jax_step(jcfg32, ckpt, batch),
            "jax_bf16": _jax_step(jcfg, ckpt, batch),
            "port_bf16": _port_step(cfg, ckpt, batch)}


@pytest.mark.parametrize("head", ["tot", "hm", "reg", "wh", "tracking"])
def test_bf16_train_step_loss_matches_jax_bf16(bf16_steps, head):
    """Per head within rel 2e-2 of JAX's bf16 loss: measured up to
    5.7e-3 (reg), against JAX's own bf16 losses lying up to 5.8e-3 from
    its float32 ones (tot 5.6309 against 5.6481)."""
    jl, tl = bf16_steps["jax_bf16"][0], bf16_steps["port_bf16"][0]
    np.testing.assert_allclose(tl[head], jl[head], rtol=2e-2)


def _sq(a):
    return float((np.asarray(a, np.float64) ** 2).sum())


def test_bf16_train_step_gradients_are_as_close_to_fp32_as_jaxs(bf16_steps):
    """All 243 gradient leaves: the port's bf16 gradient lies within 3x
    the relative L2 distance of JAX's bf16 gradient from JAX's float32
    one (measured: JAX 0.331, the port 0.357, ratio 1.08). bf16 moves
    this step's gradients that far in both packages: one-ulp flips grow
    through the train-mode BatchNorms."""
    g32, gb, gp = (bf16_steps[k][1] for k in ("jax_fp32", "jax_bf16",
                                              "port_bf16"))
    assert set(gp) == set(g32) == set(gb) and len(g32) == 243
    own = sum(_sq(gb[k] - g32[k]) for k in g32)
    assert own > 0
    assert sum(_sq(gp[k] - g32[k]) for k in g32) <= 9 * own


def test_bf16_train_step_every_gradient_leaf_is_as_close_as_jaxs(bf16_steps):
    """Leaf by leaf, the same ratio: |port - JAX fp32| <= 3 |JAX bf16 -
    JAX fp32| (L2 over the leaf) + a floor of 1e-5 of the largest
    gradient per element, for leaves whose float32 gradient is 0 up to
    rounding (the conv biases a train-mode BatchNorm follows), where
    bf16 lands at an arbitrary multiple of it. Measured: every leaf
    within 1.97x JAX's distance (pre_img_layer/bn/bias)."""
    g32, gb, gp = (bf16_steps[k][1] for k in ("jax_fp32", "jax_bf16",
                                              "port_bf16"))
    floor = 1e-5 * max(np.abs(v).max() for v in g32.values())
    for path, ref in g32.items():
        got = np.sqrt(_sq(gp[path] - ref))
        own = np.sqrt(_sq(gb[path] - ref))
        assert got <= 3 * own + floor * np.sqrt(ref.size), "/".join(path)


def test_bf16_train_step_batch_stats_match_jax_bf16(bf16_steps):
    """All 114 running statistics after the step: float32 folds of
    float32 statistics of bf16 activations, which differ where the two
    packages' bf16 activations do. Each leaf within 3x the largest
    distance of JAX's bf16 statistics from its float32 ones, plus 1e-5
    of the leaf's max (measured: within 1.86x; at most 3.2e-3 of the
    leaf's max from JAX's)."""
    b32, bb, bp = (bf16_steps[k][2] for k in ("jax_fp32", "jax_bf16",
                                              "port_bf16"))
    assert set(bp) == set(bb) == set(b32) and len(b32) == 114
    for path, ref in bb.items():
        assert bp[path].dtype == np.float32
        own = np.abs(ref - b32[path]).max()
        np.testing.assert_allclose(
            bp[path], ref, rtol=0,
            atol=3 * own + 1e-5 * np.abs(b32[path]).max(),
            err_msg="/".join(path))


# --- the bf16 autograd function and its kernels (no card needed) ----------

def _wiring_inputs(shape=(1, 6, 7, 4, 5), seed=0):
    *ins, g = [torch.from_numpy(a).bfloat16()
               for a in _dcn_case(seed, shape, 1, "random")]
    return ins, g


def test_bf16_autograd_function_calls_the_bf16_kernels(monkeypatch):
    """DCNLocal on bf16 tensors that need a gradient, its ctypes symbols
    replaced by a recorder: forward and backward reach
    dcn_local_fwd_bf16, dcn_local_bwd_data_bf16 and
    dcn_local_bwd_weight_bf16 with the inputs' pointers, fresh outputs
    and the sizes of their _SIGNATURES entries (each kernel followed by
    its launch plan: tile, chunk, the forward's and the weight kernel's
    N tile, the weight kernel's taps and window slots, splits, shared
    memory); each bumps its own
    counter; no float32 kernel is reached; the gradients come back bf16
    in the inputs' shapes, the bias grad a float32 sum rounded once."""
    ins, g = _wiring_inputs()
    calls = []

    def fake_kernel(symbol):
        def launch(*argv):
            _, n_ptr, n_int = dcn._SIGNATURES[symbol]
            assert len(argv) == n_ptr + n_int + 1
            assert all(isinstance(p, int) and p for p in argv[:n_ptr]
                       if p is not None)
            calls.append((symbol, argv[:n_ptr], argv[n_ptr:n_ptr + n_int]))
            return 0
        return launch

    monkeypatch.setattr(dcn, "_kernel", fake_kernel)
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    for name in ("launch_fwd", "launch_bwd_data", "launch_bwd_weight"):
        monkeypatch.setattr(dcn, name, lambda *a: pytest.fail(
            "a float32 kernel was reached"))
    counters = ("LAUNCHES", "BWD_DATA_LAUNCHES", "BWD_WEIGHT_LAUNCHES",
                "BF16_LAUNCHES", "BWD_DATA_BF16_LAUNCHES",
                "BWD_WEIGHT_BF16_LAUNCHES")
    before = [getattr(dcn, c) for c in counters]
    ts = [t.clone().requires_grad_() for t in ins]
    out = dcn.DCNLocal.apply(*ts, 1)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 6, 7, 5)
    out.backward(g)
    after = [getattr(dcn, c) for c in counters]
    assert [a - b for a, b in zip(after, before)] == [0, 0, 0, 1, 1, 1]
    sizes = (1, 6, 7, 4, 5, 1)
    ptr = [t.data_ptr() for t in ts]
    assert [c[0] for c in calls] == ["dcn_local_fwd_bf16",
                                     "dcn_local_bwd_data_bf16",
                                     "dcn_local_bwd_weight_bf16"]
    fwd = dcn.fwd_bf16_plan(1, 6, 7, 4, 5, 1)
    data = dcn.bwd_data_bf16_plan(1, 6, 7, 4, 5, 1)
    wgt = dcn.bwd_weight_bf16_plan(1, 6, 7, 4, 5, 1)
    assert calls[0][1][:5] == tuple(ptr)
    assert calls[0][2] == (*sizes, 4, 16, 64, 64, fwd["splits"],
                           fwd["smem_bytes"])
    assert calls[1][1][:5] == (*ptr[:4], g.data_ptr())
    assert calls[1][2] == (*sizes, 4, 16, 64, data["splits"],
                           data["smem_bytes"])
    assert calls[2][1][:4] == (*ptr[:3], g.data_ptr())
    assert wgt["route"] == "window"
    assert calls[2][2] == (*sizes, *wgt["tile"], 64, wgt["n_tile"],
                           wgt["taps"], wgt["window_slots"], wgt["splits"],
                           wgt["smem_bytes"])
    for t in ts:
        assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape
    torch.testing.assert_close(ts[4].grad,
                               g.float().sum((0, 1, 2)).bfloat16(), atol=0,
                               rtol=0)


def test_bf16_autograd_function_gives_the_plain_bf16_gradients(monkeypatch):
    """DCNLocal at bf16 with its three bf16 launchers replaced by CPU
    stand-ins built from the plain bf16 version: the gradients of x,
    offset, mask, weight and bias equal autograd of the plain bf16
    version exactly, and an input that needs no gradient launches
    nothing for it."""
    ins, g = _wiring_inputs(seed=4)
    calls = []

    def plain_vjp(x, offset, mask, weight, grad_out, r):
        ts = [t.detach().requires_grad_() for t in (x, offset, mask,
                                                    weight)]
        with torch.enable_grad():   # backward runs with grad mode off
            out = dcn.deform_conv2d_local_plain(*ts, None, r)
        return torch.autograd.grad(out, ts, grad_out)

    def fwd(*a):
        calls.append("fwd")
        return dcn.deform_conv2d_local_plain(*a)

    def bwd_data(x, offset, mask, weight, grad_out, r):
        calls.append("data")
        dcn._check_grad(grad_out, x, weight.shape[3])
        return plain_vjp(x, offset, mask, weight, grad_out, r)[:3]

    def bwd_weight(x, offset, mask, grad_out, cout, r):
        calls.append("weight")
        w = torch.zeros(3, 3, x.shape[3], cout, dtype=x.dtype)
        return plain_vjp(x, offset, mask, w, grad_out, r)[3]

    monkeypatch.setattr(dcn, "launch_fwd_bf16", fwd)
    monkeypatch.setattr(dcn, "launch_bwd_data_bf16", bwd_data)
    monkeypatch.setattr(dcn, "launch_bwd_weight_bf16", bwd_weight)
    ts = [t.clone().requires_grad_() for t in ins]
    dcn.DCNLocal.apply(*ts, 1).backward(g)
    assert calls == ["fwd", "data", "weight"]
    ref = [t.clone().requires_grad_() for t in ins]
    dcn.deform_conv2d_local_plain(*ref, 1).backward(g)
    for a, b in zip(ts, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=0, rtol=0)

    calls.clear()
    ts = [t.clone() for t in ins]
    ts[3].requires_grad_()
    dcn.DCNLocal.apply(*ts, 1).float().sum().backward()
    assert calls == ["fwd", "weight"]


# --- gradient accumulation at bf16 ---------------------------------------

def _grad_rel_l2(grads, ref):
    return (sum(((grads[n] - g) ** 2).sum().item() for n, g in ref.items())
            / sum((g ** 2).sum().item() for g in ref.values())) ** .5


def test_grad_accum_at_bf16_matches_the_monolithic_step(ckpt):
    """grad_accum=2 on [mb; mb] against one bf16 step on [mb; mb], with a
    float32 step on [mb; mb] as the yardstick. Each micro-batch's
    BatchNorm statistics equal the full batch's, but their float32 sums
    over 2 and 4 images round to other bf16 activations, and this step
    amplifies such flips as it amplifies bf16 rounding itself (below).
    So: the accumulated step's loss lies within 2x the monolithic bf16
    step's distance from the float32 loss of it (measured 1.04e-3
    against 1.88e-3 relative); its gradients lie no further from the
    monolithic bf16 ones than those lie from the float32 ones (relative
    L2 0.205 against 0.395) and no further than 1.5x from the float32
    ones (0.377 against 0.395); all are float32; and the running
    statistics advanced twice, rel 1e-5. A wrong 1/accum scale would
    put the gradients 0.5 or more away."""
    steps = {}
    for key, kw in (("mono", {"compute_dtype": "bfloat16"}),
                    ("acc", {"compute_dtype": "bfloat16", "grad_accum": 2}),
                    ("fp32", {})):
        cfg, _ = _cfgs(batch_size=4, **kw)
        mb = _batch(seed=3)
        batch = {k: np.concatenate([v, v]) for k, v in mb.items()}
        model = _port_model(cfg, ckpt)
        bn = model.backbone.base.level2.root.conv.bn
        bn0 = bn.running_mean.clone()
        trainer = Trainer(cfg, model, device="cpu")
        assert trainer.accum == kw.get("grad_accum", 1)
        loss = float(trainer.train_step(batch, 1e-4)["tot"])
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        assert all(g.dtype == torch.float32 for g in grads.values()), key
        steps[key] = (loss, grads, bn0, bn.running_mean)
    (l_mono, g_mono, bn0, ra1), (l_acc, g_acc, _, ra2), (l32, g32, _, _) = (
        steps["mono"], steps["acc"], steps["fp32"])
    assert set(g_acc) == set(g_mono) == set(g32)
    assert abs(l_acc - l_mono) <= 2 * abs(l_mono - l32)
    own = _grad_rel_l2(g_mono, g32)
    assert _grad_rel_l2(g_acc, g_mono) <= own
    assert _grad_rel_l2(g_acc, g32) <= 1.5 * own
    # ra1 = 0.9 ra0 + 0.1 m after one step; two chained: 0.9 ra1 + 0.1 m'
    # with m' the second micro-batch's mean, the first's to float32
    # rounding and bf16 flips of the layers before it
    m = (ra1 - 0.9 * bn0) / 0.1
    torch.testing.assert_close(ra2, 0.9 * ra1 + 0.1 * m, rtol=1e-5,
                               atol=1e-6)
