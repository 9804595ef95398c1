"""The port's bfloat16 serving path (centertrack_tpu_torch with
``compute_dtype="bfloat16"``) against the JAX package at bf16 on the
CPU, on inputs made from numpy seeds: the plain bf16 clamped DCN against
the Pallas kernels (interpret mode) and XLA, the layers, the whole
network on JAX's initial weights, the tie order of top-K, the warp's
bf16 precision, FusedDetector over three frames; the DCN wrapper's bf16
routes (stand-in launchers: the CUDA kernels run only on the card, where
chip_smoke.py holds them against the plain version); a bf16 Trainer
step on the CPU; and the two faults
repaired with this slice: decode without the ``reg`` head (C1) and an
unloaded model being JAX's initial network (C2). Each tolerance is
stated beside its test."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import bench
from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.engine.fused import FusedDetector as JFusedDetector
from centertrack_tpu.models.model import create_model as jcreate_model
from centertrack_tpu.models.model import init_model as jinit_model
from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu.ops import decode as jdecode
from centertrack_tpu.ops import warp as jwarp
from centertrack_tpu.ops.dcn_pallas import deform_conv2d_pallas
from centertrack_tpu.ops.dcn_pallas_grid import deform_conv2d_pallas_grid
from centertrack_tpu.ops.dcn_pallas_halo import deform_conv2d_local_halo
from centertrack_tpu.ops.dcn_pallas_shift import deform_conv2d_local_pallas
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models.layers import (BatchNorm, Conv2d,
                                                 cast_param)
from centertrack_tpu_torch.models.model import create_model, params_from_jax
from centertrack_tpu_torch.ops import dcn, decode, warp
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
BF16 = ml_dtypes.bfloat16


def ulp(a):
    """One bf16 ulp at |a| (2^(e - 7) for |a| in [2^e, 2^(e+1)))."""
    a = np.abs(np.asarray(a, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t):
    return t.float().numpy()


# --- the clamped DCN at bf16 -----------------------------------------------

def _dcn_inputs(seed, b, h, w, cin, cout, r):
    """bf16 values (as numpy ml_dtypes), offsets spread past the clamp."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, cin).astype(BF16),
            rng.uniform(-(r + 1.5), r + 1.5, (b, h, w, 18)).astype(BF16),
            rng.rand(b, h, w, 9).astype(BF16),
            (rng.randn(3, 3, cin, cout) * 0.1).astype(BF16),
            rng.randn(cout).astype(BF16))


def _plain(args, r):
    return _f32(dcn.deform_conv2d_local_plain(*map(_bf16, args), r))


# K3 and K4 sample in float32 from the bf16 inputs, mask, round the sample
# to bf16 and contract with float32 accumulation: the rounding points of
# the port's plain version and of dcn_local_fwd_bf16.
SAME_ROUNDING = {
    "K3_dcn_pallas_shift": lambda x, o, m, w, b, r:
        deform_conv2d_local_pallas(x, o, m, w, b, r, 8, 8, True),
    "K4_dcn_pallas_halo": lambda x, o, m, w, b, r: deform_conv2d_local_halo(
        x, o, m, w, b, r, None, None, True),
}


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("kernel", sorted(SAME_ROUNDING))
def test_plain_bf16_matches_k3_k4_within_one_ulp(kernel, r):
    """Same rounding points, so only the float32 summation order of the
    contraction differs: within 1 bf16 ulp of each element, plus 1e-5
    of max|out| for elements that cancel to near zero (measured: equal
    everywhere). H = 13 is not a multiple of the kernels' row tile."""
    args = _dcn_inputs(10 + r, 1, 13, 16, 16, 24, r)
    ref = np.asarray(SAME_ROUNDING[kernel](*args, r))
    assert ref.dtype == BF16
    ref = ref.astype(np.float32)
    out = _plain(args, r)
    tol = ulp(ref) + 1e-5 * np.abs(ref).max()
    assert (np.abs(out - ref) <= tol).all()


# K1, K2 and the XLA schedules round elsewhere: K1/K2 form the hat weights
# in bf16 (from the bf16 offsets) and contract the unrounded float32
# sample; XLA accumulates the sample itself in bf16.
OTHER_ROUNDING = {
    "K1_dcn_pallas": lambda x, o, m, w, b, r: deform_conv2d_pallas(
        x, o, m, w, b, max_offset=r, row_tile=8, interpret=True),
    "K2_dcn_pallas_grid": lambda x, o, m, w, b, r: deform_conv2d_pallas_grid(
        x, o, m, w, b, max_offset=r, row_tile=8, interpret=True),
    **{f"xla_{impl}": lambda x, o, m, w, b, r: jdcn.deform_conv2d_local(
        x, o, m, w, b, max_offset=r)
       for impl in ("taploop", "premul", "fused", "shiftfirst")},
}


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("schedule", sorted(OTHER_ROUNDING))
def test_plain_bf16_matches_the_other_schedules_loosely(schedule, r,
                                                        monkeypatch):
    """Rounded elsewhere, so a looser bound: max |diff| <= 2e-2 of
    max|out| (measured 4.3e-3 to 6.4e-3 at these inputs)."""
    if schedule.startswith("xla_"):
        monkeypatch.setenv("CT_LOCAL_IMPL", schedule[len("xla_"):])
    args = _dcn_inputs(10 + r, 1, 13, 16, 16, 24, r)
    ref = np.asarray(OTHER_ROUNDING[schedule](*args, r)).astype(np.float32)
    out = _plain(args, r)
    assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


def test_plain_bf16_rounds_the_sample_and_the_output():
    """The plain bf16 version is the float32 one on the bf16 values with
    the masked sample rounded to bf16 before the contraction: at zero
    offsets and a full mask the sample is x itself (exact in bf16), so
    it is a float32 conv of the bf16 values, rounded once."""
    x, _, _, weight, bias = _dcn_inputs(3, 1, 10, 12, 6, 5, 1)
    xt, wt, bt = map(_bf16, (x, weight, bias))
    out = dcn.deform_conv2d_local(xt, torch.zeros(1, 10, 12, 18).bfloat16(),
                                  torch.ones(1, 10, 12, 9).bfloat16(), wt,
                                  bt, 1)
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.conv2d(
        xt.float().permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1),
        bt.float(), padding=1).permute(0, 2, 3, 1)
    # one rounding of a float32 sum taken in another order: 1 ulp
    ref = ref.numpy()
    assert (np.abs(_f32(out) - ref) <= ulp(ref) + 1e-6).all()


def _mixes():
    x, o, m, w, b = map(_bf16, _dcn_inputs(4, 1, 6, 7, 4, 8, 1))
    return {"x_fp32": dict(x=x.float(), offset=o, mask=m, weight=w, bias=b),
            "offset_fp32": dict(x=x, offset=o.float(), mask=m, weight=w,
                                bias=b),
            "mask_fp32": dict(x=x, offset=o, mask=m.float(), weight=w,
                              bias=b),
            "weight_fp32": dict(x=x, offset=o, mask=m, weight=w.float(),
                                bias=b),
            "bias_fp32": dict(x=x, offset=o, mask=m, weight=w,
                              bias=b.float()),
            "weight_half": dict(x=x, offset=o, mask=m, weight=w.half(),
                                bias=b)}


@pytest.mark.parametrize("name", sorted(_mixes()))
def test_check_rejects_a_dtype_mix_before_any_launch(name):
    before = (dcn.LAUNCHES, dcn.BF16_LAUNCHES)
    with pytest.raises(TypeError):
        dcn.deform_conv2d_local(**_mixes()[name], max_offset=1)
    assert (dcn.LAUNCHES, dcn.BF16_LAUNCHES) == before


def test_cpu_bf16_takes_the_plain_version_and_launches_nothing():
    args = list(map(_bf16, _dcn_inputs(5, 1, 9, 8, 8, 16, 1)))
    before = (dcn.LAUNCHES, dcn.BF16_LAUNCHES)
    out = dcn.deform_conv2d_local(*args, max_offset=1)
    assert (dcn.LAUNCHES, dcn.BF16_LAUNCHES) == before
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out, dcn.deform_conv2d_local_plain(*args, max_offset=1), atol=0,
        rtol=0)


def test_bf16_cuda_route_launches_dcn_local_fwd_bf16(monkeypatch):
    """The CUDA route of a bf16 call without gradient is the bf16
    launcher: it calls the symbol dcn_local_fwd_bf16 with the inputs'
    pointers, a fresh bf16 output, the float32 scratch of the split
    partials, and the sizes followed by the launch plan of
    ``fwd_bf16_plan`` (tile, chunk, N tile, splits, shared memory), as
    many as its _SIGNATURES entry says, and counts the launch (the
    ctypes call is a stand-in here); the float32 kernel is never
    reached."""
    args = list(map(_bf16, _dcn_inputs(6, 1, 7, 9, 8, 16, 1)))
    calls = []

    def fake_kernel(symbol):
        def launch(*argv):
            _, n_ptr, n_int = dcn._SIGNATURES[symbol]
            assert len(argv) == n_ptr + n_int + 1
            calls.append((symbol, argv[:5], argv[n_ptr:n_ptr + n_int]))
            assert isinstance(argv[6], int) and argv[6]  # split partials
            return 0
        return launch

    monkeypatch.setattr(dcn, "_kernel", fake_kernel)
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    monkeypatch.setattr(dcn, "launch_fwd", lambda *a: pytest.fail(
        "the float32 kernel was reached"))
    fn = dcn.route(torch.device("cuda"), torch.bfloat16)
    assert fn is dcn.launch_fwd_bf16
    before = (dcn.LAUNCHES, dcn.BF16_LAUNCHES)
    out = fn(*args, 1)
    assert (dcn.LAUNCHES, dcn.BF16_LAUNCHES) == (before[0], before[1] + 1)
    plan = dcn.fwd_bf16_plan(1, 7, 9, 8, 16, 1)
    assert plan["splits"] == 9 and plan["n_tile"] == 64
    assert calls == [("dcn_local_fwd_bf16",
                      tuple(t.data_ptr() for t in args),
                      (1, 7, 9, 8, 16, 1, 4, 16, 64, 64, 9,
                       plan["smem_bytes"]))]
    assert out.dtype == torch.bfloat16 and out.shape == (1, 7, 9, 16)


def test_bf16_cuda_input_that_needs_a_gradient_raises(monkeypatch):
    """A bf16 CUDA call that needs a gradient goes to DCNLocal, the
    kernels' autograd function, which runs the bf16 kernels
    (dcn_local_fwd_bf16, then dcn_local_bwd_data_bf16 and
    dcn_local_bwd_weight_bf16): when a launch fails it raises, in the
    forward and in the backward, and nothing falls back to the plain
    version or upcasts to the float32 kernels (ctypes calls stood in
    here)."""
    fn = dcn.route(torch.device("cuda"), torch.bfloat16, needs_grad=True)
    assert fn.__self__ is dcn.DCNLocal
    failing = set()
    monkeypatch.setattr(dcn, "_kernel", lambda symbol: (
        lambda *argv: 719 if symbol in failing else 0))
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    for name in ("launch_fwd", "launch_bwd_data", "launch_bwd_weight",
                 "deform_conv2d_local_plain"):
        monkeypatch.setattr(dcn, name, lambda *a: pytest.fail(
            "the float32 kernels or the plain version were reached"))
    args = [t.requires_grad_() for t in
            map(_bf16, _dcn_inputs(7, 1, 5, 6, 4, 8, 1))]
    failing.add("dcn_local_fwd_bf16")
    before = dcn.BF16_LAUNCHES
    with pytest.raises(RuntimeError, match="dcn_local_fwd_bf16 launch "
                                           "failed: CUDA error 719"):
        fn(*args, 1)
    assert dcn.BF16_LAUNCHES == before
    failing.clear()
    failing.add("dcn_local_bwd_data_bf16")
    out = fn(*args, 1)
    assert out.dtype == torch.bfloat16 and dcn.BF16_LAUNCHES == before + 1
    with pytest.raises(RuntimeError, match="dcn_local_bwd_data_bf16 launch "
                                           "failed"):
        out.backward(torch.ones_like(out))


@pytest.mark.parametrize("grad_mode, requires_grad, want", [
    (True, True, True), (False, True, False), (True, False, False)])
def test_wrapper_asks_for_a_gradient_only_when_one_is_needed(
        monkeypatch, grad_mode, requires_grad, want):
    """Serving runs under no_grad with parameters that require grad: the
    wrapper must not treat that as a gradient to compute."""
    seen = []

    def route(device, dtype, needs_grad):
        seen.append((device.type, dtype, needs_grad))
        return dcn.deform_conv2d_local_plain

    monkeypatch.setattr(dcn, "route", route)
    args = list(map(_bf16, _dcn_inputs(8, 1, 5, 6, 4, 8, 1)))
    args[3].requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad_mode):
        dcn.deform_conv2d_local(*args, max_offset=1)
    assert seen == [("cpu", torch.bfloat16, want)]


# --- layers at bf16 against flax -------------------------------------------

def test_batchnorm_eval_bf16_matches_flax():
    """Eval BatchNorm on bf16: normalised in float32 with the float32
    statistics, one rounding to bf16, as flax's BatchNorm(dtype=bf16).
    Within 1 bf16 ulp (the float32 formulas group the terms otherwise)."""
    rng = np.random.RandomState(0)
    c = 12
    x = (rng.randn(2, 5, 7, c) * 3 + 1).astype(BF16)
    mean = rng.randn(c).astype(np.float32)
    var = rng.uniform(0.2, 4, c).astype(np.float32)
    scale = rng.randn(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16)
    ref = np.asarray(bn.apply({"params": {"scale": scale, "bias": bias},
                               "batch_stats": {"mean": mean, "var": var}},
                              x))
    assert ref.dtype == BF16
    ref = ref.astype(np.float32)
    m = BatchNorm(c).eval()
    with torch.no_grad():
        for t, a in ((m.weight, scale), (m.bias, bias),
                     (m.running_mean, mean), (m.running_var, var)):
            t.copy_(torch.from_numpy(a))
        out = m(_bf16(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16
    got = _f32(out.permute(0, 2, 3, 1))
    assert (np.abs(got - ref) <= ulp(ref)).all()


def test_conv_bf16_casts_its_kernel_and_bias_as_flax_does():
    """A bf16 conv against flax's nn.Conv(dtype=bf16) with the same
    float32 parameters: flax rounds the conv and then the bias sum,
    torch rounds once, so within 2 bf16 ulps, plus 1e-3 of max|out| for
    sums that cancel to near zero."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 9, 11, 8).astype(BF16)
    k = (rng.randn(3, 3, 8, 6) * 0.2).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    ref = np.asarray(fnn.Conv(6, (3, 3), padding=((1, 1), (1, 1)),
                              dtype=jnp.bfloat16).apply(
        {"params": {"kernel": k, "bias": b}}, x))
    assert ref.dtype == BF16
    ref = ref.astype(np.float32)
    conv = Conv2d(8, 6, 3, 1, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(b))
        out = conv(_bf16(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    got = _f32(out.permute(0, 2, 3, 1))
    assert (np.abs(got - ref) <= 2 * ulp(ref) + 1e-3 * np.abs(ref).max()
            ).all()


def test_cast_param_reuses_a_cast_until_the_parameter_changes():
    """Without a gradient to record, a bf16 layer casts its float32
    weight once and reuses it; an in-place update or a state_dict load
    makes a fresh cast; with a gradient the cast is part of the graph;
    at the parameter's own dtype it is the parameter."""
    conv = Conv2d(4, 6, 3, 1, 1)
    with torch.no_grad():
        first = cast_param(conv, "weight", torch.bfloat16)
        assert cast_param(conv, "weight", torch.bfloat16) is first
        conv.weight.mul_(2)
        second = cast_param(conv, "weight", torch.bfloat16)
        assert second is not first
        torch.testing.assert_close(second, conv.weight.bfloat16(), atol=0,
                                   rtol=0)
    conv.load_state_dict({"weight": torch.ones(6, 4, 3, 3),
                          "bias": torch.zeros(6)})
    with torch.no_grad():
        assert (cast_param(conv, "weight", torch.bfloat16) == 1).all()
    tracked = cast_param(conv, "weight", torch.bfloat16)
    assert tracked.grad_fn is not None
    assert cast_param(conv, "weight", torch.float32) is conv.weight


# --- the network -----------------------------------------------------------

class SmallMeta:
    num_categories = 1
    default_resolution = [64, 96]
    num_joints = 17


NET_KW = dict(task="tracking", pre_hm=True, dla_node="dcn_local1",
              head_conv=32)


def _net_cfgs(**kw):
    args = dict(NET_KW, **kw)
    return (set_heads(parse_task(Config(**args)), SmallMeta),
            jset_heads(jparse_task(JConfig(**args)), SmallMeta))


@pytest.fixture(scope="module")
def jax_init():
    """JAX's initial network at 64x96 (its parameters do not depend on
    the compute dtype)."""
    _, jcfg = _net_cfgs()
    jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                           jcfg)
    return jinit_model(jmodel, jcfg)


@pytest.fixture(scope="module")
def bf16_forward_pair(jax_init):
    """Both packages' bf16 networks on JAX's initial weights, on the
    same seeded inputs, and JAX's float32 network beside them."""
    params, batch_stats = jax_init
    rng = np.random.RandomState(0)
    ins = (rng.randn(1, 64, 96, 3).astype(np.float32),
           rng.randn(1, 64, 96, 3).astype(np.float32),
           rng.rand(1, 64, 96, 1).astype(np.float32))
    outs = {}
    for dtype in ("bfloat16", "float32"):
        cfg, jcfg = _net_cfgs(compute_dtype=dtype)
        jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict,
                               jcfg.head_convs_dict, jcfg)
        jout = jax.jit(lambda v, a, b, c: jmodel.apply(
            v, a, b, c, train=False))(
            {"params": params, "batch_stats": batch_stats}, *ins)[-1]
        outs["jax_" + dtype] = {k: np.asarray(v) for k, v in jout.items()}
    cfg, _ = _net_cfgs(compute_dtype="bfloat16")
    model = create_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(params, batch_stats), strict=True)
    with torch.no_grad():
        out = model(*map(torch.from_numpy, ins))[-1]
    outs["port_bfloat16"] = {k: v.contiguous().numpy() for k, v in
                             out.items()}
    return outs, model


@pytest.mark.parametrize("head", ["hm", "reg", "tracking", "wh"])
def test_bf16_network_matches_jax_bf16(bf16_forward_pair, head):
    """Head by head, float32 maps of bf16 networks. The two frameworks
    round every layer's bf16 output at slightly other points (flax
    rounds a conv and then its bias sum, the XLA and oneDNN convs sum
    in other orders), and one-ulp flips grow through ~40 layers: max
    |diff| <= 4e-2 of max|JAX map| (measured 3.4e-3 to 2.0e-2; JAX's
    own bf16 network is 1.4e-3 to 1.8e-2 from its float32 one)."""
    outs, _ = bf16_forward_pair
    ref = outs["jax_bfloat16"][head]
    got = outs["port_bfloat16"][head]
    assert ref.dtype == got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 4e-2 * np.abs(ref).max()


@pytest.mark.parametrize("head", ["hm", "reg", "tracking", "wh"])
def test_bf16_network_is_as_far_from_jax_as_bf16_is_from_fp32(
        bf16_forward_pair, head):
    """The port's bf16 maps are within 3x the distance of JAX's bf16 maps
    from JAX's float32 ones (measured ratio 1.1 to 2.4): the port's
    difference from JAX is of the size of bf16 rounding itself."""
    outs, _ = bf16_forward_pair
    ref = outs["jax_bfloat16"][head]
    own = np.abs(ref - outs["jax_float32"][head]).max()
    assert own > 0
    assert np.abs(outs["port_bfloat16"][head] - ref).max() <= 3 * own


def test_bf16_network_parameters_stay_float32_and_compute_in_bf16(
        bf16_forward_pair):
    outs, model = bf16_forward_pair
    assert model.dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    # bf16-quantised maps: every value is a bf16 value
    for head, v in outs["port_bfloat16"].items():
        np.testing.assert_array_equal(
            v, v.astype(BF16).astype(np.float32), err_msg=head)


def test_bridge_keeps_float32_leaves_whatever_the_tree_holds(jax_init):
    """Parameters stay float32: a JAX tree held in bf16 or float16
    bridges to float32 tensors of the same values."""
    params, batch_stats = jax_init
    for dtype in (BF16, np.float16):
        low = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(dtype),
                                     params)
        sd = params_from_jax(low, batch_stats)
        ref = params_from_jax(params, batch_stats)
        key = "heads.hm.out.bias"
        assert {t.dtype for k, t in sd.items()
                if not k.endswith("num_batches_tracked")} == {torch.float32}
        np.testing.assert_array_equal(
            sd[key].numpy(),
            ref[key].numpy().astype(dtype).astype(np.float32))


# --- C2: an unloaded model is JAX's initial network -------------------------

def _init_pair(jax_init):
    params, batch_stats = jax_init
    cfg, _ = _net_cfgs()
    return (params_from_jax(params, batch_stats),
            create_model(cfg, "cpu").state_dict())


def _random_leaf(key):
    """The leaves JAX draws from lecun_normal: conv kernels (not the
    zero-initialised offset/mask conv, not the up kernels) and the DCN
    weights."""
    return (key.endswith(".weight") and ".up_" not in key and
            "conv_offset_mask" not in key and ".bn." not in key and
            "actf_bn" not in key and not key.endswith("_layer.bn.weight"))


def test_unloaded_model_has_jaxs_deterministic_parameters(jax_init):
    """Exactly equal: the up kernels (bilinear, flipped), the zero
    offset/mask convs and DCN biases, the zero conv biases, the hm
    prior bias and every BatchNorm leaf (scale 1, bias 0, mean 0,
    var 1)."""
    ref, got = _init_pair(jax_init)
    assert set(ref) == set(got)
    fixed = [k for k in ref if not _random_leaf(k)]
    assert any(".up_" in k for k in fixed)
    assert any("conv_offset_mask" in k for k in fixed)
    assert "heads.hm.out.bias" in fixed
    for k in fixed:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
    assert float(got["heads.hm.out.bias"][0]) == pytest.approx(-4.6)


def test_unloaded_model_draws_jaxs_distributions(jax_init):
    """Each lecun_normal leaf: zero mean and std sqrt(1 / fan_in) within
    sampling error (std within 15%, |mean| within 4 std / sqrt(n), for
    leaves of at least 500 values), truncated at 2 / 0.8796 sqrt(1 /
    fan_in), as JAX's same leaf is; and two seeds give other draws."""
    ref, got = _init_pair(jax_init)
    keys = [k for k in ref if _random_leaf(k)]
    assert len(keys) > 50
    for k in keys:
        g, r = got[k].numpy(), ref[k].numpy()
        assert g.shape == r.shape, k
        fan_in = g[0].size if g.ndim == 4 and g.shape[:2] != (3, 3) else \
            g[..., 0].size
        std = np.sqrt(1.0 / fan_in)
        cut = 2.0 * std / .87962566103423978
        for a in (g, r):
            assert np.abs(a).max() <= cut * (1 + 1e-6), k
            if a.size >= 500:
                assert abs(a.std() / std - 1) < 0.15, k
                assert abs(a.mean()) < 4 * std / np.sqrt(a.size), k
    cfg, _ = _net_cfgs(seed=1)
    other = create_model(cfg, "cpu").state_dict()
    assert not torch.equal(other[keys[0]], got[keys[0]])
    cfg, _ = _net_cfgs()
    again = create_model(cfg, "cpu").state_dict()
    assert all(torch.equal(again[k], got[k]) for k in got)


# --- top-K ties --------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [1, 2])
def test_topk_breaks_ties_as_jax_top_k(num_classes):
    """A bf16-quantised heat map drawn from 12 distinct values, so nearly
    every score ties: identical indices, classes and scores to
    jax.lax.top_k (lower index first)."""
    rng = np.random.RandomState(num_classes)
    levels = np.array([0.4990234375, 0.5, 0.5009765625, 0.25, 0.75,
                       0.9, 0.1, 0.3, 0.6, 0.05, 0.95, 0.2])
    heat = levels[rng.randint(0, len(levels), (1, 18, 22, num_classes))]
    heat = heat.astype(BF16).astype(np.float32)
    k = 40
    ref = jdecode.topk(jnp.asarray(heat), k)
    got = decode.topk(torch.from_numpy(heat), k)
    for name, a, b in zip(("score", "inds", "clses", "ys", "xs"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    # the same through nms_heat + decode, every row
    jd = jdecode.generic_decode({"hm": jnp.asarray(heat)}, k=k,
                                num_classes=num_classes)
    pd = decode.generic_decode({"hm": torch.from_numpy(heat)}, k=k,
                               num_classes=num_classes)
    for key in ("scores", "inds", "clses", "cts"):
        np.testing.assert_array_equal(pd[key].numpy(), np.asarray(jd[key]),
                                      err_msg=key)


# --- the warp's precision ----------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "highest", "default", "fast"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warp_precision_for_chooses_as_jax(mode, dtype):
    jprec = jwarp.warp_precision_for(JConfig(warp_precision=mode,
                                             compute_dtype=dtype))
    want = ("default" if jprec == jax.lax.Precision.DEFAULT
            else "highest")
    got = warp.warp_precision_for(Config(warp_precision=mode,
                                         compute_dtype=dtype))
    assert got == want


@pytest.mark.parametrize("field, value", [
    ("compute_dtype", "float16"), ("compute_dtype", "bf16"),
    ("warp_precision", "exact")])
def test_config_rejects_an_unknown_dtype_or_precision(field, value):
    with pytest.raises(ValueError, match=field):
        Config(**{field: value})


def test_warp_default_rounds_each_operand_to_bf16():
    """``default`` against numpy: the two hat-weight matrices, the image
    and the first product rounded to bf16, products summed in float64
    here and float32 there (so within 1e-5 of the 0-255 range), and
    distinct from ``highest`` by more than that."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (45, 70, 3)).astype(np.uint8)
    inv = np.array([[0.731, 0, 3.37], [0, 0.713, 1.91]], np.float32)
    oh, ow = 40, 64
    got = warp.affine_warp_separable(torch.from_numpy(img),
                                     torch.from_numpy(inv), oh, ow,
                                     "default").numpy()
    high = warp.affine_warp_separable(torch.from_numpy(img),
                                      torch.from_numpy(inv), oh, ow,
                                      "highest").numpy()

    def r(a):
        return np.asarray(a, np.float32).astype(BF16).astype(np.float64)

    sy = (inv[1, 1] * np.arange(oh, dtype=np.float32) + inv[1, 2])
    sx = (inv[0, 0] * np.arange(ow, dtype=np.float32) + inv[0, 2])
    wy = np.maximum(0, 1 - np.abs(sy[:, None] - np.arange(45)[None, :],
                                  dtype=np.float32))
    wx = np.maximum(0, 1 - np.abs(sx[:, None] - np.arange(70)[None, :],
                                  dtype=np.float32))
    chw = img.transpose(2, 0, 1).astype(np.float64)
    tmp = np.einsum("oh,chw->cow", r(wy), chw).astype(np.float32)
    ref = np.einsum("cow,pw->cop", r(tmp), r(wx)).transpose(1, 2, 0)
    np.testing.assert_allclose(got, ref, atol=1e-5 * 255, rtol=0)
    assert np.abs(high - ref).max() > 1e-2


# --- FusedDetector at bf16 ---------------------------------------------------

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


DET_KW = dict(task="tracking", pre_hm=True, track_thresh=0.3,
              new_thresh=0.3, max_age=3, dla_node="dcn_local1")


def _detectors(params, batch_stats, **kw):
    args = dict(DET_KW, **kw)
    cfg = set_heads(parse_task(Config(**args)), TrainMeta)
    jcfg = jset_heads(jparse_task(JConfig(**args)), TrainMeta)
    return (FusedDetector(cfg, params, batch_stats, TrainMeta, device="cpu"),
            JFusedDetector(jcfg, params=params, batch_stats=batch_stats,
                           dataset_meta=TrainMeta), cfg)


def _compare_frames(det, jdet, cfg, frames, score_tol, box_tol):
    """Rows above out_thresh, in order, after leaving out those within
    ``score_tol`` of the threshold in either framework (a bf16 score that
    close may fall on either side): scores within ``score_tol``, boxes
    and centres within ``box_tol`` px, classes equal, track ids a
    bijection. Returns the number of rows compared."""
    id_map, n_rows = {}, 0
    for f, frame in enumerate(frames):
        packed = det.run(frame)
        jpacked = jdet.run(frame)
        assert packed.dtype == torch.float32
        assert np.asarray(jpacked).dtype == np.float32

        def keep(rows):
            return [d for d in rows
                    if abs(d["score"] - cfg.out_thresh) > score_tol]
        got = keep(FusedDetector.fetch(packed, cfg.out_thresh))
        ref = keep(JFusedDetector.fetch(jpacked, cfg.out_thresh))
        assert len(got) == len(ref), f"frame {f}"
        for a, b in zip(got, ref):
            assert abs(a["score"] - b["score"]) <= score_tol
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=box_tol,
                                       rtol=0)
            np.testing.assert_allclose(a["ct"], b["ct"], atol=box_tol,
                                       rtol=0)
            assert a["class"] == b["class"]
            assert id_map.setdefault(a["tracking_id"],
                                     b["tracking_id"]) == b["tracking_id"]
            n_rows += 1
    assert len(set(id_map.values())) == len(id_map)
    return n_rows


def test_bf16_fused_detector_matches_jax_bf16_over_three_frames():
    """Both at compute_dtype="bfloat16" and warp_precision="highest"
    (XLA on the CPU runs the warp in float32 whatever its precision), on
    the committed checkpoint and three bench-generator frames. Both
    return float32 rows: the networks' head maps are float32, so the
    scores meet the Python-float thresholds in float32 in both
    frameworks (the JAX model casts every head to float32, its
    models/heads.py:64; no bf16 comparison takes place). Scores within
    2e-2 (measured 9.1e-3), boxes within 0.5 px of the 320x192 frame
    (measured 0.14 px)."""
    params, batch_stats = load_jax_ckpt(CKPT)
    det, jdet, cfg = _detectors(params, batch_stats,
                                compute_dtype="bfloat16",
                                warp_precision="highest")
    assert det.model.dtype == torch.bfloat16
    frames = bench.synth_frames(3, height=192, width=320, n_obj=4, seed=0)
    assert _compare_frames(det, jdet, cfg, frames, 2e-2, 0.5) >= 5


# --- C1: decode without reg --------------------------------------------------

def test_decode_without_reg_matches_jax():
    """``off_weight=0`` drops the reg head: the centre is the peak + 0.5,
    in both packages (scores, centres, boxes and tracking within 1e-6)."""
    cfg = set_heads(parse_task(Config(task="tracking", off_weight=0)),
                    SmallMeta)
    jcfg = jset_heads(jparse_task(JConfig(task="tracking", off_weight=0)),
                      SmallMeta)
    assert "reg" not in cfg.heads_dict and "reg" not in jcfg.heads_dict
    rng = np.random.RandomState(3)
    h, w, k = 16, 24, 20
    maps = {"hm": rng.permutation(h * w).reshape(1, h, w, 1).astype(
                np.float32) / (h * w),
            "wh": (rng.rand(1, h, w, 2) * 9 - 1).astype(np.float32),
            "tracking": rng.randn(1, h, w, 2).astype(np.float32)}
    assert set(maps) == set(cfg.heads_dict)
    ref = jdecode.generic_decode({n: jnp.asarray(v) for n, v in
                                  maps.items()}, k=k, num_classes=1)
    got = decode.generic_decode({n: torch.from_numpy(v) for n, v in
                                 maps.items()}, k=k, num_classes=1)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("heads", [("hm", "reg", "tracking"),
                                   ("hm", "tracking")])
def test_decode_without_wh_matches_jax(heads):
    """No wh head: no bboxes, in both packages."""
    rng = np.random.RandomState(4)
    h, w, k = 12, 20, 15
    maps = {"hm": rng.permutation(h * w).reshape(1, h, w, 1).astype(
                np.float32) / (h * w),
            "reg": rng.rand(1, h, w, 2).astype(np.float32),
            "tracking": rng.randn(1, h, w, 2).astype(np.float32)}
    maps = {n: maps[n] for n in heads}
    ref = jdecode.generic_decode({n: jnp.asarray(v) for n, v in
                                  maps.items()}, k=k, num_classes=1)
    got = decode.generic_decode({n: torch.from_numpy(v) for n, v in
                                 maps.items()}, k=k, num_classes=1)
    assert "bboxes" not in got and set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_decode_reads_a_per_class_wh_as_jax():
    """A wh head of 2 * num_classes channels is read at each detection's
    class (JAX ops/decode.py:178-192)."""
    rng = np.random.RandomState(5)
    h, w, k, c = 12, 20, 25, 3
    maps = {"hm": rng.permutation(h * w * c).reshape(1, h, w, c).astype(
                np.float32) / (h * w * c),
            "reg": rng.rand(1, h, w, 2).astype(np.float32),
            "wh": (rng.rand(1, h, w, 2 * c) * 9 - 1).astype(np.float32)}
    ref = jdecode.generic_decode({n: jnp.asarray(v) for n, v in
                                  maps.items()}, k=k, num_classes=c)
    got = decode.generic_decode({n: torch.from_numpy(v) for n, v in
                                 maps.items()}, k=k, num_classes=c)
    np.testing.assert_allclose(got["bboxes"].numpy(),
                               np.asarray(ref["bboxes"]), atol=1e-6, rtol=0)


def test_fused_detector_without_reg_matches_jax():
    """A FusedDetector frame pair with ``off_weight=0`` (the checkpoint's
    reg head left out of both packages' weights), float32: rows above
    out_thresh as in the engine's float32 test (scores within 1e-4,
    boxes within 1e-2 px)."""
    params, batch_stats = load_jax_ckpt(CKPT)
    params = dict(params, heads={k: v for k, v in params["heads"].items()
                                 if k != "reg"})
    det, jdet, cfg = _detectors(params, batch_stats, off_weight=0)
    assert "reg" not in cfg.heads_dict
    frames = bench.synth_frames(2, height=192, width=320, n_obj=4, seed=0)
    assert _compare_frames(det, jdet, cfg, frames, 1e-4, 1e-2) >= 3


def _tiny_train_batch(seed=0):
    """A one-image descriptor batch at SmallMeta's 64x96 input (16x24
    output), with two objects and one ignore box."""
    rng = np.random.RandomState(seed)
    cts = np.array([[[5, 4], [17, 11]]], np.int32)
    return {
        "image": rng.randn(1, 64, 96, 3).astype(np.float32),
        "pre_img": rng.randn(1, 64, 96, 3).astype(np.float32),
        "ind": (cts[..., 1] * 24 + cts[..., 0]).astype(np.int64),
        "cat": np.zeros((1, 2), np.int64),
        "mask": np.ones((1, 2), np.float32),
        "hm_cts": cts, "hm_radii": np.array([[1, 2]], np.int32),
        "hm_valid": np.ones((1, 2), bool),
        "ignore_boxes": np.array([[[1.5, 2.0, 4.9, 3.2]]], np.float32),
        "ignore_cat": np.array([[-1]], np.int32),
        "ignore_valid": np.ones((1, 1), bool),
        "pre_cts_int": cts * 4 + 1, "pre_radii": np.array([[2, 3]],
                                                          np.int32),
        "pre_ks": np.ones((1, 2), np.float32),
        "pre_valid": np.ones((1, 2), bool),
        **{k: rng.rand(1, 2, 2).astype(np.float32) + 1
           for k in ("reg", "wh", "tracking")},
        **{k + "_mask": np.ones((1, 2, 2), np.float32)
           for k in ("reg", "wh", "tracking")}}


def test_trainer_refuses_a_bf16_config():
    """A bf16 Trainer refuses "cuda" where no GPU is present, as a float32
    one does, and on the CPU it trains: one step gives finite float32
    losses, float32 gradients on the float32 parameters and moves them,
    and launches no DCN kernel (the plain bf16 version takes a CPU
    tensor)."""
    cfg, _ = _net_cfgs(compute_dtype="bfloat16")
    model = create_model(cfg, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            Trainer(cfg, model)
    trainer = Trainer(cfg, model, device="cpu")
    w0 = model.heads["hm"].out.weight.detach().clone()
    counts = (dcn.LAUNCHES, dcn.BF16_LAUNCHES, dcn.BWD_DATA_BF16_LAUNCHES,
              dcn.BWD_WEIGHT_BF16_LAUNCHES)
    losses = trainer.train_step(_tiny_train_batch(), 1e-3)
    assert set(losses) == {"tot", "hm", "reg", "wh", "tracking"}
    assert all(v.dtype == torch.float32 and torch.isfinite(v)
               for v in losses.values())
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not torch.equal(model.heads["hm"].out.weight, w0)
    assert (dcn.LAUNCHES, dcn.BF16_LAUNCHES, dcn.BWD_DATA_BF16_LAUNCHES,
            dcn.BWD_WEIGHT_BF16_LAUNCHES) == counts
