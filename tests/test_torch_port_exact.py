"""The port's exact DCNv2 (``ops/dcn.deform_conv2d`` and its plain
version ``deform_conv2d_plain``; dla_node "dcn" and "dcn_mix") against
the JAX package on the CPU, on inputs made from numpy seeds: the plain
version against JAX's ``_deform_conv2d_slot`` and its default dispatch
(slot at h*w >= 4096, onehot below) at float32 and bf16, its autograd
against ``jax.vjp``, the CUDA route (kernel launchers stood in: the
kernels of csrc/dcn_exact.cu run only on the card, where chip_smoke.py
holds them against the plain version), the per-node choice of
``dcn_mix``, the DLA-34 network on the committed exact-trained
checkpoint and FusedDetector. Each tolerance is stated beside its
test."""

import os

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
from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu_torch.config import (Config, MOT_META, parse_task,
                                          set_heads)
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.models.layers import DCNLayer
from centertrack_tpu_torch.models.model import create_model, params_from_jax
from centertrack_tpu_torch.ops import dcn
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_dcn_fp16.ckpt")
BF16 = ml_dtypes.bfloat16
# one map on each side of JAX's slot/onehot crossover (h * w = 4096)
MAPS = [(17, 30), (64, 72)]
OFFSETS = ["n3", "n40", "zero", "1e6"]


def ulp(a):
    """One bf16 ulp at |a| (2^(e - 7) for |a| in [2^e, 2^(e+1)))."""
    a = np.abs(np.asarray(a, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


def _inputs(seed, hw, kind, b=2, cin=8, cout=16):
    """x, offset, mask, weight, bias (float32 numpy). Offsets ~N(0, 3),
    ~N(0, 40) (many samples past the map), all zero (every border tap on
    the clip's tie) or a mix of +/-1e6 and 0.3."""
    rng = np.random.RandomState(seed)
    h, w = hw
    off = {"n3": lambda: rng.randn(b, h, w, 18) * 3,
           "n40": lambda: rng.randn(b, h, w, 18) * 40,
           "zero": lambda: np.zeros((b, h, w, 18)),
           "1e6": lambda: rng.choice([-1e6, 1e6, 0.3], (b, h, w, 18))}[kind]
    return (rng.randn(b, h, w, cin).astype(np.float32),
            off().astype(np.float32),
            rng.rand(b, h, w, 9).astype(np.float32),
            (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
            rng.randn(cout).astype(np.float32))


def _port(args, dtype):
    ts = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    if dtype == "bfloat16":
        ts = [t.to(torch.bfloat16) for t in ts]
    return dcn.deform_conv2d_plain(*ts).float().numpy()


def _jax(args, dtype, impl=None):
    if dtype == "bfloat16":
        args = [np.asarray(a).astype(BF16) for a in args]
    out = jdcn.deform_conv2d(*map(jnp.asarray, args), impl=impl)
    return np.asarray(out).astype(np.float32)


# --- the plain version against JAX -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("hw", MAPS)
def test_plain_matches_jax_slot(hw, kind, dtype):
    """Against ``_deform_conv2d_slot`` (impl="slot" at every size), whose
    arithmetic the plain version follows. float32: max |diff| <= 1e-5
    max|JAX| (measured <= 1.2e-7). bf16 (inputs rounded to bf16 first):
    every value within one bf16 ulp of the larger of the two (the same
    roundings; measured: equal but for one value of 1 ulp)."""
    args = _inputs(0, hw, kind)
    got, ref = _port(args, dtype), _jax(args, dtype, "slot")
    assert got.shape == ref.shape == (2, *hw, 16)
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        np.testing.assert_array_less(
            np.abs(got - ref), np.maximum(ulp(got), ulp(ref)) * 1.0001)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", OFFSETS)
@pytest.mark.parametrize("hw", MAPS)
def test_plain_matches_jax_default_dispatch(hw, kind, dtype):
    """Against JAX's default dispatch: slot at 64x72, onehot at 17x30.
    float32: max |diff| <= 1e-5 max|JAX|. bf16: onehot rounds x @ W and
    the corner weights to bf16, where slot and the port round the
    sample, so the bound is 2 bf16 ulps of max|JAX| (measured <= 1)."""
    args = _inputs(1, hw, kind)
    got, ref = _port(args, dtype), _jax(args, dtype)
    scale = np.abs(ref).max()
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-5 * scale
    else:
        assert np.abs(got - ref).max() <= 2 * ulp(scale)


@pytest.mark.parametrize("kind", ["zero", "n3"])
@pytest.mark.parametrize("hw", MAPS)
def test_plain_autograd_matches_jax_vjp(hw, kind):
    """Gradients of x, offset, mask, weight and bias against ``jax.vjp``
    of JAX's default dispatch at float32, each within 1e-5 of max|JAX
    grad| (measured <= 8.1e-7). Zero offsets put every border tap on the
    position clip's tie, where JAX's derivative is 1/2."""
    args = _inputs(2, hw, kind)
    g = np.random.RandomState(3).randn(2, *hw, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda *v: jdcn.deform_conv2d(*v),
                     *map(jnp.asarray, args))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(dcn.deform_conv2d_plain(*ts), ts,
                              torch.from_numpy(g))
    for name, a, r in zip(("x", "offset", "mask", "weight", "bias"), got,
                          ref):
        assert np.abs(a.numpy() - r).max() <= 1e-5 * np.abs(r).max(), name


@pytest.mark.parametrize("p", [-3.0, -1.0, -0.5, 0.0, 5.5, 6.0, 7.0])
def test_position_clip_derivative_is_jaxs(p):
    """clip(p, -1, size) with size 6: 1 inside, 1/2 at a tie, 0 outside."""
    t = torch.tensor(p, requires_grad=True)
    dcn._ClipPos.apply(t, 6).backward()
    assert t.grad.item() == float(
        jax.grad(lambda v: jnp.clip(v, -1.0, 6.0))(jnp.float32(p)))


def test_plain_bf16_rounds_the_sample_and_the_output():
    """At bf16 the result is bf16 and equals the float32 computation on
    the bf16 values with the masked sample rounded before the
    contraction: a weight of one on the centre tap returns the rounded
    sample itself, plus the bias, rounded once."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 6, 7, 1).astype(np.float32))
    off = torch.from_numpy(rng.uniform(-2, 2, (1, 6, 7, 18)).astype(
        np.float32))
    mask = torch.from_numpy(rng.rand(1, 6, 7, 9).astype(np.float32))
    w = torch.zeros(3, 3, 1, 1)
    w[1, 1] = 1.0
    bias = torch.tensor([0.3])
    low = [t.to(torch.bfloat16) for t in (x, off, mask, w, bias)]
    out = dcn.deform_conv2d_plain(*low)
    assert out.dtype == torch.bfloat16
    centre = dcn.deform_conv2d_plain(*(t.float() for t in low[:4]), None)
    want = (centre.to(torch.bfloat16).float() + low[4].float()).to(
        torch.bfloat16)
    torch.testing.assert_close(out, want, atol=0, rtol=0)


# --- the wrapper and its CUDA route (no card needed) ---------------------------

def test_cpu_wrapper_takes_the_plain_version_and_launches_nothing():
    args = [torch.from_numpy(a) for a in _inputs(5, (9, 8), "n3", b=1)]
    before = (dcn.EXACT_FWD_LAUNCHES, dcn.EXACT_FWD_BF16_LAUNCHES)
    out = dcn.deform_conv2d(*args)
    assert (dcn.EXACT_FWD_LAUNCHES, dcn.EXACT_FWD_BF16_LAUNCHES) == before
    torch.testing.assert_close(out, dcn.deform_conv2d_plain(*args), atol=0,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_call_that_needs_a_gradient_raises(dtype):
    """No backward kernel yet: the CUDA route refuses a gradient and names
    the queued work, and never falls back to the plain version there."""
    with pytest.raises(NotImplementedError, match="A4b"):
        dcn.exact_route(torch.device("cuda"), dtype, needs_grad=True)
    assert dcn.exact_route(torch.device("cpu"), dtype,
                           needs_grad=True) is dcn.deform_conv2d_plain


@pytest.mark.parametrize("dtype, symbol", [
    (torch.float32, "dcn_exact_fwd"), (torch.bfloat16, "dcn_exact_fwd_bf16")])
def test_cuda_route_launches_the_kernel_of_its_dtype(monkeypatch, dtype,
                                                     symbol):
    """The CUDA route of a call without gradient is the launcher of its
    dtype: it calls its symbol with the inputs' pointers, a fresh output
    and the sizes (B, H, W, Cin, Cout) followed by its plan's ints (tile,
    chunk, N tile, box capacity, window slots, splits, shared memory), as
    many as its _SIGNATURES entry says, and counts one launch of its own
    kernel only (the ctypes call is a stand-in here). A failed launch
    raises."""
    args = [torch.from_numpy(a).to(dtype)
            for a in _inputs(6, (7, 9), "n3", b=1, cin=8, cout=16)]
    calls, rc = [], [0]

    def fake_kernel(name):
        def launch(*argv):
            _, n_ptr, n_int = dcn._SIGNATURES[name]
            assert len(argv) == n_ptr + n_int + 1
            calls.append((name, argv[:5], argv[n_ptr:n_ptr + n_int]))
            return rc[0]
        return launch

    monkeypatch.setattr(dcn, "_kernel", fake_kernel)
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    monkeypatch.setattr(dcn, "deform_conv2d_plain", lambda *a: pytest.fail(
        "the plain version was reached"))
    fn = dcn.exact_route(torch.device("cuda"), dtype)
    assert fn is (dcn.launch_exact_fwd_bf16 if dtype == torch.bfloat16
                  else dcn.launch_exact_fwd)
    before = (dcn.EXACT_FWD_LAUNCHES, dcn.EXACT_FWD_BF16_LAUNCHES)
    out = fn(*args)
    low = dtype == torch.bfloat16
    assert (dcn.EXACT_FWD_LAUNCHES, dcn.EXACT_FWD_BF16_LAUNCHES) == (
        before[0] + (not low), before[1] + low)
    plan = (dcn.exact_fwd_bf16_plan if low else dcn.exact_fwd_fp32_plan)(
        1, 7, 9, 8, 16)
    assert calls == [(symbol, tuple(t.data_ptr() for t in args),
                      (1, 7, 9, 8, 16, 4, 16, plan["chunk"], plan["n_tile"],
                       plan["box_capacity"], plan["window_slots"],
                       plan["splits"], plan["smem_bytes"]))]
    assert out.dtype == dtype and out.shape == (1, 7, 9, 16)
    rc[0] = 719
    with pytest.raises(RuntimeError, match=f"{symbol} launch failed: CUDA "
                                           f"error 719"):
        fn(*args)


@pytest.mark.parametrize("bad", ["dtype_mix", "offset_shape", "weight"])
def test_wrapper_rejects_before_any_launch(bad):
    args = [torch.from_numpy(a) for a in _inputs(7, (5, 6), "n3", b=1)]
    if bad == "dtype_mix":
        args[2] = args[2].to(torch.bfloat16)
    elif bad == "offset_shape":
        args[1] = args[1][..., :16].contiguous()
    else:
        args[3] = args[3][:, :, :4].contiguous()
    with pytest.raises((TypeError, ValueError), match="dcn: "):
        dcn.deform_conv2d(*args)


# --- dcn_mix's choice per node -------------------------------------------------

class SmallMeta:
    num_categories = 1
    default_resolution = [64, 96]
    num_joints = 17


def _out_shape(x, weight):
    return (x.shape[0], x.shape[1], x.shape[2], weight.shape[3])


def _dcn_calls_jax(jcfg):
    """(input map, Cin, Cout, op) of every DCN call of the JAX model, in
    call order, from a trace of its init with each op stood in by zeros
    of its output's shape."""
    calls = []

    def recording(op):
        def run(x, offset, mask, weight, *a, **k):
            calls.append((tuple(x.shape[1:3]), *weight.shape[2:], op))
            return jnp.zeros(_out_shape(x, weight), x.dtype)
        return run

    jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                           jcfg)
    x = jnp.zeros((1, 64, 96, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdcn, "deform_conv2d", recording("gather"))
        mp.setattr(jdcn, "deform_conv2d_local", recording("local"))
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, x,
                                           x[..., :1]))
    return calls


def _dcn_calls_port(cfg):
    """The same of the port's model, its layers' ops stood in the same
    way (kernel and plain version alike)."""
    calls = []

    def recording(op):
        def run(x, offset, mask, weight, *a):
            calls.append((tuple(x.shape[1:3]), *weight.shape[2:], op))
            return x.new_zeros(_out_shape(x, weight))
        return run

    model = create_model(cfg, "cpu")
    x = torch.zeros(1, 64, 96, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DCNLayer, "OPS", {op: (recording(op),) * 2
                                     for op in ("local", "gather")})
        with torch.no_grad():
            model(x, x, x[..., :1])
    return calls


@pytest.mark.parametrize("node, mix_stride", [
    ("dcn", None), ("dcn_mix", None), ("dcn_mix", "16"), ("dcn_mix", "4")])
def test_nodes_choose_exact_or_clamped_as_jax(monkeypatch, node, mix_stride):
    """Every DCN layer of the network, in call order, takes the op JAX's
    takes: "dcn" exact everywhere; "dcn_mix" clamped on maps of stride <=
    CT_MIX_STRIDE (default 8: 11 clamped, 5 exact) and exact above."""
    if mix_stride is None:
        monkeypatch.delenv("CT_MIX_STRIDE", raising=False)
    else:
        monkeypatch.setenv("CT_MIX_STRIDE", mix_stride)
    kw = dict(task="tracking", pre_hm=True, dla_node=node, head_conv=32)
    cfg = set_heads(parse_task(Config(**kw)), SmallMeta)
    jcfg = jset_heads(jparse_task(JConfig(**kw)), SmallMeta)
    port, ref = _dcn_calls_port(cfg), _dcn_calls_jax(jcfg)
    assert len(port) == 16 and port == ref
    exact = sum(c[-1] == "gather" for c in port)
    assert exact == {("dcn", None): 16, ("dcn_mix", None): 5,
                     ("dcn_mix", "16"): 1, ("dcn_mix", "4"): 11}[
        node, mix_stride]


def test_gcn_still_raises():
    cfg = set_heads(parse_task(Config(task="tracking", pre_hm=True,
                                      dla_node="gcn")), SmallMeta)
    with pytest.raises(NotImplementedError, match="gcn"):
        create_model(cfg, "cpu")


# --- the network and the detector on the exact-trained checkpoint ------------

class TrainMeta:
    """The committed checkpoints' training size."""
    num_categories = 1
    default_resolution = [96, 160]
    num_joints = 17
    rest_focal_length = 1200
    flip_idx = []
    mean = MOT_META.mean
    std = MOT_META.std


@pytest.fixture(scope="module")
def ckpt():
    return load_jax_ckpt(CKPT)


def _net_cfgs(**kw):
    args = dict(task="tracking", pre_hm=True, track_thresh=0.3,
                new_thresh=0.3, max_age=3, **kw)
    return (set_heads(parse_task(Config(**args)), TrainMeta),
            jset_heads(jparse_task(JConfig(**args)), TrainMeta))


@pytest.fixture(scope="module")
def forward_outputs(ckpt):
    """Both packages' DLA-34 forward at 64x96 on the committed
    exact-trained weights and the same seeded inputs, at "dcn" and
    "dcn_mix" (CT_MIX_STRIDE unset), float32 and bf16. JAX's "dcn_mix"
    network runs op by op: jit compiles its clamped op's schedules for
    about 20 s a dtype on the CPU."""
    os.environ.pop("CT_MIX_STRIDE", None)
    params, batch_stats = ckpt
    rng = np.random.RandomState(7)
    ins = (rng.randn(1, 64, 96, 3).astype(np.float32),
           rng.randn(1, 64, 96, 3).astype(np.float32),
           rng.rand(1, 64, 96, 1).astype(np.float32))
    outs = {}
    for node in ("dcn", "dcn_mix"):
        for dtype in ("float32", "bfloat16"):
            cfg, jcfg = _net_cfgs(dla_node=node, compute_dtype=dtype)
            jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict,
                                   jcfg.head_convs_dict, jcfg)
            apply = lambda v, a, b, c: jmodel.apply(  # noqa: E731
                v, a, b, c, train=False)
            if node == "dcn":
                apply = jax.jit(apply)
            jout = apply({"params": params, "batch_stats": batch_stats},
                         *ins)[-1]
            model = create_model(cfg, "cpu")
            model.load_state_dict(params_from_jax(params, batch_stats),
                                  strict=True)
            with torch.no_grad():
                out = model(*map(torch.from_numpy, ins))[-1]
            outs[node, dtype] = (
                {k: np.asarray(v, np.float32) for k, v in jout.items()},
                {k: v.contiguous().numpy() for k, v in out.items()})
    return outs


@pytest.mark.parametrize("node", ["dcn", "dcn_mix"])
def test_network_matches_jax_float32(forward_outputs, node):
    """Each head map within 1e-4 absolute of JAX's, as the dcn_local1
    forward is held (tests/test_torch_port_model.py)."""
    jout, out = forward_outputs[node, "float32"]
    for head in ("hm", "reg", "tracking", "wh"):
        assert out[head].shape == jout[head].shape
        np.testing.assert_allclose(out[head], jout[head], atol=1e-4, rtol=0,
                                   err_msg=head)


@pytest.mark.parametrize("node", ["dcn", "dcn_mix"])
def test_network_matches_jax_bf16(forward_outputs, node):
    """bf16 networks, head by head, as tests/test_torch_port_bf16.py holds
    the dcn_local1 one: max |diff| <= 4e-2 of max|JAX map| and <= 3x the
    distance of JAX's bf16 map from its float32 one."""
    jout, out = forward_outputs[node, "bfloat16"]
    j32, _ = forward_outputs[node, "float32"]
    for head in ("hm", "reg", "tracking", "wh"):
        diff = np.abs(out[head] - jout[head]).max()
        own = np.abs(jout[head] - j32[head]).max()
        assert diff <= 4e-2 * np.abs(jout[head]).max(), head
        assert own > 0 and diff <= 3 * own, head


def test_fused_detector_at_dcn_matches_jax(ckpt):
    """FusedDetector at dla_node="dcn" over three bench-generator frames
    at 320x192 (the checkpoint's training scale after the warp), as
    tests/test_torch_port_engine.py holds the dcn_local1 one: rows above
    out_thresh in order, scores within 1e-4, boxes and centres within
    1e-2 px, track ids a bijection."""
    cfg, jcfg = _net_cfgs(dla_node="dcn")
    det = FusedDetector(cfg, *ckpt, TrainMeta, device="cpu")
    jdet = JFusedDetector(jcfg, params=ckpt[0], batch_stats=ckpt[1],
                          dataset_meta=TrainMeta)
    frames = bench.synth_frames(3, height=192, width=320, n_obj=6, seed=0)
    id_map, n_rows = {}, 0
    for f, frame in enumerate(frames):
        got = FusedDetector.fetch(det.run(frame), cfg.out_thresh)
        ref = JFusedDetector.fetch(jdet.run(frame), cfg.out_thresh)
        assert len(got) == len(ref), f"frame {f}"
        for a, b in zip(got, ref):
            assert abs(a["score"] - b["score"]) <= 1e-4
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-2,
                                       rtol=0)
            np.testing.assert_allclose(a["ct"], b["ct"], atol=1e-2, rtol=0)
            assert a["class"] == b["class"]
            assert id_map.setdefault(a["tracking_id"],
                                     b["tracking_id"]) == b["tracking_id"]
            n_rows += 1
    assert len(set(id_map.values())) == len(id_map)
    assert n_rows >= 6 and len(id_map) >= 2
