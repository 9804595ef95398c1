"""The gather routes of the clamped DCN's forward and data-gradient
kernels (``dcn_local_fwd_gather[_bf16]``, ``dcn_local_bwd_data_gather
[_bf16]``), on the CPU: where their planners choose them over the window
designs, the arguments their launchers hand the C entry points
(ctypes calls stood in), and the function they compute at max offsets
the window designs do not take, the port's plain version and its
autograd against JAX ``deform_conv2d_local`` and ``jax.vjp``. The
kernels themselves run only on the card (chip_smoke.py's gather_routes
phase holds them against the plain version there)."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu_torch.ops import dcn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the seven DLA-34 neck shapes of the 544 x 960 path: (H, W, Cin, Cout)
NECK = [(136, 240, 64, 64), (68, 120, 128, 128), (68, 120, 128, 64),
        (34, 60, 256, 256), (34, 60, 256, 128), (34, 60, 256, 64),
        (17, 30, 512, 256)]
PLANS = {"fwd_fp32": dcn.fwd_fp32_plan, "fwd_bf16": dcn.fwd_bf16_plan,
         "data_fp32": dcn.bwd_data_fp32_plan,
         "data_bf16": dcn.bwd_data_bf16_plan}
# fp32; the two frameworks only sum in another order
ATOL = 1e-5
GRAD_RTOL = 1e-5   # of max|JAX grad|


# ---- the planners ---------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(PLANS))
def test_neck_shapes_keep_the_window_route(kind):
    """Every plan on the paths stays the window design's: the seven neck
    shapes at R=1 and R=2, at B=1 and the training batch of 8."""
    for b in (1, 8):
        for h, w, cin, cout in NECK:
            for r in (1, 2):
                plan = PLANS[kind](b, h, w, cin, cout, r)
                assert plan["route"] == "window", (b, h, w, cin, cout, r)
                assert plan["smem_bytes"] <= dcn.SMEM_LIMIT


@pytest.mark.parametrize("kind, shape, reason", [
    ("data_bf16", (1, 17, 30, 64, 64, 5), "max_offset 5 > 4"),
    ("fwd_fp32", (1, 17, 30, 64, 64, 9), "max_offset 9 > 8"),
    ("data_fp32", (1, 17, 30, 64, 64, 9), "max_offset 9 > 8"),
    ("data_fp32", (2, 17, 30, 64, 512, 1), "shared memory"),
    ("fwd_bf16", (1, 34, 60, 256, 256, 8), "shared memory"),
    ("data_bf16", (1, 34, 60, 256, 256, 4), "shared memory"),
])
def test_planners_choose_the_gather_route(kind, shape, reason):
    """Past a window's limits the planner returns the gather route, with
    its reason and its blocks (64 pixels by 64 output channels, or by
    one tap), instead of raising."""
    b, h, w, cin, cout, _ = shape
    plan = PLANS[kind](*shape)
    assert plan["route"] == "gather"
    assert plan["reason"].startswith(reason)
    cols = -(-cout // 64) if kind.startswith("fwd") else 9
    assert plan["blocks"] == -(-(b * h * w) // 64) * cols
    if kind == "data_bf16":
        assert plan["grad_acc"] == b * h * w * cin


@pytest.mark.parametrize("r", [3, 5, 9, 16, 40])
@pytest.mark.parametrize("cout", [37, 384, 512, 1024])
def test_no_planner_raises_for_max_offset_or_width(r, cout):
    """Any max offset and width have a plan in every planner."""
    for kind, plan in PLANS.items():
        assert plan(2, 17, 30, 69, cout, r)["route"] in ("window", "gather")


# ---- the launchers' ctypes arguments ---------------------------------------

def _extern_c_params(source, name):
    """The parameter list of csrc/<source>.cu's extern "C" ``name``."""
    with open(os.path.join(ROOT, "centertrack_tpu_torch", "csrc",
                           source + ".cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    return [p.strip() for p in m.group(1).split(",")]


GATHER = {   # symbol -> (launcher, dtype, counter)
    "dcn_local_fwd_gather": ("launch_fwd", torch.float32,
                             "FWD_GATHER_LAUNCHES"),
    "dcn_local_fwd_gather_bf16": ("launch_fwd_bf16", torch.bfloat16,
                                  "FWD_GATHER_BF16_LAUNCHES"),
    "dcn_local_bwd_data_gather": ("launch_bwd_data", torch.float32,
                                  "BWD_DATA_GATHER_LAUNCHES"),
    "dcn_local_bwd_data_gather_bf16": ("launch_bwd_data_bf16",
                                       torch.bfloat16,
                                       "BWD_DATA_GATHER_BF16_LAUNCHES"),
}
COUNTERS = [n for n in dir(dcn) if n.endswith("LAUNCHES")]


@pytest.mark.parametrize("symbol", sorted(GATHER))
def test_launchers_call_their_gather_symbol(symbol, monkeypatch):
    """At R=40 (past every window's limits) each dtype's forward and data
    launcher calls its gather symbol with the C entry point's pointers
    (bias null, the bf16 data kernel's float32 grad-x scratch), its ints
    (B, H, W, Cin, Cout, R) and the stream, allocates its outputs in
    x's dtype, and counts one launch of that kernel and of no other."""
    launcher, dtype, counter = GATHER[symbol]
    source, n_ptr, n_int = dcn._SIGNATURES[symbol]
    params = _extern_c_params(source, symbol)
    assert len(params) == n_ptr + n_int + 1
    assert all("*" in p for p in params[:n_ptr] + params[-1:])
    assert all(p.startswith("int ") for p in params[n_ptr:-1])
    calls = []
    monkeypatch.setattr(dcn, "_kernel", lambda name: (
        lambda *argv: calls.append((name, argv)) or 0))
    monkeypatch.setattr(dcn, "_stream", lambda t: 7)
    for name in COUNTERS:
        monkeypatch.setattr(dcn, name, 0)
    b, h, w, cin, cout, r = 2, 5, 6, 3, 4, 40
    x = torch.zeros(b, h, w, cin, dtype=dtype)
    offset = torch.zeros(b, h, w, 18, dtype=dtype)
    mask = torch.zeros(b, h, w, 9, dtype=dtype)
    weight = torch.zeros(3, 3, cin, cout, dtype=dtype)
    if launcher.startswith("launch_fwd"):
        out = getattr(dcn, launcher)(x, offset, mask, weight, None, r)
        assert out.shape == (b, h, w, cout) and out.dtype == dtype
    else:
        g = torch.zeros(b, h, w, cout, dtype=dtype)
        gx, go, gm = getattr(dcn, launcher)(x, offset, mask, weight, g, r)
        assert (gx.shape, go.shape, gm.shape) == (x.shape, offset.shape,
                                                  mask.shape)
        assert {t.dtype for t in (gx, go, gm)} == {dtype}
        if dtype == torch.float32:
            assert not gx.any()   # the kernel adds into it with atomics
    (name, argv), = calls
    assert name == symbol
    assert len(argv) == n_ptr + n_int + 1
    assert argv[n_ptr:n_ptr + n_int] == (b, h, w, cin, cout, r)
    assert argv[-1] == 7
    ptrs = argv[:n_ptr]
    assert ptrs[:4] == tuple(t.data_ptr() for t in (x, offset, mask,
                                                    weight))
    if launcher.startswith("launch_fwd"):
        assert ptrs[4] is None and ptrs[5] == out.data_ptr()
    else:
        assert ptrs[-3:] == tuple(t.data_ptr() for t in (gx, go, gm))
        assert all(ptrs)
    assert {n: getattr(dcn, n) for n in COUNTERS if getattr(dcn, n)} == {
        counter: 1}


# ---- the function past the windows' limits, against JAX ---------------------

def _inputs(r, seed=11):
    """B=1, 6 x 7, Cin 8, Cout 12; offsets spread past the clamp, a third
    of them integers in [-R - 1, R + 1] (hat kinks, and clip ties at
    +/-R)."""
    rng = np.random.RandomState(seed + r)
    b, h, w, cin, cout = 1, 6, 7, 8, 12
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offset = rng.uniform(-(r + 1.5), r + 1.5, (b, h, w, 18)).astype(
        np.float32)
    ints = rng.rand(*offset.shape) < 1 / 3
    offset[ints] = rng.randint(-r - 1, r + 2, ints.sum())
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    return (x, offset, mask, weight, bias), g


@pytest.fixture(scope="module", params=[5, 9])
def jax_ref(request):
    """JAX's forward and vjp at max offset R (one eager jax.vjp each: the
    JAX op sums 9 (2R + 1)^2 shifted terms)."""
    r = request.param
    args, g = _inputs(r)
    out, vjp = jax.vjp(lambda *a: jdcn.deform_conv2d_local(
        *a, max_offset=r, train=True), *args)
    return r, args, g, np.asarray(out), [np.asarray(v) for v in vjp(g)]


@pytest.fixture(scope="module")
def port_run(jax_ref):
    """The port's plain version and its autograd on the same inputs."""
    r, args, g, _, _ = jax_ref
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = dcn.deform_conv2d_local_plain(*ts, max_offset=r)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def test_plain_forward_matches_jax_past_the_windows(jax_ref, port_run):
    """Within ATOL (fp32, another summation order). The bf16 data
    kernel takes its gather route at both max offsets, the float32
    kernels theirs at R=9."""
    r = jax_ref[0]
    routes = {k: p(1, 6, 7, 8, 12, r)["route"] for k, p in PLANS.items()}
    assert routes["data_bf16"] == "gather"
    assert (routes["fwd_fp32"] == routes["data_fp32"] == "gather") == (r > 8)
    np.testing.assert_allclose(port_run[0], jax_ref[3], atol=ATOL, rtol=0)


@pytest.mark.parametrize("i, name", enumerate(
    ["x", "offset", "mask", "weight", "bias"]))
def test_plain_gradients_match_jax_vjp_past_the_windows(jax_ref, port_run,
                                                        i, name):
    """Each gradient within GRAD_RTOL of JAX's largest (fp32), JAX's
    derivative rules at the kinks and at the clamp included."""
    ref = jax_ref[4][i]
    np.testing.assert_allclose(port_run[1][i], ref, rtol=0,
                               atol=GRAD_RTOL * np.abs(ref).max(),
                               err_msg=name)
