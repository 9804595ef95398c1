"""The port's clamped DCN (centertrack_tpu_torch.ops.dcn) against the
JAX package: its plain PyTorch version against every JAX schedule of
ops/dcn.deform_conv2d_local and against the four Pallas kernels run in
interpret mode, forward and backward (jax.vjp, and the custom_vjp of
K3/K4), the derivative rules at the kinks, the wiring of the kernels'
autograd function, the wrapper's input checks, and the nvcc build
helper. The CUDA kernels themselves run only on the card (chip_smoke.py
holds them against the plain version there)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu.ops.dcn_pallas import deform_conv2d_pallas
from centertrack_tpu.ops.dcn_pallas_grid import deform_conv2d_pallas_grid
from centertrack_tpu.ops.dcn_pallas_halo import deform_conv2d_local_halo
from centertrack_tpu.ops.dcn_pallas_shift import deform_conv2d_local_pallas
from centertrack_tpu_torch.ops import _build, dcn

torch.set_num_threads(2)

ATOL = 1e-5  # fp32; the two frameworks only sum in another order


def _inputs(seed, b, h, w, cin, cout, r, with_bias=True):
    """Offsets spread to +/-(R + 1.5), past the clamp."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offset = rng.uniform(-(r + 1.5), r + 1.5,
                         (b, h, w, 18)).astype(np.float32)
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32) if with_bias else None
    return x, offset, mask, weight, bias


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


SHAPES = [(1, 13, 16, 4, 8), (2, 16, 24, 8, 16), (1, 9, 11, 16, 4)]


@pytest.mark.parametrize("impl", ["taploop", "premul", "fused",
                                  "shiftfirst"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_local(shape, r, impl, monkeypatch):
    monkeypatch.setenv("CT_LOCAL_IMPL", impl)
    args = _inputs(0, *shape, r)
    ref = np.asarray(jdcn.deform_conv2d_local(*args, max_offset=r))
    out = dcn.deform_conv2d_local_plain(*_torch(*args), max_offset=r)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


PALLAS = {
    "K1_dcn_pallas": lambda x, o, m, w, b, r: deform_conv2d_pallas(
        x, o, m, w, b, max_offset=r, row_tile=8, interpret=True),
    "K2_dcn_pallas_grid": lambda x, o, m, w, b, r: deform_conv2d_pallas_grid(
        x, o, m, w, b, max_offset=r, row_tile=8, interpret=True),
    "K3_dcn_pallas_shift": lambda x, o, m, w, b, r:
        deform_conv2d_local_pallas(x, o, m, w, b, r, 8, 8, True),
    "K4_dcn_pallas_halo": lambda x, o, m, w, b, r: deform_conv2d_local_halo(
        x, o, m, w, b, r, None, None, True),
}


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("kernel", sorted(PALLAS))
def test_plain_matches_pallas_interpret(kernel, r):
    """H = 13 is not a multiple of the kernels' row tile of 8."""
    args = _inputs(1, 1, 13, 16, 4, 8, r)
    ref = np.asarray(PALLAS[kernel](*args, r))
    out = dcn.deform_conv2d_local_plain(*_torch(*args), max_offset=r)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_bias", [True, False])
def test_wrapper_on_cpu_runs_plain_and_launches_nothing(with_bias):
    args = _torch(*_inputs(2, 1, 12, 10, 8, 8, 1, with_bias))
    before = dcn.LAUNCHES
    out = dcn.deform_conv2d_local(*args, max_offset=1)
    ref = dcn.deform_conv2d_local_plain(*args, max_offset=1)
    assert dcn.LAUNCHES == before
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_zero_offset_full_mask_is_a_plain_conv():
    x, _, _, weight, bias = _inputs(3, 1, 10, 12, 6, 5, 1)
    xt, wt, bt = _torch(x, weight, bias)
    out = dcn.deform_conv2d_local(xt, torch.zeros(1, 10, 12, 18),
                                  torch.ones(1, 10, 12, 9), wt, bt, 1)
    ref = torch.nn.functional.conv2d(
        xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), bt, padding=1)
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 1), atol=1e-5,
                               rtol=0)


def _bad_cases():
    good = _torch(*_inputs(4, 1, 6, 7, 4, 8, 1))
    x, o, m, w, b = good

    def case(**kw):
        d = dict(x=x, offset=o, mask=m, weight=w, bias=b, max_offset=1)
        d.update(kw)
        return d
    return {
        "x_float64": (case(x=x.double()), TypeError),
        "weight_half": (case(weight=w.half()), TypeError),
        "x_not_contiguous": (case(x=x.transpose(1, 2).contiguous()
                                  .transpose(1, 2)), ValueError),
        "offset_not_contiguous": (case(offset=o.permute(0, 2, 1, 3)
                                       .contiguous().permute(0, 2, 1, 3)),
                                  ValueError),
        "x_3d": (case(x=x[0]), ValueError),
        "offset_27_channels": (case(offset=torch.zeros(1, 6, 7, 27)),
                               ValueError),
        "mask_wrong_hw": (case(mask=torch.zeros(1, 7, 6, 9)), ValueError),
        "weight_5x5": (case(weight=torch.zeros(5, 5, 4, 8)), ValueError),
        "weight_wrong_cin": (case(weight=torch.zeros(3, 3, 5, 8)),
                             ValueError),
        "bias_wrong_len": (case(bias=torch.zeros(7)), ValueError),
        "mixed_devices": (case(mask=m.to("meta")), ValueError),
        "meta_device": (dict(x=x.to("meta"), offset=o.to("meta"),
                             mask=m.to("meta"), weight=w.to("meta"),
                             bias=b.to("meta"), max_offset=1), ValueError),
        "max_offset_0": (case(max_offset=0), ValueError),
        "max_offset_float": (case(max_offset=1.5), ValueError),
    }


@pytest.mark.parametrize("name", sorted(_bad_cases()))
def test_wrapper_rejects_before_any_launch(name):
    kwargs, exc = _bad_cases()[name]
    before = dcn.LAUNCHES
    with pytest.raises(exc):
        dcn.deform_conv2d_local(**kwargs)
    assert dcn.LAUNCHES == before


def test_find_nvcc_raises_clearly_when_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    real_isfile = os.path.isfile
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: (
        False if p == "/usr/local/cuda/bin/nvcc" else real_isfile(p)))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_compiles_once_into_a_hashed_library(tmp_path, monkeypatch):
    """The build runs nvcc for sm_90a under a timeout into a temporary
    name, moves it into place, and a second call finds it cached."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(_build, "build_info", {})
    calls = []

    def fake_run(cmd, capture_output, text, timeout):
        calls.append((cmd, timeout))
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF")

        class Done:
            returncode, stdout, stderr = 0, "", "ptxas info"
        return Done()

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    path = _build.build("dcn_local")
    assert path == _build.library_path("dcn_local")
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("dcn_local-")
    assert os.path.exists(path) and not [
        p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    (cmd, timeout), = calls
    assert cmd[0] == "/fake/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith(os.path.join("csrc", "dcn_local.cu"))
    assert timeout == _build.BUILD_TIMEOUT_S
    assert _build.build("dcn_local") == path
    assert len(calls) == 1


def test_build_failure_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/fake/nvcc")

    def fake_run(cmd, capture_output, text, timeout):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"partial")

        class Failed:
            returncode, stdout, stderr = 2, "", "error: expected ';'"
        return Failed()

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="expected ';'"):
        _build.build("dcn_local")
    assert os.listdir(tmp_path) == []


# --- backward: the plain version's autograd against jax.vjp ------------

GRAD_RTOL = 1e-5   # of max|JAX grad|; fp32, the sums run in another order


def _grad_inputs(case, seed=5, shape=(2, 9, 11, 8, 6), r=1):
    """Offsets: 'random' (spread past the clamp), 'zero' (every hat at
    its kink: the start of training) or 'integer' in {-2..2} (hat ties
    and, at R=1, clip ties at +/-1 and beyond)."""
    b, h, w, cin, cout = shape
    x, offset, mask, weight, bias = _inputs(seed, b, h, w, cin, cout, r)
    rng = np.random.RandomState(seed + 100)
    if case == "zero":
        offset = np.zeros_like(offset)
    elif case == "integer":
        offset = rng.randint(-2, 3, offset.shape).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    return (x, offset, mask, weight, bias), g


def _torch_grads(fn, args, g, r):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    fn(*ts, max_offset=r).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in ts]


def _assert_grads(got, ref):
    for name, a, b in zip(("x", "offset", "mask", "weight", "bias"), got,
                          ref):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_RTOL * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["random", "zero", "integer"])
def test_plain_backward_matches_jax_vjp(case):
    """Fails with torch's own derivative at the kinks (abs'(0) = 0,
    clamp' = 1 at the bound): the zero and integer cases."""
    args, g = _grad_inputs(case)
    _, vjp = jax.vjp(lambda *a: jdcn.deform_conv2d_local(
        *a, max_offset=1, train=True), *args)
    ref = [np.asarray(v) for v in vjp(g)]
    _assert_grads(_torch_grads(dcn.deform_conv2d_local, args, g, 1), ref)


@pytest.mark.parametrize("case", ["random", "zero", "integer"])
@pytest.mark.parametrize("kernel", ["K3_dcn_pallas_shift",
                                    "K4_dcn_pallas_halo"])
def test_plain_backward_matches_pallas_custom_vjp(kernel, case):
    """The backward the TPU kernels define (their custom_vjp), run in
    interpret mode; H = 9 is not a multiple of the row tile."""
    args, g = _grad_inputs(case, shape=(1, 9, 16, 4, 8))
    _, vjp = jax.vjp(lambda *a: PALLAS[kernel](*a, 1), *args)
    ref = [np.asarray(v) for v in vjp(g)]
    _assert_grads(_torch_grads(dcn.deform_conv2d_local, args, g, 1), ref)


def test_zero_offset_gradient_is_jax_central_difference():
    """At dy = 0 JAX's offset gradient is the central difference of the
    map minus the tap's own sample, (x[y+1] - x[y-1]) / 2 - x[y], as the
    hat rule hat'(-1, 0, +1) = (+1/2, -1, -1/2) gives (one channel, unit
    mask and weight, centre tap only)."""
    x = np.arange(5 * 7, dtype=np.float32).reshape(1, 5, 7, 1) ** 1.5
    weight = np.zeros((3, 3, 1, 1), np.float32)
    weight[1, 1] = 1.0
    ts = [torch.from_numpy(a).requires_grad_() for a in (
        x, np.zeros((1, 5, 7, 18), np.float32),
        np.ones((1, 5, 7, 9), np.float32), weight)]
    dcn.deform_conv2d_local(*ts, max_offset=1).sum().backward()
    gdy = ts[1].grad.numpy()[0, 2, 3, 8]   # centre tap (t = 4), dy
    col = x[0, :, 3, 0]
    np.testing.assert_allclose(gdy, 0.5 * (col[3] - col[1]) - col[2],
                               rtol=1e-6)


@pytest.mark.parametrize("u", [-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5])
def test_hat_derivative_is_jaxs(u):
    hat = lambda v: jnp.maximum(0.0, 1.0 - jnp.abs(v))   # noqa: E731
    t = torch.tensor(u, requires_grad=True)
    dcn._Hat.apply(t).backward()
    assert t.grad.item() == float(jax.grad(hat)(jnp.float32(u)))


@pytest.mark.parametrize("d", [-2.0, -1.0, -0.5, 0.0, 1.0, 2.0])
def test_clip_derivative_is_jaxs(d):
    t = torch.tensor(d, requires_grad=True)
    dcn._Clip.apply(t, 1).backward()
    assert t.grad.item() == float(
        jax.grad(lambda v: jnp.clip(v, -1, 1))(jnp.float32(d)))


# --- the CUDA route is an autograd function (no card needed) -----------

def test_cuda_route_is_the_kernels_autograd_function():
    """On a CUDA tensor the wrapper calls DCNLocal.apply, whose output
    carries a grad_fn; a ctypes launch into torch.empty would not."""
    assert dcn.route(torch.device("cpu")) is dcn.deform_conv2d_local_plain
    fn = dcn.route(torch.device("cuda"))
    assert fn.__self__ is dcn.DCNLocal
    assert issubclass(dcn.DCNLocal, torch.autograd.Function)


def test_autograd_function_wires_the_backward_kernels(monkeypatch):
    """DCNLocal with its three launchers replaced by CPU stand-ins built
    from the plain version: the gradients reach x, offset, mask, weight
    and bias through the function, each launcher runs once, and
    nothing is launched for an input that needs no gradient."""
    args, g = _grad_inputs("random", shape=(1, 6, 7, 4, 5))
    calls = []

    def plain_vjp(x, offset, mask, weight, grad_out, r):
        ts = [t.detach().requires_grad_() for t in (x, offset, mask,
                                                    weight)]
        with torch.enable_grad():   # backward runs with grad mode off
            out = dcn.deform_conv2d_local_plain(*ts, None, r)
        return torch.autograd.grad(out, ts, grad_out)

    def fwd(x, offset, mask, weight, bias, r):
        calls.append("fwd")
        return dcn.deform_conv2d_local_plain(x, offset, mask, weight, bias,
                                             r)

    def bwd_data(x, offset, mask, weight, grad_out, r):
        calls.append("data")
        dcn._check_grad(grad_out, x, weight.shape[3])
        return plain_vjp(x, offset, mask, weight, grad_out, r)[:3]

    def bwd_weight(x, offset, mask, grad_out, cout, r):
        calls.append("weight")
        w = torch.zeros(3, 3, x.shape[3], cout)
        return plain_vjp(x, offset, mask, w, grad_out, r)[3]

    monkeypatch.setattr(dcn, "launch_fwd", fwd)
    monkeypatch.setattr(dcn, "launch_bwd_data", bwd_data)
    monkeypatch.setattr(dcn, "launch_bwd_weight", bwd_weight)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = dcn.DCNLocal.apply(*ts, 1)
    assert type(out.grad_fn).__name__ == "DCNLocalBackward"
    # a permuted (non-contiguous) upstream grad is made contiguous
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1)
    out.backward(gt)
    assert calls == ["fwd", "data", "weight"]
    ref = _torch_grads(dcn.deform_conv2d_local_plain, args, g, 1)
    _assert_grads([t.grad.numpy() for t in ts], ref)

    calls.clear()
    ts = [torch.from_numpy(a) for a in args]
    ts[3].requires_grad_()
    dcn.DCNLocal.apply(*ts, 1).sum().backward()
    assert calls == ["fwd", "weight"]


def test_backward_kernels_refuse_a_bad_grad():
    x, o, m, w, _ = _torch(*_inputs(6, 1, 5, 6, 4, 3, 1))
    good = torch.zeros(1, 5, 6, 3)
    for bad, exc in [(good.double(), TypeError),
                     (torch.zeros(1, 5, 6, 4), ValueError),
                     (good.permute(0, 2, 1, 3), ValueError)]:
        with pytest.raises(exc):
            dcn._check_grad(bad, x, 3)
    dcn._check_grad(good, x, 3)


@pytest.mark.parametrize("npix, cin, cout, want", [
    (8 * 136 * 240, 64, 64, 59),    # s4 at B=8: 9 tiles -> fill the card
    (8 * 17 * 30, 512, 256, 2),     # s32 at B=8: 288 tiles
    (300, 64, 64, 2),               # at least 256 pixels per split
    (100, 512, 512, 1),
])
def test_weight_grad_splits(npix, cin, cout, want):
    assert dcn.weight_splits(npix, cin, cout) == want
