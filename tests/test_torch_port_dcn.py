"""The port's clamped DCN (centertrack_tpu_torch.ops.dcn) against the
JAX package: its plain PyTorch version against every JAX schedule of
ops/dcn.deform_conv2d_local and against the four Pallas kernels run in
interpret mode, the wrapper's input checks, and the nvcc build helper.
The CUDA kernel itself runs only on the card (chip_smoke.py holds it
against the plain version there)."""

import os

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
