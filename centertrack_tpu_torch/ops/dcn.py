"""Clamped-offset modulated 3x3 deformable convolution (``dcn_local``).

One function, in the JAX package's layout (ops/dcn.py:382,
``deform_conv2d_local``): x (B, H, W, Cin), offset (B, H, W, 18)
interleaved (dy, dx) per tap with taps row-major, mask (B, H, W, 9)
already sigmoided, weight (3, 3, Cin, Cout), bias (Cout,). Stride 1,
dilation 1; offsets are clipped to +/-max_offset and sampled with
exact bilinear interpolation, zeros outside the map.

``deform_conv2d_local`` is the wrapper of the hand-written Hopper kernel
``csrc/dcn_local.cu`` (``dcn_local_fwd``): a CUDA tensor always goes to
the kernel, a CPU tensor to ``deform_conv2d_local_plain``, the plain
PyTorch version that the tests hold against JAX and that the chip smoke
holds the kernel against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from centertrack_tpu_torch.ops import _build

# launches of dcn_local_fwd in this process; read and reset by callers
LAUNCHES = 0

_launcher = None


def _kernel():
    global _launcher
    if _launcher is None:
        fn = _build.load("dcn_local").dcn_local_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(x, offset, mask, weight, bias, max_offset):
    """Raise on anything the kernel does not take, before any launch."""
    tensors = {"x": x, "offset": offset, "mask": mask, "weight": weight}
    if bias is not None:
        tensors["bias"] = bias
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dcn_local: unsupported device {x.device}")
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"dcn_local: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"dcn_local: {name} is {t.dtype}, the kernel "
                            f"takes float32")
        if not t.is_contiguous():
            raise ValueError(f"dcn_local: {name} is not contiguous")
    if x.dim() != 4:
        raise ValueError(f"dcn_local: x must be (B, H, W, Cin), got "
                         f"{tuple(x.shape)}")
    b, h, w, cin = x.shape
    if tuple(offset.shape) != (b, h, w, 18):
        raise ValueError(f"dcn_local: offset must be {(b, h, w, 18)}, got "
                         f"{tuple(offset.shape)}")
    if tuple(mask.shape) != (b, h, w, 9):
        raise ValueError(f"dcn_local: mask must be {(b, h, w, 9)}, got "
                         f"{tuple(mask.shape)}")
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, cin):
        raise ValueError(f"dcn_local: weight must be (3, 3, {cin}, Cout), "
                         f"got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[3],):
        raise ValueError(f"dcn_local: bias must be ({weight.shape[3]},), "
                         f"got {tuple(bias.shape)}")
    if not isinstance(max_offset, int) or max_offset < 1:
        raise ValueError(f"dcn_local: max_offset must be an int >= 1, got "
                         f"{max_offset!r}")


def deform_conv2d_local(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        max_offset: int = 2) -> torch.Tensor:
    """Clamped DCN forward: the ``dcn_local_fwd`` kernel on a CUDA
    tensor, the plain PyTorch version on a CPU tensor."""
    global LAUNCHES
    _check(x, offset, mask, weight, bias, max_offset)
    if x.device.type == "cpu":
        return deform_conv2d_local_plain(x, offset, mask, weight, bias,
                                         max_offset)
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    rc = _kernel()(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                   weight.data_ptr(),
                   None if bias is None else bias.data_ptr(),
                   out.data_ptr(), b, h, w, cin, cout, max_offset,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dcn_local_fwd launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def deform_conv2d_local_plain(x: torch.Tensor, offset: torch.Tensor,
                              mask: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor | None = None,
                              max_offset: int = 2) -> torch.Tensor:
    """The same function in plain PyTorch, as the JAX package writes it
    (ops/dcn.py:422-445): each tap's bilinear sample is a sum over the
    (2R+1)^2 integer shifts of its clamped support, weighted by
    separable hat functions max(0, 1 - |d|), then masked and contracted
    with the tap's (Cin, Cout) weight."""
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    r = max_offset
    pad = 1 + r
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    out = x.new_zeros((b * h * w, cout))
    for i in range(3):
        for j in range(3):
            t = 3 * i + j
            ty, tx = i - 1, j - 1
            dy = offset[..., 2 * t].clamp(-r, r)
            dx = offset[..., 2 * t + 1].clamp(-r, r)
            sampled = x.new_zeros((b, h, w, cin))
            for a in range(ty - r, ty + r + 1):
                wy = (1.0 - (ty + dy - a).abs()).clamp(min=0.0)
                for bb in range(tx - r, tx + r + 1):
                    wx = (1.0 - (tx + dx - bb).abs()).clamp(min=0.0)
                    shifted = xp[:, pad + a:pad + a + h,
                                 pad + bb:pad + bb + w, :]
                    sampled = sampled + shifted * (wy * wx)[..., None]
            sampled = sampled * mask[..., t:t + 1]
            out = out + sampled.reshape(-1, cin) @ weight[i, j]
    if bias is not None:
        out = out + bias
    return out.reshape(b, h, w, cout)
