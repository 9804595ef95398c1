"""Clamped-offset modulated 3x3 deformable convolution (``dcn_local``),
forward and backward.

One function, in the JAX package's layout (ops/dcn.py:382,
``deform_conv2d_local``): x (B, H, W, Cin), offset (B, H, W, 18)
interleaved (dy, dx) per tap with taps row-major, mask (B, H, W, 9)
already sigmoided, weight (3, 3, Cin, Cout), bias (Cout,). Stride 1,
dilation 1; offsets are clipped to +/-max_offset and sampled with
exact bilinear interpolation, zeros outside the map.

``deform_conv2d_local`` is the wrapper of the hand-written Hopper
kernels: a CUDA tensor always goes to ``DCNLocal``, a
``torch.autograd.Function`` whose forward launches ``dcn_local_fwd``
(``csrc/dcn_local.cu``) and whose backward launches
``dcn_local_bwd_data`` (grad x, offset, mask) and ``dcn_local_bwd_weight``
(grad weight) from ``csrc/dcn_local_bwd.cu``; the bias grad is a sum
over (B, H, W). A CPU tensor goes to ``deform_conv2d_local_plain``, the
plain PyTorch version that the tests hold against JAX and that the chip
smoke holds the kernels against; autograd differentiates it.

Derivative convention. The op is piecewise linear in the offsets, with
kinks at integer offsets (where training starts: the offset conv is
zero-initialised) and at the clamp. The JAX package's gradient is
``jax.vjp`` of its hat formulation (the ``custom_vjp`` of
ops/dcn_pallas_shift.py and ops/dcn_pallas_halo.py), so the port takes
JAX's rules at the kinks, in the plain version (through ``_Hat`` and
``_Clip``) and in the kernel alike:

  hat(u) = max(0, 1 - |u|):  hat'(u) = -1 for 0 <= u < 1 (abs'(0) = +1),
      +1 for -1 < u < 0, -1/2 at u = 1 and +1/2 at u = -1 (a tie in the
      max splits the gradient), 0 beyond;
  clip(d, -R, R):  clip'(d) = 1 inside, 1/2 at exactly +/-R, 0 outside.

At a zero offset that gives the central difference of the map minus
the tap's own sample, where torch's autograd of the same expression
(abs'(0) = 0, clamp' = 1 at the bound) would give twice the central
difference, and DCNv2's floor-based backward the forward difference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from centertrack_tpu_torch.ops import _build

# launches of each kernel in this process; read and reset by callers
LAUNCHES = 0             # dcn_local_fwd
BWD_DATA_LAUNCHES = 0    # dcn_local_bwd_data
BWD_WEIGHT_LAUNCHES = 0  # dcn_local_bwd_weight

# symbol -> (source in csrc/, pointer arguments, int arguments); every
# launcher ends with the stream
_SIGNATURES = {
    "dcn_local_fwd": ("dcn_local", 6, 6),
    "dcn_local_bwd_data": ("dcn_local_bwd", 8, 6),
    "dcn_local_bwd_weight": ("dcn_local_bwd", 6, 7),
}
_launchers = {}

# blocks the weight-grad kernel aims for: four per SM of an H100
TARGET_BLOCKS = 4 * 132


def _kernel(symbol: str):
    fn = _launchers.get(symbol)
    if fn is None:
        source, n_ptr, n_int = _SIGNATURES[symbol]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launchers[symbol] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ok(rc: int, symbol: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


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


def _check_grad(grad_out, x, cout):
    """The output gradient the backward kernels take: float32,
    contiguous (B, H, W, Cout) on x's device."""
    want = (*x.shape[:3], cout)
    if grad_out.device != x.device or grad_out.dtype != torch.float32:
        raise TypeError(f"dcn_local backward: grad is {grad_out.dtype} on "
                        f"{grad_out.device}, the kernels take float32 on "
                        f"{x.device}")
    if tuple(grad_out.shape) != want:
        raise ValueError(f"dcn_local backward: grad must be {want}, got "
                         f"{tuple(grad_out.shape)}")
    if not grad_out.is_contiguous():
        raise ValueError("dcn_local backward: grad is not contiguous")


def launch_fwd(x, offset, mask, weight, bias, max_offset):
    """``dcn_local_fwd`` on checked CUDA tensors -> (B, H, W, Cout)."""
    global LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    _ok(_kernel("dcn_local_fwd")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        b, h, w, cin, cout, max_offset, _stream(x)), "dcn_local_fwd")
    LAUNCHES += 1
    return out


def launch_bwd_data(x, offset, mask, weight, grad_out, max_offset):
    """``dcn_local_bwd_data`` -> (grad x, grad offset, grad mask)."""
    global BWD_DATA_LAUNCHES
    _check_grad(grad_out, x, weight.shape[3])
    b, h, w, cin = x.shape
    grad_x = torch.zeros_like(x)   # accumulated with atomics
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    _ok(_kernel("dcn_local_bwd_data")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        grad_out.data_ptr(), grad_x.data_ptr(), grad_offset.data_ptr(),
        grad_mask.data_ptr(), b, h, w, cin, weight.shape[3], max_offset,
        _stream(x)), "dcn_local_bwd_data")
    BWD_DATA_LAUNCHES += 1
    return grad_x, grad_offset, grad_mask


def weight_splits(npix: int, cin: int, cout: int) -> int:
    """Pixel splits of the weight-grad reduction: enough blocks to fill
    the card (``TARGET_BLOCKS``), at least 256 pixels per split."""
    tiles = -(-cin // 64) * -(-cout // 64) * 9
    return max(1, min(-(-TARGET_BLOCKS // tiles), -(-npix // 256)))


def launch_bwd_weight(x, offset, mask, grad_out, cout, max_offset):
    """``dcn_local_bwd_weight`` -> grad weight (3, 3, Cin, Cout)."""
    global BWD_WEIGHT_LAUNCHES
    _check_grad(grad_out, x, cout)
    b, h, w, cin = x.shape
    splits = weight_splits(b * h * w, cin, cout)
    grad_w = torch.empty((3, 3, cin, cout), device=x.device,
                         dtype=torch.float32)
    partial = (torch.empty((splits, 9, cin, cout), device=x.device,
                           dtype=torch.float32) if splits > 1 else None)
    _ok(_kernel("dcn_local_bwd_weight")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
        grad_out.data_ptr(), grad_w.data_ptr(),
        None if partial is None else partial.data_ptr(),
        b, h, w, cin, cout, max_offset, splits, _stream(x)),
        "dcn_local_bwd_weight")
    BWD_WEIGHT_LAUNCHES += 1
    return grad_w


class DCNLocal(torch.autograd.Function):
    """The kernels' route: forward ``dcn_local_fwd``, backward
    ``dcn_local_bwd_data`` + ``dcn_local_bwd_weight`` + a bias sum.
    Inputs are checked by ``deform_conv2d_local``."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_offset):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.max_offset = max_offset
        ctx.has_bias = bias is not None
        return launch_fwd(x, offset, mask, weight, bias, max_offset)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        r = ctx.max_offset
        g = grad_out.contiguous()
        need = ctx.needs_input_grad
        grad_x = grad_offset = grad_mask = grad_w = grad_b = None
        if need[0] or need[1] or need[2]:
            grad_x, grad_offset, grad_mask = launch_bwd_data(
                x, offset, mask, weight, g, r)
        if need[3]:
            grad_w = launch_bwd_weight(x, offset, mask, g, weight.shape[3],
                                       r)
        if ctx.has_bias and need[4]:
            grad_b = g.sum(dim=(0, 1, 2))
        return grad_x, grad_offset, grad_mask, grad_w, grad_b, None


def route(device: torch.device):
    """What ``deform_conv2d_local`` calls for tensors on ``device``: the
    plain version on the CPU, the kernels' autograd function on CUDA."""
    return deform_conv2d_local_plain if device.type == "cpu" else \
        DCNLocal.apply


def deform_conv2d_local(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        max_offset: int = 2) -> torch.Tensor:
    """Clamped DCN, differentiable: the kernels on a CUDA tensor, the
    plain PyTorch version on a CPU tensor."""
    _check(x, offset, mask, weight, bias, max_offset)
    return route(x.device)(x, offset, mask, weight, bias, max_offset)


class _Hat(torch.autograd.Function):
    """hat(u) = max(0, 1 - |u|) with JAX's derivative at the kinks
    (module docstring)."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return (1.0 - u.abs()).clamp(min=0.0)

    @staticmethod
    def backward(ctx, g):
        u, = ctx.saved_tensors
        a = u.abs()
        slope = torch.where(
            a < 1, torch.where(u >= 0, -1.0, 1.0),
            torch.where(a == 1, torch.where(u > 0, -0.5, 0.5), 0.0))
        return g * slope


class _Clip(torch.autograd.Function):
    """clip(d, -r, r) with JAX's derivative: 1/2 at exactly +/-r."""

    @staticmethod
    def forward(ctx, d, r):
        ctx.save_for_backward(d)
        ctx.r = r
        return d.clamp(-r, r)

    @staticmethod
    def backward(ctx, g):
        d, = ctx.saved_tensors
        a = d.abs()
        slope = torch.where(a < ctx.r, 1.0,
                            torch.where(a == ctx.r, 0.5, 0.0))
        return g * slope, None


def deform_conv2d_local_plain(x: torch.Tensor, offset: torch.Tensor,
                              mask: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor | None = None,
                              max_offset: int = 2) -> torch.Tensor:
    """The same function in plain PyTorch, as the JAX package writes it
    (ops/dcn.py:422-445): each tap's bilinear sample is a sum over the
    (2R+1)^2 integer shifts of its clamped support, weighted by
    separable hat functions max(0, 1 - |d|), then masked and contracted
    with the tap's (Cin, Cout) weight. Autograd through it is JAX's vjp
    (``_Hat``, ``_Clip``)."""
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
            dy = _Clip.apply(offset[..., 2 * t], r)
            dx = _Clip.apply(offset[..., 2 * t + 1], r)
            sampled = x.new_zeros((b, h, w, cin))
            for a in range(ty - r, ty + r + 1):
                wy = _Hat.apply(ty + dy - a)
                for bb in range(tx - r, tx + r + 1):
                    wx = _Hat.apply(tx + dx - bb)
                    shifted = xp[:, pad + a:pad + a + h,
                                 pad + bb:pad + bb + w, :]
                    sampled = sampled + shifted * (wy * wx)[..., None]
            sampled = sampled * mask[..., t:t + 1]
            out = out + sampled.reshape(-1, cin) @ weight[i, j]
    if bias is not None:
        out = out + bias
    return out.reshape(b, h, w, cout)
