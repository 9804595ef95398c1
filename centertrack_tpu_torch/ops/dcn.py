"""Clamped-offset modulated 3x3 deformable convolution (``dcn_local``),
forward and backward.

One function, in the JAX package's layout (ops/dcn.py:382,
``deform_conv2d_local``): x (B, H, W, Cin), offset (B, H, W, 18)
interleaved (dy, dx) per tap with taps row-major, mask (B, H, W, 9)
already sigmoided, weight (3, 3, Cin, Cout), bias (Cout,). Stride 1,
dilation 1; offsets are clipped to +/-max_offset and sampled with
exact bilinear interpolation, zeros outside the map.

``deform_conv2d_local`` is the wrapper of the hand-written Hopper
kernels: a float32 CUDA tensor goes to ``DCNLocal``, a
``torch.autograd.Function`` whose forward launches ``dcn_local_fwd``
(``csrc/dcn_local.cu``) and whose backward launches
``dcn_local_bwd_data`` (grad x, offset, mask) and ``dcn_local_bwd_weight``
(grad weight) from ``csrc/dcn_local_bwd.cu``; the bias grad is a sum
over (B, H, W). A CPU tensor goes to ``deform_conv2d_local_plain``, the
plain PyTorch version that the tests hold against JAX and that the chip
smoke holds the kernels against; autograd differentiates it.

bfloat16. The five tensors are all float32 or all bfloat16. A bf16
CUDA call runs the bf16 kernels and is never upcast to the float32
ones: without a gradient it is ``dcn_local_fwd_bf16``
(``csrc/dcn_local_bf16.cu``); with one it is ``DCNLocal`` at bf16,
whose forward launches ``dcn_local_fwd_bf16`` and whose backward
launches ``dcn_local_bwd_data_bf16`` and ``dcn_local_bwd_weight_bf16``
(``csrc/dcn_local_bwd_bf16.cu``); ``fwd_bf16_plan`` and
``bwd_data_bf16_plan`` give the first two their launch plans (pixel
tile, K splits, shared memory, scratch). At bf16 the forward rounds
where the Pallas kernels do (ops/dcn_pallas_shift.py:45-76): the sample
is taken in float32 from the bf16 inputs, masked, rounded to bf16,
contracted with the bf16 weight with float32 accumulation, the bias
added in float32, and the sum rounded to bf16. The backward is the
float32 vjp of that function on the bf16 values, with its two roundings
passed through as a cast's transpose passes a cotangent, and each
gradient rounded to bf16 once; the weight gradient contracts the bf16
sample the forward contracted.

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
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from centertrack_tpu_torch.ops import _build

# launches of each kernel in this process; read and reset by callers
LAUNCHES = 0             # dcn_local_fwd
BF16_LAUNCHES = 0        # dcn_local_fwd_bf16
BWD_DATA_LAUNCHES = 0    # dcn_local_bwd_data
BWD_WEIGHT_LAUNCHES = 0  # dcn_local_bwd_weight
BWD_DATA_BF16_LAUNCHES = 0    # dcn_local_bwd_data_bf16
BWD_WEIGHT_BF16_LAUNCHES = 0  # dcn_local_bwd_weight_bf16

# symbol -> (source in csrc/, pointer arguments, int arguments); every
# launcher ends with the stream
_SIGNATURES = {
    "dcn_local_fwd": ("dcn_local", 6, 6),
    "dcn_local_fwd_bf16": ("dcn_local_bf16", 7, 12),
    "dcn_local_bwd_data": ("dcn_local_bwd", 8, 6),
    "dcn_local_bwd_weight": ("dcn_local_bwd", 6, 7),
    "dcn_local_bwd_data_bf16": ("dcn_local_bwd_bf16", 10, 11),
    "dcn_local_bwd_weight_bf16": ("dcn_local_bwd_bf16", 6, 7),
}
_launchers = {}

# blocks the weight-grad kernel aims for: four per SM of an H100
TARGET_BLOCKS = 4 * 132

# The bf16 forward and data-gradient kernels (csrc/dcn_local_bf16.cu,
# csrc/dcn_local_bwd_bf16.cu): a block takes a 4 x 16 tile of output
# pixels (one wgmma M tile of 64) and walks K in steps of (a chunk of 64
# input channels, a tap); each checks the plan it is given.
BF16_TILE = (4, 16)
BF16_CHUNK = 64
# dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
# the largest max_offset the data kernel's support walk is unrolled for
BF16_DATA_MAX_OFFSET = 4


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
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dcn_local: {name} is {t.dtype}, the kernels "
                            f"take float32 or bfloat16")
        if t.dtype != x.dtype:
            raise TypeError(f"dcn_local: {name} is {t.dtype}, x is "
                            f"{x.dtype}: the five tensors share one dtype")
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
    """The output gradient the backward kernels take: x's dtype,
    contiguous (B, H, W, Cout) on x's device."""
    want = (*x.shape[:3], cout)
    if grad_out.device != x.device or grad_out.dtype != x.dtype:
        raise TypeError(f"dcn_local backward: grad is {grad_out.dtype} on "
                        f"{grad_out.device}, the kernels take {x.dtype} on "
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


def _k_splits(blocks: int, steps: int) -> int:
    """K splits of a bf16 kernel launch: none when its pixel tiles give
    ``TARGET_BLOCKS // 2`` blocks (two per SM), else enough to reach
    that, at most one split per K step."""
    want = TARGET_BLOCKS // 2
    return 1 if blocks >= want else min(steps, -(-want // blocks))


def _k_ranges(steps: int, splits: int) -> tuple:
    """The K steps [begin, end) of each split, as the kernels cut them:
    split z takes z * steps // splits up to (z + 1) * steps // splits."""
    return tuple((z * steps // splits, (z + 1) * steps // splits)
                 for z in range(splits))


def _bf16_tiles(b: int, h: int, w: int) -> int:
    th, tw = BF16_TILE
    return b * -(-h // th) * -(-w // tw)


def _window_pixels(max_offset: int) -> int:
    """Pixels of a tile's x window: the tile and a halo of R + 1, every
    position a clamped offset's bilinear support reaches."""
    th, tw = BF16_TILE
    halo = max_offset + 1
    return (th + 2 * halo) * (tw + 2 * halo)


@functools.lru_cache(maxsize=256)
def fwd_bf16_plan(b: int, h: int, w: int, cin: int, cout: int,
                  max_offset: int) -> dict:
    """Launch plan of ``dcn_local_fwd_bf16``: output channels per block
    (``n_tile``: 64, 128 or 256, the wgmma N), the K splits, the blocks,
    the dynamic shared memory (A tile, two weight slots, one x window per
    Cin chunk up to two, the corner table) and the float32 scratch of the
    split partials. Raises ValueError when a block's shared memory would
    not fit. Cached per shape: callers read it and never change it."""
    th, tw = BF16_TILE
    ck = BF16_CHUNK
    n_tile = 64 if cout <= 64 else 128 if cout <= 128 else 256
    col_tiles = -(-cout // n_tile)
    tiles = _bf16_tiles(b, h, w)
    steps = 9 * max(1, -(-cin // ck))
    splits = _k_splits(tiles * col_tiles, steps)
    table = 9 * 4 * th * tw * (2 + 4) + 9 * th * tw * 4
    smem = (th * tw * ck * 2 + 2 * ck * n_tile * 2
            + min(2, steps // 9) * _window_pixels(max_offset) * ck * 2
            + table)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"dcn_local_fwd_bf16: a block would need {smem} bytes of shared "
            f"memory at max_offset={max_offset}, Cout={cout}; the limit is "
            f"{SMEM_LIMIT}")
    return {"tile": BF16_TILE, "chunk": ck, "n_tile": n_tile,
            "col_tiles": col_tiles, "tiles": tiles, "steps": steps,
            "splits": splits, "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * col_tiles * splits, "smem_bytes": smem,
            "scratch": splits * b * h * w * cout if splits > 1 else 0}


@functools.lru_cache(maxsize=256)
def bwd_data_bf16_plan(b: int, h: int, w: int, cin: int, cout: int,
                       max_offset: int) -> dict:
    """Launch plan of ``dcn_local_bwd_data_bf16``: the K splits, the
    blocks, the dynamic shared memory (the output-grad tile and two
    weight slots over Cout padded to 16, the x window and its float32
    grad-x tile, the tile's offsets and mask, the sums) and the float32
    scratch: the grad-x accumulator and, when split, the grad offset /
    mask partials. Raises ValueError when it would not fit, or when
    max_offset passes ``BF16_DATA_MAX_OFFSET``. Cached per shape:
    callers read it and never change it."""
    if max_offset > BF16_DATA_MAX_OFFSET:
        raise ValueError(
            f"dcn_local_bwd_data_bf16: max_offset={max_offset}; the kernel "
            f"takes max_offset up to {BF16_DATA_MAX_OFFSET}")
    th, tw = BF16_TILE
    ck = BF16_CHUNK
    kp = -(-cout // 16) * 16
    tiles = _bf16_tiles(b, h, w)
    steps = 9 * max(1, -(-cin // ck))
    splits = _k_splits(tiles, steps)
    smem = (th * tw * kp * 2 + 2 * ck * kp * 2
            + _window_pixels(max_offset) * (ck * (2 + 4) + 32 + 64)
            + th * tw * 27 * 4 + 3 * 9 * th * tw * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"dcn_local_bwd_data_bf16: a block would need {smem} bytes of "
            f"shared memory at max_offset={max_offset}, Cout={cout}; the "
            f"limit is {SMEM_LIMIT}")
    npix = b * h * w
    return {"tile": BF16_TILE, "chunk": ck, "tiles": tiles, "steps": steps,
            "splits": splits, "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * splits, "smem_bytes": smem,
            "grad_acc": npix * cin,
            "scratch": splits * npix * 27 if splits > 1 else 0}


def _plan_ints(plan: dict, *keys: str) -> tuple:
    return (*plan["tile"], plan["chunk"], *(plan[k] for k in keys),
            plan["smem_bytes"])


def launch_fwd_bf16(x, offset, mask, weight, bias, max_offset):
    """``dcn_local_fwd_bf16`` on checked bf16 CUDA tensors -> bf16
    (B, H, W, Cout), by ``fwd_bf16_plan``."""
    global BF16_LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    plan = fwd_bf16_plan(b, h, w, cin, cout, max_offset)
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    partial = (torch.empty(plan["scratch"], device=x.device,
                           dtype=torch.float32) if plan["scratch"] else None)
    _ok(_kernel("dcn_local_fwd_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        b, h, w, cin, cout, max_offset,
        *_plan_ints(plan, "n_tile", "splits"), _stream(x)),
        "dcn_local_fwd_bf16")
    BF16_LAUNCHES += 1
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


def launch_bwd_data_bf16(x, offset, mask, weight, grad_out, max_offset):
    """``dcn_local_bwd_data_bf16`` on bf16 CUDA tensors -> bf16 (grad x,
    grad offset, grad mask), by ``bwd_data_bf16_plan``. grad x is summed
    in a float32 scratch and rounded once."""
    global BWD_DATA_BF16_LAUNCHES
    _check_grad(grad_out, x, weight.shape[3])
    b, h, w, cin = x.shape
    plan = bwd_data_bf16_plan(b, h, w, cin, weight.shape[3], max_offset)
    grad_acc = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    partial = (torch.empty(plan["scratch"], device=x.device,
                           dtype=torch.float32) if plan["scratch"] else None)
    grad_x = torch.empty_like(x)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    _ok(_kernel("dcn_local_bwd_data_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        grad_out.data_ptr(), grad_acc.data_ptr(), grad_x.data_ptr(),
        grad_offset.data_ptr(), grad_mask.data_ptr(),
        None if partial is None else partial.data_ptr(), b, h, w, cin,
        weight.shape[3], max_offset, *_plan_ints(plan, "splits"),
        _stream(x)), "dcn_local_bwd_data_bf16")
    BWD_DATA_BF16_LAUNCHES += 1
    return grad_x, grad_offset, grad_mask


def launch_bwd_weight_bf16(x, offset, mask, grad_out, cout, max_offset):
    """``dcn_local_bwd_weight_bf16`` on bf16 CUDA tensors -> bf16 grad
    weight (3, 3, Cin, Cout), reduced over float32 partials."""
    global BWD_WEIGHT_BF16_LAUNCHES
    _check_grad(grad_out, x, cout)
    b, h, w, cin = x.shape
    splits = weight_splits(b * h * w, cin, cout)
    grad_w = torch.empty((3, 3, cin, cout), device=x.device, dtype=x.dtype)
    partial = torch.empty((splits, 9, cin, cout), device=x.device,
                          dtype=torch.float32)
    _ok(_kernel("dcn_local_bwd_weight_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
        grad_out.data_ptr(), grad_w.data_ptr(), partial.data_ptr(),
        b, h, w, cin, cout, max_offset, splits, _stream(x)),
        "dcn_local_bwd_weight_bf16")
    BWD_WEIGHT_BF16_LAUNCHES += 1
    return grad_w


class DCNLocal(torch.autograd.Function):
    """The kernels' route, by the inputs' dtype: at float32 forward
    ``dcn_local_fwd``, backward ``dcn_local_bwd_data`` +
    ``dcn_local_bwd_weight``; at bfloat16 forward ``dcn_local_fwd_bf16``,
    backward ``dcn_local_bwd_data_bf16`` + ``dcn_local_bwd_weight_bf16``;
    the bias grad is a float32 sum over (B, H, W) in the bias's dtype.
    Inputs are checked by ``deform_conv2d_local``."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, max_offset):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.max_offset = max_offset
        ctx.has_bias = bias is not None
        low = x.dtype == torch.bfloat16
        return (launch_fwd_bf16 if low else launch_fwd)(
            x, offset, mask, weight, bias, max_offset)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        r = ctx.max_offset
        g = grad_out.contiguous()
        need = ctx.needs_input_grad
        low = x.dtype == torch.bfloat16
        grad_x = grad_offset = grad_mask = grad_w = grad_b = None
        if need[0] or need[1] or need[2]:
            grad_x, grad_offset, grad_mask = (
                launch_bwd_data_bf16 if low else launch_bwd_data)(
                x, offset, mask, weight, g, r)
        if need[3]:
            grad_w = (launch_bwd_weight_bf16 if low else launch_bwd_weight)(
                x, offset, mask, g, weight.shape[3], r)
        if ctx.has_bias and need[4]:
            grad_b = g.float().sum(dim=(0, 1, 2)).to(g.dtype)
        return grad_x, grad_offset, grad_mask, grad_w, grad_b, None


def route(device: torch.device, dtype: torch.dtype = torch.float32,
          needs_grad: bool = False):
    """What ``deform_conv2d_local`` calls for tensors on ``device``: the
    plain version on the CPU; on CUDA the kernels' autograd function,
    except a bfloat16 call that needs no gradient, which launches
    ``dcn_local_fwd_bf16`` alone."""
    if device.type == "cpu":
        return deform_conv2d_local_plain
    if dtype == torch.bfloat16 and not needs_grad:
        return launch_fwd_bf16
    return DCNLocal.apply


def deform_conv2d_local(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        max_offset: int = 2) -> torch.Tensor:
    """Clamped DCN: the kernels on a CUDA tensor (differentiable at
    float32 and bfloat16), the plain PyTorch version on a CPU tensor."""
    _check(x, offset, mask, weight, bias, max_offset)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, offset, mask, weight, bias))
    return route(x.device, x.dtype, needs_grad)(x, offset, mask, weight,
                                                bias, max_offset)


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


class _RoundBF16(torch.autograd.Function):
    """Rounds float32 values to bf16 (kept in float32) and passes the
    gradient through unrounded, as the transpose of a cast passes a
    cotangent: the plain bf16 version's sample rounding, so that its
    autograd rounds each gradient once, at the bf16 inputs' casts, as
    the bf16 backward kernels do."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def deform_conv2d_local_plain(x: torch.Tensor, offset: torch.Tensor,
                              mask: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor | None = None,
                              max_offset: int = 2) -> torch.Tensor:
    """The same function in plain PyTorch, as the JAX package writes it
    (ops/dcn.py:422-445): each tap's bilinear sample is a sum over the
    (2R+1)^2 integer shifts of its clamped support, weighted by
    separable hat functions max(0, 1 - |d|), then masked and contracted
    with the tap's (Cin, Cout) weight. Autograd through it is JAX's vjp
    (``_Hat``, ``_Clip``).

    At bfloat16 it computes in float32 on the bf16 values and rounds
    where ``dcn_local_fwd_bf16`` and the Pallas kernels do: the masked
    sample to bf16 before the contraction (whose products of bf16
    values are exact in float32), the result to bf16 at the end. Its
    autograd is the bf16 backward kernels' function: the float32 vjp
    through ``_Hat`` and ``_Clip``, the sample's rounding passed through
    (``_RoundBF16``), the weight gradient contracting the rounded
    sample, and each gradient rounded to bf16 once, by the backward of
    the inputs' casts to float32."""
    low = x.dtype == torch.bfloat16
    if low:
        x, offset, mask, weight = (t.float() for t in (x, offset, mask,
                                                       weight))
        bias = None if bias is None else bias.float()
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
            if low:
                sampled = _RoundBF16.apply(sampled)
            out = out + sampled.reshape(-1, cin) @ weight[i, j]
    if bias is not None:
        out = out + bias
    out = out.reshape(b, h, w, cout)
    return out.to(torch.bfloat16) if low else out
