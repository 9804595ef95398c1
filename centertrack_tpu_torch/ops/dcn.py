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
over (B, H, W). ``fwd_fp32_plan``, ``bwd_data_fp32_plan`` and
``bwd_weight_fp32_plan`` give the three their launch plans (pixel tile,
Cin chunk, N tile, taps, splits, shared memory, scratch); their
contractions run on the tensor cores in 3xTF32, which keeps float32's
accuracy. Where a window design does not take the call (a max_offset
past its support walk, or shared memory past 227 KB), each plan takes
its gather route instead: ``dcn_local_fwd_gather``,
``dcn_local_bwd_data_gather`` and ``dcn_local_bwd_weight_gather``, the
first designs, which read x from global memory per corner and take every
max_offset and width. A CPU tensor goes to
``deform_conv2d_local_plain``, the plain PyTorch version that the tests
hold against JAX and that the chip smoke holds the kernels against;
autograd differentiates it.

bfloat16. The five tensors are all float32 or all bfloat16. A bf16
CUDA call runs the bf16 kernels and is never upcast to the float32
ones: without a gradient it is ``dcn_local_fwd_bf16``
(``csrc/dcn_local_bf16.cu``); with one it is ``DCNLocal`` at bf16,
whose forward launches ``dcn_local_fwd_bf16`` and whose backward
launches ``dcn_local_bwd_data_bf16`` and ``dcn_local_bwd_weight_bf16``
(``csrc/dcn_local_bwd_bf16.cu``); ``fwd_bf16_plan``,
``bwd_data_bf16_plan`` and ``bwd_weight_bf16_plan`` give the three
their launch plans (pixel tile, splits, shared memory, scratch; their
gather routes ``dcn_local_fwd_gather_bf16``,
``dcn_local_bwd_data_gather_bf16`` and
``dcn_local_bwd_weight_gather_bf16``).
At bf16 the forward rounds
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
# the gather routes, past what the window designs take
FWD_GATHER_LAUNCHES = 0              # dcn_local_fwd_gather
FWD_GATHER_BF16_LAUNCHES = 0         # dcn_local_fwd_gather_bf16
BWD_DATA_GATHER_LAUNCHES = 0         # dcn_local_bwd_data_gather
BWD_DATA_GATHER_BF16_LAUNCHES = 0    # dcn_local_bwd_data_gather_bf16
BWD_WEIGHT_GATHER_LAUNCHES = 0       # dcn_local_bwd_weight_gather
BWD_WEIGHT_GATHER_BF16_LAUNCHES = 0  # dcn_local_bwd_weight_gather_bf16

# symbol -> (source in csrc/, pointer arguments, int arguments); every
# launcher ends with the stream
_SIGNATURES = {
    "dcn_local_fwd": ("dcn_local", 8, 13),
    "dcn_local_fwd_gather": ("dcn_local", 6, 6),
    "dcn_local_fwd_bf16": ("dcn_local_bf16", 7, 12),
    "dcn_local_fwd_gather_bf16": ("dcn_local_bf16", 6, 6),
    "dcn_local_bwd_data": ("dcn_local_bwd", 10, 12),
    "dcn_local_bwd_data_gather": ("dcn_local_bwd", 8, 6),
    "dcn_local_bwd_weight": ("dcn_local_bwd", 7, 14),
    "dcn_local_bwd_weight_gather": ("dcn_local_bwd", 6, 7),
    "dcn_local_bwd_data_bf16": ("dcn_local_bwd_bf16", 10, 11),
    "dcn_local_bwd_data_gather_bf16": ("dcn_local_bwd_bf16", 9, 6),
    "dcn_local_bwd_weight_bf16": ("dcn_local_bwd_bf16", 6, 14),
    "dcn_local_bwd_weight_gather_bf16": ("dcn_local_bwd_bf16", 6, 7),
}

# blocks a split launch aims for: four per SM of an H100 (the wave rule
# asks for at least half of it)
TARGET_BLOCKS = 4 * 132

# The forward and data-gradient kernels of both dtypes
# (csrc/dcn_local.cu, csrc/dcn_local_bwd.cu, csrc/dcn_local_bf16.cu,
# csrc/dcn_local_bwd_bf16.cu): a block takes a 4 x 16 tile of output
# pixels (one wgmma M tile of 64) and walks K in steps of (a chunk of
# input channels, a tap); each checks the plan it is given.
TILE = (4, 16)
BF16_CHUNK = 64
# dynamic shared memory one block may use on an H100 (227 KB), and what
# the blocks resident on one SM share (228 KB, 1 KB of it reserved per
# block)
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
SMS = 132
# the largest max_offset the data kernel's support walk is unrolled for
BF16_DATA_MAX_OFFSET = 4
# float32: the forward's Cin chunk; the data kernel's chunks, the first
# whose shared memory fits (the chunk is its wgmma N); the largest
# max_offset both plan for
FP32_CHUNK = 32
FP32_DATA_CHUNKS = (32, 16, 8)
FP32_MAX_OFFSET = 8
# The gather routes of the forward and data-gradient kernels (the first
# designs): a block of 256 threads takes 64 consecutive output pixels and
# either 64 output channels (forward) or one tap (data gradient).
GATHER_PIXELS = 64
GATHER_CHANNELS = 64
# The weight-gradient kernels of both dtypes (csrc/dcn_local_bwd.cu,
# csrc/dcn_local_bwd_bf16.cu), window route: a block takes a chunk of 64
# input channels (the wgmma M), a group of taps and up to 256 output
# channels (the N tile), and walks its split's pixel tiles of th x 16
# (the K); the rows th of a tile are the first of WEIGHT_TILE_ROWS whose
# shared memory fits, with two x-window slots, else one. The taps of a
# block are set by registers (WEIGHT_TAPS, by N tile): each warpgroup
# keeps N / 4 float32 accumulators a thread for each. Past anything that
# fits, the weight gradient takes its gather route.
WEIGHT_CHUNK = 64
WEIGHT_TILE_ROWS = (4, 2, 1)
WEIGHT_TAPS = {64: 3, 128: 3, 256: 1}
# blocks an SM holds at most, by dtype and N tile (the kernels'
# __launch_bounds__): the bf16 kernel at N 64 fits two in registers
WEIGHT_MIN_BLOCKS = {("bfloat16", 64): 2}


def _kernel(symbol: str):
    source, n_ptr, n_int = _SIGNATURES[symbol]
    return _build.launcher(source, symbol, n_ptr, n_int)


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


def _k_splits(blocks: int, steps: int) -> int:
    """K splits of a ``dcn_local_fwd_bf16`` launch (its plan's
    ``split_rule`` "two_per_sm"): none when its pixel tiles give
    ``TARGET_BLOCKS // 2`` blocks (two per SM), else enough to reach
    that, at most one split per K step. The forward keeps it because
    the wave rule splits it more, and each split adds a float32 partial
    of the whole output and its sum (PERF.md: 25% slower at s4, B=1)."""
    want = TARGET_BLOCKS // 2
    return 1 if blocks >= want else min(steps, -(-want // blocks))


def _resident(smem: int, threads: int) -> int:
    """Blocks of a launch that one SM holds at once, by shared memory and
    threads."""
    return max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads))


def _wave_splits(blocks: int, steps: int, resident: int) -> int:
    """Splits of a launch of ``blocks`` independent units (pixel tiles,
    or the weight gradient's chunk x tap-group x N tiles) of ``steps``
    steps each (its K steps, or the weight gradient's pixel tiles),
    ``resident`` blocks to an SM (the plans' ``split_rule`` "waves":
    every planner but ``fwd_bf16_plan``'s). None when the tiles
    fill four waves (the last wave's tail is then a small share). Else,
    among the splits that give at least ``TARGET_BLOCKS // 2`` blocks (two
    per SM; every step its own split when that is short of it), the
    fewest waves times the steps of a block, one step added for its
    staging; ties to fewer splits. A launch of 288 tiles at one block per
    SM runs in 3 waves (the third of 24 blocks): 5 splits run the same K
    in 11 waves of a fifth of the steps, 330 step-times against 435."""
    cap = SMS * resident
    if blocks >= 4 * cap:
        return 1
    least = min(steps, -(-(TARGET_BLOCKS // 2) // blocks))
    return min(range(least, steps + 1), key=lambda s: (
        -(-(blocks * s) // cap) * (-(-steps // s) + 1), s))


def _k_ranges(steps: int, splits: int) -> tuple:
    """The K steps [begin, end) of each split, as the kernels cut them:
    split z takes z * steps // splits up to (z + 1) * steps // splits."""
    return tuple((z * steps // splits, (z + 1) * steps // splits)
                 for z in range(splits))


def _tiles(b: int, h: int, w: int, th: int = TILE[0]) -> int:
    tw = TILE[1]
    return b * -(-h // th) * -(-w // tw)


def _window_pixels(max_offset: int, th: int = TILE[0]) -> int:
    """Pixels of a tile's x window: the tile (th rows) and a halo of R + 1,
    every position a clamped offset's bilinear support reaches."""
    tw = TILE[1]
    halo = max_offset + 1
    return (th + 2 * halo) * (tw + 2 * halo)


def _gather_plan(kind: str, b: int, h: int, w: int, cout: int,
                 reason: str) -> dict:
    """The plan of a forward (``kind`` "fwd") or data-gradient ("data")
    kernel's gather route: its blocks, 64 pixels by 64 output channels or
    by one tap, and why the window design does not take the call."""
    cols = -(-cout // GATHER_CHANNELS) if kind == "fwd" else 9
    return {"route": "gather", "reason": reason,
            "blocks": -(-(b * h * w) // GATHER_PIXELS) * cols}


@functools.lru_cache(maxsize=256)
def fwd_bf16_plan(b: int, h: int, w: int, cin: int, cout: int,
                  max_offset: int) -> dict:
    """Launch plan of ``dcn_local_fwd_bf16``, route "window": output
    channels per block (``n_tile``: 64, 128 or 256, the wgmma N), the K
    splits (by ``_k_splits``), the blocks, the dynamic shared memory (A
    tile, two weight slots, one x window per Cin chunk up to two, the
    corner table) and the float32 scratch of the split partials. Where a
    block's shared memory would not fit, route "gather"
    (``dcn_local_fwd_gather_bf16``). Any max_offset and width have a
    plan. Cached per shape: callers read it and never change it."""
    th, tw = TILE
    ck = BF16_CHUNK
    n_tile = 64 if cout <= 64 else 128 if cout <= 128 else 256
    col_tiles = -(-cout // n_tile)
    tiles = _tiles(b, h, w)
    steps = 9 * max(1, -(-cin // ck))
    table = 9 * 4 * th * tw * (2 + 4) + 9 * th * tw * 4
    smem = (th * tw * ck * 2 + 2 * ck * n_tile * 2
            + min(2, steps // 9) * _window_pixels(max_offset) * ck * 2
            + table)
    if smem > SMEM_LIMIT:
        return _gather_plan("fwd", b, h, w, cout,
                            f"shared memory {smem} > {SMEM_LIMIT}")
    splits = _k_splits(tiles * col_tiles, steps)
    return {"route": "window", "tile": TILE, "chunk": ck, "n_tile": n_tile,
            "col_tiles": col_tiles, "tiles": tiles, "steps": steps,
            "split_rule": "two_per_sm",
            "splits": splits, "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * col_tiles * splits, "smem_bytes": smem,
            "scratch": splits * b * h * w * cout if splits > 1 else 0}


@functools.lru_cache(maxsize=256)
def bwd_data_bf16_plan(b: int, h: int, w: int, cin: int, cout: int,
                       max_offset: int) -> dict:
    """Launch plan of ``dcn_local_bwd_data_bf16``, route "window": the K
    splits (by ``_wave_splits``), the blocks, the dynamic shared memory
    (the output-grad tile and two weight slots over Cout padded to 16,
    the x window and its float32 grad-x tile, the tile's offsets and
    mask, the sums) and the float32 scratch: the grad-x accumulator and,
    when split, the grad offset / mask partials. Where max_offset passes
    ``BF16_DATA_MAX_OFFSET`` or shared memory would not fit, route
    "gather" (``dcn_local_bwd_data_gather_bf16``, its grad-x accumulator
    ``grad_acc``). Any max_offset and width have a plan. Cached per
    shape: callers read it and never change it."""
    npix = b * h * w
    th, tw = TILE
    ck = BF16_CHUNK
    kp = -(-cout // 16) * 16
    tiles = _tiles(b, h, w)
    steps = 9 * max(1, -(-cin // ck))
    smem = (th * tw * kp * 2 + 2 * ck * kp * 2
            + _window_pixels(max_offset) * (ck * (2 + 4) + 32 + 64)
            + th * tw * 27 * 4 + 3 * 9 * th * tw * 4)
    if max_offset > BF16_DATA_MAX_OFFSET or smem > SMEM_LIMIT:
        reason = (f"max_offset {max_offset} > {BF16_DATA_MAX_OFFSET}"
                  if max_offset > BF16_DATA_MAX_OFFSET else
                  f"shared memory {smem} > {SMEM_LIMIT}")
        return {**_gather_plan("data", b, h, w, cout, reason),
                "grad_acc": npix * cin}
    splits = _wave_splits(tiles, steps, _resident(smem, 128))
    return {"route": "window", "tile": TILE, "chunk": ck, "tiles": tiles,
            "steps": steps, "split_rule": "waves",
            "splits": splits, "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * splits, "smem_bytes": smem,
            "grad_acc": npix * cin,
            "scratch": splits * npix * 27 if splits > 1 else 0}


def _fwd_fp32_smem(n_tile: int, window_slots: int, max_offset: int) -> int:
    """Two A slots and two weight slots of hi and lo, the x windows and
    the corner table of ``dcn_local_fwd`` (csrc/dcn_local.cu
    smem_bytes)."""
    th, tw = TILE
    ck = FP32_CHUNK
    return (4 * th * tw * ck * 4 + 4 * ck * n_tile * 4
            + window_slots * _window_pixels(max_offset) * ck * 4
            + 9 * 4 * th * tw * (2 + 4))


@functools.lru_cache(maxsize=256)
def fwd_fp32_plan(b: int, h: int, w: int, cin: int, cout: int,
                  max_offset: int) -> dict:
    """Launch plan of ``dcn_local_fwd``, route "window": output channels
    per block
    (``n_tile``: 64, 128 or 256, half per warpgroup; narrower where the
    window would not fit 227 KB), x window slots (two, so that the next
    chunk's window flies during a whole chunk, when Cin spans several
    chunks of 32 and the second slot fits without costing a resident
    block), the K splits, the blocks, the dynamic shared memory and the
    float32 scratch: the weight split into TF32 hi and lo, K-major, padded
    to the chunk and the N tile (``weight_split``), and the split
    partials (``scratch``). Past ``FP32_MAX_OFFSET``, route "gather"
    (``dcn_local_fwd_gather``). Any max_offset and width have a plan.
    Cached per shape: callers read it and never change it."""
    if max_offset > FP32_MAX_OFFSET:
        return _gather_plan("fwd", b, h, w, cout,
                            f"max_offset {max_offset} > {FP32_MAX_OFFSET}")
    ck = FP32_CHUNK
    nchunks = max(1, -(-cin // ck))
    n_tile = 64 if cout <= 64 else 128 if cout <= 128 else 256
    while _fwd_fp32_smem(n_tile, 1, max_offset) > SMEM_LIMIT:
        n_tile //= 2   # > 64 within FP32_MAX_OFFSET
    one, two = (_fwd_fp32_smem(n_tile, k, max_offset) for k in (1, 2))
    window_slots = (2 if nchunks > 1 and two <= SMEM_LIMIT
                    and _resident(two, 256) == _resident(one, 256) else 1)
    col_tiles = -(-cout // n_tile)
    tiles = _tiles(b, h, w)
    steps = 9 * nchunks
    smem = _fwd_fp32_smem(n_tile, window_slots, max_offset)
    splits = _wave_splits(tiles * col_tiles, steps, _resident(smem, 256))
    return {"route": "window", "tile": TILE, "chunk": ck, "n_tile": n_tile,
            "window_slots": window_slots, "col_tiles": col_tiles,
            "tiles": tiles, "steps": steps, "split_rule": "waves",
            "splits": splits,
            "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * col_tiles * splits, "smem_bytes": smem,
            "weight_split": 2 * 9 * col_tiles * n_tile * nchunks * ck,
            "scratch": splits * b * h * w * cout if splits > 1 else 0}


def _data_fp32_smem(cout: int, chunk: int, max_offset: int) -> int:
    """g hi and lo, one weight slot of hi and lo, the x window and its
    grad-x tile (pixels padded by 16 bytes from chunk 16), the offsets and
    mask and the sums of ``dcn_local_bwd_data`` (csrc/dcn_local_bwd.cu
    data_smem_bytes)."""
    th, tw = TILE
    kp = -(-cout // 8) * 8
    pitch = chunk * 4 + (16 if chunk >= 16 else 0)
    return (2 * th * tw * kp * 4 + 2 * chunk * kp * 4
            + 2 * _window_pixels(max_offset) * pitch + 2 * th * tw * 27 * 4)


@functools.lru_cache(maxsize=256)
def bwd_data_fp32_plan(b: int, h: int, w: int, cin: int, cout: int,
                       max_offset: int) -> dict:
    """Launch plan of ``dcn_local_bwd_data``, route "window": the Cin
    chunk (the wgmma N:
    the first of ``FP32_DATA_CHUNKS`` whose shared memory fits, so the
    chunk shrinks as Cout and max_offset grow), the warpgroups (two, each
    with half the chunk's channels, where a block has an SM to itself by
    shared memory and the chunk is 16 or more), the K splits, the blocks,
    the dynamic shared memory and the float32 scratch: the weight split
    into TF32 hi and lo over Cout padded to 8 (``weight_split``) and, when
    split, the grad offset / mask partials (``scratch``). Past
    ``FP32_MAX_OFFSET``, or where no chunk fits (past about 360 output
    channels), route "gather" (``dcn_local_bwd_data_gather``). Any
    max_offset and width have a plan. Cached per shape: callers read it
    and never change it."""
    if max_offset > FP32_MAX_OFFSET:
        return _gather_plan("data", b, h, w, cout,
                            f"max_offset {max_offset} > {FP32_MAX_OFFSET}")
    for ck in FP32_DATA_CHUNKS:
        smem = _data_fp32_smem(cout, ck, max_offset)
        if smem <= SMEM_LIMIT:
            break
    else:
        return _gather_plan("data", b, h, w, cout,
                            f"shared memory {smem} > {SMEM_LIMIT} at "
                            f"chunk {ck}")
    warpgroups = 2 if ck >= 16 and _resident(smem, 128) == 1 else 1
    tiles = _tiles(b, h, w)
    steps = 9 * max(1, -(-cin // ck))
    splits = _wave_splits(tiles, steps, _resident(smem, 128 * warpgroups))
    npix = b * h * w
    return {"route": "window", "tile": TILE, "chunk": ck,
            "warpgroups": warpgroups,
            "tiles": tiles, "steps": steps, "split_rule": "waves",
            "splits": splits, "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * splits, "smem_bytes": smem,
            "weight_split": 2 * 9 * cin * (-(-cout // 8) * 8),
            "scratch": splits * npix * 27 if splits > 1 else 0}


def _weight_fp32_smem(n_tile: int, max_offset: int, th: int,
                      window_slots: int) -> int:
    """Two A slots and two output-grad slots of hi and lo (A's 8-channel
    groups padded by 16 bytes), the x windows and two corner tables of
    ``dcn_local_bwd_weight`` (csrc/dcn_local_bwd.cu weight_smem_bytes)."""
    tp = th * TILE[1]
    return (4 * 8 * (tp * 32 + 16) + 4 * n_tile * tp * 4
            + window_slots * _window_pixels(max_offset, th) * WEIGHT_CHUNK * 4
            + 2 * WEIGHT_TAPS[n_tile] * tp * 24)


def _weight_bf16_smem(n_tile: int, max_offset: int, th: int,
                      window_slots: int) -> int:
    """Two A slots, two output-grad slots, the x windows and two corner
    tables of ``dcn_local_bwd_weight_bf16`` (csrc/dcn_local_bwd_bf16.cu
    weight_smem_bytes)."""
    tp = th * TILE[1]
    return (2 * tp * WEIGHT_CHUNK * 2 + 2 * tp * n_tile * 2
            + window_slots * _window_pixels(max_offset, th) * WEIGHT_CHUNK * 2
            + 2 * WEIGHT_TAPS[n_tile] * tp * 28)


def weight_splits(npix: int, cin: int, cout: int) -> int:
    """Pixel splits of the gather route: enough blocks to fill the card
    (``TARGET_BLOCKS``), at least 256 pixels per split."""
    tiles = -(-cin // 64) * -(-cout // 64) * 9
    return max(1, min(-(-TARGET_BLOCKS // tiles), -(-npix // 256)))


def _weight_plan(dtype: str, smem_of, b: int, h: int, w: int, cin: int,
                 cout: int, max_offset: int) -> dict:
    n_tile = 64 if cout <= 64 else 128 if cout <= 128 else 256
    taps = WEIGHT_TAPS[n_tile]
    fits = [(th, ws) for th in WEIGHT_TILE_ROWS for ws in (2, 1)
            if smem_of(n_tile, max_offset, th, ws) <= SMEM_LIMIT]
    if not fits:
        splits = weight_splits(b * h * w, cin, cout)
        partial = splits > 1 or dtype == "bfloat16"
        return {"route": "gather", "splits": splits,
                "scratch": splits * 9 * cin * cout if partial else 0}
    th, ws = fits[0]
    smem = smem_of(n_tile, max_offset, th, ws)
    col_tiles = -(-cout // n_tile)
    groups = -(-9 // taps)
    chunks = -(-cin // WEIGHT_CHUNK)
    tiles = _tiles(b, h, w, th)
    resident = min(_resident(smem, 256),
                   WEIGHT_MIN_BLOCKS.get((dtype, n_tile), 1))
    units = chunks * groups * col_tiles
    splits = _wave_splits(units, tiles, resident)
    plan = {"route": "window", "tile": (th, TILE[1]), "chunk": WEIGHT_CHUNK,
            "n_tile": n_tile, "taps": taps, "groups": groups,
            "chunks": chunks, "col_tiles": col_tiles,
            "window_slots": ws, "tiles": tiles, "resident": resident,
            "split_rule": "waves",
            "splits": splits, "tile_ranges": _k_ranges(tiles, splits),
            "blocks": units * splits, "smem_bytes": smem,
            "scratch": splits * 9 * cin * cout if splits > 1 else 0}
    if dtype == "float32":
        plan["grad_split"] = tiles * col_tiles * 2 * n_tile * th * TILE[1]
    return plan


@functools.lru_cache(maxsize=256)
def bwd_weight_fp32_plan(b: int, h: int, w: int, cin: int, cout: int,
                         max_offset: int) -> dict:
    """Launch plan of the float32 weight gradient. Window route
    (``dcn_local_bwd_weight``): the tile rows (4, 2 or 1: the first whose
    shared memory fits) and x-window slots (two, else one), the N tile
    (64, 128 or 256), the taps of a block (``WEIGHT_TAPS``) and their
    groups, the Cin chunks, the pixel tiles and their splits by the wave
    rule (``_wave_splits``: the units chunks x tap groups x N tiles, the
    tiles the steps), the blocks, the dynamic shared memory, the float32
    scratch of the output grad split into TF32 hi and lo by tile
    (``grad_split``) and of the split partials (``scratch``). Where no
    tile fits shared memory (a max_offset past about 7 at Cout 256), the
    gather route (``dcn_local_bwd_weight_gather``): its pixel splits and
    partials. Any max_offset and width have a plan. Cached per shape:
    callers read it and never change it."""
    return _weight_plan("float32", _weight_fp32_smem, b, h, w, cin, cout,
                        max_offset)


@functools.lru_cache(maxsize=256)
def bwd_weight_bf16_plan(b: int, h: int, w: int, cin: int, cout: int,
                         max_offset: int) -> dict:
    """Launch plan of the bf16 weight gradient, as
    ``bwd_weight_fp32_plan`` (window route ``dcn_local_bwd_weight_bf16``,
    no split output grad; gather route
    ``dcn_local_bwd_weight_gather_bf16``, whose partials are always
    summed and rounded by a second kernel)."""
    return _weight_plan("bfloat16", _weight_bf16_smem, b, h, w, cin, cout,
                        max_offset)


def _plan_ints(plan: dict, *keys: str) -> tuple:
    return (*plan["tile"], plan["chunk"], *(plan[k] for k in keys),
            plan["smem_bytes"])


def _scratch(plan: dict, key: str, device):
    """The plan's float32 scratch ``key``, or None when it has none."""
    return (torch.empty(plan[key], device=device, dtype=torch.float32)
            if plan[key] else None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_fwd_gather(x, offset, mask, weight, bias, max_offset):
    """The forward's gather route on checked CUDA tensors of either dtype
    -> (B, H, W, Cout) in x's dtype: ``dcn_local_fwd_gather`` (float32)
    or ``dcn_local_fwd_gather_bf16``, any max_offset and width."""
    global FWD_GATHER_LAUNCHES, FWD_GATHER_BF16_LAUNCHES
    low = x.dtype == torch.bfloat16
    symbol = "dcn_local_fwd_gather" + ("_bf16" if low else "")
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    _ok(_kernel(symbol)(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        _ptr(bias), out.data_ptr(), b, h, w, cin, cout, max_offset,
        _stream(x)), symbol)
    if low:
        FWD_GATHER_BF16_LAUNCHES += 1
    else:
        FWD_GATHER_LAUNCHES += 1
    return out


def launch_bwd_data_gather(x, offset, mask, weight, grad_out, max_offset):
    """The data gradient's gather route on checked CUDA tensors of either
    dtype -> (grad x, grad offset, grad mask) in x's dtype:
    ``dcn_local_bwd_data_gather`` (float32) or
    ``dcn_local_bwd_data_gather_bf16`` (grad x summed in a float32
    scratch and rounded once), any max_offset and width."""
    global BWD_DATA_GATHER_LAUNCHES, BWD_DATA_GATHER_BF16_LAUNCHES
    _check_grad(grad_out, x, weight.shape[3])
    low = x.dtype == torch.bfloat16
    symbol = "dcn_local_bwd_data_gather" + ("_bf16" if low else "")
    b, h, w, cin = x.shape
    # float32: the kernel adds into grad x with atomics; bf16: into the
    # float32 scratch, which the launcher zeroes
    grad_x = torch.empty_like(x) if low else torch.zeros_like(x)
    acc = (torch.empty(x.shape, device=x.device, dtype=torch.float32),
           ) if low else ()
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    _ok(_kernel(symbol)(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        grad_out.data_ptr(), *(t.data_ptr() for t in acc), grad_x.data_ptr(),
        grad_offset.data_ptr(), grad_mask.data_ptr(), b, h, w, cin,
        weight.shape[3], max_offset, _stream(x)), symbol)
    if low:
        BWD_DATA_GATHER_BF16_LAUNCHES += 1
    else:
        BWD_DATA_GATHER_LAUNCHES += 1
    return grad_x, grad_offset, grad_mask


def launch_fwd(x, offset, mask, weight, bias, max_offset):
    """The float32 forward on checked CUDA tensors -> (B, H, W, Cout), by
    ``fwd_fp32_plan``: ``dcn_local_fwd`` (window route) or
    ``dcn_local_fwd_gather``."""
    global LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    plan = fwd_fp32_plan(b, h, w, cin, cout, max_offset)
    if plan["route"] == "gather":
        return launch_fwd_gather(x, offset, mask, weight, bias, max_offset)
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    partial = _scratch(plan, "scratch", x.device)
    wsplit = _scratch(plan, "weight_split", x.device)
    _ok(_kernel("dcn_local_fwd")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        _ptr(bias), out.data_ptr(), _ptr(partial), _ptr(wsplit),
        b, h, w, cin, cout, max_offset,
        *_plan_ints(plan, "n_tile", "window_slots", "splits"), _stream(x)),
        "dcn_local_fwd")
    LAUNCHES += 1
    return out


def launch_fwd_bf16(x, offset, mask, weight, bias, max_offset):
    """The bf16 forward on checked bf16 CUDA tensors -> bf16 (B, H, W,
    Cout), by ``fwd_bf16_plan``: ``dcn_local_fwd_bf16`` (window route) or
    ``dcn_local_fwd_gather_bf16``."""
    global BF16_LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    plan = fwd_bf16_plan(b, h, w, cin, cout, max_offset)
    if plan["route"] == "gather":
        return launch_fwd_gather(x, offset, mask, weight, bias, max_offset)
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    partial = _scratch(plan, "scratch", x.device)
    _ok(_kernel("dcn_local_fwd_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        _ptr(bias), out.data_ptr(), _ptr(partial),
        b, h, w, cin, cout, max_offset,
        *_plan_ints(plan, "n_tile", "splits"), _stream(x)),
        "dcn_local_fwd_bf16")
    BF16_LAUNCHES += 1
    return out


def launch_bwd_data(x, offset, mask, weight, grad_out, max_offset):
    """The float32 data gradient on checked CUDA tensors -> (grad x, grad
    offset, grad mask), by ``bwd_data_fp32_plan``: ``dcn_local_bwd_data``
    (window route) or ``dcn_local_bwd_data_gather``."""
    global BWD_DATA_LAUNCHES
    _check_grad(grad_out, x, weight.shape[3])
    b, h, w, cin = x.shape
    plan = bwd_data_fp32_plan(b, h, w, cin, weight.shape[3], max_offset)
    if plan["route"] == "gather":
        return launch_bwd_data_gather(x, offset, mask, weight, grad_out,
                                      max_offset)
    grad_x = torch.zeros_like(x)   # each block adds its tile with atomics
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    partial = _scratch(plan, "scratch", x.device)
    wsplit = _scratch(plan, "weight_split", x.device)
    _ok(_kernel("dcn_local_bwd_data")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        grad_out.data_ptr(), grad_x.data_ptr(), grad_offset.data_ptr(),
        grad_mask.data_ptr(), _ptr(partial), _ptr(wsplit), b, h, w, cin,
        weight.shape[3], max_offset,
        *_plan_ints(plan, "warpgroups", "splits"), _stream(x)),
        "dcn_local_bwd_data")
    BWD_DATA_LAUNCHES += 1
    return grad_x, grad_offset, grad_mask


def launch_bwd_weight(x, offset, mask, grad_out, cout, max_offset):
    """The float32 weight gradient -> grad weight (3, 3, Cin, Cout), by
    ``bwd_weight_fp32_plan``: ``dcn_local_bwd_weight`` (window route) or
    ``dcn_local_bwd_weight_gather``."""
    global BWD_WEIGHT_LAUNCHES, BWD_WEIGHT_GATHER_LAUNCHES
    _check_grad(grad_out, x, cout)
    b, h, w, cin = x.shape
    if b * h * w == 0:
        return torch.zeros((3, 3, cin, cout), device=x.device,
                           dtype=torch.float32)
    plan = bwd_weight_fp32_plan(b, h, w, cin, cout, max_offset)
    grad_w = torch.empty((3, 3, cin, cout), device=x.device,
                         dtype=torch.float32)
    if plan["route"] == "gather":
        partial = _scratch(plan, "scratch", x.device)
        _ok(_kernel("dcn_local_bwd_weight_gather")(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            grad_out.data_ptr(), grad_w.data_ptr(), _ptr(partial),
            b, h, w, cin, cout, max_offset, plan["splits"], _stream(x)),
            "dcn_local_bwd_weight_gather")
        BWD_WEIGHT_GATHER_LAUNCHES += 1
        return grad_w
    # one allocation for both scratches: the split output grad, then the
    # partials (16-byte aligned: grad_split is a multiple of 4 floats)
    scratch = torch.empty(plan["grad_split"] + plan["scratch"],
                          device=x.device, dtype=torch.float32)
    gsplit = scratch.data_ptr()
    partial = gsplit + 4 * plan["grad_split"] if plan["scratch"] else None
    _ok(_kernel("dcn_local_bwd_weight")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
        grad_out.data_ptr(), grad_w.data_ptr(), partial, gsplit,
        b, h, w, cin, cout, max_offset,
        *_plan_ints(plan, "n_tile", "taps", "window_slots", "splits"),
        _stream(x)), "dcn_local_bwd_weight")
    BWD_WEIGHT_LAUNCHES += 1
    return grad_w


def launch_bwd_data_bf16(x, offset, mask, weight, grad_out, max_offset):
    """The bf16 data gradient on bf16 CUDA tensors -> bf16 (grad x, grad
    offset, grad mask), by ``bwd_data_bf16_plan``:
    ``dcn_local_bwd_data_bf16`` (window route) or
    ``dcn_local_bwd_data_gather_bf16``. grad x is summed in a float32
    scratch and rounded once."""
    global BWD_DATA_BF16_LAUNCHES
    _check_grad(grad_out, x, weight.shape[3])
    b, h, w, cin = x.shape
    plan = bwd_data_bf16_plan(b, h, w, cin, weight.shape[3], max_offset)
    if plan["route"] == "gather":
        return launch_bwd_data_gather(x, offset, mask, weight, grad_out,
                                      max_offset)
    grad_acc = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    partial = _scratch(plan, "scratch", x.device)
    grad_x = torch.empty_like(x)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    _ok(_kernel("dcn_local_bwd_data_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        grad_out.data_ptr(), grad_acc.data_ptr(), grad_x.data_ptr(),
        grad_offset.data_ptr(), grad_mask.data_ptr(), _ptr(partial), b, h, w,
        cin,
        weight.shape[3], max_offset, *_plan_ints(plan, "splits"),
        _stream(x)), "dcn_local_bwd_data_bf16")
    BWD_DATA_BF16_LAUNCHES += 1
    return grad_x, grad_offset, grad_mask


def launch_bwd_weight_bf16(x, offset, mask, grad_out, cout, max_offset):
    """The bf16 weight gradient on bf16 CUDA tensors -> bf16 grad weight
    (3, 3, Cin, Cout), by ``bwd_weight_bf16_plan``:
    ``dcn_local_bwd_weight_bf16`` (window route) or
    ``dcn_local_bwd_weight_gather_bf16``; summed in float32 and rounded
    once."""
    global BWD_WEIGHT_BF16_LAUNCHES, BWD_WEIGHT_GATHER_BF16_LAUNCHES
    _check_grad(grad_out, x, cout)
    b, h, w, cin = x.shape
    if b * h * w == 0:
        return torch.zeros((3, 3, cin, cout), device=x.device, dtype=x.dtype)
    plan = bwd_weight_bf16_plan(b, h, w, cin, cout, max_offset)
    grad_w = torch.empty((3, 3, cin, cout), device=x.device, dtype=x.dtype)
    partial = _scratch(plan, "scratch", x.device)
    ptrs = (x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            grad_out.data_ptr(), grad_w.data_ptr(), _ptr(partial))
    if plan["route"] == "gather":
        _ok(_kernel("dcn_local_bwd_weight_gather_bf16")(
            *ptrs, b, h, w, cin, cout, max_offset, plan["splits"],
            _stream(x)), "dcn_local_bwd_weight_gather_bf16")
        BWD_WEIGHT_GATHER_BF16_LAUNCHES += 1
        return grad_w
    _ok(_kernel("dcn_local_bwd_weight_bf16")(
        *ptrs, b, h, w, cin, cout, max_offset,
        *_plan_ints(plan, "n_tile", "taps", "window_slots", "splits"),
        _stream(x)), "dcn_local_bwd_weight_bf16")
    BWD_WEIGHT_BF16_LAUNCHES += 1
    return grad_w


class DCNLocal(torch.autograd.Function):
    """The kernels' route, by the inputs' dtype: at float32 forward
    ``dcn_local_fwd``, backward ``dcn_local_bwd_data`` +
    ``dcn_local_bwd_weight``; at bfloat16 forward ``dcn_local_fwd_bf16``,
    backward ``dcn_local_bwd_data_bf16`` + ``dcn_local_bwd_weight_bf16``
    (each launcher takes its gather route where its plan says so);
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
