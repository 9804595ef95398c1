"""Modulated 3x3 deformable convolution (DCNv2) in two forms: the
clamped op ``dcn_local`` and the exact op, each with forward and
backward kernels.

Both take the JAX package's layout: x (B, H, W, Cin), offset (B, H, W,
18) interleaved (dy, dx) per tap with taps row-major, mask (B, H, W, 9)
already sigmoided, weight (3, 3, Cin, Cout), bias (Cout,). Stride 1,
padding 1, dilation 1; bilinear sampling with zeros outside the map.

The clamped op (JAX ops/dcn.py:382, ``deform_conv2d_local``) clips each
offset to +/-max_offset. ``deform_conv2d_local`` is the wrapper of its
hand-written Hopper kernels: a float32 CUDA tensor goes to ``DCNLocal``,
a ``torch.autograd.Function`` whose forward launches ``dcn_local_fwd``
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

The exact op (JAX ops/dcn.py:315, ``deform_conv2d``; dla_node "dcn", and
"dcn_mix" on its coarse maps) takes any offset: the absolute sample
position is clipped into the map's ring of zeros, as the JAX op clips it.
``deform_conv2d`` is its wrapper (route: ``exact_route``): a CUDA tensor
that needs no gradient launches ``dcn_exact_fwd`` (float32) or
``dcn_exact_fwd_bf16`` (``csrc/dcn_exact.cu``), by ``exact_fwd_fp32_plan``
/ ``exact_fwd_bf16_plan``: each block copies its tile's own bounding box
of live corners into shared memory where the box fits the plan's
capacity and gathers the corners from global memory where it does not
(``exact_tile_routes`` is that rule in plain PyTorch). A CUDA call that
needs a gradient goes to ``DCNExact``, whose forward launches the same
kernel and whose backward launches ``dcn_exact_bwd_data`` (grad x,
offset, mask) and ``dcn_exact_bwd_weight`` (grad weight), or their bf16
twins (``csrc/dcn_exact_bwd.cu``), by ``exact_bwd_data_fp32_plan`` /
``exact_bwd_data_bf16_plan`` / ``exact_bwd_weight_fp32_plan`` /
``exact_bwd_weight_bf16_plan``: the data kernels window each tile's box
of every corner the gradient reads (``exact_bwd_tile_routes``), the
weight kernels each tile's box of live corners (``exact_tile_routes``),
and both gather from global memory where a box does not fit. A CPU
tensor goes to ``deform_conv2d_plain``, the plain version and the
kernels' oracle, whose autograd is JAX's vjp.
JAX's environment
variable CT_EXACT_IMPL, which picks among its implementations of the
op, has no counterpart: the port has one kernel a dtype.

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
added in float32, and the sum rounded to bf16. The exact op rounds at
the same two points, where JAX's ``_deform_conv2d_slot`` rounds. The
clamped backward is the
float32 vjp of that function on the bf16 values, with its two roundings
passed through as a cast's transpose passes a cotangent, and each
gradient rounded to bf16 once; the weight gradient contracts the bf16
sample the forward contracted.

Derivative convention of the clamped op. It is piecewise linear in the
offsets, with kinks at integer offsets (where training starts: the
offset conv is zero-initialised) and at the clamp. The JAX package's gradient is
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
The exact op's gradient is JAX's floor-based vjp instead (floor' = 0,
the position clip's derivative 1/2 at -1 and at the map's size, which
zero offsets reach at the border taps): ``deform_conv2d_plain``.
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
# the exact (unclamped) DCNv2 forward, ``deform_conv2d``
EXACT_FWD_LAUNCHES = 0       # dcn_exact_fwd
EXACT_FWD_BF16_LAUNCHES = 0  # dcn_exact_fwd_bf16
# its backward, ``DCNExact``
EXACT_BWD_DATA_LAUNCHES = 0         # dcn_exact_bwd_data
EXACT_BWD_DATA_BF16_LAUNCHES = 0    # dcn_exact_bwd_data_bf16
EXACT_BWD_WEIGHT_LAUNCHES = 0       # dcn_exact_bwd_weight
EXACT_BWD_WEIGHT_BF16_LAUNCHES = 0  # dcn_exact_bwd_weight_bf16

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
    "dcn_exact_fwd": ("dcn_exact", 9, 13),
    "dcn_exact_fwd_bf16": ("dcn_exact", 8, 13),
    "dcn_exact_bwd_data": ("dcn_exact_bwd", 11, 13),
    "dcn_exact_bwd_data_bf16": ("dcn_exact_bwd", 11, 13),
    "dcn_exact_bwd_weight": ("dcn_exact_bwd", 8, 14),
    "dcn_exact_bwd_weight_bf16": ("dcn_exact_bwd", 7, 14),
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
# The exact forward kernels of both dtypes (csrc/dcn_exact.cu): a block of
# 256 threads takes a 4 x 16 tile and up to 256 output channels, and walks
# K in steps of (a Cin chunk, a tap), the chunk one window pixel of 128
# bytes. Its window is the tile's own bounding box of the corners it
# reads, in one or two slots of `box_capacity` pixels; a tile whose box is
# larger gathers its corners from global memory. The capacity is as large
# as shared memory allows at the resident blocks, up to EXACT_BOX_MAX
# pixels; a second resident block or a second window slot is taken only
# where each slot still holds EXACT_BOX_MIN pixels (a box of about 576
# pixels holds 96-100% of the tiles of every neck node but s16 256->256
# on the exact-trained checkpoint, PERF.md).
EXACT_CHUNK = {"float32": 32, "bfloat16": 64}
EXACT_THREADS = 256
EXACT_PIXEL_BYTES = 128
EXACT_TABLE_BYTES = 9 * 64 * 4 + 9 * 4 * 64 * 4 + 16
EXACT_BOX_MIN = 576
EXACT_BOX_MAX = 1024
# the widest N tile of each dtype's plan (64, 128 or 256)
EXACT_MAX_N_TILE = {"float32": 256, "bfloat16": 256}
# The exact data-gradient kernels (csrc/dcn_exact_bwd.cu): a block takes a
# 4 x 16 tile and walks K in steps of (a Cin chunk, a tap); the (chunk,
# warpgroups) of each dtype, widest first. The plan takes the first
# chunk whose window (the tile's box of x) still holds
# EXACT_DATA_BOX_MIN pixels, at two resident blocks an SM where each
# window still does, else at one; else the last chunk. On the trained
# inputs of the 16 dcn launches (PERF.md, tools/exact_bwd_times.py) a
# minimum of 128, 256 or 320 gave the same device time within 2% (two
# blocks an SM at most neck shapes); 256 keeps every tile on the window
# route there. The output grad is contracted in pieces of at most
# EXACT_DATA_MAX_K channels.
EXACT_DATA_CHUNKS = {"float32": ((32, 2), (16, 2), (8, 1)),
                     "bfloat16": ((64, 2), (32, 1))}
EXACT_DATA_BOX_MIN = 256
EXACT_DATA_MAX_K = 256
# The exact weight-gradient kernels: the clamped weight kernels' blocks
# (WEIGHT_CHUNK channels, WEIGHT_TAPS taps, th x 16 pixel tiles) with a
# window of the tile's box of live corners; the first (th, window slots)
# of EXACT_WEIGHT_FITS whose slots hold EXACT_WEIGHT_BOX_MIN pixels each,
# else the last at what fits.
EXACT_WEIGHT_FITS = ((4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))
EXACT_WEIGHT_BOX_MIN = 256


def _kernel(symbol: str):
    source, n_ptr, n_int = _SIGNATURES[symbol]
    return _build.launcher(source, symbol, n_ptr, n_int)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ok(rc: int, symbol: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")


def _check(x, offset, mask, weight, bias, max_offset, op="dcn_local"):
    """Raise on anything the kernel does not take, before any launch;
    ``max_offset`` None for the exact op (``op`` "dcn"), which has none."""
    tensors = {"x": x, "offset": offset, "mask": mask, "weight": weight}
    if bias is not None:
        tensors["bias"] = bias
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {x.device}")
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{op}: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{op}: {name} is {t.dtype}, the kernels "
                            f"take float32 or bfloat16")
        if t.dtype != x.dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}, x is "
                            f"{x.dtype}: the five tensors share one dtype")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if x.dim() != 4:
        raise ValueError(f"{op}: x must be (B, H, W, Cin), got "
                         f"{tuple(x.shape)}")
    b, h, w, cin = x.shape
    if tuple(offset.shape) != (b, h, w, 18):
        raise ValueError(f"{op}: offset must be {(b, h, w, 18)}, got "
                         f"{tuple(offset.shape)}")
    if tuple(mask.shape) != (b, h, w, 9):
        raise ValueError(f"{op}: mask must be {(b, h, w, 9)}, got "
                         f"{tuple(mask.shape)}")
    if weight.dim() != 4 or tuple(weight.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{op}: weight must be (3, 3, {cin}, Cout), "
                         f"got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[3],):
        raise ValueError(f"{op}: bias must be ({weight.shape[3]},), "
                         f"got {tuple(bias.shape)}")
    if max_offset is not None and (not isinstance(max_offset, int)
                                   or max_offset < 1):
        raise ValueError(f"{op}: max_offset must be an int >= 1, got "
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


def _exact_smem(dtype: str, n_tile: int, cap: int, slots: int) -> int:
    """Two A slots and two weight slots (float32: hi and lo parts of
    each), the window slots and the corner table of the exact forward
    (csrc/dcn_exact.cu smem_bytes)."""
    parts = 2 if dtype == "float32" else 1
    th, tw = TILE
    return (2 * parts * th * tw * EXACT_PIXEL_BYTES
            + 2 * parts * EXACT_CHUNK[dtype] * n_tile * (
                4 if dtype == "float32" else 2)
            + slots * cap * EXACT_PIXEL_BYTES + EXACT_TABLE_BYTES)


def _exact_plan(dtype: str, b: int, h: int, w: int, cin: int,
                cout: int) -> dict:
    ck = EXACT_CHUNK[dtype]
    n_tile = min(64 if cout <= 64 else 128 if cout <= 128 else 256,
                 EXACT_MAX_N_TILE[dtype])
    base = _exact_smem(dtype, n_tile, 0, 0)
    least = EXACT_BOX_MIN * EXACT_PIXEL_BYTES
    # two resident blocks where each still holds a window of EXACT_BOX_MIN
    two = SMEM_PER_SM // 2 - 1024 - base
    room = two if two >= least else SMEM_LIMIT - base
    nchunks = max(1, -(-cin // ck))
    slots = 2 if nchunks > 1 and room >= 2 * least else 1
    cap = min(EXACT_BOX_MAX, room // (slots * EXACT_PIXEL_BYTES))
    smem = _exact_smem(dtype, n_tile, cap, slots)
    resident = _resident(smem, EXACT_THREADS)
    col_tiles = -(-cout // n_tile)
    tiles = _tiles(b, h, w)
    steps = 9 * nchunks
    splits = (_wave_splits(tiles * col_tiles, steps, resident)
              if tiles * col_tiles else 1)
    plan = {"tile": TILE, "chunk": ck, "n_tile": n_tile,
            "col_tiles": col_tiles, "tiles": tiles, "steps": steps,
            "box_capacity": cap, "window_slots": slots,
            "resident": resident, "split_rule": "waves", "splits": splits,
            "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * col_tiles * splits, "smem_bytes": smem,
            "scratch": splits * b * h * w * cout if splits > 1 else 0}
    if dtype == "float32":
        plan["weight_split"] = 2 * 9 * col_tiles * n_tile * nchunks * ck
    return plan


@functools.lru_cache(maxsize=256)
def exact_fwd_fp32_plan(b: int, h: int, w: int, cin: int,
                        cout: int) -> dict:
    """Launch plan of ``dcn_exact_fwd``: output channels per block
    (``n_tile``: 64, 128 or 256, half per warpgroup, at most
    ``EXACT_MAX_N_TILE``), the window (``box_capacity`` pixels a slot,
    ``window_slots`` 1 or 2; a tile whose box of live corners is larger
    takes the gather route), the resident blocks, the K splits (by
    ``_wave_splits``), the blocks, the dynamic shared memory and the
    float32 scratch: the weight split into TF32 hi and lo, K-major, padded
    to the chunk and the N tile (``weight_split``), and the split partials
    (``scratch``). Any shape has a plan. Cached per shape: callers read it
    and never change it."""
    return _exact_plan("float32", b, h, w, cin, cout)


@functools.lru_cache(maxsize=256)
def exact_fwd_bf16_plan(b: int, h: int, w: int, cin: int,
                        cout: int) -> dict:
    """Launch plan of ``dcn_exact_fwd_bf16``, as ``exact_fwd_fp32_plan``
    with chunks of 64 channels and no weight split."""
    return _exact_plan("bfloat16", b, h, w, cin, cout)


def _exact_data_smem(dtype: str, k_tile: int, chunk: int, cap: int) -> int:
    """The output-grad tile and one weight slot (float32: hi and lo of
    each), the window of ``cap`` pixels, the tile's offsets and mask, the
    sums and the box of the exact data kernel (csrc/dcn_exact_bwd.cu
    data_smem_bytes)."""
    size, parts = (4, 2) if dtype == "float32" else (2, 1)
    th, tw = TILE
    return (parts * (th * tw + chunk) * k_tile * size
            + cap * (chunk * size + 16) + 2 * 27 * th * tw * 4 + 16)


def _exact_data_plan(dtype: str, b: int, h: int, w: int, cin: int,
                     cout: int) -> dict:
    size = 4 if dtype == "float32" else 2
    ka = 8 if dtype == "float32" else 16
    k_tile = (max(ka, -(-cout // ka) * ka) if cout <= EXACT_DATA_MAX_K
              else EXACT_DATA_MAX_K)
    pieces = max(1, -(-cout // k_tile))
    for chunk, warpgroups in EXACT_DATA_CHUNKS[dtype]:
        base = _exact_data_smem(dtype, k_tile, chunk, 0)
        pixel = chunk * size + 16
        # two resident blocks where each window still holds the minimum
        two = (SMEM_PER_SM // 2 - 1024 - base) // pixel
        cap = min(EXACT_BOX_MAX, two if two >= EXACT_DATA_BOX_MIN
                  else (SMEM_LIMIT - base) // pixel)
        if cap >= EXACT_DATA_BOX_MIN:
            break
    cap = max(1, cap)
    smem = _exact_data_smem(dtype, k_tile, chunk, cap)
    resident = _resident(smem, 128 * warpgroups)
    tiles = _tiles(b, h, w)
    steps = 9 * max(1, -(-cin // chunk))
    splits = _wave_splits(tiles, steps, resident) if tiles else 1
    npix = b * h * w
    plan = {"tile": TILE, "chunk": chunk, "warpgroups": warpgroups,
            "k_tile": k_tile, "pieces": pieces, "box_capacity": cap,
            "resident": resident, "tiles": tiles, "steps": steps,
            "split_rule": "waves", "splits": splits,
            "k_ranges": _k_ranges(steps, splits),
            "blocks": tiles * splits, "smem_bytes": smem,
            "scratch": splits * npix * 27 if splits > 1 else 0}
    if dtype == "float32":
        plan["weight_split"] = 2 * 9 * cin * pieces * k_tile
    else:
        plan["grad_acc"] = npix * cin
    return plan


@functools.lru_cache(maxsize=256)
def exact_bwd_data_fp32_plan(b: int, h: int, w: int, cin: int,
                             cout: int) -> dict:
    """Launch plan of ``dcn_exact_bwd_data``: the Cin chunk and warpgroups
    (the first of ``EXACT_DATA_CHUNKS`` whose window holds
    ``EXACT_DATA_BOX_MIN`` pixels, at two resident blocks where it can:
    32 channels and two warpgroups up to Cout 128, 16 and two at Cout
    256; two blocks an SM at Cout 64), the output grad's K pieces
    (``k_tile`` channels each, Cout padded to 8 up to 256), the window
    (``box_capacity`` pixels; a tile whose data box is larger takes the
    gather route), the resident blocks, the K splits (by ``_wave_splits``),
    the blocks, the dynamic shared memory and the float32 scratch: the
    weight split into TF32 hi and lo (``weight_split``) and, when split,
    the grad offset / mask partials (``scratch``). Any shape and offset
    has a plan. Cached per shape: callers read it and never change it."""
    return _exact_data_plan("float32", b, h, w, cin, cout)


@functools.lru_cache(maxsize=256)
def exact_bwd_data_bf16_plan(b: int, h: int, w: int, cin: int,
                             cout: int) -> dict:
    """Launch plan of ``dcn_exact_bwd_data_bf16``, as
    ``exact_bwd_data_fp32_plan`` with chunks of 64 channels and two
    warpgroups (32 and one where that window would be too small), Cout
    padded to 16, no weight split, and grad x's float32 accumulator
    (``grad_acc``)."""
    return _exact_data_plan("bfloat16", b, h, w, cin, cout)


def _exact_weight_smem(dtype: str, n_tile: int, th: int, slots: int,
                       cap: int) -> int:
    """Two A slots and two output-grad slots (float32: hi and lo, A's
    8-channel groups padded by 16 bytes), the window slots of ``cap``
    pixels, two corner tables and the box of the exact weight kernel
    (csrc/dcn_exact_bwd.cu weight_smem_bytes)."""
    tp = th * TILE[1]
    taps = WEIGHT_TAPS[n_tile]
    if dtype == "float32":
        fixed = 4 * 8 * (tp * 32 + 16) + 4 * n_tile * tp * 4
        pixel = WEIGHT_CHUNK * 4
    else:
        fixed = 2 * tp * WEIGHT_CHUNK * 2 + 2 * tp * n_tile * 2
        pixel = WEIGHT_CHUNK * 2
    return fixed + slots * cap * pixel + 2 * taps * tp * 20 + 16


def _exact_weight_plan(dtype: str, b: int, h: int, w: int, cin: int,
                       cout: int) -> dict:
    n_tile = 64 if cout <= 64 else 128 if cout <= 128 else 256
    pixel = WEIGHT_CHUNK * (4 if dtype == "float32" else 2)
    for th, slots in EXACT_WEIGHT_FITS:
        room = SMEM_LIMIT - _exact_weight_smem(dtype, n_tile, th, 0, 0)
        cap = min(EXACT_BOX_MAX, room // (slots * pixel))
        if cap >= EXACT_WEIGHT_BOX_MIN:
            break
    cap = max(1, cap)
    smem = _exact_weight_smem(dtype, n_tile, th, slots, cap)
    taps = WEIGHT_TAPS[n_tile]
    col_tiles = -(-cout // n_tile)
    groups = -(-9 // taps)
    chunks = -(-cin // WEIGHT_CHUNK)
    tiles = _tiles(b, h, w, th)
    units = chunks * groups * col_tiles
    splits = _wave_splits(units, tiles, 1) if tiles else 1
    plan = {"tile": (th, TILE[1]), "chunk": WEIGHT_CHUNK, "n_tile": n_tile,
            "taps": taps, "groups": groups, "chunks": chunks,
            "col_tiles": col_tiles, "window_slots": slots,
            "box_capacity": cap, "tiles": tiles, "resident": 1,
            "split_rule": "waves", "splits": splits,
            "tile_ranges": _k_ranges(tiles, splits),
            "blocks": units * splits, "smem_bytes": smem,
            "scratch": splits * 9 * cin * cout if splits > 1 else 0}
    if dtype == "float32":
        plan["grad_split"] = tiles * col_tiles * 2 * n_tile * th * TILE[1]
    return plan


@functools.lru_cache(maxsize=256)
def exact_bwd_weight_fp32_plan(b: int, h: int, w: int, cin: int,
                               cout: int) -> dict:
    """Launch plan of ``dcn_exact_bwd_weight``: the N tile (64, 128 or
    256), the taps of a block (``WEIGHT_TAPS``) and their groups, the
    tile rows and window slots (the first of ``EXACT_WEIGHT_FITS`` whose
    slots hold ``EXACT_WEIGHT_BOX_MIN`` pixels), the window's
    ``box_capacity`` (a tile whose box of live corners is larger builds
    A_t from global memory), the pixel tiles and their splits by the wave
    rule (units chunks x tap groups x N tiles, one block an SM), the
    blocks, the dynamic shared memory and the float32 scratch: the output
    grad split into TF32 hi and lo by tile (``grad_split``) and the split
    partials (``scratch``). Any shape and offset has a plan. Cached per
    shape: callers read it and never change it."""
    return _exact_weight_plan("float32", b, h, w, cin, cout)


@functools.lru_cache(maxsize=256)
def exact_bwd_weight_bf16_plan(b: int, h: int, w: int, cin: int,
                               cout: int) -> dict:
    """Launch plan of ``dcn_exact_bwd_weight_bf16``, as
    ``exact_bwd_weight_fp32_plan`` without the split output grad."""
    return _exact_weight_plan("bfloat16", b, h, w, cin, cout)


def _exact_corner_sets(offset: torch.Tensor, mask, h: int, w: int,
                       needed: bool):
    """Per tap, the four corners of every pixel as (row, column, used):
    ``used`` the forward's live corners (inside the map, hat weight not
    0), or with ``needed`` the data gradient's (inside the map, one of the
    hat and the two derivative weights not 0: dcn_exact.cuh
    ``grad_corners``), in the kernels' float32 arithmetic."""
    off = offset.float()
    dev = off.device
    rows = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    cols = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)

    def slope(u, size):
        return torch.where((u > -1) & (u < size), 1.0,
                           torch.where((u == -1) | (u == size), 0.5, 0.0))

    taps = []
    for i in range(3):
        for j in range(3):
            t = 3 * i + j
            uy = (rows + (i - 1)) + off[..., 2 * t]
            ux = (cols + (j - 1)) + off[..., 2 * t + 1]
            py = uy.clamp(-1.0, float(h))
            px = ux.clamp(-1.0, float(w))
            y0 = torch.floor(py)
            x0 = torch.floor(px)
            fy = py - y0
            fx = px - x0
            gy = 1 - fy
            gx = 1 - fx
            hats = (gy * gx, gy * fx, fy * gx, fy * fx)
            if needed:
                m = mask.float()[..., t]
                cy = slope(uy, h) * m
                cx = slope(ux, w) * m
                dys = (gx * cy, fx * cy, gx * cy, fx * cy)
                dxs = (gy * cx, gy * cx, fy * cx, fy * cx)
            corners = []
            for k, hat in enumerate(hats):
                r = y0.long() + (k >> 1)
                c = x0.long() + (k & 1)
                used = hat != 0
                if needed:
                    used = used | (dys[k] != 0) | (dxs[k] != 0)
                used = used & (r >= 0) & (r < h) & (c >= 0) & (c < w)
                corners.append((r, c, used))
            taps.append(corners)
    return taps


def _exact_routes(taps, b: int, h: int, w: int, tile, per_group: int,
                  capacity: int) -> tuple:
    """(window, gather) tiles of ``tile`` = (rows, columns), each tap group
    of ``per_group`` taps a box of its own: a box is the smallest rectangle
    holding every used corner of its pixels and taps, and its tile takes
    the window route where its area is at most ``capacity`` (or it holds
    no corner)."""
    th, tw = tile
    ty, tx = -(-h // th), -(-w // tw)
    dev = taps[0][0][0].device
    big = 2 ** 40
    n_window = n_all = 0
    for g0 in range(0, 9, per_group):
        lo = [torch.full((b, h, w), big, dtype=torch.int64, device=dev)
              for _ in range(2)]
        hi = [torch.full((b, h, w), -big, dtype=torch.int64, device=dev)
              for _ in range(2)]
        for corners in taps[g0:g0 + per_group]:
            for r, c, used in corners:
                for n, v in enumerate((r, c)):
                    lo[n] = torch.minimum(lo[n], torch.where(used, v, big))
                    hi[n] = torch.maximum(hi[n], torch.where(used, v, -big))

        def per_tile(m, fill, reduce):
            m = F.pad(m, (0, tx * tw - w, 0, ty * th - h), value=fill)
            return reduce(reduce(m.view(b, ty, th, tx, tw), 4)[0], 2)[0]

        rmin, cmin = (per_tile(m, big, torch.min) for m in lo)
        rmax, cmax = (per_tile(m, -big, torch.max) for m in hi)
        area = (rmax - rmin + 1) * (cmax - cmin + 1)
        window = (rmin > rmax) | (area <= capacity)
        n_window += int(window.sum())
        n_all += b * ty * tx
    return n_window, n_all - n_window


def exact_tile_routes(offset: torch.Tensor, h: int, w: int,
                      plan: dict) -> tuple:
    """(window tiles, gather tiles) of an exact forward or weight-gradient
    launch on ``offset`` (B, h, w, 18) under ``plan``: the kernels' rule in
    plain PyTorch, on any device. A tile's box is the smallest rectangle
    of map positions holding every corner of its pixels' taps that lies
    inside the map with a bilinear (hat) weight that is not 0, the
    positions taken as the kernels take them (``deform_conv2d_plain``'s
    float32 arithmetic); the tile takes the window route where the box's
    area is at most ``plan["box_capacity"]`` (or it holds no such corner).
    The forward's tile is 4 x 16 and its box spans all 9 taps; a weight
    plan's tile is ``plan["tile"]`` and each group of ``plan["taps"]``
    taps has a box (and a route) of its own."""
    return _exact_routes(_exact_corner_sets(offset, None, h, w, False),
                         offset.shape[0], h, w, plan.get("tile", TILE),
                         plan.get("taps", 9), plan["box_capacity"])


def exact_bwd_tile_routes(offset: torch.Tensor, mask: torch.Tensor, h: int,
                          w: int, plan: dict) -> tuple:
    """(window tiles, gather tiles) of an exact data-gradient launch on
    ``offset`` (B, h, w, 18) and ``mask`` (B, h, w, 9) under ``plan``: as
    ``exact_tile_routes``, with a box over every corner the gradient
    reads, whatever its hat weight: inside the map, with the hat or one of
    the two derivative weights (clip' m dhat/dfy, clip' m dhat/dfx) not 0.
    At an integer position fy = 0 and the corners of the next row have
    hat 0 but a derivative weight that is not, so the box is one row (and
    one column) larger than the forward's there."""
    return _exact_routes(_exact_corner_sets(offset, mask, h, w, True),
                         offset.shape[0], h, w, plan.get("tile", TILE), 9,
                         plan["box_capacity"])


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


# --- the exact DCNv2 (dla_node "dcn", and "dcn_mix" on its coarse maps) -----

def _route_counts(route_counts, x):
    """The optional route counter of an exact launch: None, or an int32
    CUDA tensor of two elements on x's device."""
    if route_counts is None:
        return None
    if (route_counts.dtype != torch.int32 or route_counts.device != x.device
            or route_counts.shape != (2,)
            or not route_counts.is_contiguous()):
        raise ValueError("dcn: route_counts must be a contiguous int32 "
                         "tensor of 2 elements on x's device, got "
                         f"{route_counts.dtype} {tuple(route_counts.shape)} "
                         f"on {route_counts.device}")
    return route_counts.data_ptr()


def launch_exact_fwd(x, offset, mask, weight, bias, route_counts=None):
    """The float32 exact forward on checked float32 CUDA tensors ->
    (B, H, W, Cout), by ``exact_fwd_fp32_plan``: ``dcn_exact_fwd``
    (csrc/dcn_exact.cu). ``route_counts`` (optional, int32 (2,)) gets the
    launch's window and gather tiles added."""
    global EXACT_FWD_LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    plan = exact_fwd_fp32_plan(b, h, w, cin, cout)
    counts = _route_counts(route_counts, x)
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    partial = _scratch(plan, "scratch", x.device)
    wsplit = _scratch(plan, "weight_split", x.device)
    _ok(_kernel("dcn_exact_fwd")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        _ptr(bias), out.data_ptr(), _ptr(partial), _ptr(wsplit), counts,
        b, h, w, cin, cout,
        *_plan_ints(plan, "n_tile", "box_capacity", "window_slots",
                    "splits"), _stream(x)), "dcn_exact_fwd")
    EXACT_FWD_LAUNCHES += 1
    return out


def launch_exact_fwd_bf16(x, offset, mask, weight, bias, route_counts=None):
    """The bf16 exact forward on checked bf16 CUDA tensors -> bf16
    (B, H, W, Cout), by ``exact_fwd_bf16_plan``: ``dcn_exact_fwd_bf16``
    (csrc/dcn_exact.cu); ``route_counts`` as ``launch_exact_fwd``."""
    global EXACT_FWD_BF16_LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    plan = exact_fwd_bf16_plan(b, h, w, cin, cout)
    counts = _route_counts(route_counts, x)
    out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    partial = _scratch(plan, "scratch", x.device)
    _ok(_kernel("dcn_exact_fwd_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        _ptr(bias), out.data_ptr(), _ptr(partial), counts,
        b, h, w, cin, cout,
        *_plan_ints(plan, "n_tile", "box_capacity", "window_slots",
                    "splits"), _stream(x)), "dcn_exact_fwd_bf16")
    EXACT_FWD_BF16_LAUNCHES += 1
    return out


def launch_exact_bwd_data(x, offset, mask, weight, grad_out,
                          route_counts=None):
    """The float32 exact data gradient on checked float32 CUDA tensors ->
    (grad x, grad offset, grad mask), by ``exact_bwd_data_fp32_plan``:
    ``dcn_exact_bwd_data`` (csrc/dcn_exact_bwd.cu). ``route_counts``
    (optional, int32 (2,)) gets the launch's window and gather tiles
    added."""
    global EXACT_BWD_DATA_LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    _check_grad(grad_out, x, cout)
    counts = _route_counts(route_counts, x)
    grad_x = torch.zeros_like(x)   # the blocks add into it with atomics
    if b * h * w == 0 or cin == 0 or cout == 0:
        return grad_x, torch.zeros_like(offset), torch.zeros_like(mask)
    plan = exact_bwd_data_fp32_plan(b, h, w, cin, cout)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    partial = _scratch(plan, "scratch", x.device)
    wsplit = _scratch(plan, "weight_split", x.device)
    _ok(_kernel("dcn_exact_bwd_data")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        grad_out.data_ptr(), grad_x.data_ptr(), grad_offset.data_ptr(),
        grad_mask.data_ptr(), _ptr(partial), _ptr(wsplit), counts,
        b, h, w, cin, cout,
        *_plan_ints(plan, "warpgroups", "k_tile", "box_capacity", "splits"),
        _stream(x)), "dcn_exact_bwd_data")
    EXACT_BWD_DATA_LAUNCHES += 1
    return grad_x, grad_offset, grad_mask


def launch_exact_bwd_data_bf16(x, offset, mask, weight, grad_out,
                               route_counts=None):
    """The bf16 exact data gradient on checked bf16 CUDA tensors -> bf16
    (grad x, grad offset, grad mask), by ``exact_bwd_data_bf16_plan``:
    ``dcn_exact_bwd_data_bf16``; grad x summed in a float32 scratch and
    rounded once; ``route_counts`` as ``launch_exact_bwd_data``."""
    global EXACT_BWD_DATA_BF16_LAUNCHES
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    _check_grad(grad_out, x, cout)
    counts = _route_counts(route_counts, x)
    if b * h * w == 0 or cin == 0 or cout == 0:
        return (torch.zeros_like(x), torch.zeros_like(offset),
                torch.zeros_like(mask))
    plan = exact_bwd_data_bf16_plan(b, h, w, cin, cout)
    grad_acc = torch.zeros(x.shape, device=x.device, dtype=torch.float32)
    grad_x = torch.empty_like(x)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    partial = _scratch(plan, "scratch", x.device)
    _ok(_kernel("dcn_exact_bwd_data_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        grad_out.data_ptr(), grad_acc.data_ptr(), grad_x.data_ptr(),
        grad_offset.data_ptr(), grad_mask.data_ptr(), _ptr(partial), counts,
        b, h, w, cin, cout,
        *_plan_ints(plan, "warpgroups", "k_tile", "box_capacity", "splits"),
        _stream(x)), "dcn_exact_bwd_data_bf16")
    EXACT_BWD_DATA_BF16_LAUNCHES += 1
    return grad_x, grad_offset, grad_mask


def launch_exact_bwd_weight(x, offset, mask, grad_out, cout,
                            route_counts=None):
    """The float32 exact weight gradient on checked float32 CUDA tensors
    -> grad weight (3, 3, Cin, Cout), by ``exact_bwd_weight_fp32_plan``:
    ``dcn_exact_bwd_weight``; ``route_counts`` (optional, int32 (2,)) gets
    the launch's window and gather (tile, tap group)s added."""
    global EXACT_BWD_WEIGHT_LAUNCHES
    b, h, w, cin = x.shape
    _check_grad(grad_out, x, cout)
    counts = _route_counts(route_counts, x)
    if b * h * w == 0 or cin == 0 or cout == 0:
        return torch.zeros((3, 3, cin, cout), device=x.device,
                           dtype=x.dtype)
    plan = exact_bwd_weight_fp32_plan(b, h, w, cin, cout)
    grad_w = torch.empty((3, 3, cin, cout), device=x.device, dtype=x.dtype)
    # one allocation for both scratches: the split output grad, then the
    # partials (16-byte aligned: grad_split is a multiple of 4 floats)
    scratch = torch.empty(plan["grad_split"] + plan["scratch"],
                          device=x.device, dtype=torch.float32)
    gsplit = scratch.data_ptr()
    partial = gsplit + 4 * plan["grad_split"] if plan["scratch"] else None
    _ok(_kernel("dcn_exact_bwd_weight")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
        grad_out.data_ptr(), grad_w.data_ptr(), partial, gsplit, counts,
        b, h, w, cin, cout,
        *_plan_ints(plan, "n_tile", "taps", "window_slots", "box_capacity",
                    "splits"), _stream(x)), "dcn_exact_bwd_weight")
    EXACT_BWD_WEIGHT_LAUNCHES += 1
    return grad_w


def launch_exact_bwd_weight_bf16(x, offset, mask, grad_out, cout,
                                 route_counts=None):
    """The bf16 exact weight gradient on checked bf16 CUDA tensors -> bf16
    grad weight (3, 3, Cin, Cout), by ``exact_bwd_weight_bf16_plan``:
    ``dcn_exact_bwd_weight_bf16``, summed in float32 and rounded once;
    ``route_counts`` as ``launch_exact_bwd_weight``."""
    global EXACT_BWD_WEIGHT_BF16_LAUNCHES
    b, h, w, cin = x.shape
    _check_grad(grad_out, x, cout)
    counts = _route_counts(route_counts, x)
    if b * h * w == 0 or cin == 0 or cout == 0:
        return torch.zeros((3, 3, cin, cout), device=x.device,
                           dtype=x.dtype)
    plan = exact_bwd_weight_bf16_plan(b, h, w, cin, cout)
    grad_w = torch.empty((3, 3, cin, cout), device=x.device, dtype=x.dtype)
    partial = _scratch(plan, "scratch", x.device)
    _ok(_kernel("dcn_exact_bwd_weight_bf16")(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
        grad_out.data_ptr(), grad_w.data_ptr(), _ptr(partial), counts,
        b, h, w, cin, cout,
        *_plan_ints(plan, "n_tile", "taps", "window_slots", "box_capacity",
                    "splits"), _stream(x)), "dcn_exact_bwd_weight_bf16")
    EXACT_BWD_WEIGHT_BF16_LAUNCHES += 1
    return grad_w


class DCNExact(torch.autograd.Function):
    """The exact op's kernels, by the inputs' dtype: at float32 forward
    ``dcn_exact_fwd``, backward ``dcn_exact_bwd_data`` +
    ``dcn_exact_bwd_weight``; at bfloat16 forward ``dcn_exact_fwd_bf16``,
    backward ``dcn_exact_bwd_data_bf16`` + ``dcn_exact_bwd_weight_bf16``;
    the bias grad is a float32 sum over (B, H, W) in the bias's dtype.
    Inputs are checked by ``deform_conv2d``."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.has_bias = bias is not None
        low = x.dtype == torch.bfloat16
        return (launch_exact_fwd_bf16 if low else launch_exact_fwd)(
            x, offset, mask, weight, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, offset, mask, weight = ctx.saved_tensors
        g = grad_out.contiguous()
        need = ctx.needs_input_grad
        low = x.dtype == torch.bfloat16
        grad_x = grad_offset = grad_mask = grad_w = grad_b = None
        if need[0] or need[1] or need[2]:
            grad_x, grad_offset, grad_mask = (
                launch_exact_bwd_data_bf16 if low else launch_exact_bwd_data)(
                x, offset, mask, weight, g)
        if need[3]:
            grad_w = (launch_exact_bwd_weight_bf16 if low
                      else launch_exact_bwd_weight)(
                x, offset, mask, g, weight.shape[3])
        if ctx.has_bias and need[4]:
            grad_b = g.float().sum(dim=(0, 1, 2)).to(g.dtype)
        return grad_x, grad_offset, grad_mask, grad_w, grad_b


def exact_route(device: torch.device, dtype: torch.dtype = torch.float32,
                needs_grad: bool = False):
    """What ``deform_conv2d`` calls for tensors on ``device``: the plain
    version on the CPU (autograd differentiates it); on CUDA the forward
    kernel of the dtype for a call that needs no gradient, else
    ``DCNExact``, whose backward is the data and weight kernels of the
    dtype. Nothing on CUDA reaches the plain version."""
    if device.type == "cpu":
        return deform_conv2d_plain
    if needs_grad:
        return DCNExact.apply
    return (launch_exact_fwd_bf16 if dtype == torch.bfloat16
            else launch_exact_fwd)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Exact DCNv2, 3x3, stride 1, padding 1 (JAX ops/dcn.py:315): the
    kernels of the dtype on a CUDA tensor (differentiable at float32 and
    bfloat16), the plain PyTorch version on a CPU tensor."""
    _check(x, offset, mask, weight, bias, None, op="dcn")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, offset, mask, weight, bias))
    return exact_route(x.device, x.dtype, needs_grad)(x, offset, mask,
                                                      weight, bias)


class _ClipPos(torch.autograd.Function):
    """clip(p, -1, size), a sample position clipped into the map's ring
    of zeros, with JAX's derivative (``jnp.clip``: 1 inside, 1/2 at
    exactly -1 or size, 0 outside)."""

    @staticmethod
    def forward(ctx, p, size):
        ctx.save_for_backward(p)
        ctx.size = size
        return p.clamp(-1.0, float(size))

    @staticmethod
    def backward(ctx, g):
        p, = ctx.saved_tensors
        inside = (p > -1.0) & (p < ctx.size)
        tie = (p == -1.0) | (p == ctx.size)
        slope = torch.where(inside, 1.0, torch.where(tie, 0.5, 0.0))
        return g * slope, None


def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Exact DCNv2 in plain PyTorch, as the JAX package computes it at
    every map size (``_deform_conv2d_slot``, ops/dcn.py:140-189; its
    ``_deform_conv2d_onehot`` below 4096 pixels is the same function):
    for tap t at (i - 1, j - 1) the absolute float32 position
    py = (y + i - 1) + dy, clipped to [-1, h] (px likewise to [-1, w]),
    y0 = floor(py), fy = py - y0; the corner weights
    ((1 - fy) * (1 - fx)) * m, ((1 - fy) * fx) * m, (fy * (1 - fx)) * m,
    (fy * fx) * m; corners outside the map read 0; the four corners
    summed in float32, the sum contracted with the tap's (Cin, Cout)
    weight and accumulated over the taps in float32; the bias added in
    float32.

    At bfloat16 it computes in float32 on the bf16 values, rounds the
    masked sample to bf16 before the contraction and the result to bf16
    at the end, where slot rounds. Autograd through it is JAX's vjp of
    slot and onehot: floor has derivative 0, the position's clip 1
    inside, 1/2 at a tie and 0 outside (``_ClipPos``), and the bf16
    rounding of the sample passes the gradient through
    (``_RoundBF16``). The oracle of ``dcn_exact_fwd[_bf16]``."""
    low = x.dtype == torch.bfloat16
    if low:
        x, offset, mask, weight = (t.float() for t in (x, offset, mask,
                                                       weight))
        bias = None if bias is None else bias.float()
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    wp = w + 3
    # padded by one row/column before and two after: every clipped
    # position's 2x2 corners lie inside, the ring reading zeros
    xp = F.pad(x, (0, 0, 1, 2, 1, 2)).reshape(b * (h + 3) * wp, cin)
    image = (torch.arange(b, device=x.device) * ((h + 3) * wp)).view(b, 1, 1)
    rows = torch.arange(h, device=x.device, dtype=torch.float32).view(1, h, 1)
    cols = torch.arange(w, device=x.device, dtype=torch.float32).view(1, 1, w)
    out = x.new_zeros((b * h * w, cout))
    for i in range(3):
        for j in range(3):
            t = 3 * i + j
            py = _ClipPos.apply((rows + (i - 1)) + offset[..., 2 * t], h)
            px = _ClipPos.apply((cols + (j - 1)) + offset[..., 2 * t + 1], w)
            y0 = torch.floor(py).detach()
            x0 = torch.floor(px).detach()
            fy = py - y0
            fx = px - x0
            m = mask[..., t]
            corner = ((y0.long() + 1) * wp + x0.long() + 1 + image).reshape(-1)
            sampled = None
            for dq, cw in ((0, ((1 - fy) * (1 - fx)) * m),
                           (1, ((1 - fy) * fx) * m),
                           (wp, (fy * (1 - fx)) * m),
                           (wp + 1, (fy * fx) * m)):
                term = xp.index_select(0, corner + dq) * cw.reshape(-1, 1)
                sampled = term if sampled is None else sampled + term
            if low:
                sampled = _RoundBF16.apply(sampled)
            out = out + sampled @ weight[i, j]
    if bias is not None:
        out = out + bias
    out = out.reshape(b, h, w, cout)
    return out.to(torch.bfloat16) if low else out
