#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (centertrack_tpu_torch) on one
NVIDIA GPU: `python3 chip_smoke.py` from the root of a checkout.

Phases, each printing one JSON line with its elapsed seconds:

  device   the card's name and power limit (nvidia-smi); fails without CUDA
  build    nvcc builds of the port's kernel sources (csrc/dcn_local.cu,
           csrc/dcn_local_bwd.cu, csrc/dcn_local_bf16.cu,
           csrc/dcn_local_bwd_bf16.cu, csrc/probes.cu) into build/, all
           started together
  probes   the 13 toolchain-probe kernels of csrc/probes.cu (the JAX
           package's tools/pallas_probe.py P0-P6 and pallas_probe2.py
           P10-P15) against their plain versions on seeded and on
           all-ones inputs, one launch counted per call, with kernel,
           plain and library times, the bound and an empty kernel's
           launch; then the two ported probe tools' main on the card,
           each probe kernel launching once and P7/P8 launching
           dcn_local_fwd_bf16
  kernel   dcn_local_fwd and dcn_local_fwd_bf16 against their plain
           PyTorch versions at the seven DLA-34 neck shapes of the
           544x960 path (R=1) and one R=2 case, and the bf16 kernel also
           at one R=3 case, every neck shape at B=8 and one ragged shape
           (17x30, 72->40), with kernel, device (queued behind a spin
           kernel), plain and cuDNN-3x3 times, the H100 bound and, at
           bf16, the launch plan (tile, N tile, splits, blocks, shared
           memory)
  grad     dcn_local_bwd_data and dcn_local_bwd_weight (through the
           autograd function) against autograd of the plain version, at
           the same shapes, on random offsets (some past +/-R) and on
           all-zero offsets (the kinks), with kernel, plain and bound times
  grad_bf16  dcn_local_bwd_data_bf16 and dcn_local_bwd_weight_bf16
           against autograd of the plain bf16 version at the bf16
           forward's cases and the same offsets, every element within the
           bf16 forward's tolerance, with kernel, device, plain and bound
           times and the data kernel's launch plan
  path     the port's FusedDetector (DLA-34 dcn_local1, 544x960, the
           committed assets/selftest_local1_fp16.ckpt weights) over 30
           synthetic 1080p frames, every frame fetched; the forward kernel
           must launch exactly 16 times per frame; the first 3 frames are
           then re-run with the DCN on its plain version and must agree
  path_bf16  the same 30 frames, checkpoint and detector at
           compute_dtype="bfloat16": dcn_local_fwd_bf16 must launch
           exactly 16 times per frame and no float32 DCN kernel at all;
           the first 3 frames re-run with the plain bf16 DCN must agree;
           the rows are compared with the float32 path's
  train    the port's Trainer on the same model and checkpoint at
           544x960, B=8, Adam: 12 steps on one fixed batch built from 9
           consecutive synthetic frames; the loss must be finite and fall,
           and each DCN kernel must launch 16 times per step; a 13th step
           in which every one of the 48 launches is held against the
           plain version on its own inputs; then one B=1 step with the
           kernels (its launches held the same way) and one with the DCN
           on its plain version, whose gradients must agree
  train_bf16  the same at compute_dtype="bfloat16": each bf16 DCN kernel
           (forward, bwd data, bwd weight) launches 16 times per step and
           no float32 one; every launch of a 13th step is held against
           the plain bf16 version; the B=1 kernel step's gradients must
           lie no further from a plain bf16 step's than twice that
           step's distance from a plain float32 step
  kernels  one JSON line: the port's kernel table

`--profile N` adds a phase after `path`, one after `path_bf16` and one
after the timed steps of `train` and of `train_bf16`: torch.profiler
over N frames (of each path) and over N B=8 steps (of each dtype),
device time by kernel and the device's idle share.

The last line is {"ok": true, "device": {...}}. Any failure raises and
the exit code is not 0. The whole run has a wall-clock budget.
"""

import contextlib
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from centertrack_tpu_torch.config import Config, MOT_META, parse_task, \
    set_heads
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models.model import create_model, \
    params_from_jax, set_dcn_plain
from centertrack_tpu_torch.ops import _build, dcn, probes
from centertrack_tpu_torch.ops.affine import get_affine_transform, \
    invert_affine
from centertrack_tpu_torch.ops.gaussian import gaussian_radius
from centertrack_tpu_torch.ops.warp import preprocess_frame
from centertrack_tpu_torch.tools import pallas_probe, pallas_probe2
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
BUDGET_S = 1100
T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# (map, H, W, Cin, Cout, launches per frame, layers) at 544x960, R=1
NECK_SHAPES = [
    ("s4", 136, 240, 64, 64, 5, "ida_2 node_1..3, ida_up node_1..2"),
    ("s8", 68, 120, 128, 128, 2, "ida_1 node_1..2"),
    ("s8", 68, 120, 128, 64, 4, "ida_2 proj_1..3, ida_up proj_1"),
    ("s16", 34, 60, 256, 256, 1, "ida_0 node_1"),
    ("s16", 34, 60, 256, 128, 2, "ida_1 proj_1..2"),
    ("s16", 34, 60, 256, 64, 1, "ida_up proj_2"),
    ("s32", 17, 30, 512, 256, 1, "ida_0 proj_1"),
]
REL_TOL = 1e-4   # fp32; only the summation order differs
# bf16 kernel against the plain bf16 version: the same bf16 sample, the
# float32 sum in another order, one rounding to bf16, so an element may
# flip by an ulp; elements that cancel to near zero carry the sums'
# float32 error, a small share of the largest output. Each element:
# |kernel - plain| <= BF16_ULPS ulps of |plain| + BF16_REL_OF_MAX max|plain|
BF16_ULPS = 2
BF16_REL_OF_MAX = 1e-3
# fp32; grad x is summed with atomics, in an order that changes per run
GRAD_REL_TOL = 1e-4
PATH_FRAMES = 30
PATH_WARMUP = 5
PLAIN_FRAMES = 3
SOURCES = ("dcn_local", "dcn_local_bwd", "dcn_local_bf16",
           "dcn_local_bwd_bf16", "probes")
# the forward kernel each compute dtype's serving path launches
PATH_KERNEL = {"float32": "dcn_local_fwd", "bfloat16": "dcn_local_fwd_bf16"}
# the kernel path's rows against the plain-DCN path's over PLAIN_FRAMES
# frames: the same track ids and scores within this. float32: both
# forwards agree to ~1e-6; bf16: a kernel launch may flip single
# outputs by an ulp, and later bf16 layers carry that on
PLAIN_SCORE_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# two paths' rows are the same detection when their centres lie within
# one output pixel of the 544x960 path on a 1080p frame
MATCH_PX = 8.0
TRAIN_B = 8
TRAIN_STEPS = 12
TRAIN_TIMED = slice(2, None)    # steps 3-12
TRAIN_LR = 1.25e-4
TRAIN_MAX_OBJS = 16
# kernel vs plain DCN gradients of one B=1 step from the checkpoint.
# Each kernel launch of that step and of a 13th B=8 step is held against
# the plain version on its own inputs at REL_TOL / GRAD_REL_TOL. The
# whole step's gradients differ more, because the two forwards round
# differently (floor-based vs hat-sum bilinear, ~1e-6) and this step's
# gradients are that sensitive: nudging the plain step's image by 1e-6
# (relative) moves them about as far as the kernels do (PERF.md, PR 5).
# So: relative L2 over all gradients <= 1e-2, and per tensor
# max|kernel - plain| <= 0.1 max|plain tensor| + 1e-5 max|any gradient|.
PLAIN_GRAD_L2_TOL = 1e-2
PLAIN_GRAD_TENSOR_RTOL = 0.1
PLAIN_GRAD_FLOOR = 1e-5
# bf16: the B=1 kernel step against the plain bf16 step. Both are bf16
# steps that differ only in where the DCN layers' float32 sums fall
# before their roundings, so each lies about as far from the plain
# float32 step (distance d, measured in the same run) as the other;
# two such steps with independent rounding errors are about sqrt(2) d
# apart. Tolerance: relative L2 over all gradients <= 2 d.
BF16_GRAD_L2_OF_FP32_DIST = 2.0


def emit(phase, **kw):
    print(json.dumps({"phase": phase,
                      "t_s": round(time.perf_counter() - T0, 3), **kw}),
          flush=True)


def synth_clip(n, height=1080, width=1920, n_obj=10, seed=0):
    """Deterministic 1080p clip in the committed checkpoints' training
    domain: moving filled rectangles with center dots on a noisy gray
    background, sized so the 1080p -> 544x960 warp lands them at the
    16-30 x 12-22 px scale the checkpoints were trained on (the same
    generator as the JAX package's bench.py). Returns the frames and,
    per frame, each object's drawn box (n, n_obj, 4) as x1, y1, x2, y2
    in pixels; object o keeps index o (its track id) in every frame."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform([0, 0], [width - 120, height - 90], (n_obj, 2))
    vel = rng.uniform(-4, 4, (n_obj, 2))
    size = rng.uniform([32, 24], [60, 44], (n_obj, 2))
    colors = rng.randint(40, 220, (n_obj, 3))
    frames = []
    boxes = np.zeros((n, n_obj, 4), np.float32)
    for f in range(n):
        img = rng.randint(180, 220, (height, width, 3), np.uint8)
        for o in range(n_obj):
            x, y = pos[o] + vel[o] * f
            w, h = size[o]
            x = int(np.clip(x, 0, width - w))
            y = int(np.clip(y, 0, height - h))
            img[y:y + int(h), x:x + int(w)] = colors[o]
            boxes[f, o] = (x, y, x + int(w), y + int(h))
            cy, cx = y + int(h) // 2, x + int(w) // 2
            img[max(0, cy - 3):cy + 3, max(0, cx - 3):cx + 3] = 255
        frames.append(img)
    return frames, boxes


def synth_frames(n, height=1080, width=1920, n_obj=10, seed=0):
    """The frames of ``synth_clip``."""
    return synth_clip(n, height, width, n_obj, seed)[0]


def time_ms(fn, warmup, iters):
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound_ms(ops, nbytes):
    """Least H100 time for `ops` fp32 operations and `nbytes` of memory
    traffic: the larger of the two over their peaks, and which it is."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dcn_bound_ms(n, cin, cout):
    """Least H100 time for one clamped-DCN call: the larger of its fp32
    operations over the fp32 peak and its bytes (each input read once,
    the output written once) over the memory rate."""
    ops = 2.0 * n * 9 * cin * cout + 8.0 * n * 9 * cin  # contraction + bilinear
    nbytes = 4.0 * (n * cin + n * 27 + 9 * cin * cout + cout + n * cout)
    return _bound_ms(ops, nbytes)


def dcn_bound_ms_bf16(n, cin, cout):
    """Least H100 time for one bf16 clamped-DCN call: the contraction at
    the dense bf16 tensor-core peak plus the bilinear sampling (in
    float32) at the fp32 peak, against its bf16 bytes (each input read
    once, the output written once) over the memory rate; the larger, and
    which it is."""
    t_ops = (2.0 * n * 9 * cin * cout / PEAK_BF16_FLOPS
             + 8.0 * n * 9 * cin / PEAK_FP32_FLOPS)
    t_bytes = 2.0 * (n * cin + n * 27 + 9 * cin * cout + cout
                     + n * cout) / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bf16_ulp(t):
    """One bf16 ulp at each |t| (2^(e - 7) for |t| in [2^e, 2^(e+1)))."""
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bf16_agreement(out, ref):
    """(max abs err, elements more than one ulp apart, elements past the
    BF16_ULPS / BF16_REL_OF_MAX tolerance) of a bf16 result against its
    plain version."""
    err = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref)
    tol = BF16_ULPS * ulp + BF16_REL_OF_MAX * ref.float().abs().max()
    return (err.max().item(), int((err > ulp).sum()),
            int((err > tol).sum()))


def dcn_bwd_bound_ms(n, cin, cout):
    """Least H100 times of the two backward kernels, each ((ms, by)).

    bwd_data: the G contraction (2 n 9 Cin Cout) plus, per pixel, tap
    and channel, the sample and its two offset derivatives over the 2x2
    support (3 x 4 FMAs), the scatter into grad x (4 FMAs) and the three
    reductions (3 FMAs): 38 n 9 Cin; it reads x, offset, mask, weight
    and the output grad and writes grad x, grad offset and grad mask.
    bwd_weight: the contraction (2 n 9 Cin Cout) plus the bilinear
    sample (8 n 9 Cin); it reads x, offset, mask and the output grad and
    writes grad weight. Counted for non-integer offsets (at an integer
    offset fewer corners are live and three shifts carry hat')."""
    data = _bound_ms(2.0 * n * 9 * cin * cout + 38.0 * n * 9 * cin,
                     4.0 * (2 * n * cin + 2 * n * 27 + 9 * cin * cout
                            + n * cout))
    weight = _bound_ms(2.0 * n * 9 * cin * cout + 8.0 * n * 9 * cin,
                       4.0 * (n * cin + n * 27 + n * cout + 9 * cin * cout))
    return data, weight


def dcn_bwd_bound_ms_bf16(n, cin, cout):
    """Least H100 times of the two bf16 backward kernels, each ((ms,
    by)): the operations of ``dcn_bwd_bound_ms``, the contraction at the
    dense bf16 tensor-core peak and the bilinear work at the fp32 peak,
    against their bf16 bytes (each input read once, each output written
    once) over the memory rate; the larger, and which it is."""
    def bound(contraction, bilinear, elems):
        t_ops = contraction / PEAK_BF16_FLOPS + bilinear / PEAK_FP32_FLOPS
        t_bytes = 2.0 * elems / PEAK_BYTES_S
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                           else "bytes")
    contraction = 2.0 * n * 9 * cin * cout
    data = bound(contraction, 38.0 * n * 9 * cin,
                 2 * n * cin + 2 * n * 27 + 9 * cin * cout + n * cout)
    weight = bound(contraction, 8.0 * n * 9 * cin,
                   n * cin + n * 27 + n * cout + 9 * cin * cout)
    return data, weight


# the DCN kernels a training step launches, by compute dtype, and the
# _RecordLaunches kinds that record them
TRAIN_KERNELS = {
    "float32": ("dcn_local_fwd", "dcn_local_bwd_data",
                "dcn_local_bwd_weight"),
    "bfloat16": ("dcn_local_fwd_bf16", "dcn_local_bwd_data_bf16",
                 "dcn_local_bwd_weight_bf16")}
TRAIN_KINDS = {"float32": ("fwd", "data", "weight"),
               "bfloat16": ("bf16", "data_bf16", "weight_bf16")}


def _launches():
    return {"dcn_local_fwd": dcn.LAUNCHES,
            "dcn_local_bwd_data": dcn.BWD_DATA_LAUNCHES,
            "dcn_local_bwd_weight": dcn.BWD_WEIGHT_LAUNCHES,
            "dcn_local_fwd_bf16": dcn.BF16_LAUNCHES,
            "dcn_local_bwd_data_bf16": dcn.BWD_DATA_BF16_LAUNCHES,
            "dcn_local_bwd_weight_bf16": dcn.BWD_WEIGHT_BF16_LAUNCHES}


def _reset_launches():
    dcn.LAUNCHES = dcn.BWD_DATA_LAUNCHES = dcn.BWD_WEIGHT_LAUNCHES = 0
    dcn.BF16_LAUNCHES = 0
    dcn.BWD_DATA_BF16_LAUNCHES = dcn.BWD_WEIGHT_BF16_LAUNCHES = 0


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=10, check=True).stdout.strip()
    print(smi, flush=True)
    # full fp32 everywhere: the kernel, its plain version and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


def phase_build():
    """One nvcc per source, all started together."""
    t = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    libs = {}
    for name, path in paths.items():
        info = _build.build_info[name]
        libs[name] = {
            "nvcc_seconds": round(info["seconds"], 3),
            "library": os.path.relpath(path, ROOT),
            "ptxas": [ln.strip() for ln in info["log"].splitlines()
                      if "registers" in ln or "smem" in ln or "spill" in ln]}
    emit("build", seconds=round(time.perf_counter() - t, 3), libraries=libs)


# ---- the toolchain probes (csrc/probes.cu) ---------------------------

PROBE_SEED = 8
PROBE_ITERS = 100
# a spin kernel of this many cycles (about 1 ms) before each timed call,
# so that the call is queued on the device before its start event runs
# and the events time the device, not the host's launch
PROBE_SPIN_CYCLES = 2_000_000
_PROBE1 = "centertrack_tpu/tools/pallas_probe.py:"
_PROBE2 = "centertrack_tpu/tools/pallas_probe2.py:"
PROBE_REPLACES = {
    "p0_copy": _PROBE1 + "44", "p1_fma12": _PROBE1 + "64",
    "p2_fma30": _PROBE1 + "64", "p3_tap_loop": _PROBE1 + "107",
    "p4_sublane_slice": _PROBE1 + "118", "p5_lane_slice": _PROBE1 + "128",
    "p6_gather": _PROBE1 + "139", "p10_aligned": _PROBE2 + "48",
    "p11_leading_offset": _PROBE2 + "69",
    "p12_sublane_offset": _PROBE2 + "90", "p13_value_slice": _PROBE2 + "113",
    "p14_4d_leading": _PROBE2 + "137", "p15_dynamic_leading": _PROBE2 + "161"}
_WINDOW_OUT = probes.RT * probes.CT * probes.C
# float32 operations of one probe call (P6, a gather, has none): P1/P2
# n multiply-adds per output and the identity product; P3 per pixel 9
# taps x (9 hat products + 64 channels x (9 multiply-adds + the mask)),
# and the 9 (64 x 64) contractions; P10-P15 one operation per term and
# output element (P15: program 1's three terms, the output's)
PROBE_OPS = {
    "p0_copy": 16 * 128, "p1_fma12": 2 * 12 * 2048 + 2 * 16 * 128 * 128,
    "p2_fma30": 2 * 30 * 2048 + 2 * 16 * 128 * 128,
    "p3_tap_loop": 1024 * (9 * (9 + 64 * 19) + 2 * 9 * 64 * 64),
    "p4_sublane_slice": 8 * 128 * 8, "p5_lane_slice": 16 * 128,
    "p6_gather": 0, "p10_aligned": _WINDOW_OUT,
    "p11_leading_offset": 3 * _WINDOW_OUT,
    "p12_sublane_offset": 3 * _WINDOW_OUT,
    "p13_value_slice": 3 * _WINDOW_OUT, "p14_4d_leading": 15 * _WINDOW_OUT,
    "p15_dynamic_leading": 3 * _WINDOW_OUT}


def probe_reads(name, inputs):
    """Masks of the input elements that probe ``name``'s output depends
    on: P3's stack only the slabs its clamped shift index reaches, P4's
    and P5's the union of their two slices, P6's table the rows its
    valid indices select, P10-P15 the union of their windows (P15's:
    program 1's, the output's); all of every other input (P1/P2's 12
    and 30 terms cycle over all 8 slabs)."""
    masks = [torch.ones(t.shape, dtype=torch.bool) for t in inputs]
    if name in ("p0_copy", "p1_fma12", "p2_fma30"):
        return masks
    first = masks[0]
    first.zero_()
    if name in probes.WINDOWS:
        window = first[0] if first.dim() == 5 else first
        for s, r, c in probes.WINDOWS[name]:
            window[s, r:r + probes.RT, c:c + probes.CT] = True
    elif name == "p3_tap_loop":
        first[sorted({probes.p3_shift(t, a, b) for t in range(9)
                      for a in range(3) for b in range(3)})] = True
    elif name == "p4_sublane_slice":
        first[1:9] = first[3:11] = True
    elif name == "p5_lane_slice":
        first[:, 3:131] = first[:, 5:133] = True
    elif name == "p6_gather":
        rows = first.shape[0]
        idx = inputs[1].cpu().long()
        idx = torch.where(idx < 0, idx + rows, idx)
        first[idx[(idx >= 0) & (idx < rows)]] = True
    return masks


def probe_bound_ms(name, inputs):
    """Least H100 time of one call of probe ``name`` on ``inputs``: its
    float32 operations (PROBE_OPS) over the fp32 peak against its bytes
    over the memory rate, each input element the output depends on
    (``probe_reads``) read once and the output written once; the
    larger, and which it is."""
    nbytes = sum(int(m.sum()) * t.element_size()
                 for m, t in zip(probe_reads(name, inputs), inputs))
    shape, dtype = probes.SPECS[name][1:]
    nbytes += int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return _bound_ms(PROBE_OPS[name], nbytes)


def probe_agreement(name, out, ref):
    """Hold a probe's result against its plain version: P3 within
    BF16_ULPS ulps + BF16_REL_OF_MAX max|ref| per element (its
    contractions may sum in another order), every other probe bit for
    bit (P1/P2 keep the JAX probe's order of roundings; NaN rows of P6
    included). Raises on a mismatch; returns the max abs error (over
    finite elements) and whether the two are equal bit for bit."""
    if out.dtype != ref.dtype or out.shape != ref.shape:
        raise RuntimeError(f"probe {name}: {out.dtype} {tuple(out.shape)}, "
                           f"the plain version {ref.dtype} "
                           f"{tuple(ref.shape)}")
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    same = torch.equal(out.contiguous().view(bits[out.dtype]),
                       ref.contiguous().view(bits[ref.dtype]))
    both = torch.isfinite(out.float()) & torch.isfinite(ref.float())
    err = ((out.float() - ref.float()).abs()[both].max().item()
           if both.any() else 0.0)
    if name == "p3_tap_loop":
        _, _, past_tol = bf16_agreement(out, ref)
        ok, crit = not past_tol, f"{BF16_ULPS} ulps + {BF16_REL_OF_MAX} max"
    else:
        ok, crit = same, "bits"
    if not ok:
        raise RuntimeError(f"probe {name}: kernel and plain version differ "
                           f"(criterion {crit}; max abs err {err}, bit "
                           f"equal {same})")
    return {"max_abs_err": err, "bit_equal": same, "criterion": crit}


def queued_us(fn, iters=PROBE_ITERS, warmup=5):
    """Median device time of one call of ``fn`` in microseconds: each
    call waits behind a spin kernel, so its CUDA events bracket the
    device's work and not the host's launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        torch.cuda._sleep(PROBE_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return 1e3 * statistics.median(a.elapsed_time(b) for a, b in events)


def host_us(fn, iters=PROBE_ITERS):
    """Median host time of one call of ``fn`` and a synchronise, in
    microseconds: what one launch costs its caller end to end."""
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1e6 * statistics.median(times)


def _probe_library(name, inputs):
    """One PyTorch call computing the probe's function, or None."""
    x = inputs[0]
    return {
        "p0_copy": lambda: torch.mul(x, 2.0),
        "p4_sublane_slice": lambda: torch.add(x[1:9], x[3:11]),
        "p5_lane_slice": lambda: torch.add(x[:, 3:131], x[:, 5:133]),
        "p6_gather": lambda: torch.index_select(x, 0, inputs[1]),
        "p10_aligned": lambda: torch.mul(x[0, :8, :240], 2.0),
    }.get(name)


def phase_probes():
    """Each probe kernel against its plain version, timed; then the two
    probe tools' entry points with the launch counts set to 0 just
    before them and read just after."""
    rows = {}
    for name in probes.NAMES:
        cases = {"seeded": probes.seeded_inputs(name, PROBE_SEED, "cuda"),
                 "ones": probes.default_inputs(name, "cuda")}
        if name == "p6_gather":   # every index in range: the timed case
            table = cases["seeded"][0]
            cases["in_range"] = [table, torch.randint(
                0, table.shape[0], (256,), dtype=torch.int32,
                generator=torch.Generator().manual_seed(PROBE_SEED)
            ).to(table.device)]
        checks = {}
        for case, inputs in cases.items():
            before = probes.LAUNCHES[name]
            out = probes.run(name, *inputs)
            torch.cuda.synchronize()
            counted = probes.LAUNCHES[name] - before
            if counted != 1:
                raise RuntimeError(f"probe {name}: {counted} launches "
                                   f"counted for one call")
            checks[case] = probe_agreement(name, out,
                                           probes.PLAIN[name](*inputs))
        timed = cases["in_range" if name == "p6_gather" else "seeded"]
        library = _probe_library(name, timed)
        bound, bound_by = probe_bound_ms(name, timed)
        row = {"kernel": "probe_" + name,
               "replaces": PROBE_REPLACES[name], "checks": checks,
               "us": queued_us(lambda: probes.run(name, *timed)),
               "plain_us": queued_us(lambda: probes.PLAIN[name](*timed)),
               "library_us": library and queued_us(library),
               "host_us_per_call": host_us(
                   lambda: probes.run(name, *timed)),
               "bound_us": 1e3 * bound, "bound_by": bound_by}
        rows[name] = row
        emit("probe", **row)
    empty = {"us": queued_us(probes.launch_empty),
             "host_us_per_call": host_us(probes.launch_empty)}

    # the entry points: each probe kernel once, P7/P8 through the DCN
    for name in probes.NAMES:
        probes.LAUNCHES[name] = 0
    _reset_launches()
    text = {}
    for tool in (pallas_probe, pallas_probe2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = tool.main([])
        torch.cuda.synchronize()
        text[tool.__name__] = buf.getvalue()
        if rc:
            raise RuntimeError(f"{tool.__name__}.main failed on the card:\n"
                               f"{buf.getvalue()}")
    launches = dict(probes.LAUNCHES)
    dcn_launches = _launches()
    want_dcn = {k: 2 if k == "dcn_local_fwd_bf16" else 0
                for k in dcn_launches}
    if launches != dict.fromkeys(probes.NAMES, 1) or dcn_launches != \
            want_dcn:
        raise RuntimeError(f"probe tools' launches: {launches} and "
                           f"{dcn_launches}, expected one of each probe "
                           f"kernel and {want_dcn}")
    report = json.loads(text[pallas_probe.__name__].strip()
                        .splitlines()[-1])
    out2 = text[pallas_probe2.__name__]
    report.update(json.loads(out2[out2.index("{"):]))
    emit("probes", empty_kernel=empty, entry_points=report,
         launches=launches, dcn_launches=dcn_launches)
    return rows, launches, dcn_launches


def _cases():
    """The neck shapes at R=1 and one R=2 check."""
    return [(*s, 1) for s in NECK_SHAPES] + \
        [("s4", 136, 240, 64, 64, 0, "R=2 check", 2)]


def _conv3x3_ms(x, weight, bias):
    """One cuDNN 3x3 convolution of the DCN call's shape and dtype: a
    yardstick of a dense contraction there, used nowhere in the port."""
    xc = x.permute(0, 3, 1, 2)
    wc = weight.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return time_ms(lambda: torch.nn.functional.conv2d(
        xc, wc, bias, padding=1), 3, 20)


def phase_kernel():
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    rows = []
    for name, h, w, cin, cout, per_frame, layers, r in _cases():
        x = torch.randn(1, h, w, cin, generator=gen, device=dev)
        spread = r + 1.5   # offsets past +/-R exercise the clamp
        offset = (torch.rand(1, h, w, 18, generator=gen, device=dev) * 2
                  - 1) * spread
        mask = torch.rand(1, h, w, 9, generator=gen, device=dev)
        weight = torch.randn(3, 3, cin, cout, generator=gen,
                             device=dev) * 0.05
        bias = torch.randn(cout, generator=gen, device=dev)
        out = dcn.deform_conv2d_local(x, offset, mask, weight, bias, r)
        ref = dcn.deform_conv2d_local_plain(x, offset, mask, weight, bias, r)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"dcn_local_fwd {name} {cin}->{cout}: "
                               f"non-finite output")
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if err > REL_TOL * scale:
            raise RuntimeError(
                f"dcn_local_fwd {name} {cin}->{cout} R={r}: max abs err "
                f"{err} > {REL_TOL} * max|ref| {scale}")
        k_ms = time_ms(lambda: dcn.deform_conv2d_local(
            x, offset, mask, weight, bias, r), 3, 20)
        p_ms = time_ms(lambda: dcn.deform_conv2d_local_plain(
            x, offset, mask, weight, bias, r), 1, 5)
        conv_ms = _conv3x3_ms(x, weight, bias)
        bound, bound_by = dcn_bound_ms(h * w, cin, cout)
        row = {"map": name, "hw": [h, w], "cin": cin, "cout": cout, "R": r,
               "launches_per_frame": per_frame, "layers": layers,
               "max_abs_err": err, "max_abs_ref": scale,
               "rel_err": err / scale, "tol_rel": REL_TOL, "ms": k_ms,
               "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
               "library_ms": None,
               "conv3x3_cudnn_ms_other_function": conv_ms}
        rows.append(row)
        emit("kernel", **row)
    return rows


def _bf16_cases():
    """(map, B, H, W, Cin, Cout, launches per image, layers, R) of the
    bf16 kernels' checks: ``_cases()`` at B=1, one R=3 case (the data
    kernel's widest support walk, built for R up to 4), every neck shape
    at B=8 (the training step's batch) and one ragged shape, whose
    tiles, Cin chunk and N tile are all partly past the map."""
    return ([(n, 1, h, w, ci, co, k, lay, r)
             for n, h, w, ci, co, k, lay, r in _cases()]
            + [("s4", 1, 136, 240, 64, 64, 0, "R=3 check", 3)]
            + [(n, TRAIN_B, h, w, ci, co, k, lay, 1)
               for n, h, w, ci, co, k, lay in NECK_SHAPES]
            + [("ragged", 1, 17, 30, 72, 40, 0, "ragged check", 1)])


def bf16_dcn_inputs(gen, b, h, w, cin, cout, r):
    """Seeded bf16 inputs of one DCN call on the card: x, offset
    (spread past +/-R, so the clamp and the kinks run), mask, weight,
    bias and an output gradient."""
    def draw(f, *shape):
        return f(*shape, generator=gen, device="cuda")
    bf16 = torch.bfloat16
    return (draw(torch.randn, b, h, w, cin).to(bf16),
            ((draw(torch.rand, b, h, w, 18) * 2 - 1) * (r + 1.5)).to(bf16),
            draw(torch.rand, b, h, w, 9).to(bf16),
            (draw(torch.randn, 3, 3, cin, cout) * 0.05).to(bf16),
            draw(torch.randn, cout).to(bf16),
            draw(torch.randn, b, h, w, cout).to(bf16))


def _plan_row(plan):
    return {k: plan[k] for k in ("tile", "n_tile", "splits", "blocks",
                                 "smem_bytes") if k in plan}


def phase_kernel_bf16():
    """dcn_local_fwd_bf16 against the plain bf16 version on the same
    bf16 inputs, at the float32 kernel's cases, an R=3 case, every neck
    shape at B=8 and a ragged shape."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    rows = []
    for name, b, h, w, cin, cout, per_frame, layers, r in _bf16_cases():
        x, offset, mask, weight, bias, _ = bf16_dcn_inputs(
            gen, b, h, w, cin, cout, r)
        out = dcn.deform_conv2d_local(x, offset, mask, weight, bias, r)
        ref = dcn.deform_conv2d_local_plain(x, offset, mask, weight, bias, r)
        torch.cuda.synchronize()
        if out.dtype != bf16 or not torch.isfinite(out).all():
            raise RuntimeError(f"dcn_local_fwd_bf16 {name} {cin}->{cout}: "
                               f"{out.dtype} output, or not finite")
        err, past_ulp, past_tol = bf16_agreement(out, ref)
        if past_tol:
            raise RuntimeError(
                f"dcn_local_fwd_bf16 {name} B={b} {cin}->{cout} R={r}: "
                f"{past_tol} elements past {BF16_ULPS} ulps + "
                f"{BF16_REL_OF_MAX} max|ref| (max abs err {err})")
        ref_max = ref.float().abs().max().item()
        del ref
        k_ms = time_ms(lambda: dcn.deform_conv2d_local(
            x, offset, mask, weight, bias, r), 3, 20)
        device_ms = queued_us(lambda: dcn.deform_conv2d_local(
            x, offset, mask, weight, bias, r), 20) / 1e3
        p_ms = time_ms(lambda: dcn.deform_conv2d_local_plain(
            x, offset, mask, weight, bias, r), 1, 5)
        bound, bound_by = dcn_bound_ms_bf16(b * h * w, cin, cout)
        row = {"kernel": "dcn_local_fwd_bf16", "map": name, "batch": b,
               "hw": [h, w], "cin": cin, "cout": cout, "R": r,
               "launches_per_frame": per_frame, "layers": layers,
               "plan": _plan_row(dcn.fwd_bf16_plan(b, h, w, cin, cout, r)),
               "max_abs_err": err, "max_abs_ref": ref_max,
               "elements": out.numel(),
               "elements_past_1_ulp": past_ulp,
               "tol": {"ulps": BF16_ULPS, "of_max": BF16_REL_OF_MAX},
               "ms": k_ms, "device_ms": device_ms, "plain_ms": p_ms,
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
               "conv3x3_cudnn_ms_other_function": _conv3x3_ms(x, weight,
                                                              bias)}
        rows.append(row)
        emit("kernel", **row)
    return rows


def _rel_errs(got, ref, names):
    out = {}
    for name, a, b in zip(names, got, ref):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"non-finite kernel result {name}")
        err = (a - b).abs().max().item()
        out[name] = (err, err / max(b.abs().max().item(), 1e-30))
    return out


def phase_grad():
    """The backward kernels through DCNLocal against autograd of the
    plain version on the same inputs and output grad."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    names = ("x", "offset", "mask", "weight", "bias")
    rows = []
    for name, h, w, cin, cout, per_frame, layers, r in _cases():
        x = torch.randn(1, h, w, cin, generator=gen, device=dev)
        spread = r + 1.5
        offsets = {
            "random": (torch.rand(1, h, w, 18, generator=gen, device=dev)
                       * 2 - 1) * spread,
            "zero": torch.zeros(1, h, w, 18, device=dev)}
        mask = torch.rand(1, h, w, 9, generator=gen, device=dev)
        weight = torch.randn(3, 3, cin, cout, generator=gen,
                             device=dev) * 0.05
        bias = torch.randn(cout, generator=gen, device=dev)
        g = torch.randn(1, h, w, cout, generator=gen, device=dev)
        errs = {}
        for kind, offset in offsets.items():
            ins = [t.clone().requires_grad_() for t in
                   (x, offset, mask, weight, bias)]
            dcn.deform_conv2d_local(*ins, r).backward(g)
            pins = [t.clone().requires_grad_() for t in
                    (x, offset, mask, weight, bias)]
            dcn.deform_conv2d_local_plain(*pins, r).backward(g)
            torch.cuda.synchronize()
            errs[kind] = _rel_errs([t.grad for t in ins],
                                   [t.grad for t in pins], names)
            bad = {k: v for k, v in errs[kind].items()
                   if v[1] > GRAD_REL_TOL}
            if bad:
                raise RuntimeError(
                    f"DCN backward {name} {cin}->{cout} R={r} {kind} "
                    f"offsets: rel err {bad} > {GRAD_REL_TOL}")
        offset = offsets["random"]
        data_ms = time_ms(lambda: dcn.launch_bwd_data(
            x, offset, mask, weight, g, r), 3, 20)
        weight_ms = time_ms(lambda: dcn.launch_bwd_weight(
            x, offset, mask, g, cout, r), 3, 20)
        pins = [t.clone().requires_grad_() for t in
                (x, offset, mask, weight)]
        pout = dcn.deform_conv2d_local_plain(*pins, None, r)
        plain_data_ms = time_ms(lambda: torch.autograd.grad(
            pout, pins[:3], g, retain_graph=True), 1, 3)
        plain_weight_ms = time_ms(lambda: torch.autograd.grad(
            pout, pins[3:], g, retain_graph=True), 1, 3)
        del pout, pins
        (data_b, data_by), (weight_b, weight_by) = dcn_bwd_bound_ms(
            h * w, cin, cout)
        row = {"map": name, "hw": [h, w], "cin": cin, "cout": cout, "R": r,
               "launches_per_step_and_image": per_frame, "layers": layers,
               "data_max_abs_err": max(e[k][0] for e in errs.values()
                                       for k in ("x", "offset", "mask")),
               "weight_max_abs_err": max(e["weight"][0]
                                         for e in errs.values()),
               "rel_err": {kind: {k: v[1] for k, v in e.items()}
                           for kind, e in errs.items()},
               "tol_rel": GRAD_REL_TOL,
               "data_ms": data_ms, "data_plain_ms": plain_data_ms,
               "data_bound_ms": data_b, "data_bound_by": data_by,
               "weight_ms": weight_ms, "weight_plain_ms": plain_weight_ms,
               "weight_bound_ms": weight_b, "weight_bound_by": weight_by,
               "library_ms": None}
        rows.append(row)
        emit("grad", **row)
    return rows


def _bf16_grad_ref(x, offset, mask, weight, g, r):
    """Autograd of the plain bf16 version: bf16 grads of x, offset,
    mask and weight."""
    ts = [t.clone().requires_grad_() for t in (x, offset, mask, weight)]
    return torch.autograd.grad(dcn.deform_conv2d_local_plain(
        *ts, None, r), ts, g)


def phase_grad_bf16():
    """dcn_local_bwd_data_bf16 and dcn_local_bwd_weight_bf16 against
    autograd of the plain bf16 version on the same bf16 inputs and
    output grad, every element within BF16_ULPS ulps + BF16_REL_OF_MAX
    max|plain|, at random and all-zero offsets, at the forward's
    cases."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    names = ("x", "offset", "mask", "weight")
    rows = []
    for name, bsz, h, w, cin, cout, per_frame, layers, r in _bf16_cases():
        x, offset, mask, weight, _, g = bf16_dcn_inputs(
            gen, bsz, h, w, cin, cout, r)
        offsets = {"random": offset, "zero": torch.zeros_like(offset)}
        errs = {}
        for kind, offset in offsets.items():
            got = (*dcn.launch_bwd_data_bf16(x, offset, mask, weight, g, r),
                   dcn.launch_bwd_weight_bf16(x, offset, mask, g, cout, r))
            ref = _bf16_grad_ref(x, offset, mask, weight, g, r)
            torch.cuda.synchronize()
            errs[kind] = {}
            for n, a, b in zip(names, got, ref):
                if a.dtype != bf16 or not torch.isfinite(a).all():
                    raise RuntimeError(f"bf16 DCN backward {name} grad {n}: "
                                       f"{a.dtype}, or not finite")
                err, past_ulp, past_tol = bf16_agreement(a, b)
                if past_tol:
                    raise RuntimeError(
                        f"bf16 DCN backward {name} B={bsz} {cin}->{cout} "
                        f"R={r} {kind} offsets: grad {n}: {past_tol} elements "
                        f"past {BF16_ULPS} ulps + {BF16_REL_OF_MAX} "
                        f"max|plain| (max abs err {err})")
                errs[kind][n] = {"max_abs_err": err,
                                 "max_abs_ref": b.float().abs().max().item(),
                                 "elements_past_1_ulp": past_ulp,
                                 "elements": a.numel()}
        offset = offsets["random"]
        data_ms = time_ms(lambda: dcn.launch_bwd_data_bf16(
            x, offset, mask, weight, g, r), 3, 20)
        data_device_ms = queued_us(lambda: dcn.launch_bwd_data_bf16(
            x, offset, mask, weight, g, r), 20) / 1e3
        weight_ms = time_ms(lambda: dcn.launch_bwd_weight_bf16(
            x, offset, mask, g, cout, r), 3, 20)
        pins = [t.clone().requires_grad_() for t in
                (x, offset, mask, weight)]
        pout = dcn.deform_conv2d_local_plain(*pins, None, r)
        plain_data_ms = time_ms(lambda: torch.autograd.grad(
            pout, pins[:3], g, retain_graph=True), 1, 3)
        plain_weight_ms = time_ms(lambda: torch.autograd.grad(
            pout, pins[3:], g, retain_graph=True), 1, 3)
        del pout, pins
        (data_b, data_by), (weight_b, weight_by) = dcn_bwd_bound_ms_bf16(
            bsz * h * w, cin, cout)
        row = {"map": name, "batch": bsz, "hw": [h, w], "cin": cin,
               "cout": cout, "R": r,
               "launches_per_step_and_image": per_frame, "layers": layers,
               "data_plan": _plan_row(dcn.bwd_data_bf16_plan(
                   bsz, h, w, cin, cout, r)),
               "data_max_abs_err": max(e[k]["max_abs_err"]
                                       for e in errs.values()
                                       for k in names[:3]),
               "weight_max_abs_err": max(e["weight"]["max_abs_err"]
                                         for e in errs.values()),
               "agreement": errs,
               "tol": {"ulps": BF16_ULPS, "of_max": BF16_REL_OF_MAX},
               "data_ms": data_ms, "data_device_ms": data_device_ms,
               "data_plain_ms": plain_data_ms,
               "data_bound_ms": data_b, "data_bound_by": data_by,
               "weight_ms": weight_ms, "weight_plain_ms": plain_weight_ms,
               "weight_bound_ms": weight_b, "weight_bound_by": weight_by,
               "library_ms": None}
        rows.append(row)
        emit("grad_bf16", **row)
    return rows


def _kept_rows(packed, out_thresh, margin, collapse_ties):
    """The rows above ``out_thresh``, without those within ``margin`` of
    it; with ``collapse_ties``, a row whose score equals the previous
    row's is left out."""
    rows = [d for d in FusedDetector.fetch(torch.from_numpy(packed),
                                           out_thresh)
            if abs(d["score"] - out_thresh) > margin]
    if collapse_ties:
        rows = [d for i, d in enumerate(rows)
                if i == 0 or d["score"] != rows[i - 1]["score"]]
    return rows


def rows_against(packed, ref_packed, out_thresh, margin=0.0,
                 collapse_ties=False):
    """Per frame, the rows above ``out_thresh`` of one path against
    another's, each row paired with the nearest unpaired row of the
    other within MATCH_PX of its centre, in score order: the rows left
    unpaired, the largest score and box differences of the pairs, the
    pairs whose track ids are equal, and whether the ids map one to one
    over all frames (the other path may number its tracks otherwise).
    ``margin`` and ``collapse_ties`` as in ``_kept_rows``: at bf16 a
    score may land on either side of the threshold, and two
    neighbouring peaks whose bf16 logits tie exactly both pass the 3x3
    max-pool NMS."""
    counts, unpaired, pairs, same_ids = [], 0, 0, 0
    score, box, id_map = 0.0, 0.0, {}
    for a, b in zip(packed, ref_packed):
        ra = _kept_rows(a, out_thresh, margin, collapse_ties)
        rb = _kept_rows(b, out_thresh, margin, collapse_ties)
        counts.append([len(ra), len(rb)])
        free = list(rb)
        for da in ra:
            dist = [float(np.abs(da["ct"] - db["ct"]).max()) for db in free]
            if not dist or min(dist) > MATCH_PX:
                unpaired += 1
                continue
            db = free.pop(int(np.argmin(dist)))
            pairs += 1
            same_ids += da["tracking_id"] == db["tracking_id"]
            id_map.setdefault(da["tracking_id"], set()).add(
                db["tracking_id"])
            score = max(score, abs(da["score"] - db["score"]))
            box = max(box, float(np.abs(da["bbox"] - db["bbox"]).max()))
        unpaired += len(free)
    mapped = [next(iter(v)) for v in id_map.values() if len(v) == 1]
    return {"rows_per_frame": counts, "rows_unpaired": unpaired,
            "pairs": pairs, "pairs_same_track_id": same_ids,
            "track_ids_one_to_one": (len(mapped) == len(id_map) ==
                                     len(set(mapped))),
            "max_score_diff": score, "max_bbox_diff_px": box}


def phase_path(dtype="float32", ref_packed=None):
    """The serving path at ``dtype`` over PATH_FRAMES frames; with
    ``ref_packed`` (the float32 path's rows) its rows are compared with
    those. Returns (row, detector, frames, cfg, packed rows)."""
    phase = "path" if dtype == "float32" else "path_bf16"
    kernel = PATH_KERNEL[dtype]
    cfg = set_heads(parse_task(Config(
        task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
        max_age=3, dla_node="dcn_local1", compute_dtype=dtype)), MOT_META)
    params, batch_stats = load_jax_ckpt(CKPT)
    frames = synth_frames(PATH_FRAMES, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    det = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda")

    _reset_launches()
    times, n_dets, packed, states = [], [], [], []
    for f in frames:
        if len(states) < PLAIN_FRAMES:
            states.append((det.track_state, det.pre_images))
        t = time.perf_counter()
        res = det.run(f)
        items = FusedDetector.fetch(res, cfg.out_thresh)
        times.append(1e3 * (time.perf_counter() - t))
        n_dets.append(len(items))
        packed.append(res.cpu().numpy())
        if res.shape != (cfg.K, 13) or not torch.isfinite(res).all():
            raise RuntimeError(f"bad packed result {tuple(res.shape)}")
    counts = _launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = counts[kernel]
    live = int(det.track_state.valid.sum())
    want = {k: 16 * PATH_FRAMES if k == kernel else 0 for k in counts}
    if counts != want:
        raise RuntimeError(f"DCN launches over {PATH_FRAMES} frames at "
                           f"{dtype}: {counts}, expected {want}")
    if sum(n_dets) == 0:
        raise RuntimeError("no detection above out_thresh in any frame")

    # same frames, DCN on the plain PyTorch version. float32: from a
    # fresh state, the two paths must stay together. bf16: each frame
    # from the kernel path's own state before it, since one flipped ulp
    # can make two neighbouring peaks tie and add a track; and every
    # kernel launch of the first frame is held against the plain
    # version on its own inputs
    plain = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda",
                          plain_dcn=True)
    low = dtype != "float32"
    plain_times, plain_packed = [], []
    for i, f in enumerate(frames[:PLAIN_FRAMES]):
        if low:
            plain.track_state, plain.pre_images = states[i]
        t = time.perf_counter()
        res = plain.run(f)
        FusedDetector.fetch(res, cfg.out_thresh)
        plain_times.append(1e3 * (time.perf_counter() - t))
        plain_packed.append(res.cpu().numpy())
    launch_worst = None
    if low:
        det.track_state, det.pre_images = states[0]
        with _RecordLaunches(("bf16",)) as rec:
            det.run(frames[0])
        launch_worst = rec.check(16)["bf16"]
    margin = PLAIN_SCORE_TOL[dtype] if low else 0.0
    vs_plain = rows_against(packed[:PLAIN_FRAMES], plain_packed,
                            cfg.out_thresh, margin, collapse_ties=low)
    if vs_plain["rows_unpaired"] or not vs_plain["pairs"] or \
            vs_plain["pairs_same_track_id"] != vs_plain["pairs"]:
        raise RuntimeError(f"rows or track ids differ between the kernel "
                           f"and the plain DCN at {dtype}: {vs_plain}")
    if vs_plain["max_score_diff"] > PLAIN_SCORE_TOL[dtype]:
        raise RuntimeError(f"kernel vs plain DCN at {dtype}: score diff "
                           f"{vs_plain['max_score_diff']} > "
                           f"{PLAIN_SCORE_TOL[dtype]}")
    if _launches()[kernel] != launches + (16 if low else 0):
        raise RuntimeError("the plain-DCN run launched the kernel")
    row = {"compute_dtype": dtype, "kernel": kernel,
           "frames": PATH_FRAMES, "input": [cfg.input_h, cfg.input_w],
           "warp_precision": det.warp_precision,
           "ms_per_frame_median": statistics.median(times[PATH_WARMUP:]),
           "ms_per_frame_first": times[0],
           "dets_per_frame": n_dets, "live_tracks_end": live,
           "dcn_launches": launches,
           "plain_dcn_frames": PLAIN_FRAMES,
           "plain_dcn_ms_per_frame": plain_times,
           "plain_vs_kernel_max_score_diff": vs_plain["max_score_diff"],
           "plain_vs_kernel_max_bbox_diff_px": vs_plain["max_bbox_diff_px"],
           "plain_vs_kernel_score_tol": PLAIN_SCORE_TOL[dtype],
           "plain_vs_kernel_rows": vs_plain["rows_per_frame"],
           "plain_vs_kernel_pairs": vs_plain["pairs"],
           "first_frame_launch_worst_rel_err": launch_worst,
           "max_memory_allocated_mb": peak_mb}
    if ref_packed is not None:
        row["vs_float32_path"] = rows_against(
            packed, ref_packed, cfg.out_thresh, margin, collapse_ties=low)
    emit(phase, **row)
    return row, det, frames, cfg, packed


def _profile(run_once, n, phase, unit):
    """torch.profiler over n calls of run_once (each ends on the host):
    device time by kernel, the share of the wall time the device was
    busy, and the host operators with the most self CPU time (inflated
    by the profiler's own cost, but in the same proportion for both
    dtypes), per ``unit``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            run_once()
        wall_ms = 1e3 * (time.perf_counter() - t)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    emit(phase, **{unit + "s": n, f"wall_ms_per_{unit}": wall_ms / n,
                   f"device_busy_ms_per_{unit}": busy_ms / n,
                   "device_idle_share": 1 - busy_ms / wall_ms,
                   f"device_kernels_per_{unit}": sum(e.count
                                                     for e in events) / n,
                   "top": [{"name": e.key[:80],
                            f"calls_per_{unit}": e.count / n,
                            f"ms_per_{unit}":
                                e.self_device_time_total / 1e3 / n}
                           for e in top],
                   "host_top": [{"name": e.key[:80],
                                 f"calls_per_{unit}": e.count / n,
                                 f"self_cpu_ms_per_{unit}":
                                     e.self_cpu_time_total / 1e3 / n}
                                for e in host]})


def phase_profile(det, frames, cfg, n, phase="profile"):
    """torch.profiler over n steady frames: device time by kernel and
    the share of the wall time the device was busy."""
    det.reset_tracking()
    for f in frames[:3]:
        FusedDetector.fetch(det.run(f), cfg.out_thresh)
    steady = iter(frames[3:3 + n])
    _profile(lambda: FusedDetector.fetch(det.run(next(steady)),
                                         cfg.out_thresh),
             n, phase, "frame")


class _RecordLaunches:
    """While active, keeps a copy of the inputs and outputs of every
    launch of the DCN kernels of ``kinds`` (the three float32 kernels by
    default; "bf16", "data_bf16" and "weight_bf16" are the bf16 ones),
    to hold each against the plain version on the same inputs
    afterwards (``check``)."""

    ALL = {"fwd": "launch_fwd", "data": "launch_bwd_data",
           "weight": "launch_bwd_weight", "bf16": "launch_fwd_bf16",
           "data_bf16": "launch_bwd_data_bf16",
           "weight_bf16": "launch_bwd_weight_bf16"}

    def __init__(self, kinds=("fwd", "data", "weight")):
        self.LAUNCHERS = {k: self.ALL[k] for k in kinds}

    def __enter__(self):
        self.calls = []
        self._saved = {k: getattr(dcn, f) for k, f in self.LAUNCHERS.items()}

        def recording(kind, launch):
            def run(*args):
                out = launch(*args)
                outs = out if isinstance(out, tuple) else (out,)
                self.calls.append((kind, [a.clone() if torch.is_tensor(a)
                                          else a for a in args],
                                   [t.clone() for t in outs]))
                return out
            return run

        for kind, f in self.LAUNCHERS.items():
            setattr(dcn, f, recording(kind, self._saved[kind]))
        return self

    def __exit__(self, *exc):
        for kind, f in self.LAUNCHERS.items():
            setattr(dcn, f, self._saved[kind])

    def check(self, per_kind):
        """Requires ``per_kind`` recorded launches of each kernel and
        holds each against the plain version on its own inputs (forward
        at REL_TOL, backward at GRAD_REL_TOL, the bf16 kernels at
        BF16_ULPS ulps + BF16_REL_OF_MAX max|ref| per element). Returns
        the worst rel err (max abs err over max|ref|) per kernel."""
        counts = {k: sum(c[0] == k for c in self.calls)
                  for k in self.LAUNCHERS}
        if counts != {k: per_kind for k in self.LAUNCHERS}:
            raise RuntimeError(f"recorded DCN launches {counts}, expected "
                               f"{per_kind} of each kernel")
        worst = dict.fromkeys(self.LAUNCHERS, 0.0)
        for kind, args, outs in self.calls:
            if kind in ("bf16", "data_bf16", "weight_bf16"):
                if kind == "bf16":
                    with torch.no_grad():
                        ref = [dcn.deform_conv2d_local_plain(*args)]
                elif kind == "data_bf16":
                    ref = _bf16_grad_ref(*args)[:3]
                else:
                    x, offset, mask, g, cout, r = args
                    w = torch.zeros(3, 3, x.shape[3], cout, device=x.device,
                                    dtype=x.dtype)
                    ref = _bf16_grad_ref(x, offset, mask, w, g, r)[3:]
                for out, rf in zip(outs, ref):
                    err, _, past_tol = bf16_agreement(out, rf)
                    if past_tol:
                        raise RuntimeError(
                            f"{self.LAUNCHERS[kind]} on "
                            f"{tuple(args[0].shape)}: {past_tol} elements "
                            f"past the tolerance (max abs err {err})")
                    worst[kind] = max(worst[kind], err / max(
                        rf.float().abs().max().item(), 1e-30))
                continue
            if kind == "fwd":
                with torch.no_grad():
                    ref = [dcn.deform_conv2d_local_plain(*args)]
                names, tol = ("out",), REL_TOL
            elif kind == "data":
                x, offset, mask, weight, g, r = args
                ts = [t.clone().requires_grad_() for t in (x, offset, mask)]
                ref = torch.autograd.grad(dcn.deform_conv2d_local_plain(
                    *ts, weight, None, r), ts, g)
                names, tol = ("x", "offset", "mask"), GRAD_REL_TOL
            else:
                x, offset, mask, g, cout, r = args
                w = torch.zeros(3, 3, x.shape[3], cout, device=x.device,
                                requires_grad=True)
                ref = torch.autograd.grad(dcn.deform_conv2d_local_plain(
                    x, offset, mask, w, None, r), [w], g)
                names, tol = ("weight",), GRAD_REL_TOL
            for name, (err, rel) in _rel_errs(outs, ref, names).items():
                if rel > tol:
                    raise RuntimeError(
                        f"{self.LAUNCHERS[kind]} on {tuple(args[0].shape)} "
                        f"in a train step: {name} rel err {rel} > {tol}")
                worst[kind] = max(worst[kind], rel)
        return worst


def _boxes_to(boxes, trans, width, height):
    """(N, 4) boxes through a 2x3 affine, clipped to the map."""
    tl = boxes[:, :2] @ trans[:, :2].T + trans[:, 2]
    br = boxes[:, 2:] @ trans[:, :2].T + trans[:, 2]
    out = np.concatenate([tl, br], 1).astype(np.float32)
    out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0, width - 1)
    out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0, height - 1)
    return out


def _radius(box):
    """Reference radius max(0, int(gaussian_radius(ceil h, ceil w)))."""
    hw = torch.from_numpy(np.ceil(box[:, [3, 2]] - box[:, [1, 0]]))
    return torch.floor(gaussian_radius(hw[:, 0], hw[:, 1])).clamp(
        min=0).numpy().astype(np.int32)


def train_batch(cfg, frames, boxes, device):
    """The descriptor batch GenericDataset would emit (no augmentation)
    for the pairs (frame i -> frame i + 1): image = frame i + 1 and
    pre_img = frame i, both through the port's preprocess_frame; GT
    from the boxes of frame i + 1 at the output stride; pre_hm splats
    and tracking offsets from the boxes of frame i."""
    h0, w0 = frames[0].shape[:2]
    c = np.array([w0 / 2.0, h0 / 2.0], np.float32)
    s = max(h0, w0) * 1.0
    trans_in = get_affine_transform(c, s, 0, [cfg.input_w, cfg.input_h])
    trans_out = get_affine_transform(c, s, 0, [cfg.output_w, cfg.output_h])
    inv_in = torch.as_tensor(invert_affine(trans_in).astype(np.float32),
                             device=device)
    mean = torch.as_tensor(MOT_META.mean, device=device)
    std = torch.as_tensor(MOT_META.std, device=device)
    images = [preprocess_frame(torch.as_tensor(f).to(device), inv_in,
                               cfg.input_h, cfg.input_w, mean, std)[0]
              for f in frames]
    n, m = len(frames) - 1, TRAIN_MAX_OBJS
    out = {"image": torch.stack(images[1:]), "pre_img": torch.stack(
        images[:-1])}
    arrays = {
        "ind": np.zeros((n, m), np.int64), "cat": np.zeros((n, m), np.int64),
        "mask": np.zeros((n, m), np.float32),
        "hm_cts": np.zeros((n, m, 2), np.int32),
        "hm_radii": np.zeros((n, m), np.int32),
        "hm_valid": np.zeros((n, m), bool),
        "ignore_boxes": np.zeros((n, 1, 4), np.float32),
        "ignore_cat": np.zeros((n, 1), np.int32),
        "ignore_valid": np.zeros((n, 1), bool),
        "pre_cts_int": np.zeros((n, 2 * m, 2), np.int32),
        "pre_radii": np.zeros((n, 2 * m), np.int32),
        "pre_ks": np.zeros((n, 2 * m), np.float32),
        "pre_valid": np.zeros((n, 2 * m), bool)}
    for head in ("reg", "wh", "tracking"):
        arrays[head] = np.zeros((n, m, 2), np.float32)
        arrays[head + "_mask"] = np.zeros((n, m, 2), np.float32)
    for i in range(n):
        k = boxes.shape[1]
        ob = _boxes_to(boxes[i + 1], trans_out, cfg.output_w, cfg.output_h)
        wh = ob[:, 2:] - ob[:, :2]
        live = (wh > 0).all(1)
        ct = (ob[:, :2] + ob[:, 2:]) / 2
        ct_int = ct.astype(np.int32)
        pb = _boxes_to(boxes[i], trans_in, cfg.input_w, cfg.input_h)
        pre_live = ((pb[:, 2:] - pb[:, :2]) > 0).all(1)
        pre_ct = (pb[:, :2] + pb[:, 2:]) / 2
        arrays["ind"][i, :k] = ct_int[:, 1] * cfg.output_w + ct_int[:, 0]
        arrays["mask"][i, :k] = live
        arrays["hm_cts"][i, :k] = ct_int
        arrays["hm_radii"][i, :k] = _radius(ob)
        arrays["hm_valid"][i, :k] = live
        arrays["reg"][i, :k] = ct - ct_int
        arrays["wh"][i, :k] = wh
        arrays["tracking"][i, :k] = pre_ct / cfg.down_ratio - ct_int
        for head, ok in (("reg", live), ("wh", live),
                         ("tracking", live & pre_live)):
            arrays[head + "_mask"][i, :k] = ok[:, None]
        arrays["pre_cts_int"][i, :k] = pre_ct.astype(np.int32)
        arrays["pre_radii"][i, :k] = _radius(pb)
        arrays["pre_ks"][i, :k] = 1.0
        arrays["pre_valid"][i, :k] = pre_live
    out.update({k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
    return out


def _fresh_model(cfg, params, batch_stats, plain=False):
    model = create_model(cfg, "cuda")
    model.load_state_dict(params_from_jax(params, batch_stats), strict=True)
    set_dcn_plain(model, plain)
    return model


def _train_cfg(dtype):
    return set_heads(parse_task(Config(
        task="tracking", pre_hm=True, dla_node="dcn_local1",
        batch_size=TRAIN_B, lr=TRAIN_LR, compute_dtype=dtype)), MOT_META)


def _b1_step(cfg, params, batch_stats, one, plain, kinds=None):
    """One B=1 training step from the checkpoint, DCN on the kernels or
    on its plain version; with ``kinds`` every DCN launch is recorded
    and held against the plain version. Returns (the step's record, its
    gradients)."""
    model = _fresh_model(cfg, params, batch_stats, plain)
    t1 = Trainer(cfg, model, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    with _RecordLaunches(kinds or ()) as rec:
        t = time.perf_counter()
        loss = float(t1.train_step(one, TRAIN_LR)["tot"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
    rec_row = {"ms": ms, "loss": loss,
               "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
               "launches": {k: v - before[k]
                            for k, v in _launches().items()}}
    if kinds:
        rec_row["launch_worst_rel_err"] = rec.check(16)
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    if any(g.dtype != torch.float32 for g in grads.values()):
        raise RuntimeError("a float32 parameter got a non-float32 gradient")
    del t1, model, rec
    torch.cuda.empty_cache()
    return rec_row, grads


def _rel_l2(grads, ref):
    if set(grads) != set(ref):
        raise RuntimeError("two steps differ in which parameters get a "
                           "gradient")
    return (sum(((grads[n] - g) ** 2).sum().item() for n, g in ref.items())
            / sum((g ** 2).sum().item() for g in ref.values())) ** .5


def phase_train(n_profile=0, dtype="float32"):
    """``n_profile`` > 0 adds a torch.profiler pass over that many
    B=8 steps after the timed ones."""
    phase = "train" if dtype == "float32" else "train_bf16"
    low = dtype != "float32"
    cfg = _train_cfg(dtype)
    kernels, kinds = TRAIN_KERNELS[dtype], TRAIN_KINDS[dtype]
    params, batch_stats = load_jax_ckpt(CKPT)
    frames, boxes = synth_clip(TRAIN_B + 1, seed=1)
    batch = train_batch(cfg, frames, boxes, "cuda")
    trainer = Trainer(cfg, _fresh_model(cfg, params, batch_stats), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        step = trainer.train_step(batch, TRAIN_LR)
        losses.append({k: float(v) for k, v in step.items()})
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    counts = _launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    tot = [l["tot"] for l in losses]
    if not all(np.isfinite(v) for l in losses for v in l.values()):
        raise RuntimeError(f"non-finite training loss at {dtype}: {losses}")
    if not tot[-1] < tot[0]:
        raise RuntimeError(f"loss did not fall over {TRAIN_STEPS} steps at "
                           f"{dtype}: {tot}")
    want = {k: 16 * TRAIN_STEPS if k in kernels else 0 for k in counts}
    if counts != want:
        raise RuntimeError(f"DCN launches over {TRAIN_STEPS} steps at "
                           f"{dtype}: {counts}, expected {want}")
    if any(p.dtype != torch.float32 or (p.grad is not None and
                                        p.grad.dtype != torch.float32)
           for p in trainer.model.parameters()):
        raise RuntimeError("a parameter or its gradient is not float32")
    # one more B=8 step, every launch held against the plain version
    with _RecordLaunches(kinds) as rec:
        trainer.train_step(batch, TRAIN_LR)
    b8_worst = rec.check(16)
    del rec
    if n_profile:
        _profile(lambda: float(trainer.train_step(batch, TRAIN_LR)["tot"]),
                 n_profile, phase + "_profile", "step")
    del trainer
    torch.cuda.empty_cache()

    # one B=1 step from the checkpoint, kernels against the plain DCN
    one = {k: v[:1] for k, v in batch.items()}
    b1, grads = {}, {}
    b1["kernel"], grads["kernel"] = _b1_step(cfg, params, batch_stats, one,
                                             False, kinds)
    b1["plain"], grads["plain"] = _b1_step(cfg, params, batch_stats, one,
                                           True)
    if b1["kernel"]["launches"] != {k: 16 if k in kernels else 0
                                    for k in counts}:
        raise RuntimeError(f"DCN launches of the B=1 kernel step at "
                           f"{dtype}: {b1['kernel']['launches']}, expected "
                           f"16 of each of {kernels}")
    if any(b1["plain"]["launches"].values()):
        raise RuntimeError(f"the plain-DCN step launched kernels: "
                           f"{b1['plain']['launches']}")
    ref = grads["plain"]
    l2 = _rel_l2(grads["kernel"], ref)
    row = {"compute_dtype": dtype, "input": [cfg.input_h, cfg.input_w],
           "batch": TRAIN_B, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "optim": cfg.optim,
           "loss_tot": tot, "loss_first": losses[0], "loss_last": losses[-1],
           "ms_per_step": times,
           "ms_per_step_median_3_12": statistics.median(times[TRAIN_TIMED]),
           "img_per_s": TRAIN_B * 1e3 / statistics.median(
               times[TRAIN_TIMED]),
           "peak_memory_mb": peak_mb, "dcn_launches": counts,
           "dcn_launches_per_step": {k: v / TRAIN_STEPS
                                     for k, v in counts.items()},
           "b8_step13_launch_worst_rel_err": b8_worst,
           "b1_kernel_step": b1["kernel"], "b1_plain_step": b1["plain"],
           "b1_grad_tensors": len(ref), "b1_grad_rel_l2": l2}
    if low:
        # the yardstick: the plain bf16 step against the plain fp32 step
        b1["plain_fp32"], fp32 = _b1_step(_train_cfg("float32"), params,
                                          batch_stats, one, True)
        dist = _rel_l2(ref, fp32)
        tol = BF16_GRAD_L2_OF_FP32_DIST * dist
        if not l2 <= tol:
            raise RuntimeError(
                f"bf16 kernel vs plain DCN gradients: relative L2 {l2} > "
                f"{BF16_GRAD_L2_OF_FP32_DIST} x {dist} (the plain bf16 "
                f"step's distance from the plain float32 step)")
        row.update({"b1_plain_fp32_step": b1["plain_fp32"],
                    "b1_plain_bf16_vs_fp32_rel_l2": dist,
                    "b1_grad_tol": {"rel_l2": tol, "of_bf16_vs_fp32":
                                    BF16_GRAD_L2_OF_FP32_DIST}})
        emit(phase, **row)
        return row

    floor = PLAIN_GRAD_FLOOR * max(g.abs().max().item()
                                   for g in ref.values())
    shares = {}
    for n, g in ref.items():
        err = (grads["kernel"][n] - g).abs().max().item()
        tol = PLAIN_GRAD_TENSOR_RTOL * g.abs().max().item() + floor
        if not err <= tol:
            raise RuntimeError(f"kernel vs plain DCN gradient of {n}: max "
                               f"abs err {err} > {tol}")
        shares[n] = err / tol
    if not l2 <= PLAIN_GRAD_L2_TOL:
        raise RuntimeError(f"kernel vs plain DCN gradients: relative L2 "
                           f"{l2} > {PLAIN_GRAD_L2_TOL}")
    worst = max(shares, key=shares.get)
    row.update({"b1_grad_worst_tensor": worst,
                "b1_grad_worst_share_of_tol": shares[worst],
                "b1_grad_tol": {"rel_l2": PLAIN_GRAD_L2_TOL,
                                "tensor_rtol": PLAIN_GRAD_TENSOR_RTOL,
                                "floor_of_global_max": PLAIN_GRAD_FLOOR}})
    emit(phase, **row)
    return row


def _out_of_time(signum, frame):
    raise TimeoutError(f"chip_smoke exceeded its {BUDGET_S} s budget")


def main(argv):
    """``--profile N`` adds torch.profiler passes over N frames and N
    training steps."""
    n_profile = int(argv[argv.index("--profile") + 1]) \
        if "--profile" in argv else 0
    signal.signal(signal.SIGALRM, _out_of_time)
    signal.alarm(BUDGET_S)
    dev = phase_device()
    phase_build()
    probe_rows, probe_launches, probe_dcn_launches = phase_probes()
    rows = phase_kernel()
    bf16_rows = phase_kernel_bf16()
    grad_rows = phase_grad()
    grad_bf16_rows = phase_grad_bf16()
    path, det, frames, cfg, packed = phase_path()
    if n_profile:
        phase_profile(det, frames, cfg, n_profile)
    del det
    torch.cuda.empty_cache()
    path_bf16, det, frames, cfg, _ = phase_path("bfloat16", packed)
    if n_profile:
        phase_profile(det, frames, cfg, n_profile, "profile_bf16")
    del det
    torch.cuda.empty_cache()
    train = phase_train(n_profile)
    train_bf16 = phase_train(n_profile, "bfloat16")

    neck = [r for r in rows if r["launches_per_frame"]]
    per_frame = lambda key, rs=neck: sum(r[key] * r["launches_per_frame"]
                                         for r in rs)
    bf16_neck = [r for r in bf16_rows
                 if r["launches_per_frame"] and r["batch"] == 1]
    bf16_neck8 = [r for r in bf16_rows
                  if r["launches_per_frame"] and r["batch"] == TRAIN_B]
    gneck = [r for r in grad_rows if r["launches_per_step_and_image"]]
    gneck_bf16 = [r for r in grad_bf16_rows
                  if r["launches_per_step_and_image"] and r["batch"] == 1]
    gneck_bf16_8 = [r for r in grad_bf16_rows
                    if r["launches_per_step_and_image"]
                    and r["batch"] == TRAIN_B]
    per_image = lambda key, rs=gneck: sum(
        r[key] * r["launches_per_step_and_image"] for r in rs)
    bwd_replaces = "centertrack_tpu/ops/dcn_pallas_shift.py:161"
    bwd_also = ["centertrack_tpu/ops/dcn_pallas_halo.py:190"]
    launches = train["dcn_launches"]
    launches_bf16 = train_bf16["dcn_launches"]
    by_path = lambda name: {
        "serving": path["dcn_launches"] if name == "dcn_local_fwd" else 0,
        "serving_bf16": (path_bf16["dcn_launches"]
                         if name == "dcn_local_fwd_bf16" else 0),
        "train": launches[name], "train_bf16": launches_bf16[name],
        "probes": probe_dcn_launches[name]}
    kernels = [{
        "name": "dcn_local_fwd", "route": "cuda",
        "source": "centertrack_tpu_torch/csrc/dcn_local.cu",
        "replaces": "centertrack_tpu/ops/dcn_pallas.py:115",
        "also_replaces": ["centertrack_tpu/ops/dcn_pallas_grid.py:126",
                          "centertrack_tpu/ops/dcn_pallas_shift.py:110",
                          "centertrack_tpu/ops/dcn_pallas_halo.py:135"],
        "launches": launches["dcn_local_fwd"],
        "launches_by_path": by_path("dcn_local_fwd"),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "per": "one 544x960 frame: the 16 launches of the neck shapes",
        "ms": per_frame("ms"), "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in neck) else "bytes"),
        "library_ms": None,
    }, {
        "name": "dcn_local_fwd_bf16", "route": "cuda",
        "source": "centertrack_tpu_torch/csrc/dcn_local_bf16.cu",
        "replaces": "centertrack_tpu/ops/dcn_pallas.py:115",
        "also_replaces": ["centertrack_tpu/ops/dcn_pallas_grid.py:126",
                          "centertrack_tpu/ops/dcn_pallas_shift.py:110",
                          "centertrack_tpu/ops/dcn_pallas_halo.py:135"],
        "at": "bfloat16 inputs",
        "launches": path_bf16["dcn_launches"],
        "launches_by_path": by_path("dcn_local_fwd_bf16"),
        "max_abs_err": max(r["max_abs_err"] for r in bf16_rows),
        "per": "one 544x960 frame: the 16 launches of the neck shapes",
        "ms": per_frame("ms", bf16_neck),
        "ms_per_image_at_b8": per_frame("ms", bf16_neck8) / TRAIN_B,
        "plain_ms": per_frame("plain_ms", bf16_neck),
        "bound_ms": per_frame("bound_ms", bf16_neck),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in bf16_neck) else "bytes"),
        "library_ms": None,
    }]
    for kname, key, rows_, neck_, src, at, n in (
            ("dcn_local_bwd_data", "data", grad_rows, gneck,
             "dcn_local_bwd.cu", None, launches),
            ("dcn_local_bwd_weight", "weight", grad_rows, gneck,
             "dcn_local_bwd.cu", None, launches),
            ("dcn_local_bwd_data_bf16", "data", grad_bf16_rows, gneck_bf16,
             "dcn_local_bwd_bf16.cu", "bfloat16 inputs", launches_bf16),
            ("dcn_local_bwd_weight_bf16", "weight", grad_bf16_rows,
             gneck_bf16, "dcn_local_bwd_bf16.cu", "bfloat16 inputs",
             launches_bf16)):
        row = {
            "name": kname, "route": "cuda",
            "source": "centertrack_tpu_torch/csrc/" + src,
            "replaces": bwd_replaces, "also_replaces": bwd_also,
            "launches": n[kname],
            "launches_by_path": by_path(kname),
            "max_abs_err": max(r[key + "_max_abs_err"] for r in rows_),
            "per": "one 544x960 image of a training step: the 16 launches "
                   "of the neck shapes at B=1",
            "ms": per_image(key + "_ms", neck_),
            "plain_ms": per_image(key + "_plain_ms", neck_),
            "bound_ms": per_image(key + "_bound_ms", neck_),
            "bound_by": ("operations" if all(
                r[key + "_bound_by"] == "operations" for r in neck_)
                else "bytes"),
            "library_ms": None,
        }
        if at:
            row["at"] = at
            row["ms_per_image_at_b8"] = per_image(
                key + "_ms", gneck_bf16_8) / TRAIN_B
        kernels.append(row)
    for name, r in probe_rows.items():
        kernels.append({
            "name": r["kernel"], "route": "cuda",
            "source": "centertrack_tpu_torch/csrc/probes.cu",
            "replaces": r["replaces"],
            "launches": probe_launches[name],
            "launches_by_path": {"probes": probe_launches[name]},
            "max_abs_err": max(c["max_abs_err"]
                               for c in r["checks"].values()),
            "per": "one call of the probe",
            "ms": r["us"] / 1e3, "plain_ms": r["plain_us"] / 1e3,
            "bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"],
            "library_ms": (None if r["library_us"] is None
                           else r["library_us"] / 1e3),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=time.perf_counter() - T0, nvidia_smi=dev[
        "nvidia_smi"])
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
