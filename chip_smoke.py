#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (centertrack_tpu_torch) on one
NVIDIA GPU: `python3 chip_smoke.py` from the root of a checkout.

Phases, each printing one JSON line with its elapsed seconds:

  device   the card's name and power limit (nvidia-smi); fails without CUDA
  build    nvcc builds of the port's kernel sources (csrc/dcn_local.cu,
           csrc/dcn_local_bwd.cu) into build/, all started together
  kernel   dcn_local_fwd against its plain PyTorch version at the seven
           DLA-34 neck shapes of the 544x960 path (R=1) and one R=2 case,
           with kernel, plain and cuDNN-3x3 times and the H100 bound
  grad     dcn_local_bwd_data and dcn_local_bwd_weight (through the
           autograd function) against autograd of the plain version, at
           the same shapes, on random offsets (some past +/-R) and on
           all-zero offsets (the kinks), with kernel, plain and bound times
  path     the port's FusedDetector (DLA-34 dcn_local1, 544x960, the
           committed assets/selftest_local1_fp16.ckpt weights) over 30
           synthetic 1080p frames, every frame fetched; the forward kernel
           must launch exactly 16 times per frame; the first 3 frames are
           then re-run with the DCN on its plain version and must agree
  train    the port's Trainer on the same model and checkpoint at
           544x960, B=8, Adam: 12 steps on one fixed batch built from 9
           consecutive synthetic frames; the loss must be finite and fall,
           and each DCN kernel must launch 16 times per step; a 13th step
           in which every one of the 48 launches is held against the
           plain version on its own inputs; then one B=1 step with the
           kernels (its launches held the same way) and one with the DCN
           on its plain version, whose gradients must agree
  kernels  one JSON line: the port's kernel table

`--profile N` adds a phase after `path` and one after the timed steps of
`train`: torch.profiler over N frames and over N B=8 steps, device time
by kernel and the device's idle share.

The last line is {"ok": true, "device": {...}}. Any failure raises and
the exit code is not 0. The whole run has a wall-clock budget.
"""

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
from centertrack_tpu_torch.ops import _build, dcn
from centertrack_tpu_torch.ops.affine import get_affine_transform, \
    invert_affine
from centertrack_tpu_torch.ops.gaussian import gaussian_radius
from centertrack_tpu_torch.ops.warp import preprocess_frame
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
BUDGET_S = 1100
T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
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
# fp32; grad x is summed with atomics, in an order that changes per run
GRAD_REL_TOL = 1e-4
PATH_FRAMES = 30
PATH_WARMUP = 5
PLAIN_FRAMES = 3
SOURCES = ("dcn_local", "dcn_local_bwd")
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


def _launches():
    return {"dcn_local_fwd": dcn.LAUNCHES,
            "dcn_local_bwd_data": dcn.BWD_DATA_LAUNCHES,
            "dcn_local_bwd_weight": dcn.BWD_WEIGHT_LAUNCHES}


def _reset_launches():
    dcn.LAUNCHES = dcn.BWD_DATA_LAUNCHES = dcn.BWD_WEIGHT_LAUNCHES = 0


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


def _cases():
    """The neck shapes at R=1 and one R=2 check."""
    return [(*s, 1) for s in NECK_SHAPES] + \
        [("s4", 136, 240, 64, 64, 0, "R=2 check", 2)]


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
        xc = x.permute(0, 3, 1, 2)
        wc = weight.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        conv_ms = time_ms(lambda: torch.nn.functional.conv2d(
            xc, wc, bias, padding=1), 3, 20)
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


def phase_path():
    cfg = set_heads(parse_task(Config(
        task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
        max_age=3, dla_node="dcn_local1")), MOT_META)
    params, batch_stats = load_jax_ckpt(CKPT)
    frames = synth_frames(PATH_FRAMES, seed=0)
    det = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda")

    _reset_launches()
    times, n_dets, packed = [], [], []
    for f in frames:
        t = time.perf_counter()
        res = det.run(f)
        items = FusedDetector.fetch(res, cfg.out_thresh)
        times.append(1e3 * (time.perf_counter() - t))
        n_dets.append(len(items))
        if len(packed) < PLAIN_FRAMES:
            packed.append(res.cpu().numpy())
        if res.shape != (cfg.K, 13) or not torch.isfinite(res).all():
            raise RuntimeError(f"bad packed result {tuple(res.shape)}")
    counts = _launches()
    launches = counts["dcn_local_fwd"]
    live = int(det.track_state.valid.sum())
    if counts != {"dcn_local_fwd": 16 * PATH_FRAMES,
                  "dcn_local_bwd_data": 0, "dcn_local_bwd_weight": 0}:
        raise RuntimeError(f"DCN launches over {PATH_FRAMES} frames: "
                           f"{counts}, expected 16 forward per frame and "
                           f"no backward")
    if sum(n_dets) == 0:
        raise RuntimeError("no detection above out_thresh in any frame")

    # same frames, DCN on the plain PyTorch version, from a fresh state
    plain = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda",
                          plain_dcn=True)
    plain_times, worst_score, worst_box = [], 0.0, 0.0
    for i, f in enumerate(frames[:PLAIN_FRAMES]):
        t = time.perf_counter()
        a = FusedDetector.fetch(plain.run(f), cfg.out_thresh)
        plain_times.append(1e3 * (time.perf_counter() - t))
        b = FusedDetector.fetch(torch.from_numpy(packed[i]), cfg.out_thresh)
        if [d["tracking_id"] for d in a] != [d["tracking_id"] for d in b]:
            raise RuntimeError(f"frame {i}: track ids differ between the "
                               f"kernel and the plain DCN")
        for da, db in zip(a, b):
            worst_score = max(worst_score, abs(da["score"] - db["score"]))
            worst_box = max(worst_box,
                            float(np.abs(da["bbox"] - db["bbox"]).max()))
    if worst_score > 1e-3:
        raise RuntimeError(f"kernel vs plain DCN: score diff {worst_score}")
    if dcn.LAUNCHES != launches:
        raise RuntimeError("the plain-DCN run launched the kernel")
    row = {"frames": PATH_FRAMES, "input": [cfg.input_h, cfg.input_w],
           "ms_per_frame_median": statistics.median(times[PATH_WARMUP:]),
           "ms_per_frame_first": times[0],
           "dets_per_frame": n_dets, "live_tracks_end": live,
           "dcn_launches": launches,
           "plain_dcn_frames": PLAIN_FRAMES,
           "plain_dcn_ms_per_frame": plain_times,
           "plain_vs_kernel_max_score_diff": worst_score,
           "plain_vs_kernel_max_bbox_diff_px": worst_box,
           "max_memory_allocated_mb":
               torch.cuda.max_memory_allocated() / 2 ** 20}
    emit("path", **row)
    return row, det, frames, cfg


def _profile(run_once, n, phase, unit):
    """torch.profiler over n calls of run_once (each ends on the host):
    device time by kernel and the share of the wall time the device was
    busy, per ``unit``."""
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
    emit(phase, **{unit + "s": n, f"wall_ms_per_{unit}": wall_ms / n,
                   f"device_busy_ms_per_{unit}": busy_ms / n,
                   "device_idle_share": 1 - busy_ms / wall_ms,
                   f"device_kernels_per_{unit}": sum(e.count
                                                     for e in events) / n,
                   "top": [{"name": e.key[:80],
                            f"calls_per_{unit}": e.count / n,
                            f"ms_per_{unit}":
                                e.self_device_time_total / 1e3 / n}
                           for e in top]})


def phase_profile(det, frames, cfg, n):
    """torch.profiler over n steady frames: device time by kernel and
    the share of the wall time the device was busy."""
    det.reset_tracking()
    for f in frames[:3]:
        FusedDetector.fetch(det.run(f), cfg.out_thresh)
    steady = iter(frames[3:3 + n])
    _profile(lambda: FusedDetector.fetch(det.run(next(steady)),
                                         cfg.out_thresh),
             n, "profile", "frame")


class _RecordLaunches:
    """While active, keeps a copy of the inputs and outputs of every
    launch of the three DCN kernels, to hold each against the plain
    version on the same inputs afterwards (``check``)."""

    LAUNCHERS = {"fwd": "launch_fwd", "data": "launch_bwd_data",
                 "weight": "launch_bwd_weight"}

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
        at REL_TOL, backward at GRAD_REL_TOL). Returns the worst rel err
        per kernel."""
        counts = {k: sum(c[0] == k for c in self.calls)
                  for k in self.LAUNCHERS}
        if counts != {k: per_kind for k in self.LAUNCHERS}:
            raise RuntimeError(f"recorded DCN launches {counts}, expected "
                               f"{per_kind} of each kernel")
        worst = dict.fromkeys(self.LAUNCHERS, 0.0)
        for kind, args, outs in self.calls:
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


def phase_train(n_profile=0):
    """``n_profile`` > 0 adds a torch.profiler pass over that many
    B=8 steps after the timed ones."""
    cfg = set_heads(parse_task(Config(
        task="tracking", pre_hm=True, dla_node="dcn_local1",
        batch_size=TRAIN_B, lr=TRAIN_LR)), MOT_META)
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
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not tot[-1] < tot[0]:
        raise RuntimeError(f"loss did not fall over {TRAIN_STEPS} steps: "
                           f"{tot}")
    want = {k: 16 * TRAIN_STEPS for k in counts}
    if counts != want:
        raise RuntimeError(f"DCN launches over {TRAIN_STEPS} steps: "
                           f"{counts}, expected {want}")
    # one more B=8 step, every launch held against the plain version
    with _RecordLaunches() as rec:
        trainer.train_step(batch, TRAIN_LR)
    b8_worst = rec.check(16)
    del rec
    if n_profile:
        _profile(lambda: float(trainer.train_step(batch, TRAIN_LR)["tot"]),
                 n_profile, "train_profile", "step")
    del trainer
    torch.cuda.empty_cache()

    # one B=1 step from the checkpoint, kernels against the plain DCN
    one = {k: v[:1] for k, v in batch.items()}
    grads, b1 = {}, {}
    for key, plain in (("kernel", False), ("plain", True)):
        model = _fresh_model(cfg, params, batch_stats, plain)
        t1 = Trainer(cfg, model, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _launches()
        with _RecordLaunches() as rec:
            t = time.perf_counter()
            loss = float(t1.train_step(one, TRAIN_LR)["tot"])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        b1[key] = {"ms": ms, "loss": loss,
                   "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
                   "launches": {k: v - before[k]
                                for k, v in _launches().items()}}
        if not plain:
            b1[key]["launch_worst_rel_err"] = rec.check(16)
        grads[key] = {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None}
        del t1, model, rec
        torch.cuda.empty_cache()
    if b1["kernel"]["launches"] != {k: 16 for k in counts}:
        raise RuntimeError(f"DCN launches of the B=1 kernel step: "
                           f"{b1['kernel']['launches']}, expected 16 each")
    if any(b1["plain"]["launches"].values()):
        raise RuntimeError(f"the plain-DCN step launched kernels: "
                           f"{b1['plain']['launches']}")
    ref = grads["plain"]
    if set(grads["kernel"]) != set(ref):
        raise RuntimeError("kernel and plain steps differ in which "
                           "parameters get a gradient")

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
    l2 = (sum(((grads["kernel"][n] - g) ** 2).sum().item()
              for n, g in ref.items())
          / sum((g ** 2).sum().item() for g in ref.values())) ** .5
    if not l2 <= PLAIN_GRAD_L2_TOL:
        raise RuntimeError(f"kernel vs plain DCN gradients: relative L2 "
                           f"{l2} > {PLAIN_GRAD_L2_TOL}")
    worst = max(shares, key=shares.get)
    row = {"input": [cfg.input_h, cfg.input_w], "batch": TRAIN_B,
           "steps": TRAIN_STEPS, "lr": TRAIN_LR, "optim": cfg.optim,
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
           "b1_grad_tensors": len(ref), "b1_grad_rel_l2": l2,
           "b1_grad_worst_tensor": worst,
           "b1_grad_worst_share_of_tol": shares[worst],
           "b1_grad_tol": {"rel_l2": PLAIN_GRAD_L2_TOL,
                           "tensor_rtol": PLAIN_GRAD_TENSOR_RTOL,
                           "floor_of_global_max": PLAIN_GRAD_FLOOR}}
    emit("train", **row)
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
    rows = phase_kernel()
    grad_rows = phase_grad()
    path, det, frames, cfg = phase_path()
    if n_profile:
        phase_profile(det, frames, cfg, n_profile)
    del det
    torch.cuda.empty_cache()
    train = phase_train(n_profile)

    neck = [r for r in rows if r["launches_per_frame"]]
    per_frame = lambda key: sum(r[key] * r["launches_per_frame"]
                                for r in neck)
    gneck = [r for r in grad_rows if r["launches_per_step_and_image"]]
    per_image = lambda key: sum(r[key] * r["launches_per_step_and_image"]
                                for r in gneck)
    bwd_source = "centertrack_tpu_torch/csrc/dcn_local_bwd.cu"
    bwd_replaces = "centertrack_tpu/ops/dcn_pallas_shift.py:161"
    bwd_also = ["centertrack_tpu/ops/dcn_pallas_halo.py:190"]
    launches = train["dcn_launches"]
    kernels = [{
        "name": "dcn_local_fwd", "route": "cuda",
        "source": "centertrack_tpu_torch/csrc/dcn_local.cu",
        "replaces": "centertrack_tpu/ops/dcn_pallas.py:115",
        "also_replaces": ["centertrack_tpu/ops/dcn_pallas_grid.py:126",
                          "centertrack_tpu/ops/dcn_pallas_shift.py:110",
                          "centertrack_tpu/ops/dcn_pallas_halo.py:135"],
        "launches": launches["dcn_local_fwd"],
        "launches_by_path": {"serving": path["dcn_launches"],
                             "train": launches["dcn_local_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "per": "one 544x960 frame: the 16 launches of the neck shapes",
        "ms": per_frame("ms"), "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in neck) else "bytes"),
        "library_ms": None,
    }]
    for kname, key in (("dcn_local_bwd_data", "data"),
                       ("dcn_local_bwd_weight", "weight")):
        kernels.append({
            "name": kname, "route": "cuda", "source": bwd_source,
            "replaces": bwd_replaces, "also_replaces": bwd_also,
            "launches": launches[kname],
            "launches_by_path": {"serving": 0, "train": launches[kname]},
            "max_abs_err": max(r[key + "_max_abs_err"] for r in grad_rows),
            "per": "one 544x960 image of a training step: the 16 launches "
                   "of the neck shapes at B=1",
            "ms": per_image(key + "_ms"),
            "plain_ms": per_image(key + "_plain_ms"),
            "bound_ms": per_image(key + "_bound_ms"),
            "bound_by": ("operations" if all(
                r[key + "_bound_by"] == "operations" for r in gneck)
                else "bytes"),
            "library_ms": None,
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
