#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (centertrack_tpu_torch) on one
NVIDIA GPU: `python3 chip_smoke.py` from the root of a checkout.

Phases, each printing one JSON line with its elapsed seconds:

  device   the card's name and power limit (nvidia-smi); fails without CUDA
  build    nvcc build of the port's kernel (csrc/dcn_local.cu) into build/
  kernel   dcn_local_fwd against its plain PyTorch version at the seven
           DLA-34 neck shapes of the 544x960 path (R=1) and one R=2 case,
           with kernel, plain and cuDNN-3x3 times and the H100 bound
  path     the port's FusedDetector (DLA-34 dcn_local1, 544x960, the
           committed assets/selftest_local1_fp16.ckpt weights) over 30
           synthetic 1080p frames, every frame fetched; the kernel must
           launch exactly 16 times per frame; the first 3 frames are then
           re-run with the DCN on its plain version and must agree
  kernels  one JSON line per the port's kernel table

`--profile N` adds a phase after `path`: torch.profiler over N frames,
device time by kernel and the device's idle share.

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

import numpy as np
import torch

from centertrack_tpu_torch.config import Config, MOT_META, parse_task, \
    set_heads
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.ops import _build, dcn
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
PATH_FRAMES = 30
PATH_WARMUP = 5
PLAIN_FRAMES = 3


def emit(phase, **kw):
    print(json.dumps({"phase": phase,
                      "t_s": round(time.perf_counter() - T0, 3), **kw}),
          flush=True)


def synth_frames(n, height=1080, width=1920, n_obj=10, seed=0):
    """Deterministic 1080p clip in the committed checkpoints' training
    domain: moving filled rectangles with center dots on a noisy gray
    background, sized so the 1080p -> 544x960 warp lands them at the
    16-30 x 12-22 px scale the checkpoints were trained on (the same
    generator as the JAX package's bench.py)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform([0, 0], [width - 120, height - 90], (n_obj, 2))
    vel = rng.uniform(-4, 4, (n_obj, 2))
    size = rng.uniform([32, 24], [60, 44], (n_obj, 2))
    colors = rng.randint(40, 220, (n_obj, 3))
    frames = []
    for f in range(n):
        img = rng.randint(180, 220, (height, width, 3), np.uint8)
        for o in range(n_obj):
            x, y = pos[o] + vel[o] * f
            w, h = size[o]
            x = int(np.clip(x, 0, width - w))
            y = int(np.clip(y, 0, height - h))
            img[y:y + int(h), x:x + int(w)] = colors[o]
            cy, cx = y + int(h) // 2, x + int(w) // 2
            img[max(0, cy - 3):cy + 3, max(0, cx - 3):cx + 3] = 255
        frames.append(img)
    return frames


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


def dcn_bound_ms(n, cin, cout):
    """Least H100 time for one clamped-DCN call: the larger of its fp32
    operations over the fp32 peak and its bytes (each input read once,
    the output written once) over the memory rate."""
    ops = 2.0 * n * 9 * cin * cout + 8.0 * n * 9 * cin  # contraction + bilinear
    nbytes = 4.0 * (n * cin + n * 27 + 9 * cin * cout + cout + n * cout)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    t = time.perf_counter()
    path = _build.build("dcn_local")
    info = _build.build_info["dcn_local"]
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t, 3),
         nvcc_seconds=round(info["seconds"], 3),
         library=os.path.relpath(path, ROOT), ptxas=ptxas)


def phase_kernel():
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    cases = [(*s, 1) for s in NECK_SHAPES] + \
        [("s4", 136, 240, 64, 64, 0, "R=2 check", 2)]
    rows = []
    for name, h, w, cin, cout, per_frame, layers, r in cases:
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


def phase_path():
    cfg = set_heads(parse_task(Config(
        task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
        max_age=3, dla_node="dcn_local1")), MOT_META)
    params, batch_stats = load_jax_ckpt(CKPT)
    frames = synth_frames(PATH_FRAMES, seed=0)
    det = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda")

    dcn.LAUNCHES = 0
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
    launches = dcn.LAUNCHES
    live = int(det.track_state.valid.sum())
    if launches != 16 * PATH_FRAMES:
        raise RuntimeError(f"dcn_local_fwd launched {launches} times over "
                           f"{PATH_FRAMES} frames, expected 16 per frame")
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


def phase_profile(det, frames, cfg, n):
    """torch.profiler over n steady frames: device time by kernel and
    the share of the wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    det.reset_tracking()
    for f in frames[:3]:
        FusedDetector.fetch(det.run(f), cfg.out_thresh)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for f in frames[3:3 + n]:
            FusedDetector.fetch(det.run(f), cfg.out_thresh)
        wall_ms = 1e3 * (time.perf_counter() - t)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    emit("profile", frames=n, wall_ms_per_frame=wall_ms / n,
         device_busy_ms_per_frame=busy_ms / n,
         device_idle_share=1 - busy_ms / wall_ms,
         device_kernels_per_frame=sum(e.count for e in events) / n,
         top=[{"name": e.key[:80], "calls_per_frame": e.count / n,
               "ms_per_frame": e.self_device_time_total / 1e3 / n}
              for e in top])


def _out_of_time(signum, frame):
    raise TimeoutError(f"chip_smoke exceeded its {BUDGET_S} s budget")


def main(argv):
    """``--profile N`` adds a torch.profiler pass over N frames."""
    n_profile = int(argv[argv.index("--profile") + 1]) \
        if "--profile" in argv else 0
    signal.signal(signal.SIGALRM, _out_of_time)
    signal.alarm(BUDGET_S)
    dev = phase_device()
    phase_build()
    rows = phase_kernel()
    path, det, frames, cfg = phase_path()
    if n_profile:
        phase_profile(det, frames, cfg, n_profile)

    neck = [r for r in rows if r["launches_per_frame"]]
    per_frame = lambda key: sum(r[key] * r["launches_per_frame"]
                                for r in neck)
    kernels = [{
        "name": "dcn_local_fwd", "route": "cuda",
        "source": "centertrack_tpu_torch/csrc/dcn_local.cu",
        "replaces": "centertrack_tpu/ops/dcn_pallas.py:115",
        "also_replaces": ["centertrack_tpu/ops/dcn_pallas_grid.py:126",
                          "centertrack_tpu/ops/dcn_pallas_shift.py:110",
                          "centertrack_tpu/ops/dcn_pallas_halo.py:135"],
        "launches": path["dcn_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "per": "one 544x960 frame: the 16 launches of the neck shapes",
        "ms": per_frame("ms"), "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in neck) else "bytes"),
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=time.perf_counter() - T0, nvidia_smi=dev[
        "nvidia_smi"])
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
