#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (centertrack_tpu_torch) on one
NVIDIA GPU: `python3 chip_smoke.py` from the root of a checkout.

Phases, each printing one JSON line with its elapsed seconds:

  device   the card's name and power limit (nvidia-smi); fails without CUDA
  build    nvcc builds of the port's kernel sources (csrc/dcn_local.cu,
           csrc/dcn_local_bwd.cu, csrc/dcn_local_bf16.cu,
           csrc/dcn_local_bwd_bf16.cu, csrc/dcn_exact.cu,
           csrc/dcn_exact_bwd.cu, csrc/probes.cu, csrc/tracker.cu) into
           build/, all started together
  codec    the port's host image codec (csrc/image_codec.c, built with cc
           at first use): the bench's 1080p frames, 1080p noise, a gray
           frame and odd-sized noise (codec_inputs) encoded as JPEG and
           decoded, the SHA-256 of each file's bytes and of each decode's
           pixels against cv2's (CODEC_GOLDEN, recomputed by
           tests/test_torch_port_codec.py); a 1920x1080 PNG whose rows
           alternate Average and Paeth decoding to its source; host ms a
           1080p JPEG decode and encode and a 1080p PNG decode
  probes   the 13 toolchain-probe kernels of csrc/probes.cu (the JAX
           package's tools/pallas_probe.py P0-P6 and pallas_probe2.py
           P10-P15) against their plain versions on seeded and on
           all-ones inputs, one launch counted per call, with kernel,
           plain and library times, the bound and an empty kernel's
           launch; then the two ported probe tools' main on the card,
           each probe kernel launching once and P7/P8 launching
           dcn_local_fwd_bf16
  tracker  greedy_assign and splat_pre_hm (csrc/tracker.cu) alone on
           adversarial cases against their plain versions: greedy_assign
           exactly at S=1 and 6 streams, T=256 and 1024 slots, K=100
           (the path's ~10 live rows, ties, NaNs in taken and untaken
           columns, every row live, every row the same, entries between
           1e16 and 1e18); splat_pre_hm within 1e-6 with the same support
           at S=1 and 6 on the 544x960 canvas (the path's ~10 slots,
           edges, corners and tile borders with radii negative and past
           the cap, all 256 slots valid, none); one launch counted per
           call; one call of each is one kernel on the device and nothing
           else (no memset); device times (spin-queued), the bytes bound
           and greedy_assign's dependency-chain bound
  kernel   dcn_local_fwd and dcn_local_fwd_bf16 against their plain
           PyTorch versions at the seven DLA-34 neck shapes of the
           544x960 path (R=1) at B=1 and B=8, R=2 and R=3 cases, one
           ragged shape (17x30, 72->40) and one of odd widths (17x30,
           69->37), with kernel, device (queued
           behind a spin kernel), plain and cuDNN-3x3 times, the H100
           bound (float32: 3xTF32 on the tensor cores, and the same work
           on the CUDA cores beside it) and the launch plan (tile, chunk,
           N tile, window slots, splits, blocks, shared memory)
  precision  a float32 3x3 convolution and matmul against float64 with
           the process's flags and inside the package's full_float32
           (the float32 paths' precision); fails if TF32 is on inside
  grad     dcn_local_bwd_data and dcn_local_bwd_weight (through the
           autograd function) against autograd of the plain version, at
           the same cases, on random offsets (some past +/-R) and on
           all-zero offsets (the kinks), with kernel, device, plain and
           bound times (3xTF32 and on the CUDA cores) and both launch
           plans; two weight launches must give a bit-identical grad w
  grad_bf16  dcn_local_bwd_data_bf16 and dcn_local_bwd_weight_bf16
           against autograd of the plain bf16 version at the bf16
           forward's cases and the same offsets, every element within the
           bf16 forward's tolerance, with kernel, device, plain and bound
           times and both launch plans; grad w bit-identical over two
           launches
  gather, gather_bf16  the weight gradient's gather route, the planner's
           choice where no window fits in shared memory, against the
           plain version at one such max offset per dtype
  gather_routes  the forward and data kernels' gather routes at both
           dtypes (dcn_local_fwd_gather[_bf16],
           dcn_local_bwd_data_gather[_bf16]) at R=5, 9 and 16 with Cout
           384 (Cin 69) and 512 (Cin 64), and odd widths 69->37 at R=5,
           B=2, 17x30: each call one launch of its kernel and nothing
           else (through the planner's route where it chooses the gather
           route), against the plain version at the kernel phases'
           tolerances, on random offsets and, at R=5, all-zero ones;
           times and bounds
  exact    dcn_exact_fwd and dcn_exact_fwd_bf16 (csrc/dcn_exact.cu, the
           exact DCNv2 of dla_node dcn and dcn_mix) against
           deform_conv2d_plain at the seven neck shapes at B=1 and B=6,
           the ragged and the odd-widths shapes and a map smaller than a
           tile, on offsets ~N(0, 3), ~N(0, 40), all zero, +/-1e6 and,
           at the neck shapes, "trained": every launch of one eager
           forward of the bench's first frame on the exact-trained
           checkpoint (each node's own inputs; dcn at the kernel's
           dtype, and dcn_mix's 5 bf16 launches as exact_dcn_mix):
           float32 within REL_TOL, bf16 within BF16_ULPS ulps +
           BF16_REL_OF_MAX max|plain|; each call through the launcher
           with a route counter equal to ops/dcn.exact_tile_routes, one
           launch of its kernel and of nothing else, a second launch bit
           for bit the first; plans, window shares, times on ~N(0, 3)
           and on the trained inputs, bounds, launches per frame
  exact_grad, exact_grad_bf16  the exact op's backward kernels
           (csrc/dcn_exact_bwd.cu: dcn_exact_bwd_data[_bf16],
           dcn_exact_bwd_weight[_bf16]) through DCNExact, the wrapper's
           CUDA route for a call that needs a gradient, against autograd
           of deform_conv2d_plain at the exact phase's cases and offsets,
           trained inputs included, with a seeded output grad: each call
           launches the forward, data and weight kernels of its dtype
           once and nothing else; every gradient float32 within
           GRAD_REL_TOL of max|plain|, bf16 within BF16_ULPS ulps +
           BF16_REL_OF_MAX max|plain|; through the launchers with route
           counters equal to ops/dcn.exact_bwd_tile_routes (data) and
           exact_tile_routes (weight, per tile and tap group); grad w,
           grad offset and grad mask bit for bit over two launches;
           plans (the weight kernels': their M tiles, stages, taps and
           window slots; their roles in the design string), window shares, times on ~N(0, 3) and on the
           trained inputs, plain times and bounds, and the float values
           the data kernel added into grad x by global reductions,
           counted on the device (at most 36 Cin a pixel: 9 taps x 4
           corners)
  path     the port's FusedDetector (DLA-34 dcn_local1, 544x960, the
           committed assets/selftest_local1_fp16.ckpt weights) over 30
           synthetic 1080p frames, every frame a CUDA graph replay (the
           first call warms up and captures), fetched, with the process's
           own precision flags (torch's defaults; the step must read TF32
           off inside and the run give the flags back); every run after
           the capture under set_sync_debug_mode("error"); the wrappers
           run twice (warm-up, capture); then the counted run: the same
           frames from a fresh state, all replays, under torch.profiler,
           bit for bit the first run's rows, no wrapper called, and 16
           device launches of the forward kernel, one of greedy_assign
           and one of splat_pre_hm per frame (the path's launches, by
           kernel name); the first 3
           frames through the eager step must give the replays' rows bit
           for bit, each of the first frame's 16 DCN launches and every
           tracker launch held against its plain version on its own
           inputs (greedy exactly, the splat within 1e-6 with the same
           support), both tracker kernels timed at the path's shapes;
           the first 3 frames re-run with the DCN on its plain version
           must agree
  path_bf16  the same 30 frames, checkpoint and detector at
           compute_dtype="bfloat16": the same checks with
           dcn_local_fwd_bf16 and no float32 DCN kernel at all; the
           rows are compared with the float32 path's
  chunk, chunk_bf16  run_chunk over the same 30 frames from a fresh
           state in chunks of 4 and one of 2 (one graph per chunk
           size): every row bit for bit the path's; run_chunk under the
           sync-debug mode after its capture; a counted run of the same
           chunks as in path; the bench's lag-4 (timed_tracking) and chunk-4
           (timed_tracking_chunked) protocols timed on device frames,
           with host ms per call and peak memory
  multistream  MultiStreamDetector at float32 with 2 streams and at
           bf16 with 6 (stream s offset by 5 s frames): at each, the
           first 3 steps on the eager step bit for bit the replays, the
           first step's 16 DCN launches and every tracker launch held
           against their plain versions, a counted run as in path;
           float32: stream 1 reset before frame 15, each stream against
           single-stream tracking of the same frames, track ids equal
           and scores within PLAIN_SCORE_TOL; bf16: each stream's rows
           at every step against a single-stream bf16 detector started
           from that stream's state, then the bench's 6-stream leg at
           lag 4: aggregate fps, peak memory
  lifetimes  three dcn_local1 detectors (float32, bf16, float32) made,
           served 3 frames through their graphs and deleted in turn:
           device memory after gc before each and after each deletion,
           then after freeing cuBLAS's per-stream workspaces; what the
           deleted detectors leave allocated must stay within
           LIFETIME_BOUND_MB (ROADMAP C8)
  path_dcn, path_dcn_bf16, path_dcn_mix_bf16  the path's checks on the
           committed exact-trained assets/selftest_dcn_fp16.ckpt at
           dla_node "dcn" (float32: both packages' default configuration;
           bf16) and "dcn_mix" (bf16): the bench's exact legs. Replays bit
           for bit the eager step, each first-frame launch against its
           plain version, rows against a plain-DCN detector, device
           launches of the counted run: 16 dcn_exact_fwd[_bf16] a frame
           at dcn, 5 dcn_exact_fwd_bf16 and 11 dcn_local_fwd_bf16 (R=2) at
           dcn_mix; then run_chunk over 8 frames bit for bit the path's
           rows, a two-stream MultiStreamDetector (captured, its eager
           step bit for bit a replay) and the lag-4 protocol (fps, peak
           memory)
  train    the port's Trainer on the same model and checkpoint at
           544x960, B=8, Adam (the flags as in path, read inside
           train_step): 12 steps on one fixed batch built from 9
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
  train_dcn, train_dcn_bf16, train_dcn_mix, train_dcn_mix_bf16  the
           train phases on the exact-trained checkpoint at dla_node "dcn"
           (each exact kernel of the dtype, forward, bwd data and bwd
           weight, 16 launches a step and no clamped one) and "dcn_mix"
           (5 of each exact kernel and 11 of each clamped one, R=2), both
           dtypes: a falling finite loss, the launches of every step, each
           launch of a 13th step and of the B=1 step against the plain
           version, the B=1 step's gradients against a plain-DCN step's
  mota     the port's MOTA on the card: FusedDetector at float32 over
           synth_clip's 30 frames (1080p warped to 544x960) with the
           committed checkpoints at dla_node "dcn_local1" and "dcn", the
           active tracks scored by the port's eval/mot_metrics against
           the clip's boxes; MOTA and IDF1 within MOTA_TOL of JAX's
           FusedDetector on the same frames and weights (MOTA_REFERENCE,
           from tests/mota_reference.py on the CPU); a counted run of
           replays gives the device launches
  mot17_recipe  MOT17's own recipe (experiments/mot17_half.sh): a clip
           of MOT's geometry (tools/selftest's generator at 1920x1080,
           scale 2, 2 videos x 16 JPEG frames), 12 training steps at
           544x960, B=8, bf16, dla_node dcn_local with ltrb_amodal and the
           recipe's flags through DataLoader and Trainer from the
           committed checkpoint, its ltrb_amodal head carried over from
           its wh head (each bf16 clamped kernel 16 launches a
           step, nothing else; the loss must fall), then the trained
           weights served by FusedDetector (graph replays) at the test
           flags (track_thresh 0.4, pre_thresh 0.5), its boxes the amodal
           head's: rows against the plain-DCN path by path_bf16's rule,
           a counted run of replays with CLEAR-MOT; step, loader, read
           and serving ms
  selftest the port's tools/selftest end to end: the hard selftest
           domain written as JAX's JPEG files, DLA-34 dcn float32 trained 30 epochs at
           B=8 through the port's DataLoader (thread workers), saved
           through CheckpointManager after epoch 15 and resumed into a
           fresh model and Trainer with its optimizer state, then every
           training video tracked by FusedDetector and scored; overall
           MOTA >= SELFTEST_MOTA_FLOOR; each exact kernel launches 16
           times a step; train and eval seconds, the loader's ms per
           batch on the host; then 10 steps on one batch timed alone
  kernels  one JSON line: the port's kernel table

`--profile N` adds a phase after `path`, `path_bf16`, the three exact
paths, `chunk` and
`chunk_bf16`, one after the timed steps of every train phase and one
after the selftest's steps timed alone: torch.profiler over N frames
(graph replays) of each path, N chunk replays and N B=8 steps of each
train phase and of the selftest, device time by kernel, kernels per
frame and the device's idle share.

The last line is {"ok": true, "device": {...}}. Any failure raises and
the exit code is not 0. The whole run has a wall-clock budget.
"""

import collections
import contextlib
import gc
import io
import json
import os
import re
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
# the exact-trained checkpoint of the bench's exact legs (bench.py:17-18):
# the same parameter tree, served at dla_node "dcn" and "dcn_mix"
CKPT_DCN = os.path.join(ROOT, "assets", "selftest_dcn_fp16.ckpt")
BUDGET_S = 1100
T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 and TF32 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
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
           "dcn_local_bwd_bf16", "dcn_exact", "dcn_exact_bwd", "probes",
           "tracker")
# the DCN kernels a serving path launches per frame, by (dla_node, compute
# dtype): dcn_mix's 5 exact nodes run on the stride-16 and -32 maps, its
# 11 clamped ones (R=2) on the stride-4 and -8 maps
PATH_KERNELS = {
    ("dcn_local1", "float32"): {"dcn_local_fwd": 16},
    ("dcn_local1", "bfloat16"): {"dcn_local_fwd_bf16": 16},
    ("dcn", "float32"): {"dcn_exact_fwd": 16},
    ("dcn", "bfloat16"): {"dcn_exact_fwd_bf16": 16},
    ("dcn_mix", "bfloat16"): {"dcn_exact_fwd_bf16": 5,
                              "dcn_local_fwd_bf16": 11}}
# the _RecordLaunches kind of each forward kernel
RECORD_KIND = {"dcn_local_fwd": "fwd", "dcn_local_fwd_bf16": "bf16",
               "dcn_exact_fwd": "exact", "dcn_exact_fwd_bf16": "exact_bf16"}
# the exact forward kernels' checks: the offsets' spreads (~N(0, s); 0 is
# all-zero offsets, every border tap on the clip's tie; "1e6" a mix of
# +/-1e6 and small ones) and the batch of the multi-stream serving leg
EXACT_OFFSETS = (3.0, 40.0, 0.0, "1e6")
EXACT_BATCH = 6
# the lifetimes phase (C8): detectors made, served and deleted in turn,
# and what may stay allocated after the last deletion
LIFETIME_DETECTORS = (("dcn_local1", "float32"), ("dcn_local1", "bfloat16"),
                      ("dcn_local1", "float32"))
LIFETIME_FRAMES = 3
LIFETIME_BOUND_MB = 16
EXACT_LAUNCHERS = {"dcn_exact_fwd": "launch_exact_fwd",
                   "dcn_exact_fwd_bf16": "launch_exact_fwd_bf16"}
# the exact backward's launchers by dtype: (data, weight)
EXACT_BWD_LAUNCHERS = {
    "float32": ("launch_exact_bwd_data", "launch_exact_bwd_weight"),
    "bfloat16": ("launch_exact_bwd_data_bf16",
                 "launch_exact_bwd_weight_bf16")}
# the path phases of the exact-trained checkpoint: (phase, dla_node,
# compute dtype); the float32 "dcn" is both packages' default
# configuration, the two bf16 ones the bench's exact legs (bench.py:319)
EXACT_PATHS = (("path_dcn", "dcn", "float32"),
               ("path_dcn_bf16", "dcn", "bfloat16"),
               ("path_dcn_mix_bf16", "dcn_mix", "bfloat16"))
# the kernel path's rows against the plain-DCN path's over PLAIN_FRAMES
# frames: the same track ids and scores within this. float32: both
# forwards agree to ~1e-6; bf16: a kernel launch may flip single
# outputs by an ulp, and later bf16 layers carry that on
PLAIN_SCORE_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# the serving step's tracker kernels (csrc/tracker.cu): greedy_assign
# must equal its plain version exactly, splat_pre_hm within this
# (float32 exp on the card and on the CPU) with the same support
TRACKER_KERNELS = ("greedy_assign", "splat_pre_hm")
SPLAT_TOL = 1e-6
# seconds the counted runs' profiler window stays open, idle, before the
# first replay and after the last has finished (device_kernel_counts)
PROFILE_EDGE_S = 0.05
# the first frames of a path run again on the eager step (no graph),
# which must give the replays' rows bit for bit
EAGER_FRAMES = 3
# the device kernels a replay launches, by name in a profiler trace
KERNEL_NAMES = {"dcn_local_fwd": r"dcn_local_fwd_kernel\b",
                "dcn_local_fwd_bf16": r"dcn_local_fwd_bf16_kernel\b",
                "dcn_exact_fwd": r"dcn_exact_fwd_kernel\b",
                "dcn_exact_fwd_bf16": r"dcn_exact_fwd_bf16_kernel\b",
                "greedy_assign": r"greedy_assign_kernel\b",
                "splat_pre_hm": r"splat_pre_hm_kernel\b"}
# bench.py's protocols (timed_tracking, timed_tracking_chunked and the
# 6-stream leg): lag-4 fetches over 60 frames after 5, chunks of 4
# fetched one chunk behind over 20 chunks after 3, six bf16 streams
# (stream s offset by 5 frames) at lag 4 over 30 steps after 4
LAG, LAG_WARMUP, LAG_FRAMES = 4, 5, 60
CHUNK, CHUNK_WARMUP, CHUNK_ITERS = 4, 3, 20
MULTI_STREAMS, MULTI_OFFSET, MULTI_WARMUP, MULTI_ITERS = 6, 5, 4, 30
# multistream at float32: two streams against single-stream tracking,
# stream 1 reset (a video boundary) before this frame
MULTI_RESET_AT = 15
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
# mota: the port's FusedDetector on synth_clip's frames (1080p warped to
# 544x960) with the committed checkpoints at float32, scored by the
# port's CLEAR-MOT against the clip's boxes (object index = track id),
# active tracks only. MOTA_REFERENCE is JAX's FusedDetector on the same
# frames and weights on the CPU, printed by
#   JAX_PLATFORMS=cpu python3 tests/mota_reference.py --frames 30
# MOTA and IDF1 must lie within MOTA_TOL of it (one event of 300
# ground-truth boxes is 0.0033).
MOTA_FRAMES = 30
MOTA_TOL = 0.01
MOTA_NODES = (("dcn_local1", CKPT), ("dcn", CKPT_DCN))
MOTA_REFERENCE = {
    "dcn_local1": {"mota": 0.94, "idf1": 0.9505962521294719,
                   "num_false_positives": 2, "num_misses": 15,
                   "num_switches": 1, "num_objects": 300,
                   "num_matches": 285},
    "dcn": {"mota": 0.8566666666666667, "idf1": 0.9191919191919192,
            "num_false_positives": 18, "num_misses": 24, "num_switches": 1,
            "num_objects": 300, "num_matches": 276}}
MOT_COUNTS = ("num_objects", "num_matches", "num_false_positives",
              "num_misses", "num_switches", "num_fragmentations")
# selftest: the port's tools/selftest end to end, the protocol of
# docs/parity_mota.json (hard domain, seed 0, 6 videos x 24 frames at
# 96x160, JPEG; dla_node dcn float32, B=8, Adam 5e-4, 30 epochs through the
# port's DataLoader with thread workers), saved through CheckpointManager
# after epoch SELFTEST_RESUME_AT and resumed into a fresh model and
# Trainer; the overall MOTA over the training videos must reach
# SELFTEST_MOTA_FLOOR (JAX's dcn seeds: 0.8957-0.9167 on JPEG frames)
SELFTEST_EPOCHS = 30
SELFTEST_RESUME_AT = 15
SELFTEST_MOTA_FLOOR = 0.85
SELFTEST_WORKERS = 4
SELFTEST_NODE = "dcn"
# steps the selftest's step is timed alone (selftest_step_profile)
SELFTEST_ALONE_STEPS = 10
# bf16: the B=1 kernel step against the plain bf16 step. Both are bf16
# steps that differ only in where the DCN layers' float32 sums fall
# before their roundings, so each lies about as far from the plain
# float32 step (distance d, measured in the same run) as the other;
# two such steps with independent rounding errors are about sqrt(2) d
# apart. Tolerance: relative L2 over all gradients <= 2 d.
BF16_GRAD_L2_OF_FP32_DIST = 2.0
# codec: the port's host JPEG codec (csrc/image_codec.c) and PNG unfilter
# on seeded inputs (codec_inputs), each case (input, quality) encoded and
# the file decoded; CODEC_GOLDEN holds the SHA-256 of the file's bytes and
# of the decoded pixels as cv2.imencode / cv2.imdecode give them
# (tests/test_torch_port_codec.py recomputes both with cv2)
CODEC_SEED = 5
CODEC_CASES = (("synth_0", 95), ("synth_0", 75), ("synth_1", 95),
               ("noise", 95), ("gray", 95), ("noise_17x33", 95))
CODEC_GOLDEN = {
    "synth_0@95": (
        "cc92d92e7dd343df26284564bde8a327cc6f5dc6789438bb442787c235487c52",
        "4852172bcbb4312587eedc78f13105ebea59dfa716a966ab1e36bb7edffb516f"),
    "synth_0@75": (
        "1f818319875550e5af1cdeec5f1ef55cabd3cb43baefee651476ec1f7e1eb125",
        "330a64f2e3cb0a19e7d82c2571625c636a7fd55f0f2ef83191194bc058aabbed"),
    "synth_1@95": (
        "60ed258b06a1068759b8288b6cbe4cebba57052f3af8d3b5aa303ec528889a0d",
        "b5341eac76855189d8b59c3ebf52bc8d88958c4770f165731a755ed3381f0356"),
    "noise@95": (
        "43154878719408c8fa4cb78a93192a114ed223793a7a7218ca2d27fe5317c000",
        "fbf2808aa5c48fba87e7656a852e8fdaddd3e9921aa331bc945eee34d5f1978d"),
    "gray@95": (
        "9029dc203721f8ee66080057c6ad49302fd5525933a3d4747b0b531f58f1f644",
        "dfa1015ae929ae3d4a21182403ad13087f9a636652c32437f41ed843ba980952"),
    "noise_17x33@95": (
        "d79e9cb646e4b19ee95df9da7e5416e09b4ece38886180f1f020a0dabbf76303",
        "f8663bed73de72b205d54b5f81ce8ed0593908066e013290697f717de12e9404")}
CODEC_TIMED = 5
# mot17_recipe: MOT17's own recipe (experiments/mot17_half.sh:3-6) on a
# clip of MOT's geometry: tools/selftest's generator at 1920x1080 with
# scale 2 (16-30 px objects at the 544x960 input), the hard domain,
# RECIPE_VIDEOS x RECIPE_FRAMES JPEG frames. Training starts from the
# committed local1 checkpoint (load_model, the recipe's finetune; the
# ltrb_amodal head carried over from its wh head) and takes RECIPE_STEPS
# steps of B=8 through DataLoader (RECIPE_WORKERS threads) and Trainer;
# serving uses
# the trained weights at the recipe's test flags (mot17_half.sh:11)
RECIPE_VIDEOS, RECIPE_FRAMES, RECIPE_STEPS = 2, 16, 12
RECIPE_FRAME_HW, RECIPE_INPUT_HW = (1080, 1920), (544, 960)
RECIPE_WORKERS = 8
RECIPE_TRAIN = dict(pre_hm=True, ltrb_amodal=True, same_aug_pre=True,
                    hm_disturb=0.05, lost_disturb=0.4, fp_disturb=0.1,
                    dla_node="dcn_local", compute_dtype="bfloat16")
RECIPE_TEST = dict(track_thresh=0.4, pre_thresh=0.5)


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


def codec_inputs():
    """The codec phase's inputs by name: two of the bench's 1080p frames,
    1080p noise, the first frame's green channel as a gray image and
    noise at an odd size, from numpy seeds."""
    frames = synth_frames(2, seed=CODEC_SEED)
    rng = np.random.RandomState(CODEC_SEED)
    return {"synth_0": frames[0], "synth_1": frames[1],
            "noise": rng.randint(0, 256, (1080, 1920, 3)).astype(np.uint8),
            "gray": np.ascontiguousarray(frames[0][..., 1]),
            "noise_17x33": rng.randint(0, 256, (17, 33, 3)).astype(np.uint8)}


def sha256(data):
    import hashlib
    return hashlib.sha256(bytes(data)).hexdigest()


def png_filtered(img, kinds):
    """An RGB PNG of ``img`` (BGR uint8) whose row y is filtered with PNG
    filter ``kinds[y % len(kinds)]`` (3 Average, 4 Paeth; PNG spec 9.2),
    in numpy: the predictors read the unfiltered rows."""
    import struct
    import zlib
    rgb = img[..., ::-1].reshape(img.shape[0], -1).astype(np.int32)
    left = np.zeros_like(rgb)
    left[:, 3:] = rgb[:, :-3]
    up = np.zeros_like(rgb)
    up[1:] = rgb[:-1]
    upleft = np.zeros_like(rgb)
    upleft[1:, 3:] = rgb[:-1, :-3]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    kind = np.array([kinds[y % len(kinds)] for y in range(img.shape[0])])
    pred = np.where((kind == 3)[:, None], (left + up) // 2, paeth)
    body = np.concatenate([kind[:, None], (rgb - pred) % 256], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data)))
    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 2, 0, 0,
                         0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) +
            chunk(b"IDAT", zlib.compress(body.astype(np.uint8).tobytes())) +
            chunk(b"IEND", b""))


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


def _bound_3xtf32_ms(contraction, bilinear, nbytes):
    """Least H100 time of float32 work whose contraction runs three times
    at the dense TF32 tensor-core peak (3xTF32) and whose bilinear work
    runs at the fp32 peak, against its bytes over the memory rate; the
    larger, and which it is."""
    t_ops = 3.0 * contraction / PEAK_TF32_FLOPS + bilinear / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dcn_bound_ms_3xtf32(n, cin, cout):
    """Least H100 time of one float32 clamped-DCN call with its
    contraction on the tensor cores in 3xTF32 (``dcn_local_fwd``): the
    work and bytes of ``dcn_bound_ms``, the contraction three times at the
    TF32 peak, the sampling at the fp32 peak."""
    return _bound_3xtf32_ms(
        2.0 * n * 9 * cin * cout, 8.0 * n * 9 * cin,
        4.0 * (n * cin + n * 27 + 9 * cin * cout + cout + n * cout))


def dcn_bwd_data_bound_ms_3xtf32(n, cin, cout):
    """Least H100 time of ``dcn_local_bwd_data`` with its G contraction in
    3xTF32: the work and bytes of ``dcn_bwd_bound_ms``'s data kernel, the
    contraction three times at the TF32 peak, the bilinear work at the
    fp32 peak."""
    return _bound_3xtf32_ms(
        2.0 * n * 9 * cin * cout, 38.0 * n * 9 * cin,
        4.0 * (2 * n * cin + 2 * n * 27 + 9 * cin * cout + n * cout))


def dcn_bwd_weight_bound_ms_3xtf32(n, cin, cout):
    """Least H100 time of ``dcn_local_bwd_weight`` with its contraction
    over pixels in 3xTF32: the work and bytes of ``dcn_bwd_bound_ms``'s
    weight kernel, the contraction three times at the TF32 peak, the
    sampling at the fp32 peak."""
    return _bound_3xtf32_ms(
        2.0 * n * 9 * cin * cout, 8.0 * n * 9 * cin,
        4.0 * (n * cin + n * 27 + n * cout + 9 * cin * cout))


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


def exact_corner_counts(offset, mask):
    """(needed, live) corners of an exact call on these offsets and mask,
    summed over pixels and taps: the corners the data kernel reads (inside
    the map, one of its three weights not 0) and those the forward and
    the weight kernel read (inside the map, hat weight not 0), as
    ops/dcn's route rules take them."""
    h, w = offset.shape[1:3]
    needed = sum(int(u.sum()) for corners in dcn._exact_corner_sets(
        offset, mask, h, w, True) for _, _, u in corners)
    live = sum(int(u.sum()) for corners in dcn._exact_corner_sets(
        offset, None, h, w, False) for _, _, u in corners)
    return needed, live


def _exact_bwd_bound(contraction, walk, elems, low):
    """The larger of the operations (the contraction three times at the
    TF32 peak at float32, at the bf16 peak at bf16; the corner walk at the
    fp32 peak) and the bytes of ``elems`` values (4 or 2 bytes each) over
    the memory rate, and which it is."""
    if low:
        t_ops = contraction / PEAK_BF16_FLOPS + walk / PEAK_FP32_FLOPS
        t_bytes = 2.0 * elems / PEAK_BYTES_S
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                           else "bytes")
    return _bound_3xtf32_ms(contraction, walk, 4.0 * elems)


def exact_bwd_data_bound_ms_3xtf32(n, cin, cout, needed, live):
    """Least H100 time of ``dcn_exact_bwd_data`` on one call's inputs: the
    G contraction, 2 n 9 Cin Cout operations, three times at the TF32
    peak; the corner walk at the fp32 peak: per needed corner (``needed``
    of ``exact_corner_counts``) 2 Cin operations for d_k and 6 for the
    three sums, per live corner 2 Cin for the scatter into grad x; against
    x, offset, mask, weight and the output grad read once and grad x,
    grad offset and grad mask written once, 4 bytes a value."""
    return _exact_bwd_bound(
        2.0 * n * 9 * cin * cout, (2.0 * cin + 6) * needed + 2.0 * cin * live,
        2 * n * cin + 2 * n * 27 + 9 * cin * cout + n * cout, False)


def exact_bwd_data_bound_ms_bf16(n, cin, cout, needed, live):
    """``exact_bwd_data_bound_ms_3xtf32`` for ``dcn_exact_bwd_data_bf16``:
    the contraction once at the bf16 peak, 2 bytes a value."""
    return _exact_bwd_bound(
        2.0 * n * 9 * cin * cout, (2.0 * cin + 6) * needed + 2.0 * cin * live,
        2 * n * cin + 2 * n * 27 + 9 * cin * cout + n * cout, True)


def exact_bwd_weight_bound_ms_3xtf32(n, cin, cout, live):
    """Least H100 time of ``dcn_exact_bwd_weight`` on one call's inputs:
    the contraction over pixels, 2 n 9 Cin Cout operations, three times
    at the TF32 peak; the sample A_t at the fp32 peak, 2 Cin operations a
    live corner (``exact_corner_counts``); against x, offset, mask and
    the output grad read once and grad w written once, 4 bytes a value."""
    return _exact_bwd_bound(2.0 * n * 9 * cin * cout, 2.0 * cin * live,
                            n * cin + n * 27 + n * cout + 9 * cin * cout,
                            False)


def exact_bwd_weight_bound_ms_bf16(n, cin, cout, live):
    """``exact_bwd_weight_bound_ms_3xtf32`` for
    ``dcn_exact_bwd_weight_bf16``: the contraction once at the bf16
    peak, 2 bytes a value."""
    return _exact_bwd_bound(2.0 * n * 9 * cin * cout, 2.0 * cin * live,
                            n * cin + n * 27 + n * cout + 9 * cin * cout,
                            True)


# the DCN kernels a training step launches, by (dla_node, compute dtype),
# each with its launches a step, and the _RecordLaunches kinds that record
# them: dcn_mix's 5 exact nodes and 11 clamped ones (R=2)
_LOCAL = {"float32": ("dcn_local_fwd", "dcn_local_bwd_data",
                      "dcn_local_bwd_weight"),
          "bfloat16": ("dcn_local_fwd_bf16", "dcn_local_bwd_data_bf16",
                       "dcn_local_bwd_weight_bf16")}
_EXACT = {"float32": ("dcn_exact_fwd", "dcn_exact_bwd_data",
                      "dcn_exact_bwd_weight"),
          "bfloat16": ("dcn_exact_fwd_bf16", "dcn_exact_bwd_data_bf16",
                       "dcn_exact_bwd_weight_bf16")}
_LOCAL_KINDS = {"float32": ("fwd", "data", "weight"),
                "bfloat16": ("bf16", "data_bf16", "weight_bf16")}
_EXACT_KINDS = {"float32": ("exact", "exact_data", "exact_weight"),
                "bfloat16": ("exact_bf16", "exact_data_bf16",
                             "exact_weight_bf16")}
TRAIN_NODES = {"dcn_local1": (16, 0), "dcn": (0, 16), "dcn_mix": (11, 5)}


def _per_step(local, exact, node, dt):
    nl, ne = TRAIN_NODES[node]
    return {k: n for names, n in ((local[dt], nl), (exact[dt], ne)) if n
            for k in names}


TRAIN_KERNELS = {(node, dt): _per_step(_LOCAL, _EXACT, node, dt)
                 for node in TRAIN_NODES for dt in ("float32", "bfloat16")}
TRAIN_KINDS = {(node, dt): _per_step(_LOCAL_KINDS, _EXACT_KINDS, node, dt)
               for node in TRAIN_NODES for dt in ("float32", "bfloat16")}
# the train phases of the exact-trained checkpoint: (phase, dla_node,
# compute dtype)
EXACT_TRAINS = (("train_dcn", "dcn", "float32"),
                ("train_dcn_bf16", "dcn", "bfloat16"),
                ("train_dcn_mix", "dcn_mix", "float32"),
                ("train_dcn_mix_bf16", "dcn_mix", "bfloat16"))


def _launches():
    return {"dcn_local_fwd": dcn.LAUNCHES,
            "dcn_local_fwd_gather": dcn.FWD_GATHER_LAUNCHES,
            "dcn_local_fwd_gather_bf16": dcn.FWD_GATHER_BF16_LAUNCHES,
            "dcn_local_bwd_data_gather": dcn.BWD_DATA_GATHER_LAUNCHES,
            "dcn_local_bwd_data_gather_bf16":
                dcn.BWD_DATA_GATHER_BF16_LAUNCHES,
            "dcn_local_bwd_data": dcn.BWD_DATA_LAUNCHES,
            "dcn_local_bwd_weight": dcn.BWD_WEIGHT_LAUNCHES,
            "dcn_local_bwd_weight_gather": dcn.BWD_WEIGHT_GATHER_LAUNCHES,
            "dcn_local_fwd_bf16": dcn.BF16_LAUNCHES,
            "dcn_local_bwd_data_bf16": dcn.BWD_DATA_BF16_LAUNCHES,
            "dcn_local_bwd_weight_bf16": dcn.BWD_WEIGHT_BF16_LAUNCHES,
            "dcn_local_bwd_weight_gather_bf16":
                dcn.BWD_WEIGHT_GATHER_BF16_LAUNCHES,
            "dcn_exact_fwd": dcn.EXACT_FWD_LAUNCHES,
            "dcn_exact_fwd_bf16": dcn.EXACT_FWD_BF16_LAUNCHES,
            "dcn_exact_bwd_data": dcn.EXACT_BWD_DATA_LAUNCHES,
            "dcn_exact_bwd_data_bf16": dcn.EXACT_BWD_DATA_BF16_LAUNCHES,
            "dcn_exact_bwd_weight": dcn.EXACT_BWD_WEIGHT_LAUNCHES,
            "dcn_exact_bwd_weight_bf16":
                dcn.EXACT_BWD_WEIGHT_BF16_LAUNCHES}


def _tracker_modules():
    """Each tracker kernel's module (``ops.tracker``, ``ops.gaussian``),
    imported where used (as ``read_flags``: an earlier checkout's package
    may lack them)."""
    from centertrack_tpu_torch.ops import gaussian, tracker
    return {"greedy_assign": tracker, "splat_pre_hm": gaussian}


def _tracker_launches():
    return {k: m.LAUNCHES[k] for k, m in _tracker_modules().items()}


def _reset_launches():
    dcn.LAUNCHES = dcn.BWD_DATA_LAUNCHES = dcn.BWD_WEIGHT_LAUNCHES = 0
    dcn.BF16_LAUNCHES = 0
    dcn.BWD_DATA_BF16_LAUNCHES = dcn.BWD_WEIGHT_BF16_LAUNCHES = 0
    dcn.BWD_WEIGHT_GATHER_LAUNCHES = dcn.BWD_WEIGHT_GATHER_BF16_LAUNCHES = 0
    dcn.FWD_GATHER_LAUNCHES = dcn.FWD_GATHER_BF16_LAUNCHES = 0
    dcn.BWD_DATA_GATHER_LAUNCHES = dcn.BWD_DATA_GATHER_BF16_LAUNCHES = 0
    dcn.EXACT_FWD_LAUNCHES = dcn.EXACT_FWD_BF16_LAUNCHES = 0
    dcn.EXACT_BWD_DATA_LAUNCHES = dcn.EXACT_BWD_DATA_BF16_LAUNCHES = 0
    dcn.EXACT_BWD_WEIGHT_LAUNCHES = dcn.EXACT_BWD_WEIGHT_BF16_LAUNCHES = 0
    for name, module in _tracker_modules().items():
        module.LAUNCHES[name] = 0


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=10, check=True).stdout.strip()
    print(smi, flush=True)
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


def read_flags():
    """The package's ``utils.precision.read_flags``, imported where used:
    tools/dcn_times.py loads this module beside an earlier checkout's
    package, which may lack it."""
    from centertrack_tpu_torch.utils import precision
    return precision.read_flags()


def full_float32(compute_dtype):
    """The package's ``utils.precision.full_float32`` (imported where
    used, as ``read_flags``)."""
    from centertrack_tpu_torch.utils import precision
    return precision.full_float32(compute_dtype)


def _rel_to(out, ref):
    return ((out.double() - ref).abs().max() / ref.abs().max()).item()


def phase_precision():
    """Which precision cuDNN's float32 convolutions and cuBLAS's float32
    matmuls take on this card and torch: a 3x3 convolution and a matmul
    against float64, with the process's flags as torch starts them
    (cuDNN convolutions in TF32), with the matmuls set to TF32 by the
    legacy call, and inside the package's ``full_float32``, under which
    the float32 paths run. Fails if either is not full float32 inside,
    or the flags are not the caller's again after it."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(1, 64, 68, 120, generator=gen, device="cuda")
    wc = torch.randn(64, 64, 3, 3, generator=gen, device="cuda")
    a = torch.randn(2048, 576, generator=gen, device="cuda")
    bm = torch.randn(576, 64, generator=gen, device="cuda")
    conv = lambda: torch.nn.functional.conv2d(x, wc, padding=1)
    ref_conv = torch.nn.functional.conv2d(x.double(), wc.double(), padding=1)
    ref_mm = a.double() @ bm.double()
    flags = {"process": read_flags()}
    errs = {"process": {"conv": _rel_to(conv(), ref_conv),
                        "matmul": _rel_to(a @ bm, ref_mm)}}
    legacy = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        flags["matmul_high"] = read_flags()
        errs["matmul_high"] = {"matmul": _rel_to(a @ bm, ref_mm)}
        with full_float32("float32"):
            flags["inside_full_float32"] = read_flags()
            errs["inside_full_float32"] = {
                "conv": _rel_to(conv(), ref_conv),
                "matmul": _rel_to(a @ bm, ref_mm)}
        restored = read_flags() == flags["matmul_high"]
    finally:
        torch.set_float32_matmul_precision(legacy)
    emit("precision", flags=flags, rel_err_vs_float64=errs,
         flags_restored=restored)
    inside = errs["inside_full_float32"]
    if max(inside.values()) > 1e-5 or not restored:
        raise RuntimeError(f"full_float32 left TF32 on or did not restore "
                           f"the flags: {errs}, {flags}")
    return errs


def _flags_inside(model):
    """A forward pre-hook on ``model`` that keeps the precision flags read
    at its first call; returns (the kept list, the hook's handle)."""
    kept = []
    handle = model.register_forward_pre_hook(
        lambda module, args: kept.append(read_flags()) if not kept
        else None)
    return kept, handle


def _check_flags(kind, dtype, inside, outside):
    """At float32 the network ran with TF32 off and cuDNN on; at bf16
    with the caller's flags untouched."""
    full = {"cudnn_enabled": True, "cudnn_allow_tf32": False,
            "cudnn_conv": "ieee", "cudnn_rnn": "ieee", "cuda_matmul": "ieee",
            "float32_matmul_precision": "highest"}
    want = full if dtype == "float32" else outside
    if inside != want:
        raise RuntimeError(f"{kind} at {dtype}: flags inside {inside}, "
                           f"expected {want}")


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


def _conv3x3_ms(x, weight, bias):
    """One cuDNN 3x3 convolution of the DCN call's shape and dtype: a
    yardstick of a dense contraction there, used nowhere in the port."""
    xc = x.permute(0, 3, 1, 2)
    wc = weight.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return time_ms(lambda: torch.nn.functional.conv2d(
        xc, wc, bias, padding=1), 3, 20)


def phase_kernel():
    """dcn_local_fwd against the plain float32 version on the same
    inputs at ``_dcn_cases()``: every neck shape at B=1 and B=8, R=2 and
    R=3, the ragged shape and the odd widths."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, h, w, cin, cout, per_frame, layers, r in _dcn_cases():
        x, offset, mask, weight, bias, _ = dcn_inputs(
            gen, b, h, w, cin, cout, r, torch.float32)
        out = dcn.deform_conv2d_local(x, offset, mask, weight, bias, r)
        ref = dcn.deform_conv2d_local_plain(x, offset, mask, weight, bias, r)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise RuntimeError(f"dcn_local_fwd {name} {cin}->{cout}: "
                               f"non-finite output")
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        del ref
        if err > REL_TOL * scale:
            raise RuntimeError(
                f"dcn_local_fwd {name} B={b} {cin}->{cout} R={r}: max abs "
                f"err {err} > {REL_TOL} * max|ref| {scale}")
        k_ms = time_ms(lambda: dcn.deform_conv2d_local(
            x, offset, mask, weight, bias, r), 3, 20)
        device_ms = queued_us(lambda: dcn.deform_conv2d_local(
            x, offset, mask, weight, bias, r), 20) / 1e3
        p_ms = time_ms(lambda: dcn.deform_conv2d_local_plain(
            x, offset, mask, weight, bias, r), 1, 5)
        bound, bound_by = dcn_bound_ms_3xtf32(b * h * w, cin, cout)
        row = {"kernel": "dcn_local_fwd", "map": name, "batch": b,
               "hw": [h, w], "cin": cin, "cout": cout, "R": r,
               "launches_per_frame": per_frame, "layers": layers,
               "plan": _plan_row(dcn.fwd_fp32_plan(b, h, w, cin, cout, r)),
               "max_abs_err": err, "max_abs_ref": scale,
               "rel_err": err / scale, "tol_rel": REL_TOL, "ms": k_ms,
               "device_ms": device_ms, "plain_ms": p_ms,
               "bound_ms": bound, "bound_by": bound_by,
               "bound_ms_fp32_cuda_cores": dcn_bound_ms(b * h * w, cin,
                                                        cout)[0],
               "library_ms": None,
               "conv3x3_cudnn_ms_other_function": _conv3x3_ms(x, weight,
                                                              bias)}
        rows.append(row)
        emit("kernel", **row)
    return rows


def _dcn_cases():
    """(map, B, H, W, Cin, Cout, launches per image, layers, R) of the
    DCN kernels' checks, at both dtypes: the neck shapes at B=1, R=1,
    one R=2 and one R=3 case (the bf16 data kernel's widest support
    walk, built for R up to 4; the float32 kernels' plans shrink their
    chunk or N tile for it), every neck shape at B=8 (the training
    step's batch), one ragged shape, whose tiles, Cin chunk and N tile
    are all partly past the map, and one of odd widths, whose rows are
    not 16-byte aligned and whose pieces of 4 and 8 channels the kernels
    copy by hand."""
    return ([(n, 1, h, w, ci, co, k, lay, 1)
             for n, h, w, ci, co, k, lay in NECK_SHAPES]
            + [("s4", 1, 136, 240, 64, 64, 0, "R=2 check", 2),
               ("s4", 1, 136, 240, 64, 64, 0, "R=3 check", 3)]
            + [(n, TRAIN_B, h, w, ci, co, k, lay, 1)
               for n, h, w, ci, co, k, lay in NECK_SHAPES]
            + [("ragged", 1, 17, 30, 72, 40, 0, "ragged check", 1),
               ("odd", 1, 17, 30, 69, 37, 0, "odd widths check", 1)])


def dcn_inputs(gen, b, h, w, cin, cout, r, dtype=torch.bfloat16):
    """Seeded inputs of one DCN call on the card, in ``dtype``: x, offset
    (spread past +/-R, so the clamp and the kinks run), mask, weight,
    bias and an output gradient."""
    def draw(f, *shape):
        return f(*shape, generator=gen, device="cuda")
    return (draw(torch.randn, b, h, w, cin).to(dtype),
            ((draw(torch.rand, b, h, w, 18) * 2 - 1) * (r + 1.5)).to(dtype),
            draw(torch.rand, b, h, w, 9).to(dtype),
            (draw(torch.randn, 3, 3, cin, cout) * 0.05).to(dtype),
            draw(torch.randn, cout).to(dtype),
            draw(torch.randn, b, h, w, cout).to(dtype))


def _plan_row(plan):
    return {k: plan[k] for k in ("route", "tile", "chunk", "n_tile", "taps",
                                 "window_slots", "warpgroups", "splits",
                                 "blocks", "smem_bytes") if k in plan}


def phase_kernel_bf16():
    """dcn_local_fwd_bf16 against the plain bf16 version on the same
    bf16 inputs, at the float32 kernel's cases, an R=3 case, every neck
    shape at B=8, a ragged shape and odd widths."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    rows = []
    for name, b, h, w, cin, cout, per_frame, layers, r in _dcn_cases():
        x, offset, mask, weight, bias, _ = dcn_inputs(
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
    plain version on the same inputs and output grad, at
    ``_dcn_cases()``, on random offsets (some past +/-R) and on all-zero
    offsets (the kinks)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    names = ("x", "offset", "mask", "weight", "bias")
    rows = []
    for name, bsz, h, w, cin, cout, per_frame, layers, r in _dcn_cases():
        x, offset, mask, weight, bias, g = dcn_inputs(
            gen, bsz, h, w, cin, cout, r, torch.float32)
        offsets = {"random": offset, "zero": torch.zeros_like(offset)}
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
            del ins, pins
            bad = {k: v for k, v in errs[kind].items()
                   if v[1] > GRAD_REL_TOL}
            if bad:
                raise RuntimeError(
                    f"DCN backward {name} B={bsz} {cin}->{cout} R={r} "
                    f"{kind} offsets: rel err {bad} > {GRAD_REL_TOL}")
        offset = offsets["random"]
        data_ms = time_ms(lambda: dcn.launch_bwd_data(
            x, offset, mask, weight, g, r), 3, 20)
        data_device_ms = queued_us(lambda: dcn.launch_bwd_data(
            x, offset, mask, weight, g, r), 20) / 1e3
        weight_ms, weight_device_ms = _weight_times(
            dcn.launch_bwd_weight, x, offset, mask, g, cout, r)
        pins = [t.clone().requires_grad_() for t in
                (x, offset, mask, weight)]
        pout = dcn.deform_conv2d_local_plain(*pins, None, r)
        plain_data_ms = time_ms(lambda: torch.autograd.grad(
            pout, pins[:3], g, retain_graph=True), 1, 3)
        plain_weight_ms = time_ms(lambda: torch.autograd.grad(
            pout, pins[3:], g, retain_graph=True), 1, 3)
        del pout, pins
        n = bsz * h * w
        (data_fp32, _), (weight_b, weight_by) = dcn_bwd_bound_ms(n, cin,
                                                                 cout)
        data_b, data_by = dcn_bwd_data_bound_ms_3xtf32(n, cin, cout)
        weight_b3, weight_by3 = dcn_bwd_weight_bound_ms_3xtf32(n, cin, cout)
        row = {"map": name, "batch": bsz, "hw": [h, w], "cin": cin,
               "cout": cout, "R": r,
               "launches_per_step_and_image": per_frame, "layers": layers,
               "data_plan": _plan_row(dcn.bwd_data_fp32_plan(
                   bsz, h, w, cin, cout, r)),
               "weight_plan": _plan_row(dcn.bwd_weight_fp32_plan(
                   bsz, h, w, cin, cout, r)),
               "weight_bit_identical_over_two_launches": True,
               "data_max_abs_err": max(e[k][0] for e in errs.values()
                                       for k in ("x", "offset", "mask")),
               "weight_max_abs_err": max(e["weight"][0]
                                         for e in errs.values()),
               "rel_err": {kind: {k: v[1] for k, v in e.items()}
                           for kind, e in errs.items()},
               "tol_rel": GRAD_REL_TOL,
               "data_ms": data_ms, "data_device_ms": data_device_ms,
               "data_plain_ms": plain_data_ms,
               "data_bound_ms": data_b, "data_bound_by": data_by,
               "data_bound_ms_fp32_cuda_cores": data_fp32,
               "weight_ms": weight_ms, "weight_device_ms": weight_device_ms,
               "weight_plain_ms": plain_weight_ms,
               "weight_bound_ms": weight_b3, "weight_bound_by": weight_by3,
               "weight_bound_ms_fp32_cuda_cores": weight_b,
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
    for name, bsz, h, w, cin, cout, per_frame, layers, r in _dcn_cases():
        x, offset, mask, weight, _, g = dcn_inputs(
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
        weight_ms, weight_device_ms = _weight_times(
            dcn.launch_bwd_weight_bf16, x, offset, mask, g, cout, r)
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
               "weight_plan": _plan_row(dcn.bwd_weight_bf16_plan(
                   bsz, h, w, cin, cout, r)),
               "weight_bit_identical_over_two_launches": True,
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
               "weight_ms": weight_ms, "weight_device_ms": weight_device_ms,
               "weight_plain_ms": plain_weight_ms,
               "weight_bound_ms": weight_b, "weight_bound_by": weight_by,
               "library_ms": None}
        rows.append(row)
        emit("grad_bf16", **row)
    return rows


def _weight_times(launch, x, offset, mask, g, cout, r):
    """A weight-gradient launcher's two launches on the same inputs must
    give a bit-identical grad w (its pixel sum runs in a fixed order);
    then its times: CUDA events around a call, and the device's time
    (queued behind a spin kernel)."""
    first = launch(x, offset, mask, g, cout, r)
    second = launch(x, offset, mask, g, cout, r)
    torch.cuda.synchronize()
    if not torch.equal(first.view(torch.int16 if first.dtype ==
                                  torch.bfloat16 else torch.int32),
                       second.view(torch.int16 if second.dtype ==
                                   torch.bfloat16 else torch.int32)):
        raise RuntimeError(f"{launch.__name__} on {tuple(x.shape)} -> "
                           f"{cout}, R={r}: two launches differ")
    return (time_ms(lambda: launch(x, offset, mask, g, cout, r), 3, 20),
            queued_us(lambda: launch(x, offset, mask, g, cout, r), 20)
            / 1e3)


# the gather route of each dtype's weight gradient, at a max offset
# whose window does not fit in shared memory: (B, H, W, Cin, Cout, R)
GATHER_CASES = {"float32": (1, 17, 30, 64, 256, 8),
                "bfloat16": (1, 17, 30, 64, 64, 16)}


def phase_gather(dtype):
    """The weight gradient's gather route (``dcn_local_bwd_weight_gather``
    or ``_bf16``) at GATHER_CASES[dtype]: the plan must choose it, one
    launch counted per call, grad w against the plain version's (float32
    at GRAD_REL_TOL, bf16 per element within BF16_ULPS ulps +
    BF16_REL_OF_MAX max|plain|), two launches bit-identical, times and
    bounds."""
    low = dtype == "bfloat16"
    b, h, w, cin, cout, r = GATHER_CASES[dtype]
    plan = (dcn.bwd_weight_bf16_plan if low else dcn.bwd_weight_fp32_plan)(
        b, h, w, cin, cout, r)
    if plan["route"] != "gather":
        raise RuntimeError(f"{dtype} weight plan at R={r}, Cout={cout}: "
                           f"{plan['route']}, expected the gather route")
    launch = dcn.launch_bwd_weight_bf16 if low else dcn.launch_bwd_weight
    kernel = "dcn_local_bwd_weight_gather" + ("_bf16" if low else "")
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, offset, mask, _, _, g = dcn_inputs(gen, b, h, w, cin, cout, r,
                                          getattr(torch, dtype))
    _reset_launches()
    out = launch(x, offset, mask, g, cout, r)
    torch.cuda.synchronize()
    if _launches()[kernel] != 1 or sum(_launches().values()) != 1:
        raise RuntimeError(f"gather route: launches {_launches()}")
    wz = torch.zeros(3, 3, cin, cout, device="cuda", dtype=x.dtype,
                     requires_grad=True)
    pout = dcn.deform_conv2d_local_plain(x, offset, mask, wz, None, r)
    ref = torch.autograd.grad(pout, [wz], g, retain_graph=True)[0]
    if low:
        err, _, past_tol = bf16_agreement(out, ref)
        if past_tol:
            raise RuntimeError(f"{kernel}: {past_tol} elements past the "
                               f"tolerance (max abs err {err})")
    else:
        err = (out - ref).abs().max().item()
        if err > GRAD_REL_TOL * ref.abs().max().item():
            raise RuntimeError(f"{kernel}: max abs err {err} > "
                               f"{GRAD_REL_TOL} max|plain|")
    ms, device_ms = _weight_times(launch, x, offset, mask, g, cout, r)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        pout, [wz], g, retain_graph=True), 1, 3)
    n = b * h * w
    bound, bound_by = (dcn_bwd_bound_ms_bf16(n, cin, cout)[1] if low else
                       dcn_bwd_weight_bound_ms_3xtf32(n, cin, cout))
    row = {"kernel": kernel, "batch": b, "hw": [h, w], "cin": cin,
           "cout": cout, "R": r, "plan": plan, "max_abs_err": err,
           "max_abs_ref": ref.float().abs().max().item(),
           "bit_identical_over_two_launches": True,
           "launches_in_check": 1, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
           "library_ms": None}
    emit("gather" if not low else "gather_bf16", **row)
    return row


# the forward and data kernels' gather routes: (R, Cin, Cout) at B=2 on
# a 17x30 map; Cout past 256 at every R, Cin 69 not a multiple of 8, and
# one case of odd widths
GATHER_ROUTE_SHAPE = (2, 17, 30)
GATHER_ROUTE_CASES = [(5, 69, 384), (5, 64, 512), (9, 69, 384),
                      (9, 64, 512), (16, 69, 384), (16, 64, 512),
                      (5, 69, 37)]
# the case whose numbers stand in the kernels line
GATHER_ROUTE_ROW = (9, 64, 512)
# the gather kernel of each (kind, dtype), its planner and the launcher
# that reaches it through the plan
GATHER_ROUTES = {
    ("fwd", "float32"): ("dcn_local_fwd_gather", "fwd_fp32_plan",
                         "launch_fwd"),
    ("fwd", "bfloat16"): ("dcn_local_fwd_gather_bf16", "fwd_bf16_plan",
                          "launch_fwd_bf16"),
    ("data", "float32"): ("dcn_local_bwd_data_gather", "bwd_data_fp32_plan",
                          "launch_bwd_data"),
    ("data", "bfloat16"): ("dcn_local_bwd_data_gather_bf16",
                           "bwd_data_bf16_plan", "launch_bwd_data_bf16"),
}


def _gather_route_bound(kind, dtype, n, cin, cout):
    """The least H100 time of a gather kernel's work: its window
    design's bound (the same function), (ms, by)."""
    if kind == "fwd":
        return (dcn_bound_ms_bf16 if dtype == "bfloat16"
                else dcn_bound_ms_3xtf32)(n, cin, cout)
    return (dcn_bwd_bound_ms_bf16(n, cin, cout)[0] if dtype == "bfloat16"
            else dcn_bwd_data_bound_ms_3xtf32(n, cin, cout))


def _timed(fn):
    """fn() and its CUDA-event time in ms (one call, e.g. the plain
    version's check call)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_gather_routes():
    """The forward and data kernels' gather routes
    (``dcn_local_fwd_gather[_bf16]``, ``dcn_local_bwd_data_gather[_bf16]``)
    at GATHER_ROUTE_CASES, both dtypes: each call with every launch count
    set to 0 just before must launch its gather kernel once and nothing
    else (through the planner's route where the plan chooses it, else
    its gather launcher directly), and agree with the plain version on
    the same inputs (float32 forward within REL_TOL of max|plain|, data
    grads within GRAD_REL_TOL each, bf16 every element within BF16_ULPS
    ulps + BF16_REL_OF_MAX max|plain|), on random offsets and, at R=5,
    on all-zero ones (the kinks); times and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, h, w = GATHER_ROUTE_SHAPE
    rows = []
    for dtype in ("float32", "bfloat16"):
        low = dtype == "bfloat16"
        for r, cin, cout in GATHER_ROUTE_CASES:
            x, offset, mask, weight, bias, g = dcn_inputs(
                gen, b, h, w, cin, cout, r, getattr(torch, dtype))
            kinds = {"random": offset}
            if r == 5:
                kinds["zero"] = torch.zeros_like(offset)
            for kind in ("fwd", "data"):
                kernel, planner, routed = GATHER_ROUTES[kind, dtype]
                plan = getattr(dcn, planner)(b, h, w, cin, cout, r)
                via = "plan" if plan["route"] == "gather" else "direct"
                launch = getattr(dcn, routed if via == "plan" else (
                    "launch_fwd_gather" if kind == "fwd"
                    else "launch_bwd_data_gather"))

                def run(off):
                    return launch(x, off, mask, weight,
                                  bias if kind == "fwd" else g, r)

                errs, plain_ms = {}, None
                for okind, off in kinds.items():
                    _reset_launches()
                    got = run(off)
                    torch.cuda.synchronize()
                    if _launches()[kernel] != 1 or sum(
                            _launches().values()) != 1:
                        raise RuntimeError(f"{kernel} R={r} {cin}->{cout}: "
                                           f"launches {_launches()}")
                    if kind == "fwd":
                        got = (got,)
                        ref, ms_ = _timed(lambda: (
                            dcn.deform_conv2d_local_plain(
                                x, off, mask, weight, bias, r),))
                    elif low:
                        ref, ms_ = _timed(lambda: _bf16_grad_ref(
                            x, off, mask, weight, g, r)[:3])
                    else:
                        ts = [t.clone().requires_grad_()
                              for t in (x, off, mask)]
                        ref, ms_ = _timed(lambda: torch.autograd.grad(
                            dcn.deform_conv2d_local_plain(
                                *ts, weight, None, r), ts, g))
                    if okind == "random":
                        plain_ms = ms_
                    names = (("out",) if kind == "fwd"
                             else ("x", "offset", "mask"))
                    errs[okind] = {}
                    for name, a, e in zip(names, got, ref):
                        if a.dtype != x.dtype or not torch.isfinite(a).all():
                            raise RuntimeError(f"{kernel} R={r} {cin}->"
                                               f"{cout} {name}: {a.dtype}, "
                                               f"or not finite")
                        scale = e.float().abs().max().item()
                        if low:
                            err, _, past = bf16_agreement(a, e)
                            bad = past > 0
                        else:
                            err = (a - e).abs().max().item()
                            tol = REL_TOL if kind == "fwd" else GRAD_REL_TOL
                            bad = err > tol * scale
                        if bad:
                            raise RuntimeError(
                                f"{kernel} B={b} {cin}->{cout} R={r} "
                                f"{okind} offsets, {name}: max abs err "
                                f"{err} (max|plain| {scale}) past the "
                                f"tolerance")
                        errs[okind][name] = {"max_abs_err": err,
                                             "max_abs_ref": scale}
                call = lambda: run(offset)
                bound, bound_by = _gather_route_bound(kind, dtype,
                                                      b * h * w, cin, cout)
                row = {"kernel": kernel, "batch": b, "hw": [h, w],
                       "cin": cin, "cout": cout, "R": r,
                       "plan_route": plan["route"], "via": via,
                       "launches_in_check": len(kinds),
                       "max_abs_err": max(e["max_abs_err"]
                                          for k in errs.values()
                                          for e in k.values()),
                       "agreement": errs,
                       "tol": ({"ulps": BF16_ULPS, "of_max": BF16_REL_OF_MAX}
                               if low else {"rel": REL_TOL if kind == "fwd"
                                            else GRAD_REL_TOL}),
                       "ms": time_ms(call, 2, 10),
                       "device_ms": queued_us(call, 10) / 1e3,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": None}
                rows.append(row)
                emit("gather_routes", **row)
    return rows


def _exact_cases():
    """(map, B, H, W, Cin, Cout, launches per frame by dla_node, layers)
    of the exact kernels' checks: the neck shapes at B=1 and at
    EXACT_BATCH (the multi-stream leg's batch), then the ragged shape and
    the odd widths of ``_dcn_cases`` and a map smaller than one tile.
    dcn_mix runs the exact op on the stride-16 and -32 maps only."""
    neck = [(n, b, h, w, ci, co,
             {"dcn": k, "dcn_mix": k if n in ("s16", "s32") else 0}, lay)
            for b in (1, EXACT_BATCH)
            for n, h, w, ci, co, k, lay in NECK_SHAPES]
    none = {"dcn": 0, "dcn_mix": 0}
    return neck + [("ragged", 1, 17, 30, 72, 40, none, "ragged"),
                   ("odd", 1, 17, 30, 69, 37, none, "odd widths"),
                   ("tiny", 2, 3, 5, 69, 37, none, "smaller than a tile")]


def exact_offsets(gen, b, h, w, spread, dtype):
    """Offsets of an exact-kernel check: ~N(0, spread), all zero, or
    ("1e6") a mix of +/-1e6 and ~N(0, 1)."""
    if spread == "1e6":
        pick = torch.randint(0, 3, (b, h, w, 18), generator=gen,
                             device="cuda")
        small = torch.randn(b, h, w, 18, generator=gen, device="cuda")
        off = torch.where(pick == 0, -1e6, torch.where(pick == 1, 1e6,
                                                       small))
    else:
        off = torch.randn(b, h, w, 18, generator=gen, device="cuda") * spread
    return off.to(dtype)


def trained_exact_inputs():
    """The inputs (x, offset, mask, weight, bias) of every exact launch
    of one eager forward of the bench's first synthetic frame through
    FusedDetector's step on the exact-trained checkpoint, by (dla_node,
    compute dtype) of EXACT_PATHS: the nodes' own offsets and masks, in
    the order the network launches them (16 at dcn, 5 at dcn_mix)."""
    params, batch_stats = load_jax_ckpt(CKPT_DCN)
    frame = synth_frames(1, seed=0)
    out = {}
    for _, node, dtype in EXACT_PATHS:
        cfg = set_heads(parse_task(Config(
            task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
            max_age=3, dla_node=node, compute_dtype=dtype)), MOT_META)
        det = FusedDetector(cfg, params, batch_stats, MOT_META,
                            device="cuda")
        kind = "exact" + ("_bf16" if dtype == "bfloat16" else "")
        rec = _RecordLaunches((kind,))
        _eager_rows(det, [frame], (rec,))
        out[node, dtype] = [tuple(args) for _, args, _ in rec.calls]
        want = sum(k for *_, k, _ in NECK_SHAPES) if node == "dcn" else 5
        if len(out[node, dtype]) != want:
            raise RuntimeError(f"{node} {dtype}: {len(out[node, dtype])} "
                               f"exact launches in a forward, not {want}")
        del det
    return out


def _exact_plan_row(plan):
    return {k: plan[k] for k in ("n_tile", "box_capacity", "window_slots",
                                 "resident", "split_rule", "splits",
                                 "blocks", "smem_bytes")}


def exact_check(kernel, args, scale_of=None):
    """One checked launch of an exact kernel on ``args`` (x, offset,
    mask, weight, bias): through its launcher with a route counter, every
    launch count set to 0 just before; exactly one launch of it and of
    nothing else; the counter equal to ``exact_tile_routes``; the result
    finite, of x's dtype, within the kernel phases' tolerance of
    deform_conv2d_plain (float32 REL_TOL of max|plain|, bf16 every element
    within BF16_ULPS ulps + BF16_REL_OF_MAX max|plain|); and a second
    launch bit for bit the first. Returns (errors, (window, gather)
    tiles, the plain version's ms)."""
    x, off, mask, weight, bias = args
    low = x.dtype == torch.bfloat16
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    plan = (dcn.exact_fwd_bf16_plan if low else dcn.exact_fwd_fp32_plan)(
        b, h, w, cin, cout)
    launch = getattr(dcn, EXACT_LAUNCHERS[kernel])
    if dcn.exact_route(x.device, x.dtype) is not launch:
        raise RuntimeError(f"{kernel}: the CUDA route is not its launcher")
    counts = torch.zeros(2, dtype=torch.int32, device="cuda")
    _reset_launches()
    with torch.no_grad():
        got = launch(x, off, mask, weight, bias, counts)
        again = launch(x, off, mask, weight, bias)
    if _launches()[kernel] != 2 or sum(_launches().values()) != 2:
        raise RuntimeError(f"{kernel}: launches {_launches()}")
    routes = tuple(counts.tolist())
    want = dcn.exact_tile_routes(off, h, w, plan)
    if routes != want:
        raise RuntimeError(f"{kernel} {b}x{h}x{w} {cin}->{cout}: route "
                           f"counts {routes}, the rule says {want}")
    if not torch.equal(got, again):
        raise RuntimeError(f"{kernel} {b}x{h}x{w} {cin}->{cout}: two "
                           f"launches differ")
    ref, plain_ms = _timed(lambda: dcn.deform_conv2d_plain(*args))
    if got.dtype != x.dtype or not torch.isfinite(got).all():
        raise RuntimeError(f"{kernel} {b}x{h}x{w} {cin}->{cout}: "
                           f"{got.dtype} output, or not finite")
    scale = ref.float().abs().max().item()
    if low:
        err, past_ulp, past = bf16_agreement(got, ref)
        bad = past > 0
    else:
        err, past_ulp = (got - ref).abs().max().item(), None
        bad = err > REL_TOL * scale
    if bad:
        raise RuntimeError(f"{kernel} {b}x{h}x{w} {cin}->{cout}: max abs "
                           f"err {err} (max|plain| {scale}) past the "
                           f"tolerance")
    errs = {"max_abs_err": err, "max_abs_ref": scale,
            "window_tiles": routes[0], "gather_tiles": routes[1]}
    if low:
        errs["elements_past_1_ulp"] = past_ulp
    return errs, routes, plain_ms


def _exact_times(kernel, args):
    """(ms per launch by CUDA events, spin-queued device ms) of an exact
    launch through its launcher."""
    launch = getattr(dcn, EXACT_LAUNCHERS[kernel])

    def call():
        with torch.no_grad():
            return launch(*args)
    return time_ms(call, 3, 20), queued_us(call, 20) / 1e3


def _batched(args, b):
    """A B=1 launch's inputs repeated to batch ``b``."""
    x, off, mask, weight, bias = args
    return (*(t.repeat(b, 1, 1, 1) for t in (x, off, mask)), weight, bias)


def phase_exact(trained):
    """dcn_exact_fwd and dcn_exact_fwd_bf16 (csrc/dcn_exact.cu) against
    deform_conv2d_plain by ``exact_check`` at ``_exact_cases()``, each on
    offsets of every EXACT_OFFSETS kind and, at the neck shapes, on
    ``trained`` (``trained_exact_inputs``): every launch of the dcn
    forward of the kernel's dtype whose shape it is, repeated to the
    case's batch. Times (per launch, spin-queued device time, the plain
    version's) on the ~N(0, 3) offsets and on the trained inputs (their
    mean over the shape's nodes), the plan, the window share of each
    kind, the bound and the launches per frame of each path; then the 5
    exact launches of dcn_mix's bf16 forward, each checked and timed
    (phase ``exact_dcn_mix``)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for dtype in ("float32", "bfloat16"):
        low = dtype == "bfloat16"
        kernel = "dcn_exact_fwd" + ("_bf16" if low else "")
        tdt = getattr(torch, dtype)
        for name, b, h, w, cin, cout, per_frame, layers in _exact_cases():
            x, _, mask, weight, bias, _ = dcn_inputs(gen, b, h, w, cin, cout,
                                                     1, tdt)
            errs, timed = {}, None
            for spread in EXACT_OFFSETS:
                off = exact_offsets(gen, b, h, w, spread, tdt)
                errs[str(spread)], _, plain_ms = exact_check(
                    kernel, (x, off, mask, weight, bias))
                if timed is None:
                    timed = ((x, off, mask, weight, bias), plain_ms)
            args, plain_ms = timed
            ms, device_ms = _exact_times(kernel, args)
            nodes = [a for a in trained["dcn", dtype]
                     if (a[0].shape[1:], a[3].shape[3]) == ((h, w, cin),
                                                           cout)]
            if per_frame["dcn"] and len(nodes) != per_frame["dcn"]:
                raise RuntimeError(f"{name} {cin}->{cout}: {len(nodes)} "
                                   f"trained launches, expected "
                                   f"{per_frame['dcn']}")
            trained_rows = []
            for i, node in enumerate(nodes):
                node = _batched(node, b)
                errs[f"trained_{i}"], _, node_plain = exact_check(kernel,
                                                                   node)
                t_ms, t_dev = _exact_times(kernel, node)
                trained_rows.append({"ms": t_ms, "device_ms": t_dev,
                                     "plain_ms": node_plain})
            plan = (dcn.exact_fwd_bf16_plan if low else
                    dcn.exact_fwd_fp32_plan)(b, h, w, cin, cout)
            bound, bound_by = (dcn_bound_ms_bf16 if low else
                               dcn_bound_ms_3xtf32)(b * h * w, cin, cout)
            mean = lambda k: (statistics.mean(r[k] for r in trained_rows)
                              if trained_rows else None)
            share = lambda kinds: (
                sum(e["window_tiles"] for k, e in errs.items() if kinds(k))
                / max(1, sum(e["window_tiles"] + e["gather_tiles"]
                             for k, e in errs.items() if kinds(k))))
            row = {"kernel": kernel, "map": name, "batch": b, "hw": [h, w],
                   "cin": cin, "cout": cout,
                   "launches_per_frame": per_frame, "layers": layers,
                   "plan": _exact_plan_row(plan),
                   "window_share": {
                       "n3": share(lambda k: k == "3.0"),
                       "trained": (share(lambda k: k.startswith("trained"))
                                   if trained_rows else None)},
                   "max_abs_err": max(e["max_abs_err"]
                                      for e in errs.values()),
                   "by_offsets": errs,
                   "tol": ({"ulps": BF16_ULPS, "of_max": BF16_REL_OF_MAX}
                           if low else {"rel": REL_TOL}),
                   "two_launches_bitwise_equal": True,
                   "ms": ms, "device_ms": device_ms,
                   "ms_trained": mean("ms"),
                   "device_ms_trained": mean("device_ms"),
                   "trained_nodes": trained_rows,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": bound_by, "library_ms": None}
            if not low:
                row["bound_ms_fp32_cuda_cores"] = dcn_bound_ms(
                    b * h * w, cin, cout)[0]
            rows.append(row)
            emit("exact", **row)
    mix = []
    for args in trained["dcn_mix", "bfloat16"]:
        errs, routes, plain_ms = exact_check("dcn_exact_fwd_bf16", args)
        ms, device_ms = _exact_times("dcn_exact_fwd_bf16", args)
        x, weight = args[0], args[3]
        mix.append({"hw": list(x.shape[1:3]), "cin": x.shape[3],
                    "cout": weight.shape[3], **errs, "ms": ms,
                    "device_ms": device_ms, "plain_ms": plain_ms,
                    "bound_ms": dcn_bound_ms_bf16(
                        x.shape[1] * x.shape[2], x.shape[3],
                        weight.shape[3])[0]})
    mix_row = {"kernel": "dcn_exact_fwd_bf16", "node": "dcn_mix",
               "launches": mix,
               "ms_per_frame": sum(r["ms"] for r in mix),
               "device_ms_per_frame": sum(r["device_ms"] for r in mix),
               "bound_ms_per_frame": sum(r["bound_ms"] for r in mix),
               "window_share": sum(r["window_tiles"] for r in mix) / sum(
                   r["window_tiles"] + r["gather_tiles"] for r in mix)}
    emit("exact_dcn_mix", **mix_row)
    return rows, mix_row


def _exact_grad_ref(x, offset, mask, weight, g):
    """Autograd of deform_conv2d_plain on CUDA: the grads of x, offset,
    mask and weight, in x's dtype (bf16: the float32 vjp on the bf16
    values, each gradient rounded once)."""
    ts = [t.clone().requires_grad_() for t in (x, offset, mask, weight)]
    return torch.autograd.grad(dcn.deform_conv2d_plain(*ts), ts, g)


def _exact_bwd_plan_row(plan):
    return {k: plan[k] for k in (
        "tile", "chunk", "warpgroups", "k_tile", "pieces", "n_tile",
        "m_tiles", "stages", "taps", "groups", "window_slots",
        "box_capacity", "resident", "splits", "blocks", "smem_bytes")
        if k in plan}


def exact_grad_check(args, g):
    """One checked backward of the exact op on ``args`` (x, offset, mask,
    weight, bias) and output grad ``g``: through ``deform_conv2d`` with
    every input needing a gradient, which must route to DCNExact and
    launch the forward, data and weight kernels of the dtype once each
    and nothing else (every launch count set to 0 just before); each
    gradient finite, of x's dtype, against autograd of
    deform_conv2d_plain (float32 within GRAD_REL_TOL of max|plain|, bf16
    every element within BF16_ULPS ulps + BF16_REL_OF_MAX max|plain|),
    the bias grad the float32 sum of g; then the data and weight
    launchers with route counters, equal to ``exact_bwd_tile_routes`` and
    ``exact_tile_routes``, the data launch also counting its reductions
    into grad x on the device (at most 36 Cin a pixel, in the errors as
    ``data_reductions``), and a second launch of each whose grad offset,
    grad mask and grad w are bit for bit the first's. Returns (errors,
    data routes, weight routes, the plain autograd's ms)."""
    x, off, mask, weight, bias = args
    low = x.dtype == torch.bfloat16
    sfx = "_bf16" if low else ""
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    what = f"exact backward{sfx} {b}x{h}x{w} {cin}->{cout}"
    if dcn.exact_route(x.device, x.dtype, True) != dcn.DCNExact.apply:
        raise RuntimeError(f"{what}: the CUDA route with a gradient is not "
                           f"DCNExact")
    ins = [t.clone().requires_grad_() for t in args]
    _reset_launches()
    dcn.deform_conv2d(*ins).backward(g)
    mine = {k + sfx for k in ("dcn_exact_fwd", "dcn_exact_bwd_data",
                              "dcn_exact_bwd_weight")}
    if _launches() != {k: int(k in mine) for k in _launches()}:
        raise RuntimeError(f"{what}: launches {_launches()}")
    ref, plain_ms = _timed(lambda: _exact_grad_ref(x, off, mask, weight, g))
    errs = {}
    for name, got, rf in zip(("x", "offset", "mask", "weight"),
                             (t.grad for t in ins), ref):
        if got.dtype != x.dtype or not torch.isfinite(got).all():
            raise RuntimeError(f"{what}: grad {name} {got.dtype}, or not "
                               f"finite")
        scale = rf.float().abs().max().item()
        if low:
            err, past_ulp, past = bf16_agreement(got, rf)
            bad = past > 0
        else:
            err, past_ulp = (got - rf).abs().max().item(), None
            bad = err > GRAD_REL_TOL * scale
        if bad:
            raise RuntimeError(f"{what}: grad {name} max abs err {err} "
                               f"(max|plain| {scale}) past the tolerance")
        errs[name] = {"max_abs_err": err, "max_abs_ref": scale}
        if low:
            errs[name]["elements_past_1_ulp"] = past_ulp
    if not torch.equal(ins[4].grad, g.float().sum((0, 1, 2)).to(g.dtype)):
        raise RuntimeError(f"{what}: grad bias is not the sum of g")
    data, weight_fn = (getattr(dcn, f) for f in EXACT_BWD_LAUNCHERS[
        "bfloat16" if low else "float32"])
    counts = [torch.zeros(2, dtype=torch.int32, device="cuda")
              for _ in range(2)]
    reduced = torch.zeros(1, dtype=torch.int64, device="cuda")
    first = (*data(x, off, mask, weight, g, counts[0], reduced)[1:],
             weight_fn(x, off, mask, g, cout, counts[1]))
    second = (*data(x, off, mask, weight, g)[1:],
              weight_fn(x, off, mask, g, cout))
    if not all(torch.equal(a, c) for a, c in zip(first, second)):
        raise RuntimeError(f"{what}: grad offset, mask or weight differ "
                           f"over two launches")
    planners = ((dcn.exact_bwd_data_bf16_plan, dcn.exact_bwd_weight_bf16_plan)
                if low else (dcn.exact_bwd_data_fp32_plan,
                             dcn.exact_bwd_weight_fp32_plan))
    want = (dcn.exact_bwd_tile_routes(off, mask, h, w,
                                      planners[0](b, h, w, cin, cout)),
            dcn.exact_tile_routes(off, h, w, planners[1](b, h, w, cin,
                                                         cout)))
    routes = tuple(tuple(c.tolist()) for c in counts)
    if routes != want:
        raise RuntimeError(f"{what}: route counts (data, weight) {routes}, "
                           f"the rules say {want}")
    errs["data_routes"], errs["weight_routes"] = routes
    errs["data_reductions"] = int(reduced)
    if not 0 <= errs["data_reductions"] <= 36 * cin * b * h * w:
        raise RuntimeError(f"{what}: {errs['data_reductions']} reductions "
                           f"into grad x, past 36 Cin a pixel")
    return errs, routes, plain_ms


def _exact_bwd_times(args, g):
    """(data ms, data device ms, weight ms, weight device ms, plain data
    ms, plain weight ms): the two launchers by CUDA events and
    spin-queued device time, and the plain version's autograd of the
    same gradients (from one forward, as phase_grad times it)."""
    x, off, mask, weight, _ = args
    low = x.dtype == torch.bfloat16
    data, weight_fn = (getattr(dcn, f) for f in EXACT_BWD_LAUNCHERS[
        "bfloat16" if low else "float32"])
    cout = weight.shape[3]
    call_d = lambda: data(x, off, mask, weight, g)
    call_w = lambda: weight_fn(x, off, mask, g, cout)
    pins = [t.clone().requires_grad_() for t in (x, off, mask, weight)]
    pout = dcn.deform_conv2d_plain(*pins)
    out = (time_ms(call_d, 3, 20), queued_us(call_d, 20) / 1e3,
           time_ms(call_w, 3, 20), queued_us(call_w, 20) / 1e3,
           time_ms(lambda: torch.autograd.grad(pout, pins[:3], g,
                                               retain_graph=True), 1, 3),
           time_ms(lambda: torch.autograd.grad(pout, pins[3:], g,
                                               retain_graph=True), 1, 3))
    del pout, pins
    return out


def _exact_bwd_bounds(args, low):
    """(data bound, its kind, weight bound, its kind) of one call on
    these inputs, from their corner counts."""
    x, off, mask, weight, _ = args
    n = x.shape[0] * x.shape[1] * x.shape[2]
    cin, cout = x.shape[3], weight.shape[3]
    needed, live = exact_corner_counts(off, mask)
    data = (exact_bwd_data_bound_ms_bf16 if low else
            exact_bwd_data_bound_ms_3xtf32)(n, cin, cout, needed, live)
    weight_ = (exact_bwd_weight_bound_ms_bf16 if low else
               exact_bwd_weight_bound_ms_3xtf32)(n, cin, cout, live)
    return (*data, *weight_)


def phase_exact_grad(trained, dtype):
    """The exact op's backward kernels of ``dtype`` by
    ``exact_grad_check`` at ``_exact_cases()`` and one output grad wider
    than a G piece (Cout 384), each on offsets of every
    EXACT_OFFSETS kind and, at the neck shapes, on ``trained``
    (``trained_exact_inputs``: every launch of the dcn forward of the
    dtype whose shape it is, repeated to the case's batch), each with a
    seeded output grad. Times of both kernels (per launch, spin-queued
    device time, the plain autograd's) and their bounds on the ~N(0, 3)
    offsets and on the trained inputs (their mean over the shape's
    nodes), both plans, the window shares, the launches per training
    step and image by dla_node."""
    low = dtype == "bfloat16"
    phase = "exact_grad" + ("_bf16" if low else "")
    gen = torch.Generator(device="cuda").manual_seed(15)
    tdt = getattr(torch, dtype)
    rows = []
    wide = ("wide", 1, 17, 30, 64, 384, {"dcn": 0, "dcn_mix": 0},
            "an output grad past one G piece (EXACT_DATA_MAX_K)")
    for name, b, h, w, cin, cout, per_frame, layers in (_exact_cases()
                                                        + [wide]):
        x, _, mask, weight, bias, g = dcn_inputs(gen, b, h, w, cin, cout, 1,
                                                 tdt)
        errs, timed = {}, None
        for spread in EXACT_OFFSETS:
            off = exact_offsets(gen, b, h, w, spread, tdt)
            args = (x, off, mask, weight, bias)
            errs[str(spread)], _, plain_ms = exact_grad_check(args, g)
            if timed is None:
                timed = args
        t_n3 = _exact_bwd_times(timed, g)
        bounds_n3 = _exact_bwd_bounds(timed, low)
        nodes = [a for a in trained["dcn", dtype]
                 if (a[0].shape[1:], a[3].shape[3]) == ((h, w, cin), cout)]
        if per_frame["dcn"] and len(nodes) != per_frame["dcn"]:
            raise RuntimeError(f"{name} {cin}->{cout}: {len(nodes)} trained "
                               f"launches, expected {per_frame['dcn']}")
        trained_rows = []
        for i, node in enumerate(nodes):
            node = _batched(node, b)
            gt = torch.randn(b, h, w, cout, generator=gen,
                             device="cuda").to(tdt)
            errs[f"trained_{i}"], _, _ = exact_grad_check(node, gt)
            t = _exact_bwd_times(node, gt)
            bd = _exact_bwd_bounds(node, low)
            trained_rows.append({
                "data_ms": t[0], "data_device_ms": t[1], "weight_ms": t[2],
                "weight_device_ms": t[3], "data_plain_ms": t[4],
                "weight_plain_ms": t[5], "data_bound_ms": bd[0],
                "weight_bound_ms": bd[2],
                "data_reductions": errs[f"trained_{i}"]["data_reductions"]})
        mean = lambda k: (statistics.mean(r[k] for r in trained_rows)
                          if trained_rows else None)
        share = lambda which, kinds: (
            sum(e[which + "_routes"][0] for k, e in errs.items() if kinds(k))
            / max(1, sum(sum(e[which + "_routes"]) for k, e in errs.items()
                         if kinds(k))))
        planners = ((dcn.exact_bwd_data_bf16_plan,
                     dcn.exact_bwd_weight_bf16_plan) if low else
                    (dcn.exact_bwd_data_fp32_plan,
                     dcn.exact_bwd_weight_fp32_plan))
        row = {"map": name, "batch": b, "hw": [h, w], "cin": cin,
               "cout": cout, "launches_per_step_and_image": per_frame,
               "layers": layers,
               "data_plan": _exact_bwd_plan_row(planners[0](b, h, w, cin,
                                                            cout)),
               "weight_plan": _exact_bwd_plan_row(planners[1](b, h, w, cin,
                                                              cout)),
               "window_share": {
                   which: {"n3": share(which, lambda k: k == "3.0"),
                           "trained": (share(which, lambda k: k.startswith(
                               "trained")) if trained_rows else None)}
                   for which in ("data", "weight")},
               "data_max_abs_err": max(e[k]["max_abs_err"]
                                       for e in errs.values()
                                       for k in ("x", "offset", "mask")),
               "weight_max_abs_err": max(e["weight"]["max_abs_err"]
                                         for e in errs.values()),
               "by_offsets": errs,
               "tol": ({"ulps": BF16_ULPS, "of_max": BF16_REL_OF_MAX}
                       if low else {"rel": GRAD_REL_TOL}),
               "weight_offset_mask_bit_identical_over_two_launches": True,
               "data_ms": t_n3[0], "data_device_ms": t_n3[1],
               "weight_ms": t_n3[2], "weight_device_ms": t_n3[3],
               "data_plain_ms": t_n3[4], "weight_plain_ms": t_n3[5],
               "data_bound_ms": bounds_n3[0], "data_bound_by": bounds_n3[1],
               "weight_bound_ms": bounds_n3[2],
               "weight_bound_by": bounds_n3[3],
               **{k + "_trained": mean(k) for k in (
                   "data_ms", "data_device_ms", "weight_ms",
                   "weight_device_ms", "data_plain_ms", "weight_plain_ms",
                   "data_bound_ms", "weight_bound_ms", "data_reductions")},
               "trained_nodes": trained_rows, "library_ms": None}
        rows.append(row)
        emit(phase, **row)
    return rows


def phase_path_exact(phase, node, dtype, ref_packed=None, n_profile=0):
    """``phase_path`` of ``node`` at ``dtype`` on the exact-trained
    checkpoint, then three more checks of the serving engine on it:
    ``run_chunk`` over the first 2 CHUNK frames from a fresh state in
    chunks of CHUNK (its own graph), every row bit for bit the path's;
    a two-stream MultiStreamDetector (stream s at frame i reads frame
    i + s MULTI_OFFSET) over EAGER_FRAMES + 2 steps, every step after the
    capture under the sync-debug mode, its first step on the eager step
    bit for bit the replay; and the bench's lag-4 protocol on device
    frames. ``n_profile``: a profile phase of that many frames after the
    path. Returns (row, packed rows)."""
    from centertrack_tpu_torch.engine.fused import MultiStreamDetector
    row, det, frames, cfg, packed = phase_path(dtype, ref_packed, node,
                                               phase)
    if n_profile:
        phase_profile(det, frames, cfg, n_profile, "profile_" + phase)
    det.reset_tracking()
    rows = []
    for i in range(2):
        with sync_errors() if i else contextlib.nullcontext():
            res = det.run_chunk(frames[i * CHUNK:(i + 1) * CHUNK])
        FusedDetector.fetch_chunk(res, cfg.out_thresh)
        rows += list(res.cpu().numpy())
    _bitwise(f"{phase}: run_chunk against run", rows, packed[:2 * CHUNK])
    torch.cuda.reset_peak_memory_stats()
    dev_frames = [torch.as_tensor(f, device="cuda") for f in frames]
    fps, live, run_host = timed_lag(
        det.run, lambda r: [det.fetch(r, cfg.out_thresh)], dev_frames,
        LAG_FRAMES, LAG_WARMUP, LAG)
    peak_lag = torch.cuda.max_memory_allocated() / 2 ** 20
    del det
    torch.cuda.empty_cache()
    params, batch_stats = load_jax_ckpt(CKPT_DCN)
    multi = MultiStreamDetector(cfg, 2, params, batch_stats, MOT_META,
                                device="cuda")
    n = len(frames)
    steps = [[frames[(i + MULTI_OFFSET * s) % n] for s in range(2)]
             for i in range(EAGER_FRAMES + 2)]
    replays = []
    for i, step in enumerate(steps):
        with sync_errors() if i else contextlib.nullcontext():
            res = multi.run(step)
        multi.fetch_all(res, cfg.out_thresh)
        replays.append(res.cpu().numpy())
        if res.shape != (2, cfg.K, 13) or not np.isfinite(replays[-1]).all():
            raise RuntimeError(f"{phase}: two-stream result {res.shape}")
    eager = _eager_rows(multi, steps[:1])
    _bitwise(f"{phase}: two-stream eager step against its replay", eager,
             replays[:1])
    del multi
    torch.cuda.empty_cache()
    row = {**row, "run_chunk_rows_bitwise_equal_to_path": len(rows),
           "two_stream_steps": len(steps),
           "two_stream_eager_steps_bitwise_equal_to_replays": 1,
           "lag4_fps": fps, "lag4_rows_per_frame": live,
           "lag4_host_ms_per_run_median": run_host,
           "lag4_max_memory_allocated_mb": peak_lag}
    emit(phase + "_serving", **{k: row[k] for k in (
        "run_chunk_rows_bitwise_equal_to_path", "two_stream_steps",
        "two_stream_eager_steps_bitwise_equal_to_replays", "lag4_fps",
        "lag4_rows_per_frame", "lag4_host_ms_per_run_median",
        "lag4_max_memory_allocated_mb", "ms_per_frame_median",
        "max_memory_allocated_mb", "memory_allocated_mb_at_start")})
    return row, packed


def phase_lifetimes(check=True):
    """Device memory a deleted detector leaves behind (ROADMAP C8): makes
    and deletes the LIFETIME_DETECTORS in turn, each serving
    LIFETIME_FRAMES frames through its graph (the first call captures),
    reading torch.cuda.memory_allocated() after gc.collect() and a
    synchronise before each construction and after each deletion, then
    once more after torch._C._cuda_clearCublasWorkspaces(), which frees
    the cuBLAS workspace kept for every stream cuBLAS has run on: what
    that reading drops is what the workspaces held. With ``check``, what
    is still allocated after the last deletion must lie within
    LIFETIME_BOUND_MB of what was allocated before the first
    construction."""
    params, batch_stats = load_jax_ckpt(CKPT)
    frames = synth_frames(LIFETIME_FRAMES, seed=0)

    def live_mb():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() / 2 ** 20
    start = live_mb()
    readings = []
    for node, dtype in LIFETIME_DETECTORS:
        cfg = set_heads(parse_task(Config(
            task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
            max_age=3, dla_node=node, compute_dtype=dtype)), MOT_META)
        before = live_mb()
        det = FusedDetector(cfg, params, batch_stats, MOT_META,
                            device="cuda")
        for f in frames:
            FusedDetector.fetch(det.run(f), cfg.out_thresh)
        serving = live_mb()
        del det
        readings.append({"dla_node": node, "compute_dtype": dtype,
                         "mb_before": before, "mb_serving": serving,
                         "mb_after_delete": live_mb()})
    end = live_mb()
    torch._C._cuda_clearCublasWorkspaces()
    cleared = live_mb()
    row = {"detectors": readings, "frames_each": LIFETIME_FRAMES,
           "mb_before_first": start, "mb_after_last": end,
           "mb_left_behind": end - start,
           "mb_after_clearing_cublas_workspaces": cleared,
           "mb_held_by_cublas_workspaces": end - cleared,
           "bound_mb": LIFETIME_BOUND_MB if check else None}
    emit("lifetimes", **row)
    if check and end - start > LIFETIME_BOUND_MB:
        raise RuntimeError(f"deleted detectors left {end - start:.1f} MB "
                           f"allocated (bound {LIFETIME_BOUND_MB} MB)")
    return row


def _kept_rows(packed, out_thresh, margin, collapse_ties):
    """The rows above ``out_thresh``, without those within ``margin`` of
    it; with ``collapse_ties``, a row is left out whose score equals that
    of an earlier kept row within 2 MATCH_PX of it (two neighbouring
    peaks of one object that both passed the 3x3 NMS: one output pixel
    apart plus their sub-pixel offsets). Distinct objects whose scores
    happen to be equal are both kept."""
    rows = [d for d in FusedDetector.fetch(torch.from_numpy(packed),
                                           out_thresh)
            if abs(d["score"] - out_thresh) > margin]
    if collapse_ties:
        kept = []
        for d in rows:
            if not any(k["score"] == d["score"] and float(np.abs(
                    k["ct"] - d["ct"]).max()) <= 2 * MATCH_PX for k in kept):
                kept.append(d)
        rows = kept
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
    max-pool NMS. With ``collapse_ties``, two pairs of a frame that swap
    their track ids are also counted apart (``pairs_swapped_on_exact_tie``,
    left out of the one-to-one map) where the two rows of one path have
    exactly equal scores: such rows have no score order, so the order in
    which the tracker numbered them is the decode's tie-break and not
    the network's. ``unpaired_scores`` are the scores of the rows left
    unpaired."""
    counts, unpaired, pairs, same_ids, swapped = [], [], 0, 0, 0
    score, box, id_map = 0.0, 0.0, {}
    for a, b in zip(packed, ref_packed):
        ra = _kept_rows(a, out_thresh, margin, collapse_ties)
        rb = _kept_rows(b, out_thresh, margin, collapse_ties)
        counts.append([len(ra), len(rb)])
        free = list(rb)
        differ = []
        for da in ra:
            dist = [float(np.abs(da["ct"] - db["ct"]).max()) for db in free]
            if not dist or min(dist) > MATCH_PX:
                unpaired.append(da["score"])
                continue
            db = free.pop(int(np.argmin(dist)))
            pairs += 1
            if da["tracking_id"] == db["tracking_id"]:
                same_ids += 1
                id_map.setdefault(da["tracking_id"], set()).add(
                    db["tracking_id"])
            else:
                differ.append((da, db))
            score = max(score, abs(da["score"] - db["score"]))
            box = max(box, float(np.abs(da["bbox"] - db["bbox"]).max()))
        tied = set()
        if collapse_ties:
            for i, (a1, b1) in enumerate(differ):
                for j, (a2, b2) in enumerate(differ[:i]):
                    if (a1["tracking_id"] == b2["tracking_id"]
                            and a2["tracking_id"] == b1["tracking_id"]
                            and (a1["score"] == a2["score"]
                                 or b1["score"] == b2["score"])
                            and not {i, j} & tied):
                        tied |= {i, j}
        swapped += len(tied)
        for i, (da, db) in enumerate(differ):
            if i not in tied:
                id_map.setdefault(da["tracking_id"], set()).add(
                    db["tracking_id"])
        unpaired += [db["score"] for db in free]
    mapped = [next(iter(v)) for v in id_map.values() if len(v) == 1]
    return {"rows_per_frame": counts, "rows_unpaired": len(unpaired),
            "unpaired_scores": unpaired, "pairs": pairs,
            "pairs_same_track_id": same_ids,
            "pairs_swapped_on_exact_tie": swapped,
            "track_ids_one_to_one": (len(mapped) == len(id_map) ==
                                     len(set(mapped))),
            "max_score_diff": score, "max_bbox_diff_px": box}


@contextlib.contextmanager
def sync_errors():
    """While active, a host synchronisation with the card raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def device_kernel_counts(run_once, n, names):
    """torch.profiler over n calls of run_once (each ends on the host):
    the device launches of each kernel of ``names`` (KERNEL_NAMES keys),
    by its name in the trace; graph replays launch no wrapper, so this
    is what counts them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # idle margins inside the window: the trace drops device events
        # that it places past either end of it, which took the first
        # kernel of the first replay or the last ones of the last replay
        # out of the count in some runs
        time.sleep(PROFILE_EDGE_S)
        for _ in range(n):
            run_once()
        torch.cuda.synchronize()
        time.sleep(PROFILE_EDGE_S)
    counts = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if re.search(KERNEL_NAMES[name], e.key):
                    counts[name] += e.count
    return counts


def _check_device_counts(phase, counts, want):
    if counts != want:
        raise RuntimeError(f"{phase}: device launches {counts} over the "
                           f"profiled replays, expected {want}")


class _RecordTracker:
    """While active, keeps a copy of the inputs and the output of every
    launch of the tracker kernels, to hold each against its plain
    version afterwards (``check``)."""

    LAUNCHERS = {"greedy_assign": "launch_greedy_assign",
                 "splat_pre_hm": "launch_splat_pre_hm"}

    def __enter__(self):
        self.modules = _tracker_modules()
        self.calls = []
        self._saved = {k: getattr(self.modules[k], f)
                       for k, f in self.LAUNCHERS.items()}

        def recording(kind, launch):
            def run(*args):
                out = launch(*args)
                self.calls.append((kind, [a.clone() if torch.is_tensor(a)
                                          else a for a in args],
                                   out.clone()))
                return out
            return run

        for kind, f in self.LAUNCHERS.items():
            setattr(self.modules[kind], f, recording(kind, self._saved[kind]))
        return self

    def __exit__(self, *exc):
        for kind, f in self.LAUNCHERS.items():
            setattr(self.modules[kind], f, self._saved[kind])

    def check(self, per_kind):
        """Requires ``per_kind`` launches of each kernel; greedy_assign
        must equal the plain version exactly, splat_pre_hm lie within
        SPLAT_TOL of it with the same support. Returns the worst max abs
        error of each."""
        tracker, gaussian = (self.modules[k] for k in TRACKER_KERNELS)
        counts = {k: sum(c[0] == k for c in self.calls)
                  for k in self.LAUNCHERS}
        if counts != dict.fromkeys(self.LAUNCHERS, per_kind):
            raise RuntimeError(f"recorded tracker launches {counts}, "
                               f"expected {per_kind} of each")
        worst = dict.fromkeys(self.LAUNCHERS, 0.0)
        for kind, args, out in self.calls:
            if kind == "greedy_assign":
                ref = tracker.greedy_assign_plain(*args)
                if not torch.equal(out, ref):
                    raise RuntimeError(
                        f"greedy_assign differs from its plain version at "
                        f"{(out != ref).sum().item()} of {out.numel()} rows")
                continue
            ref = gaussian.splat_pre_hm_plain(*args)
            err = (out - ref).abs().max().item()
            if err > SPLAT_TOL or not torch.equal(out > 0, ref > 0):
                raise RuntimeError(
                    f"splat_pre_hm against its plain version: max abs err "
                    f"{err} (tolerance {SPLAT_TOL}), support differs at "
                    f"{((out > 0) != (ref > 0)).sum().item()} pixels")
            worst[kind] = max(worst[kind], err)
        return worst

    def last_with_live_slots(self, kind):
        """The inputs of the last launch of ``kind`` whose map held a live
        track (the path's shapes, for timing)."""
        for k, args, _ in reversed(self.calls):
            if k == kind and (kind == "greedy_assign" or args[-1].any()):
                return args
        raise RuntimeError(f"no {kind} launch with a live track recorded")


def _eager_rows(det, steps, records=()):
    """``steps`` (each a list of the detector's S frames) through its
    eager step (no graph) from a fresh state: the step a graph captures,
    run as it is. The context managers of ``records`` are active for the
    first step. Returns the (S, K, 13) rows of each step on the host."""
    from centertrack_tpu_torch.engine import device_tracker as dt
    from centertrack_tpu_torch.engine.fused import _Carried
    n = det.streams
    carried = _Carried(dt.init_state(det.capacity, n, det.device),
                       torch.zeros_like(det._carried.pre),
                       torch.ones(n, dtype=torch.bool, device=det.device))
    h, w = steps[0][0].shape[:2]
    trans = det._transforms(h, w)
    out = torch.empty((1, n, det.cfg.K, 13), device=det.device)
    rows = []
    for i, step in enumerate(steps):
        frames = torch.as_tensor(np.stack(step), device=det.device)[None]
        with contextlib.ExitStack() as stack:
            if i == 0:
                for r in records:
                    stack.enter_context(r)
            det._step(frames, carried, out, trans)
        rows.append(out[0].cpu().numpy().copy())
    return rows


def counted_replays(phase, replay_all, names, want, ref_rows):
    """A path's counted run: every launch count set to 0 just before,
    then ``replay_all`` (the path's steps again from a fresh state, each
    a replay of a graph already captured; returns its rows) under
    torch.profiler. Its rows must equal ``ref_rows`` bit for bit, no
    wrapper may have been called (a replay calls none), and the device
    must have launched ``want`` of each kernel of ``names``, counted by
    kernel name. Returns those device launches, the path's count."""
    _reset_launches()
    rows = []
    launches = device_kernel_counts(lambda: rows.extend(replay_all()), 1,
                                    names)
    _bitwise(f"{phase}: the counted replays against the checked run", rows,
             ref_rows)
    calls = {**_launches(), **_tracker_launches()}
    if any(calls.values()):
        raise RuntimeError(f"{phase}: replays called wrappers {calls}")
    _check_device_counts(phase, launches, want)
    return launches


def _bitwise(kind, rows, ref_rows):
    """Raises unless the two lists of (K, 13) rows are equal bit for bit."""
    for i, (a, b) in enumerate(zip(rows, ref_rows)):
        if not np.array_equal(a, b):
            cols = sorted(set(np.nonzero(a != b)[1].tolist()))
            raise RuntimeError(
                f"{kind}: frame {i} differs (columns {cols}, max "
                f"{np.abs(a - b).max()})")
    if len(rows) != len(ref_rows):
        raise RuntimeError(f"{kind}: {len(rows)} frames against "
                           f"{len(ref_rows)}")


def greedy_bound_ms(s, k, t):
    """Least H100 time for greedy_assign: dist read once and the match
    written once, against one comparison per entry (the bytes bound)."""
    return _bound_ms(s * k * t, 4.0 * (s * k * t + s * k))


def splat_bound_ms(height, width, cts_int, radii, valid):
    """Least H100 time for splat_pre_hm on these inputs: the canvas
    written once and the slots read once, against 8 float32 operations
    per pixel of each live slot's clipped window (two squares, a sum, a
    division, the exp, the product by k, the compare)."""
    s, t = valid.shape
    r = radii.clamp(max=_tracker_modules()["splat_pre_hm"].MAX_RADIUS
                    ).long()
    cx, cy = cts_int[..., 0].long(), cts_int[..., 1].long()
    wx = ((cx + r).clamp(max=width - 1) - (cx - r).clamp(min=0) + 1).clamp(
        min=0)
    wy = ((cy + r).clamp(max=height - 1) - (cy - r).clamp(min=0) + 1
          ).clamp(min=0)
    pixels = int((wx * wy * valid.long()).sum())
    return _bound_ms(8.0 * pixels,
                     4.0 * s * height * width + 17.0 * s * t)


def tracker_kernel_rows(rec):
    """Per tracker kernel, on the last recorded inputs with a live track
    (the path's shapes): the call's time (median of CUDA events around
    each call, the launcher's host time included), its device time
    (``queued_us``: each call queued behind a spin kernel), the plain
    version's time, the bound (for greedy_assign also the dependency
    chain's: its live rows x one shared-memory round trip)."""
    tracker, gaussian = (_tracker_modules()[k] for k in TRACKER_KERNELS)
    rows = {}
    args = rec.last_with_live_slots("greedy_assign")
    s, k, t = args[0].shape
    bound, by = greedy_bound_ms(s, k, t)
    live = int(((args[0] < 1e16) | args[0].isnan()).any(-1).sum(-1).max())
    kernel = lambda: tracker.launch_greedy_assign(*args)
    rows["greedy_assign"] = {
        "shape": [s, k, t], "live_rows": live,
        "chain_bound_ms": live * SMEM_ROUND_TRIP_NS / 1e6,
        "ms": time_ms(kernel, 5, 50),
        "device_ms": queued_us(kernel, 50) / 1e3,
        "plain_ms": time_ms(lambda: tracker.greedy_assign_plain(*args), 1,
                            5),
        "bound_ms": bound, "bound_by": by}
    args = rec.last_with_live_slots("splat_pre_hm")
    bound, by = splat_bound_ms(*args[:3], args[3], args[5])
    kernel = lambda: gaussian.launch_splat_pre_hm(*args)
    rows["splat_pre_hm"] = {
        "shape": [args[0], args[1], *args[5].shape],
        "live_slots": int(args[5].sum()), "ms": time_ms(kernel, 5, 50),
        "device_ms": queued_us(kernel, 50) / 1e3,
        "plain_ms": time_ms(lambda: gaussian.splat_pre_hm_plain(*args), 1,
                            5),
        "bound_ms": bound, "bound_by": by}
    return rows


# the tracker phase: greedy_assign on K rows at S streams and T slots,
# splat_pre_hm on the 544x960 canvas with T = 256 slots
TRACKER_K = 100
TRACKER_STREAMS = (1, 6)
TRACKER_SLOTS = (256, 1024)
GREEDY_CASES = ("path", "ties", "nan", "all_live", "exhaustion", "between")
SPLAT_CASES = ("path", "edges", "dense", "empty")
SPLAT_HW = (544, 960)
# the least time of one dependent shared-memory access on the H100 (about
# 30 SM cycles by microbenchmarks of Hopper's shared memory, at the
# 1.98 GHz boost clock): greedy_assign's serial pass takes at least one
# such step per live row
SMEM_ROUND_TRIP_NS = 30 / 1.98


def greedy_case(name, s, t, seed):
    """(S, K, T) float32 distances of one adversarial case, from a numpy
    seed: ``path`` about 10 live rows a stream with a few valid tracks
    each (the serving step's frames), ``ties`` integer distances,
    ``nan`` a NaN in a column an earlier row took and one in an untaken
    column, ``all_live`` every row live, ``exhaustion`` every row the
    same (each row's candidates taken by earlier rows: a rescan per row
    from the fifth on), ``between`` entries in [1e16, 1e18) with a few
    below."""
    rng = np.random.RandomState(seed)
    k = TRACKER_K
    d = np.full((s, k, t), 1e18, np.float32)
    if name == "path":
        for st in range(s):
            for i in rng.choice(k // 4, 10, replace=False):
                cols = rng.choice(min(t, 64), rng.randint(1, 4),
                                  replace=False)
                d[st, i, cols] = rng.uniform(0, 400, len(cols))
    elif name == "ties":
        d = rng.randint(0, 3, (s, k, t)).astype(np.float32)
        d[rng.rand(s, k, t) < 0.3] = 1e18
    elif name == "nan":
        d = rng.uniform(0, 100, (s, k, t)).astype(np.float32)
        d[:, :3] = 1e18
        d[:, 0, 5] = 0.0               # row 0 takes column 5
        d[:, 1, [5, 7]] = [np.nan, 1.0]  # a NaN in the taken column
        d[:, 2, [9, 11]] = [np.nan, 0.5]  # a NaN untaken: no match
    elif name == "all_live":
        d = rng.uniform(0, 100, (s, k, t)).astype(np.float32)
    elif name == "exhaustion":
        d[:] = rng.uniform(0, 100, (s, 1, t)).astype(np.float32)
    else:
        d[rng.rand(s, k, t) < 0.5] = 5e16
        d[:, ::7, 3] = 2e15
    return d


def splat_case(name, s, t, seed):
    """(cts, radii, ks, valid) of one splat case on SPLAT_HW, from a
    numpy seed: ``path`` about 10 live slots a stream, radii 2-30;
    ``edges`` centres on and past the map's edges and corners and on
    tile borders, radii negative and past the cap, 70% valid;
    ``dense`` every slot valid, radii 40-200; ``empty`` no valid slot."""
    h, w = SPLAT_HW
    rng = np.random.RandomState(seed)
    cts = np.stack([rng.randint(-20, w + 20, (s, t)),
                    rng.randint(-20, h + 20, (s, t))], -1).astype(np.int32)
    radii = rng.randint(2, 31, (s, t)).astype(np.int32)
    ks = rng.uniform(0.1, 1.0, (s, t)).astype(np.float32)
    valid = np.zeros((s, t), bool)
    if name == "path":
        for st in range(s):
            valid[st, rng.choice(t, 10, replace=False)] = True
    elif name == "edges":
        radii = rng.randint(-3, 200, (s, t)).astype(np.int32)
        cts[:, :6] = [[127, 15], [128, 16], [0, 0], [w - 1, h - 1],
                      [-5, h // 2], [w + 3, 7]]
        valid = rng.rand(s, t) < 0.7
    elif name == "dense":
        radii = rng.randint(40, 201, (s, t)).astype(np.int32)
        valid[:] = True
    return tuple(torch.from_numpy(a).cuda() for a in (cts, radii, ks,
                                                        valid))


def _device_kernels(fn):
    """The device activities of one call of ``fn`` under torch.profiler:
    {name: count}, memsets and copies included."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _one_node(name, fn):
    """Raises unless one call of ``fn`` is one launch of kernel ``name``
    on the device and nothing else (no memset, no copy)."""
    seen = _device_kernels(fn)
    if len(seen) != 1 or not re.search(KERNEL_NAMES[name], next(iter(
            seen))) or next(iter(seen.values())) != 1:
        raise RuntimeError(f"{name}: one call ran {seen} on the device, "
                           f"expected one launch of its kernel alone")
    return seen


def phase_tracker():
    """The tracker kernels alone: greedy_assign on GREEDY_CASES at each
    of TRACKER_STREAMS x TRACKER_SLOTS, exactly its plain version;
    splat_pre_hm on SPLAT_CASES at each of TRACKER_STREAMS (T = 256),
    within SPLAT_TOL of its plain version with the same support; each
    call with the counts set to 0 just before must count one launch;
    one call of each is one kernel on the device (no memset); device
    time per call (spin-queued), the bytes bound and, for greedy_assign,
    the dependency-chain bound (live rows x one shared-memory round
    trip)."""
    tracker, gaussian = (_tracker_modules()[k] for k in TRACKER_KERNELS)
    rows = []
    for ci, name in enumerate(GREEDY_CASES):
        for s in TRACKER_STREAMS:
            for t in TRACKER_SLOTS:
                d = greedy_case(name, s, t, 100 * ci + s + t)
                dist = torch.from_numpy(d).cuda()
                _reset_launches()
                got = tracker.launch_greedy_assign(dist)
                torch.cuda.synchronize()
                if _tracker_launches() != {"greedy_assign": 1,
                                           "splat_pre_hm": 0}:
                    raise RuntimeError(f"greedy_assign {name}: launches "
                                       f"{_tracker_launches()}")
                ref = tracker.greedy_assign_plain(dist.cpu())
                if not torch.equal(got.cpu(), ref):
                    raise RuntimeError(
                        f"greedy_assign {name} S={s} T={t}: differs from "
                        f"its plain version at "
                        f"{(got.cpu() != ref).sum().item()} rows")
                live = int(((d < 1e16) | np.isnan(d)).any(-1).sum(-1).max())
                kernel = lambda: tracker.launch_greedy_assign(dist)
                bound, by = greedy_bound_ms(s, TRACKER_K, t)
                row = {"kernel": "greedy_assign", "case": name,
                       "shape": [s, TRACKER_K, t], "live_rows": live,
                       "matched": int((ref >= 0).sum()),
                       "ms": time_ms(kernel, 5, 30),
                       "device_ms": queued_us(kernel, 30) / 1e3,
                       "bound_ms": bound, "bound_by": by,
                       "chain_bound_ms": live * SMEM_ROUND_TRIP_NS / 1e6}
                rows.append(row)
                emit("tracker", **row)
    for ci, name in enumerate(SPLAT_CASES):
        for s in TRACKER_STREAMS:
            args = (*SPLAT_HW, *splat_case(name, s, 256, 7 * ci + s))
            _reset_launches()
            got = gaussian.launch_splat_pre_hm(*args)
            torch.cuda.synchronize()
            if _tracker_launches() != {"greedy_assign": 0,
                                       "splat_pre_hm": 1}:
                raise RuntimeError(f"splat_pre_hm {name}: launches "
                                   f"{_tracker_launches()}")
            ref = gaussian.splat_pre_hm_plain(*args)
            err = (got - ref).abs().max().item()
            if err > SPLAT_TOL or not torch.equal(got > 0, ref > 0):
                raise RuntimeError(
                    f"splat_pre_hm {name} S={s}: max abs err {err} "
                    f"(tolerance {SPLAT_TOL}), support differs at "
                    f"{((got > 0) != (ref > 0)).sum().item()} pixels")
            kernel = lambda: gaussian.launch_splat_pre_hm(*args)
            bound, by = splat_bound_ms(*args[:4], args[5])
            row = {"kernel": "splat_pre_hm", "case": name,
                   "shape": [s, *SPLAT_HW, 256],
                   "live_slots": int(args[5].sum()), "max_abs_err": err,
                   "ms": time_ms(kernel, 5, 30),
                   "device_ms": queued_us(kernel, 30) / 1e3,
                   "plain_ms": _timed(lambda: gaussian.splat_pre_hm_plain(
                       *args))[1],
                   "bound_ms": bound, "bound_by": by}
            rows.append(row)
            emit("tracker", **row)
    # inputs made before the profiled call, which must run one kernel
    dist = torch.from_numpy(greedy_case("path", 1, 256, 0)).cuda()
    slots = splat_case("path", 1, 256, 0)
    torch.cuda.synchronize()
    nodes = {
        "greedy_assign": _one_node(
            "greedy_assign", lambda: tracker.launch_greedy_assign(dist)),
        "splat_pre_hm": _one_node(
            "splat_pre_hm",
            lambda: gaussian.launch_splat_pre_hm(*SPLAT_HW, *slots))}
    emit("tracker", device_activities_of_one_call=nodes)
    return rows


def phase_path(dtype="float32", ref_packed=None, node="dcn_local1",
               phase=None):
    """The serving path of ``node`` at ``dtype`` over PATH_FRAMES frames
    (dcn_local1 on the committed local1 checkpoint, the other nodes on the
    exact-trained one), its DCN kernels by PATH_KERNELS; with
    ``ref_packed`` (the float32 path's rows) its rows are compared with
    those. Returns (row, detector, frames, cfg, packed rows)."""
    phase = phase or ("path" if dtype == "float32" else "path_bf16")
    kernels = PATH_KERNELS[node, dtype]
    cfg = set_heads(parse_task(Config(
        task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
        max_age=3, dla_node=node, compute_dtype=dtype)), MOT_META)
    params, batch_stats = load_jax_ckpt(
        CKPT if node == "dcn_local1" else CKPT_DCN)
    frames = synth_frames(PATH_FRAMES, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold counts in the peak; it is read here
    live_mb = torch.cuda.memory_allocated() / 2 ** 20
    det = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda")

    # every frame a graph replay: the first call also runs the eager step
    # once (warm-up, on copies of the state) and captures it; every call
    # after it runs with host synchronisation an error
    _reset_launches()
    flags_outside = read_flags()
    times, run_ms, n_dets, packed, states = [], [], [], [], []
    for i, f in enumerate(frames):
        if len(states) < PLAIN_FRAMES:
            states.append((det.track_state, det.pre_images))
        t = time.perf_counter()
        with sync_errors() if i else contextlib.nullcontext():
            res = det.run(f)
        run_ms.append(1e3 * (time.perf_counter() - t))
        items = FusedDetector.fetch(res, cfg.out_thresh)
        times.append(1e3 * (time.perf_counter() - t))
        n_dets.append(len(items))
        packed.append(res.cpu().numpy())
        if res.shape != (cfg.K, 13) or not torch.isfinite(res).all():
            raise RuntimeError(f"bad packed result {tuple(res.shape)}")
    counts, tcounts = _launches(), _tracker_launches()
    if read_flags() != flags_outside:
        raise RuntimeError("FusedDetector.run did not restore the flags")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    live = int(det.track_state.valid.sum())
    # the wrappers run twice, at the warm-up and at the capture; replays
    # launch no wrapper
    want = {k: 2 * kernels.get(k, 0) for k in counts}
    if counts != want or tcounts != dict.fromkeys(TRACKER_KERNELS, 2):
        raise RuntimeError(f"wrapper calls over {PATH_FRAMES} frames at "
                           f"{dtype}: {counts}, {tcounts}; expected {want} "
                           f"and 2 of each tracker kernel")
    if sum(n_dets) == 0:
        raise RuntimeError("no detection above out_thresh in any frame")

    # the counted run: the same frames from a fresh state, every one a
    # replay; its device launches are the path's launches
    def replay_all():
        det.reset_tracking()
        out = []
        for f in frames:
            res = det.run(f)
            FusedDetector.fetch(res, cfg.out_thresh)
            out.append(res.cpu().numpy())
        return out
    launches = counted_replays(
        phase, replay_all, tuple(kernels) + TRACKER_KERNELS,
        {**{k: n * PATH_FRAMES for k, n in kernels.items()},
         **dict.fromkeys(TRACKER_KERNELS, PATH_FRAMES)}, packed)

    # the first frames again on the eager step, no graph: the replays'
    # rows bit for bit. Its first frame's 16 DCN launches are held
    # against the plain version on their own inputs and the flags are
    # read inside; every tracker launch is held against its plain version
    kinds = {RECORD_KIND[k]: n for k, n in kernels.items()}
    flags_inside, hook = _flags_inside(det.model)
    rec, trec = _RecordLaunches(tuple(kinds)), _RecordTracker()
    with trec:
        eager = _eager_rows(det, [[f] for f in frames[:EAGER_FRAMES]],
                            (rec,))
    hook.remove()
    _check_flags("the serving step", dtype, flags_inside[0], flags_outside)
    _bitwise(f"{phase} eager step against its graph replays",
             [r[0] for r in eager], packed[:EAGER_FRAMES])
    launch_worst = max(rec.check(kinds).values())
    tracker_worst = trec.check(EAGER_FRAMES)
    tracker_rows = tracker_kernel_rows(trec)

    # same frames, DCN on the plain PyTorch version. float32: from a
    # fresh state, the two paths must stay together. bf16: each frame
    # from the kernel path's own state before it, since one flipped ulp
    # can make two neighbouring peaks tie and add a track
    plain = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda",
                          plain_dcn=True)
    low = dtype != "float32"
    plain_times, plain_packed = [], []
    before = _launches()
    for i, f in enumerate(frames[:PLAIN_FRAMES]):
        if low:
            plain.track_state, plain.pre_images = states[i]
        t = time.perf_counter()
        res = plain.run(f)
        FusedDetector.fetch(res, cfg.out_thresh)
        plain_times.append(1e3 * (time.perf_counter() - t))
        plain_packed.append(res.cpu().numpy())
    if _launches() != before:
        raise RuntimeError("the plain-DCN run launched a DCN kernel")
    del plain
    margin = PLAIN_SCORE_TOL[dtype] if low else 0.0
    vs_plain = rows_against(packed[:PLAIN_FRAMES], plain_packed,
                            cfg.out_thresh, margin, collapse_ties=low)
    if vs_plain["rows_unpaired"] or not vs_plain["pairs"] or (
            vs_plain["pairs_same_track_id"]
            + vs_plain["pairs_swapped_on_exact_tie"] != vs_plain["pairs"]):
        raise RuntimeError(f"rows or track ids differ between the kernel "
                           f"and the plain DCN at {dtype}: {vs_plain}")
    if vs_plain["max_score_diff"] > PLAIN_SCORE_TOL[dtype]:
        raise RuntimeError(f"kernel vs plain DCN at {dtype}: score diff "
                           f"{vs_plain['max_score_diff']} > "
                           f"{PLAIN_SCORE_TOL[dtype]}")
    row = {"compute_dtype": dtype, "dla_node": node,
           "kernel": "+".join(kernels), "kernels_per_frame": kernels,
           "flags_outside": flags_outside,
           "flags_inside_step": flags_inside[0],
           "frames": PATH_FRAMES, "input": [cfg.input_h, cfg.input_w],
           "warp_precision": det.warp_precision,
           "ms_per_frame_median": statistics.median(times[PATH_WARMUP:]),
           "host_ms_per_run_median": statistics.median(run_ms[PATH_WARMUP:]),
           "ms_first_call_with_capture": times[0],
           "dets_per_frame": n_dets, "live_tracks_end": live,
           "launches": launches,
           "launches_counted": "device launches over the counted run of "
                               f"{PATH_FRAMES} replayed frames, by kernel "
                               "name (torch.profiler)",
           "wrapper_calls": {**{k: counts[k] for k in kernels}, **tcounts},
           "eager_frames_bitwise_equal_to_replays": EAGER_FRAMES,
           "tracker_max_abs_err": tracker_worst,
           "tracker_kernels": tracker_rows,
           "plain_dcn_frames": PLAIN_FRAMES,
           "plain_dcn_ms_per_frame": plain_times,
           "plain_vs_kernel_max_score_diff": vs_plain["max_score_diff"],
           "plain_vs_kernel_max_bbox_diff_px": vs_plain["max_bbox_diff_px"],
           "plain_vs_kernel_score_tol": PLAIN_SCORE_TOL[dtype],
           "plain_vs_kernel_rows": vs_plain["rows_per_frame"],
           "plain_vs_kernel_pairs": vs_plain["pairs"],
           "plain_vs_kernel_pairs_swapped_on_exact_tie":
               vs_plain["pairs_swapped_on_exact_tie"],
           "first_frame_launch_worst_rel_err": launch_worst,
           "max_memory_allocated_mb": peak_mb,
           "memory_allocated_mb_at_start": live_mb}
    if ref_packed is not None:
        row["vs_float32_path"] = rows_against(
            packed, ref_packed, cfg.out_thresh, margin, collapse_ties=low)
    emit(phase, **row)
    return row, det, frames, cfg, packed


def timed_lag(run, fetch, inputs, iters, warmup, lag):
    """bench.py's protocols (timed_tracking, timed_tracking_chunked, the
    6-stream leg): ``run`` on the inputs in turn, every result fetched
    ``lag`` calls behind its run, after ``warmup`` calls fetched to the
    end; ``fetch`` returns one row list per frame or stream. Returns
    (calls per second, mean rows per frame or stream, median host ms per
    run call)."""
    pend = collections.deque()
    for i in range(warmup):
        pend.append(run(inputs[i % len(inputs)]))
        if len(pend) > lag:
            fetch(pend.popleft())
    while pend:
        fetch(pend.popleft())
    rows, host = [], []
    t0 = time.perf_counter()
    for i in range(iters):
        t = time.perf_counter()
        pend.append(run(inputs[(warmup + i) % len(inputs)]))
        host.append(1e3 * (time.perf_counter() - t))
        if len(pend) > lag:
            rows += map(len, fetch(pend.popleft()))
    while pend:
        rows += map(len, fetch(pend.popleft()))
    dt = time.perf_counter() - t0
    return iters / dt, float(np.mean(rows)), statistics.median(host)


def phase_chunk(det, frames, cfg, path_packed, n_profile=0):
    """``run_chunk`` over the path's frames from a fresh state, in chunks
    of CHUNK and a last one of 2: every row bit for bit the path's (the
    same kernels on the same inputs, unrolled in one graph). Then the
    bench's lag-4 and chunk-4 protocols timed."""
    dtype = cfg.compute_dtype
    phase = "chunk" if dtype == "float32" else "chunk_bf16"
    kernel, = PATH_KERNELS["dcn_local1", dtype]
    det.reset_tracking()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    sizes = [CHUNK] * (PATH_FRAMES // CHUNK) + (
        [PATH_FRAMES % CHUNK] if PATH_FRAMES % CHUNK else [])
    rows, host_ms, start = [], [], 0
    for j, n in enumerate(sizes):
        captured = n in sizes[:j]
        t = time.perf_counter()
        with sync_errors() if captured else contextlib.nullcontext():
            res = det.run_chunk(frames[start:start + n])
        host_ms.append(1e3 * (time.perf_counter() - t))
        FusedDetector.fetch_chunk(res, cfg.out_thresh)
        rows += list(res.cpu().numpy())
        start += n
    _bitwise(f"{phase}: run_chunk against run", rows, path_packed)
    counts, tcounts = _launches(), _tracker_launches()
    captured_frames = 2 * sum(set(sizes))
    if counts[kernel] != 16 * captured_frames or \
            tcounts != dict.fromkeys(TRACKER_KERNELS, captured_frames):
        raise RuntimeError(f"{phase}: wrapper calls {counts[kernel]}, "
                           f"{tcounts}; expected {16 * captured_frames} and "
                           f"{captured_frames} of each tracker kernel")

    # the counted run: the same chunks from a fresh state, all replays
    def replay_all():
        det.reset_tracking()
        out, start = [], 0
        for n in sizes:
            res = det.run_chunk(frames[start:start + n])
            FusedDetector.fetch_chunk(res, cfg.out_thresh)
            out += list(res.cpu().numpy())
            start += n
        return out
    launches = counted_replays(
        phase, replay_all, (kernel,) + TRACKER_KERNELS,
        {kernel: 16 * PATH_FRAMES,
         **dict.fromkeys(TRACKER_KERNELS, PATH_FRAMES)}, rows)
    peak_rows = torch.cuda.max_memory_allocated() / 2 ** 20
    # device-resident frames and chunks, as bench.py times them
    n = len(frames)
    dev_frames = [torch.as_tensor(f, device="cuda") for f in frames]
    dev_chunks = [torch.as_tensor(np.stack(
        [frames[(i * CHUNK + j) % n] for j in range(CHUNK)]), device="cuda")
        for i in range((n + CHUNK - 1) // CHUNK)]
    fps, live, run_host = timed_lag(
        det.run, lambda r: [det.fetch(r, cfg.out_thresh)], dev_frames,
        LAG_FRAMES, LAG_WARMUP, LAG)
    cps, clive, chunk_host = timed_lag(
        det.run_chunk, lambda r: det.fetch_chunk(r, cfg.out_thresh),
        dev_chunks, CHUNK_ITERS, CHUNK_WARMUP, 1)
    cfps = cps * CHUNK
    row = {"compute_dtype": dtype, "chunks": sizes,
           "rows_bitwise_equal_to_path": len(rows),
           "host_ms_per_run_chunk": host_ms,
           "launches": launches,
           "wrapper_calls": {kernel: counts[kernel], **tcounts},
           "lag4_fps": fps, "lag4_rows_per_frame": live,
           "lag4_host_ms_per_run_median": run_host,
           "chunk4_fps": cfps, "chunk4_rows_per_frame": clive,
           "chunk4_host_ms_per_run_chunk_median": chunk_host,
           "max_memory_allocated_mb_rows": peak_rows,
           "max_memory_allocated_mb": torch.cuda.max_memory_allocated()
           / 2 ** 20,
           "memory_reserved_mb": torch.cuda.memory_reserved() / 2 ** 20}
    emit(phase, **row)
    if n_profile:
        more = iter([torch.as_tensor(np.stack(frames[i:i + CHUNK]),
                                     device="cuda")
                     for i in range(0, CHUNK * n_profile, CHUNK)])
        _profile(lambda: FusedDetector.fetch_chunk(
            det.run_chunk(next(more)), cfg.out_thresh), n_profile,
            "profile_" + phase, "chunk")
    return row


def phase_multistream(path_packed):
    """MultiStreamDetector at float32 with two streams and at bf16 with
    MULTI_STREAMS (stream s at frame i reads frame i + s * MULTI_OFFSET
    of the path's clip). At each: the first EAGER_FRAMES steps through
    the eager step, bit for bit the replays, with the first step's 16
    DCN launches and every tracker launch held against their plain
    versions on their own inputs; a counted run of replays. float32:
    stream 1 reset before step MULTI_RESET_AT; each stream against
    single-stream tracking of its frames (stream 0: the path's rows):
    the same track ids, scores within PLAIN_SCORE_TOL (cuDNN may take
    other algorithms at batch 2). bf16: each stream's rows at every step
    against a single-stream bf16 FusedDetector started from that
    stream's state before the step (at bf16 one flipped ulp can make two
    peaks tie and add a track, so no clip-long comparison): scores within
    PLAIN_SCORE_TOL, ids one to one, no unpaired row but within twice
    that of out_thresh; then the bench's 6-stream leg at lag 4."""
    from centertrack_tpu_torch.engine import device_tracker as dt
    from centertrack_tpu_torch.engine.fused import MultiStreamDetector
    params, batch_stats = load_jax_ckpt(CKPT)
    frames = synth_frames(PATH_FRAMES, seed=0)
    n = len(frames)

    def cfg_at(dtype):
        return set_heads(parse_task(Config(
            task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
            max_age=3, dla_node="dcn_local1", compute_dtype=dtype)),
            MOT_META)

    def steps_of(streams):
        return [[frames[(i + MULTI_OFFSET * s) % n] for s in range(streams)]
                for i in range(n)]

    def run_steps(det, steps, out_thresh, reset_at=None, sync=False,
                  beside=None):
        """``steps`` through the detector from a fresh state, stream 1
        reset before step ``reset_at``, every step after the first under
        the sync-debug mode with ``sync``; ``beside(i, state, pre)`` is
        handed the state before step i. Returns each step's rows."""
        det.reset_tracking()
        out = []
        for i, images in enumerate(steps):
            if i == reset_at:
                det.reset_stream(1)
            if beside is not None:
                beside(i, det.track_state, det.pre_images)
            with sync_errors() if sync and i else contextlib.nullcontext():
                res = det.run(images)
            det.fetch_all(res, out_thresh)
            out.append(res.cpu().numpy())
        return out

    def eager_and_counted(phase, det, steps, rows, reset_at=None):
        """The eager steps against the replays' ``rows``, every recorded
        launch against its plain version, then the counted run."""
        dtype = det.cfg.compute_dtype
        kind = "bf16" if dtype != "float32" else "fwd"
        rec, trec = _RecordLaunches((kind,)), _RecordTracker()
        with trec:
            eager = _eager_rows(det, steps[:EAGER_FRAMES], (rec,))
        _bitwise(f"{phase}: the eager step against its graph replays", eager,
                 rows[:EAGER_FRAMES])
        kernel, = PATH_KERNELS["dcn_local1", dtype]
        launches = counted_replays(
            phase, lambda: run_steps(det, steps, det.cfg.out_thresh,
                                     reset_at),
            (kernel,) + TRACKER_KERNELS,
            {kernel: 16 * len(steps),
             **dict.fromkeys(TRACKER_KERNELS, len(steps))}, rows)
        return {"launches": launches,
                "eager_steps_bitwise_equal_to_replays": EAGER_FRAMES,
                "dcn_launch_worst_rel_err": rec.check(16)[kind],
                "tracker_max_abs_err": trec.check(EAGER_FRAMES)}

    cfg = cfg_at("float32")
    single = FusedDetector(cfg, params, batch_stats, MOT_META, device="cuda")
    single_rows = []
    for i in range(n):
        if i == MULTI_RESET_AT:
            single.reset_tracking()
        single_rows.append(single.run(frames[(i + MULTI_OFFSET) % n]).cpu()
                           .numpy())
    del single
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    det = MultiStreamDetector(cfg, 2, params, batch_stats, MOT_META,
                              device="cuda")
    steps2 = steps_of(2)
    multi = run_steps(det, steps2, cfg.out_thresh, MULTI_RESET_AT, sync=True)
    tcounts = _tracker_launches()
    s2 = eager_and_counted("multistream", det, steps2, multi,
                           MULTI_RESET_AT)
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 20
    del det
    torch.cuda.empty_cache()
    vs = {}
    for s, ref in ((0, path_packed), (1, single_rows)):
        v = vs[s] = rows_against([m[s] for m in multi], ref, cfg.out_thresh)
        if v["rows_unpaired"] or not v["pairs"] or \
                v["pairs_same_track_id"] != v["pairs"] or \
                v["max_score_diff"] > PLAIN_SCORE_TOL["float32"]:
            raise RuntimeError(f"multistream stream {s} against single-"
                               f"stream tracking: {v}")

    # bf16, MULTI_STREAMS streams
    cfg6 = cfg_at("bfloat16")
    tol = PLAIN_SCORE_TOL["bfloat16"]
    steps6 = steps_of(MULTI_STREAMS)
    det = MultiStreamDetector(cfg6, MULTI_STREAMS, params, batch_stats,
                              MOT_META, device="cuda")
    single = FusedDetector(cfg6, params, batch_stats, MOT_META,
                           device="cuda")
    single6 = [[] for _ in range(MULTI_STREAMS)]

    def beside(i, state, pre):
        for s in range(MULTI_STREAMS):
            single.track_state = dt.TrackState(*(t[s:s + 1] for t in state))
            single.pre_images = None if pre is None else pre[s:s + 1]
            single6[s].append(single.run(steps6[i][s]).cpu().numpy())

    multi6 = run_steps(det, steps6, cfg6.out_thresh, sync=True,
                       beside=beside)
    del single
    s6 = eager_and_counted("multistream_bf16", det, steps6, multi6)
    # rows within ``tol`` of out_thresh are left out on each side, and a
    # pair's scores may differ by up to ``tol``, so a row within 2 tol of
    # the threshold may lose its partner to that band: such a row may
    # stay unpaired, no other
    vs6 = {"pairs": 0, "pairs_same_track_id": 0, "max_score_diff": 0.0,
           "max_bbox_diff_px": 0.0, "unpaired_in_band": []}
    for s in range(MULTI_STREAMS):
        for i in range(n):
            v = rows_against([multi6[i][s]], [single6[s][i]],
                             cfg6.out_thresh, tol, collapse_ties=True)
            band = all(abs(x - cfg6.out_thresh) <= 2 * tol
                       for x in v["unpaired_scores"])
            if not band or not v["track_ids_one_to_one"] or \
                    v["max_score_diff"] > tol:
                raise RuntimeError(f"multistream bf16 stream {s} step {i} "
                                   f"against a single stream: {v}")
            vs6["unpaired_in_band"] += [[s, i, x]
                                        for x in v["unpaired_scores"]]
            for key in ("pairs", "pairs_same_track_id"):
                vs6[key] += v[key]
            for key in ("max_score_diff", "max_bbox_diff_px"):
                vs6[key] = max(vs6[key], v[key])
    if not vs6["pairs"]:
        raise RuntimeError("multistream bf16: no row above out_thresh")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the bench's 6-stream leg, on device-resident frames
    stk = [torch.as_tensor(np.stack(step), device="cuda") for step in steps6]
    steps, rows6, host6 = timed_lag(
        det.run, lambda r: det.fetch_all(r, cfg6.out_thresh), stk,
        MULTI_ITERS, MULTI_WARMUP, LAG)
    peak6 = torch.cuda.max_memory_allocated() / 2 ** 20
    del det
    torch.cuda.empty_cache()
    row = {"float32_streams": 2, "frames": n, "offset": MULTI_OFFSET,
           "reset_stream_1_at": MULTI_RESET_AT,
           "vs_single_stream": vs, "wrapper_calls_s2": tcounts,
           **{k + "_s2": v for k, v in s2.items()},
           "max_memory_allocated_mb_s2": peak2,
           "bf16_streams": MULTI_STREAMS,
           "bf16_vs_single_stream_per_step": vs6,
           "bf16_vs_single_stream_score_tol": tol,
           **{k + "_s6": v for k, v in s6.items()},
           "bf16_steps": MULTI_ITERS,
           "bf16_aggregate_fps": steps * MULTI_STREAMS,
           "bf16_rows_per_stream_frame": rows6,
           "bf16_host_ms_per_run_median": host6,
           "max_memory_allocated_mb_s6": peak6}
    emit("multistream", **row)
    return row


def _profile(run_once, n, phase, unit):
    """torch.profiler over n calls of run_once (each ends on the host):
    device time by kernel, the port's kernels summed over their
    template builds, the share of the wall time the device was busy, and
    the host operators with the most self CPU time (inflated by the
    profiler's own cost, but in the same proportion for both dtypes),
    per ``unit``; emits them and returns them."""
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
    port_kernels = {}
    for e in events:
        m = re.search(r"dcn_local\w*|dcn_exact\w*|greedy_assign|"
                      r"splat_pre_hm", e.key)
        if m:
            d = port_kernels.setdefault(m.group(0), {f"calls_per_{unit}": 0.0,
                                                    f"ms_per_{unit}": 0.0})
            d[f"calls_per_{unit}"] += e.count / n
            d[f"ms_per_{unit}"] += e.self_device_time_total / 1e3 / n
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:12]
    row = {unit + "s": n, f"wall_ms_per_{unit}": wall_ms / n,
           f"device_busy_ms_per_{unit}": busy_ms / n,
           "device_idle_share": 1 - busy_ms / wall_ms,
           f"device_kernels_per_{unit}": sum(e.count for e in events) / n,
           "top": [{"name": e.key[:80], f"calls_per_{unit}": e.count / n,
                    f"ms_per_{unit}": e.self_device_time_total / 1e3 / n}
                   for e in top],
           "port_kernels": port_kernels,
           "host_top": [{"name": e.key[:80],
                         f"calls_per_{unit}": e.count / n,
                         f"self_cpu_ms_per_{unit}":
                             e.self_cpu_time_total / 1e3 / n}
                        for e in host]}
    emit(phase, **row)
    return row


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
    default; "bf16", "data_bf16" and "weight_bf16" are the bf16 ones,
    "exact" and "exact_bf16" the exact forwards, "exact_data",
    "exact_weight" and their "_bf16" twins the exact backward's), to hold
    each against the plain version on the same inputs afterwards
    (``check``)."""

    ALL = {"fwd": "launch_fwd", "data": "launch_bwd_data",
           "weight": "launch_bwd_weight", "bf16": "launch_fwd_bf16",
           "data_bf16": "launch_bwd_data_bf16",
           "weight_bf16": "launch_bwd_weight_bf16",
           "exact": "launch_exact_fwd", "exact_bf16": "launch_exact_fwd_bf16",
           "exact_data": "launch_exact_bwd_data",
           "exact_weight": "launch_exact_bwd_weight",
           "exact_data_bf16": "launch_exact_bwd_data_bf16",
           "exact_weight_bf16": "launch_exact_bwd_weight_bf16"}
    LOW = ("bf16", "data_bf16", "weight_bf16", "exact_bf16",
           "exact_data_bf16", "exact_weight_bf16")

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
        """Requires ``per_kind`` recorded launches of each kernel (a count,
        or a count by kind) and holds each against the plain version on
        its own inputs (forward at REL_TOL, backward at GRAD_REL_TOL, the
        bf16 kernels at BF16_ULPS ulps + BF16_REL_OF_MAX max|ref| per
        element). Returns the worst rel err (max abs err over max|ref|)
        per kernel."""
        want = (per_kind if isinstance(per_kind, dict)
                else dict.fromkeys(self.LAUNCHERS, per_kind))
        counts = {k: sum(c[0] == k for c in self.calls)
                  for k in self.LAUNCHERS}
        if counts != want:
            raise RuntimeError(f"recorded DCN launches {counts}, expected "
                               f"{per_kind} of each kernel")
        worst = dict.fromkeys(self.LAUNCHERS, 0.0)
        for kind, args, outs in self.calls:
            if kind in ("exact_data", "exact_weight", "exact_data_bf16",
                        "exact_weight_bf16"):
                if "data" in kind:
                    ref = _exact_grad_ref(*args[:5])[:3]
                else:
                    x, offset, mask, g, cout = args[:5]
                    w = torch.zeros(3, 3, x.shape[3], cout, device=x.device,
                                    dtype=x.dtype)
                    ref = _exact_grad_ref(x, offset, mask, w, g)[3:]
            if kind in self.LOW:
                if kind == "exact_bf16":
                    with torch.no_grad():
                        ref = [dcn.deform_conv2d_plain(*args)]
                elif kind in ("exact_data_bf16", "exact_weight_bf16"):
                    pass
                elif kind == "bf16":
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
            if kind in ("fwd", "exact"):
                plain = (dcn.deform_conv2d_local_plain if kind == "fwd"
                         else dcn.deform_conv2d_plain)
                with torch.no_grad():
                    ref = [plain(*args)]
                names, tol = ("out",), REL_TOL
            elif kind == "exact_data":
                names, tol = ("x", "offset", "mask"), GRAD_REL_TOL
            elif kind == "exact_weight":
                names, tol = ("weight",), GRAD_REL_TOL
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


def _train_cfg(dtype, node="dcn_local1"):
    return set_heads(parse_task(Config(
        task="tracking", pre_hm=True, dla_node=node,
        batch_size=TRAIN_B, lr=TRAIN_LR, compute_dtype=dtype)), MOT_META)


def _b1_step(cfg, params, batch_stats, one, plain, kinds=None):
    """One B=1 training step from the checkpoint, DCN on the kernels or
    on its plain version; with ``kinds`` (each kind's launches a step)
    every DCN launch is recorded and held against the plain version.
    Returns (the step's record, its gradients)."""
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
        rec_row["launch_worst_rel_err"] = rec.check(kinds)
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


def phase_train(n_profile=0, dtype="float32", node="dcn_local1",
                phase=None):
    """``n_profile`` > 0 adds a torch.profiler pass over that many
    B=8 steps after the timed ones. ``node`` "dcn_local1" trains the
    local1 checkpoint (phases train, train_bf16), "dcn" and "dcn_mix" the
    exact-trained one (EXACT_TRAINS)."""
    phase = phase or ("train" if dtype == "float32" else "train_bf16")
    low = dtype != "float32"
    cfg = _train_cfg(dtype, node)
    kernels, kinds = TRAIN_KERNELS[node, dtype], TRAIN_KINDS[node, dtype]
    params, batch_stats = load_jax_ckpt(CKPT if node == "dcn_local1"
                                        else CKPT_DCN)
    frames, boxes = synth_clip(TRAIN_B + 1, seed=1)
    batch = train_batch(cfg, frames, boxes, "cuda")
    trainer = Trainer(cfg, _fresh_model(cfg, params, batch_stats), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    flags_outside = read_flags()
    flags_inside, hook = _flags_inside(trainer.model)
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        step = trainer.train_step(batch, TRAIN_LR)
        losses.append({k: float(v) for k, v in step.items()})
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    counts, tcounts = _launches(), _tracker_launches()
    hook.remove()
    _check_flags("Trainer.train_step", dtype, flags_inside[0], flags_outside)
    if read_flags() != flags_outside:
        raise RuntimeError("Trainer.train_step did not restore the flags")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    tot = [l["tot"] for l in losses]
    if not all(np.isfinite(v) for l in losses for v in l.values()):
        raise RuntimeError(f"non-finite training loss at {dtype}: {losses}")
    if not tot[-1] < tot[0]:
        raise RuntimeError(f"loss did not fall over {TRAIN_STEPS} steps at "
                           f"{dtype}: {tot}")
    want = {k: kernels.get(k, 0) * TRAIN_STEPS for k in counts}
    if counts != want:
        raise RuntimeError(f"DCN launches over {TRAIN_STEPS} steps at "
                           f"{node} {dtype}: {counts}, expected {want}")
    if any(p.dtype != torch.float32 or (p.grad is not None and
                                        p.grad.dtype != torch.float32)
           for p in trainer.model.parameters()):
        raise RuntimeError("a parameter or its gradient is not float32")
    # one more B=8 step, every launch held against the plain version
    with _RecordLaunches(kinds) as rec:
        trainer.train_step(batch, TRAIN_LR)
    b8_worst = rec.check(kinds)
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
    if b1["kernel"]["launches"] != {k: kernels.get(k, 0) for k in counts}:
        raise RuntimeError(f"DCN launches of the B=1 kernel step at "
                           f"{node} {dtype}: {b1['kernel']['launches']}, "
                           f"expected {kernels}")
    if any(b1["plain"]["launches"].values()):
        raise RuntimeError(f"the plain-DCN step launched kernels: "
                           f"{b1['plain']['launches']}")
    ref = grads["plain"]
    l2 = _rel_l2(grads["kernel"], ref)
    row = {"dla_node": node, "compute_dtype": dtype,
           "input": [cfg.input_h, cfg.input_w],
           "flags_outside": flags_outside,
           "flags_inside_train_step": flags_inside[0],
           "batch": TRAIN_B, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "optim": cfg.optim,
           "loss_tot": tot, "loss_first": losses[0], "loss_last": losses[-1],
           "ms_per_step": times,
           "ms_per_step_median_3_12": statistics.median(times[TRAIN_TIMED]),
           "img_per_s": TRAIN_B * 1e3 / statistics.median(
               times[TRAIN_TIMED]),
           "peak_memory_mb": peak_mb, "dcn_launches": counts,
           "tracker_launches": tcounts,
           "dcn_launches_per_step": {k: v / TRAIN_STEPS
                                     for k, v in counts.items()},
           "b8_step13_launch_worst_rel_err": b8_worst,
           "b1_kernel_step": b1["kernel"], "b1_plain_step": b1["plain"],
           "b1_grad_tensors": len(ref), "b1_grad_rel_l2": l2}
    if low:
        # the yardstick: the plain bf16 step against the plain fp32 step
        b1["plain_fp32"], fp32 = _b1_step(_train_cfg("float32", node),
                                          params, batch_stats, one, True)
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


def _active_boxes(rows):
    """The active rows of a fetched frame as (track ids, x, y, w, h)."""
    rows = [r for r in rows if r["active"]]
    boxes = np.array([[*r["bbox"][:2], r["bbox"][2] - r["bbox"][0],
                       r["bbox"][3] - r["bbox"][1]] for r in rows],
                     np.float64).reshape(-1, 4)
    return [r["tracking_id"] for r in rows], boxes


def phase_mota():
    """The port's MOTA on synth_clip against JAX's (MOTA_REFERENCE), at
    each node of MOTA_NODES: a float32 FusedDetector over MOTA_FRAMES
    frames (graph replays), the active tracks scored against the clip's
    boxes by the port's mot_metrics; then the counted run (the same frames
    from a fresh state, all replays, under torch.profiler, bit for bit the
    scored run) gives the path's device launches."""
    from centertrack_tpu_torch.eval.mot_metrics import MOTAccumulator

    t0 = time.perf_counter()
    frames, boxes = synth_clip(MOTA_FRAMES, seed=0)
    gt = np.concatenate([boxes[..., :2], boxes[..., 2:] - boxes[..., :2]],
                        -1)
    out = {}
    for node, ckpt in MOTA_NODES:
        kernels = PATH_KERNELS[node, "float32"]
        cfg = set_heads(parse_task(Config(
            task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
            max_age=3, dla_node=node, compute_dtype="float32")), MOT_META)
        det = FusedDetector(cfg, *load_jax_ckpt(ckpt), MOT_META,
                            device="cuda")
        acc = MOTAccumulator()
        packed = []
        for f, frame in enumerate(frames):
            res = det.run(frame)
            ids, hyp = _active_boxes(FusedDetector.fetch(res, cfg.out_thresh))
            packed.append(res.cpu().numpy())
            acc.update(list(range(len(gt[f]))), gt[f], ids, hyp)
        m = acc.metrics()

        def replay_all():
            det.reset_tracking()
            return [det.run(f).cpu().numpy() for f in frames]
        launches = counted_replays(
            f"mota_{node}", replay_all, tuple(kernels) + TRACKER_KERNELS,
            {**{k: n * MOTA_FRAMES for k, n in kernels.items()},
             **dict.fromkeys(TRACKER_KERNELS, MOTA_FRAMES)}, packed)
        ref = MOTA_REFERENCE[node]
        row = {"node": node, "frames": MOTA_FRAMES,
               "mota": m["mota"], "idf1": m["idf1"],
               **{k: m[k] for k in MOT_COUNTS},
               "jax": ref, "mota_minus_jax": m["mota"] - ref["mota"],
               "idf1_minus_jax": m["idf1"] - ref["idf1"],
               "tol": MOTA_TOL, "launches": launches}
        emit(f"mota_{node}", **row)
        if (abs(m["mota"] - ref["mota"]) > MOTA_TOL or
                abs(m["idf1"] - ref["idf1"]) > MOTA_TOL):
            raise RuntimeError(f"mota at {node}: MOTA {m['mota']:.4f} IDF1 "
                               f"{m['idf1']:.4f}, JAX's {ref['mota']:.4f} / "
                               f"{ref['idf1']:.4f}: past {MOTA_TOL}")
        out[node] = row
        del det
        torch.cuda.empty_cache()
    emit("mota", seconds=time.perf_counter() - t0)
    return out


def phase_selftest(n_profile=0):
    """tools/selftest end to end on the card (SELFTEST_* above): the
    dataset written as JAX's JPEG files, training with a save and resume through
    CheckpointManager, then evaluate over the training videos. Every
    launch count is set to 0 just before training and read just after:
    each exact kernel of dla_node dcn at float32 launches 16 times a
    step and nothing else launches. Evaluation runs twice on one
    FusedDetector: the scored run, then the counted run (all replays,
    under torch.profiler), whose rows must equal the scored run's bit
    for bit and whose metrics must equal its metrics. Last, the training
    step timed alone (``selftest_step_profile``; profiled with
    ``n_profile``)."""
    import shutil

    from centertrack_tpu_torch.models.model import params_to_jax
    from centertrack_tpu_torch.tools import selftest

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "selftest")
    shutil.rmtree(root, ignore_errors=True)
    ann, img_dir = selftest.make_dataset(root, hard=True, seed=0)
    t_data = time.perf_counter() - t0
    cfg = selftest.build_cfg(ann, img_dir, dla_node=SELFTEST_NODE,
                             compute_dtype="float32", batch_size=TRAIN_B,
                             lr=5e-4, epochs=SELFTEST_EPOCHS,
                             num_workers=SELFTEST_WORKERS)
    per_step = TRAIN_KERNELS[SELFTEST_NODE, "float32"]
    _reset_launches()
    log = []
    model, info = selftest.train(
        cfg, log=log.append, device="cuda", resume_at=SELFTEST_RESUME_AT,
        ckpt_dir=os.path.join(root, "ckpt"))
    train_launches = {k: v for k, v in {**_launches(),
                                        **_tracker_launches()}.items() if v}
    want = {k: n * info["steps"] for k, n in per_step.items()}
    if train_launches != want:
        raise RuntimeError(f"selftest training launched {train_launches}, "
                           f"expected {want} over {info['steps']} steps")
    if not np.isfinite(info["last_epoch"]["tot"]):
        raise RuntimeError(f"selftest: loss {info['last_epoch']}")
    t1 = time.perf_counter()
    det = FusedDetector(cfg, *params_to_jax(model),
                        selftest.selftest_meta(cfg), device="cuda")
    scored_rows = []
    overall = selftest.evaluate(cfg, None, None, ann, img_dir,
                                log=log.append, detector=det,
                                rows=scored_rows)
    t_eval = time.perf_counter() - t1
    with open(ann) as f:
        n_frames = len(json.load(f)["images"])
    again = {}
    eval_kernels = PATH_KERNELS[SELFTEST_NODE, "float32"]

    def replay_all():
        rows = []
        again.update(selftest.evaluate(cfg, None, None, ann, img_dir,
                                       log=lambda line: None, detector=det,
                                       rows=rows))
        return rows
    # at 96x160 the pre_hm renders densely, without splat_pre_hm
    from centertrack_tpu_torch.ops.gaussian import DENSE_MAX_PIXELS
    splat = cfg.input_h * cfg.input_w > DENSE_MAX_PIXELS
    eval_launches = counted_replays(
        "selftest_eval", replay_all, tuple(eval_kernels) + TRACKER_KERNELS,
        {**{k: n * n_frames for k, n in eval_kernels.items()},
         "greedy_assign": n_frames, "splat_pre_hm": n_frames * splat},
        scored_rows)
    if {k: again[k] for k in MOT_COUNTS} != {k: overall[k]
                                             for k in MOT_COUNTS}:
        raise RuntimeError("selftest: the counted evaluation scored "
                           f"{again}, the first {overall}")
    del det
    step = selftest_step_profile(cfg, model, n_profile)
    row = {"node": SELFTEST_NODE, "compute_dtype": "float32",
           "epochs": SELFTEST_EPOCHS, "resumed_at": info["resumed_at"],
           "steps": info["steps"], "batch": TRAIN_B, "frames": n_frames,
           "mota": overall["mota"], "idf1": overall["idf1"],
           **{k: overall[k] for k in MOT_COUNTS},
           "mota_floor": SELFTEST_MOTA_FLOOR,
           "jax_dcn_mota_seeds": [0.8957, 0.9058, 0.9167],
           "dataset_s": t_data, "train_s": info["seconds"],
           "eval_s": t_eval, "seconds": time.perf_counter() - t0,
           "loader_ms_per_batch": info["loader_ms_per_batch"],
           "loader_workers": SELFTEST_WORKERS,
           "wait_ms_per_step": info["wait_ms_per_step"],
           "step_ms": info["step_ms"],
           "alone_ms_per_step": step["alone_ms_per_step"],
           "device_busy_ms_per_step": step["device_busy_ms_per_step"],
           "device_idle_share": step["device_idle_share"],
           "last_epoch": info["last_epoch"],
           "launches_per_step": {k: v // info["steps"]
                                 for k, v in train_launches.items()},
           "train_launches": train_launches,
           "eval_launches": eval_launches, "log": log}
    emit("selftest", **row)
    if not overall["mota"] >= SELFTEST_MOTA_FLOOR:
        raise RuntimeError(f"selftest: MOTA {overall['mota']:.4f} below "
                           f"{SELFTEST_MOTA_FLOOR}")
    return row


def phase_codec():
    """The host codec (csrc/image_codec.c, built with cc at first use) on
    the card's machine: each of CODEC_CASES encoded and the file decoded,
    the SHA-256 of both against CODEC_GOLDEN (cv2's bytes and pixels); a
    1920x1080 PNG whose rows alternate Average and Paeth (png_filtered)
    decoding to its source; ms a 1080p JPEG decode and encode and a 1080p
    PNG decode (the median of CODEC_TIMED calls, on the host)."""
    from centertrack_tpu_torch.utils import image_io, jpeg

    t0 = time.perf_counter()
    jpeg.decode(jpeg.encode(np.zeros((8, 8), np.uint8)))    # builds it
    build = _build.build_info["image_codec"]
    inputs = codec_inputs()
    cases, wrong = {}, []
    for name, quality in CODEC_CASES:
        key = f"{name}@{quality}"
        data = jpeg.encode(inputs[name], quality)
        pixels = jpeg.decode(data, key)
        got = (sha256(data), sha256(np.ascontiguousarray(pixels)))
        cases[key] = {"bytes": len(data), "shape": list(pixels.shape),
                      "jpeg_sha256": got[0], "pixels_sha256": got[1]}
        if got != CODEC_GOLDEN[key]:
            wrong.append(key)
    png = png_filtered(inputs["synth_0"], (3, 4))
    png_equal = bool(np.array_equal(image_io.decode_png(png),
                                    inputs["synth_0"]))
    frame = inputs["synth_0"]
    data = jpeg.encode(frame)

    def median_ms(fn):
        times = []
        for _ in range(CODEC_TIMED):
            t = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)
    row = {"cc_seconds": build["seconds"], "cases": cases,
           "cases_against_golden": {k: k not in wrong for k in cases},
           "png_avg_paeth_1080p_equal": png_equal,
           "jpeg_decode_ms_1080p": median_ms(lambda: jpeg.decode(data)),
           "jpeg_encode_ms_1080p": median_ms(lambda: jpeg.encode(frame)),
           "png_decode_ms_1080p_avg_paeth":
               median_ms(lambda: image_io.decode_png(png)),
           "png_bytes": len(png), "jpeg_bytes_1080p_q95": len(data),
           "timed_calls": CODEC_TIMED, "clock": "host wall",
           "seconds": time.perf_counter() - t0}
    emit("codec", **row)
    if wrong or not png_equal:
        raise RuntimeError(f"codec: {wrong} differ from cv2's goldens; "
                           f"PNG Average/Paeth decoded equal: {png_equal}")
    return row


def carry_wh_to_ltrb_amodal(model):
    """The recipe finetunes a checkpoint that has an ltrb_amodal head
    (CrowdHuman's, mot17_half.sh:1-3); the committed one has none, and a
    fresh head's sides move about 0.2 output pixels in 12 steps, so every
    box would be a point. The head starts instead as the checkpoint's wh
    head read as sides: its first conv, and (-wh/2, -wh/2, wh/2, wh/2)
    around the peak + 0.5 (tests/test_torch_port_ltrb.py builds the
    same)."""
    from centertrack_tpu_torch.models.model import (params_from_jax,
                                                    params_to_jax)
    params, batch_stats = params_to_jax(model)
    wh = params["heads"]["wh"]
    kernel = np.asarray(wh["out"]["kernel"], np.float32)
    bias = np.asarray(wh["out"]["bias"], np.float32)
    params["heads"]["ltrb_amodal"] = {
        "conv_0": {k: np.array(v) for k, v in wh["conv_0"].items()},
        "out": {"kernel": np.concatenate([-0.5 * kernel, 0.5 * kernel], 3),
                "bias": np.concatenate([-0.5 * bias, 0.5 * bias]) + 0.5}}
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in params_from_jax(
        params, batch_stats).items()}, strict=True)


def phase_mot17_recipe():
    """MOT17's own recipe on the card (RECIPE_* above): the MOT-geometry
    clip written as JPEG, RECIPE_STEPS bf16 dcn_local steps with
    ltrb_amodal from the committed checkpoint (the head carried over from
    its wh head, carry_wh_to_ltrb_amodal) through DataLoader and
    Trainer (every launch count set to 0 just before and read just after:
    each bf16 clamped kernel launches 16 times a step, splat_pre_hm once a
    sample, nothing else; the loss must fall: the mean of the last 3 steps below the
    first 3's), then the trained weights served by FusedDetector (graph
    replays) over both videos at the test flags, its boxes the amodal
    head's; the first PLAIN_FRAMES frames against the plain-DCN path by
    phase_path's bf16 rule (each frame from the kernel path's state
    before it), then the counted run (CLEAR-MOT of the active tracks, all
    replays, bit for bit the first run's rows)."""
    import shutil

    from centertrack_tpu_torch.data.datasets import CustomDataset
    from centertrack_tpu_torch.data.loader import DataLoader
    from centertrack_tpu_torch.models.model import params_to_jax
    from centertrack_tpu_torch.tools import selftest
    from centertrack_tpu_torch.utils import image_io

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "mot17_recipe")
    shutil.rmtree(root, ignore_errors=True)
    ann, img_dir = selftest.make_dataset(
        root, num_videos=RECIPE_VIDEOS, frames=RECIPE_FRAMES,
        width=RECIPE_FRAME_HW[1], height=RECIPE_FRAME_HW[0], scale=2,
        hard=True, seed=0)
    t_data = time.perf_counter() - t0
    meta = type("Meta", (), {"num_categories": 1,
                             "default_resolution": RECIPE_INPUT_HW,
                             "num_joints": 17})

    def recipe_cfg(**kw):
        return set_heads(parse_task(Config(
            task="tracking", dataset="custom", num_classes=1,
            custom_dataset_ann_path=ann, custom_dataset_img_path=img_dir,
            batch_size=TRAIN_B, load_model=CKPT,
            num_workers=RECIPE_WORKERS, **RECIPE_TRAIN, **kw)), meta)
    cfg = recipe_cfg()
    trainer = Trainer(cfg, create_model(cfg, "cuda"), "cuda")
    trainer.start()
    carry_wh_to_ltrb_amodal(trainer.model)
    loader = DataLoader(CustomDataset(cfg, "train"), cfg.batch_size,
                        shuffle=True, num_workers=cfg.num_workers,
                        seed=cfg.seed)
    _reset_launches()
    step_ms, wait_ms, losses = [], [], []
    t_train = time.perf_counter()
    while len(step_ms) < RECIPE_STEPS:
        t_wait = time.perf_counter()
        for batch in loader:
            t = time.perf_counter()
            wait_ms.append(1e3 * (t - t_wait))
            out = trainer.train_step(batch, cfg.lr)
            losses.append({k: float(v) for k, v in out.items()})
            step_ms.append(1e3 * (time.perf_counter() - t))
            if len(step_ms) == RECIPE_STEPS:
                break
            t_wait = time.perf_counter()
    t_train = time.perf_counter() - t_train
    train_launches = {k: v for k, v in {**_launches(),
                                        **_tracker_launches()}.items() if v}
    # the pre_hm of each sample is splatted on the device (544x960 is past
    # ops/gaussian.DENSE_MAX_PIXELS)
    want = {**{k: 16 * RECIPE_STEPS for k in _LOCAL["bfloat16"]},
            "splat_pre_hm": TRAIN_B * RECIPE_STEPS}
    if train_launches != want:
        raise RuntimeError(f"mot17_recipe training launched "
                           f"{train_launches}, expected {want}")
    tot = [x["tot"] for x in losses]
    falls = bool(np.isfinite(tot).all() and
                 np.mean(tot[-3:]) < np.mean(tot[:3]))

    # serving: the test flags, the trained weights
    scfg = recipe_cfg(**RECIPE_TEST)
    params, batch_stats = params_to_jax(trainer.model)
    del trainer
    torch.cuda.empty_cache()
    smeta = selftest.selftest_meta(scfg)
    with open(ann) as f:
        images = sorted(json.load(f)["images"],
                        key=lambda im: (im["video_id"], im["frame_id"]))
    t = time.perf_counter()
    frames = [image_io.read(os.path.join(img_dir, im["file_name"]))
              for im in images]
    read_ms = 1e3 * (time.perf_counter() - t) / len(frames)
    det = FusedDetector(scfg, params, batch_stats, smeta, device="cuda")
    _reset_launches()
    times, packed, states = [], [], []
    for i, (im, frame) in enumerate(zip(images, frames)):
        if im["frame_id"] == 1:
            det.reset_tracking()
        if i < PLAIN_FRAMES:
            states.append((det.track_state, det.pre_images))
        t = time.perf_counter()
        res = det.run(frame)
        FusedDetector.fetch(res, scfg.out_thresh)
        times.append(1e3 * (time.perf_counter() - t))
        packed.append(res.cpu().numpy())
        if not torch.isfinite(res).all():
            raise RuntimeError("mot17_recipe: a non-finite packed row")
    wrapper_calls = {k: v for k, v in {**_launches(),
                                       **_tracker_launches()}.items() if v}
    plain = FusedDetector(scfg, params, batch_stats, smeta, device="cuda",
                          plain_dcn=True)
    plain_packed = []
    for i in range(PLAIN_FRAMES):
        plain.track_state, plain.pre_images = states[i]
        plain_packed.append(plain.run(frames[i]).cpu().numpy())
    del plain
    tol = PLAIN_SCORE_TOL["bfloat16"]
    vs_plain = rows_against(packed[:PLAIN_FRAMES], plain_packed,
                            scfg.out_thresh, tol, collapse_ties=True)
    if vs_plain["rows_unpaired"] or not vs_plain["pairs"] or (
            vs_plain["pairs_same_track_id"]
            + vs_plain["pairs_swapped_on_exact_tie"] != vs_plain["pairs"]
            ) or vs_plain["max_score_diff"] > tol:
        raise RuntimeError(f"mot17_recipe: the kernel and plain-DCN paths "
                           f"differ: {vs_plain}")
    scored = {}

    def replay_all():
        rows = []
        scored.update(selftest.evaluate(scfg, None, None, ann, img_dir,
                                        log=lambda line: None, detector=det,
                                        rows=rows))
        return rows
    n = len(frames)
    serve_launches = counted_replays(
        "mot17_recipe_serve", replay_all,
        ("dcn_local_fwd_bf16",) + TRACKER_KERNELS,
        {"dcn_local_fwd_bf16": 16 * n, **dict.fromkeys(TRACKER_KERNELS, n)},
        packed)
    row = {"videos": RECIPE_VIDEOS, "frames": n,
           "frame": list(RECIPE_FRAME_HW), "input": list(RECIPE_INPUT_HW),
           "flags": {**RECIPE_TRAIN, **RECIPE_TEST},
           "heads": scfg.heads_dict, "batch": TRAIN_B, "steps": len(step_ms),
           "lr": cfg.lr, "load_model": os.path.relpath(CKPT, ROOT),
           "step_ms": step_ms,
           "step_ms_median_3_12": statistics.median(step_ms[TRAIN_TIMED]),
           "wait_ms_per_step": wait_ms,
           "loader_ms_per_batch": 1e3 * float(np.mean(loader.batch_seconds)),
           "loader_workers": RECIPE_WORKERS, "train_s": t_train,
           "loss_tot": tot, "loss_last": losses[-1], "loss_falls": falls,
           "train_launches": train_launches,
           "dataset_s": t_data, "jpeg_read_ms_per_frame": read_ms,
           "serve_ms_per_frame_median": statistics.median(
               times[PATH_WARMUP:]),
           "serve_ms_first_call_with_capture": times[0],
           "serve_wrapper_calls": wrapper_calls,
           "serve_launches": serve_launches,
           "plain_vs_kernel": vs_plain,
           "mota": scored.get("mota"), "idf1": scored.get("idf1"),
           **{k: scored.get(k) for k in MOT_COUNTS},
           "seconds": time.perf_counter() - t0}
    emit("mot17_recipe", **row)
    del det
    torch.cuda.empty_cache()
    if not falls:
        raise RuntimeError(f"mot17_recipe: the loss did not fall: {tot}")
    return row


def selftest_step_profile(cfg, model, n_profile=0):
    """Where the selftest's training step goes: SELFTEST_ALONE_STEPS
    steps of the trained model (a fresh Adam) on one loader batch, with
    no loader running, timed alone (wall ms a step, each step ending on
    the host as in ``Trainer.run_epoch``); with ``n_profile``, n_profile
    more under torch.profiler (``_profile``: device busy ms a step and
    idle share). The training run's own step (``step_ms``, loader
    threads beside it) against these says how much of it is the device,
    the step's own host work and the loader's company."""
    from centertrack_tpu_torch.data.datasets import CustomDataset
    from centertrack_tpu_torch.data.loader import DataLoader

    loader = DataLoader(CustomDataset(cfg, "train"), cfg.batch_size,
                        shuffle=True, num_workers=cfg.num_workers,
                        seed=cfg.seed)
    batch = next(iter(loader))
    trainer = Trainer(cfg, model, "cuda")

    def one():
        float(trainer.train_step(batch, cfg.lr)["tot"])
    for _ in range(3):
        one()
    t = time.perf_counter()
    for _ in range(SELFTEST_ALONE_STEPS):
        one()
    row = {"alone_ms_per_step":
           1e3 * (time.perf_counter() - t) / SELFTEST_ALONE_STEPS,
           "device_busy_ms_per_step": None, "device_idle_share": None}
    if n_profile:
        row.update(_profile(one, n_profile, "selftest_profile", "step"))
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
    phase_codec()
    phase_precision()
    # the kernel phases hold the kernels against their plain versions, so
    # they run in full float32 (cuBLAS without TF32 for the plain
    # versions' products); the paths after them run with the process's
    # own flags, and the package sets its precision itself
    with full_float32("float32"):
        probe_rows, probe_launches, probe_dcn_launches = phase_probes()
        tracker_rows = phase_tracker()
        rows = phase_kernel()
        bf16_rows = phase_kernel_bf16()
        grad_rows = phase_grad()
        grad_bf16_rows = phase_grad_bf16()
        gather_rows = {dt: phase_gather(dt)
                       for dt in ("float32", "bfloat16")}
        route_rows = phase_gather_routes()
        trained = trained_exact_inputs()
        exact_rows, exact_mix = phase_exact(trained)
        exact_grad_rows = {dt: phase_exact_grad(trained, dt)
                           for dt in ("float32", "bfloat16")}
        del trained
    path, det, frames, cfg, packed = phase_path()
    if n_profile:
        phase_profile(det, frames, cfg, n_profile)
    chunk = phase_chunk(det, frames, cfg, packed, n_profile)
    del det
    torch.cuda.empty_cache()
    path_bf16, det, frames, cfg, packed_bf16 = phase_path("bfloat16", packed)
    if n_profile:
        phase_profile(det, frames, cfg, n_profile, "profile_bf16")
    chunk_bf16 = phase_chunk(det, frames, cfg, packed_bf16, n_profile)
    del det
    torch.cuda.empty_cache()
    multistream = phase_multistream(packed)
    phase_lifetimes()
    exact_paths, exact_packed = {}, None
    for phase, node, dtype in EXACT_PATHS:
        exact_paths[phase], rows_ = phase_path_exact(
            phase, node, dtype, exact_packed if node == "dcn" else None,
            n_profile)
        if (node, dtype) == ("dcn", "float32"):
            exact_packed = rows_
        torch.cuda.empty_cache()
    train = phase_train(n_profile)
    train_bf16 = phase_train(n_profile, "bfloat16")
    train_exact = {phase: phase_train(n_profile, dtype, node, phase)
                   for phase, node, dtype in EXACT_TRAINS}
    torch.cuda.empty_cache()
    mota = phase_mota()
    recipe = phase_mot17_recipe()
    selftest = phase_selftest(n_profile)

    neck = [r for r in rows if r["launches_per_frame"] and r["batch"] == 1]
    neck8 = [r for r in rows
             if r["launches_per_frame"] and r["batch"] == TRAIN_B]
    per_frame = lambda key, rs=neck: sum(r[key] * r["launches_per_frame"]
                                         for r in rs)
    bf16_neck = [r for r in bf16_rows
                 if r["launches_per_frame"] and r["batch"] == 1]
    bf16_neck8 = [r for r in bf16_rows
                  if r["launches_per_frame"] and r["batch"] == TRAIN_B]
    gneck = [r for r in grad_rows
             if r["launches_per_step_and_image"] and r["batch"] == 1]
    gneck8 = [r for r in grad_rows
              if r["launches_per_step_and_image"] and r["batch"] == TRAIN_B]
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
    # the serving paths' launches are device launches over each path's
    # counted run of replays (a replay calls no wrapper); training runs
    # eagerly, so there a wrapper call is a launch
    serving = {"serving": path, "serving_bf16": path_bf16, "chunk": chunk,
               "chunk_bf16": chunk_bf16,
               "multistream": {"launches": multistream["launches_s2"]},
               "multistream_bf16": {"launches": multistream["launches_s6"]},
               **{"serving_" + k[len("path_"):]: r
                  for k, r in exact_paths.items()}}
    by_path = lambda name: {
        **{k: r["launches"].get(name, 0) for k, r in serving.items()},
        "train": (launches if name in launches else train[
            "tracker_launches"])[name],
        "train_bf16": (launches_bf16 if name in launches_bf16 else
                       train_bf16["tracker_launches"])[name],
        **{phase: (r["dcn_launches"] if name in r["dcn_launches"] else
                   r["tracker_launches"])[name]
           for phase, r in train_exact.items()},
        "probes": probe_dcn_launches.get(name, 0),
        **{"mota_" + node: r["launches"].get(name, 0)
           for node, r in mota.items()},
        "selftest_train": selftest["train_launches"].get(name, 0),
        "selftest_eval": selftest["eval_launches"].get(name, 0),
        "mot17_recipe_train": recipe["train_launches"].get(name, 0),
        "mot17_recipe_serve": recipe["serve_launches"].get(name, 0)}
    fp32_design = "3xTF32 wgmma, cp.async haloed window, K splits by waves"
    weight_design = ("wgmma over pixels (3xTF32 at float32), A_t from a "
                     "cp.async haloed window, pixel splits by waves")
    kernels = [{
        "name": "dcn_local_fwd", "route": "cuda",
        "source": "centertrack_tpu_torch/csrc/dcn_local.cu",
        "replaces": "centertrack_tpu/ops/dcn_pallas.py:115",
        "also_replaces": ["centertrack_tpu/ops/dcn_pallas_grid.py:126",
                          "centertrack_tpu/ops/dcn_pallas_shift.py:110",
                          "centertrack_tpu/ops/dcn_pallas_halo.py:135"],
        "design": fp32_design,
        "launches": launches["dcn_local_fwd"],
        "launches_by_path": by_path("dcn_local_fwd"),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "per": "one 544x960 frame: the 16 launches of the neck shapes",
        "ms": per_frame("ms"), "device_ms": per_frame("device_ms"),
        "ms_per_image_at_b8": per_frame("ms", neck8) / TRAIN_B,
        "plain_ms": per_frame("plain_ms"),
        "bound_ms": per_frame("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in neck) else "bytes"),
        "bound_ms_fp32_cuda_cores": per_frame("bound_ms_fp32_cuda_cores"),
        "library_ms": None,
    }, {
        "name": "dcn_local_fwd_bf16", "route": "cuda",
        "source": "centertrack_tpu_torch/csrc/dcn_local_bf16.cu",
        "replaces": "centertrack_tpu/ops/dcn_pallas.py:115",
        "also_replaces": ["centertrack_tpu/ops/dcn_pallas_grid.py:126",
                          "centertrack_tpu/ops/dcn_pallas_shift.py:110",
                          "centertrack_tpu/ops/dcn_pallas_halo.py:135"],
        "at": "bfloat16 inputs",
        "launches": path_bf16["launches"]["dcn_local_fwd_bf16"],
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
    for kname, key, rows_, neck_, neck8_, src, at, n in (
            ("dcn_local_bwd_data", "data", grad_rows, gneck, gneck8,
             "dcn_local_bwd.cu", None, launches),
            ("dcn_local_bwd_weight", "weight", grad_rows, gneck, gneck8,
             "dcn_local_bwd.cu", None, launches),
            ("dcn_local_bwd_data_bf16", "data", grad_bf16_rows, gneck_bf16,
             gneck_bf16_8, "dcn_local_bwd_bf16.cu", "bfloat16 inputs",
             launches_bf16),
            ("dcn_local_bwd_weight_bf16", "weight", grad_bf16_rows,
             gneck_bf16, gneck_bf16_8, "dcn_local_bwd_bf16.cu",
             "bfloat16 inputs", launches_bf16)):
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
            "ms_per_image_at_b8": per_image(key + "_ms", neck8_) / TRAIN_B,
        }
        if at:
            row["at"] = at
        row["device_ms"] = per_image(key + "_device_ms", neck_)
        row["device_ms_per_image_at_b8"] = per_image(
            key + "_device_ms", neck8_) / TRAIN_B
        if kname in ("dcn_local_bwd_data", "dcn_local_bwd_weight"):
            row["bound_ms_fp32_cuda_cores"] = per_image(
                key + "_bound_ms_fp32_cuda_cores", neck_)
        if kname == "dcn_local_bwd_data":
            row["design"] = fp32_design
        elif "weight" in kname:
            row["design"] = weight_design
        kernels.append(row)
    for dt, r in gather_rows.items():
        kernels.append({
            "name": r["kernel"], "route": "cuda",
            "source": "centertrack_tpu_torch/csrc/dcn_local_bwd"
                      + ("_bf16" if dt == "bfloat16" else "") + ".cu",
            "replaces": bwd_replaces, "also_replaces": bwd_also,
            "at": f"{dt} inputs, max offsets whose window does not fit",
            "launches": 0, "launches_in_check": r["launches_in_check"],
            "launches_by_path": {"train": 0, "train_bf16": 0},
            "max_abs_err": r["max_abs_err"],
            "per": f"one call at B={r['batch']}, {r['hw'][0]}x{r['hw'][1]}, "
                   f"{r['cin']}->{r['cout']}, R={r['R']}",
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    for (kind, dt), (kname, _, _) in GATHER_ROUTES.items():
        r, = [r for r in route_rows if r["kernel"] == kname
              and (r["R"], r["cin"], r["cout"]) == GATHER_ROUTE_ROW]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "centertrack_tpu_torch/csrc/dcn_local"
                      + ("_bwd" if kind == "data" else "")
                      + ("_bf16" if dt == "bfloat16" else "") + ".cu",
            "replaces": ("centertrack_tpu/ops/dcn_pallas.py:115"
                         if kind == "fwd" else bwd_replaces),
            "also_replaces": (
                ["centertrack_tpu/ops/dcn_pallas_grid.py:126",
                 "centertrack_tpu/ops/dcn_pallas_shift.py:110",
                 "centertrack_tpu/ops/dcn_pallas_halo.py:135"]
                if kind == "fwd" else bwd_also),
            "at": f"{dt} inputs, past the window design's limits",
            "design": "the first design: corners gathered from global "
                      "memory, any max offset and width",
            "launches": sum(by_path(kname).values()),
            "launches_by_path": by_path(kname),
            "launches_in_check": sum(x["launches_in_check"]
                                     for x in route_rows
                                     if x["kernel"] == kname),
            "max_abs_err": max(x["max_abs_err"] for x in route_rows
                               if x["kernel"] == kname),
            "per": f"one call at B={r['batch']}, {r['hw'][0]}x{r['hw'][1]}, "
                   f"{r['cin']}->{r['cout']}, R={r['R']}",
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    for low in (False, True):
        kname = "dcn_exact_fwd" + ("_bf16" if low else "")
        rs = [r for r in exact_rows if r["kernel"] == kname]
        neck_rows = [r for r in rs if r["launches_per_frame"]["dcn"]]
        one = [r for r in neck_rows if r["batch"] == 1]
        frame = lambda key, node="dcn", rows_=one: sum(
            r[key] * r["launches_per_frame"][node] for r in rows_)
        six = [r for r in neck_rows if r["batch"] == EXACT_BATCH]
        tiles = lambda kind: sum(
            e[kind + "_tiles"] for r in one
            for k, e in r["by_offsets"].items() if k.startswith("trained"))
        exact_row = {
            "name": kname, "route": "cuda",
            "source": "centertrack_tpu_torch/csrc/dcn_exact.cu",
            "replaces": "centertrack_tpu/ops/dcn.py:315",
            "replaces_kind": "deform_conv2d, an XLA gather (no "
                             "pl.pallas_call): _deform_conv2d_slot at "
                             "h*w >= 4096, _deform_conv2d_onehot below",
            "at": "bfloat16 inputs" if low else "float32 inputs",
            "design": "a 4x16 tile by up to 256 output channels a block, "
                      "the tile's own bounding box of live corners copied "
                      "by cp.async where it fits the plan's capacity, the "
                      "corners gathered from global memory where not, "
                      + ("bf16 wgmma" if low else "3xTF32 wgmma")
                      + ", K splits by waves",
            "launches": exact_paths[
                "path_dcn_bf16" if low else "path_dcn"]["launches"][kname],
            "launches_by_path": by_path(kname),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "per": "one 544x960 frame at dla_node dcn: the 16 launches of "
                   "the neck shapes at B=1, each on its node's own inputs "
                   "from one forward of the first synthetic frame",
            "ms": frame("ms_trained"), "device_ms": frame(
                "device_ms_trained"),
            "ms_n3_offsets": frame("ms"),
            "device_ms_n3_offsets": frame("device_ms"),
            "window_share_trained": tiles("window") / max(
                1, tiles("window") + tiles("gather")),
            "ms_per_image_at_b6": frame("ms_trained", rows_=six)
            / EXACT_BATCH,
            "plain_ms": frame("plain_ms"),
            "bound_ms": frame("bound_ms"),
            "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                             for r in one) else "bytes"),
            "plans": {f"{r['map']} {r['cin']}->{r['cout']}": r["plan"]
                      for r in one},
            "library_ms": None}
        if low:
            exact_row.update({
                "ms_per_frame_dcn_mix": exact_mix["ms_per_frame"],
                "device_ms_per_frame_dcn_mix":
                    exact_mix["device_ms_per_frame"],
                "window_share_dcn_mix": exact_mix["window_share"]})
        else:
            exact_row["bound_ms_fp32_cuda_cores"] = frame(
                "bound_ms_fp32_cuda_cores")
        kernels.append(exact_row)
    for low in (False, True):
        dt = "bfloat16" if low else "float32"
        rs = exact_grad_rows[dt]
        one = [r for r in rs if r["launches_per_step_and_image"]["dcn"]
               and r["batch"] == 1]
        six = [r for r in rs if r["launches_per_step_and_image"]["dcn"]
               and r["batch"] == EXACT_BATCH]
        image = lambda key, rows_=one: sum(
            r[key] * r["launches_per_step_and_image"]["dcn"] for r in rows_)
        for kind in ("data", "weight"):
            kname = f"dcn_exact_bwd_{kind}" + ("_bf16" if low else "")
            tiles = lambda route: sum(
                e[kind + "_routes"][route] for r in one
                for k, e in r["by_offsets"].items() if k.startswith("trained"))
            kernels.append({
                "name": kname, "route": "cuda",
                "source": "centertrack_tpu_torch/csrc/dcn_exact_bwd.cu",
                "replaces": "centertrack_tpu/ops/dcn.py:315",
                "replaces_kind": "the backward of deform_conv2d, jax.vjp of "
                                 "its XLA gather (no pl.pallas_call): "
                                 "_deform_conv2d_slot at h*w >= 4096, "
                                 "_deform_conv2d_onehot below",
                "at": dt + " inputs",
                "design": (
                    "a 4x16 tile a block, each (pixel, tap)'s corners "
                    "once a tile into a table from which every step's "
                    "walk rebuilds its weights; per warpgroup G = g w^T on "
                    + ("bf16 wgmma" if low else "3xTF32 wgmma")
                    + " issued a step ahead under the walk from two weight "
                      "slots (one bulk copy a step on mbarriers), its "
                      "share of the tile's box of every needed corner "
                      "copied by cp.async (the next chunk's into a second "
                      "window slot during the walk where two fit), one "
                      "warpgroup barrier a step; m hat_k G added into grad "
                      "x per corner by red.global.add.v4.f32, the corners "
                      "gathered from global memory where the box does not "
                      "fit, K splits by waves"
                    if kind == "data" else
                    "output channels as the wgmma M: g^T from registers "
                    "(wgmma's register A, " + (
                        "bf16" if low else "3xTF32: split into hi and lo "
                        "as it is loaded")
                    + ", once a tile for every tap), each tap's sample as "
                      "B; one producer warpgroup stages each tile "
                      "(corners, the box of live corners and the output "
                      "grad by cp.async a tile ahead on mbarriers, two "
                      "window slots), the others build each tap's sample "
                      "into a ring of stages, consumer warpgroups only "
                      "issue wgmma (setmaxnreg; 1 stager, 2 samplers and "
                      "1 consumer with 5 taps a block at Cout 64, 1, 1 "
                      "and 2 above); samples from global memory where the "
                      "box does not fit; pixel splits by waves, a block's "
                      "flush counted"),
                "launches": train_exact[
                    "train_dcn_bf16" if low else "train_dcn"][
                    "dcn_launches"][kname],
                "launches_by_path": by_path(kname),
                "max_abs_err": max(r[kind + "_max_abs_err"] for r in rs),
                "per": "one 544x960 image of a training step at dla_node "
                       "dcn: the 16 launches of the neck shapes at B=1, each "
                       "on its node's own inputs from one forward of the "
                       "first synthetic frame, with a seeded output grad",
                "ms": image(kind + "_ms_trained"),
                "device_ms": image(kind + "_device_ms_trained"),
                "ms_n3_offsets": image(kind + "_ms"),
                "device_ms_n3_offsets": image(kind + "_device_ms"),
                "device_ms_per_image_at_b6": image(
                    kind + "_device_ms_trained", six) / EXACT_BATCH,
                "window_share_trained": tiles(0) / max(
                    1, tiles(0) + tiles(1)),
                "plain_ms": image(kind + "_plain_ms_trained"),
                "bound_ms": image(kind + "_bound_ms_trained"),
                "bound_ms_n3_offsets": image(kind + "_bound_ms"),
                "bound_by": ("operations" if all(
                    r[kind + "_bound_by"] == "operations" for r in one)
                    else "bytes"),
                "plans": {f"{r['map']} {r['cin']}->{r['cout']}":
                          r[kind + "_plan"] for r in one},
                **({"reductions_per_image": image("data_reductions_trained")}
                   if kind == "data" else {}),
                "library_ms": None})
    replaces = {"greedy_assign": "centertrack_tpu/engine/device_tracker.py:70",
                "splat_pre_hm": "centertrack_tpu/ops/gaussian.py:214"}
    designs = {"greedy_assign": "one block per stream: a parallel pass of "
                                "each row's first 4 candidates, then one "
                                "warp walks the live rows against its "
                                "taken bits",
               "splat_pre_hm": "a block per 16x128 tile of one stream: "
                               "the slots meeting it in shared memory, "
                               "each pixel written once, no memset"}
    greedy_path = [r for r in tracker_rows if r["kernel"] == "greedy_assign"
                   and r["case"] == "path"]
    for name in TRACKER_KERNELS:
        r = path["tracker_kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "centertrack_tpu_torch/csrc/tracker.cu",
            "replaces": replaces[name],
            "replaces_kind": "an XLA loop inside the jitted step (no "
                             "pl.pallas_call)",
            "design": designs[name],
            "launches": path["launches"][name],
            "launches_by_path": by_path(name),
            "launches_counted": path["launches_counted"],
            "wrapper_calls": {"serving": path["wrapper_calls"][name],
                              "serving_bf16":
                                  path_bf16["wrapper_calls"][name]},
            "max_abs_err": max(
                path["tracker_max_abs_err"][name],
                path_bf16["tracker_max_abs_err"][name],
                multistream["tracker_max_abs_err_s2"][name],
                multistream["tracker_max_abs_err_s6"][name]),
            "per": f"one call at the 544x960 path's shape {r['shape']}",
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            **({"chain_bound_ms": r["chain_bound_ms"],
                "device_ms_by_case_s_t": {
                    f"{x['case']}/S{x['shape'][0]}/T{x['shape'][2]}":
                        x["device_ms"] for x in greedy_path}}
               if name == "greedy_assign" else {}),
            "library_ms": None})
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
