"""Where a block of the DCN kernels spends its cycles, on one NVIDIA GPU:
`dcn_local_fwd_bf16`, `dcn_local_bwd_data_bf16` and
`dcn_local_bwd_weight_bf16` (the default), or with `--dtype float32`
`dcn_local_fwd`, `dcn_local_bwd_data` and `dcn_local_bwd_weight`, are
built from their sources with `-DDCN_PHASES`, which turns their
`DCN_PHASE(k)` marks (`csrc/hopper.cuh`) into `clock64()` counters at
the phase boundaries of their K loop, launched through the port's
launchers at the neck shapes below, and each phase's cycles, summed
over each block's thread 0 and averaged over the blocks, printed as one
JSON line per kernel and shape.

    python3 -m centertrack_tpu_torch.tools.dcn_phases
    python3 -m centertrack_tpu_torch.tools.dcn_phases --dtype float32
    python3 -m centertrack_tpu_torch.tools.dcn_phases --exact \
        [--dtype float32]
    python3 -m centertrack_tpu_torch.tools.dcn_phases --exact-bwd \
        [--dtype float32] [--root DIR]

With ``--exact`` the exact forward of the dtype (``dcn_exact_fwd`` or
``dcn_exact_fwd_bf16``) runs instead, at B=1 on every launch of one
eager ``dcn`` forward of the bench's first synthetic frame
(``chip_smoke.trained_exact_inputs``: each neck node's own inputs), one
line per node, with its window share (``ops/dcn.exact_tile_routes``).
Its phases are the float32 forward's four and `prologue` (the corner
table, the tile's box and its route). With ``--exact-bwd`` the exact
backward's data and weight kernels of the dtype (``dcn_exact_bwd_data``,
``dcn_exact_bwd_weight`` or their bf16 twins, csrc/dcn_exact_bwd.cu) run
on the same inputs with a seeded output grad, one line per node and
kernel, with its window share (``exact_bwd_tile_routes`` for the data
kernel, ``exact_tile_routes`` for the weight kernel). The exact data
kernel's warpgroups all walk, each issuing its own G and copies: one
thread (the block's thread 0) is recorded, as the role `walker`
(``EXACT_DATA_PHASES``, ``DATA_ROLE_SLOTS``), its phases with their
share of its cycles: `table` (the corner table and the tile's box),
`staging` (the first copies' wait, the output grad's split, the first
G), `g_wait` (each step's wait for its G, issued a step ahead),
`copy_wait` (the waits for the next step's weights and a chunk's
window, and the warpgroup's barrier), `issue` (issuing the next step's
G and the next copies), `walk` (the corner walk: the table's entries,
reads of x and the sums), `reductions` (the walk's global reductions
into grad x, one a live corner: sending only, as no thread waits for a
reduction), `flush` (the sums of grad offset and grad mask out).
``--root DIR`` runs the package of the checkout in DIR instead of this
one (built under build/phases by its source directory; the trained
inputs still come from this checkout's ``chip_smoke.py``). The
exact weight kernel is warp-specialised: one thread of each of its
roles is recorded apart, in slots of its own (``EXACT_WEIGHT_PHASES``,
``ROLE_SLOTS``: the stager's thread 0, the first sampler's first
thread, a consumer's thread 0), each role's phases with their share of
that role's cycles. Stager: `built_wait` (for the samplers to be done
with the slot the tile takes), `entries` (its corners, box and route,
with the stager's barrier), `entries_load` (issuing the next tile's
offsets and mask loads), `copies` (issuing its output grad and window
copies, with the waits for free slots). Sampler: `window_wait` (for the
tile's window, table and box), `stage_wait` (for a free stage of the
ring), `build` (a tap's sample into the stage), `publish` (the proxy
fence and the stage's full arrive). Consumer: `g_wait` (for the tile's
output grad), `g_load` (g^T into registers, split at float32),
`full_wait` (for a full stage), `issue` (the product's wgmma),
`product_wait` (for the product, then freeing its stage), `tile_end` (a
tile's end), `flush` (the accumulators out).

Phases of the bf16 forward: `prologue` (first copies, and each step's
product and next copies), `wait` (copy wait and barrier), `sample`
(building A_t), `barrier` (before the product). Of the float32 forward,
whose product runs under the next step's sampling: `window_wait` (the
corner table and first copies, and a chunk's window where it was copied
late), `sample` (building A_s), `wait` (copy wait and barrier),
`product` (issuing A_s's product, waiting for the one before it, the
barrier and the next copies). Of the data kernels: `prologue` (tile
staging and each step's tail), `wait` (copy wait and barrier), `product`
(G on the tensor cores), `walk` (support walk), `chunk_barrier`, `flush`
(grad-x tile out by atomics). Of the weight kernels (both dtypes):
`window_wait` (the first tile's staging and each tile's wait for its
copies), `barrier` (the barrier after it), `next_window` (issuing the
next tile's window copy), `next_entries` (loading its offsets and
mask), `build` (building a tap's A_t and the barrier after it),
`product`
(issuing its product, waiting for the one before it, the barrier and,
after a tile's first, the next tile's output grad into its slot),
`table` (the next tile's corner table), `flush` (the accumulators
out). The counters cost
a few cycles each; the instrumented libraries are built under
build/phases and used only by this tool, in this process. Without a GPU
it exits with an error.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from unittest import mock

from centertrack_tpu_torch.tools import _turns

OUT_DIR = os.path.join(_turns.ROOT, "build", "phases")

# (B, H, W, Cin, Cout) at R=1: two neck shapes at the training batch and
# two at the serving batch
SHAPES = [(8, 136, 240, 64, 64), (8, 34, 60, 256, 128),
          (1, 136, 240, 64, 64), (1, 68, 120, 128, 128)]

FWD_PHASES = ["prologue", "wait", "sample", "barrier"]
FWD_FP32_PHASES = ["window_wait", "sample", "wait", "product"]
DATA_PHASES = ["prologue", "wait", "product", "walk", "chunk_barrier",
               "flush"]
WEIGHT_PHASES = ["window_wait", "build", "product", "flush", "table",
                 "barrier", "next_window", "next_entries"]
EXACT_PHASES = FWD_FP32_PHASES + ["prologue"]
# dtype -> symbol -> (source in csrc/, phase names in DCN_PHASE order,
# its launcher and its planner in ops/dcn)
KERNELS = {
    "bfloat16": {
        "dcn_local_fwd_bf16": ("dcn_local_bf16", FWD_PHASES,
                               "launch_fwd_bf16", "fwd_bf16_plan"),
        "dcn_local_bwd_data_bf16": ("dcn_local_bwd_bf16", DATA_PHASES,
                                    "launch_bwd_data_bf16",
                                    "bwd_data_bf16_plan"),
        "dcn_local_bwd_weight_bf16": ("dcn_local_bwd_bf16", WEIGHT_PHASES,
                                      "launch_bwd_weight_bf16",
                                      "bwd_weight_bf16_plan")},
    "float32": {
        "dcn_local_fwd": ("dcn_local", FWD_FP32_PHASES, "launch_fwd",
                          "fwd_fp32_plan"),
        "dcn_local_bwd_data": ("dcn_local_bwd", DATA_PHASES,
                               "launch_bwd_data", "bwd_data_fp32_plan"),
        "dcn_local_bwd_weight": ("dcn_local_bwd", WEIGHT_PHASES,
                                 "launch_bwd_weight",
                                 "bwd_weight_fp32_plan")},
}
# the exact data kernel records one walker thread, its phases from its
# DATA_ROLE_SLOTS on
EXACT_DATA_PHASES = {"walker": ["table", "staging", "g_wait", "copy_wait",
                                "issue", "walk", "reductions", "flush"]}
DATA_ROLE_SLOTS = {"walker": 0}
# the exact weight kernel records one thread of each role, each role's
# phases in slots from its ROLE_SLOTS on
EXACT_WEIGHT_PHASES = {
    "stager": ["built_wait", "entries", "entries_load", "copies"],
    "sampler": ["window_wait", "stage_wait", "build", "publish"],
    "consumer": ["g_wait", "g_load", "full_wait", "issue", "product_wait",
                 "tile_end", "flush"]}
ROLE_SLOTS = {"stager": 0, "sampler": 4, "consumer": 8}
SLOTS = 16
EXACT_BWD = {
    dtype: {"dcn_exact_bwd_data" + sfx: ("dcn_exact_bwd", EXACT_DATA_PHASES,
                                         "launch_exact_bwd_data" + sfx,
                                         "exact_bwd_data_" + plan),
            "dcn_exact_bwd_weight" + sfx: ("dcn_exact_bwd",
                                           EXACT_WEIGHT_PHASES,
                                           "launch_exact_bwd_weight" + sfx,
                                           "exact_bwd_weight_" + plan)}
    for dtype, sfx, plan in (("bfloat16", "_bf16", "bf16_plan"),
                             ("float32", "", "fp32_plan"))}
EXACT = {"bfloat16": {"dcn_exact_fwd_bf16": ("dcn_exact", EXACT_PHASES,
                                             "launch_exact_fwd_bf16",
                                             "exact_fwd_bf16_plan")},
         "float32": {"dcn_exact_fwd": ("dcn_exact", EXACT_PHASES,
                                       "launch_exact_fwd",
                                       "exact_fwd_fp32_plan")}}


def _instrumented(_build, name):
    """csrc/<name>.cu of the package `_build` belongs to, built with
    -DDCN_PHASES under build/phases/<its source directory's hash>; its
    library."""
    out = os.path.join(OUT_DIR, hashlib.sha1(
        _build.CSRC_DIR.encode()).hexdigest()[:12])
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, name + ".so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DDCN_PHASES",
                    "-o", lib, os.path.join(_build.CSRC_DIR, name + ".cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def _cycles(lib, call, blocks, phases, symbol, slots=ROLE_SLOTS):
    """Each phase's cycles per block of one call, after three warm-up
    calls: {name: cycles} for a list of names (slots 0..), or for the
    exact backward kernels' roles {role: {name: cycles}} (each role's from
    its entry of ``slots``)."""
    import torch
    buf = (ctypes.c_ulonglong * SLOTS)()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    lib.dcn_read_phases(buf)   # clears the warm-up's
    call()
    torch.cuda.synchronize()
    if lib.dcn_read_phases(buf) != 0:
        raise SystemExit(f"dcn_phases: reading {symbol}'s counters failed")
    if isinstance(phases, dict):
        return {role: {p: buf[slots[role] + i] / blocks
                       for i, p in enumerate(names)}
                for role, names in phases.items()}
    return {p: buf[i] / blocks for i, p in enumerate(phases)}


def _share(cycles):
    """Each phase's share of its role's cycles (of all, for one role)."""
    if all(isinstance(v, dict) for v in cycles.values()):
        return {role: _share(c) for role, c in cycles.items()}
    total = sum(cycles.values()) or 1
    return {p: c / total for p, c in cycles.items()}


def _exact_phases(kernels, libs, dcn, torch, dtype):
    """``--exact``: one line per launch of the dcn forward of `dtype`."""
    smoke = _turns.smoke()
    (symbol, (name, phases, launch, planner)), = kernels.items()
    for node, args in enumerate(smoke.trained_exact_inputs()["dcn", dtype]):
        x, offset, _, weight, _ = args
        b, h, w, cin = x.shape
        cout = weight.shape[3]
        plan = getattr(dcn, planner)(b, h, w, cin, cout)

        def call():
            with torch.no_grad():
                return getattr(dcn, launch)(*args)
        cycles = _cycles(libs[name], call, plan["blocks"], phases, symbol)
        win, gat = dcn.exact_tile_routes(offset, h, w, plan)
        print(json.dumps({
            "kernel": symbol, "node": node, "batch": b, "hw": [h, w],
            "cin": cin, "cout": cout, "n_tile": plan["n_tile"],
            "box_capacity": plan["box_capacity"],
            "window_slots": plan["window_slots"], "blocks": plan["blocks"],
            "splits": plan["splits"], "window_share": win / (win + gat),
            "steps_per_block": plan["steps"] / plan["splits"],
            "cycles_per_block": cycles,
            "share": {p: c / sum(cycles.values())
                      for p, c in cycles.items()}}), flush=True)


def _exact_bwd_phases(kernels, libs, dcn, torch, dtype):
    """``--exact-bwd``: one line per launch of the dcn forward of `dtype`
    and backward kernel, with a seeded output grad."""
    smoke = _turns.smoke()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for node, args in enumerate(smoke.trained_exact_inputs()["dcn", dtype]):
        x, offset, mask, weight, _ = args
        b, h, w, cin = x.shape
        cout = weight.shape[3]
        g = torch.randn(b, h, w, cout, generator=gen,
                        device="cuda").to(x.dtype)
        for symbol, (name, phases, launch, planner) in kernels.items():
            plan = getattr(dcn, planner)(b, h, w, cin, cout)
            if phases is EXACT_DATA_PHASES:
                call = lambda: getattr(dcn, launch)(x, offset, mask, weight,
                                                    g)
                win, gat = dcn.exact_bwd_tile_routes(offset, mask, h, w,
                                                     plan)
            else:
                call = lambda: getattr(dcn, launch)(x, offset, mask, g, cout)
                win, gat = dcn.exact_tile_routes(offset, h, w, plan)
            cycles = _cycles(libs[name], call, plan["blocks"], phases,
                             symbol, DATA_ROLE_SLOTS
                             if phases is EXACT_DATA_PHASES else ROLE_SLOTS)
            print(json.dumps({
                "kernel": symbol, "node": node, "batch": b, "hw": [h, w],
                "cin": cin, "cout": cout, "chunk": plan["chunk"],
                **{k: plan[k] for k in ("tile", "warpgroups", "taps",
                                        "stages", "window_slots")
                   if k in plan},
                "box_capacity": plan["box_capacity"],
                "resident": plan["resident"], "blocks": plan["blocks"],
                "splits": plan["splits"], "window_share": win / (win + gat),
                "cycles_per_block": cycles,
                "share": _share(cycles)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(KERNELS),
                    help="the kernels of this dtype (default: bfloat16)")
    ap.add_argument("--exact", action="store_true",
                    help="the exact forward, on trained offsets")
    ap.add_argument("--exact-bwd", action="store_true",
                    help="the exact backward kernels, on trained offsets")
    ap.add_argument("--root", default=_turns.ROOT,
                    help="checkout whose port is run (default: this one)")
    args = ap.parse_args(argv)
    kernels = (EXACT_BWD if args.exact_bwd else EXACT if args.exact
               else KERNELS)[args.dtype]
    _turns.use_root(args.root)
    import torch
    from centertrack_tpu_torch.ops import _build, dcn
    if not torch.cuda.is_available():
        raise SystemExit("dcn_phases: no CUDA device")
    libs, launchers = {}, {}
    for symbol, (name, *_) in kernels.items():
        if name not in libs:
            libs[name] = _instrumented(_build, name)
        fn = getattr(libs[name], symbol)
        _, n_ptr, n_int = dcn._SIGNATURES[symbol]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        launchers[symbol] = fn
    if args.exact or args.exact_bwd:
        with mock.patch.dict(_build._symbols, launchers):
            (_exact_bwd_phases if args.exact_bwd else _exact_phases)(
                kernels, libs, dcn, torch, args.dtype)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    r = 1
    with mock.patch.dict(_build._symbols, launchers):
        for b, h, w, cin, cout in SHAPES:
            x = torch.randn(b, h, w, cin, generator=gen,
                            device="cuda").to(dtype)
            offset = ((torch.rand(b, h, w, 18, generator=gen, device="cuda")
                       * 2 - 1) * (r + 1.5)).to(dtype)
            mask = torch.rand(b, h, w, 9, generator=gen,
                              device="cuda").to(dtype)
            weight = (torch.randn(3, 3, cin, cout, generator=gen,
                                  device="cuda") * 0.05).to(dtype)
            g = torch.randn(b, h, w, cout, generator=gen,
                            device="cuda").to(dtype)
            for symbol, (name, phases, launch, planner) in kernels.items():
                if phases is WEIGHT_PHASES:
                    call = (lambda: getattr(dcn, launch)(
                        x, offset, mask, g, cout, r))
                else:
                    fwd = phases is not DATA_PHASES
                    call = (lambda: getattr(dcn, launch)(
                        x, offset, mask, weight, None if fwd else g, r))
                plan = getattr(dcn, planner)(b, h, w, cin, cout, r)
                # the K loop of a block: steps (taps x Cin chunks) for the
                # forward and data kernels, pixel tiles for the weight
                steps = plan["steps"] if "steps" in plan else plan["tiles"]
                cycles = _cycles(libs[name], call, plan["blocks"], phases,
                                 symbol)
                print(json.dumps({
                    "kernel": symbol, "batch": b, "hw": [h, w], "cin": cin,
                    "cout": cout, "chunk": plan["chunk"],
                    "blocks": plan["blocks"], "splits": plan["splits"],
                    "steps_per_block": steps / plan["splits"],
                    "cycles_per_block": cycles,
                    "share": {p: c / sum(cycles.values())
                              for p, c in cycles.items()}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
