"""Where a block of the bf16 DCN kernels spends its cycles, on one
NVIDIA GPU: `dcn_local_fwd_bf16` and `dcn_local_bwd_data_bf16` are
built from their sources with `-DDCN_PHASES`, which turns their
`DCN_PHASE(k)` marks (`csrc/hopper.cuh`) into `clock64()` counters at
the phase boundaries of their K loop, launched through the port's
launchers at the neck shapes below, and each phase's cycles, summed over
each block's thread 0 and averaged over the blocks, printed as one JSON
line per kernel and shape.

    python3 -m centertrack_tpu_torch.tools.dcn_bf16_phases

Phases of the forward: `prologue` (first copies, and each step's product
and next copies), `wait` (copy wait and barrier), `sample` (building
A_t), `barrier` (before the product). Of the data kernel: `prologue`
(tile staging and each step's tail), `wait` (copy wait and barrier),
`product` (G on the tensor cores), `walk` (support walk),
`chunk_barrier`, `flush` (grad-x tile to the scratch). The counters cost
a few cycles each; the instrumented libraries are built under
build/phases and used only by this tool, in this process. Without a GPU
it exits with an error.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_DIR = os.path.join(ROOT, "build", "phases")

# (B, H, W, Cin, Cout) at R=1: two neck shapes at the training batch and
# two at the serving batch
SHAPES = [(8, 136, 240, 64, 64), (8, 34, 60, 256, 128),
          (1, 136, 240, 64, 64), (1, 68, 120, 128, 128)]

# source in csrc/ -> (symbol, phase names in DCN_PHASE order)
KERNELS = {
    "dcn_local_bf16": ("dcn_local_fwd_bf16",
                       ["prologue", "wait", "sample", "barrier"]),
    "dcn_local_bwd_bf16": ("dcn_local_bwd_data_bf16",
                           ["prologue", "wait", "product", "walk",
                            "chunk_barrier", "flush"]),
}


def _instrumented(_build, name):
    """csrc/<name>.cu built with -DDCN_PHASES; its library."""
    os.makedirs(OUT_DIR, exist_ok=True)
    lib = os.path.join(OUT_DIR, name + ".so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DDCN_PHASES",
                    "-o", lib, os.path.join(_build.CSRC_DIR, name + ".cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch
    from centertrack_tpu_torch.ops import _build, dcn
    if not torch.cuda.is_available():
        raise SystemExit("dcn_bf16_phases: no CUDA device")
    libs, launchers = {}, {}
    for name, (symbol, _) in KERNELS.items():
        libs[name] = _instrumented(_build, name)
        fn = getattr(libs[name], symbol)
        _, n_ptr, n_int = dcn._SIGNATURES[symbol]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        launchers[symbol] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, r = torch.bfloat16, 1
    with mock.patch.dict(dcn._launchers, launchers):
        for b, h, w, cin, cout in SHAPES:
            x = torch.randn(b, h, w, cin, generator=gen,
                            device="cuda").to(bf16)
            offset = ((torch.rand(b, h, w, 18, generator=gen, device="cuda")
                       * 2 - 1) * (r + 1.5)).to(bf16)
            mask = torch.rand(b, h, w, 9, generator=gen,
                              device="cuda").to(bf16)
            weight = (torch.randn(3, 3, cin, cout, generator=gen,
                                  device="cuda") * 0.05).to(bf16)
            g = torch.randn(b, h, w, cout, generator=gen,
                            device="cuda").to(bf16)
            runs = {
                "dcn_local_bf16": (lambda: dcn.launch_fwd_bf16(
                    x, offset, mask, weight, None, r),
                    dcn.fwd_bf16_plan(b, h, w, cin, cout, r)),
                "dcn_local_bwd_bf16": (lambda: dcn.launch_bwd_data_bf16(
                    x, offset, mask, weight, g, r),
                    dcn.bwd_data_bf16_plan(b, h, w, cin, cout, r))}
            for name, (call, plan) in runs.items():
                symbol, phases = KERNELS[name]
                buf = (ctypes.c_ulonglong * 8)()
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                libs[name].dcn_read_phases(buf)   # clears the warm-up's
                call()
                torch.cuda.synchronize()
                if libs[name].dcn_read_phases(buf) != 0:
                    raise SystemExit(f"dcn_bf16_phases: reading {symbol}'s "
                                     f"counters failed")
                cycles = {p: buf[i] / plan["blocks"]
                          for i, p in enumerate(phases)}
                print(json.dumps({
                    "kernel": symbol, "batch": b, "hw": [h, w], "cin": cin,
                    "cout": cout, "blocks": plan["blocks"],
                    "splits": plan["splits"],
                    "steps_per_block": plan["steps"] / plan["splits"],
                    "cycles_per_block": cycles,
                    "share": {p: c / sum(cycles.values())
                              for p, c in cycles.items()}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
