"""The toolchain probes P0-P8 on the GPU: each probe's kernel on its
inputs, one after another, with a pass/fail report.

The counterpart of the JAX package's ``tools/pallas_probe.py``, with its
names and report. P0-P6 are the kernels of ``csrc/probes.cu``
(``ops/probes.py``), each taking optional inputs (the JAX probe's ones
by default) and a device; P7 and P8, the real DCN at 1x64x128x64 and
R=1 in bf16 on the JAX probe's inputs, go through ``ops/dcn``, which on
the card is ``dcn_local_fwd_bf16``.

Usage: python -m centertrack_tpu_torch.tools.pallas_probe [out.json]
           [--device cuda|cpu]

It prints ``{name: "OK (t s)" | "FAIL ..."}`` as one JSON line (and
writes it to ``out.json`` when given) and exits non-zero if any probe
failed. ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from centertrack_tpu_torch.ops import dcn, probes


def _tool(name):
    """The tool's probe ``name``: ``probe(*inputs, device="cuda")``, with
    the JAX probe's own input in place of each input left out or None."""
    def probe(*given, device="cuda"):
        default = probes.default_inputs(name, device)
        given = list(given) + [None] * (len(default) - len(given))
        return probes.run(name, *[d if g is None else g
                                  for g, d in zip(given, default)])
    probe.__name__ = probe.__qualname__ = name
    return probe


p0_copy = _tool("p0_copy")
p1_fma12 = _tool("p1_fma12")
p2_fma30 = _tool("p2_fma30")
p3_tap_loop = _tool("p3_tap_loop")
p4_sublane_slice = _tool("p4_sublane_slice")
p5_lane_slice = _tool("p5_lane_slice")
p6_gather = _tool("p6_gather")


def p7_dcn_pallas(device="cuda"):
    """``ops/dcn``'s bf16 forward at R=1 on the JAX probe's inputs,
    1x64x128x64 from RandomState(0). The JAX tool's P7 runs them through
    K1 (``deform_conv2d_pallas``) and its P8 through K3
    (``deform_conv2d_local_pallas``): one forward here."""
    rng = np.random.RandomState(0)
    arrays = (rng.randn(1, 64, 128, 64), rng.randn(1, 64, 128, 18),
              rng.rand(1, 64, 128, 9), rng.randn(3, 3, 64, 64) * 0.05)
    x, off, mask, wt = [torch.from_numpy(a.astype(np.float32)).to(
        device=device, dtype=torch.bfloat16) for a in arrays]
    with torch.no_grad():
        return dcn.deform_conv2d_local(x, off, mask, wt, None, 1)


p8_preshift_local = p7_dcn_pallas

# the JAX tool's names, in its order
PROBES = {"p0_copy": p0_copy, "p1_fma12": p1_fma12, "p2_fma30": p2_fma30,
          "p3_tap_loop": p3_tap_loop, "p4_sublane_slice": p4_sublane_slice,
          "p5_lane_slice": p5_lane_slice, "p6_gather": p6_gather,
          "p7_dcn_pallas": p7_dcn_pallas,
          "p8_preshift_local": p8_preshift_local}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", help="also write the report here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    results = {}
    for name, fn in PROBES.items():
        t0 = time.time()
        try:
            fn(device=args.device).cpu()
            results[name] = f"OK ({time.time() - t0:.1f}s)"
        except Exception as e:  # noqa: BLE001 - a failure is the report
            results[name] = f"FAIL {type(e).__name__}: {e}"[:300]
        print(f"{name}: {results[name]}", file=sys.stderr, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return 0 if all(v.startswith("OK") for v in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
