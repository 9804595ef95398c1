"""The window probes P10-P15 on the GPU: a window copied to shared
memory, then offset loads, each probe's kernel with a pass/fail report.

The counterpart of the JAX package's ``tools/pallas_probe2.py``, with its
result names and its ``sum=`` report (summed here in float32; a bf16 sum
saturates). The kernels are those of ``csrc/probes.cu``
(``ops/probes.py``): each copies its part of the window global ->
shared with ``cp.async`` and reads it at the probe's offsets. Each
probe takes the result dict, an optional input (the JAX probe's ones by
default) and a device, and returns its output (None if it failed).

Usage: python -m centertrack_tpu_torch.tools.pallas_probe2 [out.json]
           [--device cuda|cpu]

It prints the report as JSON (and writes it to ``out.json`` when given)
and exits non-zero if any probe failed. ``--device cpu`` runs the plain
versions.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from centertrack_tpu_torch.ops import probes


def _run(name, fn, res):
    try:
        out = fn()
        res[name] = f"OK sum={float(out.float().sum()):.3f}"
    except Exception as e:  # noqa: BLE001 - a failure is the report
        out = None
        first = (str(e).splitlines() or [""])[0]
        res[name] = f"FAIL {type(e).__name__}: {first[:100]}"
    print(name, res[name], flush=True)
    return out


def _tool(name, result):
    """The tool's probe ``name``, reported as ``result`` (the JAX tool's
    name): ``probe(res, x=None, device="cuda")``, on the JAX probe's own
    input when ``x`` is None."""
    def probe(res, x=None, device="cuda"):
        def call():   # inside _run: a failure here is reported too
            return probes.run(name, probes.default_inputs(name, device)[0]
                              if x is None else x)
        return _run(result, call, res)
    probe.__name__ = probe.__qualname__ = name
    return probe


p10_aligned = _tool("p10_aligned", "p10_fullload_valueslice")
p11_leading_offset = _tool("p11_leading_offset", "p11_leading_dim_offset")
p12_sublane_offset = _tool("p12_sublane_offset", "p12_sublane_offset")
p13_value_slice = _tool("p13_value_slice", "p13_value_dynslice")
p14_4d_leading = _tool("p14_4d_leading", "p14_4d_leading_index")
p15_dynamic_leading = _tool("p15_dynamic_leading",
                            "p15_dynamic_leading_offset")

PROBES = (p10_aligned, p11_leading_offset, p12_sublane_offset,
          p13_value_slice, p14_4d_leading, p15_dynamic_leading)


def _device_name(device):
    if device == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", help="also write the report here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = {"device": _device_name(args.device)}
    for fn in PROBES:
        fn(res, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)
    return 0 if all(v.startswith("OK") for k, v in res.items()
                    if k != "device") else 1


if __name__ == "__main__":
    sys.exit(main())
