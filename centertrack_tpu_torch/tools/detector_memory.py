"""Device memory that deleted FusedDetectors leave allocated, on one
NVIDIA GPU, by ``chip_smoke.py``'s ``lifetimes`` phase (ROADMAP C8):
detectors made, served through their graphs and deleted in turn, the
allocation read before and after each, and once more after freeing the
cuBLAS workspaces of every stream.

    python3 -m centertrack_tpu_torch.tools.detector_memory
    python3 -m centertrack_tpu_torch.tools.detector_memory --against DIR

``--root DIR`` measures the package of the checkout in DIR (its kernels
built into DIR/build) with this checkout's ``chip_smoke.py``;
``--against DIR`` runs DIR's package, then this one's, one process each,
and prints both rows. The phase's bound is not applied. Without a GPU it
exits with an error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def measure(root: str) -> dict:
    """The lifetimes row of the package of the checkout at `root`, by
    this checkout's chip_smoke.py (which then uses the package already
    imported)."""
    sys.path.insert(0, root)
    import torch
    import centertrack_tpu_torch  # noqa: F401  (the checkout's package)
    if not torch.cuda.is_available():
        raise SystemExit("detector_memory: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return {"root": root, "device": torch.cuda.get_device_name(0),
            **smoke.phase_lifetimes(check=False)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose port is measured (default: this "
                         "one)")
    ap.add_argument("--against", default=None,
                    help="checkout measured first, in its own process")
    args = ap.parse_args(argv)
    if args.against:
        rows = []
        for root in (os.path.abspath(args.against), ROOT):
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--root", root], capture_output=True,
                                 text=True, cwd=root)
            if out.returncode != 0:
                raise SystemExit(f"detector_memory on {root} failed:\n"
                                 f"{out.stdout}{out.stderr}")
            rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps({"parent": rows[0], "change": rows[1]}))
    else:
        print(json.dumps(measure(os.path.abspath(args.root))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
