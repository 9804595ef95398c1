"""Device times of the serving step's tracker kernels, ``greedy_assign``
and ``splat_pre_hm`` (``csrc/tracker.cu``), on one NVIDIA GPU, on the
cases of ``chip_smoke.py``'s tracker phase: greedy_assign on every
``GREEDY_CASES`` case at S = 1 and 6 streams and T = 256 and 1024 slots,
splat_pre_hm on every ``SPLAT_CASES`` case at S = 1 and 6 on the
544 x 960 canvas.

    python3 -m centertrack_tpu_torch.tools.tracker_times
    python3 -m centertrack_tpu_torch.tools.tracker_times --against DIR

The cases (``chip_smoke.greedy_case``, ``splat_case``, their seeds) and
the time of each call (``chip_smoke.queued_us``: median of 30 calls each
queued behind a spin kernel, the device's time) are the smoke's, taken
from the ``chip_smoke.py`` beside this package; the kernels are called
through the launchers ``ops/tracker.launch_greedy_assign`` and
``ops/gaussian.launch_splat_pre_hm``, whose signatures are the same in
every version of the port that has them.

``--root DIR`` times the package of the checkout in DIR instead of this
one (its kernels are built into DIR/build). ``--against DIR`` runs this
script on DIR, on this checkout, on this checkout again and on DIR (in
that order, one process each) and prints one JSON object with every
case's device times of both and parent / change. Without a GPU it exits
with an error.
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


def _smoke():
    """This checkout's chip_smoke.py as a module, over the package
    already imported (whichever checkout it came from)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def measure(root: str) -> dict:
    """Device µs per call of both kernels of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch
    from centertrack_tpu_torch.ops import gaussian, tracker
    if not torch.cuda.is_available():
        raise SystemExit("tracker_times: no CUDA device")
    smoke = _smoke()
    rows = []
    for ci, name in enumerate(smoke.GREEDY_CASES):
        for s in smoke.TRACKER_STREAMS:
            for t in smoke.TRACKER_SLOTS:
                dist = torch.from_numpy(smoke.greedy_case(
                    name, s, t, 100 * ci + s + t)).cuda()
                rows.append({"kernel": "greedy_assign", "case": name,
                             "shape": [s, smoke.TRACKER_K, t],
                             "device_us": smoke.queued_us(
                                 lambda: tracker.launch_greedy_assign(dist),
                                 30)})
    for ci, name in enumerate(smoke.SPLAT_CASES):
        for s in smoke.TRACKER_STREAMS:
            args = (*smoke.SPLAT_HW, *smoke.splat_case(name, s, 256,
                                                       7 * ci + s))
            rows.append({"kernel": "splat_pre_hm", "case": name,
                         "shape": [s, *smoke.SPLAT_HW, 256],
                         "device_us": smoke.queued_us(
                             lambda: gaussian.launch_splat_pre_hm(*args),
                             30)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "rows": rows}


def _run(root: str) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--root", root], capture_output=True, text=True,
                         cwd=root)
    if out.returncode != 0:
        raise SystemExit(f"tracker_times on {root} failed:\n{out.stdout}"
                         f"{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare(parent: str, change: str) -> dict:
    """Both checkouts in the order parent, change, change, parent; per
    case the two runs' times of each and parent / change (best of two)."""
    runs = [_run(parent), _run(change), _run(change), _run(parent)]
    times = {}
    for i, run in enumerate(runs):
        side = "parent" if i in (0, 3) else "change"
        for r in run["rows"]:
            t = times.setdefault((r["kernel"], r["case"], *r["shape"]),
                                 {"kernel": r["kernel"], "case": r["case"],
                                  "shape": r["shape"]})
            t.setdefault(f"{side}_device_us", []).append(r["device_us"])
    for t in times.values():
        t["speedup"] = min(t["parent_device_us"]) / min(
            t["change_device_us"])
    return {"parent": parent, "change": change, "device": runs[0]["device"],
            "nvidia_smi": [r["nvidia_smi"] for r in runs],
            "order": ["parent", "change", "change", "parent"],
            "rows": list(times.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--against", default=None,
                    help="checkout to compare with, run in turns")
    args = ap.parse_args(argv)
    if args.against:
        print(json.dumps(compare(os.path.abspath(args.against), ROOT)))
    else:
        print(json.dumps(measure(os.path.abspath(args.root))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
