"""Device times of the two bf16 DCN kernels that the bf16 serving and
training paths launch, ``dcn_local_fwd_bf16`` and
``dcn_local_bwd_data_bf16``, at the seven DLA-34 neck shapes of the
544x960 path (R=1), at B=1 and B=8, on one NVIDIA GPU, by the
measurement of ``chip_smoke.py``'s bf16 kernel and grad_bf16 phases.

    python3 -m centertrack_tpu_torch.tools.dcn_bf16_times
    python3 -m centertrack_tpu_torch.tools.dcn_bf16_times --against DIR

The neck shapes (``chip_smoke.NECK_SHAPES``), the seeded inputs
(``chip_smoke.bf16_dcn_inputs``) and the two times of each launch
(``chip_smoke.time_ms``: median of 20 CUDA-event timed calls after 3 of
warm-up; ``chip_smoke.queued_us``: median of 20 calls each queued behind
a spin kernel, the device's time) are the smoke's, taken from the
``chip_smoke.py`` beside this package. The kernels are called through
the launchers ``ops/dcn.launch_fwd_bf16`` and ``launch_bwd_data_bf16``,
whose signatures are the same in every version of the port that has
them.

``--root DIR`` times the package of the checkout in DIR instead of this
one (its kernels are built into DIR/build), with this checkout's
``chip_smoke.py``. ``--against DIR`` compares two checkouts in one
process tree on one card: it runs this script on DIR, on this checkout,
on this checkout again and on DIR (in that order, one process each) and
prints one JSON object with every shape's times of both, their ratio,
and the per-image sums over the 16 neck launches of a 544x960 frame.
Without a GPU it exits with an error.
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
BATCHES = (1, 8)
KERNELS = ("dcn_local_fwd_bf16", "dcn_local_bwd_data_bf16")


def _smoke():
    """This checkout's chip_smoke.py as a module. The port's package must
    be imported first: the smoke then uses the package already loaded,
    whichever checkout it came from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def measure(root: str) -> dict:
    """Times of both kernels of the checkout at `root`, every neck shape
    and batch."""
    sys.path.insert(0, root)
    import torch
    from centertrack_tpu_torch.ops import dcn
    if not torch.cuda.is_available():
        raise SystemExit("dcn_bf16_times: no CUDA device")
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(5)
    r = 1
    rows = []
    for b in BATCHES:
        for name, h, w, cin, cout, per, _ in smoke.NECK_SHAPES:
            x, offset, mask, weight, bias, g = smoke.bf16_dcn_inputs(
                gen, b, h, w, cin, cout, r)
            calls = (lambda: dcn.launch_fwd_bf16(x, offset, mask, weight,
                                                 bias, r),
                     lambda: dcn.launch_bwd_data_bf16(x, offset, mask,
                                                      weight, g, r))
            for kernel, fn in zip(KERNELS, calls):
                rows.append({"kernel": kernel, "map": name, "batch": b,
                             "hw": [h, w], "cin": cin, "cout": cout,
                             "launches_per_image": per,
                             "ms": smoke.time_ms(fn, 3, 20),
                             "device_ms": smoke.queued_us(fn, 20) / 1e3})
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
        raise SystemExit(f"dcn_bf16_times on {root} failed:\n{out.stdout}"
                         f"{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare(parent: str, change: str) -> dict:
    """Both checkouts in the order parent, change, change, parent; per
    shape the two runs' times of each and change / parent."""
    runs = [_run(parent), _run(change), _run(change), _run(parent)]
    key = lambda r: (r["kernel"], r["map"], r["batch"], r["cin"], r["cout"])
    times = {}
    for i, run in enumerate(runs):
        side = "parent" if i in (0, 3) else "change"
        for r in run["rows"]:
            t = times.setdefault(key(r), {"row": r})
            for m in ("ms", "device_ms"):
                t.setdefault(f"{side}_{m}", []).append(r[m])
    rows, per_image = [], {}
    for (kernel, name, b, cin, cout), t in times.items():
        row = {"kernel": kernel, "map": name, "batch": b, "cin": cin,
               "cout": cout}
        acc = per_image.setdefault(f"{kernel} B={b}", {})
        for m in ("ms", "device_ms"):
            p, c = min(t[f"parent_{m}"]), min(t[f"change_{m}"])
            row.update({f"parent_{m}": t[f"parent_{m}"],
                        f"change_{m}": t[f"change_{m}"],
                        f"speedup_{m}": p / c})
            n = t["row"]["launches_per_image"]
            acc[f"parent_{m}"] = acc.get(f"parent_{m}", 0.0) + p * n / b
            acc[f"change_{m}"] = acc.get(f"change_{m}", 0.0) + c * n / b
        rows.append(row)
    for v in per_image.values():
        for m in ("ms", "device_ms"):
            v[f"speedup_{m}"] = v[f"parent_{m}"] / v[f"change_{m}"]
    return {"parent": parent, "change": change,
            "device": runs[0]["device"],
            "nvidia_smi": [r["nvidia_smi"] for r in runs],
            "order": ["parent", "change", "change", "parent"],
            "per_image_ms_best_of_two": per_image, "rows": rows}


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
