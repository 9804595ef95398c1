"""Device times of the DCN kernels of one dtype at the seven DLA-34 neck
shapes of the 544x960 path (R=1), at B=1 and B=8, on one NVIDIA GPU, by
the measurement of ``chip_smoke.py``'s kernel and grad phases: the
forward, the data gradient and the weight gradient,
``dcn_local_fwd_bf16``, ``dcn_local_bwd_data_bf16`` and
``dcn_local_bwd_weight_bf16`` (the bf16 paths' kernels, the default), or
with ``--dtype float32`` ``dcn_local_fwd``, ``dcn_local_bwd_data`` and
``dcn_local_bwd_weight`` (the float32 paths').

    python3 -m centertrack_tpu_torch.tools.dcn_times
    python3 -m centertrack_tpu_torch.tools.dcn_times --against DIR
    python3 -m centertrack_tpu_torch.tools.dcn_times --dtype float32 \
        --against DIR

The neck shapes (``chip_smoke.NECK_SHAPES``), the seeded inputs
(``chip_smoke.dcn_inputs``) and the two times of each launch
(``chip_smoke.time_ms``: median of 20 CUDA-event timed calls after 3 of
warm-up; ``chip_smoke.queued_us``: median of 20 calls each queued behind
a spin kernel, the device's time) are the smoke's, taken from the
``chip_smoke.py`` beside this package. The kernels are called through
the launchers ``ops/dcn.launch_fwd_bf16``, ``launch_bwd_data_bf16`` and
``launch_bwd_weight_bf16`` (``launch_fwd``, ``launch_bwd_data`` and
``launch_bwd_weight`` at float32), whose signatures are the same in
every version of the port that has them.

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
# dtype -> (kernel, its launcher in ops/dcn) of the forward, the data
# gradient and the weight gradient
KERNELS = {"bfloat16": (("dcn_local_fwd_bf16", "launch_fwd_bf16"),
                        ("dcn_local_bwd_data_bf16", "launch_bwd_data_bf16"),
                        ("dcn_local_bwd_weight_bf16",
                         "launch_bwd_weight_bf16")),
           "float32": (("dcn_local_fwd", "launch_fwd"),
                       ("dcn_local_bwd_data", "launch_bwd_data"),
                       ("dcn_local_bwd_weight", "launch_bwd_weight"))}


def _smoke():
    """This checkout's chip_smoke.py as a module. The port's package must
    be imported first: the smoke then uses the package already loaded,
    whichever checkout it came from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def measure(root: str, dtype: str = "bfloat16") -> dict:
    """Times of both kernels of `dtype` of the checkout at `root`, every
    neck shape and batch."""
    sys.path.insert(0, root)
    import torch
    from centertrack_tpu_torch.ops import dcn
    if not torch.cuda.is_available():
        raise SystemExit("dcn_times: no CUDA device")
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(5)
    r = 1
    (fwd, launch_fwd), (data, launch_data), (wgt, launch_wgt) = \
        KERNELS[dtype]
    rows = []
    for b in BATCHES:
        for name, h, w, cin, cout, per, _ in smoke.NECK_SHAPES:
            x, offset, mask, weight, bias, g = smoke.dcn_inputs(
                gen, b, h, w, cin, cout, r, getattr(torch, dtype))
            calls = (lambda: getattr(dcn, launch_fwd)(x, offset, mask,
                                                      weight, bias, r),
                     lambda: getattr(dcn, launch_data)(x, offset, mask,
                                                       weight, g, r),
                     lambda: getattr(dcn, launch_wgt)(x, offset, mask, g,
                                                      cout, r))
            for kernel, fn in zip((fwd, data, wgt), calls):
                rows.append({"kernel": kernel, "map": name, "batch": b,
                             "hw": [h, w], "cin": cin, "cout": cout,
                             "launches_per_image": per,
                             "ms": smoke.time_ms(fn, 3, 20),
                             "device_ms": smoke.queued_us(fn, 20) / 1e3})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"root": root, "dtype": dtype,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "rows": rows}


def _run(root: str, dtype: str) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--root", root, "--dtype", dtype],
                         capture_output=True, text=True, cwd=root)
    if out.returncode != 0:
        raise SystemExit(f"dcn_times on {root} failed:\n{out.stdout}"
                         f"{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare(parent: str, change: str, dtype: str = "bfloat16") -> dict:
    """Both checkouts in the order parent, change, change, parent; per
    shape the two runs' times of each and change / parent."""
    runs = [_run(parent, dtype), _run(change, dtype), _run(change, dtype),
            _run(parent, dtype)]
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
    return {"parent": parent, "change": change, "dtype": dtype,
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
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(KERNELS),
                    help="the kernels of this dtype (default: bfloat16)")
    args = ap.parse_args(argv)
    if args.against:
        print(json.dumps(compare(os.path.abspath(args.against), ROOT,
                                 args.dtype)))
    else:
        print(json.dumps(measure(os.path.abspath(args.root), args.dtype)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
