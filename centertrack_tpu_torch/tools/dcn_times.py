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
``--exact`` times the exact forward of the dtype instead
(``dcn_exact_fwd``, or ``dcn_exact_fwd_bf16`` at ``--dtype bfloat16``,
through ``ops/dcn.launch_exact_fwd[_bf16]``) at the neck shapes, B=1 and
B=6 (``chip_smoke.EXACT_BATCH``), on two kinds of offsets: ~N(0, 3)
(``chip_smoke.exact_offsets``, with ``dcn_inputs``' x, mask and weight)
and "trained", every launch of one eager ``dcn`` forward of the bench's
first synthetic frame on the exact-trained checkpoint
(``chip_smoke.trained_exact_inputs``: the nodes' own inputs, repeated
to B=6), each node its own row. Where the package has
``exact_tile_routes``, each row gives the share of its tiles that take
the window route. ``--max-n-tile N`` caps the exact plans' N tile
(``ops/dcn.EXACT_MAX_N_TILE``) for the run.

Without a GPU it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from centertrack_tpu_torch.tools import _turns

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


def measure_exact(smoke, dcn, torch, dtype: str) -> list:
    """Rows of the exact forward of `dtype` (``--exact``)."""
    low = dtype == "bfloat16"
    kernel = "dcn_exact_fwd" + ("_bf16" if low else "")
    launch = getattr(dcn, "launch_exact_fwd" + ("_bf16" if low else ""))
    plan_of = getattr(dcn, "exact_fwd_bf16_plan" if low
                      else "exact_fwd_fp32_plan", None)
    gen = torch.Generator(device="cuda").manual_seed(5)
    trained = smoke.trained_exact_inputs()["dcn", dtype]
    rows = []
    for b in (1, smoke.EXACT_BATCH):
        for name, h, w, cin, cout, per, _ in smoke.NECK_SHAPES:
            x, _, mask, weight, bias, _ = smoke.dcn_inputs(
                gen, b, h, w, cin, cout, 1, getattr(torch, dtype))
            off = smoke.exact_offsets(gen, b, h, w, 3.0,
                                      getattr(torch, dtype))
            cases = [("n3", None, per, (x, off, mask, weight, bias))]
            nodes = [a for a in trained
                     if (tuple(a[0].shape[1:]), a[3].shape[3])
                     == ((h, w, cin), cout)]
            cases += [("trained", i, 1, (
                *(t.repeat(b, 1, 1, 1) for t in a[:3]), *a[3:]))
                for i, a in enumerate(nodes)]
            for kind, node, n, args in cases:
                def fn(args=args):
                    with torch.no_grad():
                        return launch(*args)
                row = {"kernel": kernel, "map": name, "batch": b,
                       "hw": [h, w], "cin": cin, "cout": cout,
                       "offsets": kind, "node": node,
                       "launches_per_image": n,
                       "ms": smoke.time_ms(fn, 3, 20),
                       "device_ms": smoke.queued_us(fn, 20) / 1e3}
                if plan_of is not None:
                    plan = plan_of(b, h, w, cin, cout)
                    win, gat = dcn.exact_tile_routes(args[1], h, w, plan)
                    row["window_share"] = win / (win + gat)
                    row["n_tile"] = plan["n_tile"]
                    row["box_capacity"] = plan["box_capacity"]
                rows.append(row)
    return rows


def measure_clamped(smoke, dcn, torch, dtype: str) -> list:
    """Rows of the three clamped kernels of `dtype`."""
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
    return rows


def measure(root: str, dtype: str = "bfloat16", exact: bool = False,
            max_n_tile: int | None = None) -> dict:
    """Times of the kernels of `dtype` of the checkout at `root`, every
    neck shape and batch: the three clamped kernels, or with `exact` the
    exact forward (its plans' N tile capped at `max_n_tile`)."""
    _turns.use_root(root)
    import torch
    from centertrack_tpu_torch.ops import dcn
    if not torch.cuda.is_available():
        raise SystemExit("dcn_times: no CUDA device")
    smoke = _turns.smoke()
    if max_n_tile:
        dcn.EXACT_MAX_N_TILE[dtype] = max_n_tile
    rows = (measure_exact if exact else measure_clamped)(smoke, dcn, torch,
                                                         dtype)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"root": root, "dtype": dtype, "exact": exact,
            "max_n_tile": max_n_tile,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "rows": rows}


def _run(root: str, dtype: str, exact: bool = False) -> dict:
    return _turns.run("dcn_times", root, "--dtype", dtype,
                      *(["--exact"] if exact else []))[-1]


def compare(parent: str, change: str, dtype: str = "bfloat16",
            exact: bool = False) -> dict:
    """Both checkouts in the order parent, change, change, parent; per
    shape (and, with `exact`, offsets and node) the two runs' times of
    each and change / parent."""
    runs = _turns.in_turns(lambda root: _run(root, dtype, exact), parent,
                           change)
    fields = ("kernel", "map", "batch", "cin", "cout", "offsets", "node")
    key = lambda r: tuple(r.get(f) for f in fields)
    times = {}
    for side, run in runs:
        for r in run["rows"]:
            t = times.setdefault(key(r), {"row": r})
            for m in ("ms", "device_ms"):
                t.setdefault(f"{side}_{m}", []).append(r[m])
            if side == "change" and "window_share" in r:
                t["window_share"] = r["window_share"]
    rows, per_image = [], {}
    for k, t in times.items():
        row = {f: v for f, v in zip(fields, k) if v is not None}
        if "window_share" in t:
            row["window_share"] = t["window_share"]
        b = row["batch"]
        label = f"{row['kernel']} B={b}" + (
            f" {row['offsets']}" if "offsets" in row else "")
        acc = per_image.setdefault(label, {})
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
            "exact": exact,
            "device": runs[0][1]["device"],
            "nvidia_smi": [r["nvidia_smi"] for _, r in runs],
            "order": list(_turns.ORDER),
            "per_image_ms_best_of_two": per_image, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=_turns.ROOT,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--against", default=None,
                    help="checkout to compare with, run in turns")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(KERNELS),
                    help="the kernels of this dtype (default: bfloat16)")
    ap.add_argument("--exact", action="store_true",
                    help="time the exact forward of the dtype")
    ap.add_argument("--max-n-tile", type=int, default=None,
                    choices=(64, 128, 256),
                    help="cap the exact plans' N tile (with --exact)")
    args = ap.parse_args(argv)
    if args.against:
        print(json.dumps(compare(os.path.abspath(args.against), _turns.ROOT,
                                 args.dtype, args.exact)))
    else:
        print(json.dumps(measure(os.path.abspath(args.root), args.dtype,
                                 args.exact, args.max_n_tile)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
