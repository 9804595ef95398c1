"""Device times of the exact DCNv2 backward kernels
(``dcn_exact_bwd_data[_bf16]``, ``dcn_exact_bwd_weight[_bf16]``,
csrc/dcn_exact_bwd.cu) on one NVIDIA GPU, per 544x960 image of a
training step at dla_node "dcn": the 16 neck launches, each on its
node's own inputs from one eager forward of the bench's first synthetic
frame on the exact-trained checkpoint (``chip_smoke.trained_exact_inputs``)
with a seeded output grad, at B=1 ("trained") and repeated to B=6
(``chip_smoke.EXACT_BATCH``, "trained_b6", per image); and at B=1 on
offsets ~N(0, 3) ("n3": ``chip_smoke.dcn_inputs`` and
``chip_smoke.exact_offsets``, each neck shape times its launches an
image).

    python3 -m centertrack_tpu_torch.tools.exact_bwd_times
    python3 -m centertrack_tpu_torch.tools.exact_bwd_times \
        --data-box-min 320 128 --reps 2
    python3 -m centertrack_tpu_torch.tools.exact_bwd_times --against DIR \
        [--kernel data]

Each launch's device time is ``chip_smoke.queued_us`` (median of 20
calls queued behind a spin kernel); each run first holds every trained
B=1 launch's gradients against autograd of the plain version (float32
within ``chip_smoke.GRAD_REL_TOL`` of max|plain|, bf16 within 2e-2) and
counts its routes. ``--data-box-min`` runs the data kernels' plans at
each value of ``ops/dcn.EXACT_DATA_BOX_MIN`` in turn (the smallest
window pixels a plan accepts, at two resident blocks where it fits);
``--reps`` repeats the sequence; ``--kernel`` times only the data or the
weight kernels. One JSON line per (dtype, kernel, value, rep): per case
the per-image device ms, the window and gather tiles, and per neck shape
the device ms of its last node and its plan (chunk, capacity, resident
blocks, splits); where the data launcher takes a ``reductions`` counter,
the float values the data kernel added into grad x by global reductions
per image, counted on the device.

``--root DIR`` times the package of the checkout in DIR instead of this
one (its kernels built into DIR/build), with this checkout's
``chip_smoke.py``. ``--against DIR`` compares two checkouts on one card
(``tools/_turns``): it runs this script on DIR, on this checkout, on
this checkout again and on DIR (in that order, one process each; DIR a
gitignored directory holding an unpacked ``git archive <parent>
centertrack_tpu_torch``) and prints one JSON object: per (dtype, kernel,
case) both sides' per-image device ms, the best of each side's two runs
and parent / change.

Without a GPU it exits with an error.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

from centertrack_tpu_torch.tools import _turns


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-box-min", type=int, nargs="+", default=None)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--kernel", choices=("data", "weight", "both"),
                    default="both")
    ap.add_argument("--root", default=_turns.ROOT,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--against", default=None,
                    help="checkout to compare with, run in turns")
    args = ap.parse_args(argv)
    if args.against:
        print(json.dumps(compare(os.path.abspath(args.against), _turns.ROOT,
                                 args.kernel)))
        return 0
    _turns.use_root(args.root)
    import torch
    from centertrack_tpu_torch.ops import dcn
    if not torch.cuda.is_available():
        raise SystemExit("exact_bwd_times: needs an NVIDIA GPU")
    smoke = _turns.smoke()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": os.path.abspath(args.root),
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    mins = args.data_box_min or [dcn.EXACT_DATA_BOX_MIN]
    kinds = ("data", "weight") if args.kernel == "both" else (args.kernel,)
    with smoke.full_float32("float32"):
        trained = smoke.trained_exact_inputs()
        for dtype in ("float32", "bfloat16"):
            cases = _cases(smoke, torch, trained["dcn", dtype], dtype)
            planners = ((dcn.exact_bwd_data_bf16_plan,
                         dcn.exact_bwd_weight_bf16_plan)
                        if dtype == "bfloat16" else
                        (dcn.exact_bwd_data_fp32_plan,
                         dcn.exact_bwd_weight_fp32_plan))
            for rep in range(args.reps):
                for kind in kinds:
                    for value in (mins if kind == "data" else [None]):
                        if value is not None:
                            dcn.EXACT_DATA_BOX_MIN = value
                            planners[0].cache_clear()
                        print(json.dumps(_run(smoke, dcn, torch, kind,
                                              planners, cases, rep == 0,
                                              dtype, value, rep)),
                              flush=True)
    return 0


def _cases(smoke, torch, nodes, dtype):
    """case -> (batch, [(launch inputs, output grad, launches an image)])
    for the three kinds of inputs, each with a seeded output grad."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    tdt = getattr(torch, dtype)

    def grad(x, cout):
        return torch.randn(*x.shape[:3], cout, generator=gen,
                           device="cuda").to(tdt)
    trained = [(a, grad(a[0], a[3].shape[3]), 1) for a in nodes]
    b6 = [(a, grad(a[0], a[3].shape[3]), 1) for a in (
        smoke._batched(n, smoke.EXACT_BATCH) for n in nodes)]
    n3 = []
    for _, h, w, cin, cout, per, _ in smoke.NECK_SHAPES:
        x, _, mask, weight, bias, _ = smoke.dcn_inputs(gen, 1, h, w, cin,
                                                       cout, 1, tdt)
        off = smoke.exact_offsets(gen, 1, h, w, 3.0, tdt)
        n3.append(((x, off, mask, weight, bias), grad(x, cout), per))
    return {"trained": (1, trained), "trained_b6": (smoke.EXACT_BATCH, b6),
            "n3": (1, n3)}


def _run(smoke, dcn, torch, kind, planners, cases, check, dtype, value, rep):
    low = dtype == "bfloat16"
    data, weight = (getattr(dcn, f) for f in smoke.EXACT_BWD_LAUNCHERS[dtype])
    counted = "reductions" in inspect.signature(data).parameters
    out = {"dtype": dtype, "kernel": kind, "data_box_min": value, "rep": rep,
           "cases": {}}
    for case, (batch, launches) in cases.items():
        total, routes, shapes, reductions = 0.0, [0, 0], {}, 0.0
        for (x, off, mask, w, _), g, per in launches:
            cout = w.shape[3]
            counts = torch.zeros(2, dtype=torch.int32, device="cuda")
            if kind == "data":
                red = torch.zeros(1, dtype=torch.int64, device="cuda")
                got = data(x, off, mask, w, g, counts,
                           **({"reductions": red} if counted else {}))[:3]
                reductions += int(red) * per / batch
                call = lambda: data(x, off, mask, w, g)
            else:
                got = (weight(x, off, mask, g, cout, counts),)
                call = lambda: weight(x, off, mask, g, cout)
            routes = [routes[0] + int(counts[0]) * per,
                      routes[1] + int(counts[1]) * per]
            if check and case == "trained":
                ref = smoke._exact_grad_ref(x, off, mask, w, g)
                ref = ref[:3] if kind == "data" else ref[3:]
                for a, r in zip(got, ref):
                    scale = r.float().abs().max().item()
                    err = (a.float() - r.float()).abs().max().item()
                    if err > (2e-2 if low else smoke.GRAD_REL_TOL) * scale:
                        raise RuntimeError(
                            f"{kind} {dtype} {tuple(x.shape)} -> {cout}: "
                            f"max abs err {err} of {scale}")
            ms = smoke.queued_us(call, 20) / 1e3
            total += ms * per / batch
            plan = planners[0 if kind == "data" else 1](*x.shape, cout)
            shapes[f"{x.shape[1]}x{x.shape[2]} {x.shape[3]}->{cout}"] = {
                "device_ms": ms, "chunk": plan["chunk"],
                **{k: plan[k] for k in ("tile", "taps", "window_slots")
                   if k in plan},
                "box_capacity": plan["box_capacity"],
                "resident": plan["resident"], "splits": plan["splits"]}
        out["cases"][case] = {"device_ms_per_image": total,
                              "window_tiles": routes[0],
                              "gather_tiles": routes[1], "shapes": shapes}
        if kind == "data" and counted:
            out["cases"][case]["reductions_per_image"] = reductions
    return out


def _side(root: str, kernel: str) -> list:
    lines = _turns.run("exact_bwd_times", root, "--kernel", kernel)
    return [r for r in lines if "root" in r][:1] + [r for r in lines
                                                   if "cases" in r]


def compare(parent: str, change: str, kernel: str = "both") -> dict:
    """Both checkouts in the order parent, change, change, parent; per
    (dtype, kernel, case) each side's per-image device ms and parent /
    change of the best of each side's two runs."""
    runs = _turns.in_turns(lambda root: _side(root, kernel), parent, change)
    rows = {}
    for side, run in runs:
        for r in run[1:]:
            for case, c in r["cases"].items():
                row = rows.setdefault(f"{r['kernel']} {r['dtype']} {case}",
                                      {})
                row.setdefault(side + "_ms", []).append(
                    c["device_ms_per_image"])
                row.setdefault(side + "_routes", [c["window_tiles"],
                                                  c["gather_tiles"]])
                row.setdefault(side + "_shapes", []).append(c["shapes"])
                if "reductions_per_image" in c:
                    row[side + "_reductions_per_image"] = c[
                        "reductions_per_image"]
    for row in rows.values():
        row["speedup"] = min(row["parent_ms"]) / min(row["change_ms"])
    return {"parent": parent, "change": change,
            "device": runs[0][1][0]["device"],
            "nvidia_smi": [run[0]["nvidia_smi"] for _, run in runs],
            "order": list(_turns.ORDER), "rows": rows}


if __name__ == "__main__":
    sys.exit(main())
