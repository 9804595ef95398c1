"""Device times of the exact DCNv2 backward kernels
(``dcn_exact_bwd_data[_bf16]``, ``dcn_exact_bwd_weight[_bf16]``,
csrc/dcn_exact_bwd.cu) on one NVIDIA GPU, per 544x960 image of a
training step at dla_node "dcn": the 16 neck launches at B=1, each on
its node's own inputs from one eager forward of the bench's first
synthetic frame on the exact-trained checkpoint
(``chip_smoke.trained_exact_inputs``), with a seeded output grad.

    python3 -m centertrack_tpu_torch.tools.exact_bwd_times
    python3 -m centertrack_tpu_torch.tools.exact_bwd_times \
        --data-box-min 320 128 --reps 2

Each launch's device time is ``chip_smoke.queued_us`` (median of 20
calls queued behind a spin kernel); each run first holds every launch's
gradients against autograd of the plain version (float32 within
``chip_smoke.GRAD_REL_TOL`` of max|plain|, bf16 within 2e-2) and counts
its routes. ``--data-box-min`` runs the data kernels' plans at each
value of ``ops/dcn.EXACT_DATA_BOX_MIN`` in turn (the smallest window
pixels a plan accepts, at two resident blocks where it fits); ``--reps``
repeats the sequence. One JSON line per (dtype, kernel, value, rep):
the per-image device ms, the window and gather tiles, and per neck shape
the device ms of its last node and its plan (chunk, capacity, resident
blocks, splits).

Without a GPU it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-box-min", type=int, nargs="+", default=None)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exact_bwd_times: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from centertrack_tpu_torch.ops import dcn

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smoke.phase_device()["nvidia_smi"]}),
          flush=True)
    mins = args.data_box_min or [dcn.EXACT_DATA_BOX_MIN]
    with smoke.full_float32("float32"):
        trained = smoke.trained_exact_inputs()
        gen = torch.Generator(device="cuda").manual_seed(3)
        for dtype in ("float32", "bfloat16"):
            low = dtype == "bfloat16"
            nodes = trained["dcn", dtype]
            grads = [torch.randn(*a[0].shape[:3], a[3].shape[3],
                                 generator=gen, device="cuda").to(a[0].dtype)
                     for a in nodes]
            data, weight = (getattr(dcn, f) for f in
                            smoke.EXACT_BWD_LAUNCHERS[dtype])
            planners = ((dcn.exact_bwd_data_bf16_plan,
                         dcn.exact_bwd_weight_bf16_plan) if low else
                        (dcn.exact_bwd_data_fp32_plan,
                         dcn.exact_bwd_weight_fp32_plan))
            for rep in range(args.reps):
                for kind in ("data", "weight"):
                    for value in (mins if kind == "data" else [None]):
                        if value is not None:
                            dcn.EXACT_DATA_BOX_MIN = value
                            planners[0].cache_clear()
                        print(json.dumps(_run(smoke, dcn, kind, data, weight,
                                              planners, nodes, grads, low,
                                              rep == 0, dtype, value, rep)),
                              flush=True)
    return 0


def _run(smoke, dcn, kind, data, weight, planners, nodes, grads, low, check,
         dtype, value, rep):
    total, routes, shapes = 0.0, [0, 0], {}
    for (x, off, mask, w, _), g in zip(nodes, grads):
        cout = w.shape[3]
        counts = torch.zeros(2, dtype=torch.int32, device="cuda")
        if kind == "data":
            got = data(x, off, mask, w, g, counts)[:3]
            call = lambda: data(x, off, mask, w, g)
        else:
            got = (weight(x, off, mask, g, cout, counts),)
            call = lambda: weight(x, off, mask, g, cout)
        routes = [routes[0] + int(counts[0]), routes[1] + int(counts[1])]
        if check:
            ref = smoke._exact_grad_ref(x, off, mask, w, g)
            ref = ref[:3] if kind == "data" else ref[3:]
            for a, r in zip(got, ref):
                scale = r.float().abs().max().item()
                err = (a.float() - r.float()).abs().max().item()
                if err > (2e-2 if low else smoke.GRAD_REL_TOL) * scale:
                    raise RuntimeError(f"{kind} {dtype} {tuple(x.shape)} -> "
                                       f"{cout}: max abs err {err} of "
                                       f"{scale}")
        ms = smoke.queued_us(call, 20) / 1e3
        total += ms
        plan = planners[0 if kind == "data" else 1](*x.shape, cout)
        shapes[f"{x.shape[1]}x{x.shape[2]} {x.shape[3]}->{cout}"] = {
            "device_ms": ms, "chunk": plan["chunk"],
            "box_capacity": plan["box_capacity"],
            "resident": plan["resident"], "splits": plan["splits"]}
    return {"dtype": dtype, "kernel": kind, "data_box_min": value,
            "rep": rep, "device_ms_per_image": total,
            "window_tiles": routes[0], "gather_tiles": routes[1],
            "shapes": shapes}


if __name__ == "__main__":
    sys.exit(main())
