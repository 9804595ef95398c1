"""What the train-mode BatchNorm formula costs, on one GPU.

The port's ``models/layers.BatchNorm`` trains with flax's formula in
plain PyTorch (E[x^2] - E[x]^2, autograd), the JAX package's BatchNorm.
This script holds it against ``nn.BatchNorm2d``'s fused op, swapped in
for every BatchNorm layer, on the DLA-34 ``dcn_local1`` training step
of the committed checkpoint:

  time      ms per Adam step at B=``--batch`` and 544x960 (DCN kernels),
            medians of ``--steps`` CUDA-synchronised steps per variant,
            run in the order formula, fused, fused, formula
  accuracy  every parameter gradient of one step at B=2 in float32 with
            each variant, against the same step in float64 (the plain
            DCN throughout, so that only the BatchNorm and the dtype
            differ): relative L2 over all gradients and the worst leaf

Run from the root of a checkout:

    python3 -m centertrack_tpu_torch.tools.bn_cost [--steps N]
        [--batch B] [--size H W] [--device cuda|cpu]

It prints one JSON line per measurement. ``--device cpu`` (small
``--size``) runs the same code on the CPU, without the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn as nn

from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.data.render import render_batch
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models import layers
from centertrack_tpu_torch.models.model import (create_model,
                                                params_from_jax,
                                                set_dcn_plain)
from centertrack_tpu_torch.ops.losses import generic_loss
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
LR = 1.25e-4


@contextlib.contextmanager
def fused_batchnorm():
    """Every port BatchNorm runs ``nn.BatchNorm2d.forward`` meanwhile."""
    formula = layers.BatchNorm.forward
    layers.BatchNorm.forward = nn.BatchNorm2d.forward
    try:
        yield
    finally:
        layers.BatchNorm.forward = formula


def _cfg(h, w, b):
    class Meta:
        num_categories = 1
        default_resolution = [h, w]
    return set_heads(parse_task(Config(
        task="tracking", pre_hm=True, dla_node="dcn_local1", batch_size=b,
        lr=LR)), Meta)


def synthetic_batch(cfg, b, m=8, seed=0):
    """A descriptor batch with seeded images and ``m`` live objects per
    image (the time of a step does not depend on the targets)."""
    rng = np.random.RandomState(seed)
    h, w, oh, ow = cfg.input_h, cfg.input_w, cfg.output_h, cfg.output_w
    cts = np.stack([rng.randint(1, ow - 1, (b, m)),
                    rng.randint(1, oh - 1, (b, m))], -1).astype(np.int32)
    ones2 = np.ones((b, m, 2), np.float32)
    return {
        "image": rng.randn(b, h, w, 3).astype(np.float32),
        "pre_img": rng.randn(b, h, w, 3).astype(np.float32),
        "ind": (cts[..., 1] * ow + cts[..., 0]).astype(np.int64),
        "cat": np.zeros((b, m), np.int64),
        "mask": np.ones((b, m), np.float32),
        "hm_cts": cts, "hm_radii": rng.randint(1, 4, (b, m)).astype(
            np.int32),
        "hm_valid": np.ones((b, m), bool),
        "ignore_boxes": np.zeros((b, 1, 4), np.float32),
        "ignore_cat": np.zeros((b, 1), np.int32),
        "ignore_valid": np.zeros((b, 1), bool),
        "pre_cts_int": (cts * cfg.down_ratio).astype(np.int32),
        "pre_radii": rng.randint(2, 8, (b, m)).astype(np.int32),
        "pre_ks": np.ones((b, m), np.float32),
        "pre_valid": np.ones((b, m), bool),
        "reg": rng.rand(b, m, 2).astype(np.float32), "reg_mask": ones2,
        "wh": rng.uniform(2, 12, (b, m, 2)).astype(np.float32),
        "wh_mask": ones2,
        "tracking": rng.randn(b, m, 2).astype(np.float32),
        "tracking_mask": ones2,
    }


def _model(cfg, ckpt, device, dtype=torch.float32, plain=False):
    model = create_model(cfg, device)
    model.load_state_dict(params_from_jax(*ckpt), strict=True)
    set_dcn_plain(model, plain)
    return model.to(dtype)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_steps(cfg, ckpt, batch, device, steps, warmup=2):
    """Median ms per ``Trainer.train_step`` after ``warmup`` steps."""
    trainer = Trainer(cfg, _model(cfg, ckpt, device), device)
    times = []
    for i in range(warmup + steps):
        t = time.perf_counter()
        trainer.train_step(batch, LR)
        _sync(device)
        if i >= warmup:
            times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def step_grads(cfg, ckpt, batch, device, dtype):
    """Every parameter gradient of one train-mode step in ``dtype``,
    with the plain DCN."""
    model = _model(cfg, ckpt, device, dtype, plain=True).train()
    rendered = render_batch({k: torch.as_tensor(v).to(device)
                             for k, v in batch.items()}, cfg)
    rendered = {k: v.to(dtype) if torch.is_floating_point(v) else v
                for k, v in rendered.items()}
    out = model(rendered["image"], rendered["pre_img"], rendered["pre_hm"])
    total, _ = generic_loss(out, rendered, cfg.heads_dict, cfg.weights_dict)
    total.backward()
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(total.detach()), grads


def grad_error(got, ref):
    """Relative L2 over all gradients and the worst leaf's max error over
    its max (leaves below 1e-6 of the largest gradient are skipped)."""
    num = sum(((got[n] - g) ** 2).sum().item() for n, g in ref.items())
    den = sum((g ** 2).sum().item() for g in ref.values())
    gmax = max(g.abs().max().item() for g in ref.values())
    worst = {n: ((got[n] - g).abs().max() / g.abs().max()).item()
             for n, g in ref.items() if g.abs().max().item() > 1e-6 * gmax}
    leaf = max(worst, key=worst.get)
    return {"rel_l2": (num / den) ** 0.5, "worst_leaf": leaf,
            "worst_leaf_rel": worst[leaf]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=[544, 960])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bn_cost: no GPU; pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
    else:
        smi = "cpu"
    ckpt = load_jax_ckpt(CKPT)
    h, w = args.size
    cfg = _cfg(h, w, args.batch)
    batch = synthetic_batch(cfg, args.batch)
    ms = {"formula": [], "fused": []}
    for variant in ("formula", "fused", "fused", "formula"):
        with (fused_batchnorm() if variant == "fused"
              else contextlib.nullcontext()):
            ms[variant].append(time_steps(cfg, ckpt, batch, device,
                                          args.steps))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"measure": "time", "device": smi, "input": [h, w],
                      "batch": args.batch, "steps": args.steps,
                      "ms_per_step": ms}), flush=True)

    cfg2 = _cfg(h, w, 2)
    batch2 = synthetic_batch(cfg2, 2, seed=1)
    loss64, ref = step_grads(cfg2, ckpt, batch2, device, torch.float64)
    row = {"measure": "accuracy", "device": smi, "input": [h, w],
           "batch": 2, "loss_f64": loss64}
    for variant in ("formula", "fused"):
        with (fused_batchnorm() if variant == "fused"
              else contextlib.nullcontext()):
            loss, got = step_grads(cfg2, ckpt, batch2, device,
                                   torch.float32)
        row[variant] = {"loss_rel": abs(loss - loss64) / abs(loss64),
                        **grad_error(got, ref)}
    print(json.dumps(row), flush=True)
    return ms, row


if __name__ == "__main__":
    main()
