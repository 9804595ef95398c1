"""Training runtime (reference: src/lib/trainer.py + src/main.py;
JAX: centertrack_tpu/engine/trainer.py, without the device mesh).

One optimisation step:
  render GT heatmaps from splat descriptors (data/render.py)
  -> forward in train mode (BatchNorm statistics advance)
  -> generic_loss (ops/losses.py)
  -> backward (the DCN layers' backward runs in the hand-written
     kernels on the card)
  -> Adam / SGD update.

At ``compute_dtype="bfloat16"`` the network computes in bf16 (its DCN
layers through the bf16 kernels, forward and backward) while the
parameters, their gradients, the optimizer state, the head maps, the
rendered targets and the losses stay float32, as the JAX Trainer's
step at bf16 keeps them: each layer's cast of a float32 parameter to
bf16 passes the gradient back as float32.

The batch is the descriptor dict that the JAX package's GenericDataset
emits (numpy arrays or tensors with a leading batch dimension: image,
pre_img, ind, cat, mask, hm_cts, hm_radii, hm_valid, ignore_*, pre_*,
and per-head targets and masks).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from centertrack_tpu_torch.data.render import render_batch
from centertrack_tpu_torch.ops.losses import generic_loss

# the loss heads in the order the reference logs them
LOSS_ORDER = ["hm", "wh", "reg", "ltrb", "hps", "hm_hp", "hp_offset", "dep",
              "dim", "rot", "amodel_offset", "ltrb_amodal", "tracking",
              "nuscenes_att", "velocity"]


def make_lr_schedule(cfg):
    """Step decay x0.1 at each epoch in lr_step
    (reference: main.py:92-96). Returns epoch -> lr."""
    def lr_for_epoch(epoch: int) -> float:
        lr = cfg.lr
        for e in cfg.lr_step:
            if epoch >= e:
                lr *= 0.1
        return lr
    return lr_for_epoch


def make_optimizer(cfg, params) -> torch.optim.Optimizer:
    """(reference: main.py:17-26) Adam with optax's and torch's common
    defaults, betas (0.9, 0.999) and eps 1e-8 added outside the square
    root; or SGD with momentum 0.9."""
    if cfg.optim == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if cfg.optim == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {cfg.optim!r}")


class Trainer:
    """Trains ``model`` (a CenterTrackNet) in place on ``device``
    (reference: trainer.py:102-317).

    ``train_step`` leaves the step's gradients in ``param.grad`` until
    the next step.
    """

    def __init__(self, cfg, model, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for but no GPU is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self.cfg = cfg
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.lr_for_epoch = make_lr_schedule(cfg)
        self.accum = max(1, int(cfg.grad_accum))
        self.loss_order = [k for k in LOSS_ORDER if k in cfg.heads_dict]

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def _forward_loss(self, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        rendered = render_batch(batch, cfg)
        pre_img = rendered.get("pre_img") if cfg.pre_img else None
        pre_hm = rendered.get("pre_hm") if cfg.pre_hm else None
        outputs = self.model(rendered["image"], pre_img, pre_hm)
        return generic_loss(outputs, rendered, cfg.heads_dict,
                            cfg.weights_dict)

    def train_step(self, batch, lr: float) -> Dict[str, torch.Tensor]:
        """One optimiser step over ``batch`` (split into ``grad_accum``
        micro-batches). Returns the per-head losses (device scalars,
        averaged over the micro-batches)."""
        batch = self._to_device(batch)
        n = batch["image"].shape[0]
        if n % self.accum:
            raise ValueError(f"batch leading dim {n} not divisible by "
                             f"grad_accum {self.accum}")
        m = n // self.accum
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        agg = None
        for i in range(self.accum):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            total, losses = self._forward_loss(micro)
            # fp32 grads accumulate sum_i grad_i / accum in param.grad;
            # BN statistics chain through the micro-batches
            (total / self.accum).backward()
            losses = {k: torch.as_tensor(v).detach()
                      for k, v in losses.items()}
            agg = losses if agg is None else {k: agg[k] + losses[k]
                                              for k in agg}
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return {k: v / self.accum for k, v in agg.items()}

    @torch.no_grad()
    def val_step(self, batch) -> Dict[str, torch.Tensor]:
        """Losses of ``batch`` in eval mode (running statistics)."""
        self.model.eval()
        _, losses = self._forward_loss(self._to_device(batch))
        return {k: torch.as_tensor(v) for k, v in losses.items()}

    def run_epoch(self, phase: str, epoch: int, loader, num_iters: int = -1,
                  log_every: int = 20):
        """One pass of ``loader`` in phase 'train' or 'val'; returns the
        mean of each loss and the minutes taken."""
        lr = self.lr_for_epoch(epoch)
        agg: Dict[str, float] = {}
        n = 0
        t0 = t_prev = time.time()
        data_t = step_t = 0.0
        for it, batch in enumerate(loader):
            if 0 < num_iters <= it:
                break
            data_t += time.time() - t_prev
            ts = time.time()
            losses = (self.train_step(batch, lr) if phase == "train"
                      else self.val_step(batch))
            losses = {k: float(v) for k, v in losses.items()}
            step_t += time.time() - ts
            for k, v in losses.items():
                agg[k] = agg.get(k, 0.0) + v
            n += 1
            if log_every and it % log_every == 0:
                msg = f"{phase} e{epoch} it{it}"
                for k in ["tot"] + self.loss_order:
                    if k in losses:
                        msg += f" | {k} {agg[k] / n:.4f}"
                msg += f" | data {data_t / n:.3f}s step {step_t / n:.3f}s"
                print(msg)
            t_prev = time.time()
        ret = {k: v / max(n, 1) for k, v in agg.items()}
        ret["time"] = (time.time() - t0) / 60.0
        return ret

    def train(self, epoch: int, loader, num_iters: int = -1,
              log_every: int = 20):
        return self.run_epoch("train", epoch, loader, num_iters, log_every)

    def val(self, epoch: int, loader, num_iters: int = -1,
            log_every: int = 20):
        return self.run_epoch("val", epoch, loader, num_iters, log_every)
