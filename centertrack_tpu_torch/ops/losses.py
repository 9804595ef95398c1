"""Training losses (reference: src/lib/model/losses.py,
src/lib/trainer.py:20-86; JAX: centertrack_tpu/ops/losses.py).

All losses take NHWC maps and fixed-capacity (B, M) target arrays, as
the JAX package's do. The reference's data-dependent branches (``if
num_pos == 0``) are ``torch.where`` selects, so no loss reads a value
back to the host.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from centertrack_tpu_torch.ops.decode import gather_feat_nhwc


def clamp_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid clamped to [1e-4, 1-1e-4]
    (reference: src/lib/model/utils.py:8-10)."""
    return torch.sigmoid(x).clamp(1e-4, 1 - 1e-4)


def _gather(fmap: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    return gather_feat_nhwc(fmap, ind.long())


def fast_focal_loss(out: torch.Tensor, target: torch.Tensor,
                    ind: torch.Tensor, mask: torch.Tensor,
                    cat: torch.Tensor) -> torch.Tensor:
    """CornerNet penalty-reduced focal loss, gathered-positives form
    (reference: losses.py:67-97). out, target: (B, H, W, C), ``out``
    already sigmoided and clamped; ind, mask, cat: (B, M)."""
    neg_weights = torch.pow(1.0 - target, 4)
    neg_loss = (torch.log(1.0 - out) * torch.pow(out, 2) * neg_weights).sum()
    pos_pred_pix = _gather(out, ind)                          # B, M, C
    pos_pred = torch.gather(pos_pred_pix, 2, cat.long()[:, :, None])
    num_pos = mask.sum()
    pos_loss = (torch.log(pos_pred) * torch.pow(1.0 - pos_pred, 2) *
                mask[:, :, None]).sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp(min=1.0))


def reg_weighted_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Masked L1 at GT indices (reference: losses.py:117-126).
    output: (B, H, W, F); mask, target: (B, M, F); ind: (B, M)."""
    pred = _gather(output, ind)
    loss = (pred * mask - target * mask).abs().sum()
    return loss / (mask.sum() + 1e-4)


def weighted_bce_loss(output: torch.Tensor, mask: torch.Tensor,
                      ind: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """Masked BCE-with-logits at GT indices (reference:
    losses.py:129-142), in the log(1 + exp(-|x|)) form."""
    pred = _gather(output, ind)
    bce = (pred.clamp(min=0) - pred * target +
           torch.log1p(torch.exp(-pred.abs())))
    return (mask * bce).sum() / (mask.sum() + 1e-4)


def _smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5)


def _masked_mean(values: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    cnt = sel.sum()
    return torch.where(cnt > 0, (values * sel).sum() / cnt.clamp(min=1.0),
                       torch.zeros_like(cnt))


def bin_rot_loss(output: torch.Tensor, mask: torch.Tensor,
                 ind: torch.Tensor, rotbin: torch.Tensor,
                 rotres: torch.Tensor) -> torch.Tensor:
    """2-bin orientation loss: bin cross-entropy + sin/cos residual
    smooth-L1 (reference: losses.py:144-192). output: (B, H, W, 8) as
    [bin1_cls0, bin1_cls1, bin1_sin, bin1_cos, bin2_cls0, bin2_cls1,
    bin2_sin, bin2_cos]; rotbin: (B, M, 2) int; rotres: (B, M, 2)."""
    pred = _gather(output, ind)
    b, m, _ = pred.shape
    pred = pred.reshape(b * m, 8)
    rotbin = rotbin.reshape(b * m, 2).long()
    rotres = rotres.reshape(b * m, 2)
    mask_f = mask.reshape(b * m, 1).float()

    def bin_ce(logits2, target):
        # logits zeroed outside the mask, then a mean over ALL rows
        # (reference compute_bin_loss, losses.py:156-159)
        return F.cross_entropy(logits2 * mask_f, target)

    loss_bin1 = bin_ce(pred[:, 0:2], rotbin[:, 0])
    loss_bin2 = bin_ce(pred[:, 4:6], rotbin[:, 1])
    sel1 = (rotbin[:, 0] != 0).float()
    sel2 = (rotbin[:, 1] != 0).float()
    loss_res = (
        _masked_mean(_smooth_l1(pred[:, 2] - torch.sin(rotres[:, 0])), sel1)
        + _masked_mean(_smooth_l1(pred[:, 3] - torch.cos(rotres[:, 0])),
                       sel1)
        + _masked_mean(_smooth_l1(pred[:, 6] - torch.sin(rotres[:, 1])),
                       sel2)
        + _masked_mean(_smooth_l1(pred[:, 7] - torch.cos(rotres[:, 1])),
                       sel2))
    return loss_bin1 + loss_bin2 + loss_res


# heads whose loss is a masked L1 at the GT indices
_L1_HEADS = ("reg", "wh", "tracking", "ltrb", "ltrb_amodal", "hps", "dep",
             "dim", "amodel_offset", "velocity")


def generic_loss(outputs, batch: Dict[str, torch.Tensor],
                 heads: Dict[str, int], weights: Dict[str, float],
                 num_stacks: int = 1, depth_scale_inv: bool = True):
    """Total multi-head loss (reference: src/lib/trainer.py:20-86).

    outputs: list of per-stack dicts of NHWC head maps (raw logits);
    batch: the targets ('hm', 'ind', 'mask', 'cat' and per-head target
    and mask arrays). Returns (total, dict of per-head losses + 'tot').
    """
    losses = {h: 0.0 for h in heads}
    for s in range(num_stacks):
        output = dict(outputs[s])
        if "hm" in output:
            output["hm"] = clamp_sigmoid(output["hm"])
        if "hm_hp" in output:
            output["hm_hp"] = clamp_sigmoid(output["hm_hp"])
        if "dep" in output and depth_scale_inv:
            output["dep"] = 1.0 / (torch.sigmoid(output["dep"]) + 1e-6) - 1.0

        if "hm" in output:
            losses["hm"] = losses["hm"] + fast_focal_loss(
                output["hm"], batch["hm"], batch["ind"], batch["mask"],
                batch["cat"]) / num_stacks
        for head in _L1_HEADS:
            if head in output:
                losses[head] = losses[head] + reg_weighted_l1_loss(
                    output[head], batch[head + "_mask"], batch["ind"],
                    batch[head]) / num_stacks
        if "hm_hp" in output:
            losses["hm_hp"] = losses["hm_hp"] + fast_focal_loss(
                output["hm_hp"], batch["hm_hp"], batch["hp_ind"],
                batch["hm_hp_mask"], batch["joint"]) / num_stacks
            if "hp_offset" in output:
                losses["hp_offset"] = losses["hp_offset"] + \
                    reg_weighted_l1_loss(
                        output["hp_offset"], batch["hp_offset_mask"],
                        batch["hp_ind"], batch["hp_offset"]) / num_stacks
        if "rot" in output:
            losses["rot"] = losses["rot"] + bin_rot_loss(
                output["rot"], batch["rot_mask"], batch["ind"],
                batch["rotbin"], batch["rotres"]) / num_stacks
        if "nuscenes_att" in output:
            losses["nuscenes_att"] = losses["nuscenes_att"] + \
                weighted_bce_loss(
                    output["nuscenes_att"], batch["nuscenes_att_mask"],
                    batch["ind"], batch["nuscenes_att"]) / num_stacks

    total = 0.0
    for head in heads:
        total = total + weights[head] * losses[head]
    losses["tot"] = total
    return total, losses
