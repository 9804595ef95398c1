"""GT heatmap rendering from the compact splat descriptors of a batch
(JAX: centertrack_tpu/data/render.py; reference:
generic_dataset.py:205-255, 386-398, 423-515).

The dataset emits fixed-capacity descriptor arrays (centers, radii,
validity, ignore boxes) instead of dense maps; the train step renders
'hm' and 'pre_hm' from them on the device.
"""

from __future__ import annotations

from typing import Dict

import torch

from centertrack_tpu_torch.ops.gaussian import render_gaussians, render_pre_hm


def _apply_ignore_regions(hm: torch.Tensor, boxes: torch.Tensor,
                          cats: torch.Tensor, valid: torch.Tensor,
                          ignore_val: float = 1.0) -> torch.Tensor:
    """Raise the (H, W, C) map to ``ignore_val`` inside each valid box
    (K, 4) (x1, y1, x2, y2): all channels where its cat is -1, else that
    class's channel. Boxes cover the reference's integer slice
    hm[:, int(y1):int(y2)+1, int(x1):int(x2)+1]
    (generic_dataset.py:386-398), with floor for int as in the JAX
    package."""
    h, w, c = hm.shape
    dev = hm.device
    # each (K, 1, 1, 1), against (1, H, 1, 1) rows, (1, 1, W, 1) columns
    # and (1, 1, 1, C) channels
    x1, y1, x2, y2 = torch.floor(boxes).to(torch.int32)[
        :, :, None, None, None].unbind(1)
    ys = torch.arange(h, device=dev)[None, :, None, None]
    xs = torch.arange(w, device=dev)[None, None, :, None]
    cs = torch.arange(c, device=dev)[None, None, None, :]
    cat = cats.long()[:, None, None, None]
    hit = ((ys >= y1) & (ys <= y2) & (xs >= x1) & (xs <= x2) &
           ((cat < 0) | (cs == cat)) &
           valid.bool()[:, None, None, None]).any(dim=0)
    return torch.where(hit, hm.clamp(min=ignore_val), hm)


def render_single(sample: Dict[str, torch.Tensor], output_h: int,
                  output_w: int, num_classes: int, input_h: int,
                  input_w: int, with_pre_hm: bool) -> Dict[str, torch.Tensor]:
    """'hm' (output_h, output_w, C) and, with ``with_pre_hm``, 'pre_hm'
    (input_h, input_w, 1) of ONE sample."""
    hm = render_gaussians(
        output_h, output_w, num_classes, sample["hm_cts"],
        sample["hm_radii"], sample["cat"],
        torch.ones_like(sample["hm_radii"], dtype=torch.float32),
        sample["hm_valid"])
    out = {"hm": _apply_ignore_regions(hm, sample["ignore_boxes"],
                                       sample["ignore_cat"],
                                       sample["ignore_valid"])}
    if with_pre_hm and "pre_cts_int" in sample:
        out["pre_hm"] = render_pre_hm(
            input_h, input_w, sample["pre_cts_int"][None],
            sample["pre_radii"][None], sample["pre_ks"][None],
            sample["pre_valid"][None])[0]
    return out


def render_batch(batch: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The batch dict with 'hm' (B, oh, ow, C) and, when ``cfg.pre_hm``,
    'pre_hm' (B, H, W, 1) rendered per sample and stacked."""
    if "hm_hp" in cfg.heads_dict:
        raise NotImplementedError(
            "the hm_hp target (pose) is not ported yet (ROADMAP: pose "
            "extras)")
    n = batch["hm_cts"].shape[0]
    rendered = [render_single({k: v[i] for k, v in batch.items()},
                              cfg.output_h, cfg.output_w, cfg.num_classes,
                              cfg.input_h, cfg.input_w, cfg.pre_hm)
                for i in range(n)]
    merged = dict(batch)
    for key in rendered[0]:
        merged[key] = torch.stack([r[key] for r in rendered])
    return merged
