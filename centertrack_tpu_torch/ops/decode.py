"""Heatmap decode: max-pool pseudo-NMS -> top-K -> head gathers
(reference: src/lib/model/utils.py:52-87, src/lib/model/decode.py:83-182;
JAX: centertrack_tpu/ops/decode.py).

Maps are NHWC as in the JAX package. Flat peak indices are row-major
over H*W (ind = y*W + x). Every function runs in the dtype of the maps
it is given, as JAX's do (the network returns float32 maps, whose
values are bf16-quantised when it computes in bf16). Top-K breaks ties
as ``jax.lax.top_k`` does, the lower index first: quantised scores tie
often, and the order of the K rows drives the greedy association and
the track ids.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def nms_heat(heat: torch.Tensor) -> torch.Tensor:
    """Keep pixels equal to their 3x3 local max
    (reference: utils.py:52-58). heat: (B, H, W, C)."""
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, 1,
                        1).permute(0, 2, 3, 1)
    return heat * (hmax == heat).to(heat.dtype)


def gather_feat_nhwc(fmap: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, H, W, F) at flat indices (B, K) -> (B, K, F)
    (reference: utils.py:22-26)."""
    b, h, w, f = fmap.shape
    flat = fmap.reshape(b, h * w, f)
    return torch.gather(flat, 1, ind[:, :, None].expand(-1, -1, f))


def _top_k(x: torch.Tensor, k: int):
    """The k largest of the last axis, in descending order, ties to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises no
    order among ties on CUDA)."""
    values, inds = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], inds[..., :k]


def topk_channel(scores: torch.Tensor, k: int):
    """Per-channel top-K over the spatial plane (reference:
    utils.py:60-69). scores: (B, H, W, C) -> 4 x (B, C, K)."""
    b, h, w, c = scores.shape
    flat = scores.reshape(b, h * w, c).transpose(1, 2)
    topk_scores, topk_inds = _top_k(flat, k)
    topk_ys = torch.div(topk_inds, w, rounding_mode="floor").float()
    topk_xs = (topk_inds % w).float()
    return topk_scores, topk_inds, topk_ys, topk_xs


def topk(scores: torch.Tensor, k: int):
    """Two-stage top-K: per class over H*W, then over C*K
    (reference: utils.py:71-87). Returns (score, inds, clses, ys, xs),
    each (B, K); inds are flat spatial indices."""
    b, h, w, c = scores.shape
    topk_scores, topk_inds, topk_ys, topk_xs = topk_channel(scores, k)
    topk_score, topk_ind = _top_k(topk_scores.reshape(b, c * k), k)
    topk_clses = torch.div(topk_ind, k, rounding_mode="floor").int()

    def gather(x):
        return torch.gather(x.reshape(b, c * k), 1, topk_ind)

    return (topk_score, gather(topk_inds), topk_clses, gather(topk_ys),
            gather(topk_xs))


def generic_decode(output: Dict[str, torch.Tensor], k: int = 100,
                   num_classes: int = 1) -> Dict[str, torch.Tensor]:
    """NHWC tracking head maps (hm, and any of reg, wh, tracking) ->
    top-K detections, each (B, K, ...) (reference: decode.py:83-182;
    JAX ops/decode.py:145-192). Without ``reg`` the centre is the peak
    + 0.5; without ``wh`` there are no ``bboxes``; a ``wh`` of
    2 * num_classes channels (num_classes > 1) is read at each
    detection's class."""
    scores, inds, clses, ys0, xs0 = topk(nms_heat(output["hm"]), k)
    ret = {"scores": scores, "clses": clses.float(), "xs": xs0, "ys": ys0,
           "cts": torch.stack([xs0, ys0], dim=2), "inds": inds}
    if "reg" in output:
        reg = gather_feat_nhwc(output["reg"], inds)
        xs = xs0[:, :, None] + reg[:, :, 0:1]
        ys = ys0[:, :, None] + reg[:, :, 1:2]
    else:
        xs = xs0[:, :, None] + 0.5
        ys = ys0[:, :, None] + 0.5
    if "wh" in output:
        wh = gather_feat_nhwc(output["wh"], inds)
        b = wh.shape[0]
        if wh.shape[2] == 2 * num_classes and num_classes > 1:
            cats = clses.long()[:, :, None, None].expand(-1, -1, 1, 2)
            wh = torch.gather(wh.reshape(b, k, -1, 2), 2, cats)[:, :, 0]
        else:
            wh = wh.reshape(b, k, 2)
        wh = wh.clamp(min=0.0)
        ret["bboxes"] = torch.cat(
            [xs - wh[..., 0:1] / 2, ys - wh[..., 1:2] / 2,
             xs + wh[..., 0:1] / 2, ys + wh[..., 1:2] / 2], dim=2)
    if "tracking" in output:
        ret["tracking"] = gather_feat_nhwc(output["tracking"], inds)
    return ret


def sigmoid_output(output: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Sigmoid on the heatmap (reference: src/lib/detector.py:300-308)."""
    output = dict(output)
    output["hm"] = torch.sigmoid(output["hm"])
    return output
