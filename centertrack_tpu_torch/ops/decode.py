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


def _sides(fmap: torch.Tensor, inds, xs0, ys0) -> torch.Tensor:
    """(x1, y1, x2, y2) from a head of box sides at each peak, measured
    from the peak itself (no ``reg``)."""
    d = gather_feat_nhwc(fmap, inds)
    x0, y0 = xs0[:, :, None], ys0[:, :, None]
    return torch.cat([x0 + d[..., 0:1], y0 + d[..., 1:2],
                      x0 + d[..., 2:3], y0 + d[..., 3:4]], dim=2)


def _update_kps_with_hm(kps, output, num_joints: int, k: int, bboxes,
                        scores, thresh: float = 0.2):
    """Snap the regressed keypoints (B, K, 2J) to nearby hm_hp peaks,
    gated by each detection's box (reference: decode.py:11-81; JAX
    ops/decode.py:82-148): per joint the K strongest peaks, each
    keypoint's nearest one (the first of equal distances), kept where it
    scores ``thresh`` and lies in the box. Dense (B, J, K, K) distances;
    returns (kps, kps_score)."""
    if "hm_hp" not in output:
        return kps, kps
    hm_hp = nms_heat(output["hm_hp"])
    b = kps.shape[0]
    kps = kps.reshape(b, k, num_joints, 2).transpose(1, 2)   # B,J,K,2
    reg_kps = kps[:, :, :, None, :]
    hm_score, hm_inds, hm_ys, hm_xs = topk_channel(hm_hp, k)  # B,J,K
    hp_offset_map = output.get("hp_offset", output.get("reg"))
    if hp_offset_map is not None:
        hp_offset = gather_feat_nhwc(hp_offset_map, hm_inds.reshape(b, -1))
        hp_offset = hp_offset.reshape(b, num_joints, k, 2)
        hm_xs = hm_xs + hp_offset[..., 0]
        hm_ys = hm_ys + hp_offset[..., 1]
    else:
        hm_xs = hm_xs + 0.5
        hm_ys = hm_ys + 0.5

    mask = (hm_score > thresh).to(torch.float32)
    hm_score = (1 - mask) * -1 + mask * hm_score
    hm_ys = (1 - mask) * (-10000) + mask * hm_ys
    hm_xs = (1 - mask) * (-10000) + mask * hm_xs
    hm_kps = torch.stack([hm_xs, hm_ys], dim=-1)[:, :, None]  # B,J,1,K,2
    dist = torch.sqrt(((reg_kps - hm_kps) ** 2).sum(dim=4))   # B,J,K,K
    min_ind = dist.argmin(dim=3)                              # B,J,K
    hm_score = torch.gather(hm_score, 2, min_ind)[..., None]
    hm_kps = torch.gather(hm_kps[:, :, 0], 2,
                          min_ind[..., None].expand(-1, -1, -1, 2))
    mask = hm_score < thresh
    if bboxes is not None:
        l = bboxes[:, None, :, 0:1]
        t = bboxes[:, None, :, 1:2]
        r = bboxes[:, None, :, 2:3]
        bb = bboxes[:, None, :, 3:4]
    else:
        l = kps[..., 0:1].amin(dim=1, keepdim=True)
        t = kps[..., 1:2].amin(dim=1, keepdim=True)
        r = kps[..., 0:1].amax(dim=1, keepdim=True)
        bb = kps[..., 1:2].amax(dim=1, keepdim=True)
        margin = 0.25
        l = l - (r - l) * margin
        r = r + (r - l) * margin
        t = t - (bb - t) * margin
        bb = bb + (bb - t) * margin
    mask = ((hm_kps[..., 0:1] < l) | (hm_kps[..., 0:1] > r) |
            (hm_kps[..., 1:2] < t) | (hm_kps[..., 1:2] > bb) | mask)
    mask = mask.to(torch.float32)
    kps_score = (1 - mask) * hm_score + mask * scores[:, None, :, None]
    kps_score = scores * kps_score.mean(dim=1).reshape(b, k)
    mask2 = mask.repeat_interleave(2, dim=-1)
    kps = (1 - mask2) * hm_kps + mask2 * kps
    kps = kps.transpose(1, 2).reshape(b, k, num_joints * 2)
    return kps, kps_score


def generic_decode(output: Dict[str, torch.Tensor], k: int = 100,
                   num_classes: int = 1,
                   zero_tracking: bool = False) -> Dict[str, torch.Tensor]:
    """NHWC head maps (hm, and any of reg, wh, tracking, ltrb,
    ltrb_amodal, the ddd heads, the pose heads) -> top-K detections,
    each (B, K, ...) (reference: decode.py:83-182; JAX
    ops/decode.py:151-236). Without ``reg`` the centre is the peak +
    0.5; a ``wh`` of 2 * num_classes channels
    (num_classes > 1) is read at each detection's class. ``bboxes`` come
    from ``wh``, then from ``ltrb`` where the net has it, then from
    ``ltrb_amodal`` (also ``bboxes_amodal``), the last one present
    winning, as in JAX; without any of the three there are none.
    ``zero_tracking`` multiplies the tracking map by 0 first (JAX
    ops/decode.py:157-158). With ``hps`` the keypoints are snapped to
    the hm_hp peaks (``_update_kps_with_hm``) and scored
    (``kps_score``)."""
    if zero_tracking and "tracking" in output:
        output = dict(output)
        output["tracking"] = output["tracking"] * 0
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
    if "ltrb" in output:
        ret["bboxes"] = _sides(output["ltrb"], inds, xs0, ys0)
    for head in ("tracking", "dep", "rot", "dim", "amodel_offset",
                 "nuscenes_att", "velocity"):
        if head in output:
            ret[head] = gather_feat_nhwc(output[head], inds)
    if "ltrb_amodal" in output:
        ret["bboxes_amodal"] = _sides(output["ltrb_amodal"], inds, xs0, ys0)
        ret["bboxes"] = ret["bboxes_amodal"]
    if "hps" in output:
        kps = gather_feat_nhwc(output["hps"], inds)   # B,K,2J
        b = kps.shape[0]
        num_joints = kps.shape[2] // 2
        kps = (kps.reshape(b, k, num_joints, 2) +
               torch.stack([xs0, ys0], dim=-1)[:, :, None, :])
        ret["hps"], ret["kps_score"] = _update_kps_with_hm(
            kps.reshape(b, k, num_joints * 2), output, num_joints, k,
            ret.get("bboxes"), scores)
    return ret


def sigmoid_output(output: Dict[str, torch.Tensor],
                   depth_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Sigmoid on the heatmaps, and depth as 1 / sigmoid(x) - 1 times
    ``depth_scale`` (reference: src/lib/detector.py:300-308; JAX
    ops/decode.py:240-252)."""
    output = dict(output)
    output["hm"] = torch.sigmoid(output["hm"])
    if "hm_hp" in output:
        output["hm_hp"] = torch.sigmoid(output["hm_hp"])
    if "dep" in output:
        output["dep"] = (1.0 / (torch.sigmoid(output["dep"]) + 1e-6)
                         - 1.0) * depth_scale
    return output
