"""Greedy IoU suppression of the decoded boxes (the ``--nms`` option;
JAX: centertrack_tpu/ops/nms.py), and its kernel ``nms_keep``
(``csrc/nms.cu``).

Given each image's score-sorted top-K boxes, a box is suppressed when its
IoU with a higher-scoring kept box passes the threshold; boxes of
different classes never suppress each other (``batched_nms`` shifts each
box by class * 1e4). JAX runs it as a K-step ``lax.fori_loop`` (XLA, no
``pl.pallas_call``) inside the host Detector's jitted step; the port
runs it as one hand-written kernel a frame, one block per image. On a
CUDA tensor the wrappers launch the kernel on the current stream (it
allocates nothing and nothing synchronises) or raise; on a CPU tensor
they take the plain version, in the same float32 operations and order as
JAX's, which is what the tests and the chip smoke hold the kernel
against, bit for bit.
"""

from __future__ import annotations

import struct
from typing import Optional

import torch

from centertrack_tpu_torch.ops import _build

# launches of the kernel in this process; read and reset by callers
LAUNCHES = {"nms_keep": 0}
# the kernel keeps one 32-row word of the keep mask a lane of one warp
NMS_MAX_K = 1024
IOU_THRESH = 0.5


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) x1y1x2y2 -> (..., K, K) IoU, JAX's operations in
    JAX's order: union = (area_i + area_j) - inter."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0.0) * (iy2 - iy1).clamp(min=0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-9),
                       torch.zeros_like(inter))


def _shifted(boxes, classes):
    if classes is None:
        return boxes
    return boxes + classes.to(torch.float32)[..., None] * 1e4


def nms_keep_plain(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: Optional[torch.Tensor] = None,
                   iou_thresh: float = IOU_THRESH) -> torch.Tensor:
    """The plain version of ``nms_keep``: (S, K, 4), (S, K) and optional
    (S, K) classes -> (S, K) bool, JAX's loop over the K rows (row i kept
    iff its score is above -inf and no kept row above it overlaps it past
    ``iou_thresh``), batched over the images."""
    iou = iou_matrix(_shifted(boxes, classes))
    k = boxes.shape[-2]
    keep = scores > float("-inf")
    above = torch.arange(k, device=boxes.device)
    for i in range(k):
        over = (iou[:, i] > iou_thresh) & keep & (above < i)
        keep[:, i] = ~over.any(dim=1) & keep[:, i]
    return keep


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: Optional[torch.Tensor] = None,
                iou_thresh: float = IOU_THRESH) -> torch.Tensor:
    """(S, K, 4) boxes, (S, K) scores and optional (S, K) classes ->
    (S, K) bool keep mask (JAX ``batched_nms``): one launch of the kernel
    for the batch on CUDA tensors, the plain version on CPU ones."""
    s, k = scores.shape
    if tuple(boxes.shape) != (s, k, 4) or (
            classes is not None and tuple(classes.shape) != (s, k)):
        raise ValueError(
            f"batched_nms: boxes {tuple(boxes.shape)} and classes "
            f"{None if classes is None else tuple(classes.shape)} do not "
            f"fit scores {(s, k)}")
    devices = {x.device for x in (boxes, scores, classes) if x is not None}
    if len(devices) != 1:
        raise ValueError(f"batched_nms: inputs on several devices {devices}")
    if scores.device.type != "cuda":
        return nms_keep_plain(boxes.float(), scores.float(),
                              None if classes is None else classes.float(),
                              iou_thresh)
    return launch_nms_keep(
        boxes.float().contiguous(), scores.float().contiguous(),
        None if classes is None else classes.float().contiguous(),
        iou_thresh)


def launch_nms_keep(boxes, scores, classes, iou_thresh):
    """``nms_keep`` (the kernel) on contiguous float32 CUDA tensors."""
    s, k = scores.shape
    if not 0 < k <= NMS_MAX_K:
        raise ValueError(f"nms_keep: K={k}; the kernel takes 1 to "
                         f"{NMS_MAX_K} boxes an image")
    keep = torch.empty((s, k), dtype=torch.bool, device=scores.device)
    bits = struct.unpack("<i", struct.pack("<f", iou_thresh))[0]
    fn = _build.launcher("nms", "nms_keep", 4, 3)
    rc = fn(boxes.data_ptr(), scores.data_ptr(),
            0 if classes is None else classes.data_ptr(), keep.data_ptr(),
            s, k, bits, torch.cuda.current_stream(scores.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms_keep launch failed: CUDA error {rc}")
    LAUNCHES["nms_keep"] += 1
    return keep


def nms_suppress_plain(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_thresh: float = IOU_THRESH) -> torch.Tensor:
    """One image's score-sorted (K, 4) boxes and (K,) scores -> (K,)
    keep mask (JAX ``nms_suppress``), the plain version on any device."""
    return nms_keep_plain(boxes[None], scores[None], None, iou_thresh)[0]
