"""Fused detection + tracking step, the port's main serving path
(JAX: centertrack_tpu/engine/fused.py:127-355, 405-476).

Per frame, on the device:

  uint8 frame -> separable affine warp + normalize
              -> pre_hm rendered from the device track state
              -> DLA-34 + DLAUp/IDAUp neck (clamped-DCN nodes) + heads
              -> sigmoid + top-K decode
              -> inverse affine to image coordinates
              -> greedy association (engine/device_tracker.py)
              -> one packed (K, 13) float32 result row

The track state and the previous frame's input stay on the device; the
host reads back two counts per frame (live tracks for the pre_hm render,
detections above threshold for the association loop) and whatever
``fetch`` asks for. Private-detection 2D tracking only.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from centertrack_tpu_torch.engine import device_tracker as dt
from centertrack_tpu_torch.models.model import (create_model,
                                                params_from_jax,
                                                set_dcn_plain)
from centertrack_tpu_torch.ops.affine import (get_affine_transform,
                                              invert_affine)
from centertrack_tpu_torch.ops.decode import generic_decode, sigmoid_output
from centertrack_tpu_torch.ops.gaussian import gaussian_radius, render_pre_hm
from centertrack_tpu_torch.ops.warp import (preprocess_frame,
                                            warp_precision_for)


def _affine_pts(pts: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 2) points through a 2x3 affine."""
    return pts @ m[:, :2].T + m[:, 2]


class FusedDetector:
    """``run(frame)`` enqueues one frame and returns its packed (K, 13)
    result on the device; ``fetch`` turns that into the host dict list.

    ``params``/``batch_stats`` are the JAX package's trees (as read by
    utils.checkpoint.load_jax_ckpt). ``plain_dcn=True`` runs the DCN
    layers through their plain PyTorch version instead of the kernel.

    ``cfg.compute_dtype`` sets the network's dtype. Everything around it
    runs as in the JAX ``one_frame``: the warp at
    ``warp_precision_for(cfg)``, the float32 input and pre_hm cast to
    the compute dtype by the network, float32 head maps (bf16-quantised
    at bf16), so the decode, the thresholds, the track state and the
    packed row are float32 at either dtype.
    """

    def __init__(self, cfg, params, batch_stats, dataset_meta,
                 device="cuda", plain_dcn: bool = False):
        if not cfg.tracking:
            raise ValueError("FusedDetector is for tracking tasks")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = create_model(cfg, self.device)
        self.model.load_state_dict(params_from_jax(params, batch_stats),
                                   strict=True)
        set_dcn_plain(self.model, plain_dcn)
        self.mean = torch.as_tensor(
            np.asarray(dataset_meta.mean, np.float32).reshape(3),
            device=self.device)
        self.std = torch.as_tensor(
            np.asarray(dataset_meta.std, np.float32).reshape(3),
            device=self.device)
        self.warp_precision = warp_precision_for(cfg)
        self.capacity = cfg.max_tracks
        self._trans = {}
        self.reset_tracking()

    def reset_tracking(self):
        self.track_state = dt.init_state(self.capacity, self.device)
        self.pre_images = None

    def _transforms(self, height, width):
        """Device copies of (inv_trans_input, trans_input,
        inv_trans_output) for a frame size, built once per size."""
        key = (height, width)
        cached = self._trans.get(key)
        if cached is not None:
            return cached
        cfg = self.cfg
        c = np.array([width / 2.0, height / 2.0], np.float32)
        s = max(height, width) * 1.0
        trans_input = get_affine_transform(c, s, 0, [cfg.input_w,
                                                     cfg.input_h])
        inv_trans_input = invert_affine(trans_input)
        out_w = cfg.input_w // cfg.down_ratio
        out_h = cfg.input_h // cfg.down_ratio
        inv_trans_output = get_affine_transform(c, s, 0, [out_w, out_h],
                                                inv=1)
        cached = tuple(
            torch.as_tensor(m.astype(np.float32), device=self.device)
            for m in (inv_trans_input, trans_input, inv_trans_output))
        self._trans[key] = cached
        return cached

    def _pre_hm(self, state, trans_input):
        cfg = self.cfg
        use_track = (state.valid & (state.active > 0) &
                     (state.scores >= cfg.pre_thresh))
        tl = _affine_pts(state.bboxes[:, 0:2], trans_input)
        br = _affine_pts(state.bboxes[:, 2:4], trans_input)
        x1 = tl[:, 0].clamp(0, cfg.input_w - 1)
        y1 = tl[:, 1].clamp(0, cfg.input_h - 1)
        x2 = br[:, 0].clamp(0, cfg.input_w - 1)
        y2 = br[:, 1].clamp(0, cfg.input_h - 1)
        h = y2 - y1
        w = x2 - x1
        use_track = use_track & (h > 0) & (w > 0)
        radius = torch.floor(gaussian_radius(torch.ceil(h), torch.ceil(w))
                             ).clamp(min=0).to(torch.int32)
        cts = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2], dim=1)
        return render_pre_hm(cfg.input_h, cfg.input_w, cts.to(torch.int32),
                             radius,
                             torch.ones_like(radius, dtype=torch.float32),
                             use_track)[None]

    @torch.no_grad()
    def run(self, image) -> torch.Tensor:
        """Enqueue one uint8 (H, W, 3) frame (numpy or tensor); returns
        the packed (K, 13) float32 result on the device."""
        cfg = self.cfg
        height, width = image.shape[:2]
        inv_trans_input, trans_input, inv_trans_output = \
            self._transforms(height, width)
        frame = torch.as_tensor(image).to(self.device)
        images = preprocess_frame(frame, inv_trans_input, cfg.input_h,
                                  cfg.input_w, self.mean, self.std,
                                  self.warp_precision)
        if self.pre_images is None:
            self.pre_images = images
        state = self.track_state
        pre_hm = self._pre_hm(state, trans_input)

        out = self.model(images, self.pre_images if cfg.pre_img else None,
                         pre_hm if cfg.pre_hm else None)[-1]
        dets = generic_decode(sigmoid_output(out), cfg.K, cfg.num_classes)

        # output grid -> image coordinates
        scores = dets["scores"][0]
        clses = dets["clses"][0].to(torch.int32) + 1
        cts_out = dets["cts"][0]
        cts_img = _affine_pts(cts_out, inv_trans_output)
        tracking_img = _affine_pts(dets["tracking"][0] + cts_out,
                                   inv_trans_output) - cts_img
        bb = dets["bboxes"][0]
        bboxes_img = torch.cat([_affine_pts(bb[:, 0:2], inv_trans_output),
                                _affine_pts(bb[:, 2:4], inv_trans_output)],
                               dim=1)

        self.track_state, assoc = dt.step(
            state, scores, clses, cts_img, tracking_img, bboxes_img,
            cfg.out_thresh, cfg.new_thresh, cfg.max_age)
        self.pre_images = images
        return _pack_results(scores, clses, cts_img, tracking_img,
                             bboxes_img, assoc)

    @staticmethod
    def fetch(results: torch.Tensor, out_thresh: float) -> List[Dict]:
        """The packed rows as the host dict list (one device->host copy)."""
        return _fetch_one(results.cpu().numpy(), out_thresh)


# Packed per-candidate row (fp32): [score, class, ct_x, ct_y, track_dx,
# track_dy, x1, y1, x2, y2, tracking_id, age, active]. fp32 holds ids,
# ages and classes exactly up to 2^24.
def _pack_results(scores, clses, cts_img, tracking_img, bboxes_img, assoc):
    def f32(a):
        return a.to(torch.float32)[..., None]
    return torch.cat(
        [scores[..., None], f32(clses), cts_img, tracking_img, bboxes_img,
         f32(assoc["tracking_id"]), f32(assoc["age"]),
         f32(assoc["active"])], dim=-1)


def _fetch_one(packed: np.ndarray, out_thresh: float) -> List[Dict]:
    keep = packed[(packed[:, 0] > out_thresh) & (packed[:, 10] > 0)]
    return [{"score": float(row[0]), "class": int(row[1]), "ct": row[2:4],
             "tracking": row[4:6], "bbox": row[6:10],
             "tracking_id": int(row[10]), "age": int(row[11]),
             "active": int(row[12])} for row in keep]
