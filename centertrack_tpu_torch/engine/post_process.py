"""Output-grid detections -> original-image coordinates, the host
Detector's post-process (reference: src/lib/utils/post_process.py:21-91;
JAX: centertrack_tpu/engine/post_process.py), in numpy. Batched array
work instead of a per-detection loop:

  1. count survivors — decode emits score-sorted rows, so the
     reference's early ``break`` at ``out_thresh`` is a prefix length;
  2. stack every 2-D point the heads produced (centers, tracking
     endpoints, bbox corners, keypoints, amodal centers) into ONE
     (P, 2) array and push it through the inverse affine once;
  3. lift all 3D boxes with one batched unprojection (utils/ddd.py);
  4. assemble the per-detection dicts from the transformed slabs.

The dict-list output contract (score/class/ct/tracking/bbox/hps/dep/
dim/alpha/loc/rot_y/nuscenes_att/velocity per detection) matches the
reference's so downstream tracker/eval code is drop-in; with the ddd
heads 'ct' is the centre the box was lifted at (the amodal one where
the net predicts it).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from centertrack_tpu_torch.ops.affine import (get_affine_transform,
                                              transform_preds_with_trans)
from centertrack_tpu_torch.utils.ddd import ddd2locrot_batch


def get_alpha(rot: np.ndarray) -> np.ndarray:
    """8-bin rot vector -> observation angle alpha, batched over rows
    (reference: post_process.py:12-19). rot: (N, 8)."""
    idx = rot[:, 1] > rot[:, 5]
    alpha1 = np.arctan2(rot[:, 2], rot[:, 3]) + (-0.5 * np.pi)
    alpha2 = np.arctan2(rot[:, 6], rot[:, 7]) + (0.5 * np.pi)
    return alpha1 * idx + alpha2 * (1 - idx)


def _image_post_process(cfg, dets: Dict[str, np.ndarray], i: int,
                        trans: np.ndarray, calib) -> List[Dict]:
    scores = np.asarray(dets["scores"][i], np.float32)
    # rows are score-sorted (decode guarantees it; the detector re-sorts
    # after NMS masking), so thresholding is a prefix count
    n = int((scores >= cfg.out_thresh).sum())
    if n == 0:
        return []

    cts = np.asarray(dets["cts"][i][:n], np.float32).reshape(n, 2)
    has_ddd = "rot" in dets and "dep" in dets and "dim" in dets
    use_amodel = has_ddd and "amodel_offset" in dets

    # one inverse-affine over every 2-D point of every head
    segments = [("ct", cts, (n, 2))]
    if "tracking" in dets:
        ends = np.asarray(dets["tracking"][i][:n], np.float32) + cts
        segments.append(("track_end", ends, (n, 2)))
    if "bboxes" in dets:
        corners = np.asarray(dets["bboxes"][i][:n],
                             np.float32).reshape(2 * n, 2)
        segments.append(("bbox", corners, (n, 4)))
    if "hps" in dets:
        n_hp = int(np.asarray(dets["hps"][i]).shape[-1])
        kps = np.asarray(dets["hps"][i][:n], np.float32).reshape(-1, 2)
        segments.append(("hps", kps, (n, n_hp)))
    if use_amodel:
        bbox_ct = np.asarray(dets["bboxes"][i][:n],
                             np.float32).reshape(n, 2, 2).mean(axis=1)
        amodel = bbox_ct + np.asarray(dets["amodel_offset"][i][:n],
                                      np.float32)
        segments.append(("amodel_ct", amodel, (n, 2)))

    flat = (np.concatenate([s[1].reshape(-1, 2) for s in segments])
            if n else np.zeros((0, 2), np.float32))
    warped = transform_preds_with_trans(flat, trans)

    fields: Dict[str, np.ndarray] = {}
    ofs = 0
    for name, pts, out_shape in segments:
        cnt = pts.reshape(-1, 2).shape[0]
        fields[name] = warped[ofs:ofs + cnt].reshape(out_shape)
        ofs += cnt

    if "tracking" in dets:
        fields["tracking"] = fields.pop("track_end") - fields["ct"]
    if "rot" in dets:
        fields["alpha"] = get_alpha(
            np.asarray(dets["rot"][i][:n]).reshape(n, -1))
    if has_ddd:
        # 3D lift at the amodal center when predicted, else the bbox
        # center (reference: post_process.py:65-77)
        ct3d = (fields["amodel_ct"] if use_amodel else
                fields["bbox"].reshape(n, 2, 2).mean(axis=1))
        fields["ct"] = ct3d
        locs, rot_ys = ddd2locrot_batch(
            ct3d, fields["alpha"],
            np.asarray(dets["dim"][i][:n]).reshape(n, -1),
            np.asarray(dets["dep"][i][:n]).reshape(n, -1)[:, 0], calib)
        fields["loc"], fields["rot_y"] = locs, rot_ys
    fields.pop("amodel_ct", None)

    passthrough = [k for k in ("dep", "dim", "nuscenes_att", "velocity")
                   if k in dets]

    preds = []
    for j in range(n):
        item = {"score": float(scores[j]),
                "class": int(dets["clses"][i][j]) + 1}
        for name, arr in fields.items():
            item[name] = arr[j]
        for name in passthrough:
            item[name] = np.asarray(dets[name][i][j])
        preds.append(item)
    return preds


def generic_post_process(cfg, dets: Dict[str, np.ndarray], c, s,
                         h: int, w: int, calibs=None) -> List[List[Dict]]:
    """Args:
      dets: dict of (B, K, ...) numpy arrays from generic_decode,
        rows score-sorted per image.
      c, s: per-image center/scale used at pre-process time.
      h, w: output grid height/width.
    Returns per-image lists of per-detection dicts in image coords."""
    if "scores" not in dets:
        return [{}]
    ret = []
    for i in range(len(dets["scores"])):
        trans = get_affine_transform(
            c[i], s[i], 0, (w, h), inv=1).astype(np.float32)
        calib = calibs[i] if calibs is not None else None
        ret.append(_image_post_process(cfg, dets, i, trans, calib))
    return ret
