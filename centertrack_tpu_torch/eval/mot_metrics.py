"""CLEAR-MOT + ID metrics (MOTA/MOTP/IDF1/MT/ML/Frag/IDSW)
(JAX: centertrack_tpu/eval/mot_metrics.py).

Implements the py-motmetrics algorithm the reference relies on
(reference: src/tools/eval_motchallenge.py:49-127 calls
mm.utils.compare_to_groundtruth(..., 'iou', distth=0.5)):

  * per-frame correspondence: keep previous-frame matches that are
    still within the distance threshold, then Hungarian on the rest
    (Bernardin & Stiefelhagen 2008);
  * distance = 1 - IoU, invalid above 0.5;
  * ID measures: trajectory-level bipartite assignment maximizing
    in-threshold frame overlaps (Ristani et al. 2016).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

INVALID = np.nan


def iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (N,4) and (M,4) boxes in x,y,w,h."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix1 = np.maximum(ax1[:, None], bx1[None, :])
    iy1 = np.maximum(ay1[:, None], by1[None, :])
    ix2 = np.minimum(ax2[:, None], bx2[None, :])
    iy2 = np.minimum(ay2[:, None], by2[None, :])
    iw = np.clip(ix2 - ix1, 0, None)
    ih = np.clip(iy2 - iy1, 0, None)
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + \
        (b[:, 2] * b[:, 3])[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def iou_distance(gt_boxes, hyp_boxes, max_iou: float = 0.5) -> np.ndarray:
    """1 - IoU, NaN where IoU < 1 - max_iou... following motmetrics:
    distances > max_iou are invalid."""
    d = 1.0 - iou_xywh(np.asarray(gt_boxes, np.float64),
                       np.asarray(hyp_boxes, np.float64))
    return np.where(d > max_iou, INVALID, d)


class MOTAccumulator:
    """Frame-by-frame CLEAR accumulation for one sequence."""

    def __init__(self):
        # last hypothesis each gt id was EVER matched to (for IDSW)
        self.last_match: Dict = {}
        # hypothesis matched in the previous frame (for correspondence
        # carry-over)
        self.prev_frame_match: Dict = {}
        self.num_objects = 0      # total gt boxes
        self.num_hyps = 0
        self.num_matches = 0
        self.num_switches = 0
        self.num_false_positives = 0
        self.num_misses = 0
        self.dist_sum = 0.0
        # per gt id: frames present / matched, and last-frame match state
        self.gt_frames = defaultdict(int)
        self.gt_matched_frames = defaultdict(int)
        self.gt_was_matched_prev = {}
        self.fragmentations = 0
        # for ID measures
        self.id_overlap = defaultdict(int)      # (gt_id, hyp_id) -> frames
        self.hyp_frames = defaultdict(int)

    def update(self, gt_ids: List, gt_boxes, hyp_ids: List, hyp_boxes,
               dist: Optional[np.ndarray] = None):
        """``dist`` overrides the default IoU distance with a custom
        (num_gt, num_hyp) matrix (NaN = invalid pair) — e.g. the
        nuScenes evaluator's ground-plane center distance."""
        gt_ids = list(gt_ids)
        hyp_ids = list(hyp_ids)
        if dist is None:
            dist = iou_distance(gt_boxes, hyp_boxes) \
                if gt_ids and hyp_ids \
                else np.zeros((len(gt_ids), len(hyp_ids)))
        self.num_objects += len(gt_ids)
        self.num_hyps += len(hyp_ids)
        for g in gt_ids:
            self.gt_frames[g] += 1
        for h in hyp_ids:
            self.hyp_frames[h] += 1

        matches = {}  # gt_id -> (hyp_id, dist)
        used_h = set()
        # 1) carry over previous-frame correspondences still valid
        for gi, g in enumerate(gt_ids):
            h = self.prev_frame_match.get(g)
            if h is not None and h in hyp_ids:
                hi = hyp_ids.index(h)
                if not np.isnan(dist[gi, hi]):
                    matches[g] = (h, dist[gi, hi])
                    used_h.add(h)
        # 2) Hungarian on the rest
        rem_g = [i for i, g in enumerate(gt_ids) if g not in matches]
        rem_h = [j for j, h in enumerate(hyp_ids) if h not in used_h]
        if rem_g and rem_h:
            sub = dist[np.ix_(rem_g, rem_h)]
            cost = np.where(np.isnan(sub), 1e9, sub)
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if cost[r, c] < 1e8:
                    g = gt_ids[rem_g[r]]
                    h = hyp_ids[rem_h[c]]
                    matches[g] = (h, sub[r, c])
                    used_h.add(h)

        # 3) events
        for g, (h, d) in matches.items():
            self.num_matches += 1
            self.dist_sum += d
            self.gt_matched_frames[g] += 1
            self.id_overlap[(g, h)] += 1
            last = self.last_match.get(g)
            if last is not None and last != h:
                self.num_switches += 1
            self.last_match[g] = h
            if self.gt_was_matched_prev.get(g) is False:
                # was seen unmatched after having been matched before
                self.fragmentations += 1
        self.num_false_positives += len(hyp_ids) - len(used_h)
        self.num_misses += len(gt_ids) - len(matches)

        for g in gt_ids:
            if g in matches:
                self.gt_was_matched_prev[g] = True
            elif g in self.last_match:
                self.gt_was_matched_prev[g] = False
        self.prev_frame_match = {g: h for g, (h, _) in matches.items()}

    # ------------------------------------------------------------------
    def id_measures(self) -> Dict[str, float]:
        """Trajectory-level ID assignment (Ristani et al.)."""
        gt_tracks = sorted(self.gt_frames)
        hyp_tracks = sorted(self.hyp_frames)
        n, m = len(gt_tracks), len(hyp_tracks)
        total_gt = sum(self.gt_frames.values())
        total_hyp = sum(self.hyp_frames.values())
        if n == 0 or m == 0:
            idtp = 0
        else:
            size = n + m
            # cost = missed frames if paired; diagonal blocks for unmatched
            cost = np.full((size, size), 0.0)
            big = 1e9
            cost[:n, :m] = 0.0
            for i, g in enumerate(gt_tracks):
                for j, h in enumerate(hyp_tracks):
                    ov = self.id_overlap.get((g, h), 0)
                    cost[i, j] = (self.gt_frames[g] - ov) + \
                        (self.hyp_frames[h] - ov)
            cost[:n, m:] = big
            for i, g in enumerate(gt_tracks):
                cost[i, m + i] = self.gt_frames[g]
            cost[n:, :m] = big
            for j, h in enumerate(hyp_tracks):
                cost[n + j, j] = self.hyp_frames[h]
            cost[n:, m:] = 0.0
            rows, cols = linear_sum_assignment(cost)
            idtp = 0
            for r, c in zip(rows, cols):
                if r < n and c < m:
                    idtp += self.id_overlap.get(
                        (gt_tracks[r], hyp_tracks[c]), 0)
        idfn = total_gt - idtp
        idfp = total_hyp - idtp
        idp = idtp / max(idtp + idfp, 1)
        idr = idtp / max(idtp + idfn, 1)
        idf1 = 2 * idtp / max(2 * idtp + idfp + idfn, 1)
        return {"idf1": idf1, "idp": idp, "idr": idr, "idtp": idtp,
                "idfp": idfp, "idfn": idfn}

    def metrics(self) -> Dict[str, float]:
        num_obj = max(self.num_objects, 1)
        mt = pt = ml = 0
        for g, present in self.gt_frames.items():
            ratio = self.gt_matched_frames.get(g, 0) / present
            if ratio >= 0.8:
                mt += 1
            elif ratio <= 0.2:
                ml += 1
            else:
                pt += 1
        out = {
            "num_frames": None,
            "num_objects": self.num_objects,
            "num_unique_objects": len(self.gt_frames),
            "num_matches": self.num_matches,
            "num_false_positives": self.num_false_positives,
            "num_misses": self.num_misses,
            "num_switches": self.num_switches,
            "num_fragmentations": self.fragmentations,
            "mostly_tracked": mt,
            "partially_tracked": pt,
            "mostly_lost": ml,
            "recall": self.num_matches / num_obj,
            "precision": self.num_matches / max(
                self.num_matches + self.num_false_positives, 1),
            "mota": 1.0 - (self.num_misses + self.num_false_positives +
                           self.num_switches) / num_obj,
            "motp": (self.dist_sum / self.num_matches
                     if self.num_matches else np.nan),
        }
        out.update(self.id_measures())
        return out


def combine_metrics(per_seq: Dict[str, Dict[str, float]],
                    accs: Dict[str, MOTAccumulator]) -> Dict[str, float]:
    """OVERALL row: recompute ratios from summed counts
    (matches motmetrics generate_overall)."""
    keys = ["num_objects", "num_unique_objects", "num_matches",
            "num_false_positives", "num_misses", "num_switches",
            "num_fragmentations", "mostly_tracked", "partially_tracked",
            "mostly_lost", "idtp", "idfp", "idfn"]
    tot = {k: sum(m[k] for m in per_seq.values()) for k in keys}
    num_obj = max(tot["num_objects"], 1)
    dist_sum = sum(a.dist_sum for a in accs.values())
    overall = dict(tot)
    overall["recall"] = tot["num_matches"] / num_obj
    overall["precision"] = tot["num_matches"] / max(
        tot["num_matches"] + tot["num_false_positives"], 1)
    overall["mota"] = 1.0 - (
        tot["num_misses"] + tot["num_false_positives"] +
        tot["num_switches"]) / num_obj
    overall["motp"] = (dist_sum / tot["num_matches"]
                       if tot["num_matches"] else np.nan)
    idtp, idfp, idfn = tot["idtp"], tot["idfp"], tot["idfn"]
    overall["idf1"] = 2 * idtp / max(2 * idtp + idfp + idfn, 1)
    overall["idp"] = idtp / max(idtp + idfp, 1)
    overall["idr"] = idtp / max(idtp + idfn, 1)
    return overall
