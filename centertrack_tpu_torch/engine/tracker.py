"""Displacement-based association tracker of the host Detector
(reference: src/lib/utils/tracker.py; JAX: centertrack_tpu/engine/
tracker.py), in numpy.

It matches the reference exactly, including the greedy loop's
tie-breaking order (``argmin``'s first minimum), which decides the
track ids, and the in-place mutation of the result dicts it is given
(the dicts it returns are those very dicts, and a later step changes
their ``age`` and ``active``). N and M are <= K (100), so this is
microseconds of host work a frame. The serving engine's on-device
tracker is ``device_tracker.py``.

The Hungarian option uses scipy's linear_sum_assignment (the reference
used sklearn's deprecated linear_assignment, the same algorithm),
imported only when the option is on.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np


def greedy_assignment(dist: np.ndarray) -> np.ndarray:
    """Row-ordered greedy argmin assignment
    (reference: tracker.py:129-138). dist is mutated."""
    matched_indices = []
    if dist.shape[1] == 0:
        return np.array(matched_indices, np.int32).reshape(-1, 2)
    for i in range(dist.shape[0]):
        j = dist[i].argmin()
        if dist[i][j] < 1e16:
            dist[:, j] = 1e18
            matched_indices.append([i, j])
    return np.array(matched_indices, np.int32).reshape(-1, 2)


class Tracker:
    """(reference: tracker.py:6-127)"""

    def __init__(self, cfg):
        self.cfg = cfg
        self.reset()

    def init_track(self, results: List[Dict]) -> None:
        """Seed tracks from provided detections (first frame / public
        dets) (reference: tracker.py:11-22)."""
        for item in results:
            if item["score"] > self.cfg.new_thresh:
                self.id_count += 1
                item["active"] = 1
                item["age"] = 1
                item["tracking_id"] = self.id_count
                if "ct" not in item:
                    bbox = item["bbox"]
                    item["ct"] = [(bbox[0] + bbox[2]) / 2,
                                  (bbox[1] + bbox[3]) / 2]
                self.tracks.append(item)

    def reset(self) -> None:
        self.id_count = 0
        self.tracks: List[Dict] = []

    def step(self, results: List[Dict],
             public_det: Optional[List[Dict]] = None) -> List[Dict]:
        """One association step (reference: tracker.py:28-127)."""
        n = len(results)
        m = len(self.tracks)

        # elementwise ct + tracking displacement (reference: tracker.py:32-33
        # relies on both being numpy arrays; asarray makes list inputs safe)
        dets = np.array(
            [np.asarray(det["ct"], np.float32) +
             np.asarray(det["tracking"], np.float32) for det in results],
            np.float32).reshape(n, 2)
        track_size = np.array(
            [((t["bbox"][2] - t["bbox"][0]) * (t["bbox"][3] - t["bbox"][1]))
             for t in self.tracks], np.float32)
        track_cat = np.array([t["class"] for t in self.tracks], np.int32)
        item_size = np.array(
            [((i_["bbox"][2] - i_["bbox"][0]) *
              (i_["bbox"][3] - i_["bbox"][1])) for i_ in results], np.float32)
        item_cat = np.array([i_["class"] for i_ in results], np.int32)
        tracks_ct = np.array(
            [t["ct"] for t in self.tracks], np.float32).reshape(m, 2)
        dist = (((tracks_ct.reshape(1, -1, 2) -
                  dets.reshape(-1, 1, 2)) ** 2).sum(axis=2))  # N x M

        invalid = ((dist > track_size.reshape(1, m)) +
                   (dist > item_size.reshape(n, 1)) +
                   (item_cat.reshape(n, 1) != track_cat.reshape(1, m))) > 0
        dist = dist + invalid * 1e18

        if self.cfg.hungarian:
            from scipy.optimize import linear_sum_assignment
            dist = np.minimum(dist, 1e18)
            row, col = linear_sum_assignment(dist)
            matched_indices = np.stack([row, col], axis=1)
        else:
            matched_indices = greedy_assignment(copy.deepcopy(dist))

        unmatched_dets = [d for d in range(dets.shape[0])
                          if not (d in matched_indices[:, 0])]
        unmatched_tracks = [d for d in range(tracks_ct.shape[0])
                            if not (d in matched_indices[:, 1])]

        if self.cfg.hungarian:
            matches = []
            for mi in matched_indices:
                if dist[mi[0], mi[1]] > 1e16:
                    unmatched_dets.append(mi[0])
                    unmatched_tracks.append(mi[1])
                else:
                    matches.append(mi)
            matches = np.array(matches).reshape(-1, 2)
        else:
            matches = matched_indices

        ret = []
        for mi in matches:
            track = results[mi[0]]
            track["tracking_id"] = self.tracks[mi[1]]["tracking_id"]
            track["age"] = 1
            track["active"] = self.tracks[mi[1]]["active"] + 1
            ret.append(track)

        if self.cfg.public_det and len(unmatched_dets) > 0:
            # Public-detection mode: new tracks only from provided dets
            # (reference: tracker.py:83-101)
            pub_dets = np.array([d["ct"] for d in public_det], np.float32)
            dist3 = ((dets.reshape(-1, 1, 2) -
                      pub_dets.reshape(1, -1, 2)) ** 2).sum(axis=2)
            matched_dets = [d for d in range(dets.shape[0])
                            if not (d in unmatched_dets)]
            dist3[matched_dets] = 1e18
            for j in range(len(pub_dets)):
                i = dist3[:, j].argmin()
                if dist3[i, j] < item_size[i]:
                    dist3[i, :] = 1e18
                    track = results[i]
                    if track["score"] > self.cfg.new_thresh:
                        self.id_count += 1
                        track["tracking_id"] = self.id_count
                        track["age"] = 1
                        track["active"] = 1
                        ret.append(track)
        else:
            # Private mode: every unmatched det above new_thresh births
            # a track (reference: tracker.py:102-111)
            for i in unmatched_dets:
                track = results[i]
                if track["score"] > self.cfg.new_thresh:
                    self.id_count += 1
                    track["tracking_id"] = self.id_count
                    track["age"] = 1
                    track["active"] = 1
                    ret.append(track)

        # Age unmatched tracks up to max_age with active=0
        # (reference: tracker.py:113-125)
        for i in unmatched_tracks:
            track = self.tracks[i]
            if track["age"] < self.cfg.max_age:
                track["age"] += 1
                track["active"] = 0
                ret.append(track)
        self.tracks = ret
        return ret
