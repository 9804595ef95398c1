"""On-device greedy association tracker (reference:
src/lib/utils/tracker.py:28-127; JAX: centertrack_tpu/engine/
device_tracker.py:40-166).

The track state is a fixed-capacity set of masked tensors that stays on
the device. Births and deaths are compacted with masked cumsums in the
reference's order: matched and born detections first, in detection
order, then aged tracks.

One difference from the JAX package: JAX marks matched tracks with a
scatter whose unmatched rows also write (a False into slot 0), so on
its CPU backend a track matched from slot 0 is also kept as aged, a
duplicate. Here only matched rows write.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch


class TrackState(NamedTuple):
    ids: torch.Tensor        # (T,) int32
    cts: torch.Tensor        # (T, 2) f32
    bboxes: torch.Tensor     # (T, 4) f32
    classes: torch.Tensor    # (T,) int32
    scores: torch.Tensor     # (T,) f32
    ages: torch.Tensor       # (T,) int32
    active: torch.Tensor     # (T,) int32
    valid: torch.Tensor      # (T,) bool
    id_count: torch.Tensor   # () int32


def init_state(capacity: int, device="cuda") -> TrackState:
    t = capacity
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackState(
        ids=torch.zeros(t, **i32), cts=torch.zeros(t, 2, **f32),
        bboxes=torch.zeros(t, 4, **f32), classes=torch.zeros(t, **i32),
        scores=torch.zeros(t, **f32), ages=torch.zeros(t, **i32),
        active=torch.zeros(t, **i32),
        valid=torch.zeros(t, dtype=torch.bool, device=device),
        id_count=torch.zeros((), **i32))


def greedy_assign(dist: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """Row-ordered greedy argmin (reference: tracker.py:129-138).
    dist: (K, T), invalid entries >= 1e18. Returns (K,) int32 matched
    column per row, -1 if none. ``rows``, increasing, are the rows that
    may match (a row left out must be all invalid); they run in order
    and the first minimal column wins, as in the JAX fori_loop."""
    k, t = dist.shape
    dist = dist.clone()
    match = torch.full((k,), -1, dtype=torch.int32, device=dist.device)
    big = torch.tensor(1e18, dtype=dist.dtype, device=dist.device)
    for i in rows:
        j = torch.argmin(dist[i]).view(1)
        ok = dist[i].gather(0, j) < 1e16
        match[i] = torch.where(ok, j, -1)[0].to(torch.int32)
        col = dist.index_select(1, j)
        dist.index_copy_(1, j, torch.where(ok, big, col))
    return match


def step(state: TrackState, det_scores: torch.Tensor,
         det_classes: torch.Tensor, det_cts: torch.Tensor,
         det_tracking: torch.Tensor, det_bboxes: torch.Tensor,
         out_thresh: float, new_thresh: float, max_age: int
         ) -> Tuple[TrackState, Dict[str, torch.Tensor]]:
    """One association step over (K, ...) score-sorted detections.

    Returns (new_state, per-detection tracking_id / age / active;
    tracking_id 0 means the detection made no track). Reads the number
    of detections above ``out_thresh`` back to the host once, to run
    the greedy loop over those rows only.
    """
    k = det_scores.shape[0]
    t = state.ids.shape[0]
    i32 = torch.int32
    det_valid = det_scores > out_thresh

    moved = det_cts + det_tracking
    dist = ((moved[:, None, :] - state.cts[None, :, :]) ** 2).sum(-1)
    track_size = ((state.bboxes[:, 2] - state.bboxes[:, 0]) *
                  (state.bboxes[:, 3] - state.bboxes[:, 1]))
    det_size = ((det_bboxes[:, 2] - det_bboxes[:, 0]) *
                (det_bboxes[:, 3] - det_bboxes[:, 1]))
    invalid = ((dist > track_size[None, :]) | (dist > det_size[:, None]) |
               (det_classes[:, None] != state.classes[None, :]) |
               (~det_valid[:, None]) | (~state.valid[None, :]))
    dist = torch.where(invalid, torch.full_like(dist, 1e18), dist)

    rows: List[int] = torch.nonzero(det_valid).flatten().tolist()
    match = greedy_assign(dist, rows)
    matched = match >= 0
    mcol = match.clamp(min=0).long()

    det_ids = torch.where(matched, state.ids[mcol], 0)
    det_active = torch.where(matched, state.active[mcol] + 1, 1)

    # births (reference: tracker.py:102-111)
    births = (~matched) & det_valid & (det_scores > new_thresh)
    birth_ord = torch.cumsum(births.to(i32), 0, dtype=i32)
    det_ids = torch.where(births, state.id_count + birth_ord, det_ids)
    id_count = state.id_count + birth_ord[-1]

    has_track = matched | births
    det_age = has_track.to(i32)
    det_active = torch.where(has_track, det_active, 0)

    # aged unmatched tracks (reference: tracker.py:113-125)
    track_matched = torch.zeros(t + 1, dtype=torch.bool, device=mcol.device)
    track_matched[torch.where(matched, mcol, t)] = True
    aged = state.valid & (~track_matched[:t]) & (state.ages < max_age)

    # compact: matched + born detections first (detection order), then
    # aged tracks; rows past the capacity are dropped (row t is a sink)
    det_pos = torch.cumsum(has_track.to(i32), 0, dtype=i32) - 1
    n_dets = has_track.sum(dtype=i32)
    aged_pos = n_dets + torch.cumsum(aged.to(i32), 0, dtype=i32) - 1

    f32 = torch.float32
    det_rows = torch.cat([
        det_ids[:, None].to(f32), det_cts, det_bboxes,
        det_classes[:, None].to(f32), det_scores[:, None],
        det_age[:, None].to(f32), det_active[:, None].to(f32),
        has_track[:, None].to(f32)], dim=1)                     # K, 12
    aged_rows = torch.cat([
        state.ids[:, None].to(f32), state.cts, state.bboxes,
        state.classes[:, None].to(f32), state.scores[:, None],
        (state.ages + 1)[:, None].to(f32),
        torch.zeros((t, 1), dtype=f32, device=mcol.device),
        aged[:, None].to(f32)], dim=1)                          # T, 12

    def slot(keep, pos):
        return torch.where(keep & (pos < t), pos, t).long()

    packed = torch.zeros((t + 1, 12), dtype=f32, device=mcol.device)
    packed[slot(has_track, det_pos)] = det_rows
    packed[slot(aged, aged_pos)] = aged_rows
    packed = packed[:t]

    new = TrackState(
        ids=packed[:, 0].to(i32), cts=packed[:, 1:3],
        bboxes=packed[:, 3:7], classes=packed[:, 7].to(i32),
        scores=packed[:, 8], ages=packed[:, 9].to(i32),
        active=packed[:, 10].to(i32), valid=packed[:, 11] > 0.5,
        id_count=id_count)
    out = {"tracking_id": det_ids * has_track.to(i32), "age": det_age,
           "active": det_active}
    return new, out
