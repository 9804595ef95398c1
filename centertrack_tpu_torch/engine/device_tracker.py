"""On-device greedy association tracker (reference:
src/lib/utils/tracker.py:28-127; JAX: centertrack_tpu/engine/
device_tracker.py:40-166).

The track state is a fixed-capacity set of masked tensors with a
leading stream axis that stays on the device. Births and deaths are
compacted with masked cumsums in the reference's order: matched and
born detections first, in detection order, then aged tracks.

One difference from the JAX package: JAX marks matched tracks with a
scatter whose unmatched rows also write (a False into slot 0), so on
its CPU backend a track matched from slot 0 is also kept as aged, a
duplicate. Here only matched rows write.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from centertrack_tpu_torch.ops import tracker


class TrackState(NamedTuple):
    ids: torch.Tensor        # (S, T) int32
    cts: torch.Tensor        # (S, T, 2) f32
    bboxes: torch.Tensor     # (S, T, 4) f32
    classes: torch.Tensor    # (S, T) int32
    scores: torch.Tensor     # (S, T) f32
    ages: torch.Tensor       # (S, T) int32
    active: torch.Tensor     # (S, T) int32
    valid: torch.Tensor      # (S, T) bool
    id_count: torch.Tensor   # (S,) int32


def init_state(capacity: int, streams: int, device="cuda") -> TrackState:
    """Empty state of ``streams`` streams of ``capacity`` slots each (all
    zeros, as the JAX init_state per stream)."""
    st = (streams, capacity)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackState(
        ids=torch.zeros(st, **i32), cts=torch.zeros(st + (2,), **f32),
        bboxes=torch.zeros(st + (4,), **f32),
        classes=torch.zeros(st, **i32), scores=torch.zeros(st, **f32),
        ages=torch.zeros(st, **i32), active=torch.zeros(st, **i32),
        valid=torch.zeros(st, dtype=torch.bool, device=device),
        id_count=torch.zeros(streams, **i32))


# the plain single-stream assignment over a row list (the tests' oracle)
greedy_assign = tracker.greedy_assign_rows


def step(state: TrackState, det_scores: torch.Tensor,
         det_classes: torch.Tensor, det_cts: torch.Tensor,
         det_tracking: torch.Tensor, det_bboxes: torch.Tensor,
         out_thresh: float, new_thresh: float, max_age: int
         ) -> Tuple[TrackState, Dict[str, torch.Tensor]]:
    """One association step of S independent streams over (S, K, ...)
    score-sorted detections (JAX: ``jax.vmap(device_tracker.step)``).

    Returns (new_state, per-detection tracking_id / age / active, each
    (S, K); tracking_id 0 means the detection made no track). Reads
    nothing back to the host: the greedy assignment is
    ``ops/tracker.greedy_assign``, births, deaths and compaction are
    masked cumsums and scatters with a sink slot per stream.
    """
    t = state.ids.shape[1]
    i32 = torch.int32
    det_valid = det_scores > out_thresh

    moved = det_cts + det_tracking
    dist = ((moved[:, :, None, :] - state.cts[:, None, :, :]) ** 2).sum(-1)
    track_size = ((state.bboxes[..., 2] - state.bboxes[..., 0]) *
                  (state.bboxes[..., 3] - state.bboxes[..., 1]))
    det_size = ((det_bboxes[..., 2] - det_bboxes[..., 0]) *
                (det_bboxes[..., 3] - det_bboxes[..., 1]))
    invalid = ((dist > track_size[:, None, :]) |
               (dist > det_size[:, :, None]) |
               (det_classes[:, :, None] != state.classes[:, None, :]) |
               (~det_valid[:, :, None]) | (~state.valid[:, None, :]))
    dist = dist.masked_fill(invalid, 1e18)                      # S, K, T

    match = tracker.greedy_assign(dist)
    matched = match >= 0
    mcol = match.clamp(min=0).long()

    det_ids = torch.where(matched, state.ids.gather(1, mcol), 0)
    det_active = torch.where(matched, state.active.gather(1, mcol) + 1, 1)

    # births (reference: tracker.py:102-111)
    births = (~matched) & det_valid & (det_scores > new_thresh)
    birth_ord = torch.cumsum(births.to(i32), 1, dtype=i32)
    det_ids = torch.where(births, state.id_count[:, None] + birth_ord,
                          det_ids)
    id_count = state.id_count + birth_ord[:, -1]

    has_track = matched | births
    det_age = has_track.to(i32)
    det_active = torch.where(has_track, det_active, 0)

    # aged unmatched tracks (reference: tracker.py:113-125); slot t is a
    # sink for the unmatched rows
    track_matched = torch.zeros(matched.shape[0], t + 1, dtype=torch.bool,
                                device=mcol.device)
    track_matched.scatter_(1, torch.where(matched, mcol, t), True)
    aged = state.valid & (~track_matched[:, :t]) & (state.ages < max_age)

    # compact: matched + born detections first (detection order), then
    # aged tracks; rows past the capacity go to the sink slot t
    det_pos = torch.cumsum(has_track.to(i32), 1, dtype=i32) - 1
    n_dets = has_track.sum(1, dtype=i32)
    aged_pos = n_dets[:, None] + torch.cumsum(aged.to(i32), 1, dtype=i32) - 1

    f32 = torch.float32
    det_rows = torch.cat([
        det_ids[..., None].to(f32), det_cts, det_bboxes,
        det_classes[..., None].to(f32), det_scores[..., None],
        det_age[..., None].to(f32), det_active[..., None].to(f32),
        has_track[..., None].to(f32)], dim=2)                   # S, K, 12
    aged_rows = torch.cat([
        state.ids[..., None].to(f32), state.cts, state.bboxes,
        state.classes[..., None].to(f32), state.scores[..., None],
        (state.ages + 1)[..., None].to(f32),
        torch.zeros_like(state.scores)[..., None],
        aged[..., None].to(f32)], dim=2)                        # S, T, 12

    def slot(keep, pos):
        return torch.where(keep & (pos < t), pos, t).long()[..., None]

    packed = torch.zeros((matched.shape[0], t + 1, 12), dtype=f32,
                         device=mcol.device)
    packed.scatter_(1, slot(has_track, det_pos).expand(-1, -1, 12), det_rows)
    packed.scatter_(1, slot(aged, aged_pos).expand(-1, -1, 12), aged_rows)
    packed = packed[:, :t]

    new = TrackState(
        ids=packed[..., 0].to(i32), cts=packed[..., 1:3],
        bboxes=packed[..., 3:7], classes=packed[..., 7].to(i32),
        scores=packed[..., 8], ages=packed[..., 9].to(i32),
        active=packed[..., 10].to(i32), valid=packed[..., 11] > 0.5,
        id_count=id_count)
    out = {"tracking_id": det_ids * has_track.to(i32), "age": det_age,
           "active": det_active}
    return new, out
