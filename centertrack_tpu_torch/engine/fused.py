"""Fused detection + tracking step, the port's serving engine
(JAX: centertrack_tpu/engine/fused.py:127-476, 479-760).

Per frame and stream, on the device:

  uint8 frame -> separable affine warp + normalize
              -> pre_hm rendered from the device track state
              -> DLA-34 + DLAUp/IDAUp neck (clamped-DCN nodes) + heads
              -> sigmoid + top-K decode (boxes from wh, ltrb or
                 ltrb_amodal)
              -> inverse affine to image coordinates
              -> greedy association (engine/device_tracker.py)
              -> one packed (K, 13) float32 result row

The step reads nothing back to the host (the association and the pre_hm
splat are kernels: ops/tracker.greedy_assign and
ops/gaussian.splat_pre_hm), so on the card it is captured
as one CUDA graph per input shape, the port's form of JAX's ``jit`` per
``in_shape``: at a shape's first call the eager step runs once on
copies of the carried buffers (building the kernels and the libraries'
handles without advancing the tracker), then is captured on the static
buffers it reads and writes: the frame, the track state, the previous
frame's network input (``pre_images``) and a per-stream ``fresh`` flag
(a stream's first frame after a reset conditions on itself). Every
later call copies its frame in and replays the graph; a capture or a
replay that fails raises. On the CPU the same eager step runs directly.

``run`` / ``run_chunk`` return a fresh device tensor (the graph's own
output buffer is overwritten by the next replay) whose copy into pinned
host memory is started at once, as JAX's ``copy_to_host_async``;
``fetch`` / ``fetch_chunk`` wait for that copy only, and take only the
tensor that ``run`` / ``run_chunk`` returned (or a CPU tensor). Host frames reach
the card through a ring of pinned staging buffers by a non-blocking
copy. Private-detection 2D tracking only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from centertrack_tpu_torch.engine import device_tracker as dt
from centertrack_tpu_torch.data.registry import get_dataset_meta
from centertrack_tpu_torch.models.model import (create_model, load_model,
                                                params_from_jax,
                                                set_dcn_plain)
from centertrack_tpu_torch.ops.affine import (get_affine_transform,
                                              invert_affine)
from centertrack_tpu_torch.ops.decode import generic_decode, sigmoid_output
from centertrack_tpu_torch.ops.gaussian import gaussian_radius, render_pre_hm
from centertrack_tpu_torch.ops.warp import (preprocess_frame,
                                            warp_precision_for)
from centertrack_tpu_torch.utils.precision import full_float32

# pinned host buffers per frame shape: a buffer is refilled only after
# the copy that read it has completed, so this many copies may be in
# flight (the bench's lag-4 protocol keeps about five)
STAGING_DEPTH = 6

# one side stream per device index on which every engine warms a graph
# up before capturing it. cuBLAS keeps a workspace for each stream it has
# run on for the life of the process (32 MiB on an H100), so a side
# stream made per capture left one workspace behind per graph of every
# deleted detector
_WARMUP_STREAMS: Dict[int, torch.cuda.Stream] = {}


def warmup_stream(device) -> torch.cuda.Stream:
    """The warm-up stream of ``device`` (a CUDA device), made at first
    use and kept."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _WARMUP_STREAMS.get(index)
    if stream is None:
        stream = _WARMUP_STREAMS[index] = torch.cuda.Stream(index)
    return stream


def _affine_pts(pts: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 2) points through a 2x3 affine."""
    return pts @ m[:, :2].T + m[:, 2]


class _Carried(NamedTuple):
    """What one step hands the next: the (S, T, ...) track state, the
    (S, H, W, 3) previous network input and the (S,) fresh flags."""
    state: dt.TrackState
    pre: torch.Tensor
    fresh: torch.Tensor

    def clone(self) -> "_Carried":
        return _Carried(dt.TrackState(*(t.clone() for t in self.state)),
                        self.pre.clone(), self.fresh.clone())


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    frames: torch.Tensor   # (F, S, h, w, 3) uint8, read by every replay
    out: torch.Tensor      # (F, S, K, 13) float32, written by every replay


class _Staging:
    """A ring of pinned host buffers for frames of one shape."""

    def __init__(self, shape):
        self.bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                     for _ in range(STAGING_DEPTH)]
        self.copied = [None] * STAGING_DEPTH
        self.next = 0

    def copy(self, frames, dst: torch.Tensor) -> None:
        """Host frames (an array of ``dst``'s size, or a sequence of
        (h, w, 3) frames) -> ``dst`` on the card, non-blocking."""
        i = self.next
        self.next = (i + 1) % STAGING_DEPTH
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        host = self.bufs[i].numpy()
        if isinstance(frames, (list, tuple)):
            flat = host.reshape((-1,) + host.shape[-3:])
            for j, frame in enumerate(frames):
                flat[j] = frame
        else:
            np.copyto(host, np.asarray(frames).reshape(host.shape))
        dst.copy_(self.bufs[i], non_blocking=True)
        self.copied[i] = torch.cuda.Event()
        self.copied[i].record()


def _with_host_copy(results: torch.Tensor) -> torch.Tensor:
    """Starts ``results``' copy into pinned host memory and records its
    event; ``_host`` waits for it."""
    if results.device.type == "cuda":
        host = torch.empty(results.shape, dtype=results.dtype,
                           pin_memory=True)
        host.copy_(results, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        results._host_copy = (host, done)
    return results


def _host(results: torch.Tensor) -> np.ndarray:
    """The rows on the host: a CPU tensor as it is; for a CUDA tensor
    returned by ``run`` / ``run_chunk``, its started copy once that
    copy's event completes. Any other CUDA tensor (a view or a copy of a
    result) raises: its copy would wait for every frame enqueued
    after it."""
    if results.device.type != "cuda":
        return results.numpy()
    pending = getattr(results, "_host_copy", None)
    if pending is None:
        raise ValueError("fetch takes the tensor that run or run_chunk "
                         "returned, whose host copy was started there; "
                         "this CUDA tensor has none (a view or a copy?)")
    host, done = pending
    done.synchronize()
    return host.numpy()


class _Engine:
    """The serving step over S streams in one batch, with the static
    buffers, graphs and staging that ``FusedDetector`` (S = 1) and
    ``MultiStreamDetector`` share.

    ``params``/``batch_stats`` are the JAX package's trees (as read by
    utils.checkpoint.load_jax_ckpt). Without ``params`` the net keeps its
    initialisation, or takes ``cfg.load_model``'s checkpoint merged onto
    it (JAX engine/fused.py:142-148); without ``dataset_meta`` the meta is
    ``cfg.dataset``'s. ``cfg.compute_dtype`` sets the
    network's dtype; at float32 the step runs in full float32
    (``utils.precision.full_float32``: cuDNN and cuBLAS without TF32, the
    caller's flags restored after), so a graph captured from it keeps
    that precision whatever the process's flags at a replay. Everything
    around the network runs as in the JAX ``one_frame``: the warp at
    ``warp_precision_for(cfg)``, the float32 input and pre_hm cast to the
    compute dtype by the network, float32 head maps, so the decode, the
    thresholds, the track state and the packed rows are float32 at
    either dtype.
    """

    def __init__(self, cfg, streams, params, batch_stats, dataset_meta,
                 device, plain_dcn=False):
        if not cfg.tracking:
            raise ValueError(f"{type(self).__name__} is for tracking tasks")
        self.cfg = cfg
        self.streams = int(streams)
        self.device = torch.device(device)
        self.model = create_model(cfg, self.device)
        if params is not None:
            self.model.load_state_dict(params_from_jax(params, batch_stats),
                                       strict=True)
        elif cfg.load_model:
            load_model(cfg.load_model, self.model)
        if dataset_meta is None:
            dataset_meta = get_dataset_meta(cfg.dataset, cfg)
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
        self._graphs: Dict[tuple, _Graph] = {}
        self._staging: Dict[tuple, _Staging] = {}
        self._pool = None        # one memory pool for this engine's graphs
        self._carried = _Carried(
            dt.init_state(self.capacity, self.streams, self.device),
            torch.zeros((self.streams, cfg.input_h, cfg.input_w, 3),
                        device=self.device),
            torch.ones(self.streams, dtype=torch.bool, device=self.device))
        # the fresh flags as the host last set them (no read-back)
        self._fresh_host = np.ones(self.streams, bool)

    # ---- the carried state ------------------------------------------
    def reset_tracking(self):
        """Every stream starts over: the static buffers are reset in
        place, in stream order."""
        for t in self._carried.state:
            t.zero_()
        self._carried.fresh.fill_(True)
        self._fresh_host[:] = True

    @property
    def track_state(self) -> dt.TrackState:
        """A copy of the (S, T, ...) track state."""
        return dt.TrackState(*(t.clone() for t in self._carried.state))

    @track_state.setter
    def track_state(self, state: dt.TrackState):
        for dst, src in zip(self._carried.state, state):
            dst.copy_(src.reshape(dst.shape))

    @property
    def pre_images(self):
        """A copy of the (S, H, W, 3) previous network input, None while
        every stream is fresh (its next frame conditions on itself)."""
        if self._fresh_host.all():
            return None
        return self._carried.pre.clone()

    @pre_images.setter
    def pre_images(self, images):
        """None makes every stream fresh; a tensor is copied in and
        every stream conditions on it."""
        if images is None:
            self._carried.fresh.fill_(True)
            self._fresh_host[:] = True
        else:
            self._carried.pre.copy_(images.reshape(self._carried.pre.shape))
            self._carried.fresh.fill_(False)
            self._fresh_host[:] = False

    # ---- the step ---------------------------------------------------
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
        tl = _affine_pts(state.bboxes[..., 0:2], trans_input)
        br = _affine_pts(state.bboxes[..., 2:4], trans_input)
        x1 = tl[..., 0].clamp(0, cfg.input_w - 1)
        y1 = tl[..., 1].clamp(0, cfg.input_h - 1)
        x2 = br[..., 0].clamp(0, cfg.input_w - 1)
        y2 = br[..., 1].clamp(0, cfg.input_h - 1)
        h = y2 - y1
        w = x2 - x1
        use_track = use_track & (h > 0) & (w > 0)
        radius = torch.floor(gaussian_radius(torch.ceil(h), torch.ceil(w))
                             ).clamp(min=0).to(torch.int32)
        cts = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2], dim=-1)
        return render_pre_hm(cfg.input_h, cfg.input_w, cts.to(torch.int32),
                             radius,
                             torch.ones_like(radius, dtype=torch.float32),
                             use_track)

    def _one(self, frames, carried, trans):
        """One frame of every stream: (S, h, w, 3) uint8 -> the packed
        (S, K, 13) rows; writes the carried buffers in place."""
        cfg = self.cfg
        inv_trans_input, trans_input, inv_trans_output = trans
        state, pre, fresh = carried
        images = torch.cat([
            preprocess_frame(f, inv_trans_input, cfg.input_h, cfg.input_w,
                             self.mean, self.std, self.warp_precision)
            for f in frames])
        pre_in = torch.where(fresh[:, None, None, None], images, pre)
        pre_hm = self._pre_hm(state, trans_input)

        out = self.model(images, pre_in if cfg.pre_img else None,
                         pre_hm if cfg.pre_hm else None)[-1]
        dets = generic_decode(sigmoid_output(out), cfg.K, cfg.num_classes)

        # output grid -> image coordinates
        scores = dets["scores"]
        clses = dets["clses"].to(torch.int32) + 1
        cts_out = dets["cts"]
        cts_img = _affine_pts(cts_out, inv_trans_output)
        tracking_img = _affine_pts(dets["tracking"] + cts_out,
                                   inv_trans_output) - cts_img
        # the amodal boxes where the net has ltrb_amodal (decode puts them
        # in "bboxes"), so the tracks and the next frame's pre_hm are
        # drawn from them (JAX engine/fused.py:254, :623)
        bb = dets["bboxes"]
        bboxes_img = torch.cat([_affine_pts(bb[..., 0:2], inv_trans_output),
                                _affine_pts(bb[..., 2:4], inv_trans_output)],
                               dim=-1)

        new_state, assoc = dt.step(
            state, scores, clses, cts_img, tracking_img, bboxes_img,
            cfg.out_thresh, cfg.new_thresh, cfg.max_age)
        for dst, src in zip(state, new_state):
            dst.copy_(src)
        pre.copy_(images)
        fresh.fill_(False)
        return _pack_results(scores, clses, cts_img, tracking_img,
                             bboxes_img, assoc)

    @torch.no_grad()
    def _step(self, frames, carried, out, trans):
        """The eager step, the one function a graph captures: F frames
        (F, S, h, w, 3) uint8 in order -> ``out`` (F, S, K, 13); advances
        ``carried`` in place."""
        with full_float32(self.cfg.compute_dtype):
            for f in range(frames.shape[0]):
                out[f].copy_(self._one(frames[f], carried, trans))

    def _graph(self, shape) -> _Graph:
        """The graph of (F, S, h, w, 3) frames, captured at first use."""
        g = self._graphs.get(shape)
        if g is not None:
            return g
        trans = self._transforms(*shape[2:4])
        frames = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        out = torch.empty(shape[:2] + (self.cfg.K, 13), device=self.device)
        # warm-up on copies of the carried buffers, on the device's warm-up
        # stream
        scratch = self._carried.clone()
        side = warmup_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step(frames, scratch, out, trans)
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            self._step(frames, self._carried, out, trans)
        g = self._graphs[shape] = _Graph(graph, frames, out)
        return g

    def _advance(self, frames, lead) -> torch.Tensor:
        """``frames``: an array or tensor of F * S frames of one shape
        (``lead`` = (F, S)), stacked or as a sequence, on the host or the
        device. Runs them in order and returns the (F, S, K, 13) rows."""
        seq = frames if isinstance(frames, (list, tuple)) else None
        first = seq[0] if seq is not None else frames
        shape = tuple(lead) + tuple(first.shape[-3:])
        count = len(seq) if seq is not None else int(np.prod(
            first.shape[:-3]))
        if count != lead[0] * lead[1]:
            raise ValueError(f"expected {lead[0] * lead[1]} frames of "
                             f"(h, w, 3), got {count}")
        if self.device.type == "cpu":
            items = seq if seq is not None else [frames]
            host = torch.stack([torch.as_tensor(np.asarray(x)).reshape(
                (-1,) + shape[2:]) for x in items]).reshape(shape)
            out = torch.empty(shape[:2] + (self.cfg.K, 13))
            self._step(host, self._carried, out, self._transforms(
                *shape[2:4]))
        else:
            g = self._graph(shape)
            if torch.is_tensor(first) and first.device.type == "cuda":
                if seq is None:
                    g.frames.copy_(frames.reshape(shape))
                else:
                    g.frames.copy_(torch.stack(seq).reshape(shape))
            else:
                staging = self._staging.get(shape)
                if staging is None:
                    staging = self._staging[shape] = _Staging(shape)
                staging.copy(frames, g.frames)
            g.graph.replay()
            out = g.out.clone()
        self._fresh_host[:] = False
        return out


class FusedDetector(_Engine):
    """One stream. ``run(frame)`` enqueues one frame and returns its
    packed (K, 13) result on the device, its host copy started;
    ``fetch`` turns that into the host dict list. ``run_chunk`` advances
    F frames in one graph replay. ``plain_dcn=True`` runs the DCN layers
    through their plain PyTorch version instead of the kernel (the
    smoke's reference path). ``track_state`` is (1, T, ...) and
    ``pre_images`` (1, H, W, 3) or None before the first frame."""

    def __init__(self, cfg, params=None, batch_stats=None,
                 dataset_meta=None, device="cuda", plain_dcn: bool = False):
        super().__init__(cfg, 1, params, batch_stats, dataset_meta, device,
                         plain_dcn)

    def run(self, image) -> torch.Tensor:
        """Enqueue one uint8 (H, W, 3) frame (numpy or tensor); returns
        the packed (K, 13) float32 rows on the device."""
        out = self._advance([image], (1, 1))
        return _with_host_copy(out.view(self.cfg.K, 13))

    def run_chunk(self, frames) -> torch.Tensor:
        """Advance over F consecutive uint8 frames, a stacked (F, H, W, 3)
        array or tensor or a list of same-shaped frames, host or device,
        in one replay (JAX: a ``lax.scan``); returns the (F, K, 13) rows,
        equal to F ``run`` calls, their host copy started."""
        n = len(frames)
        out = self._advance(frames, (n, 1))
        return _with_host_copy(out.view(n, self.cfg.K, 13))

    @staticmethod
    def fetch(results: torch.Tensor, out_thresh: float) -> List[Dict]:
        """The packed rows as the host dict list; waits for this
        result's copy only."""
        return _fetch_one(_host(results), out_thresh)

    @staticmethod
    def fetch_chunk(results: torch.Tensor,
                    out_thresh: float) -> List[List[Dict]]:
        """A ``run_chunk`` result as one dict list per frame: one wait,
        one host array."""
        host = _host(results)
        return [_fetch_one(frame, out_thresh) for frame in host]


class MultiStreamDetector(_Engine):
    """S independent streams in one batched step (JAX
    ``MultiStreamDetector``, 2D tracking): the network runs at batch S,
    the tracker over an (S, T, ...) state; streams never interact.
    ``run(images)`` advances every stream by one frame and returns the
    (S, K, 13) rows; ``reset_stream(i)`` starts stream i over."""

    def __init__(self, cfg, streams, params=None, batch_stats=None,
                 dataset_meta=None, device="cuda"):
        super().__init__(cfg, streams, params, batch_stats, dataset_meta,
                         device)

    def reset_stream(self, i: int):
        """Stream i starts over (a video boundary): its slot of the
        static state and its fresh flag are written in stream order."""
        for t in self._carried.state:
            t[i].zero_()
        self._carried.fresh[i] = True
        self._fresh_host[i] = True

    def run(self, images) -> torch.Tensor:
        """S same-shaped uint8 frames (a sequence, or stacked (S, H, W,
        3)), host or device -> the (S, K, 13) rows on the device, their
        host copy started."""
        out = self._advance(images, (1, self.streams))
        return _with_host_copy(out.view(self.streams, self.cfg.K, 13))

    @staticmethod
    def fetch_stream(results: torch.Tensor, stream: int,
                     out_thresh: float) -> List[Dict]:
        """One stream's rows, as ``FusedDetector.fetch``."""
        return _fetch_one(_host(results)[stream], out_thresh)

    @staticmethod
    def fetch_all(results: torch.Tensor,
                  out_thresh: float) -> List[List[Dict]]:
        """Every stream's rows: one wait, one host array."""
        return [_fetch_one(rows, out_thresh) for rows in _host(results)]

    def fetch_all_full(self, results, out_thresh):
        _device_extras()

    def set_calib(self, calib):
        _device_extras()


def _device_extras(*args):
    """The ddd/pose columns of the packed row: not ported."""
    raise NotImplementedError("the ddd/pose extras of the serving engine "
                              "(set_calib, fetch_all_full, _device_extras) "
                              "are not ported yet (ROADMAP A9)")


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
