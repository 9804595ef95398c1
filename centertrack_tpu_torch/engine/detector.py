"""The host per-frame detection + tracking loop (reference:
src/lib/detector.py; JAX: centertrack_tpu/engine/detector.py:37-411).

One eager step a frame on the device:
  uint8 frame -> affine warp + normalize  (ops/warp.preprocess_frame; with
                 its mirror under flip_test, a batch of 2)
  -> pre_hm drawn from the host tracker's tracks (ops/gaussian.
     render_pre_hm: the splat_pre_hm kernel on maps past 128 x 128),
     zeroed under zero_pre_hm, mirrored under flip_test
  -> the network and sigmoid_output, then flip_merge under flip_test
  -> generic_decode (zero_tracking)
  -> NMS under nms (ops/nms.batched_nms: the nms_keep kernel), the
     suppressed scores zeroed and the rows re-sorted by score
and one copy of the (1, K, ...) arrays to the host. Post-process
(engine/post_process.py) and association (engine/tracker.py: greedy or
Hungarian, private or public detections) run on the host, as the
reference's do. The previous frame's network input stays on the device.

This is the reference's protocol; the serving engine (engine/fused.py)
is the sync-free one. Frames may change size from one video to the next
(keep_res sizes the input per frame), so nothing is captured: the step
is an eager function per (frame shape, input size).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from centertrack_tpu_torch.data.generic import gaussian_radius
from centertrack_tpu_torch.engine.post_process import generic_post_process
from centertrack_tpu_torch.engine.tracker import Tracker
from centertrack_tpu_torch.models.model import (create_model, load_model,
                                                params_from_jax)
from centertrack_tpu_torch.ops.affine import (affine_transform,
                                              get_affine_transform,
                                              invert_affine)
from centertrack_tpu_torch.ops.decode import generic_decode, sigmoid_output
from centertrack_tpu_torch.ops.gaussian import render_pre_hm
from centertrack_tpu_torch.ops.nms import batched_nms
from centertrack_tpu_torch.ops.warp import (preprocess_frame,
                                            warp_precision_for)
from centertrack_tpu_torch.utils import image_io
from centertrack_tpu_torch.utils.precision import full_float32


def _swap(n: int, flip_idx) -> list:
    perm = list(range(n))
    for a, b in flip_idx:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def flip_merge(output: Dict[str, torch.Tensor],
               flip_idx: Tuple[Tuple[int, int], ...]
               ) -> Dict[str, torch.Tensor]:
    """Average a [normal; flipped] batch-2 output into batch 1
    (reference: detector.py:311-332; JAX detector.py:37-76). NHWC: W is
    axis 2."""
    average_flips = {"hm", "wh", "dep", "dim"}
    neg_average_flips = {"amodel_offset"}
    single_flips = {"ltrb", "nuscenes_att", "velocity", "ltrb_amodal", "reg",
                    "hp_offset", "rot", "tracking", "pre_hm"}
    out = {}
    for head, v in output.items():
        if head in average_flips:
            out[head] = (v[0:1] + v[1:2].flip(2)) / 2
        elif head in neg_average_flips:
            flipped = v[1:2].flip(2).clone()
            flipped[..., 0::2] *= -1
            out[head] = (v[0:1] + flipped) / 2
        elif head in single_flips:
            out[head] = v[0:1]
        elif head == "hps":
            # (reference: model/utils.py:41-50): flip W, negate x offsets,
            # swap left/right joint pairs
            flipped = v[1:2].flip(2)
            b, h, w, c = flipped.shape
            f = flipped.reshape(b, h, w, c // 2, 2).clone()
            f[..., 0] *= -1
            f = f[:, :, :, _swap(c // 2, flip_idx), :].reshape(b, h, w, c)
            out[head] = (v[0:1] + f) / 2
        elif head == "hm_hp":
            # (reference: model/utils.py:33-39)
            flipped = v[1:2].flip(2)
            out[head] = (v[0:1] + flipped[..., _swap(v.shape[3], flip_idx)]
                         ) / 2
        else:
            out[head] = v
    return out


def _to_host(dets: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The (B, K, ...) arrays on the host in one copy: packed as float64
    (exact for their float32 values and int indices), split after."""
    if not dets:
        return {}
    keys = list(dets)
    b, k = dets[keys[0]].shape[:2]
    flat = [dets[key].reshape(b, k, -1) for key in keys]
    host = torch.cat([f.to(torch.float64) for f in flat], 2).cpu().numpy()
    out, ofs = {}, 0
    for key, f in zip(keys, flat):
        n = f.shape[2]
        dtype = np.dtype(str(dets[key].dtype).replace("torch.", ""))
        out[key] = host[:, :, ofs:ofs + n].reshape(
            tuple(dets[key].shape)).astype(dtype)
        ofs += n
    return out


class Detector:
    """(reference: detector.py:24-458; JAX detector.py:79-411)

    ``params``/``batch_stats`` are the JAX package's trees; without them
    the net keeps its initialisation, or takes ``cfg.load_model``'s
    checkpoint merged onto it (with ``reset_hm`` / ``reuse_hm``). Without
    ``dataset_meta`` the meta is ``cfg.dataset``'s. Runs on ``device``
    ("cuda" by default; it raises without a GPU)."""

    def __init__(self, cfg, params=None, batch_stats=None,
                 dataset_meta=None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for but no GPU is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        if dataset_meta is None:
            from centertrack_tpu_torch.data.registry import get_dataset_meta
            dataset_meta = get_dataset_meta(cfg.dataset, cfg)
        self.dataset_meta = dataset_meta
        self.mean = torch.as_tensor(
            np.asarray(dataset_meta.mean, np.float32).reshape(3),
            device=self.device)
        self.std = torch.as_tensor(
            np.asarray(dataset_meta.std, np.float32).reshape(3),
            device=self.device)
        # the default camera's focal length (JAX detector.py:93-95)
        self.rest_focal_length = (
            getattr(dataset_meta, "rest_focal_length", 1200)
            if cfg.test_focal_length < 0 else cfg.test_focal_length)
        self.flip_idx = tuple(tuple(p) for p in
                              getattr(dataset_meta, "flip_idx", ()))

        self.model = create_model(cfg, self.device)
        if params is not None:
            self.model.load_state_dict(params_from_jax(params, batch_stats),
                                       strict=True)
        elif cfg.load_model:
            load_model(cfg.load_model, self.model, reset_hm=cfg.reset_hm,
                       reuse_hm=cfg.reuse_hm)
        self.warp_precision = warp_precision_for(cfg)

        self.pre_images = None      # device (B, H, W, 3), normalized
        self.tracker = Tracker(cfg)
        self.cnt = 0
        self.max_tracks = cfg.max_tracks
        self._step_fn = {}

    # ------------------------------------------------------------------
    def _warp(self, frame_u8, inv_trans, inp_height, inp_width):
        img = preprocess_frame(frame_u8, inv_trans, inp_height, inp_width,
                               self.mean, self.std, self.warp_precision)
        if self.cfg.flip_test:
            img = torch.cat([img, img.flip(2)])
        return img

    def _get_step_fn(self, in_shape, inp_height=None, inp_width=None):
        """The per-frame step for a raw-frame shape and network input
        size (JAX's jitted program per key; here an eager function)."""
        inp_height = inp_height or self.cfg.input_h
        inp_width = inp_width or self.cfg.input_w
        key = (tuple(in_shape), inp_height, inp_width)
        if key in self._step_fn:
            return self._step_fn[key]
        cfg = self.cfg
        use_pre_img = cfg.pre_img and cfg.tracking
        use_pre_hm = cfg.pre_hm and cfg.tracking

        @torch.no_grad()
        def step(frame_u8, inv_trans, pre_images, track_cts, track_radii,
                 track_valid):
            with full_float32(cfg.compute_dtype):
                images = self._warp(frame_u8, inv_trans, inp_height,
                                    inp_width)
                pre_hm = None
                if use_pre_hm:
                    hm = render_pre_hm(
                        inp_height, inp_width, track_cts[None],
                        track_radii[None],
                        torch.ones_like(track_radii,
                                        dtype=torch.float32)[None],
                        track_valid[None])
                    if cfg.zero_pre_hm:
                        hm = hm * 0
                    if cfg.flip_test:
                        hm = torch.cat([hm, hm.flip(2)])
                    pre_hm = hm
                out = self.model(images, pre_images if use_pre_img else None,
                                 pre_hm)[-1]
                out = sigmoid_output(out, cfg.depth_scale)
                if cfg.flip_test:
                    out = flip_merge(out, self.flip_idx)
                dets = generic_decode(out, cfg.K, cfg.num_classes,
                                      cfg.zero_tracking)
                if cfg.nms and "bboxes" in dets:
                    keep = batched_nms(dets["bboxes"], dets["scores"],
                                       dets["clses"])
                    dets["scores"] = torch.where(
                        keep, dets["scores"], torch.zeros_like(
                            dets["scores"]))
                    # post-process reads the rows as score-sorted (a
                    # prefix cut at out_thresh); suppression zeroed scores
                    # mid-array, so re-sort, ties in row order
                    order = torch.sort(dets["scores"], dim=1,
                                       descending=True, stable=True)[1]
                    dets = {
                        k: torch.gather(v, 1, order.reshape(
                            order.shape + (1,) * (v.dim() - 2)).expand(
                                v.shape))
                        for k, v in dets.items()}
            return images, dets

        self._step_fn[key] = step
        return step

    # ------------------------------------------------------------------
    def _transform_scale(self, image, scale: float = 1.0):
        """(reference: detector.py:175-204)"""
        cfg = self.cfg
        height, width = image.shape[0:2]
        new_height = int(height * scale)
        new_width = int(width * scale)
        if cfg.fix_short > 0:
            if height < width:
                inp_height = cfg.fix_short
                inp_width = (int(width / height * cfg.fix_short) + 63
                             ) // 64 * 64
            else:
                inp_height = (int(height / width * cfg.fix_short) + 63
                              ) // 64 * 64
                inp_width = cfg.fix_short
            c = np.array([width / 2, height / 2], dtype=np.float32)
            s = np.array([width, height], dtype=np.float32)
        elif cfg.fix_res:
            inp_height, inp_width = cfg.input_h, cfg.input_w
            c = np.array([new_width / 2.0, new_height / 2.0], np.float32)
            s = max(height, width) * 1.0
        else:
            inp_height = (new_height | cfg.pad) + 1
            inp_width = (new_width | cfg.pad) + 1
            c = np.array([new_width // 2, new_height // 2], np.float32)
            s = np.array([inp_width, inp_height], np.float32)
        return c, s, inp_width, inp_height, height, width

    def _get_default_calib(self, width, height):
        return np.array(
            [[self.rest_focal_length, 0, width / 2, 0],
             [0, self.rest_focal_length, height / 2, 0],
             [0, 0, 1, 0]], np.float32)

    def _trans_bbox(self, bbox, trans, width, height):
        """(reference: detector.py:242-251)"""
        bbox = np.array(bbox, dtype=np.float32).copy()
        bbox[:2] = affine_transform(bbox[:2], trans)
        bbox[2:] = affine_transform(bbox[2:], trans)
        bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, width - 1)
        bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, height - 1)
        return bbox

    def _track_arrays(self, trans_input, inp_width, inp_height):
        """Fixed-capacity (max_tracks,) arrays of the live tracks for the
        pre_hm render on the device (the reference drew the heatmap on the
        host: detector.py:254-290)."""
        t = self.max_tracks
        cts = np.zeros((t, 2), np.int32)
        radii = np.zeros((t,), np.int32)
        valid = np.zeros((t,), bool)
        n = 0
        for det in self.tracker.tracks:
            if det["score"] < self.cfg.pre_thresh or det["active"] == 0:
                continue
            bbox = self._trans_bbox(det["bbox"], trans_input, inp_width,
                                    inp_height)
            h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if h > 0 and w > 0 and n < t:
                radius = gaussian_radius((math.ceil(h), math.ceil(w)))
                ct = np.array([(bbox[0] + bbox[2]) / 2,
                               (bbox[1] + bbox[3]) / 2], np.float32)
                cts[n] = ct.astype(np.int32)
                radii[n] = max(0, int(radius))
                valid[n] = True
                n += 1
        return cts, radii, valid

    # ------------------------------------------------------------------
    def run(self, image_or_path, meta: Optional[Dict] = None) -> Dict:
        """Process one frame, a BGR uint8 (H, W, 3) array or an image
        path (reference: detector.py:55-172). ``meta`` may hold
        ``pre_dets`` (seeds the tracks at a sequence's first frame),
        ``cur_dets`` (the public detections, with ``public_det``) and
        ``calib``. Returns the tracked results and the stage times."""
        cfg = self.cfg
        meta = dict(meta or {})
        start = time.time()
        if isinstance(image_or_path, str):
            image = image_io.read(image_or_path)
        else:
            image = image_or_path
        load_time = time.time() - start

        scale = cfg.test_scales[0]
        assert len(cfg.test_scales) == 1, "multi_scale not supported!"

        t0 = time.time()
        c, s, inp_width, inp_height, height, width = \
            self._transform_scale(image, scale)
        trans_input = get_affine_transform(
            c, s, 0, [inp_width, inp_height])
        out_height = inp_height // cfg.down_ratio
        out_width = inp_width // cfg.down_ratio
        inv_trans_input = torch.as_tensor(
            invert_affine(trans_input).astype(np.float32),
            device=self.device)

        calib = (np.array(meta["calib"], np.float32)
                 if "calib" in meta
                 else self._get_default_calib(width, height))

        step = self._get_step_fn(image.shape, inp_height, inp_width)
        frame_dev = torch.as_tensor(np.ascontiguousarray(image)).to(
            self.device)

        # tracking state
        if cfg.tracking and self.pre_images is None:
            with torch.no_grad(), full_float32(cfg.compute_dtype):
                self.pre_images = self._warp(frame_dev, inv_trans_input,
                                             inp_height, inp_width)
            self.tracker.init_track(meta.get("pre_dets", []))
        track_cts, track_radii, track_valid = self._track_arrays(
            trans_input, inp_width, inp_height)
        pre_time = time.time() - t0

        t0 = time.time()
        pre_images = (self.pre_images if self.pre_images is not None
                      else torch.zeros(
                          (2 if cfg.flip_test else 1, inp_height,
                           inp_width, 3), device=self.device))
        if cfg.tracking and self.pre_images is not None and \
                tuple(self.pre_images.shape[1:3]) != (inp_height, inp_width):
            # keep_res sizes vary per image; the temporal model needs a
            # constant resolution within one tracked sequence
            raise ValueError(
                "input resolution changed mid-sequence "
                f"({tuple(self.pre_images.shape[1:3])} -> "
                f"{(inp_height, inp_width)}); call reset_tracking() at "
                "video boundaries or use fix_res")
        images, dets_dev = step(
            frame_dev, inv_trans_input, pre_images,
            torch.as_tensor(track_cts, device=self.device),
            torch.as_tensor(track_radii, device=self.device),
            torch.as_tensor(track_valid, device=self.device))
        dets = _to_host(dets_dev)
        net_time = time.time() - t0

        t0 = time.time()
        result = generic_post_process(
            cfg, dets, [c], [s], out_height, out_width, [calib])
        results = [d for d in result[0] if d["score"] > cfg.out_thresh]
        post_time = time.time() - t0

        t0 = time.time()
        if cfg.tracking:
            public_det = meta.get("cur_dets") if cfg.public_det else None
            results = self.tracker.step(results, public_det)
            self.pre_images = images
        track_time = time.time() - t0

        self.cnt += 1
        return {
            "results": results,
            "tot": time.time() - start, "load": load_time,
            "pre": pre_time, "net": net_time, "post": post_time,
            "track": track_time,
        }

    def show_results(self, image, results, save_dir: str = "debug_out",
                     prefix: str = "") -> None:
        """The reference's Debugger drawing (detector.py:402-452) needs
        cv2's drawing; not ported yet."""
        raise NotImplementedError("Detector.show_results needs the "
                                  "Debugger, which is not ported yet "
                                  "(ROADMAP A11)")

    def reset_tracking(self) -> None:
        """(reference: detector.py:455-458)"""
        self.tracker.reset()
        self.pre_images = None
