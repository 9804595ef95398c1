"""Image-folder demo (reference: src/demo.py; JAX:
centertrack_tpu/cli/demo.py).

Usage:
  python -m centertrack_tpu_torch.cli.demo tracking,ddd --demo frames/ \
      --load_model assets/selftest_ddd_fp16.ckpt --dla_node dcn_local1 \
      --pre_hm [--fused | --chunk F] [--save_results]

``--demo`` is an image file or a folder of them (jpg, jpeg, png, webp,
read by utils/image_io in name order). The dataset defaults from the
task (tracking,ddd -> nuscenes, tracking,multi_pose -> coco_hp). Engines:
the host Detector by default (the reference's loop); ``--fused``
FusedDetector a frame at a time, each frame's results read one frame
later; ``--chunk F`` FusedDetector.run_chunk over F frames a call,
results up to 2F - 1 frames late. ``--save_results`` writes
demo_results_<task>.json in the working directory, keyed by the 1-based
frame index. Video files, the webcam and ``--save_video`` need a video
codec and drawing, which are not ported (ROADMAP A14). ``--device cpu``
runs on the CPU; the default is the card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from centertrack_tpu_torch.cli.opts import parse_demo
from centertrack_tpu_torch.cli.test import _jsonable
from centertrack_tpu_torch.engine.detector import Detector
from centertrack_tpu_torch.utils import image_io

IMAGE_EXT = ["jpg", "jpeg", "png", "webp"]
VIDEO_EXT = ["mp4", "mov", "avi", "mkv"]


class _FusedRunner:
    """FusedDetector behind the demo loop's ``Detector.run`` contract:
    each frame's results are read one frame later, so the copy overlaps
    the next frame's step. A result carries the 1-based index of its
    frame ('frame', None while the pipeline fills); ``flush`` returns
    the last one."""

    def __init__(self, fused, cfg):
        self.fused = fused
        self.cfg = cfg
        self._pending = None
        self.emitted = 0

    def run(self, img, meta=None):
        t0 = time.time()
        lazy = self.fused.run(img)
        prev, self._pending = self._pending, lazy
        if prev is not None:
            self.emitted += 1
            results = self.fused.fetch_full(prev, self.cfg.out_thresh)
            frame = self.emitted
        else:
            results, frame = [], None
        dt = time.time() - t0
        return {"results": results, "frame": frame, "tot": dt, "pre": 0.0,
                "net": dt, "post": 0.0, "track": 0.0}

    def flush(self):
        """{frame index: results} of the frame still in flight."""
        out = {}
        if self._pending is not None:
            self.emitted += 1
            out[self.emitted] = self.fused.fetch_full(self._pending,
                                                      self.cfg.out_thresh)
            self._pending = None
        return out


class _ChunkRunner:
    """FusedDetector.run_chunk behind the demo loop: F frames are
    buffered and advanced in one call, their results read a chunk later
    and handed back one a frame, each with its 1-based frame index."""

    def __init__(self, fused, cfg, chunk):
        self.fused = fused
        self.cfg = cfg
        self.chunk = int(chunk)
        self._buf = []
        self._ready = []
        self._pending = None
        self.emitted = 0

    def _dispatch(self):
        lazy = self.fused.run_chunk(np.stack(self._buf))
        self._buf = []
        if self._pending is not None:
            self._ready.extend(self.fused.fetch_chunk_full(
                self._pending, self.cfg.out_thresh))
        self._pending = lazy

    def run(self, img, meta=None):
        t0 = time.time()
        self._buf.append(img)
        if len(self._buf) == self.chunk:
            self._dispatch()
        if self._ready:
            results = self._ready.pop(0)
            self.emitted += 1
            frame = self.emitted
        else:
            results, frame = [], None
        dt = time.time() - t0
        return {"results": results, "frame": frame, "tot": dt, "pre": 0.0,
                "net": dt, "post": 0.0, "track": 0.0}

    def flush(self):
        """{frame index: results} of every frame not yet returned."""
        if self._buf:
            self._dispatch()
        if self._pending is not None:
            self._ready.extend(self.fused.fetch_chunk_full(
                self._pending, self.cfg.out_thresh))
            self._pending = None
        out = {}
        for res in self._ready:
            self.emitted += 1
            out[self.emitted] = res
        self._ready = []
        return out


def _frames(path):
    """The image files of ``path`` (a file or a folder), in name order."""
    ext = path[path.rfind(".") + 1:].lower()
    if path == "webcam" or ext in VIDEO_EXT:
        raise NotImplementedError(
            f"--demo {path!r}: video and webcam input need a video codec, "
            f"which is not ported (ROADMAP A14); give an image folder")
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if f.split(".")[-1].lower() in IMAGE_EXT)
    return [path]


def demo(cfg, args):
    """Runs the demo and returns {frame index: results}."""
    if args.save_video:
        raise NotImplementedError("--save_video draws and encodes video, "
                                  "which is not ported (ROADMAP A14)")
    frames = _frames(args.demo)
    device = getattr(args, "device", "cuda")
    chunk = int(getattr(args, "chunk", 0) or 0)
    if chunk > 1 or args.fused:
        from centertrack_tpu_torch.engine.fused import FusedDetector
        fused = FusedDetector(cfg, device=device)
        detector = (_ChunkRunner(fused, cfg, chunk) if chunk > 1
                    else _FusedRunner(fused, cfg))
    else:
        detector = Detector(cfg, device=device)
    results = {}
    timing = []
    for cnt, path in enumerate(frames, 1):
        ret = detector.run(image_io.read(path))
        # the lagged engines name the frame their results belong to
        frame_idx = ret.get("frame", cnt)
        if frame_idx is not None:
            results[frame_idx] = ret["results"]
        timing.append(ret["tot"])
        print(f"frame {cnt} |" + "".join(
            f" {k} {ret[k]:.3f}s" for k in
            ("tot", "pre", "net", "post", "track") if k in ret))
        if cfg.num_iters > 0 and cnt >= cfg.num_iters:
            break
    if hasattr(detector, "flush"):
        results.update(detector.flush())
    if args.save_results:
        path = f"demo_results_{cfg.task.replace(',', '_')}.json"
        with open(path, "w") as f:
            json.dump({k: [_jsonable(it) for it in v]
                       for k, v in results.items()}, f)
        print(f"results saved to {path}")
    if len(timing) > 2:
        # without the first two frames (graph capture, warm-up)
        print(f"avg fps (excl. warmup): {1.0 / np.mean(timing[2:]):.1f}")
    return results


def main(argv=None):
    cfg, args = parse_demo(argv)
    if args.demo == "":
        print("usage: demo.py <task> --demo <image or folder>")
        sys.exit(1)
    return demo(cfg, args)


if __name__ == "__main__":
    main()
