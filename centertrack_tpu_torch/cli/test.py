"""Benchmark evaluation entry point (reference: src/test.py; JAX:
centertrack_tpu/cli/test.py).

Runs a whole dataset split through the host Detector frame by frame
(tracking reset at each video's first frame), writes the results and
calls the dataset's evaluator; ``--multi_stream N`` tracks N videos at
once through MultiStreamDetector instead.

Usage (MOT17's recipe, experiments/mot17_half.sh:10-17):
  python -m centertrack_tpu_torch.cli.test tracking --exp_id mot17_half \
      --dataset mot --dataset_version 17halfval --pre_hm --ltrb_amodal \
      --track_thresh 0.4 --pre_thresh 0.5 --resume
  ... --public_det --load_results results_public.json

``--resume`` loads exp/<task>/<exp_id>/model_last.ckpt (cli/opts.py);
``--device cpu`` runs on the CPU, the default is the card.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from centertrack_tpu_torch.cli.opts import (args_to_config, build_parser,
                                            exp_dir)
from centertrack_tpu_torch.config import finalize
from centertrack_tpu_torch.data.datasets import get_dataset
from centertrack_tpu_torch.engine.detector import Detector
from centertrack_tpu_torch.utils import image_io


def load_external_results(path, dataset):
    """Public-detection / preloaded results json
    (reference: test.py:65-72, 101-107)."""
    with open(path) as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}


def _save_results(cfg, args, results, save_dir):
    if args.save_results:
        path = os.path.join(
            save_dir, f"save_results_{cfg.test_dataset}"
                      f"{cfg.dataset_version}.json")
        with open(path, "w") as f:
            json.dump({k: [_jsonable(d) for d in v]
                       for k, v in results.items()}, f)
        print("results saved to", path)


def test(cfg, args):
    dataset_cls = get_dataset(cfg.test_dataset)
    split = "val" if not cfg.trainval else "test"
    dataset = dataset_cls(cfg, split)
    detector = Detector(cfg, dataset_meta=dataset_cls,
                        device=getattr(args, "device", "cuda"))

    load_results = {}
    if args.load_results:
        load_results = load_external_results(args.load_results, dataset)
        print(f"loaded results for {len(load_results)} images")

    results = {}
    num_iters = len(dataset) if cfg.num_iters < 0 else cfg.num_iters
    avg_time = {}

    # image read-ahead on two threads (the reference overlaps reading
    # with the network through a DataLoader worker, test.py:53-76)
    pool = ThreadPoolExecutor(2)

    def read(ind):
        info = dataset.coco.loadImgs([dataset.images[ind]])[0]
        return image_io.read(os.path.join(dataset.img_dir,
                                          info["file_name"]))

    pending = {0: pool.submit(read, 0)} if num_iters > 0 else {}

    for ind in range(num_iters):
        img_id = dataset.images[ind]
        img_info = dataset.coco.loadImgs([img_id])[0]
        img_path = os.path.join(dataset.img_dir, img_info["file_name"])

        meta = {}
        if "calib" in img_info:
            meta["calib"] = img_info["calib"]
        # video boundary: reset tracking, inject seed dets
        # (reference: test.py:90-107)
        if cfg.tracking and img_info.get("frame_id", 1) == 1:
            detector.reset_tracking()
            if img_id in load_results:
                meta["pre_dets"] = load_results[img_id]
        if cfg.public_det and img_id in load_results:
            meta["cur_dets"] = load_results[img_id]

        image = pending.pop(ind).result() if ind in pending else None
        if ind + 1 < num_iters:
            pending[ind + 1] = pool.submit(read, ind + 1)
        ret = detector.run(image if image is not None else img_path,
                           meta)
        results[img_id] = ret["results"]
        for k in ("tot", "pre", "net", "post", "track"):
            avg_time[k] = avg_time.get(k, 0.0) + ret[k]
        if ind % 50 == 0:
            msg = f"{ind}/{num_iters} |" + "".join(
                f" {k} {v / (ind + 1):.3f}s" for k, v in avg_time.items())
            print(msg)
    pool.shutdown()

    save_dir = exp_dir(cfg)
    os.makedirs(save_dir, exist_ok=True)
    _save_results(cfg, args, results, save_dir)
    return dataset.run_eval(results, save_dir)


def _group_videos(cfg, dataset):
    """Split the dataset's image list into videos (boundary =
    frame_id 1, reference: test.py:90-100), then bucket videos by
    frame resolution: one batched step takes frames of one shape."""
    videos = []
    for ind in range(len(dataset)):
        img_id = dataset.images[ind]
        info = dataset.coco.loadImgs([img_id])[0]
        path = os.path.join(dataset.img_dir, info["file_name"])
        if info.get("frame_id", 1) == 1 or not videos:
            videos.append([])
        videos[-1].append((img_id, path, info))
    by_res = {}
    for vid in videos:
        info = vid[0][2]
        h, w = info.get("height"), info.get("width")
        if not h or not w:
            h, w = image_io.read(vid[0][1]).shape[:2]
        by_res.setdefault((int(h), int(w)), []).append(vid)
    return by_res


def test_multistream(cfg, args, n_streams):
    """Throughput eval: N videos tracked concurrently through one
    batched step (engine/fused.MultiStreamDetector, the device tracker),
    results fetched with a pipeline lag (reference: src/test.py:53-130)."""
    import collections

    from centertrack_tpu_torch.engine.fused import MultiStreamDetector

    assert cfg.tracking, "--multi_stream requires a tracking task"
    assert not args.load_results and not cfg.public_det, \
        "--multi_stream is incompatible with external detections"
    dataset_cls = get_dataset(cfg.test_dataset)
    split = "val" if not cfg.trainval else "test"
    dataset = dataset_cls(cfg, split)
    by_res = _group_videos(cfg, dataset)

    pool = ThreadPoolExecutor(2)
    results = {}
    t0 = time.time()
    n_frames = 0
    for (h, w), vids in sorted(by_res.items()):
        s = min(n_streams, len(vids))
        det = MultiStreamDetector(cfg, s, dataset_meta=dataset_cls,
                                  device=getattr(args, "device", "cuda"))
        queue = collections.deque(vids)
        cur = [queue.popleft() for _ in range(s)]
        pos = [0] * s
        last = [None] * s  # last host frame per stream (tail padding)
        pend = collections.deque()
        lag = 4

        def next_stack():
            """One frame per stream; returns (stack, ids) or None when
            every stream is drained. Streams that finish a video pull
            the next one (tracking reset); drained streams re-feed
            their last frame and their results are discarded."""
            ids = [None] * s
            frames = [None] * s
            alive = False
            for i in range(s):
                if cur[i] is not None and pos[i] >= len(cur[i]):
                    if queue:
                        cur[i] = queue.popleft()
                        pos[i] = 0
                        det.reset_stream(i)
                    else:
                        cur[i] = None
                if cur[i] is None:
                    frames[i] = last[i]
                    continue
                img_id, path, _ = cur[i][pos[i]]
                frames[i] = pool.submit(image_io.read, path)
                ids[i] = img_id
                pos[i] += 1
                alive = True
            if not alive:
                return None
            for i in range(s):
                if hasattr(frames[i], "result"):
                    frames[i] = frames[i].result()
                last[i] = frames[i]
            return np.stack(frames), ids

        def drain():
            lazy, ids = pend.popleft()
            per_stream = MultiStreamDetector.fetch_all(
                lazy, cfg.out_thresh)
            for i, img_id in enumerate(ids):
                if img_id is not None:
                    results[img_id] = per_stream[i]

        while True:
            nxt = next_stack()
            if nxt is None:
                break
            stack, ids = nxt
            pend.append((det.run(stack), ids))
            n_frames += sum(x is not None for x in ids)
            if len(pend) > lag:
                drain()
            if n_frames % 200 < s:
                dt = time.time() - t0
                print(f"{n_frames} frames | {n_frames / dt:.1f} fps "
                      f"aggregate ({s} streams @ {w}x{h})")
        while pend:
            drain()
    pool.shutdown()

    dt = time.time() - t0
    print(f"done: {n_frames} frames in {dt:.1f}s "
          f"({n_frames / max(dt, 1e-9):.1f} fps aggregate)")
    save_dir = exp_dir(cfg)
    os.makedirs(save_dir, exist_ok=True)
    _save_results(cfg, args, results, save_dir)
    return dataset.run_eval(results, save_dir)


def _jsonable(d):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else
                float(v) if isinstance(v, (np.floating,)) else
                int(v) if isinstance(v, (np.integer,)) else v)
            for k, v in d.items()}


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    dataset_cls = get_dataset(cfg.dataset)
    cfg = finalize(cfg, dataset_cls)
    if getattr(args, "multi_stream", 0) > 0:
        return test_multistream(cfg, args, args.multi_stream)
    return test(cfg, args)


if __name__ == "__main__":
    main()
