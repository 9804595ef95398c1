"""JAX's host Detector on chip_smoke.py's synthetic clip: the reference
numbers of the smoke's `detector` phase.

Runs the JAX package's engine/detector.Detector on the CPU over
`synth_clip`'s frames (1080p, warped to 544x960) with the committed
checkpoint at dla_node "dcn_local1" (assets/selftest_local1_fp16.ckpt),
float32, in each of chip_smoke.DETECTOR_VARIANTS (private greedy,
Hungarian, public detections from chip_smoke.public_dets, flip_test with
nms), and scores the active tracks against the clip's boxes (object
index = track id) with the JAX package's CLEAR-MOT accumulator. The
variants that differ only in the host tracker share one compiled step.
Prints one JSON object per variant.

Not a collected test (it imports JAX): run it from the repository root,

    JAX_PLATFORMS=cpu python3 tests/detector_reference.py [--frames N]

and copy the printed numbers into chip_smoke.py's DETECTOR_REFERENCE.
"""

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--variants", default="private,hungarian,public,flip_nms")
    args = p.parse_args(argv)

    from bench import _mot_meta, load_ckpt
    from chip_smoke import (CKPT, DETECTOR_FLAGS, DETECTOR_VARIANTS,
                            detector_metas, synth_clip)
    from centertrack_tpu.config import Config, parse_task, set_heads
    from centertrack_tpu.engine.detector import Detector
    from centertrack_tpu.engine.tracker import Tracker
    from centertrack_tpu.eval.mot_metrics import MOTAccumulator

    meta = _mot_meta()
    frames, boxes = synth_clip(args.frames, seed=0)
    gt_xywh = np.concatenate([boxes[..., :2], boxes[..., 2:] - boxes[..., :2]],
                             -1)
    params, batch_stats = load_ckpt(CKPT)
    shared = None
    for name in args.variants.split(","):
        kw = DETECTOR_VARIANTS[name]
        cfg = set_heads(parse_task(Config(**DETECTOR_FLAGS, **kw)), meta)
        if kw.get("flip_test") or kw.get("nms"):
            det = Detector(cfg, params, batch_stats, meta)
        else:
            # the host tracker's options leave the compiled step as it is
            if shared is None:
                shared = Detector(cfg, params, batch_stats, meta)
            det = shared
            det.cfg = cfg
            det.tracker = Tracker(cfg)
            det.reset_tracking()
        metas = detector_metas(name, boxes)
        acc = MOTAccumulator()
        t0 = time.time()
        for f, frame in enumerate(frames):
            ret = det.run(frame, copy.deepcopy(metas[f]))
            rows = [r for r in copy.deepcopy(ret["results"]) if r["active"]]
            hyp = np.array([[*r["bbox"][:2], r["bbox"][2] - r["bbox"][0],
                             r["bbox"][3] - r["bbox"][1]] for r in rows],
                           np.float64).reshape(-1, 4)
            acc.update(list(range(len(gt_xywh[f]))), gt_xywh[f],
                       [r["tracking_id"] for r in rows], hyp)
        m = acc.metrics()
        print(json.dumps({
            "variant": name, "frames": args.frames,
            "seconds": round(time.time() - t0, 1),
            **{k: m[k] for k in ("mota", "idf1", "num_false_positives",
                                 "num_misses", "num_switches",
                                 "num_objects", "num_matches")}}),
            flush=True)


if __name__ == "__main__":
    main()
