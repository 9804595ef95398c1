"""JAX's MOTA on chip_smoke.py's synthetic clip: the reference numbers
of the smoke's `mota` phase.

Runs the JAX package's FusedDetector on the CPU over `synth_clip`'s
frames (1080p, warped to 544x960) with the committed checkpoints at
dla_node "dcn_local1" (assets/selftest_local1_fp16.ckpt) and "dcn"
(assets/selftest_dcn_fp16.ckpt), both float32, and scores the active
tracks against the clip's boxes (object index = track id) with the JAX
package's CLEAR-MOT accumulator. Prints one JSON object per node.

Not a collected test (it imports JAX): run it from the repository root,

    JAX_PLATFORMS=cpu python3 tests/mota_reference.py [--frames N]

and copy the printed numbers into chip_smoke.py's MOTA_REFERENCE.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NODES = (("dcn_local1", "selftest_local1_fp16.ckpt"),
         ("dcn", "selftest_dcn_fp16.ckpt"))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--nodes", default="dcn_local1,dcn")
    args = p.parse_args(argv)

    from bench import _mot_meta, load_ckpt
    from chip_smoke import synth_clip
    from centertrack_tpu.config import Config, parse_task, set_heads
    from centertrack_tpu.engine.fused import FusedDetector
    from centertrack_tpu.eval.mot_metrics import MOTAccumulator

    meta = _mot_meta()
    frames, boxes = synth_clip(args.frames, seed=0)
    gt_xywh = np.concatenate([boxes[..., :2], boxes[..., 2:] - boxes[..., :2]],
                             -1)
    for node, ckpt in NODES:
        if node not in args.nodes.split(","):
            continue
        cfg = set_heads(parse_task(Config(
            task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
            max_age=3, dla_node=node, compute_dtype="float32")), meta)
        params, batch_stats = load_ckpt(os.path.join(ROOT, "assets", ckpt))
        det = FusedDetector(cfg, params=params, batch_stats=batch_stats,
                            dataset_meta=meta)
        acc = MOTAccumulator()
        t0 = time.time()
        for f, frame in enumerate(frames):
            rows = [r for r in FusedDetector.fetch(det.run(frame),
                                                   cfg.out_thresh)
                    if r["active"]]
            hyp = np.array([[*r["bbox"][:2], r["bbox"][2] - r["bbox"][0],
                             r["bbox"][3] - r["bbox"][1]] for r in rows],
                           np.float64).reshape(-1, 4)
            acc.update(list(range(len(gt_xywh[f]))), gt_xywh[f],
                       [r["tracking_id"] for r in rows], hyp)
        m = acc.metrics()
        print(json.dumps({
            "node": node, "frames": args.frames,
            "seconds": round(time.time() - t0, 1),
            **{k: m[k] for k in ("mota", "idf1", "num_false_positives",
                                 "num_misses", "num_switches",
                                 "num_objects", "num_matches")}}),
            flush=True)


if __name__ == "__main__":
    main()
