"""JAX's numbers on chip_smoke.py's ddd and pose clips: the reference of
the smoke's `ddd` and `pose` phases.

Writes each task's held-out clip with the JAX selftest's generator
(tools/selftest.make_dataset_ddd / make_dataset_pose, one video of
TASK_FRAMES frames, seed 99, as bench.py:203-235 does) and runs the JAX
package on the CPU over it at float32 with the committed checkpoint
(dla_node "dcn_local1": assets/selftest_ddd_fp16.ckpt at 448x800 with 10
classes and track_thresh 0.1, as bench.py:377-396;
assets/selftest_pose_fp16.ckpt at 512x512, as bench.py:398-422), the
camera set from the clip's records:

- its host Detector (the reference's per-frame protocol), whose active
  tracks' 2D boxes are scored against the clip's annotations (track ids
  as object ids) with the JAX package's CLEAR-MOT accumulator: the
  MOTA, IDF1 and counts printed;
- its FusedDetector, whose fetch_full rows above out_thresh of frames
  1-5 are kept, and whose own CLEAR-MOT is printed under "fused". On
  the CPU backend JAX's device tracker keeps an aged copy of a track
  matched from slot 0 (ROADMAP C3), which gives a later detection of
  the ddd clip a second track's id (frame 13); the host Detector's
  tracker has no such fault, and the rows kept end before it.

Prints one JSON object per task.

Not a collected test (it imports JAX): run it from the repository root,

    JAX_PLATFORMS=cpu python3 tests/task_reference.py [--tasks ddd,pose]

and copy the printed objects into chip_smoke.py's TASK_REFERENCE.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASK_FRAMES = 24
ROW_FRAMES = 5
# per task: the JAX config, the meta, the checkpoint, the generator
TASKS = {
    "ddd": dict(task="tracking,ddd", num_classes=10, track_thresh=0.1,
                resolution=(448, 800), ckpt="selftest_ddd_fp16.ckpt",
                make="make_dataset_ddd"),
    "pose": dict(task="tracking,multi_pose", num_classes=-1,
                 track_thresh=0.3, resolution=(512, 512),
                 ckpt="selftest_pose_fp16.ckpt", make="make_dataset_pose"),
}
COUNTS = ("mota", "idf1", "num_false_positives", "num_misses",
          "num_switches", "num_objects", "num_matches")
# the fetch_full keys kept per row
ROW_KEYS = ("score", "class", "ct", "bbox", "tracking_id", "active", "dep",
            "alpha", "dim", "loc", "rot_y", "hps", "kps_score")


def meta_of(name):
    spec = TASKS[name]

    class Meta:
        num_categories = 10 if name == "ddd" else 1
        default_resolution = list(spec["resolution"])
        num_joints = 17
        rest_focal_length = 1200
        flip_idx = []
        mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
        std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)
    return Meta


def _num(x):
    """float32 values as Python floats with 8 significant digits."""
    a = np.asarray(x, np.float64)
    if a.ndim == 0:
        return float(f"{float(a):.8g}")
    return [float(f"{v:.8g}") for v in a.ravel()]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tasks", default="ddd,pose")
    args = p.parse_args(argv)

    import cv2
    from bench import load_ckpt
    from centertrack_tpu.config import Config, parse_task, set_heads
    from centertrack_tpu.engine.detector import Detector
    from centertrack_tpu.engine.fused import FusedDetector
    from centertrack_tpu.eval.mot_metrics import MOTAccumulator
    from centertrack_tpu.tools import selftest

    for name in args.tasks.split(","):
        spec = TASKS[name]
        root = tempfile.mkdtemp(prefix=f"ct_taskref_{name}_")
        ann_path, img_dir = getattr(selftest, spec["make"])(
            root, num_videos=1, frames=TASK_FRAMES, seed=99)
        with open(ann_path) as f:
            db = json.load(f)
        images = sorted(db["images"], key=lambda im: im["frame_id"])
        meta = meta_of(name)
        cfg = set_heads(parse_task(Config(
            task=spec["task"], pre_hm=True, track_thresh=spec["track_thresh"],
            new_thresh=spec["track_thresh"], max_age=3,
            dla_node="dcn_local1", compute_dtype="float32",
            num_classes=spec["num_classes"])), meta)
        params, batch_stats = load_ckpt(os.path.join(ROOT, "assets",
                                                     spec["ckpt"]))
        calib = images[0].get("calib")
        fused = FusedDetector(cfg, params=params, batch_stats=batch_stats,
                              dataset_meta=meta)
        host = Detector(cfg, params=params, batch_stats=batch_stats,
                        dataset_meta=meta)
        if calib is not None:
            fused.set_calib(np.array(calib, np.float32))
        acc, fused_acc = MOTAccumulator(), MOTAccumulator()
        rows = []
        t0 = time.time()
        for f, im in enumerate(images):
            frame = cv2.imread(os.path.join(img_dir, im["file_name"]))
            anns = [a for a in db["annotations"] if a["image_id"] == im["id"]]
            gt = np.array([a["bbox"] for a in anns], np.float64).reshape(-1, 4)
            items = fused.fetch_full(fused.run(frame), cfg.out_thresh)
            tracks = host.run(frame, {} if calib is None else
                              {"calib": calib})["results"]
            for a, results in ((acc, tracks), (fused_acc, items)):
                active = [r for r in results if r["active"]]
                hyp = np.array([[*r["bbox"][:2], r["bbox"][2] - r["bbox"][0],
                                 r["bbox"][3] - r["bbox"][1]]
                                for r in active], np.float64).reshape(-1, 4)
                a.update([a_["track_id"] for a_ in anns], gt,
                         [r["tracking_id"] for r in active], hyp)
            if f < ROW_FRAMES:
                ids = [r["tracking_id"] for r in items]
                assert len(set(ids)) == len(ids), f"frame {f + 1}: {ids}"
                rows.append([{k: _num(r[k]) for k in ROW_KEYS if k in r}
                             for r in items])
        m, fm = acc.metrics(), fused_acc.metrics()
        print(json.dumps({
            "task": name, "frames": TASK_FRAMES,
            "input": list(spec["resolution"]),
            "out_thresh": cfg.out_thresh,
            "seconds": round(time.time() - t0, 1),
            **{k: m[k] for k in COUNTS},
            "fused": {k: fm[k] for k in COUNTS},
            "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
