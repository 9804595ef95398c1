"""MOTChallenge directory evaluation (JAX: eval/mot_eval.py;
reference: src/tools/eval_motchallenge.py; same file layout:
<GT_ROOT>/<SEQ>/gt/gt{gt_type}.txt vs <RES>/<SEQ>.txt).
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from centertrack_tpu_torch.eval.mot_metrics import (MOTAccumulator,
                                                    combine_metrics)


def load_mot_txt(path: str, min_confidence: Optional[float] = None):
    """frame,id,x,y,w,h,conf,... -> {frame: (ids, boxes)}
    (mot15-2D format; min_confidence filters gt rows, matching
    mm.io.loadtxt(min_confidence=1))."""
    frames = defaultdict(lambda: ([], []))
    if not os.path.exists(path):
        return frames
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    if data.size == 0:
        return frames
    for row in data:
        if min_confidence is not None and row[6] < min_confidence:
            continue
        f = int(row[0])
        frames[f][0].append(int(row[1]))
        frames[f][1].append(row[2:6].astype(np.float64))
    return frames


def evaluate_seq(gt_path: str, res_path: str) -> MOTAccumulator:
    gt = load_mot_txt(gt_path, min_confidence=1)
    ts = load_mot_txt(res_path)
    acc = MOTAccumulator()
    all_frames = sorted(set(gt.keys()) | set(ts.keys()))
    for f in all_frames:
        gt_ids, gt_boxes = gt.get(f, ([], []))
        hyp_ids, hyp_boxes = ts.get(f, ([], []))
        acc.update(gt_ids, np.array(gt_boxes).reshape(-1, 4),
                   hyp_ids, np.array(hyp_boxes).reshape(-1, 4))
    return acc


def evaluate_mot_dir(gt_root: str, results_dir: str,
                     gt_type: str = "") -> Dict[str, Dict[str, float]]:
    """Evaluate every <seq>.txt under results_dir against
    <gt_root>/<seq>/gt/gt{gt_type}.txt. Returns {seq: metrics} +
    'OVERALL'."""
    ts_files = [f for f in glob.glob(os.path.join(results_dir, "*.txt"))
                if not os.path.basename(f).startswith("eval")]
    accs, summary = {}, {}
    for ts_path in sorted(ts_files):
        seq = os.path.splitext(os.path.basename(ts_path))[0]
        gt_path = os.path.join(gt_root, seq, "gt", f"gt{gt_type}.txt")
        if not os.path.exists(gt_path):
            print(f"No ground truth for {seq}, skipping.")
            continue
        acc = evaluate_seq(gt_path, ts_path)
        accs[seq] = acc
        summary[seq] = acc.metrics()
    if not accs:
        print("no sequences evaluated")
        return {}
    overall = combine_metrics(summary, accs)
    summary["OVERALL"] = overall
    _print_summary(summary)
    return summary


def _print_summary(summary: Dict[str, Dict[str, float]]) -> None:
    cols = ["mota", "motp", "idf1", "recall", "precision",
            "num_false_positives", "num_misses", "num_switches",
            "num_fragmentations", "mostly_tracked", "mostly_lost",
            "num_objects"]
    header = "SEQ".ljust(24) + "".join(c[:10].rjust(11) for c in cols)
    print(header)
    for seq, m in summary.items():
        line = seq.ljust(24)
        for c in cols:
            v = m.get(c)
            if v is None:
                line += " " * 11
            elif isinstance(v, float):
                line += f"{v:11.3f}"
            else:
                line += f"{v:11d}"
        print(line)
