"""Public-detection txt -> results json for --load_results
(reference: src/tools/convert_mot_det_to_results.py; JAX:
centertrack_tpu/tools/convert_mot_det_to_results.py).

Converts per-sequence det/det{_split}.txt MOTChallenge files into the
{image_id: [det dicts]} json that cli/test.py injects for
public-detection tracking (--public_det --load_results).

Usage:
  python -m centertrack_tpu_torch.tools.convert_mot_det_to_results \
      --ann_path data/mot17/annotations/val_half.json \
      --data_path data/mot17/train --split val_half \
      --out results_public.json
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from centertrack_tpu_torch.data.coco_api import COCO


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", default="val_half")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    coco = COCO(args.ann_path)
    video_to_images = defaultdict(list)
    for img in coco.dataset["images"]:
        video_to_images[img["video_id"]].append(img)
    results = {}
    for video in coco.dataset["videos"]:
        seq = video["file_name"]
        det_file = os.path.join(args.data_path, seq, "det",
                                f"det_{args.split}.txt"
                                if args.split else "det.txt")
        if not os.path.exists(det_file):
            det_file = os.path.join(args.data_path, seq, "det", "det.txt")
        dets = np.loadtxt(det_file, dtype=np.float32, delimiter=",",
                          ndmin=2)
        frame_to_image = {img["frame_id"]: img["id"]
                          for img in video_to_images[video["id"]]}
        for row in dets:
            frame = int(row[0])
            if frame not in frame_to_image:
                continue
            img_id = frame_to_image[frame]
            bbox = [float(row[2]), float(row[3]),
                    float(row[2] + row[4]), float(row[3] + row[5])]
            ct = [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2]
            results.setdefault(img_id, []).append({
                "bbox": bbox, "ct": ct,
                "score": float(row[6]), "class": 1,
            })
    with open(args.out, "w") as f:
        json.dump(results, f)
    print(f"wrote {sum(len(v) for v in results.values())} dets for "
          f"{len(results)} images to {args.out}")


if __name__ == "__main__":
    main()
