"""Concrete dataset classes and the factory (reference:
src/lib/dataset/datasets/*.py, dataset_factory.py; JAX:
centertrack_tpu/data/datasets.py).

``run_eval`` uses this package's own evaluators: ``MOT`` writes
MOTChallenge txt files and scores them with ``eval/mot_eval``, and
``CustomDataset`` evaluates nothing. The COCO, KITTI and CrowdHuman
evaluators are the rest of ROADMAP A7 and raise. ``NuScenes`` and
``COCOHP`` carry their metas (what serving reads) and raise when loaded
or evaluated: their loaders, targets and evaluators are A9c.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from centertrack_tpu_torch.data.generic import GenericDataset


def _eval_not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A7: "
                               f"coco_eval, kitti_*, nuscenes_eval)")


class COCODet(GenericDataset):
    """80-class COCO detection (reference: datasets/coco.py)."""
    default_resolution = [512, 512]
    num_categories = 80
    class_name = [
        'person', 'bicycle', 'car', 'motorcycle', 'airplane',
        'bus', 'train', 'truck', 'boat', 'traffic light', 'fire hydrant',
        'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog',
        'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
        'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
        'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
        'baseball glove', 'skateboard', 'surfboard', 'tennis racket',
        'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl',
        'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
        'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch',
        'potted plant', 'bed', 'dining table', 'toilet', 'tv', 'laptop',
        'mouse', 'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
        'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
        'scissors', 'teddy bear', 'hair drier', 'toothbrush']
    _valid_ids = [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13,
        14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
        24, 25, 27, 28, 31, 32, 33, 34, 35, 36,
        37, 38, 39, 40, 41, 42, 43, 44, 46, 47,
        48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
        58, 59, 60, 61, 62, 63, 64, 65, 67, 70,
        72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
        82, 84, 85, 86, 87, 88, 89, 90]
    cat_ids = {v: i + 1 for i, v in enumerate(_valid_ids)}
    num_joints = 17
    max_objs = 128

    def __init__(self, cfg, split):
        data_dir = os.path.join(cfg_data_dir(cfg), "coco")
        img_dir = os.path.join(data_dir, f"{split}2017")
        ann_path = os.path.join(
            data_dir, "annotations", f"instances_{split}2017.json")
        super().__init__(cfg, split, ann_path, img_dir)

    def run_eval(self, results, save_dir):
        raise _eval_not_ported("COCO evaluation (eval/coco_eval)")


def _a9c_not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A9c: the "
                               f"ddd / pose targets, data and evaluators)")


class COCOHP(COCODet):
    """COCO person keypoints (reference: datasets/coco_hp.py; JAX
    data/datasets.py:91-100): the meta; loading raises."""
    num_categories = 1
    class_name = ['']
    num_joints = 17
    default_resolution = [512, 512]
    max_objs = 32
    cat_ids = {1: 1}
    _valid_ids = [1]

    def __init__(self, cfg, split):
        raise _a9c_not_ported("the COCO keypoints dataset")

    def run_eval(self, results, save_dir):
        raise _a9c_not_ported("COCO keypoint evaluation")


class NuScenes(GenericDataset):
    """nuScenes monocular 3D (reference: datasets/nuscenes.py; JAX
    data/nuscenes.py:57-79): the meta; loading raises."""
    default_resolution = [448, 800]
    num_categories = 10
    class_name = [
        'car', 'truck', 'bus', 'trailer',
        'construction_vehicle', 'pedestrian', 'motorcycle', 'bicycle',
        'traffic_cone', 'barrier']
    cat_ids = {i + 1: i + 1 for i in range(10)}
    focal_length = 1200
    max_objs = 128

    def __init__(self, cfg, split):
        raise _a9c_not_ported("the nuScenes dataset")

    def run_eval(self, results, save_dir):
        raise _a9c_not_ported("nuScenes evaluation")


class MOT(GenericDataset):
    """MOT17/20 pedestrian tracking (reference: datasets/mot.py)."""
    num_categories = 1
    default_resolution = [544, 960]
    class_name = ['']
    max_objs = 256
    cat_ids = {1: 1, -1: -1}

    def __init__(self, cfg, split):
        self.dataset_version = cfg.dataset_version
        self.year = int(self.dataset_version[:2]) \
            if self.dataset_version else 17
        data_dir = os.path.join(cfg_data_dir(cfg), f"mot{self.year}")
        if cfg.dataset_version in ["17trainval", "17test"]:
            ann_file = "{}.json".format(
                "train" if split == "train" else "test")
        elif cfg.dataset_version == "17halftrain":
            ann_file = "train_half.json"
        else:  # 17halfval and default
            ann_file = "val_half.json" \
                if "halfval" in (cfg.dataset_version or "") \
                else f"{split}.json"
        img_dir = os.path.join(
            data_dir,
            "test" if "test" in (self.dataset_version or "") else "train")
        ann_path = os.path.join(data_dir, "annotations", ann_file)
        super().__init__(cfg, split, ann_path, img_dir)

    def save_results(self, results, save_dir, rng=None):
        """MOTChallenge txt per video (reference: mot.py:52-83). An
        untracked detection gets a random id from ``rng`` (by default
        ``RandomState(0)``, the draws of JAX's after ``np.random.seed(0)``)."""
        rng = rng if rng is not None else np.random.RandomState(0)
        results_dir = os.path.join(
            save_dir, f"results_mot{self.dataset_version}")
        os.makedirs(results_dir, exist_ok=True)
        for video in self.coco.dataset["videos"]:
            video_id = video["id"]
            file_name = video["file_name"]
            out_path = os.path.join(results_dir, f"{file_name}.txt")
            with open(out_path, "w") as f:
                images = self.video_to_images[video_id]
                tracks = defaultdict(list)
                for image_info in images:
                    if image_info["id"] not in results:
                        continue
                    result = results[image_info["id"]]
                    frame_id = image_info["frame_id"]
                    for item in result:
                        tid = item.get("tracking_id")
                        if tid is None:
                            tid = rng.randint(100000)
                        if item["active"] == 0:
                            continue
                        bbox = item["bbox"]
                        tracks[tid].append([frame_id] + list(bbox))
                rename_track_id = 0
                for track_id in sorted(tracks):
                    rename_track_id += 1
                    for t in tracks[track_id]:
                        f.write(
                            "{},{},{:.2f},{:.2f},{:.2f},{:.2f},-1,-1,-1,-1\n"
                            .format(t[0], rename_track_id, t[1], t[2],
                                    t[3] - t[1], t[4] - t[2]))
        return results_dir

    def run_eval(self, results, save_dir):
        from centertrack_tpu_torch.eval.mot_eval import evaluate_mot_dir
        results_dir = self.save_results(results, save_dir)
        gt_type = ("_train_half" if "17halftrain" in
                   (self.dataset_version or "")
                   else "_val_half" if "17halfval" in
                   (self.dataset_version or "") else "")
        data_root = os.path.join(cfg_data_dir(self.cfg),
                                 f"mot{self.year}", "train")
        return evaluate_mot_dir(data_root, results_dir, gt_type=gt_type)


class KITTI(GenericDataset):
    """KITTI 2D/3D detection (reference: datasets/kitti.py)."""
    num_categories = 3
    default_resolution = [384, 1280]
    class_name = ['Pedestrian', 'Car', 'Cyclist']
    cat_ids = {1: 1, 2: 2, 3: 3, 4: -2, 5: -2, 6: -1, 7: -9999, 8: -9999,
               9: 0}
    max_objs = 50

    def __init__(self, cfg, split):
        data_dir = os.path.join(cfg_data_dir(cfg), "kitti")
        img_dir = os.path.join(data_dir, "images", "trainval")
        ann_path = os.path.join(
            data_dir, "annotations",
            f"kitti_v2_{cfg.kitti_split}_{split}.json")
        super().__init__(cfg, split, ann_path, img_dir)
        self.alpha_in_degree = False

    def run_eval(self, results, save_dir):
        raise _eval_not_ported("KITTI evaluation (eval/kitti_det_eval)")


class KITTITracking(KITTI):
    """KITTI multi-object tracking (reference: datasets/kitti_tracking.py)."""

    def __init__(self, cfg, split):
        data_dir = os.path.join(cfg_data_dir(cfg), "kitti_tracking")
        split_ = "train" if cfg.dataset_version != "test" else "test"
        img_dir = os.path.join(data_dir, "data_tracking_image_2",
                               f"{split_}ing", "image_02")
        ann_file_ = split_ if cfg.dataset_version == "" \
            else cfg.dataset_version
        ann_path = os.path.join(data_dir, "annotations",
                                f"tracking_{ann_file_}.json")
        GenericDataset.__init__(self, cfg, split, ann_path, img_dir)
        self.alpha_in_degree = False

    def run_eval(self, results, save_dir):
        raise _eval_not_ported(
            "KITTI tracking evaluation (eval/kitti_track_eval)")


class CrowdHuman(GenericDataset):
    """(reference: datasets/crowdhuman.py)"""
    num_categories = 1
    num_joints = 17
    default_resolution = [512, 512]
    max_objs = 128
    class_name = ['person']
    cat_ids = {1: 1}

    def __init__(self, cfg, split):
        data_dir = os.path.join(cfg_data_dir(cfg), "crowdhuman")
        img_dir = os.path.join(data_dir, f"CrowdHuman_{split}", "Images")
        ann_path = os.path.join(data_dir, "annotations", f"{split}.json")
        super().__init__(cfg, split, ann_path, img_dir)

    def run_eval(self, results, save_dir):
        raise _eval_not_ported("CrowdHuman evaluation")


class CustomDataset(GenericDataset):
    """User-specified paths and classes (reference:
    datasets/custom_dataset.py)."""
    num_categories = 1
    default_resolution = [-1, -1]
    class_name = ['']
    max_objs = 128
    cat_ids = {1: 1}

    def __init__(self, cfg, split):
        if not (cfg.custom_dataset_img_path and
                cfg.custom_dataset_ann_path and cfg.num_classes != -1 and
                cfg.input_h != -1 and cfg.input_w != -1):
            raise ValueError("custom datasets require "
                             "custom_dataset_img_path, "
                             "custom_dataset_ann_path, num_classes, "
                             "input_h, input_w")
        self.num_categories = cfg.num_classes
        self.class_name = ['' for _ in range(self.num_categories)]
        self.default_resolution = [cfg.input_h, cfg.input_w]
        self.cat_ids = {i: i for i in range(1, self.num_categories + 1)}
        super().__init__(cfg, split, cfg.custom_dataset_ann_path,
                         cfg.custom_dataset_img_path)

    def run_eval(self, results, save_dir):
        pass


def cfg_data_dir(cfg) -> str:
    """$CENTERTRACK_DATA_DIR, else data/ at the repository root."""
    return os.environ.get("CENTERTRACK_DATA_DIR",
                          os.path.join(os.path.dirname(
                              os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__)))), "data"))


dataset_factory = {
    "custom": CustomDataset,
    "coco": COCODet,
    "mot": MOT,
    "crowdhuman": CrowdHuman,
    "kitti": KITTI,
    "kitti_tracking": KITTITracking,
    "coco_hp": COCOHP,
    "nuscenes": NuScenes,
}


def get_dataset(name: str):
    """(reference: dataset_factory.py:20-33)"""
    return dataset_factory[name]
