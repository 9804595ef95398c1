"""Minimal COCO-annotation-format API (JAX: data/coco_api.py).

The subset of pycocotools' index that the data layer needs
(getImgIds/loadImgs/getAnnIds/loadAnns/getCatIds/loadRes and raw
dataset access), in pure Python.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional


class COCO:
    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[Dict] = None):
        if dataset is None:
            with open(annotation_file, "r") as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.create_index()

    def create_index(self) -> None:
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    def getImgIds(self, imgIds=None, catIds=None) -> List[int]:
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        if catIds:
            cat_imgs = set()
            for c in catIds:
                cat_imgs.update(self.cat_to_imgs[c])
            ids &= cat_imgs
        return list(ids)

    def loadImgs(self, ids) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds=None, catIds=None) -> List[int]:
        if imgIds is None:
            anns = list(self.anns.values())
        else:
            if isinstance(imgIds, int):
                imgIds = [imgIds]
            anns = []
            for i in imgIds:
                anns.extend(self.img_to_anns[i])
        if catIds is not None:
            if isinstance(catIds, int):
                catIds = [catIds]
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        return [a["id"] for a in anns]

    def loadAnns(self, ids) -> List[Dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def getCatIds(self) -> List[int]:
        return list(self.cats.keys())

    def loadRes(self, results) -> "COCO":
        """Build a results COCO from a list of detection dicts
        (pycocotools-compatible subset)."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        dataset = {
            "images": self.dataset.get("images", []),
            "categories": self.dataset.get("categories", []),
            "annotations": [],
        }
        for i, det in enumerate(results):
            ann = dict(det)
            ann["id"] = i + 1
            if "bbox" in ann and "area" not in ann:
                ann["area"] = ann["bbox"][2] * ann["bbox"][3]
            ann.setdefault("iscrowd", 0)
            dataset["annotations"].append(ann)
        return COCO(dataset=dataset)
