"""Generic COCO-json dataset: augmentation and ground-truth target
generation for the tracking and detection tasks (reference:
src/lib/dataset/generic_dataset.py; JAX: centertrack_tpu/data/generic.py).

The host builds the image, the per-object scalar targets and compact
splat descriptors (integer centers, radii, classes); the train step
renders the dense heatmaps from them on the device
(``data/render.render_batch``). Every output array has a fixed capacity.

Without OpenCV: images are read by ``utils/image_io`` (JPEG and PNG,
as ``cv2.imread`` reads them), the input
warp is a numpy bilinear with a zero border (``warp_affine``, within one
level of ``cv2.warpAffine``), and ``color_aug``'s gray is 0.114 B +
0.587 G + 0.299 R in float32, as ``cv2.cvtColor(BGR2GRAY)``.

Random draws: where the JAX package draws from numpy's global state, an
item here draws from a ``RandomState`` of its own (``rng``), and the
colour jitter from a second one (``data_rng``), in the same order, so
that ``RandomState(s)`` and ``RandomState(t)`` give what
``np.random.seed(s)`` and ``_data_rng = RandomState(t)`` give JAX.
``__getitem__`` uses the dataset's ``rng`` and ``_data_rng``;
``item(index, seed)`` seeds both per item, as the loader does.
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from centertrack_tpu_torch.data.coco_api import COCO
from centertrack_tpu_torch.ops.affine import (affine_transform,
                                              get_affine_transform)
from centertrack_tpu_torch.utils import image_io

# heads whose targets are the ddd and pose extras (ROADMAP A9)
_EXTRA_HEADS = ("hps", "hm_hp", "hp_offset", "rot", "dep", "dim",
                "amodel_offset", "nuscenes_att", "velocity")
# the per-object regression targets and their widths, in JAX's order
# (data/generic.py:431)
_REGRESSION_DIMS = (("reg", 2), ("wh", 2), ("tracking", 2), ("ltrb", 4),
                    ("ltrb_amodal", 4))


def _extras_not_ported(what: str):
    return NotImplementedError(f"{what}: the ddd and pose targets are not "
                               f"ported yet (ROADMAP A9)")


def gaussian_radius(det_size, min_overlap: float = 0.7) -> float:
    """Minimum gaussian radius keeping IoU >= min_overlap
    (reference: src/lib/utils/image.py:105-125)."""
    height, width = det_size
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1 ** 2 - 4 * c1)) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2 ** 2 - 16 * c2)) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3 ** 2 - 4 * a3 * c3)) / 2
    return min(r1, r2, r3)


def warp_affine(img: np.ndarray, trans: np.ndarray, width: int,
                height: int) -> np.ndarray:
    """``cv2.warpAffine(img, trans, (width, height), INTER_LINEAR)`` with
    its constant-0 border: each output pixel samples the input at the
    inverse map of its position, bilinearly in float32 (corners outside
    the image count as 0), rounded to uint8. Within one level of OpenCV
    5's result, on about 0.02% of the elements
    (tests/test_torch_port_data.py)."""
    m = np.asarray(trans, np.float32).astype(np.float64)
    # cv2.invertAffineTransform's arithmetic
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    # the source positions in float32, each row's offset first (exact
    # half-pixel positions then stay exact, as in OpenCV)
    a = np.array([[a11, a12, b1], [a21, a22, b2]], np.float32)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    sx = a[0, 0] * xs + (a[0, 1] * ys + a[0, 2])
    sy = a[1, 0] * xs + (a[1, 1] * ys + a[1, 2])
    x0, y0 = np.floor(sx), np.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    h, w = img.shape[:2]
    # a zero frame one pixel wide around the image: every corner outside
    # the image is clipped onto it and reads 0
    src = np.zeros((h + 2, w + 2, img.size // (h * w)), np.float32)
    src[1:-1, 1:-1] = img.reshape(h, w, -1)
    src = src.reshape((h + 2) * (w + 2), -1)
    xa = np.clip(x0.astype(np.int64) + 1, 0, w + 1)
    xb = np.clip(x0.astype(np.int64) + 2, 0, w + 1)
    ya = np.clip(y0.astype(np.int64) + 1, 0, h + 1) * (w + 2)
    yb = np.clip(y0.astype(np.int64) + 2, 0, h + 1) * (w + 2)
    top = src[ya + xa] * (1 - fx) + src[ya + xb] * fx
    bottom = src[yb + xa] * (1 - fx) + src[yb + xb] * fx
    out = top * (1 - fy) + bottom * fy
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((height, width) + img.shape[2:])


def bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(image, COLOR_BGR2GRAY)`` of a float32 BGR image."""
    return (image[..., 0] * np.float32(0.114) +
            image[..., 1] * np.float32(0.587) +
            image[..., 2] * np.float32(0.299))


def color_aug(data_rng, image, eig_val, eig_vec, var=0.4):
    """CornerNet-style photometric jitter, fused into one array pass
    (reference: utils/image.py:211-243; JAX: data/generic.py:30).

    Brightness, contrast and saturation in random order, then PCA
    lighting noise. Each of the three is affine in the original image I
    and its gray G, so the permutation folds into scalars (ci, cg, cb):
    out = ci I + cg G + cb + lighting. The draws (a permutation, three
    uniforms in permuted order, one normal(3)) are the reference's.
    Returns float32 HWC."""
    gray = bgr_to_gray(image)
    gray_mean = float(gray.mean())
    ci, cg, cb = 1.0, 0.0, 0.0
    for op in data_rng.permutation(3):
        alpha = 1.0 + data_rng.uniform(low=-var, high=var)
        ci, cg, cb = alpha * ci, alpha * cg, alpha * cb
        if op == 1:    # contrast: blend toward the gray mean
            cb += (1.0 - alpha) * gray_mean
        elif op == 2:  # saturation: blend toward per-pixel gray
            cg += 1.0 - alpha
    lighting = eig_vec @ (eig_val * data_rng.normal(scale=0.1, size=(3,)))
    return (ci * image + cg * gray[:, :, None] +
            (cb + lighting).astype(np.float32)).astype(np.float32)


class GenericDataset:
    """Base dataset. Subclasses set the class attributes
    (reference: generic_dataset.py:21-52)."""

    default_resolution: Optional[Tuple[int, int]] = None
    num_categories: Optional[int] = None
    class_name: Optional[List[str]] = None
    cat_ids: Optional[Dict[int, int]] = None
    max_objs: Optional[int] = None
    rest_focal_length = 1200
    num_joints = 17
    mean = np.array([0.40789654, 0.44719302, 0.47026115],
                    dtype=np.float32).reshape(1, 1, 3)
    std = np.array([0.28863828, 0.27408164, 0.27809835],
                   dtype=np.float32).reshape(1, 1, 3)
    _eig_val = np.array([0.2141788, 0.01817699, 0.00341571],
                        dtype=np.float32)
    _eig_vec = np.array([
        [-0.58752847, -0.69563484, 0.41340352],
        [-0.5832747, 0.00994535, -0.81221408],
        [-0.56089297, 0.71832671, 0.41158938]
    ], dtype=np.float32)
    max_ignore_regions = 16

    def __init__(self, cfg=None, split=None, ann_path=None, img_dir=None):
        if cfg is not None and split is not None:
            self.split = split
            self.cfg = cfg
            extra = [h for h in cfg.heads_dict if h in _EXTRA_HEADS]
            if extra:
                raise _extras_not_ported(f"heads {extra}")
            # the draws JAX takes from np.random, and its _data_rng
            self.rng = np.random.RandomState(cfg.seed)
            self._data_rng = np.random.RandomState(123)
        if ann_path is not None and img_dir is not None:
            print(f"==> initializing {split} data from {ann_path},\n"
                  f" images from {img_dir} ...")
            self.coco = COCO(ann_path)
            self.images = self.coco.getImgIds()
            if cfg.tracking:
                if "videos" not in self.coco.dataset:
                    self.fake_video_data()
                self.video_to_images = defaultdict(list)
                for image in self.coco.dataset["images"]:
                    self.video_to_images[image["video_id"]].append(image)
            self.img_dir = img_dir

    def __len__(self):
        return len(self.images)

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self._item(index, self.rng, self._data_rng)

    def item(self, index: int, seed: int) -> Dict[str, np.ndarray]:
        """Item ``index`` with its own draws: ``RandomState(seed)`` and a
        colour-jitter ``RandomState`` seeded from it as JAX's process
        workers seed theirs (data/loader.py:30-35)."""
        return self._item(index, np.random.RandomState(seed),
                          np.random.RandomState(
                              (seed * 2654435761) % (2 ** 31 - 1)))

    def _item(self, index, rng, data_rng) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img, anns, img_info, img_path = self._load_data(index)

        height, width = img.shape[0], img.shape[1]
        c = np.array([img.shape[1] / 2.0, img.shape[0] / 2.0], np.float32)
        s = (max(img.shape[0], img.shape[1]) * 1.0
             if not cfg.not_max_crop
             else np.array([img.shape[1], img.shape[0]], np.float32))
        aug_s, rot, flipped = 1, 0, 0
        if self.split == "train":
            c, aug_s, rot = self._get_aug_param(rng, c, s, width, height)
            s = s * aug_s
            if rng.random_sample() < cfg.flip:
                flipped = 1
                img = img[:, ::-1, :]
                anns = self._flip_anns(anns, width)

        trans_input = get_affine_transform(
            c, s, rot, [cfg.input_w, cfg.input_h])
        trans_output = get_affine_transform(
            c, s, rot, [cfg.output_w, cfg.output_h])
        inp = self._get_input(data_rng, img, trans_input)
        ret = {"image": inp}

        pre_cts, track_ids = None, None
        if cfg.tracking:
            pre_image, pre_anns, frame_dist = self._load_pre_data(
                rng, img_info["video_id"], img_info["frame_id"],
                img_info.get("sensor_id", 1))
            if flipped:
                pre_image = pre_image[:, ::-1, :].copy()
                pre_anns = self._flip_anns(pre_anns, width)
            if cfg.same_aug_pre and frame_dist != 0:
                trans_input_pre = trans_input
                trans_output_pre = trans_output
            else:
                c_pre, aug_s_pre, _ = self._get_aug_param(
                    rng, c.copy(), s, width, height, disturb=True)
                s_pre = s * aug_s_pre
                trans_input_pre = get_affine_transform(
                    c_pre, s_pre, rot, [cfg.input_w, cfg.input_h])
                trans_output_pre = get_affine_transform(
                    c_pre, s_pre, rot, [cfg.output_w, cfg.output_h])
            pre_img = self._get_input(data_rng, pre_image, trans_input_pre)
            pre_splats, pre_cts, track_ids = self._get_pre_dets(
                rng, pre_anns, trans_input_pre, trans_output_pre)
            ret["pre_img"] = pre_img
            if cfg.pre_hm:
                ret.update(pre_splats)

        self._init_ret(ret)
        calib = self._get_calib(img_info, width, height)
        self._add_instances(ret, anns[:self.max_objs], trans_output,
                            pre_cts, track_ids)

        ret["meta_c"] = c.astype(np.float32)
        ret["meta_s"] = np.array(
            s if isinstance(s, np.ndarray) else [s, s], np.float32)
        ret["calib"] = calib.astype(np.float32)
        ret["image_id"] = np.int64(img_info["id"])
        return ret

    # ------------------------------------------------------------------
    def _load_image_anns(self, img_id, coco, img_dir):
        img_info = coco.loadImgs([img_id])[0]
        img_path = os.path.join(img_dir, img_info["file_name"])
        ann_ids = coco.getAnnIds(imgIds=[img_id])
        # copies the caller may change (a flip rewrites each bbox)
        anns = [dict(a, bbox=list(a["bbox"]))
                for a in coco.loadAnns(ann_ids)]
        img = image_io.read(img_path)
        return img, anns, img_info, img_path

    def _load_data(self, index):
        img_id = self.images[index]
        return self._load_image_anns(img_id, self.coco, self.img_dir)

    def _pre_frame_candidates(self, video_id, frame_id, sensor_id, lo, hi):
        """Frames of the same video and sensor whose frame distance to
        ``frame_id`` lies in [lo, hi]."""
        return [(info["id"], info["frame_id"])
                for info in self.video_to_images[video_id]
                if lo <= info["frame_id"] - frame_id <= hi
                and info.get("sensor_id", sensor_id) == sensor_id]

    def _load_pre_data(self, rng, video_id, frame_id, sensor_id=1):
        """The 'previous' frame (reference: generic_dataset.py:179-202):
        in training uniform within +/-(max_frame_dist - 1), the frame
        itself included; otherwise frame_id - 1, or the frame itself at a
        video's start."""
        if "train" in self.split:
            d = self.cfg.max_frame_dist - 1
            cands = self._pre_frame_candidates(
                video_id, frame_id, sensor_id, -d, d)
        else:
            cands = (self._pre_frame_candidates(
                         video_id, frame_id, sensor_id, -1, -1) or
                     self._pre_frame_candidates(
                         video_id, frame_id, sensor_id, 0, 0))
        img_id, pre_frame_id = cands[rng.choice(len(cands))]
        img, anns, _, _ = self._load_image_anns(img_id, self.coco,
                                                self.img_dir)
        return img, anns, abs(frame_id - pre_frame_id)

    def _get_pre_dets(self, rng, anns, trans_input, trans_output):
        """Previous-frame centers with simulated tracker noise
        (reference: generic_dataset.py:205-255), as splat descriptors of
        capacity 2 * max_objs (each object may add one fp_disturb
        splat)."""
        cfg = self.cfg
        hm_h, hm_w = cfg.input_h, cfg.input_w
        down_ratio = cfg.down_ratio
        cap = 2 * self.max_objs
        cts_int = np.zeros((cap, 2), np.int32)
        radii = np.zeros((cap,), np.int32)
        ks = np.zeros((cap,), np.float32)
        valid = np.zeros((cap,), bool)
        n = 0
        pre_cts, track_ids = [], []
        for ann in anns:
            cls_id = int(self.cat_ids[ann["category_id"]])
            if (cls_id > cfg.num_classes or cls_id <= -99 or
                    ("iscrowd" in ann and ann["iscrowd"] > 0)):
                continue
            bbox = self._coco_box_to_bbox(ann["bbox"])
            bbox[:2] = affine_transform(bbox[:2], trans_input)
            bbox[2:] = affine_transform(bbox[2:], trans_input)
            bbox[[0, 2]] = np.clip(bbox[[0, 2]], 0, hm_w - 1)
            bbox[[1, 3]] = np.clip(bbox[[1, 3]], 0, hm_h - 1)
            h, w = bbox[3] - bbox[1], bbox[2] - bbox[0]
            if h > 0 and w > 0:
                radius = gaussian_radius((math.ceil(h), math.ceil(w)))
                radius = max(0, int(radius))
                ct = np.array([(bbox[0] + bbox[2]) / 2,
                               (bbox[1] + bbox[3]) / 2], np.float32)
                ct0 = ct.copy()

                ct[0] = ct[0] + rng.randn() * cfg.hm_disturb * w
                ct[1] = ct[1] + rng.randn() * cfg.hm_disturb * h
                conf = 1 if rng.random_sample() > cfg.lost_disturb else 0

                ct_int = ct.astype(np.int32)
                if conf == 0:
                    pre_cts.append(ct / down_ratio)
                else:
                    pre_cts.append(ct0 / down_ratio)
                track_ids.append(ann.get("track_id", -1))
                if n < cap:
                    cts_int[n] = ct_int
                    radii[n] = radius
                    ks[n] = conf
                    valid[n] = True
                    n += 1

                if rng.random_sample() < cfg.fp_disturb and cfg.pre_hm:
                    ct2 = ct0.copy()
                    ct2[0] = ct2[0] + rng.randn() * 0.05 * w
                    ct2[1] = ct2[1] + rng.randn() * 0.05 * h
                    if n < cap:
                        cts_int[n] = ct2.astype(np.int32)
                        radii[n] = radius
                        ks[n] = conf
                        valid[n] = True
                        n += 1
        splats = {"pre_cts_int": cts_int, "pre_radii": radii,
                  "pre_ks": ks, "pre_valid": valid}
        return splats, pre_cts, track_ids

    @staticmethod
    def _safe_crop_margin(border, size):
        """Largest margin border // 2^k that leaves a non-empty randint
        range inside ``size`` (reference: generic_dataset.py:258-262)."""
        margin = border
        div = 1
        while size <= 2 * margin:
            div *= 2
            margin = border // div
        return margin

    def _get_aug_param(self, rng, c, s, width, height, disturb=False):
        """The geometric augmentation (center, scale factor, rotation;
        reference: generic_dataset.py:264-286): random crop (scale from
        the ladder 0.6..1.3, center inside a safe margin) for training
        unless ``not_rand_crop``; else, and for the previous frame
        (``disturb``), a gaussian shift and scale clipped to 2 sigma."""
        cfg = self.cfg
        use_crop = (not cfg.not_rand_crop) and not disturb
        if use_crop:
            scale_ladder = np.arange(0.6, 1.4, 0.1)
            aug_s = rng.choice(scale_ladder)
            margins = [self._safe_crop_margin(128, d)
                       for d in (width, height)]
            c[:] = [rng.randint(low=m, high=d - m)
                    for m, d in zip(margins, (width, height))]
        else:
            s_wh = np.broadcast_to(
                np.asarray(s, np.float32).ravel(), (2,))
            shift = np.clip(rng.randn(2) * cfg.shift,
                            -2 * cfg.shift, 2 * cfg.shift)
            c += s_wh * shift
            aug_s = np.clip(rng.randn() * cfg.scale + 1,
                            1 - cfg.scale, 1 + cfg.scale)
        rot = 0
        if rng.random_sample() < cfg.aug_rot:
            rot = np.clip(rng.randn() * cfg.rotate,
                          -2 * cfg.rotate, 2 * cfg.rotate)
        return c, aug_s, rot

    def _flip_anns(self, anns, width):
        """Mirror every box horizontally (reference:
        generic_dataset.py:289-314)."""
        if anns:
            boxes = np.array([a["bbox"] for a in anns], np.float64)
            boxes[:, 0] = width - 1 - boxes[:, 0] - boxes[:, 2]
            for a, b in zip(anns, boxes):
                a["bbox"] = b.tolist()
        return anns

    def _get_input(self, data_rng, img, trans_input):
        """(reference: generic_dataset.py:317-327). HWC float32."""
        cfg = self.cfg
        inp = warp_affine(img, trans_input, cfg.input_w, cfg.input_h)
        inp = inp.astype(np.float32) / 255.0
        if self.split == "train" and not cfg.no_color_aug:
            inp = color_aug(data_rng, inp, self._eig_val, self._eig_vec)
        inp = (inp - self.mean) / self.std
        return inp

    # ------------------------------------------------------------------
    def _init_ret(self, ret):
        """Fixed-capacity targets (reference: generic_dataset.py:330-369)
        and the splat descriptors of the device render."""
        cfg = self.cfg
        heads = cfg.heads_dict
        max_objs = self.max_objs * cfg.dense_reg
        ret["ind"] = np.zeros((max_objs,), np.int64)
        ret["cat"] = np.zeros((max_objs,), np.int64)
        ret["mask"] = np.zeros((max_objs,), np.float32)
        ret["hm_cts"] = np.zeros((max_objs, 2), np.int32)
        ret["hm_radii"] = np.zeros((max_objs,), np.int32)
        ret["hm_valid"] = np.zeros((max_objs,), bool)
        # rectangular ignore/crowd regions; cat == -1 -> all classes
        ret["ignore_boxes"] = np.zeros((self.max_ignore_regions, 4),
                                       np.float32)
        ret["ignore_cat"] = np.zeros((self.max_ignore_regions,), np.int32)
        ret["ignore_valid"] = np.zeros((self.max_ignore_regions,), bool)
        self._num_ignore = 0
        for head, dim in _REGRESSION_DIMS:
            if head in heads:
                ret[head] = np.zeros((max_objs, dim), np.float32)
                ret[head + "_mask"] = np.zeros((max_objs, dim), np.float32)

    def _get_calib(self, img_info, width, height):
        if "calib" in img_info:
            return np.array(img_info["calib"], np.float32)
        return np.array([[self.rest_focal_length, 0, width / 2, 0],
                         [0, self.rest_focal_length, height / 2, 0],
                         [0, 0, 1, 0]], np.float32)

    def _mask_ignore_or_crowd(self, ret, cls_id, bbox):
        """Record a rectangular ignore region for the device render
        (reference: generic_dataset.py:386-398 writes hm = 1 there)."""
        if self._num_ignore >= self.max_ignore_regions:
            return
        i = self._num_ignore
        ret["ignore_boxes"][i] = bbox
        ret["ignore_cat"][i] = -1 if cls_id == 0 else abs(cls_id) - 1
        ret["ignore_valid"][i] = True
        self._num_ignore += 1

    def _coco_box_to_bbox(self, box):
        return np.array([box[0], box[1], box[0] + box[2], box[1] + box[3]],
                        np.float32)

    def _transform_bboxes(self, boxes_xywh, trans_output: np.ndarray):
        """coco xywh -> output-space xyxy envelopes of the 4 warped
        corners, clipped and amodal (reference:
        generic_dataset.py:407-421)."""
        cfg = self.cfg
        b = np.asarray(boxes_xywh, np.float32)
        x0y0 = b[:, :2]
        x1y1 = b[:, :2] + b[:, 2:4]
        rect = np.stack([x0y0,
                         np.stack([x0y0[:, 0], x1y1[:, 1]], -1),
                         x1y1,
                         np.stack([x1y1[:, 0], x0y0[:, 1]], -1)], axis=1)
        warped = rect @ trans_output[:, :2].T + trans_output[:, 2]
        amodal = np.concatenate([warped.min(axis=1), warped.max(axis=1)],
                                axis=1).astype(np.float32)
        clipped = amodal.copy()
        clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, cfg.output_w - 1)
        clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, cfg.output_h - 1)
        return clipped, amodal

    def _add_instances(self, ret, anns, trans_output, pre_cts=None,
                       track_ids=None):
        """Per-object targets (reference: generic_dataset.py:372-515).
        Target slot k keeps the annotation's index (holes stay masked)."""
        cfg = self.cfg
        heads = cfg.heads_dict
        if not anns:
            return
        cls = np.array([self.cat_ids[a["category_id"]] for a in anns],
                       np.int64)
        crowd = np.array([a.get("iscrowd", 0) > 0 for a in anns], bool)
        known = (cls <= cfg.num_classes) & (cls > -999)
        clipped, amodal = self._transform_bboxes(
            [a["bbox"] for a in anns], trans_output)
        wh = clipped[:, 2:4] - clipped[:, 0:2]

        for k in np.nonzero(known & ((cls <= 0) | crowd))[0]:
            self._mask_ignore_or_crowd(ret, int(cls[k]), clipped[k])

        live_mask = (known & (cls > 0) & ~crowd &
                     (wh[:, 0] > 0) & (wh[:, 1] > 0))
        live = np.nonzero(live_mask)[0]
        if live.size == 0:
            return
        box = clipped[live]
        ct = (box[:, 0:2] + box[:, 2:4]) / 2
        ct_int = ct.astype(np.int32)
        radii = np.array([max(0, int(gaussian_radius(
            (math.ceil(hh), math.ceil(ww)))))
            for ww, hh in wh[live]], np.int32)

        ret["cat"][live] = cls[live] - 1
        ret["mask"][live] = 1
        if "wh" in ret:
            ret["wh"][live] = wh[live]
            ret["wh_mask"][live] = 1
        ret["ind"][live] = ct_int[:, 1] * cfg.output_w + ct_int[:, 0]
        ret["reg"][live] = ct - ct_int
        ret["reg_mask"][live] = 1
        ret["hm_cts"][live] = ct_int
        ret["hm_radii"][live] = radii
        ret["hm_valid"][live] = True

        # box sides from the integer peak: the clipped box (ltrb) and the
        # unclipped one (ltrb_amodal)
        if "ltrb" in heads:
            ret["ltrb"][live] = box - np.tile(ct_int, 2)
            ret["ltrb_mask"][live] = 1
        if "ltrb_amodal" in heads:
            ret["ltrb_amodal"][live] = amodal[live] - np.tile(ct_int, 2)
            ret["ltrb_amodal_mask"][live] = 1

        if "tracking" in heads and track_ids:
            pre_ct_of = {tid: pc for tid, pc in zip(track_ids, pre_cts)}
            for i, k in enumerate(live):
                pre_ct = pre_ct_of.get(anns[k].get("track_id"))
                if pre_ct is not None:
                    ret["tracking_mask"][k] = 1
                    ret["tracking"][k] = pre_ct - ct_int[i]

    def _add_hps(self, *args):
        raise _extras_not_ported("_add_hps (keypoint targets)")

    def _add_rot(self, *args):
        raise _extras_not_ported("_add_rot (orientation targets)")

    def fake_video_data(self):
        """Each still image as a 1-frame video, so that the tracking
        pipeline runs on detection datasets (reference:
        generic_dataset.py:595-607)."""
        data = self.coco.dataset
        for img in data["images"]:
            img["video_id"], img["frame_id"] = img["id"], 1
        data["videos"] = [{"id": img["id"]} for img in data["images"]]
        for t, ann in enumerate(data.get("annotations", []), start=1):
            ann["track_id"] = t
