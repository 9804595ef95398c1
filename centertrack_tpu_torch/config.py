"""Tracking- and detection-task configuration: the subset of the JAX
package's ``Config``, ``parse_task``, ``set_heads`` and ``finalize``
that the fused serving path, the trainer, the data pipeline and the
checkpoint loader read (reference: src/lib/opts.py:257-388; JAX:
centertrack_tpu/config.py), plus the MOT17 dataset meta the serving
benchmark uses. Every field keeps the JAX default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


COMPUTE_DTYPES = ("float32", "bfloat16")
# the spellings the JAX package's ops/warp.warp_precision_for accepts
WARP_PRECISIONS = ("auto", "highest", "default", "fast")


def _freeze_dict(d: Dict) -> Tuple[Tuple, ...]:
    return tuple(sorted(d.items()))


@dataclasses.dataclass(frozen=True)
class Config:
    task: str = ""
    dataset: str = "coco"          # data/datasets.get_dataset's name
    # checkpoint to start from (engine/trainer.Trainer.start, through
    # models/model.load_model: merged onto the fresh init, optimizer
    # state included; engine/fused.FusedDetector without params)
    load_model: str = ""
    # backbone-only pretrain merged onto the fresh init before training
    # (Trainer.start, through models/model.load_backbone)
    load_backbone: str = ""
    # without load_model, Trainer.start resumes from its save_dir's
    # model_last.ckpt
    resume: bool = False

    # --- system ----------------------------------------------------------
    seed: int = 317                # seeds create_model's initialisation
    num_workers: int = 4           # data/loader.DataLoader workers
    # fork-based loader workers instead of threads (tools/selftest.train)
    process_workers: bool = False

    # --- model -----------------------------------------------------------
    # dtype of the network's compute: 'float32' or 'bfloat16' (parameters
    # stay float32; JAX config.py:57)
    compute_dtype: str = "float32"
    # matmul precision of the separable input warp (ops/warp.py):
    # 'auto' rounds its operands to bf16 when compute_dtype is bfloat16,
    # as the TPU's one-pass DEFAULT does, else 'highest' (float32);
    # 'highest' | 'default' ('fast' is an alias) force one mode
    # (JAX config.py:84)
    warp_precision: str = "auto"
    arch: str = "dla_34"
    # the neck's nodes (JAX config.py:65): dcn (exact DCNv2) | dcn_mix
    # (clamped at R=2 on maps of stride <= CT_MIX_STRIDE, default 8, exact
    # above) | dcn_local (clamped, R=2) | dcn_local1 (R=1) | conv; both
    # ops serve and train on CUDA through hand-written kernels
    dla_node: str = "dcn"
    head_conv: int = -1            # -1 => 256 for dla, 64 otherwise
    down_ratio: int = 4
    num_classes: int = -1
    prior_bias: float = -4.6       # initial bias of the hm head's out conv

    # --- input (-1: the dataset's default resolution) ---------------------
    input_h: int = -1
    input_w: int = -1
    dataset_version: str = ""

    # --- test ------------------------------------------------------------
    K: int = 100
    out_thresh: float = -1.0

    # --- tracking --------------------------------------------------------
    tracking: bool = False
    pre_hm: bool = False
    same_aug_pre: bool = False
    hm_disturb: float = 0.0
    lost_disturb: float = 0.0
    fp_disturb: float = 0.0
    pre_thresh: float = -1.0
    track_thresh: float = 0.3
    new_thresh: float = 0.3
    max_frame_dist: int = 3
    max_age: int = -1
    max_tracks: int = 256          # capacity of the on-device track state
    # box heads (JAX config.py:119-120, 164-165): ltrb regresses the
    # clipped box's sides from the peak, ltrb_amodal the unclipped box's,
    # whose boxes then replace wh's in decode and tracking (MOT17's and
    # CrowdHuman's recipe)
    ltrb: bool = False
    ltrb_weight: float = 0.1
    ltrb_amodal: bool = False
    ltrb_amodal_weight: float = 0.1

    # --- train (JAX config.py:104-121) ------------------------------------
    optim: str = "adam"            # adam | sgd
    lr: float = 1.25e-4
    lr_step: Tuple[int, ...] = (60,)
    num_epochs: int = 70
    batch_size: int = 32
    # split each optimizer step into N sequential micro-batches of
    # batch_size / N; gradients sum in fp32, BN statistics advance once
    # per micro-batch
    grad_accum: int = 1
    # epochs Trainer.fit saves as model_<epoch>.ckpt (with a save_dir)
    save_point: Tuple[int, ...] = (90,)
    # checkpoint shape drift in Trainer.resume's load_model (reference:
    # model.py:46-71):
    # reset_hm re-initialises hm heads loaded from an 80- or 1-class
    # pretrain; reuse_hm copies the overlapping class channels
    reset_hm: bool = False
    reuse_hm: bool = False
    dense_reg: int = 1
    kitti_split: str = "3dop"

    # --- dataset augmentation (JAX config.py:145-153) ----------------------
    not_rand_crop: bool = False
    not_max_crop: bool = False
    shift: float = 0.0
    scale: float = 0.0
    aug_rot: float = 0.0
    rotate: float = 0.0
    flip: float = 0.5
    no_color_aug: bool = False

    # --- loss weights (JAX config.py:173-188) ------------------------------
    tracking_weight: float = 1.0
    hm_weight: float = 1.0
    off_weight: float = 1.0
    wh_weight: float = 0.1

    # --- custom dataset (data/datasets.CustomDataset) ----------------------
    custom_dataset_img_path: str = ""
    custom_dataset_ann_path: str = ""

    # --- derived (filled by parse_task / set_heads) -----------------------
    pre_img: bool = False
    output_h: int = -1
    output_w: int = -1
    heads: Tuple[Tuple[str, int], ...] = ()
    weights: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{'|'.join(COMPUTE_DTYPES)}, got "
                             f"{self.compute_dtype!r}")
        if self.warp_precision not in WARP_PRECISIONS:
            raise ValueError(f"warp_precision must be auto|highest|default, "
                             f"got {self.warp_precision!r}")

    @property
    def heads_dict(self) -> Dict[str, int]:
        return dict(self.heads)

    @property
    def weights_dict(self) -> Dict[str, float]:
        return dict(self.weights)


def parse_task(cfg: Config) -> Config:
    """Task-derived settings (reference: src/lib/opts.py:257-326)."""
    updates = {}
    if "tracking" in cfg.task:
        updates["tracking"] = True
        updates["out_thresh"] = max(cfg.track_thresh, cfg.out_thresh)
        updates["pre_thresh"] = max(cfg.track_thresh, cfg.pre_thresh)
        updates["new_thresh"] = max(cfg.track_thresh, cfg.new_thresh)
        updates["pre_img"] = True
    if cfg.head_conv == -1:
        updates["head_conv"] = 256 if "dla" in cfg.arch else 64
    return dataclasses.replace(cfg, **updates)


def set_heads(cfg: Config, dataset_meta) -> Config:
    """Input/output resolution and the head dict of a tracking or
    detection task (reference: src/lib/opts.py:329-388). ``dataset_meta``
    needs ``num_categories`` and ``default_resolution``."""
    extra = [t for t in cfg.task.split(",")
             if t not in ("tracking", "ctdet", "")]
    if extra:
        raise NotImplementedError(
            f"tasks {extra} are not ported yet (ROADMAP: ddd/pose extras)")
    num_classes = (dataset_meta.num_categories
                   if cfg.num_classes < 0 else cfg.num_classes)
    input_h, input_w = dataset_meta.default_resolution
    input_h = cfg.input_h if cfg.input_h > 0 else input_h
    input_w = cfg.input_w if cfg.input_w > 0 else input_w

    heads = {"hm": num_classes, "reg": 2, "wh": 2}
    if "tracking" in cfg.task:
        heads["tracking"] = 2
    if cfg.ltrb:
        heads["ltrb"] = 4
    if cfg.ltrb_amodal:
        heads["ltrb_amodal"] = 4
    # loss weight per head; a head weighted 0 is dropped (JAX
    # config.py:292-303)
    weight_of = {"hm": cfg.hm_weight, "wh": cfg.wh_weight,
                 "reg": cfg.off_weight, "tracking": cfg.tracking_weight,
                 "ltrb": cfg.ltrb_weight,
                 "ltrb_amodal": cfg.ltrb_amodal_weight}
    heads = {h: c for h, c in heads.items() if weight_of[h] != 0}
    weights = {h: weight_of[h] for h in heads}
    head_conv = cfg.head_conv if cfg.head_conv > 0 else (
        256 if "dla" in cfg.arch else 64)
    return dataclasses.replace(
        cfg,
        num_classes=num_classes,
        input_h=input_h, input_w=input_w,
        output_h=input_h // cfg.down_ratio,
        output_w=input_w // cfg.down_ratio,
        heads=_freeze_dict(heads),
        weights=_freeze_dict(weights),
        head_conv=head_conv,
    )


def finalize(cfg: Config, dataset_meta=None) -> Config:
    """parse_task + set_heads in one call; without ``dataset_meta`` the
    meta is the class of ``cfg.dataset`` (JAX config.py:327-334)."""
    cfg = parse_task(cfg)
    if dataset_meta is None:
        from centertrack_tpu_torch.data.registry import get_dataset_meta
        dataset_meta = get_dataset_meta(cfg.dataset, cfg)
    return set_heads(cfg, dataset_meta)


class MOT_META:
    """MOT17 pedestrian tracking at 544x960, the serving benchmark's
    primary configuration (reference: src/lib/dataset/datasets/mot.py)."""
    num_categories = 1
    default_resolution = [544, 960]
    mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
    std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)
