"""Tracking- and detection-task configuration: the subset of the JAX
package's ``Config``, ``parse_task``, ``set_heads`` and ``finalize``
that the fused serving path, the host Detector, the trainer, the CLI,
the data pipeline and the checkpoint loader read (reference:
src/lib/opts.py:257-388; JAX: centertrack_tpu/config.py), plus the MOT17
dataset meta the serving benchmark uses. Every field keeps the JAX
default. The tasks are ``tracking`` and ``ctdet``, each optionally with
``ddd`` (monocular 3D) or ``multi_pose`` (keypoints) beside it.
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
    # the dataset cli/test.py evaluates on; "" takes ``dataset``
    # (parse_task)
    test_dataset: str = ""
    # the run's directory is exp/<task>/<exp_id> (cli/main.py, cli/test.py)
    exp_id: str = "default"
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
    # both sides of the input, unless input_h / input_w say otherwise;
    # set_heads writes max(input_h, input_w) back
    input_res: int = -1
    input_h: int = -1
    input_w: int = -1
    dataset_version: str = ""

    # --- test (the host Detector, engine/detector.py; JAX config.py:
    # 129-140) -------------------------------------------------------------
    # average each frame's maps with its mirror's (a batch of 2)
    flip_test: bool = False
    # one scale only: the Detector asserts it, as JAX's does
    test_scales: Tuple[float, ...] = (1.0,)
    # greedy IoU suppression of the decoded boxes (ops/nms.py)
    nms: bool = False
    K: int = 100
    # short side of the input (the long side rounded up to 64); overrides
    # fix_res and keep_res
    fix_short: int = -1
    # keep each frame's own size: each side n becomes (n | pad) + 1
    keep_res: bool = False
    # multiplies the decoded depth (ops/decode.sigmoid_output)
    depth_scale: float = 1.0
    # focal length of the default camera of the ddd lift, in pixels;
    # -1 takes the dataset's rest_focal_length
    test_focal_length: int = -1
    # cli/test.py evaluates the test split instead of val
    trainval: bool = False
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
    # the host tracker births tracks only at the public detections
    # (meta["cur_dets"]) and seeds the first frame from meta["pre_dets"]
    public_det: bool = False
    # the host tracker matches by scipy's linear_sum_assignment
    hungarian: bool = False
    # zero the pre_hm input / the tracking offsets (ablations; both the
    # host Detector and the fused step read them)
    zero_pre_hm: bool = False
    zero_tracking: bool = False
    # no previous-frame image input (pre_img is its negation)
    no_pre_img: bool = False
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
    # iterations an epoch (train) or frames a test, -1 for all
    num_iters: int = -1
    # cli/main.py validates and saves model_<epoch>.ckpt every this many
    # epochs
    val_intervals: int = 10000
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
    # the pose heads: keypoint offsets from the centre (hps), the
    # keypoint heatmaps (hm_hp); hp_offset takes off_weight
    hp_weight: float = 1.0
    hm_hp_weight: float = 1.0
    # the ddd heads: amodal-centre offset, depth, 3D size, 8-bin
    # orientation
    amodel_offset_weight: float = 1.0
    dep_weight: float = 1.0
    dim_weight: float = 1.0
    rot_weight: float = 1.0
    # nuScenes attribute (8 classes) and velocity (3) heads, off unless
    # set
    nuscenes_att: bool = False
    nuscenes_att_weight: float = 1.0
    velocity: bool = False
    velocity_weight: float = 1.0

    # --- custom dataset (data/datasets.CustomDataset) ----------------------
    custom_dataset_img_path: str = ""
    custom_dataset_ann_path: str = ""

    # --- derived (filled by parse_task / set_heads) -----------------------
    pre_img: bool = False
    fix_res: bool = True           # not keep_res
    pad: int = 31                  # keep_res's padding mask
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
    """Task-derived settings (reference: src/lib/opts.py:257-326; JAX
    config.py:236-253)."""
    updates = {}
    if cfg.test_dataset == "":
        updates["test_dataset"] = cfg.dataset
    if "tracking" in cfg.task:
        updates["tracking"] = True
        updates["out_thresh"] = max(cfg.track_thresh, cfg.out_thresh)
        updates["pre_thresh"] = max(cfg.track_thresh, cfg.pre_thresh)
        updates["new_thresh"] = max(cfg.track_thresh, cfg.new_thresh)
        updates["pre_img"] = not cfg.no_pre_img
    updates["fix_res"] = not cfg.keep_res
    if cfg.head_conv == -1:
        updates["head_conv"] = 256 if "dla" in cfg.arch else 64
    updates["pad"] = 127 if "hourglass" in cfg.arch else 31
    return dataclasses.replace(cfg, **updates)


def set_heads(cfg: Config, dataset_meta) -> Config:
    """Input/output resolution and the head dict of the task
    (reference: src/lib/opts.py:329-388; JAX config.py:254-324).
    ``dataset_meta`` needs ``num_categories`` and ``default_resolution``,
    and ``num_joints`` for ``multi_pose``."""
    extra = [t for t in cfg.task.split(",")
             if t not in ("tracking", "ctdet", "ddd", "multi_pose", "")]
    if extra:
        raise NotImplementedError(f"tasks {extra} are not ported")
    num_classes = (dataset_meta.num_categories
                   if cfg.num_classes < 0 else cfg.num_classes)
    input_h, input_w = dataset_meta.default_resolution
    input_h = cfg.input_res if cfg.input_res > 0 else input_h
    input_w = cfg.input_res if cfg.input_res > 0 else input_w
    input_h = cfg.input_h if cfg.input_h > 0 else input_h
    input_w = cfg.input_w if cfg.input_w > 0 else input_w

    heads = {"hm": num_classes, "reg": 2, "wh": 2}
    if "tracking" in cfg.task:
        heads["tracking"] = 2
    if "ddd" in cfg.task:
        heads.update({"dep": 1, "rot": 8, "dim": 3, "amodel_offset": 2})
    if "multi_pose" in cfg.task:
        heads.update({"hps": dataset_meta.num_joints * 2,
                      "hm_hp": dataset_meta.num_joints, "hp_offset": 2})
    if cfg.ltrb:
        heads["ltrb"] = 4
    if cfg.ltrb_amodal:
        heads["ltrb_amodal"] = 4
    if cfg.nuscenes_att:
        heads["nuscenes_att"] = 8
    if cfg.velocity:
        heads["velocity"] = 3
    # loss weight per head; a head weighted 0 is dropped (JAX
    # config.py:292-303)
    weight_of = {"hm": cfg.hm_weight, "wh": cfg.wh_weight,
                 "reg": cfg.off_weight, "tracking": cfg.tracking_weight,
                 "hps": cfg.hp_weight, "hm_hp": cfg.hm_hp_weight,
                 "hp_offset": cfg.off_weight, "dep": cfg.dep_weight,
                 "rot": cfg.rot_weight, "dim": cfg.dim_weight,
                 "amodel_offset": cfg.amodel_offset_weight,
                 "ltrb": cfg.ltrb_weight,
                 "ltrb_amodal": cfg.ltrb_amodal_weight,
                 "nuscenes_att": cfg.nuscenes_att_weight,
                 "velocity": cfg.velocity_weight}
    heads = {h: c for h, c in heads.items() if weight_of[h] != 0}
    weights = {h: weight_of[h] for h in heads}
    head_conv = cfg.head_conv if cfg.head_conv > 0 else (
        256 if "dla" in cfg.arch else 64)
    return dataclasses.replace(
        cfg,
        num_classes=num_classes,
        input_h=input_h, input_w=input_w,
        input_res=max(input_h, input_w),
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
