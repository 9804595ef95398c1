"""Tracking-task configuration: the subset of the JAX package's
``Config``, ``parse_task`` and ``set_heads`` that the fused serving path
and the trainer read (reference: src/lib/opts.py:257-388; JAX:
centertrack_tpu/config.py), plus the MOT17 dataset meta the serving
benchmark uses.
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

    # --- system ----------------------------------------------------------
    seed: int = 317                # seeds create_model's initialisation

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
    # above) | dcn_local (clamped, R=2) | dcn_local1 (R=1) | conv; the
    # exact op serves on CUDA and trains on the CPU only (ROADMAP A4b)
    dla_node: str = "dcn"
    head_conv: int = -1            # -1 => 256 for dla, 64 otherwise
    down_ratio: int = 4
    num_classes: int = -1
    prior_bias: float = -4.6       # initial bias of the hm head's out conv

    # --- input (-1: the dataset's default resolution) ---------------------
    input_h: int = -1
    input_w: int = -1

    # --- test ------------------------------------------------------------
    K: int = 100
    out_thresh: float = -1.0

    # --- tracking --------------------------------------------------------
    tracking: bool = False
    pre_hm: bool = False
    pre_thresh: float = -1.0
    track_thresh: float = 0.3
    new_thresh: float = 0.3
    max_age: int = -1
    max_tracks: int = 256          # capacity of the on-device track state

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

    # --- loss weights (JAX config.py:173-188) ------------------------------
    tracking_weight: float = 1.0
    hm_weight: float = 1.0
    off_weight: float = 1.0
    wh_weight: float = 0.1

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
    """Input/output resolution and the head dict of a tracking task
    (reference: src/lib/opts.py:329-388). ``dataset_meta`` needs
    ``num_categories`` and ``default_resolution``."""
    extra = [t for t in cfg.task.split(",") if t not in ("tracking", "")]
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
    # loss weight per head; a head weighted 0 is dropped (JAX
    # config.py:292-303)
    weight_of = {"hm": cfg.hm_weight, "wh": cfg.wh_weight,
                 "reg": cfg.off_weight, "tracking": cfg.tracking_weight}
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


class MOT_META:
    """MOT17 pedestrian tracking at 544x960, the serving benchmark's
    primary configuration (reference: src/lib/dataset/datasets/mot.py)."""
    num_categories = 1
    default_resolution = [544, 960]
    mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
    std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)
