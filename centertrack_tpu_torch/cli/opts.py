"""argparse <-> Config bridge (reference: src/lib/opts.py; JAX:
centertrack_tpu/cli/opts.py).

Flags are generated from the port's Config dataclass, so every config
field is a CLI flag with the same name (booleans become --flag
store_true, or store_false where the default is True). Every flag of the
JAX package's CLI parses: a JAX field the port does not have yet
(``UNPORTED``) still parses, and set away from JAX's default raises
``NotImplementedError`` naming the ROADMAP item that ports it.

Two flags of the port's own: ``--device {cuda,cpu}`` (the entry points
run on the card unless asked for the CPU), and ``--resume``, resolved
here once as upstream's opts.py:324-325 does: without ``--load_model``
it points ``load_model`` at exp/<task>/<exp_id>/model_last.ckpt, for
training and test alike. (The JAX package resolves it in cli/main.py
only, so its cli.test --resume scores a fresh network; ROADMAP C9.)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Tuple

from centertrack_tpu_torch.config import Config, finalize


_DERIVED = {"pre_img", "fix_res", "num_stacks", "output_h", "output_w",
            "heads", "weights", "head_convs"}

# JAX Config fields the port has no field for yet: name -> (the ROADMAP
# item that ports it, JAX's default). ``local_impl`` picks an XLA
# schedule of JAX's clamped DCN; the port's planners choose its kernels'
# routes, so it parses and is ignored.
UNPORTED = {
    "num_devices": ("A10", 1),
    **{name: ("A11", default) for name, default in (
        ("grad_checkpoint", False), ("debug", 0), ("vis_thresh", 0.3))},
    **{name: ("A13", default) for name, default in (
        ("backbone", "dla34"), ("neck", "dlaup"), ("head_kernel", 3),
        ("num_head_conv", 1), ("num_layers", 101),
        ("msra_outchannel", 256))},
    **{name: ("A14", default) for name, default in (
        ("model_output_list", False), ("reg_loss", "l1"),
        ("custom_num_categories", -1), ("custom_input_h", -1),
        ("custom_input_w", -1))},
}
IGNORED = {"local_impl": "auto"}

# help of the Config fields that have one (the ddd and pose tasks'; JAX
# cli/opts.py generates its flags without help)
HELP = {
    "hp_weight": "loss weight of the keypoint offset head hps "
                 "(multi_pose); 0 drops the head",
    "hm_hp_weight": "loss weight of the keypoint heatmap head hm_hp "
                    "(multi_pose); 0 drops the head",
    "amodel_offset_weight": "loss weight of the amodal-centre offset head "
                            "(ddd); 0 drops the head",
    "dep_weight": "loss weight of the depth head (ddd); 0 drops the head",
    "dim_weight": "loss weight of the 3D size head (ddd); 0 drops the head",
    "rot_weight": "loss weight of the 8-bin orientation head (ddd); 0 "
                  "drops the head",
    "nuscenes_att": "add the 8-class nuScenes attribute head",
    "nuscenes_att_weight": "loss weight of the nuScenes attribute head",
    "velocity": "add the 3D velocity head",
    "velocity_weight": "loss weight of the velocity head",
    "depth_scale": "multiplies the decoded depth, 1 / sigmoid(dep) - 1",
    "test_focal_length": "focal length in pixels of the default camera of "
                         "the ddd lift (a frame without calib); -1 takes "
                         "the dataset's rest_focal_length",
}


def _add_flag(parser, name, default, help=None):
    flag = "--" + name
    if isinstance(default, bool):
        parser.add_argument(flag, action="store_false" if default
                            else "store_true", help=help)
    elif isinstance(default, tuple):
        parser.add_argument(flag, default=None, type=str, help=help)
    elif isinstance(default, int):
        parser.add_argument(flag, default=default, type=int, help=help)
    elif isinstance(default, float):
        parser.add_argument(flag, default=default, type=float, help=help)
    else:
        parser.add_argument(flag, default=default, type=str, help=help)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="centertrack-tpu-torch")
    parser.add_argument(
        "task", default="", nargs="?",
        help="ctdet | ddd | multi_pose | tracking, or combined with ','")
    parser.add_argument("--demo", default="",
                        help="path to an image or a folder of images "
                             "(cli/demo.py; video and webcam: ROADMAP "
                             "A14)")
    parser.add_argument("--save_video", action="store_true")
    parser.add_argument("--save_results", action="store_true")
    parser.add_argument("--save_framerate", type=int, default=30)
    parser.add_argument("--video_out", default="")
    parser.add_argument("--load_results", default="")
    parser.add_argument("--eval_val", action="store_true")
    parser.add_argument(
        "--multi_stream", type=int, default=0,
        help="evaluate N videos concurrently through one batched step "
             "(MultiStreamDetector); tracking tasks only, incompatible "
             "with --load_results/--public_det")
    parser.add_argument("--fused", action="store_true",
                        help="demo: the FusedDetector engine")
    parser.add_argument("--chunk", type=int, default=0,
                        help="demo: run_chunk over F frames a call")
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the network runs: the card (default; raises without "
             "one) or the CPU, where each kernel takes its plain version")
    for f in dataclasses.fields(Config):
        if f.name in _DERIVED or f.name == "task":
            continue
        _add_flag(parser, f.name, f.default, help=HELP.get(f.name))
    for name, (item, default) in UNPORTED.items():
        _add_flag(parser, name, default,
                  help=f"not ported yet (ROADMAP {item}): only JAX's "
                       f"default {default!r} is taken")
    for name, default in IGNORED.items():
        _add_flag(parser, name, default,
                  help="JAX's XLA schedule of the clamped DCN; accepted and "
                       "ignored: the port's planners choose its kernels' "
                       "routes")
    return parser


def exp_dir(cfg) -> str:
    """The run's directory, exp/<task>/<exp_id> (reference:
    opts.py:290-296)."""
    return os.path.join("exp", cfg.task.replace(",", "_"), cfg.exp_id)


def args_to_config(args) -> Config:
    """The parsed flags as the port's Config (before parse_task and
    set_heads). A JAX-only field away from JAX's default raises; with
    ``resume`` and no ``load_model``, ``load_model`` is the run's
    model_last.ckpt."""
    for name, (item, default) in UNPORTED.items():
        v = getattr(args, name, default)
        if v is not None and v != default:
            raise NotImplementedError(
                f"--{name} {v!r}: the port has no {name} yet (ROADMAP "
                f"{item}); only JAX's default {default!r} is taken")
    kwargs = {"task": args.task}
    for f in dataclasses.fields(Config):
        if f.name in _DERIVED or f.name == "task":
            continue
        v = getattr(args, f.name, None)
        if v is None:
            continue
        if isinstance(f.default, tuple) and isinstance(v, str):
            elt = float if any(
                isinstance(x, float) for x in f.default) else int
            v = tuple(elt(x) for x in v.split(","))
        kwargs[f.name] = v
    cfg = Config(**kwargs)
    if cfg.resume and not cfg.load_model:
        cfg = dataclasses.replace(
            cfg, load_model=os.path.join(exp_dir(cfg), "model_last.ckpt"))
    return cfg


def parse(argv=None) -> Tuple[Config, argparse.Namespace]:
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = args_to_config(args)
    cfg = finalize(cfg)
    return cfg, args


DEFAULT_DATASET_FOR_TASK = {
    # (reference: opts.py:390-403)
    "ctdet": "coco", "multi_pose": "coco_hp", "ddd": "nuscenes",
    "tracking": "coco", "tracking,ctdet": "coco",
    "tracking,multi_pose": "coco_hp", "tracking,ddd": "nuscenes",
}


def parse_demo(argv=None) -> Tuple[Config, argparse.Namespace]:
    """Demo-style init: dataset defaulted from the task
    (reference: opts.init, opts.py:390-403)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dataset == "coco" and args.task in DEFAULT_DATASET_FOR_TASK:
        args.dataset = DEFAULT_DATASET_FOR_TASK[args.task]
    cfg = args_to_config(args)
    cfg = finalize(cfg)
    return cfg, args
