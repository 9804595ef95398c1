"""Network assembly and the weight bridge to and from the JAX
package's parameter trees (reference: src/lib/model/model.py;
JAX: centertrack_tpu/models/model.py).

``CenterTrackNet.forward(x, pre_img, pre_hm)`` takes NHWC inputs and
returns ``[dict head -> NHWC map]``, the JAX model's contract. Inside,
the network runs NCHW in ``torch.channels_last`` memory. ``.train()``
and ``.eval()`` are the JAX model's ``train=`` flag: in train mode the
BatchNorm layers normalise with batch statistics and fold them into
their running statistics as flax does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from centertrack_tpu_torch.models.dla import DLASeg
from centertrack_tpu_torch.models.heads import HeadSet
from centertrack_tpu_torch.models.layers import DCNLayer, UpBilinear


def _nchw(x):
    return None if x is None else x.permute(0, 3, 1, 2)


class CenterTrackNet(nn.Module):
    """DLA-34 backbone + neck -> head maps."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 256,
                 dla_node="dcn_local1", with_pre_img=False,
                 with_pre_hm=False):
        super().__init__()
        self.backbone = DLASeg(dla_node, with_pre_img, with_pre_hm)
        self.heads = HeadSet(64, heads, head_conv)

    def forward(self, x, pre_img=None, pre_hm=None):
        feats = self.backbone(_nchw(x), _nchw(pre_img), _nchw(pre_hm))
        return [{k: v.permute(0, 2, 3, 1) for k, v in self.heads(f).items()}
                for f in feats]


def set_dcn_plain(model: nn.Module, plain: bool) -> None:
    """Route every DCN layer to the kernel (False) or to its plain
    PyTorch version (True)."""
    for m in model.modules():
        if isinstance(m, DCNLayer):
            m.plain = plain


def create_model(cfg, device="cuda") -> CenterTrackNet:
    """Build the float32 net of ``cfg`` (``arch='dla_34'``) in eval mode
    on ``device``."""
    if cfg.arch != "dla_34":
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP: other archs)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    model = CenterTrackNet(cfg.heads_dict, cfg.head_conv, cfg.dla_node,
                           cfg.pre_img, cfg.pre_hm)
    model = model.eval().to(device)
    # channels_last for the convolutions only: the DCN weight keeps its
    # contiguous (3, 3, Cin, Cout) layout
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.to(memory_format=torch.channels_last)
    return model


def _flatten(tree, path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def params_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX (params, batch_stats) trees -> a state_dict of this port.

    Convolutions map HWIO -> OIHW; BatchNorm scale/bias/mean/var map to
    weight/bias/running_mean/running_var; the DCN weight keeps its
    (3, 3, Cin, Cout) layout; the upsampling kernels (up_*) become
    conv_transpose2d weights, flipped in both spatial axes (see
    layers.UpBilinear). Every leaf is consumed exactly once: a leaf this
    bridge does not know, or two leaves landing on one key, raise. Load
    the result with ``load_state_dict(strict=True)`` so that a missing
    key raises too.
    """
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        if key in sd:
            raise ValueError(f"two JAX leaves map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))

    for path, a in _flatten(params):
        *mod, leaf = path
        prefix = ".".join(mod)
        if leaf == "kernel" and mod and mod[-1].startswith("up_"):
            # (2f, 2f, 1, C) -> (C, 1, 2f, 2f), spatially flipped
            put(prefix + ".weight", a.transpose(3, 2, 0, 1)[:, :, ::-1, ::-1])
        elif leaf == "kernel":
            put(prefix + ".weight", a.transpose(3, 2, 0, 1))
        elif leaf in ("scale", "weight"):
            # BN scale, or the DCN weight in its JAX layout
            put(prefix + ".weight", a)
        elif leaf == "bias":
            put(prefix + ".bias", a)
        else:
            raise ValueError(f"unknown JAX parameter {'/'.join(path)}")
    for path, a in _flatten(batch_stats):
        *mod, leaf = path
        prefix = ".".join(mod)
        if leaf == "mean":
            put(prefix + ".running_mean", a)
            put(prefix + ".num_batches_tracked", np.zeros((), np.int64))
        elif leaf == "var":
            put(prefix + ".running_var", a)
        else:
            raise ValueError(f"unknown JAX batch stat {'/'.join(path)}")
    return sd


def params_to_jax(model: nn.Module) -> Tuple[Dict, Dict]:
    """The inverse of ``params_from_jax``: the model's state as the JAX
    package's (params, batch_stats) trees of float32 numpy arrays, the
    payload ``centertrack_tpu.models.model.save_model`` writes.
    ``num_batches_tracked`` has no JAX counterpart and is left out."""
    params: Dict = {}
    batch_stats: Dict = {}

    def put(tree, path, leaf, value):
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        if leaf in node:
            raise ValueError(f"two tensors map to {'/'.join(path)}/{leaf}")
        node[leaf] = np.ascontiguousarray(value, dtype=np.float32)

    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        owner = model.get_submodule(".".join(path))
        if leaf == "num_batches_tracked":
            continue
        if isinstance(owner, nn.BatchNorm2d):
            names = {"weight": "scale", "bias": "bias",
                     "running_mean": "mean", "running_var": "var"}
            tree = params if leaf in ("weight", "bias") else batch_stats
            put(tree, path, names[leaf], a)
        elif isinstance(owner, UpBilinear):
            # (C, 1, 2f, 2f), flipped -> (2f, 2f, 1, C)
            put(params, path, "kernel",
                a[:, :, ::-1, ::-1].transpose(2, 3, 1, 0))
        elif isinstance(owner, nn.Conv2d) and leaf == "weight":
            put(params, path, "kernel", a.transpose(2, 3, 1, 0))
        elif leaf in ("weight", "bias"):
            # conv bias, or the DCN weight/bias in their JAX layout
            put(params, path, leaf, a)
        else:
            raise ValueError(f"no JAX counterpart for {key}")
    return params, batch_stats
