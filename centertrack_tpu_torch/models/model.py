"""Network assembly and the weight bridge to and from the JAX
package's parameter trees (reference: src/lib/model/model.py;
JAX: centertrack_tpu/models/model.py).

``CenterTrackNet.forward(x, pre_img, pre_hm)`` takes NHWC inputs and
returns ``[dict head -> NHWC float32 map]``, the JAX model's contract.
Inside, the network runs NCHW in ``torch.channels_last`` memory, in its
compute dtype (``Config.compute_dtype``; parameters stay float32).
``.train()`` and ``.eval()`` are the JAX model's ``train=`` flag: in
train mode the BatchNorm layers normalise with batch statistics and
fold them into their running statistics as flax does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from centertrack_tpu_torch.models.dla import DLASeg
from centertrack_tpu_torch.models.heads import HeadSet
from centertrack_tpu_torch.models.layers import (BatchNorm, DCNLayer,
                                                 UpBilinear)


class CenterTrackNet(nn.Module):
    """DLA-34 backbone + neck -> head maps. ``dtype`` is the compute
    dtype: the inputs are cast to it, as the JAX model casts them
    (models/model.py:83-86), and every layer computes in it."""

    def __init__(self, heads: Dict[str, int], head_conv: int = 256,
                 dla_node="dcn_local1", with_pre_img=False,
                 with_pre_hm=False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = DLASeg(dla_node, with_pre_img, with_pre_hm)
        self.heads = HeadSet(64, heads, head_conv)

    def forward(self, x, pre_img=None, pre_hm=None):
        x, pre_img, pre_hm = (
            None if t is None else t.permute(0, 3, 1, 2).to(self.dtype)
            for t in (x, pre_img, pre_hm))
        feats = self.backbone(x, pre_img, pre_hm)
        return [{k: v.permute(0, 2, 3, 1) for k, v in self.heads(f).items()}
                for f in feats]


def set_dcn_plain(model: nn.Module, plain: bool) -> None:
    """Route every DCN layer to the kernel (False) or to its plain
    PyTorch version (True)."""
    for m in model.modules():
        if isinstance(m, DCNLayer):
            m.plain = plain


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init, ``lecun_normal``: a normal of std
    sqrt(1 / fan_in) / 0.8796 truncated at two of its stds, so that the
    truncated draw has std sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_like_jax(model: CenterTrackNet, seed: int,
                  prior_bias: float = -4.6) -> None:
    """The JAX package's initial network (models/model.init_model):

    - every conv kernel and the DCN weight ``lecun_normal`` (flax's
      default; fan in = kernel area x in channels), conv biases zero;
    - the DCN offset/mask conv and the DCN bias zero, so a DCN layer
      starts as a 3x3 conv with mask 0.5 (JAX models/layers.py:140-149);
    - each UpBilinear kernel the depthwise bilinear stencil of JAX
      ``bilinear_upsample_kernel`` (models/layers.py:69-80), flipped as
      ``params_from_jax`` flips it;
    - the hm head's out bias at ``prior_bias`` (JAX models/heads.py:26);
    - BatchNorm at scale 1, bias 0, mean 0, var 1.

    The random draws come from a CPU ``torch.Generator`` seeded with
    ``seed``, in module order: the same distributions as JAX's, not its
    numbers."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.weight[0].numel(), gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, DCNLayer):
                _lecun_normal_(m.weight, m.weight[..., 0].numel(), gen)
                m.bias.zero_()
            elif isinstance(m, UpBilinear):
                m.weight.copy_(_bilinear_kernel(m.factor, m.weight.shape[0]))
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
        for m in model.modules():   # after the convs they hold
            if isinstance(m, DCNLayer):
                m.conv_offset_mask.weight.zero_()
                m.conv_offset_mask.bias.zero_()
        for name, head in model.heads.items():
            if "hm" in name:
                head.out.bias.fill_(prior_bias)


def _bilinear_kernel(factor: int, channels: int) -> torch.Tensor:
    """JAX ``bilinear_upsample_kernel(f, C)`` ((2f, 2f, 1, C), reference
    fill_up_weights) in UpBilinear's flipped (C, 1, 2f, 2f) layout."""
    size = 2 * factor
    c = (2 * factor - 1 - factor % 2) / (2.0 * factor)
    fc = math.ceil(size / 2)
    w = np.zeros((size, size), np.float32)
    for i in range(size):
        for j in range(size):
            w[i, j] = (1 - abs(i / fc - c)) * (1 - abs(j / fc - c))
    k = np.ascontiguousarray(w[::-1, ::-1])
    return torch.from_numpy(k)[None, None].repeat(channels, 1, 1, 1)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def create_model(cfg, device="cuda") -> CenterTrackNet:
    """Build the net of ``cfg`` (``arch='dla_34'``) in eval mode on
    ``device``: float32 parameters initialised as the JAX package's
    ``init_model`` initialises them (``init_like_jax``, seeded from
    ``cfg.seed``), computing in ``cfg.compute_dtype``."""
    if cfg.arch != "dla_34":
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP: other archs)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    model = CenterTrackNet(cfg.heads_dict, cfg.head_conv, cfg.dla_node,
                           cfg.pre_img, cfg.pre_hm,
                           COMPUTE_DTYPES[cfg.compute_dtype])
    init_like_jax(model, cfg.seed, cfg.prior_bias)
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
    layers.UpBilinear). Every float leaf becomes float32, whatever dtype
    the tree holds. Every leaf is consumed exactly once: a leaf this
    bridge does not know, or two leaves landing on one key, raise. Load
    the result with ``load_state_dict(strict=True)`` so that a missing
    key raises too.
    """
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        if key in sd:
            raise ValueError(f"two JAX leaves map to {key}")
        value = np.ascontiguousarray(value)
        if value.dtype != np.int64:   # float32 whatever the tree held
            value = value.astype(np.float32)
        sd[key] = torch.from_numpy(value)

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
