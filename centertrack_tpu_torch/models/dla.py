"""DLA backbone + DLAUp/IDAUp neck (reference:
src/lib/model/networks/dla.py; JAX: centertrack_tpu/models/dla.py).

Module names mirror the JAX package's so that the weight bridge is a
renaming. The CenterTrack temporal inputs — separate 7x7 stems for the
previous frame and the prior-track heatmap whose outputs are added to
the current frame's stem features — live in ``DLA.forward``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from centertrack_tpu_torch.models.layers import (ConvBNAct, DCNLayer,
                                                 UpBilinear, batch_norm)

# DLA-34: tree depth and width of the six levels (reference: dla.py:327)
DLA34_LEVELS = (1, 1, 1, 2, 2, 1)
DLA34_CHANNELS = (16, 32, 64, 128, 256, 512)


class BasicBlock(nn.Module):
    """(reference: dla.py:38-66)"""

    def __init__(self, in_channels: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBNAct(in_channels, planes, 3, stride)
        self.conv2 = ConvBNAct(planes, planes, 3, 1, act=False)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        return F.relu(self.conv2(self.conv1(x)) + residual)


class Root(nn.Module):
    """Concat children -> 1x1 conv -> BN -> ReLU; DLA-34's roots have
    no residual (reference: dla.py:154-172)"""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = ConvBNAct(in_channels, features, 1, 1, act=False)

    def forward(self, children: Sequence[torch.Tensor]):
        return F.relu(self.conv(torch.cat(list(children), dim=1)))


class Tree(nn.Module):
    """Recursive deep-aggregation tree (reference: dla.py:175-228)."""

    def __init__(self, levels: int, in_channels: int, out_channels: int,
                 stride: int = 1, level_root: bool = False,
                 root_dim: int = 0):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels + (in_channels if level_root else 0)
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if levels == 1:
            self.tree1 = BasicBlock(in_channels, out_channels, stride)
            self.tree2 = BasicBlock(out_channels, out_channels, 1)
            self.root = Root(root_dim, out_channels)
        else:
            self.tree1 = Tree(levels - 1, in_channels, out_channels, stride)
            self.tree2 = Tree(levels - 1, out_channels, out_channels, 1,
                              root_dim=root_dim + out_channels)
        # the JAX package (like the reference) creates the projection
        # whenever the widths differ; only a one-level tree reads it
        self.project = (ConvBNAct(in_channels, out_channels, 1, act=False)
                        if in_channels != out_channels else None)

    def forward(self, x, children: Optional[List[torch.Tensor]] = None):
        children = [] if children is None else list(children)
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        residual = bottom
        if self.project is not None and (self.levels == 1 or self.training):
            # a deeper tree discards it, but in train mode its BatchNorm
            # statistics advance, as in the JAX package and the reference
            residual = self.project(bottom)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DLA(nn.Module):
    """The DLA-34 pyramid backbone with pre_img/pre_hm stems
    (reference: dla.py:231-316)."""

    def __init__(self, with_pre_img: bool = False, with_pre_hm: bool = False):
        super().__init__()
        levels, ch = DLA34_LEVELS, DLA34_CHANNELS
        self.base_layer = ConvBNAct(3, ch[0], 7)
        self.pre_img_layer = ConvBNAct(3, ch[0], 7) if with_pre_img else None
        self.pre_hm_layer = ConvBNAct(1, ch[0], 7) if with_pre_hm else None
        self.level0_0 = ConvBNAct(ch[0], ch[0], 3, 1)
        self.level1_0 = ConvBNAct(ch[0], ch[1], 3, 2)
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True)

    def forward(self, x, pre_img=None, pre_hm=None):
        x = self.base_layer(x)
        if pre_img is not None and self.pre_img_layer is not None:
            x = x + self.pre_img_layer(pre_img)
        if pre_hm is not None and self.pre_hm_layer is not None:
            x = x + self.pre_hm_layer(pre_hm)
        y = []
        x = self.level0_0(x)
        y.append(x)
        x = self.level1_0(x)
        y.append(x)
        for level in (self.level2, self.level3, self.level4, self.level5):
            x = level(x)
            y.append(x)
        return y


class ConvNode(nn.Module):
    """'conv' node: 1x1 conv + BN + ReLU (reference: dla.py:466-475)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = ConvBNAct(in_channels, features, 1, 1)

    def forward(self, x):
        return self.conv(x)


class DeformNode(nn.Module):
    """'dcn' node with the clamped op: DCN 3x3 + BN + ReLU
    (reference: dla.py:506-518; JAX: models/dla.py:234-270)."""

    def __init__(self, in_channels: int, features: int,
                 max_offset: int = 2):
        super().__init__()
        self.conv = DCNLayer(in_channels, features, "local", max_offset)
        self.actf_bn = batch_norm(features)

    def forward(self, x):
        return F.relu(self.actf_bn(self.conv(x)))


def node_factory(dla_node: str):
    """(in, out) -> node module for a ``dla_node`` name
    (reference: DLA_NODE, dla.py:588-592)."""
    if dla_node == "dcn_local1":
        return lambda cin, cout: DeformNode(cin, cout, max_offset=1)
    if dla_node == "dcn_local":
        return lambda cin, cout: DeformNode(cin, cout, max_offset=2)
    if dla_node == "conv":
        return ConvNode
    raise NotImplementedError(
        f"dla_node {dla_node!r} is not ported yet: 'dcn' and 'dcn_mix' need "
        f"the exact DCNv2 kernel (ROADMAP.md), 'gcn' the other nodes")


class IDAUp(nn.Module):
    """Iterative deep aggregation over a level slice
    (reference: dla.py:520-545)."""

    def __init__(self, out_channels: int, in_channels: Sequence[int],
                 up_factors: Sequence[int], node: str):
        super().__init__()
        make = node_factory(node)
        self.n = len(in_channels)
        for i in range(1, self.n):
            # every level after the first is coarser: up_factors[i] >= 2
            setattr(self, f"proj_{i}", make(in_channels[i], out_channels))
            setattr(self, f"up_{i}",
                    UpBilinear(out_channels, int(up_factors[i])))
            setattr(self, f"node_{i}", make(out_channels, out_channels))

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        for i in range(1, self.n):
            x = getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(layers[i]))
            layers[i] = getattr(self, f"node_{i}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Pyramid of IDAUp stages (reference: dla.py:549-574)."""

    def __init__(self, channels: Sequence[int], node: str):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = [2 ** i for i in range(len(channels))]
        self.stages = len(channels) - 1
        for i in range(self.stages):
            j = len(channels) - i - 2
            setattr(self, f"ida_{i}", IDAUp(
                channels[j], in_channels[j:],
                [s // scales[j] for s in scales[j:]], node))
            # the stage leaves every level after j at level j's scale
            # and width
            scales[j + 1:] = [scales[j]] * (len(scales) - j - 1)
            in_channels[j + 1:] = [channels[j]] * (len(channels) - j - 1)

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.stages):
            j = len(layers) - i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """DLA-34 backbone + neck producing one stride-4 feature map
    (reference: dla.py:594-641; levels 2..5 feed the neck)."""

    def __init__(self, dla_node: str = "dcn_local1",
                 with_pre_img: bool = False, with_pre_hm: bool = False):
        super().__init__()
        ch = DLA34_CHANNELS
        self.base = DLA(with_pre_img, with_pre_hm)
        self.dla_up = DLAUp(ch[2:], dla_node)
        self.ida_up = IDAUp(ch[2], ch[2:5], [1, 2, 4], dla_node)

    def forward(self, x, pre_img=None, pre_hm=None):
        feats = self.base(x, pre_img, pre_hm)
        out = self.dla_up(feats[2:])
        return [self.ida_up(out[:3])[-1]]
