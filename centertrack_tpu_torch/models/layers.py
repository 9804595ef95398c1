"""Shared building blocks. Modules take and return NCHW tensors, kept in
``torch.channels_last`` memory by the model, so that
``x.permute(0, 2, 3, 1)`` hands the DCN kernel a contiguous NHWC view.

BatchNorm follows the reference's torch settings: momentum 0.1, eps 1e-5
(reference: src/lib/model/networks/dla.py:25).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from centertrack_tpu_torch.ops.dcn import (deform_conv2d_local,
                                           deform_conv2d_local_plain)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm -> optional ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride,
                              (kernel - 1) // 2, bias=False)
        self.bn = batch_norm(features)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class UpBilinear(nn.Module):
    """Trainable depthwise transposed conv of factor f (kernel 2f,
    padding f//2), the reference's upsample layer
    (reference: src/lib/model/networks/dla.py:529-532).

    The JAX package runs it as a convolution over the f-dilated input
    without flipping its kernel (models/layers.py:82-110), which is a
    transposed convolution with the kernel flipped in both spatial axes.
    ``weight`` is held in conv_transpose2d's (C, 1, 2f, 2f) layout and
    already flipped: the weight bridge (models/model.params_from_jax)
    does the flip once.
    """

    def __init__(self, channels: int, factor: int):
        super().__init__()
        k = 2 * factor
        self.factor = factor
        self.weight = nn.Parameter(torch.zeros(channels, 1, k, k))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, stride=self.factor,
                                  padding=self.factor // 2,
                                  groups=self.weight.shape[0])


class DCNLayer(nn.Module):
    """Modulated deformable 3x3 conv: a plain conv predicts the 18 offset
    and 9 mask channels, the clamped DCN op samples and contracts
    (reference API: DCN(chi, cho, 3, stride=1, padding=1) —
    src/lib/model/networks/dla.py:513; JAX: models/layers.py:113-163).

    ``weight`` keeps the JAX (3, 3, Cin, Cout) layout the kernel takes.
    ``plain=True`` routes the op to its plain PyTorch version on any
    device (used to check the kernel on the card).
    """

    def __init__(self, in_channels: int, features: int, mode: str = "local",
                 max_offset: int = 2):
        super().__init__()
        if mode != "local":
            raise NotImplementedError(
                f"DCN mode {mode!r}: only the clamped 'local' op is ported; "
                f"the exact DCNv2 ('gather') is queued in ROADMAP.md as a "
                f"later hand-written kernel")
        self.conv_offset_mask = nn.Conv2d(in_channels, 27, 3, 1, 1)
        self.weight = nn.Parameter(torch.zeros(3, 3, in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.max_offset = max_offset
        self.plain = False

    def forward(self, x):
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)
        offset = om[..., :18].contiguous()
        mask = torch.sigmoid(om[..., 18:]).contiguous()
        xh = x.permute(0, 2, 3, 1).contiguous()
        op = deform_conv2d_local_plain if self.plain else deform_conv2d_local
        out = op(xh, offset, mask, self.weight, self.bias, self.max_offset)
        return out.permute(0, 3, 1, 2)
