"""Output heads (reference: src/lib/model/networks/base_model.py:24-65;
JAX: centertrack_tpu/models/heads.py).

Each head is 3x3 conv(head_conv) -> ReLU -> 1x1 out conv, computed in
the dtype of its input; its map is returned in float32, as the JAX
HeadSet casts it (models/heads.py:64).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from centertrack_tpu_torch.models.layers import Conv2d


class Head(nn.Module):
    def __init__(self, in_channels: int, out_features: int, head_conv: int):
        super().__init__()
        self.conv_0 = Conv2d(in_channels, head_conv, 3, 1, 1)
        self.out = Conv2d(head_conv, out_features, 1)

    def forward(self, x):
        return self.out(F.relu(self.conv_0(x))).float()


class HeadSet(nn.ModuleDict):
    """Every head over one feature map -> dict of NCHW maps."""

    def __init__(self, in_channels: int, heads: Dict[str, int],
                 head_conv: int):
        super().__init__({name: Head(in_channels, classes, head_conv)
                          for name, classes in sorted(heads.items())})

    def forward(self, feat) -> Dict[str, torch.Tensor]:
        return {name: head(feat) for name, head in self.items()}
