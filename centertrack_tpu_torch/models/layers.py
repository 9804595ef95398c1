"""Shared building blocks. Modules take and return NCHW tensors, kept in
``torch.channels_last`` memory by the model, so that
``x.permute(0, 2, 3, 1)`` hands the DCN kernel a contiguous NHWC view.

BatchNorm follows the reference's torch settings: momentum 0.1, eps 1e-5
(reference: src/lib/model/networks/dla.py:25), and updates its running
statistics the way the JAX package's flax BatchNorm does
(models/dla.py:266-267, 291-292; ``BatchNorm`` below).

Compute dtype. Parameters are float32. Every layer computes in the
dtype of its input, casting its float32 kernel and bias to it, as
flax's ``nn.Conv(dtype=...)`` casts them (``cast_param``); the network
casts its inputs to the compute dtype once
(models/model.CenterTrackNet), so a bfloat16 network runs every conv,
UpBilinear, DCN and BatchNorm in bf16. BatchNorm takes bf16, normalises
in float32 (in train mode with float32 statistics of the batch, in eval
mode with its float32 running statistics) and returns bf16, as flax's
``BatchNorm(dtype=bf16)`` does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from centertrack_tpu_torch.ops.dcn import (deform_conv2d_local,
                                           deform_conv2d_local_plain)


def cast_param(module: nn.Module, name: str, dtype: torch.dtype):
    """The float32 parameter ``name`` of ``module`` in ``dtype``. Where
    no gradient is recorded the cast is kept and reused until the
    parameter changes (another storage or an in-place update), so that
    a bf16 network casts each weight once and not at every frame, as
    the JAX package's jit folds its casts."""
    p = getattr(module, name)
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    key = (p.data_ptr(), p._version, dtype)
    casts = module.__dict__.setdefault("_casts", {})
    hit = casts.get(name)
    if hit is None or hit[0] != key:
        hit = casts[name] = (key, p.detach().to(dtype))
    return hit[1]


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose train mode is flax's BatchNorm, as the JAX
    package trains it: batch mean and the fast biased variance
    E[x^2] - E[x]^2 (clipped at 0), y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias differentiated by autograd, and the running
    statistics folded as ra = 0.9 ra + 0.1 stat with the BIASED
    variance (``nn.BatchNorm2d`` folds in the unbiased one, n / (n - 1)
    larger, and differentiates through its own fused backward, which
    loses more precision in fp32 where a channel's mean dwarfs its
    spread). Eval mode is ``nn.BatchNorm2d``'s, on the running
    statistics.

    At bfloat16 (flax ``BatchNorm(dtype=bf16)``, whose
    ``force_float32_reductions`` holds by default) the statistics are
    float32 reductions of the bf16 input, y is computed in float32 and
    rounded to bf16 once, and the running statistics fold in float32.
    The input is cast to float32 twice, once for the statistics and
    once for y, as flax casts it in ``_compute_stats`` and promotes it
    in ``_normalize``, so that the two bf16 input gradients add as
    JAX's do."""

    def forward(self, x):
        if not self.training:
            # at bf16, F.batch_norm normalises in float32 with the float32
            # statistics and rounds the result to bf16 once
            return super().forward(x)
        axes = (0, 2, 3)
        xs = x.float()
        mean = xs.mean(dim=axes)
        var = ((xs * xs).mean(dim=axes) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean[:, None, None]) * mul[:, None, None] + \
            self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def batch_norm(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=1e-5, momentum=0.1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in the dtype of its input: the float32 kernel and
    bias are cast to it."""

    def forward(self, x):
        return self._conv_forward(x, cast_param(self, "weight", x.dtype),
                                  cast_param(self, "bias", x.dtype))


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm -> optional ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride,
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
        return F.conv_transpose2d(x, cast_param(self, "weight", x.dtype),
                                  stride=self.factor,
                                  padding=self.factor // 2,
                                  groups=self.weight.shape[0])


class DCNLayer(nn.Module):
    """Modulated deformable 3x3 conv: a plain conv predicts the 18 offset
    and 9 mask channels, the clamped DCN op samples and contracts
    (reference API: DCN(chi, cho, 3, stride=1, padding=1) —
    src/lib/model/networks/dla.py:513; JAX: models/layers.py:113-163).

    ``weight`` keeps the JAX (3, 3, Cin, Cout) layout the kernel takes.
    The op is differentiable at float32 and bf16 on both devices (the
    kernels' autograd function on CUDA, autograd through the plain
    version on the CPU); at bf16 the offsets, the mask (the sigmoid of
    the bf16 mask channels), the weight and the bias are bf16, as the
    JAX layer hands them to its op (models/layers.py:150-155).
    ``plain=True`` routes it to its plain PyTorch version on any device
    (used to check the kernels on the card).
    """

    def __init__(self, in_channels: int, features: int, mode: str = "local",
                 max_offset: int = 2):
        super().__init__()
        if mode != "local":
            raise NotImplementedError(
                f"DCN mode {mode!r}: only the clamped 'local' op is ported; "
                f"the exact DCNv2 ('gather') is queued in ROADMAP.md as a "
                f"later hand-written kernel")
        self.conv_offset_mask = Conv2d(in_channels, 27, 3, 1, 1)
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
        out = op(xh, offset, mask, cast_param(self, "weight", x.dtype),
                 cast_param(self, "bias", x.dtype), self.max_offset)
        return out.permute(0, 3, 1, 2)
