"""On-device affine warp + normalization, the serving prologue
(reference: src/lib/detector.py:207-239; JAX: centertrack_tpu/ops/warp.py).

Two precisions of the separable warp's matmuls, as the JAX package
chooses them (``warp_precision_for``): ``"highest"`` is float32 (the
JAX ``Precision.HIGHEST``, pixel-exact), ``"default"`` is what a TPU's
one-pass ``Precision.DEFAULT`` computes: each matmul's operands are
rounded to bf16 (the hat-weight matrices, the image, which is exact in
bf16 as uint8, and the first product where it feeds the second), their
products are exact and the sums run in float32. On the card that is a
float32 matmul of the rounded operands.

XLA on the CPU ignores the precision and runs both in float32, so the
CPU comparisons with the JAX package run both with
``warp_precision="highest"``; ``"default"`` is checked against a numpy
construction of the rounded operands.
"""

from __future__ import annotations

import torch


def warp_precision_for(cfg) -> str:
    """``Config.warp_precision`` -> ``"highest"`` or ``"default"``:
    ``auto`` takes ``default`` when the network computes in bfloat16 (its
    first conv rounds the input to bf16 anyway) and ``highest`` otherwise
    (JAX ops/warp.py:140-157)."""
    mode = cfg.warp_precision   # validated by Config
    if mode == "auto":
        return "default" if cfg.compute_dtype == "bfloat16" else "highest"
    return "highest" if mode == "highest" else "default"


def _operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A float32 matmul operand, rounded to bf16 at ``default``."""
    t = t.float()
    return t.to(torch.bfloat16).float() if precision == "default" else t


def affine_warp_separable(image: torch.Tensor, inv_trans: torch.Tensor,
                          out_h: int, out_w: int,
                          precision: str = "highest") -> torch.Tensor:
    """Bilinear warp of an (H, W, C) image by an AXIS-ALIGNED inverse
    affine (rot == 0) as two matmuls with hat-weight matrices,

        out = W_y @ image @ W_x^T      (per channel),

    W_y[o, i] = max(0, 1 - |sy_o - i|) with sy_o = inv[1,1]*o + inv[1,2]:
    exact bilinear interpolation with zeros outside the image. The
    matmuls run in float32 (at ``default`` on bf16-rounded operands); on
    the card that needs PyTorch's default full-float32 matmul
    (``torch.backends.cuda.matmul.allow_tf32`` False).
    Returns (out_h, out_w, C) float32.
    """
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be highest|default, got "
                         f"{precision!r}")
    h, w, _ = image.shape
    dev = image.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    sy = inv_trans[1, 1] * ys + inv_trans[1, 2]
    sx = inv_trans[0, 0] * xs + inv_trans[0, 2]
    wy = (1.0 - (sy[:, None] - torch.arange(
        h, dtype=torch.float32, device=dev)[None, :]).abs()).clamp(min=0.0)
    wx = (1.0 - (sx[:, None] - torch.arange(
        w, dtype=torch.float32, device=dev)[None, :]).abs()).clamp(min=0.0)
    img_f = image.permute(2, 0, 1)                              # C, H, W
    tmp = torch.matmul(_operand(wy, precision),
                       _operand(img_f, precision))              # C, oh, W
    out = torch.matmul(_operand(tmp, precision),
                       _operand(wx, precision).t())             # C, oh, ow
    return out.permute(1, 2, 0)


def preprocess_frame(frame_u8: torch.Tensor, inv_trans: torch.Tensor,
                     out_h: int, out_w: int, mean: torch.Tensor,
                     std: torch.Tensor,
                     precision: str = "highest") -> torch.Tensor:
    """uint8 (H, W, 3) frame -> normalized (1, out_h, out_w, 3) network
    input: separable warp at ``precision``, /255, mean/std (reference:
    detector.py:219-224).
    """
    warped = affine_warp_separable(frame_u8, inv_trans, out_h, out_w,
                                   precision)
    return ((warped / 255.0 - mean) / std)[None]
