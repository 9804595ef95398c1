"""On-device affine warp + normalization, the serving prologue
(reference: src/lib/detector.py:207-239; JAX: centertrack_tpu/ops/warp.py).
"""

from __future__ import annotations

import torch


def affine_warp_separable(image: torch.Tensor, inv_trans: torch.Tensor,
                          out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear warp of an (H, W, C) image by an AXIS-ALIGNED inverse
    affine (rot == 0) as two matmuls with hat-weight matrices,

        out = W_y @ image @ W_x^T      (per channel),

    W_y[o, i] = max(0, 1 - |sy_o - i|) with sy_o = inv[1,1]*o + inv[1,2]:
    exact bilinear interpolation with zeros outside the image. Runs in
    float32; on the card that needs PyTorch's default full-float32
    matmul (``torch.backends.cuda.matmul.allow_tf32`` False).
    Returns (out_h, out_w, C) float32.
    """
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
    img_f = image.permute(2, 0, 1).float()                      # C, H, W
    tmp = torch.matmul(wy, img_f)                               # C, oh, W
    out = torch.matmul(tmp, wx.t())                             # C, oh, ow
    return out.permute(1, 2, 0)


def preprocess_frame(frame_u8: torch.Tensor, inv_trans: torch.Tensor,
                     out_h: int, out_w: int, mean: torch.Tensor,
                     std: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, 3) frame -> normalized (1, out_h, out_w, 3) network
    input: separable warp, /255, mean/std (reference: detector.py:219-224).
    """
    warped = affine_warp_separable(frame_u8, inv_trans, out_h, out_w)
    return ((warped / 255.0 - mean) / std)[None]
