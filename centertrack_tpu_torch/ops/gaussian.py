"""Gaussian radius law and the pre_hm render from tracked centers
(reference: src/lib/utils/image.py:105-154, src/lib/detector.py:254-290;
JAX: centertrack_tpu/ops/gaussian.py:46-224).
"""

from __future__ import annotations

import torch


def gaussian_radius(height: torch.Tensor,
                    width: torch.Tensor) -> torch.Tensor:
    """Elementwise CornerNet radius law at IoU 0.7 (the JAX package's
    gaussian_radius_jax)."""
    min_overlap = 0.7
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


# window of one splat on large maps, as in the JAX package
PATCH = 256


def render_pre_hm(height: int, width: int, cts_int: torch.Tensor,
                  radii: torch.Tensor, ks: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Max-composited gaussian splats of the valid entries into an
    (H, W, 1) map. Each object contributes
    k * exp(-(dx^2 + dy^2) / (2 sigma^2)) for |dx|, |dy| <= r, with
    sigma = (2r + 1) / 6 (cts_int (N, 2) integer (x, y), radii (N,) int).

    Maps of up to 128 x 128 pixels render densely over all N entries, as
    the JAX package does. Larger maps splat a (PATCH x PATCH) window per
    live object into a padded canvas, radius capped at PATCH // 2 - 1 as
    in the JAX package; finding the live objects reads their count back
    to the host once. Max-splatting commutes, so the order of the
    objects does not change the result.
    """
    dev = cts_int.device
    ks = ks.float()
    if height * width <= 128 * 128:
        ys = torch.arange(height, dtype=torch.float32, device=dev)
        xs = torch.arange(width, dtype=torch.float32, device=dev)
        dx = xs[None, None, :] - cts_int[:, 0].float()[:, None, None]
        dy = ys[None, :, None] - cts_int[:, 1].float()[:, None, None]
        r = radii.float()[:, None, None]
        sigma = (2.0 * r + 1.0) / 6.0
        g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
        in_box = (dx.abs() <= r) & (dy.abs() <= r)
        g = g * in_box * ks[:, None, None] * valid.float()[:, None, None]
        return g.amax(dim=0).clamp(min=0.0)[..., None]

    patch, half = PATCH, PATCH // 2
    live = torch.nonzero(valid.bool()).flatten()
    pw = width + 2 * patch
    canvas = torch.zeros((height + 2 * patch) * pw, dtype=torch.float32,
                         device=dev)
    if live.numel():
        r = radii[live].clamp(max=half - 1).float()[:, None, None]
        off = torch.arange(patch, device=dev) - half
        dy = off.float()[None, :, None]
        dx = off.float()[None, None, :]
        sigma = (2.0 * r + 1.0) / 6.0
        g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma + 1e-12))
        g = g * ((dx.abs() <= r) & (dy.abs() <= r)) * ks[live][:, None, None]
        cts = cts_int[live].long()
        rows = cts[:, 1, None, None] + patch + off[None, :, None]
        cols = cts[:, 0, None, None] + patch + off[None, None, :]
        canvas.scatter_reduce_(0, (rows * pw + cols).flatten(), g.flatten(),
                               "amax")
    hm = canvas.view(height + 2 * patch, pw)[patch:patch + height,
                                             patch:patch + width]
    return hm[..., None]
