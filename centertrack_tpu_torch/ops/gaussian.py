"""Gaussian radius law, the GT heatmap render and the pre_hm render
(reference: src/lib/utils/image.py:105-154, src/lib/detector.py:254-290;
JAX: centertrack_tpu/ops/gaussian.py:46-224).

``splat_pre_hm`` is the pre_hm render on maps past 128 x 128, a kernel
of ``csrc/tracker.cu`` with a leading stream axis: the max-composited
gaussian splat of JAX ``render_pre_hm(compact=True)``, every valid slot
adding k * exp(-(dx^2 + dy^2) / (2 sigma^2 + 1e-12)), sigma =
(2r + 1) / 6, on |dx|, |dy| <= r with r capped at ``MAX_RADIUS``,
clipped to the map. It replaces no ``pl.pallas_call``: JAX runs it as an
XLA loop inside its one compiled step. On CUDA tensors the wrapper
launches the kernel on the current stream (it allocates nothing and
nothing synchronises, so a CUDA graph can capture it) or raises; on CPU
tensors it takes the plain version, which reads the live slots on the
host and is what the tests and the chip smoke hold the kernel against.
"""

from __future__ import annotations

import torch

from centertrack_tpu_torch.ops import _build

# launches of the splat kernel in this process; read and reset by callers
LAUNCHES = {"splat_pre_hm": 0}
# symbol -> (pointer arguments, int arguments); both end with the stream
_SIGNATURES = {"splat_pre_hm": (5, 5)}

# the splat window of the JAX serving render (render_pre_hm's ``patch``)
# caps the radius
PATCH = 256
MAX_RADIUS = PATCH // 2 - 1
# maps of at most this many pixels render densely, without the kernel
DENSE_MAX_PIXELS = 128 * 128


def _kernel(symbol: str):
    return _build.launcher("tracker", symbol, *_SIGNATURES[symbol])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


def render_gaussians(height: int, width: int, num_channels: int,
                     cts_int: torch.Tensor, radii: torch.Tensor,
                     channels: torch.Tensor, ks: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """N truncated gaussians into an (H, W, C) heatmap, max-composited
    per channel (JAX: ops/gaussian.py:96-137). Object n adds
    k_n * exp(-(dx^2 + dy^2) / (2 sigma^2)) for |dx|, |dy| <= r_n,
    sigma = (2 r_n + 1) / 6, to channel ``channels[n]``; invalid objects
    add nothing. cts_int (N, 2) integer (x, y); radii, channels (N,)
    int; ks (N,) float; valid (N,) bool."""
    dev = cts_int.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    dx = xs[None, None, :] - cts_int[:, 0].float()[:, None, None]
    dy = ys[None, :, None] - cts_int[:, 1].float()[:, None, None]
    r = radii.float()[:, None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    in_box = (dx.abs() <= r) & (dy.abs() <= r)
    g = g * in_box * ks.float()[:, None, None] * valid.float()[:, None, None]
    # dead objects go to an extra channel that is dropped
    seg = torch.where(valid.bool(), channels.long(), num_channels)
    hm = torch.zeros((num_channels + 1, height * width), dtype=torch.float32,
                     device=dev)
    hm.scatter_reduce_(0, seg[:, None].expand(-1, height * width),
                       g.reshape(-1, height * width), "amax")
    return hm[:num_channels].reshape(num_channels, height, width).permute(
        1, 2, 0)


def render_pre_hm(height: int, width: int, cts_int: torch.Tensor,
                  radii: torch.Tensor, ks: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Max-composited gaussian splats of the valid entries of each stream
    into an (S, H, W, 1) map. Each object contributes
    k * exp(-(dx^2 + dy^2) / (2 sigma^2)) for |dx|, |dy| <= r, with
    sigma = (2r + 1) / 6 (cts_int (S, N, 2) integer (x, y), radii (S, N)
    int, ks (S, N), valid (S, N) bool).

    Maps of up to 128 x 128 pixels render densely over all N entries, as
    the JAX package does. Larger maps go to ``splat_pre_hm`` (a window
    per live object, radius capped at ``MAX_RADIUS`` as in the JAX
    package): its kernel on the card, which reads nothing back
    to the host. Max-splatting commutes, so the order of the objects does
    not change the result.
    """
    dev = cts_int.device
    if height * width <= DENSE_MAX_PIXELS:
        ys = torch.arange(height, dtype=torch.float32, device=dev)
        xs = torch.arange(width, dtype=torch.float32, device=dev)
        dx = xs[None, None, None, :] - cts_int[..., 0].float()[..., None, None]
        dy = ys[None, None, :, None] - cts_int[..., 1].float()[..., None, None]
        r = radii.float()[..., None, None]
        sigma = (2.0 * r + 1.0) / 6.0
        g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
        in_box = (dx.abs() <= r) & (dy.abs() <= r)
        g = (g * in_box * ks.float()[..., None, None]
             * valid.float()[..., None, None])
        return g.amax(dim=1).clamp(min=0.0)[..., None]
    return splat_pre_hm(height, width, cts_int, radii, ks, valid)[..., None]


def splat_pre_hm_plain(height: int, width: int, cts_int: torch.Tensor,
                       radii: torch.Tensor, ks: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """The plain version of ``splat_pre_hm``: a (PATCH x PATCH) window per
    live slot, scatter-maxed into a canvas padded by PATCH (as the JAX
    render), the live slots found on the host. Returns (S, H, W)."""
    dev = cts_int.device
    s = cts_int.shape[0]
    patch, half = PATCH, PATCH // 2
    ph, pw = height + 2 * patch, width + 2 * patch
    canvas = torch.zeros(s * ph * pw, dtype=torch.float32, device=dev)
    live = torch.nonzero(valid.bool().reshape(-1).cpu()).flatten().to(dev)
    if live.numel():
        stream = (live // cts_int.shape[1])[:, None, None]
        r = radii.reshape(-1)[live].clamp(max=MAX_RADIUS).float()[
            :, None, None]
        off = torch.arange(patch, device=dev) - half
        dy = off.float()[None, :, None]
        dx = off.float()[None, None, :]
        sigma = (2.0 * r + 1.0) / 6.0
        g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma + 1e-12))
        g = g * ((dx.abs() <= r) & (dy.abs() <= r)) * ks.float().reshape(
            -1)[live][:, None, None]
        cts = cts_int.reshape(-1, 2)[live].long()
        rows = cts[:, 1, None, None] + patch + off[None, :, None]
        cols = cts[:, 0, None, None] + patch + off[None, None, :]
        canvas.scatter_reduce_(0, ((stream * ph + rows) * pw + cols).flatten(),
                               g.flatten(), "amax")
    return canvas.view(s, ph, pw)[:, patch:patch + height,
                                  patch:patch + width]


def splat_pre_hm(height: int, width: int, cts_int: torch.Tensor,
                 radii: torch.Tensor, ks: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """cts_int (S, T, 2) integer (x, y), radii (S, T) integer, ks (S, T),
    valid (S, T) -> the (S, H, W) float32 canvas: the kernel on CUDA
    tensors, the plain version on CPU ones."""
    s, t = valid.shape
    if (tuple(cts_int.shape) != (s, t, 2) or tuple(radii.shape) != (s, t)
            or tuple(ks.shape) != (s, t)):
        raise ValueError(f"splat_pre_hm: cts {tuple(cts_int.shape)}, radii "
                         f"{tuple(radii.shape)}, ks {tuple(ks.shape)} do "
                         f"not fit valid {(s, t)}")
    devices = {x.device for x in (cts_int, radii, ks, valid)}
    if len(devices) != 1:
        raise ValueError(f"splat_pre_hm: inputs on several devices "
                         f"{devices}")
    if valid.device.type != "cuda":
        return splat_pre_hm_plain(height, width, cts_int, radii, ks, valid)
    return launch_splat_pre_hm(
        height, width, cts_int.to(torch.int32).contiguous(),
        radii.to(torch.int32).contiguous(), ks.float().contiguous(),
        valid.bool().contiguous())


def launch_splat_pre_hm(height, width, cts_int, radii, ks, valid):
    """``splat_pre_hm`` (the kernel) on contiguous CUDA int32 cts (S, T,
    2) and radii, float32 ks and bool valid (S, T)."""
    s, t = valid.shape
    canvas = torch.empty((s, height, width), dtype=torch.float32,
                         device=valid.device)
    rc = _kernel("splat_pre_hm")(
        cts_int.data_ptr(), radii.data_ptr(), ks.data_ptr(),
        valid.data_ptr(), canvas.data_ptr(), s, t, height, width,
        MAX_RADIUS, _stream(valid))
    if rc != 0:
        raise RuntimeError(f"splat_pre_hm launch failed: CUDA error {rc}")
    LAUNCHES["splat_pre_hm"] += 1
    return canvas
