"""The serving step's association kernel (``csrc/tracker.cu``) and its
plain PyTorch version, with a leading stream axis.

``greedy_assign`` is the row-ordered greedy association of JAX
``engine/device_tracker.greedy_assign`` (a K-step ``lax.fori_loop``):
dist (S, K, T) float32 with invalid entries >= 1e18 -> match (S, K)
int32, -1 for no match. Rows run in order; each takes the first minimal
column not yet taken, if that minimum is below 1e16; a row holding a
NaN matches nothing and takes nothing, as JAX's ``argmin`` makes it.

It replaces no ``pl.pallas_call``: JAX runs it as an XLA loop inside its
one compiled step. On a CUDA tensor the wrapper launches the kernel on
the current stream (the kernel allocates nothing and nothing
synchronises, so a CUDA graph can capture it) or raises; on a CPU
tensor it takes the plain version, which is also what the tests and the
chip smoke hold the kernel against. The pre_hm splat, the other kernel
of ``csrc/tracker.cu``, is ``ops/gaussian.splat_pre_hm``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from centertrack_tpu_torch.ops import _build

# launches of the kernel in this process; read and reset by callers
LAUNCHES = {"greedy_assign": 0}

# symbol -> (pointer arguments, int arguments); both end with the stream
_SIGNATURES = {"greedy_assign": (2, 3)}
# the kernel holds up to 32 columns a lane of one warp
GREEDY_MAX_SLOTS = 1024


def _kernel(symbol: str):
    return _build.launcher("tracker", symbol, *_SIGNATURES[symbol])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def greedy_assign_rows(dist: torch.Tensor, rows: Sequence[int]
                       ) -> torch.Tensor:
    """One stream's greedy assignment, plain: dist (K, T), ``rows``
    (increasing) the rows that may match; a row left out must match
    nothing (all invalid, or a NaN). Returns (K,) int32."""
    k, _ = dist.shape
    dist = dist.clone()
    match = torch.full((k,), -1, dtype=torch.int32, device=dist.device)
    big = torch.tensor(1e18, dtype=dist.dtype, device=dist.device)
    for i in rows:
        j = torch.argmin(dist[i]).view(1)
        ok = dist[i].gather(0, j) < 1e16
        match[i] = torch.where(ok, j, -1)[0].to(torch.int32)
        col = dist.index_select(1, j)
        dist.index_copy_(1, j, torch.where(ok, big, col))
    return match


def greedy_assign_plain(dist: torch.Tensor) -> torch.Tensor:
    """The plain version of ``greedy_assign``: (S, K, T) -> (S, K) int32,
    all K rows of each stream in order, as JAX's loop."""
    return torch.stack([greedy_assign_rows(d, range(d.shape[0]))
                        for d in dist])


def greedy_assign(dist: torch.Tensor) -> torch.Tensor:
    """(S, K, T) float32 -> (S, K) int32 matched column per row, -1 if
    none: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if dist.dim() != 3 or dist.dtype != torch.float32:
        raise ValueError(f"greedy_assign: dist must be float32 (S, K, T), "
                         f"got {dist.dtype} {tuple(dist.shape)}")
    if dist.device.type != "cuda":
        return greedy_assign_plain(dist)
    return launch_greedy_assign(dist.contiguous())


def launch_greedy_assign(dist: torch.Tensor) -> torch.Tensor:
    """``greedy_assign`` (the kernel) on a float32 CUDA (S, K, T)."""
    s, k, t = dist.shape
    if not 0 < t <= GREEDY_MAX_SLOTS:
        raise ValueError(f"greedy_assign: {t} track slots; the kernel "
                         f"takes 1 to {GREEDY_MAX_SLOTS}")
    match = torch.empty((s, k), dtype=torch.int32, device=dist.device)
    rc = _kernel("greedy_assign")(dist.data_ptr(), match.data_ptr(), s, k,
                                  t, _stream(dist))
    if rc != 0:
        raise RuntimeError(f"greedy_assign launch failed: CUDA error {rc}")
    LAUNCHES["greedy_assign"] += 1
    return match
