"""The Mosaic toolchain probes as hand-written Hopper kernels.

The JAX package's ``tools/pallas_probe.py`` (P0-P6) and
``tools/pallas_probe2.py`` (P10-P15) are small Pallas TPU kernels, each
isolating one construct the DCN kernels depend on: aligned FMAs and a
matmul, a tap loop on a pre-shifted stack, unaligned sublane and lane
slices, an in-kernel gather, and a DMA HBM->VMEM window followed by
offset loads. Each has a kernel of its own here, in
``csrc/probes.cu``, on the probe's shapes, dtypes and arithmetic; the
DMA window becomes a ``cp.async`` copy global->shared followed by
offset shared-memory reads.

``run(name, *inputs)`` calls probe ``name`` (``NAMES``: ``p0_copy`` ...
``p15_dynamic_leading``). A CUDA tensor goes to its kernel or raises; a
CPU tensor goes to its plain PyTorch version (``PLAIN[name]``), which
the CPU tests hold against the JAX probe and ``chip_smoke.py`` holds
the kernel against on the card. Shapes, dtypes, devices and
contiguity are checked on the host before any launch, so a wrong input
raises instead of reading out of bounds. ``LAUNCHES[name]`` counts the
kernel's launches in this process.

Two facts of the JAX reference that the port follows:

- P3's shift index ``(ty+a)*5 + (tx+b) + 12`` runs over 6..30, but the
  stack has 25 slabs: 11 of the 81 reads of each tap loop fall past
  slab 24. On the TPU they read whatever lies past the buffer; the JAX
  probe run on the CPU (Pallas interpret mode) clamps the index to 24,
  and the port does the same.
- P15 runs a grid of 2 programs that write one output block; the TPU
  runs them in order, so the output is program 1's. Each program here
  writes its own slot of a (2, 8, 240, 64) scratch and the op returns
  slot 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from centertrack_tpu_torch.ops import _build

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32
RT, CT, C, HALO = 8, 240, 64, 2   # pallas_probe2's tile and halo
TABLE_ROWS = 512                  # P6's table

# name -> (inputs as (shape, dtype), output shape, output dtype). The
# kernel's symbol in csrc/probes.cu is "probe_" + name.
SPECS = {
    "p0_copy": ([((16, 128), F32)], (16, 128), F32),
    "p1_fma12": ([((8, 16, 128), BF16), ((1, 8), F32)], (16, 128), F32),
    "p2_fma30": ([((8, 16, 128), BF16), ((1, 8), F32)], (16, 128), F32),
    "p3_tap_loop": ([((25, 8, 128, 64), BF16), ((9, 3, 8, 128), F32),
                     ((9, 3, 8, 128), F32), ((9, 8, 128), F32),
                     ((9, 64, 64), BF16)], (8, 128, 64), BF16),
    "p4_sublane_slice": ([((16, 128, 8), F32)], (8, 128, 8), F32),
    "p5_lane_slice": ([((16, 256), F32)], (16, 128), F32),
    "p6_gather": ([((TABLE_ROWS, 128), BF16), ((256,), I32)], (256, 128),
                  BF16),
    "p10_aligned": ([((1, RT + HALO, CT + HALO, C), BF16)], (1, RT, CT, C),
                    BF16),
    "p11_leading_offset": ([((1, RT + HALO, CT + HALO, C), BF16)],
                           (1, RT, CT, C), BF16),
    "p12_sublane_offset": ([((1, RT + HALO, CT + HALO, C), BF16)],
                           (1, RT, CT, C), BF16),
    "p13_value_slice": ([((1, RT + HALO, CT + HALO, C), BF16)],
                        (1, RT, CT, C), BF16),
    "p14_4d_leading": ([((1, 5, RT + HALO, CT, C), BF16)], (1, RT, CT, C),
                       BF16),
    "p15_dynamic_leading": ([((1, RT + 2 * HALO, CT, C), BF16)],
                            (1, RT, CT, C), BF16),
}
P15_PROGRAMS = 2   # P15's grid: its kernel writes one output per program
NAMES = tuple(SPECS)

# launches of each probe kernel in this process; read and reset by callers
LAUNCHES = {name: 0 for name in NAMES}


def _kernel(symbol: str):
    """The ctypes launcher ``symbol(pointers..., stream)`` of probes.cu."""
    n_ptr = (len(SPECS[symbol[len("probe_"):]][0]) + 1
             if symbol != "probe_empty" else 0)
    return _build.launcher("probes", symbol, n_ptr, 0)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, inputs):
    """Raise on anything the kernel does not take, before any launch."""
    specs = SPECS[name][0]
    if len(inputs) != len(specs):
        raise TypeError(f"{name}: takes {len(specs)} inputs, got "
                        f"{len(inputs)}")
    device = inputs[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    for i, (t, (shape, dtype)) in enumerate(zip(inputs, specs)):
        if t.device != device:
            raise ValueError(f"{name}: input {i} on {t.device}, input 0 on "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: input {i} is {t.dtype}, the probe "
                            f"takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: input {i} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input {i} is not contiguous")
        if device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: input {i} is not 16-byte aligned")


def launch(name, *inputs):
    """The kernel of probe ``name`` on checked CUDA tensors."""
    _, shape, dtype = SPECS[name]
    if name == "p15_dynamic_leading":
        shape = (P15_PROGRAMS, *shape[1:])
    out = torch.empty(shape, device=inputs[0].device, dtype=dtype)
    symbol = "probe_" + name
    rc = _kernel(symbol)(*(t.data_ptr() for t in inputs), out.data_ptr(),
                         _stream(inputs[0]))
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    if name == "p15_dynamic_leading":   # the last program's, as on the TPU
        out = out[-1:]
    return out


def launch_empty(device="cuda"):
    """An empty kernel (one warp), to time a launch alone."""
    rc = _kernel("probe_empty")(torch.cuda.current_stream(device)
                                .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_empty launch failed: CUDA error {rc}")


def route(name, device):
    """What a call of probe ``name`` on ``device`` runs: the kernel for
    CUDA, the plain version for the CPU; anything else raises."""
    if device.type == "cuda":
        return lambda *inputs: launch(name, *inputs)
    if device.type == "cpu":
        return PLAIN[name]
    raise ValueError(f"{name}: unsupported device {device}")


def run(name, *inputs):
    """Probe ``name`` on ``inputs`` (each as ``SPECS[name]`` gives it):
    its kernel on CUDA tensors, its plain version on CPU tensors."""
    _check(name, inputs)
    return route(name, inputs[0].device)(*inputs)


# ---- the plain versions ----------------------------------------------

def _p0_plain(x):
    return x * 2.0


def _fma_plain(n):
    def fma(x, w):
        acc = torch.zeros(x.shape[1:], dtype=F32, device=x.device)
        for i in range(n):
            acc = acc + x[i % x.shape[0]].float() * w[0, i % 8]
        return acc @ torch.eye(acc.shape[-1], dtype=F32, device=x.device)
    return fma


def p3_shift(t, a, b):
    """The stack slab P3's tap t reads at shift (a, b): the JAX probe's
    index, clamped to the last slab as the JAX probe runs on the CPU."""
    ty, tx = t // 3 - 1, t % 3 - 1
    return min((ty + a) * 5 + (tx + b) + 12, 24)


def _p3_plain(xs, hy, hx, m, w):
    tr, wd, cin = xs.shape[1:]
    acc = torch.zeros((tr * wd, w.shape[2]), dtype=F32, device=xs.device)
    for t in range(9):
        sampled = torch.zeros((tr, wd, cin), dtype=F32, device=xs.device)
        for a in range(3):
            for b in range(3):
                wgt = hy[t, a] * hx[t, b]
                sampled = sampled + xs[p3_shift(t, a, b)].float() * \
                    wgt[..., None]
        sampled = sampled * m[t][..., None]
        acc = acc + sampled.reshape(tr * wd, cin) @ w[t].float()
    return acc.reshape(tr, wd, -1).to(BF16)


def _p4_plain(x):
    return x[1:9] + x[3:11]


def _p5_plain(x):
    return x[:, 3:3 + 128] + x[:, 5:5 + 128]


def _p6_plain(table, idx):
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = table[idx.clamp(0, n - 1).long()]
    # NaN as jnp.take fills it, 0x7FC0 (written as bits: a float32 NaN
    # cast to bf16 may come out as another NaN)
    nan = torch.full_like(out.view(torch.int16), 0x7FC0).view(BF16)
    return torch.where(valid[:, None], out, nan)


def _slabs(x):
    """A window probe's input as (slab, row, column, channel): P14's
    five slabs, or the others' leading 1."""
    return x[0] if x.dim() == 5 else x


def _window_sum(terms, x):
    """sum of x's slabs [s, r:r+8, c:c+240] over (s, r, c) in terms, in
    order, in f32 from zero, rounded to bf16 once."""
    x = _slabs(x)
    acc = torch.zeros((RT, CT, C), dtype=F32, device=x.device)
    for s, r, c in terms:
        acc = acc + x[s, r:r + RT, c:c + CT].float()
    return acc.to(BF16)[None]


def _p15_terms(t):
    """Program t's window terms: its rows start t further down."""
    return [(0, t + a, 0) for a in range(HALO + 1)]


# the (slab, row, column) offsets of the (8, 240, 64) windows each window
# probe reads, in the JAX probe's order of summing (P10 doubles its one;
# P15's are program 1's, the output's)
WINDOWS = {
    "p10_aligned": [(0, 0, 0)],
    "p11_leading_offset": [(0, a, 0) for a in range(HALO + 1)],
    "p12_sublane_offset": [(0, 0, b) for b in range(HALO + 1)],
    "p13_value_slice": [(0, a, a) for a in range(HALO + 1)],
    "p14_4d_leading": [(s, a, 0) for s in range(5)
                       for a in range(HALO + 1)],
    "p15_dynamic_leading": _p15_terms(P15_PROGRAMS - 1),
}


def _p10_plain(x):
    return (x[0, :RT, :CT] * 2.0)[None]


def _p15_plain(x):
    slots = [_window_sum(_p15_terms(t), x) for t in range(P15_PROGRAMS)]
    return slots[-1]


PLAIN = {
    "p0_copy": _p0_plain,
    "p1_fma12": _fma_plain(12),
    "p2_fma30": _fma_plain(30),
    "p3_tap_loop": _p3_plain,
    "p4_sublane_slice": _p4_plain,
    "p5_lane_slice": _p5_plain,
    "p6_gather": _p6_plain,
    "p10_aligned": _p10_plain,
    "p15_dynamic_leading": _p15_plain,
}
PLAIN.update({name: functools.partial(_window_sum, terms)
              for name, terms in WINDOWS.items() if name not in PLAIN})


def default_inputs(name, device="cuda"):
    """The JAX probe's own inputs: ones, and P6's indices zeros."""
    return [torch.zeros(shape, dtype=dtype, device=device) if dtype == I32
            else torch.ones(shape, dtype=dtype, device=device)
            for shape, dtype in SPECS[name][0]]


def seeded_inputs(name, seed, device="cpu"):
    """Inputs of probe ``name`` drawn with numpy from ``seed``: normal
    values (P3's hat weights and mask uniform in [0, 1), its weight
    scaled by 0.05), bf16 ones rounded from float32; P6's indices
    uniform in [-600, 600), so some count from the end and some fall
    outside."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (shape, dtype) in enumerate(SPECS[name][0]):
        if dtype == I32:
            a = rng.randint(-600, 600, shape).astype(np.int32)
        elif name == "p3_tap_loop" and i in (1, 2, 3):
            a = rng.rand(*shape).astype(np.float32)
        else:
            a = rng.randn(*shape).astype(np.float32)
            if name == "p3_tap_loop" and i == 4:
                a *= np.float32(0.05)
        out.append(torch.from_numpy(a).to(device=device, dtype=dtype))
    return out
