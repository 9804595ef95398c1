"""What the exact DCNv2 backward kernels (csrc/dcn_exact_bwd.cu:
``dcn_exact_bwd_data``, ``dcn_exact_bwd_weight`` and their bf16 twins)
rely on, checked on the CPU on inputs made from numpy seeds: their launch
plans (``ops/dcn.exact_bwd_data_fp32_plan`` and the three others) at every
DLA-34 neck shape at B=1, 6 and 8, a ragged shape, odd widths, a map
smaller than a tile and output grads wider than one G piece; the data
kernels' route rule ``exact_bwd_tile_routes`` (a box of every corner the
gradient reads, one row and one column more than the forward's box at
zero offsets) and the weight kernels' ``exact_tile_routes`` per tile and
tap group, against boxes recomputed in numpy; a numpy emulation of the
data kernel's decomposition (G_t = g w[t]^T, the corner walk over the
box's window or the image, grad x scattered per corner) against
``jax.vjp`` of
JAX's ``deform_conv2d``; the launchers' ctypes arguments and counters;
and ``DCNExact``'s wiring. The kernels themselves run only on the card,
where chip_smoke.py holds them against the plain version. Each tolerance
is stated beside its test."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu_torch.ops import dcn

torch.set_num_threads(2)

DTYPES = ("float32", "bfloat16")
SHAPES = ([(b, h, w, ci, co) for b in (1, chip_smoke.EXACT_BATCH,
                                       chip_smoke.TRAIN_B)
           for _, h, w, ci, co, _, _ in chip_smoke.NECK_SHAPES]
          + [(1, 17, 30, 72, 40), (1, 17, 30, 69, 37), (2, 3, 5, 69, 37),
             (1, 17, 30, 64, 512), (1, 9, 20, 40, 600)])
DATA_PLANS = {"float32": dcn.exact_bwd_data_fp32_plan,
              "bfloat16": dcn.exact_bwd_data_bf16_plan}
WEIGHT_PLANS = {"float32": dcn.exact_bwd_weight_fp32_plan,
                "bfloat16": dcn.exact_bwd_weight_bf16_plan}
KINDS = ("zero", "n3", "1e6")
F32 = np.float32


def _bf16(a):
    return np.asarray(a, F32).astype(ml_dtypes.bfloat16).astype(F32)


def _ulp(a):
    """One bf16 ulp at |a| (2^(e - 7) for |a| in [2^e, 2^(e+1)))."""
    a = np.abs(np.asarray(a, F32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


def _case(seed, kind, b=2, h=13, w=37, cin=11, cout=9):
    """x, offset, mask, weight, output grad (float32 numpy): offsets ~N(0,
    3), all zero (every tap at an integer position, the border taps on the
    clip's tie) or a mix of +/-1e6 and ~N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(F32)
    mask = rng.rand(b, h, w, 9).astype(F32)
    if kind == "n3":
        off = rng.randn(b, h, w, 18) * 3
    elif kind == "zero":
        off = np.zeros((b, h, w, 18))
    else:
        off = np.where(rng.rand(b, h, w, 18) < 0.3,
                       rng.choice([-1e6, 1e6], (b, h, w, 18)),
                       rng.randn(b, h, w, 18))
    weight = (rng.randn(3, 3, cin, cout) * 0.2).astype(F32)
    g = rng.randn(b, h, w, cout).astype(F32)
    return x, off.astype(F32), mask, weight, g


def _grad_corners(off, mask, h, w):
    """dcn_exact.cuh ``grad_corners`` in numpy float32 for every (b, y, x,
    tap): the top-left corner (iy, ix), the hats, the derivative weights
    of dy and dx (clip' m folded in), the corners' rows and columns, and
    which corners the gradient reads (inside the map, one weight not 0)
    and which the forward reads (inside, hat not 0)."""
    ti = np.arange(9)
    uy = (np.arange(h, dtype=F32)[None, :, None, None]
          + (ti // 3 - 1).astype(F32)) + off[..., 0::2]
    ux = (np.arange(w, dtype=F32)[None, None, :, None]
          + (ti % 3 - 1).astype(F32)) + off[..., 1::2]
    py = np.minimum(np.maximum(uy, F32(-1)), F32(h))
    px = np.minimum(np.maximum(ux, F32(-1)), F32(w))
    y0, x0 = np.floor(py), np.floor(px)
    fy, fx = py - y0, px - x0
    ry, rx = F32(1) - fy, F32(1) - fx

    def slope(u, size):
        return np.where((u > -1) & (u < size), F32(1), np.where(
            (u == -1) | (u == size), F32(0.5), F32(0))).astype(F32)

    cy, cx = slope(uy, h) * mask, slope(ux, w) * mask
    hat = np.stack([ry * rx, ry * fx, fy * rx, fy * fx], -1)
    gy = np.stack([-(rx * cy), -(fx * cy), rx * cy, fx * cy], -1)
    gx = np.stack([-(ry * cx), ry * cx, -(fy * cx), fy * cx], -1)
    iy, ix = y0.astype(np.int64), x0.astype(np.int64)
    rows = iy[..., None] + np.array([0, 0, 1, 1])
    cols = ix[..., None] + np.array([0, 1, 0, 1])
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    needed = inside & ((hat != 0) | (gy != 0) | (gx != 0))
    assert hat.dtype == gy.dtype == gx.dtype == F32
    return hat, gy, gx, rows, cols, needed, inside & (hat != 0)


def _tiles(b, h, w, th=4, tw=16):
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                yield bi, slice(y0, y0 + th), slice(x0, x0 + tw)


def _box(used, rows, cols, sl, taps=slice(None)):
    """(r0, c0, bh, bw) of the used corners of one tile's taps ``taps``;
    1 x 1 at (0, 0) when it has none."""
    u = used[sl][..., taps, :]
    if not u.any():
        return 0, 0, 1, 1
    r, c = rows[sl][..., taps, :][u], cols[sl][..., taps, :][u]
    return r.min(), c.min(), r.max() - r.min() + 1, c.max() - c.min() + 1


# --- the plans -------------------------------------------------------------

def _data_design():
    """The data kernel's constants as csrc/dcn_exact_bwd.cu states them:
    the barrier bytes (DBAR_B), a table entry's bytes (DENT_B), the
    widest G piece (MAX_KC) and the (chunk, warpgroups) each dtype's
    launcher takes (launch_data's plan check, bf16 first)."""
    src = _source("dcn_exact_bwd.cu")
    body = src[src.index("int launch_data("):src.index("// ---- the weight")]
    pairs = [tuple(map(int, m)) for m in re.findall(
        r"chunk == (\d+) && warpgroups == (\d+)", body)]
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    return {"barrier_bytes": const("DBAR_B"), "entry_bytes": const("DENT_B"),
            "max_k": const("MAX_KC"),
            "chunks": {"bfloat16": tuple(pairs[:2]),
                       "float32": tuple(pairs[2:])}}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_data_plan_fits_and_covers(dtype, shape):
    """Shared memory within 227 KB and as the kernel computes it (the
    barriers, the output-grad tile, two weight slots, the corner table of
    9 x 64 entries, the window slots; the planner's constants equal the
    source's), one or two window slots (two only where the tile has more
    than one chunk) of 1 to EXACT_BOX_MAX pixels each and of at least
    EXACT_DATA_BOX_MIN at every neck shape, the output grad's K pieces
    covering Cout (each a multiple of the wgmma K, at most
    EXACT_DATA_MAX_K), the K splits covering the steps in order (by
    the wave rule, a block's prologue counted as two steps, one block an
    SM the least), the blocks, the resident blocks by shared memory and
    threads, and the scratch: the partials, the weight slices laid out
    for the slots
    (float32: TF32 hi and lo) and (bf16) grad x's float32 accumulator.
    Any width has a plan."""
    b, h, w, cin, cout = shape
    p = DATA_PLANS[dtype](b, h, w, cin, cout)
    design = _data_design()
    assert dcn.EXACT_DATA_BARRIER_BYTES == design["barrier_bytes"]
    assert dcn.EXACT_DATA_TABLE_BYTES == 9 * 64 * design["entry_bytes"]
    assert dcn.EXACT_DATA_MAX_K == design["max_k"]
    assert dcn.EXACT_DATA_CHUNKS[dtype] == design["chunks"][dtype]
    assert p["tile"] == dcn.TILE
    assert (p["chunk"], p["warpgroups"]) in dcn.EXACT_DATA_CHUNKS[dtype]
    assert p["smem_bytes"] <= dcn.SMEM_LIMIT
    size, parts = (4, 2) if dtype == "float32" else (2, 1)
    assert p["smem_bytes"] == (
        design["barrier_bytes"]
        + parts * (64 + 2 * p["chunk"]) * p["k_tile"] * size
        + 9 * 64 * design["entry_bytes"]
        + p["window_slots"] * p["box_capacity"] * (p["chunk"] * size + 16)
    ) == dcn._exact_data_smem(dtype, p["k_tile"], p["chunk"],
                              p["window_slots"], p["box_capacity"])
    assert p["window_slots"] in (1, 2)
    assert p["window_slots"] == 1 or cin > p["chunk"]
    assert 0 < p["box_capacity"] <= dcn.EXACT_BOX_MAX
    neck = (b, h, w, cin, cout) in {(bb, hh, ww, ci, co) for bb in (
        1, chip_smoke.EXACT_BATCH, chip_smoke.TRAIN_B)
        for _, hh, ww, ci, co, _, _ in chip_smoke.NECK_SHAPES}
    if neck:
        assert p["box_capacity"] >= dcn.EXACT_DATA_BOX_MIN == 256
    ka = 8 if dtype == "float32" else 16
    assert p["k_tile"] % ka == 0 and p["k_tile"] <= dcn.EXACT_DATA_MAX_K
    assert p["pieces"] * p["k_tile"] >= cout > (p["pieces"] - 1) * p[
        "k_tile"]
    assert p["tiles"] == b * -(-h // 4) * -(-w // 16)
    assert p["steps"] == 9 * -(-cin // p["chunk"])
    ranges = p["k_ranges"]
    assert len(ranges) == p["splits"] and ranges[0][0] == 0
    assert ranges[-1][1] == p["steps"]
    assert all(a[1] == b_[0] and a[0] < a[1]
               for a, b_ in zip(ranges, ranges[1:]))
    assert p["blocks"] == p["tiles"] * p["splits"]
    assert p["resident"] == dcn._resident(p["smem_bytes"],
                                          128 * p["warpgroups"])
    assert p["splits"] == dcn._wave_splits(
        p["tiles"], p["steps"], p["resident"], flush=1,
        least_blocks=dcn.SMS * p["resident"])
    npix = b * h * w
    assert p["scratch"] == (p["splits"] * npix * 27 if p["splits"] > 1
                            else 0)
    layout = parts * p["steps"] * p["chunk"] * p["pieces"] * p["k_tile"]
    assert p["weight_layout"] * 4 == layout * size
    if dtype == "float32":
        assert "grad_acc" not in p
    else:
        assert p["grad_acc"] == npix * cin


def _weight_design():
    """The weight kernel's design as csrc/dcn_exact_bwd.cu states it: per
    block width (n_tile) its WRoles (NPROD, NCONS, MPW, TPW, PREGS,
    CREGS), the ring's stages per dtype (weight_stages), the barrier
    bytes (WBAR_B), the consumers' k steps (WKS) and the widest block per
    dtype (launch_weight's ``widest``)."""
    src = _source("dcn_exact_bwd.cu")
    roles = {int(m[0]): dict(zip(
        ("NPROD", "NCONS", "MPW", "TPW", "PREGS", "CREGS"),
        map(int, m[1:]))) for m in re.findall(
        r"struct WRoles<(\d+)> \{\s*static constexpr int NPROD = (\d+), "
        r"NCONS = (\d+), MPW = (\d+), TPW = (\d+);\s*static constexpr int "
        r"PREGS = (\d+), CREGS = (\d+);", src)}
    low, full = re.search(r"constexpr int weight_stages\(\) \{\s*return "
                          r"is_low<T>\(\) \? (\d+) : (\d+);", src).groups()
    wmax = re.search(r"constexpr int WMAX_STAGES = (\d+);", src).group(1)
    bar = re.search(r"constexpr int WBAR_B = ([^;]+);", src).group(1)
    wide_low, wide = re.search(r"const int widest = LOW \? (\d+) : (\d+);",
                               src).groups()
    return {"roles": roles,
            "stages": {"float32": int(full), "bfloat16": int(low)},
            "barrier_bytes": eval(bar.replace("WMAX_STAGES", wmax)),
            "k_steps": int(re.search(r"constexpr int WKS = (\d+);",
                                     src).group(1)),
            "widest": {"float32": int(wide), "bfloat16": int(wide_low)}}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_weight_plan_fits_and_covers(dtype, shape):
    """Shared memory within 227 KB and as the kernel computes it
    (csrc/dcn_exact_bwd.cu weight_smem_bytes: barriers, sample stages,
    two g slots, two corner tables, the window slots), the tile rows and
    window slots one of EXACT_WEIGHT_FITS (two slots at every neck shape,
    each of at least EXACT_WEIGHT_BOX_MIN pixels; tile rows 4 at bf16, 2
    at float32 where the g^T fragment allows no more), a window of 1 to
    EXACT_BOX_MAX pixels a slot; the planner's copy of the kernel's
    design (taps by block width, stages, barrier bytes, widest block)
    equal to the source's; the kernel's roles (four warpgroups, the
    producers at least as many as the consumers, their setmaxnreg counts
    within the SM's 64K registers: one block an SM; the consumers'
    accumulators plus their g^T fragment within their setmaxnreg count);
    the M tiles and taps (5 at Cout 64, 3 at 128, 1 at 256, in balanced
    groups; float32 past Cout 128 in blocks of 128), the pixel tiles
    split in order by the wave rule with the flush counted, the blocks,
    the partials' scratch, and no split output grad at either dtype."""
    b, h, w, cin, cout = shape
    p = WEIGHT_PLANS[dtype](b, h, w, cin, cout)
    design = _weight_design()
    assert dcn.EXACT_WEIGHT_TAPS == {n: r["TPW"]
                                     for n, r in design["roles"].items()}
    assert dcn.EXACT_WEIGHT_STAGES == design["stages"]
    assert dcn.EXACT_WEIGHT_BARRIER_BYTES == design["barrier_bytes"]
    assert dcn.EXACT_WEIGHT_MAX_N_TILE == design["widest"]
    th, tw = p["tile"]
    assert (th, p["window_slots"]) in dcn.EXACT_WEIGHT_FITS[dtype]
    assert tw == 16
    assert th * 16 <= design["k_steps"] * (8 if dtype == "float32" else 16)
    assert p["smem_bytes"] <= dcn.SMEM_LIMIT
    size = 4 if dtype == "float32" else 2
    tp = th * 16
    stage = (2 * 8 * (tp * 32 + 16) if dtype == "float32" else tp * 128)
    gpitch = p["n_tile"] * size + (32 if dtype == "float32" else 16)
    assert p["stages"] == design["stages"][dtype]
    assert p["smem_bytes"] == (
        (2 * 8 + 8) * 8 + 2 * 4 * 16 + 2 * 32 + p["stages"] * stage
        + 2 * tp * gpitch + 2 * p["taps"] * tp * 20
        + p["window_slots"] * p["box_capacity"] * 64 * size
    ) == dcn._exact_weight_smem(dtype, p["n_tile"], th, p["taps"],
                                p["window_slots"], p["box_capacity"])
    assert 0 < p["box_capacity"] <= dcn.EXACT_BOX_MAX
    neck = (b, h, w, cin, cout) in {(bb, hh, ww, ci, co) for bb in (
        1, chip_smoke.EXACT_BATCH, chip_smoke.TRAIN_B)
        for _, hh, ww, ci, co, _, _ in chip_smoke.NECK_SHAPES}
    if neck:
        assert p["window_slots"] == 2
        assert p["box_capacity"] >= dcn.EXACT_WEIGHT_BOX_MIN
        assert th == (4 if dtype == "bfloat16" else 2)
    r = design["roles"][p["n_tile"]]
    assert r["NPROD"] + r["NCONS"] == 4
    assert r["NPROD"] >= r["NCONS"] and r["NPROD"] >= 2
    assert 128 * (r["NPROD"] * r["PREGS"] + r["NCONS"] * r["CREGS"]) <= 65536
    assert r["PREGS"] % 8 == r["CREGS"] % 8 == 0
    g_fragment = r["MPW"] * design["k_steps"] * 4 * (
        2 if dtype == "float32" else 1)
    assert r["MPW"] * r["TPW"] * 32 + g_fragment <= r["CREGS"] - 24
    assert r["NCONS"] * r["MPW"] == p["m_tiles"]
    assert p["n_tile"] == min(64 if cout <= 64 else 128 if cout <= 128
                              else 256, dcn.EXACT_WEIGHT_MAX_N_TILE[dtype])
    assert p["m_tiles"] == p["n_tile"] // 64
    assert p["taps"] == {1: 5, 2: 3, 4: 1}[p["m_tiles"]] <= r["TPW"]
    assert p["groups"] == -(-9 // p["taps"])
    assert p["taps"] * (p["groups"] - 1) < 9 <= p["taps"] * p["groups"]
    assert p["col_tiles"] == -(-cout // p["n_tile"])
    assert p["chunks"] == -(-cin // 64)
    assert p["tiles"] == b * -(-h // th) * -(-w // 16)
    assert p["resident"] == 1
    ranges = p["tile_ranges"]
    assert len(ranges) == p["splits"] and ranges[0][0] == 0
    assert ranges[-1][1] == p["tiles"]
    assert all(e > s for s, e in ranges)
    units = p["chunks"] * p["groups"] * p["col_tiles"]
    assert p["blocks"] == units * p["splits"]
    assert p["flush_steps"] == p["m_tiles"]
    assert p["splits"] == dcn._wave_splits(units, p["tiles"], 1,
                                           flush=p["m_tiles"],
                                           least_blocks=dcn.SMS)
    assert p["scratch"] == (p["splits"] * 9 * cin * cout
                            if p["splits"] > 1 else 0)
    assert "grad_split" not in p


@pytest.mark.parametrize("dtype", DTYPES)
def test_plans_take_the_first_fit_with_room(dtype):
    """The data plan takes the widest chunk and, for it, the first fit of
    EXACT_DATA_FITS (two resident blocks an SM before one, two window
    slots before one where the tile has more than one chunk) at which
    each window slot still holds EXACT_DATA_BOX_MIN pixels, with the
    whole room of that fit; the weight plan the first (rows, slots) whose
    slots hold EXACT_WEIGHT_BOX_MIN pixels."""
    size = 4 if dtype == "float32" else 2
    for cin, cout in ((64, 64), (256, 64), (256, 128), (256, 256)):
        p = DATA_PLANS[dtype].__wrapped__(1, 34, 60, cin, cout)
        for chunk, _ in dcn.EXACT_DATA_CHUNKS[dtype]:
            base = dcn._exact_data_smem(dtype, p["k_tile"], chunk, 0, 0)
            fits = []
            for blocks, slots in dcn.EXACT_DATA_FITS:
                if slots == 2 and cin <= chunk:
                    continue
                room = (dcn.SMEM_PER_SM // 2 - 1024 if blocks == 2
                        else dcn.SMEM_LIMIT) - base
                cap = min(dcn.EXACT_BOX_MAX,
                          room // (slots * (chunk * size + 16)))
                if cap >= dcn.EXACT_DATA_BOX_MIN:
                    fits.append((blocks, slots, cap))
            if chunk == p["chunk"]:
                blocks, slots, cap = fits[0]
                assert (p["window_slots"], p["box_capacity"]) == (slots, cap)
                assert p["resident"] == blocks
                break
            assert not fits
        q = WEIGHT_PLANS[dtype].__wrapped__(1, 34, 60, 256, cout)
        assert q["box_capacity"] >= dcn.EXACT_WEIGHT_BOX_MIN
    assert DATA_PLANS[dtype](1, 136, 240, 64, 64)["resident"] == 2


# --- the route rules -------------------------------------------------------

@pytest.mark.parametrize("cap", [60, 133, 300])
@pytest.mark.parametrize("kind", KINDS)
def test_data_routes_match_a_numpy_box_per_tile(kind, cap):
    """``exact_bwd_tile_routes`` counts the tiles whose box of needed
    corners has an area within the capacity as window tiles, as a box
    recomputed per tile in numpy; bf16 offsets are read as the kernel
    reads them (float32 of the bf16 values)."""
    x, off, mask, _, _ = _case(3, kind)
    b, h, w, _ = x.shape
    _, _, _, rows, cols, needed, _ = _grad_corners(off, mask, h, w)
    window = sum(np.prod(_box(needed, rows, cols, t)[2:]) <= cap
                 for t in _tiles(b, h, w))
    total = b * -(-h // 4) * -(-w // 16)
    got = dcn.exact_bwd_tile_routes(torch.from_numpy(off),
                                    torch.from_numpy(mask), h, w,
                                    {"box_capacity": cap})
    assert got == (window, total - window)
    low = [torch.from_numpy(a).to(torch.bfloat16) for a in (off, mask)]
    assert dcn.exact_bwd_tile_routes(*low, h, w, {"box_capacity": cap}) == \
        dcn.exact_bwd_tile_routes(*(t.float() for t in low), h, w,
                                  {"box_capacity": cap})


def test_data_box_at_zero_offsets_is_a_row_and_a_column_larger():
    """At zero offsets every position is an integer, fy = fx = 0: the
    corners of the next row and column have hat 0 but a derivative weight
    that is not, so each tile's data box is the forward's box of live
    corners with one more row below and one more column to the right
    (clipped to the map at its last row and column): 7 x 19 for an inner
    4 x 16 tile. ``exact_bwd_tile_routes`` and ``exact_tile_routes``
    split at those areas."""
    x, off, mask, _, _ = _case(4, "zero", b=1, h=13, w=37)
    b, h, w, _ = x.shape
    _, _, _, rows, cols, needed, live = _grad_corners(off, mask, h, w)
    for t in _tiles(b, h, w):
        r0, c0, bh, bw = _box(live, rows, cols, t)
        d = _box(needed, rows, cols, t)
        assert d[:2] == (r0, c0)
        assert d[2] == min(bh + 1, h - r0) and d[3] == min(bw + 1, w - c0)
    inner = (0, slice(4, 8), slice(16, 32))
    assert _box(needed, rows, cols, inner)[2:] == (7, 19)
    assert _box(live, rows, cols, inner)[2:] == (6, 18)
    tiles = b * 4 * 3
    offt, maskt = torch.from_numpy(off), torch.from_numpy(mask)
    assert dcn.exact_tile_routes(offt, h, w, {"box_capacity": 108}) == (
        tiles, 0)
    assert dcn.exact_bwd_tile_routes(offt, maskt, h, w,
                                     {"box_capacity": 108})[0] < tiles
    assert dcn.exact_bwd_tile_routes(offt, maskt, h, w,
                                     {"box_capacity": 133}) == (tiles, 0)


def test_data_box_holds_the_zero_hat_corner():
    """On a 6 x 7 map whose x is 0 but on row 3, with zero offsets, the
    centre tap's dy gradient at y = 2 reads only row 3: a corner of hat
    0 (fy = 0) that the forward's box leaves out. The gradient is not 0
    (autograd of the plain version), the data box holds the corner, the
    forward's box does not, and the emulated kernel gets the same value
    by either route."""
    b, h, w, cin, cout = 1, 6, 7, 2, 3
    rng = np.random.RandomState(5)
    x = np.zeros((b, h, w, cin), F32)
    x[:, 3] = rng.randn(w, cin)
    off = np.zeros((b, h, w, 18), F32)
    mask = np.full((b, h, w, 9), 0.8, F32)
    weight = rng.randn(3, 3, cin, cout).astype(F32)
    g = rng.randn(b, h, w, cout).astype(F32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, off, mask,
                                                         weight)]
    ref = torch.autograd.grad(dcn.deform_conv2d_plain(*ts), ts,
                              torch.from_numpy(g))
    centre_dy = ref[1][0, 2, :, 8].numpy()
    assert (np.abs(centre_dy) > 1e-3).all()
    _, _, _, rows, cols, needed, live = _grad_corners(off, mask, h, w)
    assert needed[0, 2, :, 4, 2].all() and not live[0, 2, :, 4, 2].any()
    assert (rows[0, 2, :, 4, 2] == 3).all()
    for cap in (1, 10 ** 6):   # every tile gathers / every tile windows
        got = _emulate_data(x, off, mask, weight, g, cap)
        np.testing.assert_allclose(got[1][0, 2, :, 8], centre_dy,
                                   rtol=1e-5, atol=1e-6)


def _weight_plan(th, taps, cap):
    return {"tile": (th, 16), "taps": taps, "box_capacity": cap}


@pytest.mark.parametrize("th, taps", [(4, 3), (2, 1), (1, 3)])
@pytest.mark.parametrize("kind", KINDS)
def test_weight_routes_are_per_tile_and_tap_group(kind, th, taps):
    """A weight plan's routes: ``exact_tile_routes`` with the plan's tile
    rows and taps per group counts each (tile, group) once, its box the
    live corners of that group's taps only, as recomputed in numpy."""
    x, off, mask, _, _ = _case(6, kind)
    b, h, w, _ = x.shape
    _, _, _, rows, cols, _, live = _grad_corners(off, mask, h, w)
    cap = 50
    window = total = 0
    for t in _tiles(b, h, w, th):
        for g0 in range(0, 9, taps):
            area = np.prod(_box(live, rows, cols, t,
                                slice(g0, g0 + taps))[2:])
            window += area <= cap
            total += 1
    got = dcn.exact_tile_routes(torch.from_numpy(off), h, w,
                                _weight_plan(th, taps, cap))
    assert got == (window, total - window)


# --- the data kernel's decomposition against JAX ----------------------------

def _table(off, mask, h, w):
    """The data kernel's corner table for every (b, y, x, tap), as
    dcn_exact.cuh ``grad_position`` fills it: the top-left corner (iy,
    ix), the fractions (fy, fx) of the clipped position, the mask and the
    clip's slope codes (2 inside, 1 at exactly -1 or the size, 0
    outside), in numpy float32."""
    ti = np.arange(9)
    uy = (np.arange(h, dtype=F32)[None, :, None, None]
          + (ti // 3 - 1).astype(F32)) + off[..., 0::2]
    ux = (np.arange(w, dtype=F32)[None, None, :, None]
          + (ti % 3 - 1).astype(F32)) + off[..., 1::2]
    py = np.minimum(np.maximum(uy, F32(-1)), F32(h))
    px = np.minimum(np.maximum(ux, F32(-1)), F32(w))
    y0, x0 = np.floor(py), np.floor(px)

    def code(u, size):
        return np.where((u > -1) & (u < size), 2,
                        np.where((u == -1) | (u == size), 1, 0))

    return (y0.astype(np.int64), x0.astype(np.int64), py - y0, px - x0,
            mask, code(uy, h), code(ux, w))


def _rebuild(fy, fx, m, sy, sx):
    """dcn_exact.cuh ``grad_weights``: the hats and the derivative weights
    of dy and dx rebuilt from a table entry's (fy, fx, m) and slope
    codes, in numpy float32 (the walk's arithmetic)."""
    ry, rx = F32(1) - fy, F32(1) - fx
    slope = np.array([0, 0.5, 1], F32)
    cy, cx = slope[sy] * m, slope[sx] * m
    hat = np.stack([ry * rx, ry * fx, fy * rx, fy * fx], -1)
    gy = np.stack([-(rx * cy), -(fx * cy), rx * cy, fx * cy], -1)
    gx = np.stack([-(ry * cx), ry * cx, -(fy * cx), fy * cx], -1)
    return hat, gy, gx


def _emulate_data(x, off, mask, weight, g, cap, low=False, ranges=None):
    """(grad x, grad offset, grad mask) as the data kernel computes them,
    by its plan (``exact_bwd_data_*_plan``: chunk, warpgroups, K splits;
    ``ranges`` replaces the plan's split ranges): per 4 x 16 tile the
    corner table once (``_table``), the weights of every walk rebuilt
    from it (``_rebuild``), the data box of the needed corners and, where
    its area is within ``cap``, x read from a copy of the box (positions
    relative to it; an index outside it fails), else from the image; per
    split the steps (Cin chunk, tap) in order, each step's G = g w[t]^T
    (float32) taken before the step before it is walked, as the
    pipelined kernel issues it; per warpgroup its share of the chunk's
    channels, d_k = sum_c G x_k over them weighed by the hats and the
    derivative weights, the sums of grad mask, dy and dx kept per
    warpgroup over the split's steps and added warpgroup 0 + 1 at its
    end, the splits' partials in split order; m hat_k G added into grad
    x at the corner. ``low``: the inputs are bf16 values, everything
    runs in float32, and each gradient is rounded to bf16 once."""
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    plan = DATA_PLANS["bfloat16" if low else "float32"](b, h, w, cin, cout)
    ck, nwg = plan["chunk"], plan["warpgroups"]
    nw = ck // nwg
    ranges = plan["k_ranges"] if ranges is None else ranges
    iy, ix, fy, fx, m, sy, sx = _table(off, mask, h, w)
    hat, gy, gx = _rebuild(fy, fx, m, sy, sx)
    rows = iy[..., None] + np.array([0, 0, 1, 1])
    cols = ix[..., None] + np.array([0, 1, 0, 1])
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    needed = inside & ((hat != 0) | (gy != 0) | (gx != 0))
    wts = np.stack([hat, gy, gx], -2)   # (..., 3, 4)
    G = np.einsum("bhwo,tco->bhwtc", g, weight.reshape(9, cin, cout),
                  dtype=F32)
    grad_x = np.zeros_like(x)
    out = np.zeros((b, h, w, 9, 3), F32)
    for tl in _tiles(b, h, w):
        bi, ys, xs = tl
        r0, c0, bh, bw = _box(needed, rows, cols, tl)
        window = bh * bw <= cap
        win = x[bi, r0:r0 + bh, c0:c0 + bw].copy()
        pix = [(y, xx) for y in range(ys.start, min(ys.stop, h))
               for xx in range(xs.start, min(xs.stop, w))]
        total = {p: np.zeros((9, 3), F32) for p in pix}
        for s0, s1 in ranges:
            sums = [{p: np.zeros((9, 3), F32) for p in pix}
                    for _ in range(nwg)]
            for st in range(s0, s1):
                chunk, tap = divmod(st, 9)
                for wg in range(nwg):
                    chs = slice(chunk * ck + wg * nw,
                                min(chunk * ck + (wg + 1) * nw, cin))
                    if chs.start >= cin:
                        continue
                    for y, xx in pix:
                        Gp = G[bi, y, xx, tap, chs]
                        for k in np.flatnonzero(needed[bi, y, xx, tap]):
                            r, c = rows[bi, y, xx, tap, k], cols[
                                bi, y, xx, tap, k]
                            if window:
                                assert 0 <= r - r0 < bh and 0 <= c - c0 < bw
                                xv = win[r - r0, c - c0, chs]
                            else:
                                xv = x[bi, r, c, chs]
                            d = F32(np.dot(Gp, xv))
                            sums[wg][y, xx][tap] += wts[
                                bi, y, xx, tap, :, k] * d
                            grad_x[bi, r, c, chs] += (
                                hat[bi, y, xx, tap, k] * m[bi, y, xx, tap]
                            ) * Gp
            for p in pix:
                part = sums[0][p]
                for wg in range(1, nwg):
                    part = part + sums[wg][p]
                total[p] = total[p] + part
        for (y, xx), v in total.items():
            out[bi, y, xx] = v
    grad_off = np.stack([out[..., 1], out[..., 2]], -1).reshape(b, h, w, 18)
    res = [grad_x, grad_off, out[..., 0]]
    return [_bf16(a) for a in res] if low else res


def test_corner_table_rebuilds_grad_corners_bit_for_bit():
    """The table's stored values (fy, fx, m and the slope codes) rebuild
    the hats and both derivative weights bit for bit as
    ``grad_corners`` computes them from the offsets, at every offset
    kind and on bf16 values."""
    for kind in KINDS:
        for low in (False, True):
            x, off, mask, _, _ = _case(12, kind)
            if low:
                off, mask = _bf16(off), _bf16(mask)
            h, w = x.shape[1:3]
            ref = _grad_corners(off, mask, h, w)
            iy, ix, fy, fx, m, sy, sx = _table(off, mask, h, w)
            for got, want in zip(_rebuild(fy, fx, m, sy, sx), ref[:3]):
                assert got.dtype == F32
                np.testing.assert_array_equal(got, want)
            assert (iy[..., None] + np.array([0, 0, 1, 1]) == ref[3]).all()
            assert (ix[..., None] + np.array([0, 1, 0, 1]) == ref[4]).all()


@pytest.mark.parametrize("kc", [64, 256])
def test_two_wgmma_3xtf32_keeps_float32_precision(kc):
    """The float32 data kernel's G in two wgmma a K step (csrc
    dcn_exact_bwd.cu ``g_product``): per K step of 8, a_hi [b_hi | b_lo]
    into both halves and a_lo b_hi into the first, float32 sums, G the
    sum of the halves (``g_sum``), within 1e-5 of max|G| of the float64
    product, as the three products it replaced (a_lo b_hi + a_hi b_lo +
    a_hi b_hi a K step); one TF32 product alone is 10x past that."""
    rng = np.random.RandomState(kc)
    g = rng.randn(64, kc).astype(F32)
    w = (rng.randn(kc, 16) * 0.2).astype(F32)
    ref = g.astype(np.float64) @ w.astype(np.float64)
    g_hi, w_hi = _tf32(g), _tf32(w)
    g_lo, w_lo = _tf32(g - g_hi), _tf32(w - w_hi)
    both = np.zeros((64, 32), F32)
    three = np.zeros((64, 16), F32)
    for k in range(0, kc, 8):
        ks = slice(k, k + 8)
        both += g_hi[:, ks] @ np.concatenate([w_hi[ks], w_lo[ks]], 1)
        both[:, :16] += g_lo[:, ks] @ w_hi[ks]
        three += g_lo[:, ks] @ w_hi[ks]
        three += g_hi[:, ks] @ w_lo[ks]
        three += g_hi[:, ks] @ w_hi[ks]
    two = both[:, :16] + both[:, 16:]
    scale = np.abs(ref).max()
    assert np.abs(two - ref).max() <= 1e-5 * scale
    assert np.abs(three - ref).max() <= 1e-5 * scale
    assert np.abs(g_hi @ w_hi - ref).max() > 1e-4 * scale


def _jax_grads(args, g, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda *v: jdcn.deform_conv2d(*v),
                     *(jnp.asarray(a, dtype) for a in args))
    return [np.asarray(r, F32) for r in vjp(jnp.asarray(g, dtype))]


@pytest.mark.parametrize("cin", [5, 40])
@pytest.mark.parametrize("cap", [40, 10 ** 6])
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_data_kernel_matches_jax_vjp(kind, cap, cin):
    """float32: the emulated kernel's grad x, offset and mask against
    ``jax.vjp`` of JAX's ``deform_conv2d`` (default dispatch), each within
    1e-5 of max|JAX grad| (the summation orders differ), by the plan's K
    splits (one step each at this size) and by one block walking every
    step; capacity 40 puts most tiles on the gather route, 10^6 every
    tile on the window route; Cin 40 takes two chunks of 32 (two window
    slots in the plan)."""
    x, off, mask, weight, g = _case(7, kind, b=1, h=9, w=21, cin=cin,
                                    cout=6)
    bias = np.zeros(6, F32)
    ref = _jax_grads((x, off, mask, weight, bias), g)[:3]
    steps = 9 * -(-cin // 32)
    for ranges in (None, ((0, steps),)):
        got = _emulate_data(x, off, mask, weight, g, cap, ranges=ranges)
        for name, a, r in zip(("x", "offset", "mask"), got, ref):
            assert np.abs(a - r).max() <= 1e-5 * np.abs(r).max(), name


@pytest.mark.parametrize("cin", [5, 40])
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_bf16_data_kernel_rounds_once(kind, cin):
    """bf16: on bf16 inputs the emulated kernel (float32 inside, by the
    bf16 plan: chunks of 64, two warpgroups, one step a split at this
    size; each gradient rounded once) against the float32 ``jax.vjp`` of
    JAX's op on the same bf16 values, rounded to bf16: every element
    within one bf16 ulp of the larger of the two + 1e-5 max|JAX| (the
    float32 sums in another order, then one rounding), and against
    autograd of the plain bf16 version (whose sample rounding passes the
    gradient through) within the same bound. JAX's own bf16 vjp rounds
    at every bf16 op, so it is not the reference here."""
    args = [_bf16(a) for a in _case(8, kind, b=1, h=9, w=21, cin=cin,
                                    cout=6)]
    x, off, mask, weight, g = args
    got = _emulate_data(x, off, mask, weight, g, 10 ** 6, low=True)
    ref = [_bf16(r) for r in _jax_grads((x, off, mask, weight,
                                         np.zeros(6, F32)), g)[:3]]
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in (x, off, mask, weight)]
    plain = torch.autograd.grad(dcn.deform_conv2d_plain(*ts), ts,
                                torch.from_numpy(g).to(torch.bfloat16))
    for name, a, r, p in zip(("x", "offset", "mask"), got, ref, plain):
        bound = (np.maximum(_ulp(a), _ulp(r)) * 1.0001
                 + 1e-5 * np.abs(r).max())
        assert (np.abs(a - r) <= bound).all(), name
        p = p.float().numpy()
        assert (np.abs(a - p) <= bound).all(), name


# --- the weight kernel's decomposition against JAX --------------------------

def _tf32(a):
    """float32 rounded to TF32 (10 mantissa bits), ties away from zero:
    the kernels' cvt.rna.tf32.f32."""
    u = np.asarray(a, F32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(F32)


def _emulate_weight(x, off, mask, g, th, taps, cap, splits, low=False,
                    n_tile=None):
    """grad w (3, 3, Cin, Cout) as the weight kernel computes it: per
    block of ``n_tile`` output channels (all where None), th x 16 pixel
    tile and group of ``taps`` taps, the box of the group's live
    corners; per tap the sample A_t built as the forward builds it (each
    live corner's x times its weight hat m, added term by term in
    float32), from a copy of the box where its area is within ``cap``
    (an index outside it fails) else from the image; then D_t = g^T A_t
    over the tile's pixels: float32 in 3xTF32 (g and A_t split into TF32
    hi and lo, g_lo A_hi + g_hi A_lo + g_hi A_hi), bf16 on A_t rounded to
    bf16 (the forward's sample) in float32. The tiles' products summed
    per split of the tiles in order, the splits' partials in split order
    (bf16: rounded once). Returns (grad w, window tiles, gather tiles)."""
    b, h, w, cin = x.shape
    cout = g.shape[3]
    hat, _, _, rows, cols, _, live = _grad_corners(off, mask, h, w)
    wts = np.where(live, hat * mask[..., None], F32(0)).astype(F32)
    tiles = list(_tiles(b, h, w, th))
    partials = np.zeros((splits, 9, cin, cout), F32)
    n_win = n_gat = 0
    for z in range(splits):
        for ti in range(z * len(tiles) // splits,
                        (z + 1) * len(tiles) // splits):
            bi, ys, xs = tiles[ti]
            ys = slice(ys.start, min(ys.stop, h))
            xs = slice(xs.start, min(xs.stop, w))
            gt = g[bi, ys, xs].reshape(-1, cout)
            for g0 in range(0, 9, taps):
                group = slice(g0, min(9, g0 + taps))
                r0, c0, bh, bw = _box(live, rows, cols, (bi, ys, xs), group)
                window = bh * bw <= cap
                n_win += window
                n_gat += not window
                win = x[bi, r0:r0 + bh, c0:c0 + bw]
                for t in range(group.start, group.stop):
                    a = np.zeros((gt.shape[0], cin), F32)
                    for k in range(4):
                        wk = wts[bi, ys, xs, t, k].reshape(-1)
                        r = rows[bi, ys, xs, t, k].reshape(-1)
                        c = cols[bi, ys, xs, t, k].reshape(-1)
                        on = wk != 0
                        xv = np.zeros_like(a)
                        if window:
                            assert ((r[on] >= r0) & (r[on] < r0 + bh)
                                    & (c[on] >= c0) & (c[on] < c0 + bw)).all()
                            xv[on] = win[r[on] - r0, c[on] - c0]
                        else:
                            xv[on] = x[bi, r[on], c[on]]
                        a = np.where(on[:, None], a + xv * wk[:, None], a)
                        a = a.astype(F32)
                    for n0 in range(0, cout, n_tile or cout):
                        gb = gt[:, n0:n0 + (n_tile or cout)]
                        if low:
                            d = gb.T @ _bf16(a)
                        else:
                            gh, ah = _tf32(gb), _tf32(a)
                            gl, al = _tf32(gb - gh), _tf32(a - ah)
                            d = ((gl.T @ ah).astype(F32) + (gh.T @ al)
                                 ).astype(F32) + (gh.T @ ah)
                        partials[z, t][:, n0:n0 + gb.shape[1]] += \
                            d.T.astype(F32)
    out = np.zeros((9, cin, cout), F32)
    for z in range(splits):
        out = (out + partials[z]).astype(F32)
    out = out.reshape(3, 3, cin, cout)
    return (_bf16(out) if low else out), n_win, n_gat


# the output channels of the emulated weight kernel's cases: one block
# of 64 (5 taps a group) and, past 128, blocks of 128 at float32 (3 taps)
# and one of 256 at bf16 (1 tap)
WEIGHT_EMULATIONS = [6, 130]
EMULATED = dict(b=1, h=9, w=37, cin=5)


def _emulated_plan(dtype, cout):
    """(tile rows, taps a group, splits, n_tile) of the kernel's plan at
    the emulated shape."""
    p = WEIGHT_PLANS[dtype](*EMULATED.values(), cout)
    return p["tile"][0], p["taps"], p["splits"], p["n_tile"]


def _median_area(off, mask, th, taps):
    """The median area of the (tile, tap group) boxes of live corners: a
    capacity that sends about half of them down the gather route."""
    b, h, w, _ = off.shape
    _, _, _, rows, cols, _, live = _grad_corners(off, mask, h, w)
    return int(np.median([np.prod(_box(live, rows, cols, t,
                                       slice(g0, g0 + taps))[2:])
                          for t in _tiles(b, h, w, th)
                          for g0 in range(0, 9, taps)]))


@pytest.mark.parametrize("cout", WEIGHT_EMULATIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_weight_kernel_matches_jax_vjp(kind, cout):
    """float32: the emulated weight kernel at the float32 plan's tile
    rows, taps a group, splits and output-channel blocks (g^T A_t in
    3xTF32 per block, tile and tap group, the split partials summed in
    split order) against ``jax.vjp`` of JAX's ``deform_conv2d`` w.r.t.
    the weight, within 1e-5 of max|JAX grad| (the data kernels'
    emulation's tolerance: the summation orders differ), with tiles on
    both routes (the median box as the capacity; the counts those of
    ``exact_tile_routes``) and the pixels split."""
    th, taps, splits, n_tile = _emulated_plan("float32", cout)
    assert splits > 1
    x, off, mask, weight, g = _case(11, kind, **EMULATED, cout=cout)
    cap = _median_area(off, mask, th, taps) - 1
    ref = _jax_grads((x, off, mask, weight, np.zeros(cout, F32)), g)[3]
    got, n_win, n_gat = _emulate_weight(x, off, mask, g, th, taps, cap,
                                        splits, n_tile=n_tile)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert (n_win, n_gat) == dcn.exact_tile_routes(
        torch.from_numpy(off), 9, 37, _weight_plan(th, taps, cap))
    if kind != "zero":
        assert n_win and n_gat


@pytest.mark.parametrize("cout", WEIGHT_EMULATIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_bf16_weight_kernel_rounds_once(kind, cout):
    """bf16: on bf16 inputs the emulated weight kernel at the bf16 plan's
    tile rows, taps a group, splits and output-channel blocks (the
    forward's bf16 sample, float32 products and sums, one rounding, both
    routes) against autograd of
    the plain bf16 version (whose sample rounding passes the gradient
    through) within one bf16 ulp of the larger of the two + 1e-5
    max|plain| (the data kernels' emulation's bound), and against the
    float32 ``jax.vjp`` of JAX's op on the same bf16 values within the
    sample's rounding (2^-8 of sum_p |A_t| |g|, the unrounded sample's
    gradient) plus that bound."""
    th, taps, splits, n_tile = _emulated_plan("bfloat16", cout)
    assert splits > 1
    args = [_bf16(a) for a in _case(12, kind, **EMULATED, cout=cout)]
    x, off, mask, weight, g = args
    got, n_win, n_gat = _emulate_weight(
        x, off, mask, g, th, taps, _median_area(off, mask, th, taps) - 1,
        splits, low=True, n_tile=n_tile)
    if kind != "zero":
        assert n_win and n_gat
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in (x, off, mask, weight)]
    plain = torch.autograd.grad(dcn.deform_conv2d_plain(*ts), ts[3],
                                torch.from_numpy(g).to(torch.bfloat16))[0]
    plain = plain.float().numpy()
    bound = (np.maximum(_ulp(got), _ulp(plain)) * 1.0001
             + 1e-5 * np.abs(plain).max())
    assert (np.abs(got - plain) <= bound).all()
    ref = _jax_grads((x, off, mask, weight, np.zeros(cout, F32)), g)[3]
    exact, _, _ = _emulate_weight(np.abs(x), off, np.abs(mask), np.abs(g),
                                  th, taps, 80, splits)
    assert (np.abs(got - ref) <= exact * 2.0 ** -8 + bound).all()


def test_weight_kernel_source_has_no_block_barrier_or_split_grad():
    """The weight kernel's tile loops hold no barrier of the whole block
    (its one __syncthreads publishes the barriers' init, before the
    roles part), each role sets its registers once, and the output grad
    is no longer split by a kernel of its own into a scratch."""
    src = _source("dcn_exact_bwd.cu")
    body = src[src.index("dcn_exact_bwd_weight_kernel(const WeightArgs"):
               src.index("dcn_exact_bwd_weight_reduce_kernel(")]
    assert body.count("__syncthreads()") == 1
    assert body.index("__syncthreads()") < body.index("setmaxnreg_dec")
    assert body.count("setmaxnreg_dec<") == body.count("setmaxnreg_inc<") == 1
    assert "split_grad" not in src and "gsplit" not in src
    assert "block_box" not in body


# --- the launchers and DCNExact ----------------------------------------------

def _fake_kernels(monkeypatch, rc=None):
    """Stand-in ctypes launchers: each records (symbol, argv) after
    checking its argument count against _SIGNATURES, and returns rc[0]."""
    calls = []
    rc = rc if rc is not None else [0]

    def fake_kernel(name):
        def launch(*argv):
            _, n_ptr, n_int = dcn._SIGNATURES[name]
            assert len(argv) == n_ptr + n_int + 1
            calls.append((name, argv))
            return rc[0]
        return launch

    monkeypatch.setattr(dcn, "_kernel", fake_kernel)
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    monkeypatch.setattr(dcn, "deform_conv2d_plain", lambda *a: pytest.fail(
        "the plain version was reached"))
    return calls


def _tensors(dtype, b=1, h=34, w=60, cin=40, cout=24, seed=9):
    x, off, mask, weight, g = _case(seed, "n3", b, h, w, cin, cout)
    return [torch.from_numpy(a).to(dtype) for a in (x, off, mask, weight,
                                                    g)]


LAUNCHERS = {
    ("data", torch.float32): ("launch_exact_bwd_data", "dcn_exact_bwd_data",
                              "EXACT_BWD_DATA_LAUNCHES"),
    ("data", torch.bfloat16): ("launch_exact_bwd_data_bf16",
                               "dcn_exact_bwd_data_bf16",
                               "EXACT_BWD_DATA_BF16_LAUNCHES"),
    ("weight", torch.float32): ("launch_exact_bwd_weight",
                                "dcn_exact_bwd_weight",
                                "EXACT_BWD_WEIGHT_LAUNCHES"),
    ("weight", torch.bfloat16): ("launch_exact_bwd_weight_bf16",
                                 "dcn_exact_bwd_weight_bf16",
                                 "EXACT_BWD_WEIGHT_BF16_LAUNCHES"),
}
COUNTERS = [c for _, _, c in LAUNCHERS.values()]


@pytest.mark.parametrize("kind, dtype", sorted(
    LAUNCHERS, key=lambda k: (k[0], str(k[1]))))
def test_launcher_passes_pointers_sizes_plan_and_counter(monkeypatch, kind,
                                                         dtype):
    """Each launcher calls its own symbol with the inputs' pointers, the
    outputs and scratches the plan sizes (the data launchers' weight
    layout just before the route counter's pointer, then their
    reduction counter's; the weight launchers' route counter last), then
    B, H, W, Cin, Cout and the plan's ints (tile, chunk, then the data
    plan's warpgroups, K piece, window slots, capacity, splits or the
    weight plan's N tile, taps, window slots, capacity, splits; then
    shared memory), counts one launch of its own kernel only, returns
    outputs of the inputs' dtype and shapes, and raises on a failed
    launch. The weight launchers pass no output-grad scratch: the
    kernels read g itself (float32 split into TF32 hi and lo as the
    consumers load it)."""
    fn, symbol, counter = LAUNCHERS[kind, dtype]
    x, off, mask, weight, g = _tensors(dtype)
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    rc = [0]
    calls = _fake_kernels(monkeypatch, rc)
    counts = torch.zeros(2, dtype=torch.int32)
    reduced = torch.zeros(1, dtype=torch.int64)
    before = {c: getattr(dcn, c) for c in COUNTERS}
    low = dtype == torch.bfloat16
    dname = "bfloat16" if low else "float32"
    if kind == "data":
        out = getattr(dcn, fn)(x, off, mask, weight, g, counts, reduced)
        plan = DATA_PLANS[dname](b, h, w, cin, cout)
        keys = ("warpgroups", "k_tile", "window_slots", "box_capacity",
                "splits")
        assert [t.shape for t in out] == [x.shape, off.shape, mask.shape]
        assert all(t.dtype == dtype for t in out)
    else:
        out = getattr(dcn, fn)(x, off, mask, g, cout, counts)
        plan = WEIGHT_PLANS[dname](b, h, w, cin, cout)
        keys = ("n_tile", "taps", "window_slots", "box_capacity", "splits")
        assert out.shape == (3, 3, cin, cout) and out.dtype == dtype
    (name, argv), = calls
    _, n_ptr, n_int = dcn._SIGNATURES[symbol]
    assert name == symbol
    assert argv[:3] == (x.data_ptr(), off.data_ptr(), mask.data_ptr())
    assert argv[3] == (weight if kind == "data" else g).data_ptr()
    if kind == "data":
        assert argv[n_ptr - 2:n_ptr] == (counts.data_ptr(),
                                         reduced.data_ptr())
        assert n_ptr == (13 if low else 12) and argv[n_ptr - 3] > 0
    else:
        assert n_ptr == 7
        assert argv[4] == out.data_ptr()
        assert argv[5] is None if plan["splits"] == 1 else argv[5] > 0
        assert argv[n_ptr - 1] == counts.data_ptr()
    assert argv[n_ptr:n_ptr + n_int] == (
        b, h, w, cin, cout, *plan["tile"], plan["chunk"],
        *(plan[k] for k in keys), plan["smem_bytes"])
    assert {c: getattr(dcn, c) - before[c] for c in COUNTERS} == {
        c: int(c == counter) for c in COUNTERS}
    rc[0] = 700
    with pytest.raises(RuntimeError, match=f"{symbol} launch failed"):
        if kind == "data":
            getattr(dcn, fn)(x, off, mask, weight, g)
        else:
            getattr(dcn, fn)(x, off, mask, g, cout)
    assert getattr(dcn, counter) - before[counter] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_exact_launches_the_kernels_of_its_dtype(monkeypatch, dtype):
    """``DCNExact`` launches the forward, data and weight kernels of its
    dtype, once each, and no other; its bias grad is the float32 sum of
    the output grad in the bias's dtype; an input that needs no gradient
    skips its kernel (weight only: no data kernel)."""
    x, off, mask, weight, g = _tensors(dtype, h=9, w=20, cin=8, cout=16)
    bias = torch.zeros(16, dtype=dtype)
    calls = _fake_kernels(monkeypatch)
    low = dtype == torch.bfloat16
    sfx = "_bf16" if low else ""
    ins = [t.clone().requires_grad_() for t in (x, off, mask, weight, bias)]
    out = dcn.DCNExact.apply(*ins)
    assert out.dtype == dtype and out.shape == g.shape
    out.backward(g)
    assert [c[0] for c in calls] == ["dcn_exact_fwd" + sfx,
                                     "dcn_exact_bwd_data" + sfx,
                                     "dcn_exact_bwd_weight" + sfx]
    assert [t.grad.shape for t in ins] == [t.shape for t in ins]
    torch.testing.assert_close(ins[4].grad, g.float().sum((0, 1, 2)).to(
        dtype), atol=0, rtol=0)
    calls.clear()
    w_only = weight.clone().requires_grad_()
    dcn.DCNExact.apply(x, off, mask, w_only, None).backward(g)
    assert [c[0] for c in calls] == ["dcn_exact_fwd" + sfx,
                                     "dcn_exact_bwd_weight" + sfx]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv2d_on_cuda_with_a_gradient_is_dcn_exact(monkeypatch,
                                                            dtype):
    """The wrapper's CUDA route for a call that needs a gradient is
    ``DCNExact.apply`` (its launches stood in), for a call without one the
    forward launcher; the CPU route stays the plain version."""
    assert dcn.exact_route(torch.device("cuda"), dtype,
                           needs_grad=True) == dcn.DCNExact.apply
    assert dcn.exact_route(torch.device("cuda"), dtype) is (
        dcn.launch_exact_fwd_bf16 if dtype == torch.bfloat16
        else dcn.launch_exact_fwd)
    assert dcn.exact_route(torch.device("cpu"), dtype,
                           needs_grad=True) is dcn.deform_conv2d_plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_data_launcher_takes_no_counter_or_an_int64_one(monkeypatch, dtype):
    """A data launcher passes a null reduction counter where none is given
    and raises, before any launch, on a counter that is not one int64
    element on x's device."""
    fn = LAUNCHERS["data", dtype][0]
    x, off, mask, weight, g = _tensors(dtype, h=9, w=20, cin=8, cout=16)
    calls = _fake_kernels(monkeypatch)
    getattr(dcn, fn)(x, off, mask, weight, g)
    (name, argv), = calls
    assert argv[dcn._SIGNATURES[name][1] - 1] is None
    for bad in (torch.zeros(1, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="reductions must be"):
            getattr(dcn, fn)(x, off, mask, weight, g, None, bad)
    assert len(calls) == 1


# --- the measurement tools ----------------------------------------------------

def _source(name):
    from centertrack_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def _data_kernel_body():
    src = _source("dcn_exact_bwd.cu")
    return src[src.index("dcn_exact_bwd_data_kernel("):
               src.index("dcn_exact_bwd_data_reduce_kernel(")]


def test_phase_tool_names_every_data_kernel_mark():
    """``tools/dcn_phases``' names of the exact data kernel's phases are
    exactly the slots its source marks: its one recorded role, the
    walker (every warpgroup walks; thread 0 is recorded), from its
    DATA_ROLE_SLOTS on; the reductions' slot closes each per-corner
    reduction into grad x (one per run of GC channels), the walk's slot
    opening it."""
    from centertrack_tpu_torch.tools import dcn_phases
    body = _data_kernel_body()
    names = dcn_phases.EXACT_DATA_PHASES
    assert set(names) == set(dcn_phases.DATA_ROLE_SLOTS) == {"walker"}
    slots = {int(k) for k in re.findall(r"DCN_PHASE\((\d+)\)", body)}
    first = dcn_phases.DATA_ROLE_SLOTS["walker"]
    assert slots == {first + k for k in range(len(names["walker"]))}
    assert max(slots) < dcn_phases.SLOTS
    assert names["walker"][6] == "reductions"
    assert names["walker"][5] == "walk"
    scatters = re.findall(r"(DCN_PHASE\(\d\));\s*#pragma unroll\s*"
                          r"for \([^)]*\)\s*scatter<GC>[^;]*;\s*"
                          r"(DCN_PHASE\(\d\))", body)
    assert scatters == [("DCN_PHASE(5)", "DCN_PHASE(6)")]
    assert body.count("scatter<GC>") == 1
    assert body.count("DCN_PHASES_END;") == 1


def test_data_kernel_step_loop_has_no_block_barrier():
    """The data kernel's step loop holds no barrier of the whole block:
    a step's one barrier is its warpgroup's own (``bar_sync(1 + wg,
    128)``; a second only where one window slot is reloaded), the next
    step's G is issued, unconditionally, before the walk and waited for
    after it in the same turn of the loop (no wgmma wait between the
    issue and the walk), and the weights come by one bulk copy a step
    on the slots' mbarriers. The block-wide barriers of an output grad
    wider than one G piece are ``stage_piece``'s, called only on that
    (serial, FAST false) path; the corners come from the table, not
    from ``grad_position``, inside the loop."""
    body = _data_kernel_body()
    assert "constexpr bool fast = FAST;" in body
    loop = body[body.index("for (int r = 0; r < n; ++r) {"):
                body.index("reduced += __shfl_xor_sync")]
    assert "__syncthreads" not in loop
    assert loop.count("hopper::bar_sync(1 + wg, 128)") == 2
    at = loop.index("if (fast) {")
    fast = loop[at:loop.index("} else if (r + 1 < n) {", at)]
    assert "g_product<T, NW>(Gn" in fast
    assert "wgmma_wait" not in fast and "stage_piece" not in fast
    assert loop.count("stage_piece(") == 1
    walk = loop.index("scatter<GC>")
    serial = loop[loop.index("} else if (r + 1 < n) {", at):
                  loop.index("if (fast && r + 2 < n")]
    assert "wgmma_wait" not in loop[at:walk].replace(serial, "")
    assert loop.rindex("hopper::wgmma_wait_all();") > walk
    assert "grad_position" not in loop and "s_tab[e]" in loop
    assert "load_w(s + 2, r + 2)" in loop
    assert body.count("hopper::bulk_copy(") == 1
    assert body.count("hopper::mbar_arrive_expect_tx(") == 1
    stage = body[body.index("const auto stage_piece"):
                 body.index("if (window) load_window(c_first, 0);")]
    assert stage.count("__syncthreads()") == 3


def test_phase_tool_names_every_weight_kernel_mark():
    """``tools/dcn_phases``' names of the exact weight kernel's phases are
    exactly the slots its source marks, role by role: the stager's
    branch marks its ROLE_SLOTS on (one per stager phase), the samplers'
    branch theirs, the consumers' branch theirs; the roles' slots do not
    overlap, the producers record one stager and one sampler thread and
    the consumers one thread."""
    from centertrack_tpu_torch.tools import dcn_phases
    src = _source("dcn_exact_bwd.cu")
    body = src[src.index("dcn_exact_bwd_weight_kernel(const WeightArgs"):
               src.index("dcn_exact_bwd_weight_reduce_kernel(")]
    producer = body[body.index("setmaxnreg_dec<"):
                    body.index("setmaxnreg_inc<")]
    branches = {"stager": producer[producer.index("if (pwg == 0) {"):
                                   producer.index("// the samplers:")],
                "sampler": producer[producer.index("// the samplers:"):],
                "consumer": body[body.index("setmaxnreg_inc<"):]}
    names = dcn_phases.EXACT_WEIGHT_PHASES
    assert set(names) == set(branches) == set(dcn_phases.ROLE_SLOTS)
    slots = lambda text: {int(k) for k in re.findall(r"DCN_PHASE\((\d+)\)",
                                                     text)}
    taken = set()
    for role, text in branches.items():
        own = {dcn_phases.ROLE_SLOTS[role] + k
               for k in range(len(names[role]))}
        assert slots(text) == own, role
        assert not own & taken and max(own) < dcn_phases.SLOTS
        taken |= own
    assert producer.count("DCN_PHASES_END_IF(pt == 0 || pt == 128)") == 1
    assert branches["consumer"].count("DCN_PHASES_END_IF(tid == 0)") == 1


def test_exact_bwd_times_needs_a_gpu(monkeypatch):
    """``tools/exact_bwd_times`` exits with an error where no GPU is
    available (it never falls back to the CPU). Its ``main`` imports the
    port's package anew (``--root``); the modules imported before are put
    back after, so that later tests in this process see one package."""
    from centertrack_tpu_torch.tools import exact_bwd_times
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ours = lambda: [m for m in sys.modules
                    if m.split(".")[0] == "centertrack_tpu_torch"]
    saved = {m: sys.modules[m] for m in ours()}
    path = list(sys.path)
    try:
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            exact_bwd_times.main([])
    finally:
        for m in ours():
            del sys.modules[m]
        sys.modules.update(saved)
        sys.path[:] = path


@pytest.mark.parametrize("tool", ["dcn_phases", "exact_bwd_times",
                                  "dcn_times", "tracker_times"])
def test_tools_root_imports_that_checkouts_package(tool, tmp_path):
    """``--root DIR`` makes a tool import DIR's port package, also where
    this checkout's was imported first (``python3 -m``): a stand-in
    package in DIR without the launchers is the one that fails to
    import."""
    import importlib
    import sys
    module = importlib.import_module("centertrack_tpu_torch.tools." + tool)
    pkg = tmp_path / "centertrack_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "ops" / "__init__.py").write_text("")
    ours = lambda: [m for m in sys.modules
                    if m.split(".")[0] == "centertrack_tpu_torch"]
    saved = {m: sys.modules[m] for m in ours()}
    path = list(sys.path)
    argv = ["--root", str(tmp_path)] + (["--exact-bwd"]
                                        if tool == "dcn_phases" else [])
    try:
        with pytest.raises(ImportError, match=str(tmp_path)):
            module.main(argv)
    finally:
        for m in ours():
            del sys.modules[m]
        sys.modules.update(saved)
        sys.path[:] = path


def test_turns_run_parent_change_change_parent():
    """``tools/_turns.in_turns`` measures the parent, the change, the
    change again and the parent again, in that order."""
    from centertrack_tpu_torch.tools import _turns
    seen = []
    got = _turns.in_turns(lambda root: seen.append(root) or len(seen),
                          "p", "c")
    assert seen == ["p", "c", "c", "p"]
    assert got == [("parent", 1), ("change", 2), ("change", 3),
                   ("parent", 4)]


def test_turns_run_a_tool_from_this_checkout(monkeypatch):
    """``tools/_turns.run`` starts ``python3 -m`` of the tool from this
    checkout with ``--root``, keeps the JSON lines it prints, and exits
    with its output where it fails."""
    from centertrack_tpu_torch.tools import _turns
    seen = []

    def fake(cmd, capture_output, text, cwd):
        seen.append((cmd, cwd))
        rc = 0 if "ok" in cmd else 1
        return subprocess.CompletedProcess(cmd, rc, 'x\n{"a": 1}\n', "err")
    monkeypatch.setattr(_turns.subprocess, "run", fake)
    assert _turns.run("exact_bwd_times", "DIR", "ok") == [{"a": 1}]
    assert seen == [([sys.executable, "-m",
                      "centertrack_tpu_torch.tools.exact_bwd_times",
                      "--root", "DIR", "ok"], _turns.ROOT)]
    with pytest.raises(SystemExit, match="tracker_times on DIR failed"):
        _turns.run("tracker_times", "DIR")


def test_exact_bwd_times_compares_best_of_two(monkeypatch):
    """``tools/exact_bwd_times --against``: the four runs are matched by
    (kernel, dtype, case), each side's best of two kept, parent / change
    the speedup, and the change's device-counted reductions carried."""
    from centertrack_tpu_torch.tools import exact_bwd_times

    def side(ms, reductions):
        case = {"device_ms_per_image": ms, "window_tiles": 3,
                "gather_tiles": 1, "shapes": {}}
        if reductions is not None:
            case["reductions_per_image"] = reductions
        return [{"root": "r", "device": "card", "nvidia_smi": "card, 700 W"},
                {"dtype": "float32", "kernel": "data",
                 "cases": {"trained": case}}]
    runs = iter([side(3.0, None), side(2.0, 7.0), side(1.5, 7.0),
                 side(3.3, None)])
    monkeypatch.setattr(exact_bwd_times, "_side",
                        lambda root, kernel: next(runs))
    got = exact_bwd_times.compare("parent", "change", "data")
    row = got["rows"]["data float32 trained"]
    assert row["parent_ms"] == [3.0, 3.3] and row["change_ms"] == [2.0, 1.5]
    assert row["speedup"] == 2.0
    assert row["change_reductions_per_image"] == 7.0
    assert "parent_reductions_per_image" not in row
    assert got["order"] == ["parent", "change", "change", "parent"]
    assert got["nvidia_smi"] == ["card, 700 W"] * 4


def test_tracker_times_compares_in_turns(monkeypatch):
    """``tools/tracker_times --against``: per case both sides' two device
    times, in turn order, and parent / change of the best of each."""
    from centertrack_tpu_torch.tools import tracker_times
    runs = iter([{"device": "card", "nvidia_smi": "s", "rows": [
        {"kernel": "greedy_assign", "case": "path", "shape": [1, 100, 256],
         "device_us": us}]} for us in (40.0, 10.0, 8.0, 42.0)])
    monkeypatch.setattr(tracker_times, "_run", lambda root: next(runs))
    got = tracker_times.compare("parent", "change")
    row, = got["rows"]
    assert row["parent_device_us"] == [40.0, 42.0]
    assert row["change_device_us"] == [10.0, 8.0]
    assert row["speedup"] == 5.0
