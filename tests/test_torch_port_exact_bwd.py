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

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_data_plan_fits_and_covers(dtype, shape):
    """Shared memory within 227 KB and as the kernel computes it, a
    window of 1 to EXACT_BOX_MAX pixels, the output grad's K pieces
    covering Cout (each a multiple of the wgmma K, at most
    EXACT_DATA_MAX_K), the K splits covering the steps in order, the
    blocks, the resident blocks by shared memory and threads, and the
    scratch: the partials, the split weight (float32) or grad x's
    float32 accumulator (bf16). Any width has a plan."""
    b, h, w, cin, cout = shape
    p = DATA_PLANS[dtype](b, h, w, cin, cout)
    assert p["tile"] == dcn.TILE
    assert (p["chunk"], p["warpgroups"]) in dcn.EXACT_DATA_CHUNKS[dtype]
    assert p["smem_bytes"] <= dcn.SMEM_LIMIT
    assert p["smem_bytes"] == dcn._exact_data_smem(
        dtype, p["k_tile"], p["chunk"], p["box_capacity"])
    assert 0 < p["box_capacity"] <= dcn.EXACT_BOX_MAX
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
    assert p["splits"] == dcn._wave_splits(p["tiles"], p["steps"],
                                           p["resident"])
    npix = b * h * w
    assert p["scratch"] == (p["splits"] * npix * 27 if p["splits"] > 1
                            else 0)
    if dtype == "float32":
        assert p["weight_split"] == 2 * 9 * cin * p["pieces"] * p["k_tile"]
    else:
        assert p["grad_acc"] == npix * cin and "weight_split" not in p


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_weight_plan_fits_and_covers(dtype, shape):
    """Shared memory within 227 KB and as the kernel computes it, the
    tile rows and window slots one of EXACT_WEIGHT_FITS, a window of 1 to
    EXACT_BOX_MAX pixels a slot, the N tile, taps and groups, the pixel
    tiles split in order, the blocks, and the scratch: the partials and
    (float32) the output grad split by tile."""
    b, h, w, cin, cout = shape
    p = WEIGHT_PLANS[dtype](b, h, w, cin, cout)
    th, tw = p["tile"]
    assert (th, p["window_slots"]) in dcn.EXACT_WEIGHT_FITS and tw == 16
    assert p["smem_bytes"] <= dcn.SMEM_LIMIT
    assert p["smem_bytes"] == dcn._exact_weight_smem(
        dtype, p["n_tile"], th, p["window_slots"], p["box_capacity"])
    assert 0 < p["box_capacity"] <= dcn.EXACT_BOX_MAX
    assert p["n_tile"] == (64 if cout <= 64 else 128 if cout <= 128
                           else 256)
    assert p["taps"] == dcn.WEIGHT_TAPS[p["n_tile"]]
    assert p["groups"] * p["taps"] >= 9
    assert p["col_tiles"] == -(-cout // p["n_tile"])
    assert p["chunks"] == -(-cin // 64)
    assert p["tiles"] == b * -(-h // th) * -(-w // 16)
    ranges = p["tile_ranges"]
    assert len(ranges) == p["splits"] and ranges[0][0] == 0
    assert ranges[-1][1] == p["tiles"]
    units = p["chunks"] * p["groups"] * p["col_tiles"]
    assert p["blocks"] == units * p["splits"]
    assert p["splits"] == dcn._wave_splits(units, p["tiles"], 1)
    assert p["scratch"] == (p["splits"] * 9 * cin * cout
                            if p["splits"] > 1 else 0)
    if dtype == "float32":
        assert p["grad_split"] == (p["tiles"] * p["col_tiles"] * 2
                                   * p["n_tile"] * th * 16)
    else:
        assert "grad_split" not in p


@pytest.mark.parametrize("dtype", DTYPES)
def test_plans_take_the_first_fit_with_room(dtype):
    """The data plan takes the widest chunk whose window still holds
    EXACT_DATA_BOX_MIN pixels, at two resident blocks an SM where each
    window still does, else at one with the whole room left; the weight
    plan the first (rows, slots) whose slots hold EXACT_WEIGHT_BOX_MIN
    pixels."""
    size = 4 if dtype == "float32" else 2
    for cout in (64, 128, 256):
        p = DATA_PLANS[dtype].__wrapped__(1, 34, 60, 256, cout)
        for chunk, _ in dcn.EXACT_DATA_CHUNKS[dtype]:
            base = dcn._exact_data_smem(dtype, p["k_tile"], chunk, 0)
            two = (dcn.SMEM_PER_SM // 2 - 1024 - base) // (chunk * size + 16)
            one = (dcn.SMEM_LIMIT - base) // (chunk * size + 16)
            cap = min(dcn.EXACT_BOX_MAX,
                      two if two >= dcn.EXACT_DATA_BOX_MIN else one)
            if chunk == p["chunk"]:
                assert p["box_capacity"] == cap >= dcn.EXACT_DATA_BOX_MIN
                assert p["resident"] == (2 if two >= dcn.EXACT_DATA_BOX_MIN
                                         else 1)
                break
            assert cap < dcn.EXACT_DATA_BOX_MIN
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

def _emulate_data(x, off, mask, weight, g, cap, low=False):
    """(grad x, grad offset, grad mask) as the data kernel computes them:
    G_t = g w[t]^T in float32; per 4 x 16 tile its data box, and where the
    box's area is within ``cap`` x read from a copy of the box (positions
    relative to it; an index outside it fails), else from the image; per
    (pixel, tap) d_k = sum_c G x_k weighed by the hats and the derivative
    weights, and m hat_k G added into grad x at the corner. ``low``: the
    inputs are bf16 values, everything runs in float32, and each gradient
    is rounded to bf16 once."""
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    hat, gy, gx, rows, cols, needed, _ = _grad_corners(off, mask, h, w)
    G = np.einsum("bhwo,tco->bhwtc", g, weight.reshape(9, cin, cout),
                  dtype=F32)
    grad_x = np.zeros_like(x)
    sums = np.zeros((3, b, h, w, 9), F32)
    for t in _tiles(b, h, w):
        bi, ys, xs = t
        r0, c0, bh, bw = _box(needed, rows, cols, t)
        window = bh * bw <= cap
        win = x[bi, r0:r0 + bh, c0:c0 + bw].copy()
        for y in range(ys.start, min(ys.stop, h)):
            for xx in range(xs.start, min(xs.stop, w)):
                for tap in range(9):
                    Gp = G[bi, y, xx, tap]
                    m = mask[bi, y, xx, tap]
                    for k in range(4):
                        if not needed[bi, y, xx, tap, k]:
                            continue
                        r, c = rows[bi, y, xx, tap, k], cols[bi, y, xx, tap, k]
                        if window:
                            assert 0 <= r - r0 < bh and 0 <= c - c0 < bw
                            xv = win[r - r0, c - c0]
                        else:
                            xv = x[bi, r, c]
                        d = F32(np.dot(Gp, xv))
                        sums[:, bi, y, xx, tap] += np.array(
                            [hat[bi, y, xx, tap, k], gy[bi, y, xx, tap, k],
                             gx[bi, y, xx, tap, k]], F32) * d
                        grad_x[bi, r, c] += (hat[bi, y, xx, tap, k] * m) * Gp
    grad_off = np.stack([sums[1], sums[2]], -1).reshape(b, h, w, 18)
    out = [grad_x, grad_off, sums[0]]
    return [_bf16(a) for a in out] if low else out


def _jax_grads(args, g, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda *v: jdcn.deform_conv2d(*v),
                     *(jnp.asarray(a, dtype) for a in args))
    return [np.asarray(r, F32) for r in vjp(jnp.asarray(g, dtype))]


@pytest.mark.parametrize("cap", [40, 10 ** 6])
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_data_kernel_matches_jax_vjp(kind, cap):
    """float32: the emulated kernel's grad x, offset and mask against
    ``jax.vjp`` of JAX's ``deform_conv2d`` (default dispatch), each within
    1e-5 of max|JAX grad| (the summation orders differ); capacity 40 puts
    most tiles on the gather route, 10^6 every tile on the window route."""
    x, off, mask, weight, g = _case(7, kind, b=1, h=9, w=21, cin=5, cout=6)
    bias = np.zeros(6, F32)
    ref = _jax_grads((x, off, mask, weight, bias), g)[:3]
    got = _emulate_data(x, off, mask, weight, g, cap)
    for name, a, r in zip(("x", "offset", "mask"), got, ref):
        assert np.abs(a - r).max() <= 1e-5 * np.abs(r).max(), name


@pytest.mark.parametrize("kind", KINDS)
def test_emulated_bf16_data_kernel_rounds_once(kind):
    """bf16: on bf16 inputs the emulated kernel (float32 inside, each
    gradient rounded once) against the float32 ``jax.vjp`` of JAX's op on
    the same bf16 values, rounded to bf16: every element within one bf16
    ulp of the larger of the two + 1e-5 max|JAX| (the float32 sums in
    another order, then one rounding), and against autograd of the plain
    bf16 version (whose sample rounding passes the gradient through)
    within the same bound. JAX's own bf16 vjp rounds at every bf16 op,
    so it is not the reference here."""
    args = [_bf16(a) for a in _case(8, kind, b=1, h=9, w=21, cin=5,
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
    outputs and scratches the plan sizes (the route counter's pointer
    last), then B, H, W, Cin, Cout and the plan's ints (tile, chunk,
    then the data plan's warpgroups, K piece, capacity, splits or the
    weight plan's N tile, taps, window slots, capacity, splits; then
    shared memory), counts one launch of its own kernel only, returns
    outputs of the inputs' dtype and shapes, and raises on a failed
    launch."""
    fn, symbol, counter = LAUNCHERS[kind, dtype]
    x, off, mask, weight, g = _tensors(dtype)
    b, h, w, cin = x.shape
    cout = weight.shape[3]
    rc = [0]
    calls = _fake_kernels(monkeypatch, rc)
    counts = torch.zeros(2, dtype=torch.int32)
    before = {c: getattr(dcn, c) for c in COUNTERS}
    low = dtype == torch.bfloat16
    dname = "bfloat16" if low else "float32"
    if kind == "data":
        out = getattr(dcn, fn)(x, off, mask, weight, g, counts)
        plan = DATA_PLANS[dname](b, h, w, cin, cout)
        keys = ("warpgroups", "k_tile", "box_capacity", "splits")
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
