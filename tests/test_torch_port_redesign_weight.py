"""What the redesigned weight-gradient kernels (csrc/dcn_local_bwd.cu
``dcn_local_bwd_weight``, csrc/dcn_local_bwd_bf16.cu
``dcn_local_bwd_weight_bf16``) rely on, checked on the CPU:

- their launch plans (``ops/dcn.bwd_weight_fp32_plan``,
  ``bwd_weight_bf16_plan``) at every DLA-34 neck shape, at B=1 and B=8,
  R = 1, 2, 3 and 8, a ragged and an odd shape: pixel tiles, taps and
  Cin chunks each covered once, splits by the wave rule, shared memory
  within 227 KB, the gather route where and only where no window fits,
  and the scratch the launchers hand the kernels;
- 3xTF32 for the contraction over pixels, summed in the kernel's order
  (tiles, then splits in order): within a tenth of the smoke's float32
  tolerance of float64, where one TF32 pass misses the tolerance;
- A_t as the kernels lay it out, rebuilt from one tile's window alone:
  at float32 the plain version's masked samples; at bf16, bit for bit,
  the plain bf16 version's rounded samples, which is the forward's A_t
  read through the other descriptor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu_torch.ops import dcn

torch.set_num_threads(2)

RAGGED = ("ragged", 17, 30, 72, 40)
ODD = ("odd", 17, 30, 69, 37)
SHAPES = [(n, h, w, ci, co) for n, h, w, ci, co, *_ in chip_smoke.NECK_SHAPES]
PLANS = {"float32": dcn.bwd_weight_fp32_plan,
         "bfloat16": dcn.bwd_weight_bf16_plan}
SMEM = {"float32": dcn._weight_fp32_smem, "bfloat16": dcn._weight_bf16_smem}
RADII = (1, 2, 3, 8)


# --- the launch plans --------------------------------------------------------

def _cases():
    return [(dt, s, b, r) for dt in sorted(PLANS)
            for s in SHAPES + [RAGGED, ODD] for b in (1, 8) for r in RADII]


def _fits(dtype, n_tile, r):
    return [(th, ws) for th in dcn.WEIGHT_TILE_ROWS for ws in (2, 1)
            if SMEM[dtype](n_tile, r, th, ws) <= dcn.SMEM_LIMIT]


@pytest.mark.parametrize("dtype, shape, b, r", _cases())
def test_weight_plan_covers_pixels_taps_and_chunks_once(dtype, shape, b, r):
    """Window route: the plan's tiles (th x 16, the kernels' order:
    image, tile row, tile column) cover every pixel once; the splits'
    tile ranges partition the tiles without an empty one; the tap groups
    cover the 9 taps once and the Cin chunks of 64 every input channel;
    the N tiles cover Cout, one N tile up to 256; the splits are the wave
    rule's over the blocks' units (chunks x tap groups x N tiles) with
    the tiles as the steps, at least two blocks per SM unless every tile
    is its own split; the tile rows and window slots are the first of
    the planner's order whose shared memory fits 227 KB; the scratch is
    the split partials' and, at float32, the split output grad's. Where
    nothing fits, the gather route and its pixel splits."""
    _, h, w, cin, cout = shape
    plan = PLANS[dtype](b, h, w, cin, cout, r)
    n_tile = 64 if cout <= 64 else 128 if cout <= 128 else 256
    fits = _fits(dtype, n_tile, r)
    if not fits:
        assert plan["route"] == "gather"
        splits = dcn.weight_splits(b * h * w, cin, cout)
        assert plan["splits"] == splits
        partial = splits > 1 or dtype == "bfloat16"
        assert plan["scratch"] == (splits * 9 * cin * cout if partial else 0)
        return
    assert plan["route"] == "window"
    th, tw = plan["tile"]
    assert (th, plan["window_slots"]) == fits[0] and tw == 16
    ty, tx = -(-h // th), -(-w // tw)
    assert plan["tiles"] == b * ty * tx
    seen = np.zeros((b, ty * th, tx * tw), np.int64)
    for t in range(plan["tiles"]):
        img, rest = divmod(t, ty * tx)
        row, col = divmod(rest, tx)
        seen[img, row * th:(row + 1) * th, col * tw:(col + 1) * tw] += 1
    assert (seen[:, :h, :w] == 1).all()

    ranges = plan["tile_ranges"]
    assert len(ranges) == plan["splits"] <= plan["tiles"]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan["tiles"]
    assert all(a < e for a, e in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))

    taps = plan["taps"]
    assert taps == dcn.WEIGHT_TAPS[plan["n_tile"]]
    covered = sorted(t for g in range(plan["groups"])
                     for t in range(g * taps, min(9, (g + 1) * taps)))
    assert covered == list(range(9)) and (plan["groups"] - 1) * taps < 9
    assert plan["chunk"] == dcn.WEIGHT_CHUNK == 64
    assert plan["chunks"] == -(-cin // 64)
    assert plan["n_tile"] == n_tile and plan["n_tile"] >= min(cout, 256)
    assert plan["col_tiles"] * plan["n_tile"] >= cout
    assert (plan["col_tiles"] - 1) * plan["n_tile"] < cout

    units = plan["chunks"] * plan["groups"] * plan["col_tiles"]
    assert plan["blocks"] == units * plan["splits"]
    assert plan["splits"] == dcn._wave_splits(units, plan["tiles"],
                                              plan["resident"])
    assert (plan["blocks"] >= dcn.TARGET_BLOCKS // 2
            or plan["splits"] == plan["tiles"])
    assert plan["smem_bytes"] == SMEM[dtype](n_tile, r, th,
                                             plan["window_slots"])
    assert plan["smem_bytes"] <= dcn.SMEM_LIMIT == 227 * 1024
    assert plan["split_rule"] == "waves"
    assert plan["resident"] == min(
        dcn._resident(plan["smem_bytes"], 256),
        dcn.WEIGHT_MIN_BLOCKS.get((dtype, n_tile), 1))
    splits = plan["splits"]
    assert plan["scratch"] == (splits * 9 * cin * cout if splits > 1 else 0)
    if dtype == "float32":
        assert plan["grad_split"] == (plan["tiles"] * plan["col_tiles"] * 2
                                      * n_tile * th * tw)
    else:
        assert "grad_split" not in plan


@pytest.mark.parametrize("dtype", sorted(PLANS))
def test_weight_route_is_gather_only_where_no_window_fits(dtype):
    """No max offset and no width is refused: up to R = 20 at every
    N tile the planner returns a plan, the gather route exactly where no
    tile of 4, 2 or 1 rows fits shared memory with one window slot (the
    smallest), and the smoke's gather cases take that route while the
    neck's R = 1 and R = 2 never do."""
    for r in range(1, 21):
        for cout in (64, 128, 256):
            plan = PLANS[dtype](1, 17, 30, 64, cout, r)
            nothing = all(SMEM[dtype](cout, r, th, 1) > dcn.SMEM_LIMIT
                          for th in dcn.WEIGHT_TILE_ROWS)
            assert (plan["route"] == "gather") == nothing
            if r <= 2:
                assert plan["route"] == "window"
    b, h, w, cin, cout, r = chip_smoke.GATHER_CASES[dtype]
    assert PLANS[dtype](b, h, w, cin, cout, r)["route"] == "gather"


@pytest.mark.parametrize("dtype", sorted(PLANS))
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[6], RAGGED,
                                   ODD])
def test_weight_launchers_pass_the_plan_and_its_scratch(monkeypatch, dtype,
                                                        shape):
    """The weight launchers (their ctypes calls stood in) hand the kernel
    as many arguments as its _SIGNATURES entry says: the plan's numbers
    after the sizes, the float32 scratch of the split output grad
    (float32 only) and of the partials (None when not split), in one
    allocation, and count
    one launch of the window route; at the smoke's gather case they call
    the gather route with its splits and count that."""
    _, h, w, cin, cout = shape
    r = 1
    calls, floats = [], []

    def fake_kernel(symbol):
        def launch(*argv):
            _, n_ptr, n_int = dcn._SIGNATURES[symbol]
            assert len(argv) == n_ptr + n_int + 1
            calls.append((symbol, argv))
            return 0
        return launch

    monkeypatch.setattr(dcn, "_kernel", fake_kernel)
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    empty = torch.empty

    def recording_empty(*size, **kw):
        t = empty(*size, **kw)
        if t.dtype == torch.float32 and t.dim() == 1:
            floats.append(t.numel())
        return t

    monkeypatch.setattr(dcn.torch, "empty", recording_empty)
    low = dtype == "bfloat16"
    dt = getattr(torch, dtype)
    launch = dcn.launch_bwd_weight_bf16 if low else dcn.launch_bwd_weight
    symbol = "dcn_local_bwd_weight" + ("_bf16" if low else "")
    counter = "BWD_WEIGHT_BF16_LAUNCHES" if low else "BWD_WEIGHT_LAUNCHES"

    def inputs(b, h, w, cin, cout):
        return (torch.zeros(b, h, w, cin, dtype=dt),
                torch.zeros(b, h, w, 18, dtype=dt),
                torch.zeros(b, h, w, 9, dtype=dt),
                torch.zeros(b, h, w, cout, dtype=dt))

    plan = PLANS[dtype](1, h, w, cin, cout, r)
    before = getattr(dcn, counter)
    x, offset, mask, g = inputs(1, h, w, cin, cout)
    grad_w = launch(x, offset, mask, g, cout, r)
    assert getattr(dcn, counter) == before + 1
    assert grad_w.shape == (3, 3, cin, cout) and grad_w.dtype == dt
    got, argv = calls.pop()
    assert got == symbol
    n_ptr = 6 if low else 7
    assert argv[n_ptr:n_ptr + 6] == (1, h, w, cin, cout, r)
    assert argv[n_ptr + 6:n_ptr + 14] == (
        *plan["tile"], 64, plan["n_tile"], plan["taps"],
        plan["window_slots"], plan["splits"], plan["smem_bytes"])
    assert (argv[5] is None) == (plan["splits"] == 1)
    if low:
        assert floats == ([plan["scratch"]] if plan["scratch"] else [])
    else:
        # one allocation: the split output grad (argv[6]), then the
        # partials (argv[5]) right after it
        assert floats == [plan["grad_split"] + plan["scratch"]]
        assert argv[6] and plan["grad_split"] % 4 == 0
        if argv[5] is not None:
            assert argv[5] == argv[6] + 4 * plan["grad_split"]

    floats.clear()
    b, h, w, cin, cout, r = chip_smoke.GATHER_CASES[dtype]
    plan = PLANS[dtype](b, h, w, cin, cout, r)
    counter = ("BWD_WEIGHT_GATHER_BF16_LAUNCHES" if low
               else "BWD_WEIGHT_GATHER_LAUNCHES")
    before = getattr(dcn, counter)
    launch(*inputs(b, h, w, cin, cout)[:3], inputs(b, h, w, cin, cout)[3],
           cout, r)
    assert getattr(dcn, counter) == before + 1
    got, argv = calls.pop()
    assert got == symbol.replace("weight", "weight_gather")
    assert argv[6:13] == (b, h, w, cin, cout, r, plan["splits"])
    assert floats == ([plan["scratch"]] if plan["scratch"] else [])


def test_smoke_gather_cases_and_weight_bound():
    """The smoke's gather cases lie past every window, and its 3xTF32
    bound of the float32 weight kernel counts the contraction three
    times at the TF32 peak and the sampling at the float32 peak against
    the bytes of x, offsets, mask, output grad and grad w."""
    n, cin, cout = 32640, 64, 64
    ms, by = chip_smoke.dcn_bwd_weight_bound_ms_3xtf32(n, cin, cout)
    ops = (3 * 2.0 * n * 9 * cin * cout / chip_smoke.PEAK_TF32_FLOPS
           + 8.0 * n * 9 * cin / chip_smoke.PEAK_FP32_FLOPS)
    nbytes = 4.0 * (n * cin + n * 27 + n * cout + 9 * cin * cout)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * max(ops, nbytes
                                         / chip_smoke.PEAK_BYTES_S))
    assert ms < chip_smoke.dcn_bwd_bound_ms(n, cin, cout)[1][0]


# --- 3xTF32 over pixels ------------------------------------------------------

def tf32(t):
    """float32 -> nearest TF32, ties away (cvt.rna.tf32.f32)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def _weight_in_kernel_order(a, g, tile, splits, passes):
    """sum_p a[p]^T g[p] as the kernel sums it: per tile of ``tile``
    pixels the products (3xTF32, or one TF32 pass) into a float32
    accumulator, tiles in order within a split, the splits' partials
    summed in split order in float32."""
    npix = a.shape[0]
    tiles = -(-npix // tile)
    out = torch.zeros(a.shape[1], g.shape[1])
    for z in range(splits):
        acc = torch.zeros_like(out)
        for t in range(z * tiles // splits, (z + 1) * tiles // splits):
            at, gt = a[t * tile:(t + 1) * tile], g[t * tile:(t + 1) * tile]
            if passes == 3:
                (ah, al), (gh, gl) = split(at), split(gt)
                acc = acc + (al.T @ gh + ah.T @ gl + ah.T @ gh)
            else:
                acc = acc + tf32(at).T @ tf32(gt)
        out = out + acc
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[0]}-{s[3]}-{s[4]}"
                                               for s in SHAPES])
def test_3xtf32_holds_the_weight_contraction_over_pixels(shape):
    """At each neck width (one 64-channel chunk of Cin against all of
    Cout), over 4096 pixels of masked samples and output grads: grad w
    by 3xTF32 in the kernel's order (tiles of 64 pixels, 8 splits in
    order) lies within REL_TOL / 10 of float64 (max abs err over max
    |ref|); one TF32 pass lies past REL_TOL."""
    _, _, _, cin, cout = shape
    rng = np.random.RandomState(cin + 3 * cout)
    npix = 4096
    a = torch.tensor(rng.randn(npix, 64) * rng.rand(npix, 1),
                     dtype=torch.float32)
    g = torch.tensor(rng.randn(npix, cout), dtype=torch.float32)
    ref = a.double().T @ g.double()
    tol = chip_smoke.REL_TOL

    def rel(got):
        return ((got.double() - ref).abs().max() / ref.abs().max()).item()

    assert rel(_weight_in_kernel_order(a, g, 64, 8, 3)) <= tol / 10
    assert rel(_weight_in_kernel_order(a, g, 64, 8, 1)) > tol


def test_3xtf32_weight_gradient_matches_jax_vjp():
    """The weight gradient of a small clamped DCN (R = 1, offsets spread
    past it) by 3xTF32 in the kernel's order, from the plain version's
    samples, against jax.vjp of the JAX package's op with respect to the
    weight (ops/dcn.py:382): within REL_TOL / 10."""
    h, w, cin, cout, r = 9, 21, 12, 7, 1
    rng = np.random.RandomState(5)
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    x = f(rng.randn(1, h, w, cin))
    offset = f(rng.uniform(-2.5, 2.5, (1, h, w, 18)))
    mask = f(rng.rand(1, h, w, 9))
    weight = f(rng.randn(3, 3, cin, cout) * 0.1)
    g = f(rng.randn(1, h, w, cout))
    _, vjp = jax.vjp(lambda wt: jdcn.deform_conv2d_local(
        jnp.asarray(x.numpy()), jnp.asarray(offset.numpy()),
        jnp.asarray(mask.numpy()), wt, None, r), jnp.asarray(weight.numpy()))
    want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    got = torch.stack([_weight_in_kernel_order(
        s.float(), g.reshape(-1, cout), 64, 2, 3)
        for s in _samples(x, offset, mask, r)]).reshape(3, 3, cin, cout)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= chip_smoke.REL_TOL / 10


# --- A_t from a tile's window ------------------------------------------------

def _samples(x, offset, mask, r, dtype=torch.float64):
    """The masked samples A_t (npix, Cin) of each tap from the plain
    version with a one-tap identity weight: float64, or at bf16 the plain
    bf16 version's rounded samples."""
    cin = x.shape[3]
    out = []
    for t in range(9):
        eye = torch.zeros(3, 3, cin, cin, dtype=dtype)
        eye[t // 3, t % 3] = torch.eye(cin, dtype=dtype)
        out.append(dcn.deform_conv2d_local_plain(
            x.to(dtype), offset.to(dtype), mask.to(dtype), eye, None,
            r).reshape(-1, cin))
    return out


def _window(x, b, y0, x0, th, r, chunk, pieces, per):
    """One tile's window of 64 channels as the weight kernels lay it out:
    (window position, ``pieces`` slots of ``per`` channels), piece q of
    position pos at slot q ^ (pos & 7), zero outside the map and past
    Cin."""
    h = r + 1
    _, H, W, cin = x.shape
    wh, ww = th + 2 * h, 16 + 2 * h
    win = torch.zeros(wh * ww, pieces, per, dtype=x.dtype)
    for pos in range(wh * ww):
        yy, xc = y0 - h + pos // ww, x0 - h + pos % ww
        if not (0 <= yy < H and 0 <= xc < W):
            continue
        for q in range(pieces):
            ch = chunk * 64 + per * q
            live = max(0, min(per, cin - ch))
            win[pos, q ^ (pos & 7), :live] = x[b, yy, xc, ch:ch + live]
    return win, wh, ww


def _map_inputs(seed, r, H=9, W=21, cin=72):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(1, H, W, cin), dtype=torch.float32)
    off = rng.uniform(-(r + 1.5), r + 1.5, (1, H, W, 18))
    off[0, ::3, ::2] = np.round(off[0, ::3, ::2])
    offset = torch.tensor(off, dtype=torch.float32)
    mask = torch.tensor(rng.rand(1, H, W, 9), dtype=torch.float32)
    return x, offset, mask


@pytest.mark.parametrize("r", [1, 2, 3])
def test_fp32_weight_a_from_the_window_is_the_samples(r):
    """The float32 kernel's A_t of one tile (4 x 16 and 2 x 16 rows, one
    partly past a ragged map's edge), every tap and both 64-channel
    chunks of Cin = 72: its corner entries (window index clamped into
    the window, weight wy * wx * m) read through the window's swizzled
    16 pieces, each item of 4 pixels x 4 channels laid K-major (4 pixels
    of one channel per 16 bytes, 8-channel groups ASBO = 32 TP + 16
    bytes apart), read back through the descriptor's strides (LBO 128,
    SBO ASBO): the plain version's samples."""
    x, offset, mask = _map_inputs(70 + r, r)
    _, H, W, cin = x.shape
    samples = _samples(x, offset, mask, r)
    ch64 = np.arange(64)
    for th, (y0, x0) in ((4, (4, 16)), (2, (0, 0))):
        tp = th * 16
        asbo = tp * 32 + 16
        for chunk in range(-(-cin // 64)):
            win, wh, ww = _window(x.double(), 0, y0, x0, th, r, chunk, 16, 4)
            for t in range(9):
                image = torch.zeros(8 * asbo // 4, dtype=torch.float64)
                for p in range(tp):
                    y, xx = y0 + p // 16, x0 + p % 16
                    if y >= H or xx >= W:
                        continue
                    dy = np.clip(offset[0, y, xx, 2 * t].item(), -r, r)
                    dx = np.clip(offset[0, y, xx, 2 * t + 1].item(), -r, r)
                    vy = np.float32(t // 3 - 1) + np.float32(dy)
                    vx = np.float32(t % 3 - 1) + np.float32(dx)
                    fy, fx = np.floor(vy), np.floor(vx)
                    wy, wx = (1 - (vy - fy), vy - fy), (1 - (vx - fx), vx - fx)
                    r0 = p // 16 + r + 1 + int(fy)
                    c0 = p % 16 + r + 1 + int(fx)
                    m = mask[0, y, xx, t].item()
                    v = torch.zeros(64, dtype=torch.float64)
                    for i in range(2):
                        for j in range(2):
                            pos = (min(r0 + i, wh - 1) * ww
                                   + min(c0 + j, ww - 1))
                            slots = np.arange(16) ^ (pos & 7)
                            v += (float(wy[i] * wx[j] * m)
                                  * win[pos, slots].reshape(-1))
                    # the kernel's store of item (4 (p / 4), 4 q): byte
                    # (ch / 8) ASBO + (p / 4) 128 + (ch % 8) 16 + 4 (p % 4)
                    at = ((ch64 >> 3) * asbo + (p >> 2) * 128
                          + (ch64 & 7) * 16 + 4 * (p & 3)) // 4
                    image[at] = v
                # read as wgmma's K-major A (M = channel, K = pixel): core
                # matrix (m / 8, k / 4) at SBO (m / 8) + LBO (k / 4), its
                # row m % 8 of 16 bytes holding k % 4
                m, k = np.meshgrid(ch64, np.arange(tp), indexing="ij")
                addr = (asbo * (m >> 3) + 128 * (k >> 2) + 16 * (m & 7)
                        + 4 * (k & 3)) // 4
                assert len(np.unique(addr)) == addr.size
                assert addr.max() < 8 * asbo // 4
                a = image[torch.from_numpy(addr)]
                live = min(64, cin - chunk * 64)
                for p in range(tp):
                    y, xx = y0 + p // 16, x0 + p % 16
                    if y >= H or xx >= W:
                        continue
                    want = samples[t][y * W + xx, chunk * 64:chunk * 64 + live]
                    np.testing.assert_allclose(a[:live, p], want, rtol=1e-5,
                                               atol=1e-6)


def _bf16_corners(dy, dx, t, py, px, h, wh, ww):
    """dcn_sample_bf16.cuh corners(): float32 arithmetic, op by op."""
    f = np.float32
    vy = f(t // 3 - 1) + f(dy)
    vx = f(t % 3 - 1) + f(dx)
    fy, fx = np.floor(vy), np.floor(vx)
    wy = (f(1) - abs(vy - fy), f(1) - abs(vy - (fy + f(1))))
    wx = (f(1) - abs(vx - fx), f(1) - abs(vx - (fx + f(1))))
    r0, c0 = py + h + int(fy), px + h + int(fx)
    return ([min(r0 + i, wh - 1) * ww + min(c0 + j, ww - 1)
             for i in range(2) for j in range(2)],
            [f(wy[i] * wx[j]) for i in range(2) for j in range(2)])


@pytest.mark.parametrize("r", [1, 2, 3])
def test_bf16_weight_a_is_the_forwards_a(r):
    """The bf16 kernels' shared sample (dcn_sample_bf16.cuh: corner
    weights wy*wx, each corner's product added in turn in float32, the
    mask, one rounding), built from one tile's window of bf16 x and
    stored as both kernels store it (8 channels of one pixel per 16
    bytes, at (p / 8) 1024 + q 128 + (p % 8) 16): read through the weight
    kernel's descriptor (trans-a: M = channel, K = pixel, LBO 1024, SBO
    128) it is, bit for bit, the plain bf16 version's rounded sample of
    every tap, and it is the transpose of what the forward's descriptor
    (K-major: M = pixel, K = channel, LBO 128, SBO 1024) reads."""
    x, offset, mask = _map_inputs(80 + r, r, cin=64)
    x, offset, mask = (t.to(torch.bfloat16) for t in (x, offset, mask))
    _, H, W, cin = x.shape
    samples = _samples(x, offset, mask, r, torch.bfloat16)
    th, tp, h = 4, 64, r + 1
    for y0, x0 in ((4, 16), (0, 0)):
        win, wh, ww = _window(x.float(), 0, y0, x0, th, r, 0, 8, 8)
        for t in range(9):
            image = torch.zeros(tp * 64, dtype=torch.bfloat16)
            for p in range(tp):
                y, xx = y0 + p // 16, x0 + p % 16
                if y >= H or xx >= W:
                    continue
                dy = np.clip(np.float32(offset[0, y, xx, 2 * t].float()),
                             -r, r)
                dx = np.clip(np.float32(offset[0, y, xx, 2 * t + 1].float()),
                             -r, r)
                pos, wt = _bf16_corners(dy, dx, t, p // 16, p % 16, h, wh,
                                        ww)
                s = torch.zeros(64, dtype=torch.float32)
                for k in range(4):
                    slots = np.arange(8) ^ (pos[k] & 7)
                    s = s + win[pos[k], slots].reshape(-1) * float(wt[k])
                a = (s * float(mask[0, y, xx, t].float())).to(torch.bfloat16)
                for q in range(8):
                    at = ((p >> 3) * 1024 + q * 128 + (p & 7) * 16) // 2
                    image[at:at + 8] = a[8 * q:8 * q + 8]

            def element(lbo, sbo, m, k):
                # m / 8 core matrices apart by SBO, k / 8 by LBO, a core
                # matrix 8 rows (k % 8) of 16 bytes, 8 values (m % 8)
                return image[(lbo * (k >> 3) + sbo * (m >> 3)
                              + 16 * (k & 7)) // 2 + (m & 7)]

            live = [p for p in range(tp)
                    if y0 + p // 16 < H and x0 + p % 16 < W]
            weight_a = torch.stack([torch.stack(
                [element(1024, 128, c, p) for p in live]) for c in range(64)])
            fwd_a = torch.stack([torch.stack(
                [image[(1024 * (p >> 3) + 128 * (c >> 3) + 16 * (p & 7)) // 2
                       + (c & 7)] for c in range(64)]) for p in live])
            assert torch.equal(weight_a, fwd_a.T)
            want = torch.stack([samples[t][(y0 + p // 16) * W + x0 + p % 16]
                                for p in live])
            assert torch.equal(fwd_a, want)
