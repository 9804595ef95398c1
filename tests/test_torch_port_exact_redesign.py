"""What the redesigned exact DCNv2 forward kernels (csrc/dcn_exact.cu:
``dcn_exact_fwd``, ``dcn_exact_fwd_bf16``) rely on, checked on the CPU on
inputs made from numpy seeds: their launch plans
(``ops/dcn.exact_fwd_fp32_plan``, ``exact_fwd_bf16_plan``) at every
DLA-34 neck shape at B=1 and B=6, a ragged shape, odd widths and a map
smaller than a tile; the route rule ``exact_tile_routes`` against a numpy
recomputation of every tile's box of live corners; the kernels' index
arithmetic of both routes (the tile's box copied with zero fill and
indexed relative to it, or the corners read from the image), emulated in
numpy, against the plain version's sample bit for bit and, contracted,
against JAX's ``_deform_conv2d_slot``; and the launchers' arguments. The
kernels themselves run only on the card, where chip_smoke.py holds them
against the plain version."""

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
SHAPES = ([(b, h, w, ci, co) for b in (1, chip_smoke.EXACT_BATCH)
           for _, h, w, ci, co, _, _ in chip_smoke.NECK_SHAPES]
          + [(1, 17, 30, 72, 40), (1, 17, 30, 69, 37), (2, 3, 5, 69, 37)])
KINDS = ("n3", "zero", "1e6", "edges", "tiny")
PLANNERS = {"float32": dcn.exact_fwd_fp32_plan,
            "bfloat16": dcn.exact_fwd_bf16_plan}


def _case(seed, kind, b=2, h=13, w=37, cin=11):
    """x, offset, mask (float32 numpy) of one check. Offsets ~N(0, 3), all
    zero, a mix of +/-1e6 and ~N(0, 1), positions exactly on -1 and on the
    map's size ("edges": each (pixel, tap) coordinate set so that the
    absolute position is -1, H (or W) or random), or ~N(0, 3) on a map
    smaller than one 4 x 16 tile."""
    rng = np.random.RandomState(seed)
    if kind == "tiny":
        h, w = 3, 5
    x = rng.randn(b, h, w, cin).astype(np.float32)
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    if kind in ("n3", "tiny"):
        off = rng.randn(b, h, w, 18) * 3
    elif kind == "zero":
        off = np.zeros((b, h, w, 18))
    elif kind == "1e6":
        off = np.where(rng.rand(b, h, w, 18) < 0.3,
                       rng.choice([-1e6, 1e6], (b, h, w, 18)),
                       rng.randn(b, h, w, 18))
    else:
        ys = np.arange(h)[None, :, None, None] + (np.arange(9) // 3 - 1)
        xs = np.arange(w)[None, None, :, None] + (np.arange(9) % 3 - 1)
        pick = rng.randint(0, 3, (b, h, w, 18))
        off = rng.randn(b, h, w, 18) * 2
        for c, base, size in ((0, ys, h), (1, xs, w)):
            part = off[..., c::2]
            part[...] = np.where(pick[..., c::2] == 0, -1 - base, np.where(
                pick[..., c::2] == 1, size - base, part))
    return x, off.astype(np.float32), mask


def _corners(off, mask, h, w):
    """The kernels' corner table (csrc/dcn_exact.cuh ``corners``) in
    numpy float32, for every (b, y, x, tap): the top-left corner (iy, ix),
    the four weights (0 outside the map) and which corners are live
    (inside the map, hat weight not 0)."""
    f32 = np.float32
    ti = np.arange(9)
    py = (np.arange(h, dtype=f32)[None, :, None, None]
          + (ti // 3 - 1).astype(f32)) + off[..., 0::2]
    px = (np.arange(w, dtype=f32)[None, None, :, None]
          + (ti % 3 - 1).astype(f32)) + off[..., 1::2]
    py = np.minimum(np.maximum(py, f32(-1)), f32(h))
    px = np.minimum(np.maximum(px, f32(-1)), f32(w))
    y0, x0 = np.floor(py), np.floor(px)
    fy, fx = py - y0, px - x0
    gy, gx = f32(1) - fy, f32(1) - fx
    hat = np.stack([gy * gx, gy * fx, fy * gx, fy * fx], -1)
    iy, ix = y0.astype(np.int64), x0.astype(np.int64)
    rows = iy[..., None] + np.array([0, 0, 1, 1])
    cols = ix[..., None] + np.array([0, 1, 0, 1])
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    wt = np.where(inside, hat * mask[..., None], f32(0)).astype(f32)
    assert wt.dtype == f32 and hat.dtype == f32
    return iy, ix, wt, inside & (hat != 0), rows, cols


def _tiles(b, h, w):
    th, tw = dcn.TILE
    for bi in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                yield bi, slice(y0, y0 + th), slice(x0, x0 + tw)


def _box(live, rows, cols, sl):
    """(r0, c0, bh, bw) of one tile's live corners; 1 x 1 at (0, 0) when
    it has none."""
    lv = live[sl]
    if not lv.any():
        return 0, 0, 1, 1
    r, c = rows[sl][lv], cols[sl][lv]
    return r.min(), c.min(), r.max() - r.min() + 1, c.max() - c.min() + 1


def _emulate(x, off, mask, route):
    """A_t (B, H, W, 9, Cin) float32 as the kernels build it on ``route``:
    "window", the tile's box copied (zero past Cin is moot here: the copy
    holds Cin channels) and every corner read at its box position,
    clamped into the box, and added where its weight is not 0; "gather",
    the corners of weight not 0 read from the image. Term by term in
    float32, in corner order."""
    b, h, w, cin = x.shape
    iy, ix, wt, live, rows, cols = _corners(off, mask, h, w)
    out = np.zeros((b, h, w, 9, cin), np.float32)
    for tile in _tiles(b, h, w):
        r0, c0, bh, bw = _box(live, rows, cols, tile)
        if route == "window":
            src = x[tile[0], r0:r0 + bh, c0:c0 + bw].reshape(bh * bw, cin)
            base = (iy[tile] - r0) * bw + (ix[tile] - c0)
            pos = np.clip(base[..., None] + np.array([0, 1, bw, bw + 1]), 0,
                          bh * bw - 1)
        else:
            src = x[tile[0]].reshape(h * w, cin)
            base = iy[tile] * w + ix[tile]
            pos = base[..., None] + np.array([0, 1, w, w + 1])
        tw_ = wt[tile]
        pos = np.where(tw_ != 0, pos, 0)   # the gather route reads no other
        vals = src[pos]                    # (th, tw, 9, 4, cin)
        v = np.zeros(vals.shape[:3] + (cin,), np.float32)
        for k in range(4):
            wk = tw_[..., k, None]
            v = np.where(wk != 0, v + vals[..., k, :] * wk, v)
        out[tile] = v
    return out


def _plain_samples(x, off, mask, low):
    """deform_conv2d_plain's sample A_t, (B, H, W, 9, Cin), read out
    exactly through a one-hot weight (each output column is one (tap,
    channel) times 1, the other products 0)."""
    b, h, w, cin = x.shape
    onehot = np.zeros((3, 3, cin, 9 * cin), np.float32)
    for t in range(9):
        onehot[t // 3, t % 3, np.arange(cin), t * cin + np.arange(cin)] = 1
    ts = [torch.from_numpy(a) for a in (x, off, mask, onehot)]
    if low:
        ts = [t.to(torch.bfloat16) for t in ts]
    return dcn.deform_conv2d_plain(*ts).reshape(b, h, w, 9, cin)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# --- the plans -------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_and_covers(dtype, shape):
    """Shared memory within 227 KB and as the kernel computes it, a
    window of at least one pixel (at most EXACT_BOX_MAX), the K splits
    covering the steps in order, the blocks adding up, the resident
    blocks by shared memory, the scratch sized for the partials (and the
    split weight at float32)."""
    b, h, w, cin, cout = shape
    p = PLANNERS[dtype](b, h, w, cin, cout)
    assert p["tile"] == dcn.TILE and p["chunk"] == dcn.EXACT_CHUNK[dtype]
    assert p["smem_bytes"] <= dcn.SMEM_LIMIT
    assert p["smem_bytes"] == dcn._exact_smem(dtype, p["n_tile"],
                                              p["box_capacity"],
                                              p["window_slots"])
    assert 0 < p["box_capacity"] <= dcn.EXACT_BOX_MAX
    assert p["window_slots"] in (1, 2)
    if p["window_slots"] == 2:
        assert p["steps"] > 9 and p["box_capacity"] >= dcn.EXACT_BOX_MIN
    assert p["n_tile"] in (64, 128, 256)
    assert p["n_tile"] >= min(cout, 256) or p["n_tile"] == 256
    assert p["col_tiles"] == -(-cout // p["n_tile"])
    assert p["tiles"] == b * -(-h // 4) * -(-w // 16)
    assert p["steps"] == 9 * -(-cin // p["chunk"])
    ranges = p["k_ranges"]
    assert len(ranges) == p["splits"] and ranges[0][0] == 0
    assert ranges[-1][1] == p["steps"]
    assert all(a[1] == b_[0] and a[0] < a[1]
               for a, b_ in zip(ranges, ranges[1:]))
    assert p["blocks"] == p["tiles"] * p["col_tiles"] * p["splits"]
    assert p["resident"] == dcn._resident(p["smem_bytes"], 256)
    assert p["split_rule"] == "waves"
    assert p["splits"] == dcn._wave_splits(p["tiles"] * p["col_tiles"],
                                           p["steps"], p["resident"])
    assert p["scratch"] == (p["splits"] * b * h * w * cout
                            if p["splits"] > 1 else 0)
    if dtype == "float32":
        assert p["weight_split"] == (2 * 9 * p["col_tiles"] * p["n_tile"]
                                     * p["steps"] // 9 * p["chunk"])
    else:
        assert "weight_split" not in p


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_takes_the_widest_room_and_its_n_cap(dtype, monkeypatch):
    """The capacity is the room left after the A and weight slots and the
    table, in whole pixels, up to EXACT_BOX_MAX; ``EXACT_MAX_N_TILE``
    caps the N tile (the s16 256->256 node at N 128 gets a larger window
    and two column tiles)."""
    wide = PLANNERS[dtype].__wrapped__(1, 34, 60, 256, 256)
    room = dcn.SMEM_LIMIT - dcn._exact_smem(dtype, wide["n_tile"], 0, 0)
    assert wide["box_capacity"] == min(dcn.EXACT_BOX_MAX,
                                       room // (128 * wide["window_slots"]))
    monkeypatch.setitem(dcn.EXACT_MAX_N_TILE, dtype, 128)
    narrow = PLANNERS[dtype].__wrapped__(1, 34, 60, 256, 256)
    assert (narrow["n_tile"], narrow["col_tiles"]) == (128, 2)
    assert narrow["box_capacity"] * narrow["window_slots"] > (
        wide["box_capacity"] * wide["window_slots"])


# --- the route rule --------------------------------------------------------

@pytest.mark.parametrize("cap", [40, 446])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_routes_match_a_numpy_box_per_tile(kind, cap):
    """``exact_tile_routes`` counts the tiles whose box of live corners
    has an area within the capacity (or no live corner) as window tiles,
    the rest as gather tiles, as a box recomputed per tile in numpy."""
    x, off, mask = _case(3, kind)
    b, h, w, _ = x.shape
    _, _, _, live, rows, cols = _corners(off, mask, h, w)
    window = sum(_box(live, rows, cols, t)[2] * _box(live, rows, cols, t)[3]
                 <= cap for t in _tiles(b, h, w))
    total = b * -(-h // 4) * -(-w // 16)
    got = dcn.exact_tile_routes(torch.from_numpy(off), h, w,
                                {"box_capacity": cap})
    assert got == (window, total - window)
    if kind == "zero" and cap >= 6 * 18:
        assert got == (total, 0)   # every box within 6 x 18 pixels


def test_tile_routes_take_bf16_offsets_as_the_kernel_reads_them():
    x, off, mask = _case(4, "n3")
    h, w = x.shape[1:3]
    low = torch.from_numpy(off).to(torch.bfloat16)
    assert dcn.exact_tile_routes(low, h, w, {"box_capacity": 200}) == \
        dcn.exact_tile_routes(low.float(), h, w, {"box_capacity": 200})


def test_edges_box_ignores_the_zero_weight_ring():
    """A position clipped to exactly -1 or to the map's size has fy = 0
    (fx = 0): its corner past the map carries weight 0, is not live, and
    the box stays inside the map."""
    x, off, mask = _case(5, "edges")
    b, h, w, _ = x.shape
    _, _, wt, live, rows, cols = _corners(off, mask, h, w)
    assert (rows[live] >= 0).all() and (rows[live] < h).all()
    assert (cols[live] >= 0).all() and (cols[live] < w).all()
    assert (wt[~live] == 0).all()
    on_ring = (rows == h) | (cols == w) | (rows == -1) | (cols == -1)
    assert on_ring.any() and not live[on_ring].any()


# --- the routes' index arithmetic against the plain version ----------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_both_routes_build_the_plain_sample_bit_for_bit(dtype, kind):
    """A_t by the window route's arithmetic (box copy, positions relative
    to the box, clamped; weight-0 corners not added) and by the gather
    route's (positions in the image), term by term in float32, equals
    deform_conv2d_plain's sample bit for bit; at bf16 on the bf16 inputs,
    rounded to bf16 once."""
    low = dtype == "bfloat16"
    x, off, mask = _case(6, kind)
    if low:
        x, off, mask = (_bf16(a) for a in (x, off, mask))
    ref = _plain_samples(x, off, mask, low)
    for route in ("window", "gather"):
        got = torch.from_numpy(_emulate(x, off, mask, route))
        if low:
            got = got.to(torch.bfloat16)
        assert torch.equal(got, ref), route


@pytest.mark.parametrize("kind", ["n3", "edges"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_kernel_matches_jax_slot(dtype, kind):
    """The emulated window route's sample, contracted with a weight and
    the bias as the plain version contracts it, against JAX's
    ``_deform_conv2d_slot`` within tests/test_torch_port_exact.py's
    tolerances: float32 max |diff| <= 1e-5 max|JAX|; bf16 every value
    within one bf16 ulp of the larger of the two."""
    low = dtype == "bfloat16"
    x, off, mask = _case(7, kind, cin=8)
    rng = np.random.RandomState(8)
    weight = (rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    if low:
        x, off, mask, weight, bias = (_bf16(a) for a in (x, off, mask,
                                                          weight, bias))
    a_t = torch.from_numpy(_emulate(x, off, mask, "window"))
    if low:
        a_t = a_t.to(torch.bfloat16).float()
    b, h, w, cin = x.shape
    out = torch.zeros(b * h * w, 16)
    for t in range(9):
        out = out + a_t[..., t, :].reshape(-1, cin) @ torch.from_numpy(
            weight[t // 3, t % 3])
    out = (out + torch.from_numpy(bias)).reshape(b, h, w, 16)
    args = [x, off, mask, weight, bias]
    if low:
        out = out.to(torch.bfloat16).float()
        args = [a.astype(ml_dtypes.bfloat16) for a in args]
    ref = np.asarray(jdcn.deform_conv2d(*map(jnp.asarray, args),
                                        impl="slot")).astype(np.float32)
    got = out.numpy()
    if low:
        ulp = lambda a: np.exp2(np.floor(np.log2(np.maximum(
            np.abs(a), 2.0 ** -126))) - 7)
        np.testing.assert_array_less(np.abs(got - ref),
                                     np.maximum(ulp(got), ulp(ref)) * 1.0001)
    else:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# --- the launchers -----------------------------------------------------------

@pytest.mark.parametrize("dtype, symbol", [
    (torch.float32, "dcn_exact_fwd"), (torch.bfloat16, "dcn_exact_fwd_bf16")])
def test_launcher_passes_the_plan_and_the_route_counter(monkeypatch, dtype,
                                                        symbol):
    """With a route counter the launcher hands the kernel its pointer
    after the scratch pointers, then the sizes and the plan's ints; the
    split weight (float32) and the partials are allocated as the plan
    sizes them."""
    rng = np.random.RandomState(9)
    b, h, w, cin, cout = 1, 34, 60, 40, 24
    args = [torch.from_numpy(a).to(dtype) for a in (
        rng.randn(b, h, w, cin).astype(np.float32),
        (rng.randn(b, h, w, 18) * 3).astype(np.float32),
        rng.rand(b, h, w, 9).astype(np.float32),
        rng.randn(3, 3, cin, cout).astype(np.float32),
        rng.randn(cout).astype(np.float32))]
    counts = torch.zeros(2, dtype=torch.int32)
    calls = []

    def fake_kernel(name):
        def launch(*argv):
            calls.append((name, argv))
            return 0
        return launch

    allocs = []
    real_scratch = dcn._scratch
    monkeypatch.setattr(dcn, "_kernel", fake_kernel)
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    monkeypatch.setattr(dcn, "_scratch", lambda plan, key, device: (
        allocs.append((key, plan[key])) or real_scratch(plan, key, device)))
    low = dtype == torch.bfloat16
    launch = dcn.launch_exact_fwd_bf16 if low else dcn.launch_exact_fwd
    out = launch(*args, counts)
    plan = PLANNERS["bfloat16" if low else "float32"](b, h, w, cin, cout)
    (name, argv), = calls
    n_ptr = dcn._SIGNATURES[symbol][1]
    assert name == symbol and len(argv) == n_ptr + 13 + 1
    assert argv[n_ptr - 1] == counts.data_ptr()
    assert argv[n_ptr:n_ptr + 13] == (
        b, h, w, cin, cout, 4, 16, plan["chunk"], plan["n_tile"],
        plan["box_capacity"], plan["window_slots"], plan["splits"],
        plan["smem_bytes"])
    assert allocs == [("scratch", plan["scratch"])] + (
        [] if low else [("weight_split", plan["weight_split"])])
    assert out.shape == (b, h, w, cout) and out.dtype == dtype


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_route_counter_is_checked_before_any_launch(monkeypatch, bad):
    x = torch.zeros(1, 4, 16, 8)
    counts = {"dtype": torch.zeros(2, dtype=torch.int64),
              "shape": torch.zeros(3, dtype=torch.int32),
              "device": torch.zeros(2, dtype=torch.int32,
                                    device="meta")}[bad]
    monkeypatch.setattr(dcn, "_kernel", lambda name: pytest.fail(
        "launched"))
    with pytest.raises(ValueError, match="route_counts"):
        dcn.launch_exact_fwd(x, torch.zeros(1, 4, 16, 18),
                             torch.zeros(1, 4, 16, 9),
                             torch.zeros(3, 3, 8, 8), None, counts)


def test_dcn_times_compares_exact_rows_per_offsets_and_node(monkeypatch):
    """``tools/dcn_times.py --exact --against``: the four runs (parent,
    change, change, parent) are matched by shape, offsets and node, each
    side's best of two kept, and the per-image sums weight an ~N(0, 3)
    row by its launches per image and a trained node's row by one, over
    the batch; the change's window share is carried."""
    from centertrack_tpu_torch.tools import dcn_times

    def rows(scale, share):
        out = []
        for b in (1, 6):
            out.append({"kernel": "dcn_exact_fwd", "map": "s4", "batch": b,
                        "cin": 64, "cout": 64, "offsets": "n3",
                        "node": None, "launches_per_image": 5,
                        "ms": scale * b, "device_ms": scale * b / 2})
            for node in (0, 1):
                out.append({"kernel": "dcn_exact_fwd", "map": "s4",
                            "batch": b, "cin": 64, "cout": 64,
                            "offsets": "trained", "node": node,
                            "launches_per_image": 1,
                            "ms": scale * b * (1 + node),
                            "device_ms": scale * b, **share})
        return {"rows": out, "device": "card", "nvidia_smi": "card, 700 W"}

    runs = iter([rows(2.0, {}), rows(1.0, {"window_share": 0.75}),
                 rows(1.5, {"window_share": 0.75}), rows(3.0, {})])
    monkeypatch.setattr(dcn_times, "_run", lambda root, dtype, exact: next(
        runs))
    got = dcn_times.compare("parent", "change", "float32", exact=True)
    per = got["per_image_ms_best_of_two"]
    assert set(per) == {f"dcn_exact_fwd B={b} {k}" for b in (1, 6)
                        for k in ("n3", "trained")}
    assert per["dcn_exact_fwd B=1 n3"]["parent_ms"] == 2.0 * 5
    assert per["dcn_exact_fwd B=1 n3"]["change_ms"] == 1.0 * 5
    assert per["dcn_exact_fwd B=6 trained"]["change_ms"] == (6 + 12) / 6
    assert per["dcn_exact_fwd B=6 trained"]["speedup_ms"] == 2.0
    trained = [r for r in got["rows"] if r.get("offsets") == "trained"]
    assert len(trained) == 4 and all(r["window_share"] == 0.75
                                     for r in trained)
