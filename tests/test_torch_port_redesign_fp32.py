"""What the redesigned float32 DCN kernels (csrc/dcn_local.cu,
csrc/dcn_local_bwd.cu) rely on, checked on the CPU:

- their launch plans (``ops/dcn.fwd_fp32_plan``, ``bwd_data_fp32_plan``)
  at every DLA-34 neck shape, at B=1 and B=8, R = 1, 2, 3 and 8: shared
  memory within 227 KB, two blocks per SM, K ranges that partition the
  steps, a ValueError past the limit, and the scratch the launchers hand
  the kernels;
- 3xTF32: each operand split into TF32 hi and lo parts (round to nearest,
  ties away, to 10 mantissa bits, emulated on float32 bit patterns) and
  hi*hi + hi*lo + lo*hi summed in float32 holds the forward's and the
  data kernel's contractions at neck widths to a tenth of the smoke's
  float32 tolerance against float64 (and the forward to JAX's op), where
  one TF32 pass misses that tolerance;
- the haloed window in the float32 layout: the forward's corner table and
  swizzled 16-byte pieces rebuild the plain version's samples from a
  tile's window alone, and the data kernel's support walk, by its window
  positions, adds up the plain version's grad x.
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
PLANS = {"fwd": dcn.fwd_fp32_plan, "data": dcn.bwd_data_fp32_plan}
RADII = (1, 2, 3, 8)


# --- the launch plans --------------------------------------------------------

def _cases():
    return [(kind, s, b, r) for kind in sorted(PLANS)
            for s in SHAPES + [RAGGED, ODD] for b in (1, 8) for r in RADII]


@pytest.mark.parametrize("kind, shape, b, r", _cases())
def test_plan_covers_pixels_and_k_once_and_fits(kind, shape, b, r):
    """Tiles cover every output pixel once (the kernels' tile order:
    image, tile row, tile column); the splits' K ranges partition the
    steps (taps x Cin chunks) without an empty one; a launch has at
    least two blocks per SM unless every step is its own split; the
    shared memory fits a block of the H100; the chunk is one the kernels
    are built for."""
    name, h, w, cin, cout = shape
    plan = PLANS[kind](b, h, w, cin, cout, r)
    th, tw = plan["tile"]
    ty, tx = -(-h // th), -(-w // tw)
    assert plan["tiles"] == b * ty * tx
    seen = np.zeros((b, ty * th, tx * tw), np.int64)
    for t in range(plan["tiles"]):
        img, rest = divmod(t, ty * tx)
        row, col = divmod(rest, tx)
        seen[img, row * th:(row + 1) * th, col * tw:(col + 1) * tw] += 1
    assert (seen[:, :h, :w] == 1).all()

    assert plan["steps"] == 9 * -(-cin // plan["chunk"])
    ranges = plan["k_ranges"]
    assert len(ranges) == plan["splits"]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan["steps"]
    assert all(a < e for a, e in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))

    cols = plan.get("col_tiles", 1)
    assert plan["blocks"] == plan["tiles"] * cols * plan["splits"]
    assert (plan["blocks"] >= dcn.TARGET_BLOCKS // 2
            or plan["splits"] == plan["steps"])
    assert plan["smem_bytes"] <= dcn.SMEM_LIMIT == 227 * 1024
    if kind == "fwd":
        assert plan["chunk"] == dcn.FP32_CHUNK == 32
        assert plan["n_tile"] in (64, 128, 256)
        assert cols * plan["n_tile"] >= cout
        assert plan["window_slots"] in (1, 2)
        assert plan["weight_split"] == (2 * 9 * cols * plan["n_tile"]
                                        * plan["steps"] // 9 * 32)
    else:
        assert plan["chunk"] in dcn.FP32_DATA_CHUNKS == (32, 16, 8)
        assert plan["warpgroups"] in ((1, 2) if plan["chunk"] >= 16
                                      else (1,))
        assert plan["weight_split"] == 2 * 9 * cin * (-(-cout // 8) * 8)
    npix = b * h * w
    want = (npix * (cout if kind == "fwd" else 27) * plan["splits"]
            if plan["splits"] > 1 else 0)
    assert plan["scratch"] == want


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_plan_shrinks_as_the_halo_grows(kind):
    """Where the window grows, the plan gives up shared memory elsewhere:
    the forward one window slot and then a narrower N tile, the data
    kernel a smaller chunk; at the neck's widest shape, R=1 keeps the
    widest plan."""
    plan = PLANS[kind]
    wide = plan(1, 34, 60, 256, 256, 1)
    far = plan(1, 34, 60, 256, 256, 8)
    if kind == "fwd":
        assert (wide["n_tile"], wide["window_slots"]) == (256, 2)
        assert (far["n_tile"], far["window_slots"]) == (128, 1)
    else:
        assert (wide["chunk"], far["chunk"]) == (16, 8)
        assert plan(1, 136, 240, 64, 64, 1)["chunk"] == 32


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_plan_refuses_max_offset_past_its_limit(kind):
    """Both planners take max_offset up to FP32_MAX_OFFSET (8) on the
    window design and, past it, take the gather route, naming the
    limit."""
    assert dcn.FP32_MAX_OFFSET == 8
    assert PLANS[kind](1, 34, 60, 256, 256, 8)["route"] == "window"
    plan = PLANS[kind](1, 34, 60, 64, 64, 9)
    assert plan["route"] == "gather"
    assert plan["reason"] == "max_offset 9 > 8"


def test_data_plan_refuses_a_gradient_tile_past_shared_memory():
    """The data kernel keeps the tile's output gradient (hi and lo) in
    shared memory: past about 360 output channels no chunk fits, and the
    planner takes the gather route, naming the sizes."""
    assert dcn.bwd_data_fp32_plan(1, 34, 60, 64, 320, 1)["route"] == "window"
    plan = dcn.bwd_data_fp32_plan(1, 34, 60, 64, 512, 1)
    assert plan["route"] == "gather"
    assert plan["reason"].startswith("shared memory")
    assert plan["reason"].endswith("at chunk 8")


@pytest.mark.parametrize("blocks, steps, resident, want", [
    (288, 144, 1, 5),    # 3 waves, the last of 24 blocks: split 5 ways
    (4080, 18, 2, 1),    # more than four waves: no split
    (36, 72, 1, 11),     # at least 8 splits for two blocks per SM; 11
                         # fill 3 waves with 7 steps a block
    (10, 4, 1, 4),       # every step its own split
])
def test_wave_splits(blocks, steps, resident, want):
    assert dcn._wave_splits(blocks, steps, resident) == want


def test_resident_blocks_by_shared_memory_and_threads():
    assert dcn._resident(109056, 128) == 2
    assert dcn._resident(115968, 128) == 1   # 256 bytes past two
    assert dcn._resident(32768, 256) == 6
    assert dcn._resident(1024, 256) == 8     # threads bound it


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[6], RAGGED])
def test_launchers_pass_the_plan_and_its_scratch(monkeypatch, shape):
    """The float32 launchers (their ctypes calls stood in) hand the kernels
    as many arguments as their _SIGNATURES entries say: the plan's
    numbers after the sizes, the split weight's scratch and, when split,
    the partials' (None otherwise), and zero grad x before the data
    kernel adds its tiles into it."""
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
        floats.append(t.numel())
        return t

    monkeypatch.setattr(dcn.torch, "empty", recording_empty)
    x = torch.zeros(1, h, w, cin)
    offset = torch.zeros(1, h, w, 18)
    mask = torch.zeros(1, h, w, 9)
    weight = torch.zeros(3, 3, cin, cout)
    g = torch.zeros(1, h, w, cout)

    fwd = dcn.fwd_fp32_plan(1, h, w, cin, cout, r)
    dcn.launch_fwd(x, offset, mask, weight, None, r)
    symbol, argv = calls.pop()
    assert symbol == "dcn_local_fwd"
    assert argv[8:14] == (1, h, w, cin, cout, r)
    assert argv[14:21] == (4, 16, 32, fwd["n_tile"], fwd["window_slots"],
                           fwd["splits"], fwd["smem_bytes"])
    assert floats == [h * w * cout] + ([fwd["scratch"]] if fwd["scratch"]
                                       else []) + [fwd["weight_split"]]
    assert (argv[6] is None) == (fwd["splits"] == 1)
    assert argv[4] is None and argv[7]

    floats.clear()
    data = dcn.bwd_data_fp32_plan(1, h, w, cin, cout, r)
    grads = dcn.launch_bwd_data(x, offset, mask, weight, g, r)
    symbol, argv = calls.pop()
    assert symbol == "dcn_local_bwd_data"
    assert argv[10:16] == (1, h, w, cin, cout, r)
    assert argv[16:22] == (4, 16, data["chunk"], data["warpgroups"],
                           data["splits"], data["smem_bytes"])
    assert floats == ([data["scratch"]] if data["scratch"] else []) + [
        data["weight_split"]]
    assert (argv[8] is None) == (data["splits"] == 1) and argv[9]
    assert grads[0].shape == x.shape and not grads[0].any()


def test_smoke_fp32_cases_cover_the_neck_and_the_walks():
    """The smoke's float32 kernel and grad phases run every neck shape at
    B=1 and at the training batch, the ragged shape, a shape of odd
    widths (rows not 16-byte aligned, so the kernels copy their pieces
    by hand, and an odd Cout), and R = 1, 2 and 3, and both planners
    take every case."""
    cases = chip_smoke._dcn_cases()
    neck = {(h, w, ci, co) for _, h, w, ci, co in SHAPES}
    for b in (1, chip_smoke.TRAIN_B):
        assert neck <= {(h, w, ci, co) for _, bb, h, w, ci, co, _, _, r
                        in cases if bb == b and r == 1}
    assert {r for *_, r in cases} == {1, 2, 3}
    assert any(c[0] == "ragged" for c in cases)
    assert any(ci % 2 and co % 2 for _, _, _, _, ci, co, *_ in cases)
    for _, b, h, w, ci, co, _, _, r in cases:
        for plan in PLANS.values():
            assert plan(b, h, w, ci, co, r)["smem_bytes"] <= dcn.SMEM_LIMIT


# --- 3xTF32 ------------------------------------------------------------------

def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 (10 mantissa bits, ties away from zero), as
    cvt.rna.tf32.f32: add half of the 13 dropped bits to the magnitude's
    bit pattern, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def mm_3xtf32(a, b):
    """a @ b from the TF32 parts, products in float32: what the kernels'
    three wgmma per K step sum."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10
    vals = torch.tensor([1, 1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4,
                         -(1 + ulp / 2), -7.5], dtype=torch.float32)
    want = torch.tensor([1, 1, 1 + ulp, 1 + ulp, -(1 + ulp), -7.5],
                        dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    x = torch.randn(10000)
    hi, lo = split(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -21 * x.double().abs()).all()


def _samples(x, offset, mask, r):
    """The masked bilinear samples A_t (npix, Cin) of each tap, in
    float64, from the plain version with a one-tap identity weight."""
    cin = x.shape[3]
    out = []
    for t in range(9):
        eye = torch.zeros(3, 3, cin, cin, dtype=torch.float64)
        eye[t // 3, t % 3] = torch.eye(cin, dtype=torch.float64)
        out.append(dcn.deform_conv2d_local_plain(
            x.double(), offset.double(), mask.double(), eye, None,
            r).reshape(-1, cin))
    return out


def _neck_inputs(seed, cin, cout, h=5, w=7, r=1):
    rng = np.random.RandomState(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    return (f(rng.randn(1, h, w, cin)),
            f(rng.uniform(-(r + 1.5), r + 1.5, (1, h, w, 18))),
            f(rng.rand(1, h, w, 9)), f(rng.randn(3, 3, cin, cout) * 0.05),
            f(rng.randn(1, h, w, cout)))


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{s[0]}-{s[3]}-{s[4]}"
                                               for s in SHAPES])
def test_3xtf32_holds_both_contractions_where_one_pass_does_not(shape):
    """At each neck width, on a 5 x 7 map: the forward's sum over taps of
    A_t w[t] and the data kernel's G_t = g w[t]^T, by 3xTF32, lie within
    REL_TOL / 10 of float64 (max abs err over max |ref|); one TF32 pass
    lies past REL_TOL; the 3xTF32 forward with the bias also matches JAX's
    op within REL_TOL / 10."""
    _, _, _, cin, cout = shape
    x, offset, mask, weight, g = _neck_inputs(cin + cout, cin, cout)
    samples = _samples(x, offset, mask, 1)
    w64 = weight.double()
    ref = sum(a @ w64[t // 3, t % 3] for t, a in enumerate(samples))
    fast = sum(mm_3xtf32(a.float(), weight[t // 3, t % 3])
               for t, a in enumerate(samples))
    single = sum(mm_tf32(a.float(), weight[t // 3, t % 3])
                 for t, a in enumerate(samples))
    tol = chip_smoke.REL_TOL
    assert _rel(fast, ref) <= tol / 10
    assert _rel(single, ref) > tol

    g2 = g.reshape(-1, cout)
    for t in (0, 4, 8):
        wt = weight[t // 3, t % 3]
        gref = g2.double() @ wt.double().T
        assert _rel(mm_3xtf32(g2, wt.T.contiguous()), gref) <= tol / 10
        assert _rel(mm_tf32(g2, wt.T.contiguous()), gref) > tol

    bias = torch.linspace(-1, 1, cout)
    jout = np.array(jdcn.deform_conv2d_local(
        *(jnp.asarray(t.numpy()) for t in (x, offset, mask, weight, bias)),
        1)).reshape(-1, cout)
    assert _rel(fast + bias, torch.from_numpy(jout).double()) <= tol / 10


# --- the haloed window in the float32 layout ------------------------------

TH, TW, CK = 4, 16, 32


def _window(x, b, y0, x0, r, chunk):
    """The forward's window of one tile and Cin chunk, as the kernel lays
    it out: (window pixel, 8 pieces of 4 float32) with piece q of pixel
    pos at slot q ^ (pos & 7), zero outside the map and past Cin."""
    h = r + 1
    _, H, W, cin = x.shape
    wh, ww = TH + 2 * h, TW + 2 * h
    win = torch.zeros(wh * ww, 8, 4, dtype=x.dtype)
    for pos in range(wh * ww):
        yy, xc = y0 - h + pos // ww, x0 - h + pos % ww
        if not (0 <= yy < H and 0 <= xc < W):
            continue
        for q in range(8):
            ch = chunk * CK + 4 * q
            live = max(0, min(4, cin - ch))
            win[pos, q ^ (pos & 7), :live] = x[b, yy, xc, ch:ch + live]
    return win


def _corner_table(offset, mask, b, y0, x0, r, H, W):
    """The forward's corner table of one tile: per (tap, pixel) the window
    index of each of the 4 corners (clamped into the window) and its
    weight wy * wx * m, as dcn_local.cu computes them."""
    h = r + 1
    wh, ww = TH + 2 * h, TW + 2 * h
    idx = np.zeros((9, 4, TH * TW), np.int64)
    wt = np.zeros((9, 4, TH * TW), np.float32)
    for t in range(9):
        for p in range(TH * TW):
            py, px = divmod(p, TW)
            y, xx = y0 + py, x0 + px
            if y >= H or xx >= W:
                continue
            dy = np.clip(offset[b, y, xx, 2 * t].item(), -r, r)
            dx = np.clip(offset[b, y, xx, 2 * t + 1].item(), -r, r)
            vy = np.float32(t // 3 - 1) + np.float32(dy)
            vx = np.float32(t % 3 - 1) + np.float32(dx)
            fy, fx = np.floor(vy), np.floor(vx)
            wy = (1 - (vy - fy), vy - fy)
            wx = (1 - (vx - fx), vx - fx)
            r0, c0 = py + h + int(fy), px + h + int(fx)
            assert r0 >= 0 and c0 >= 0   # the halo reaches every corner
            for i in range(2):
                for j in range(2):
                    k = 2 * i + j
                    row, col = r0 + i, c0 + j
                    # a corner past the window carries no weight
                    if row >= wh or col >= ww:
                        assert wy[i] * wx[j] == 0
                    idx[t, k, p] = min(row, wh - 1) * ww + min(col, ww - 1)
                    wt[t, k, p] = wy[i] * wx[j] * mask[b, y, xx, t].item()
    return idx, wt


@pytest.mark.parametrize("r", [1, 2, 3])
def test_forward_window_rebuilds_the_samples(r):
    """One tile of a ragged map (partly past its edge), offsets spread
    past +/-R (clamped, so corners reach the halo's last ring) and some
    exactly integer: the corner table read through the swizzled window
    gives the plain version's samples of every tap and chunk."""
    H, W, cin = 9, 21, 40
    rng = np.random.RandomState(40 + r)
    x = torch.tensor(rng.randn(1, H, W, cin), dtype=torch.float32)
    off = rng.uniform(-(r + 1.5), r + 1.5, (1, H, W, 18))
    off[0, ::3, ::2] = np.round(off[0, ::3, ::2])
    offset = torch.tensor(off, dtype=torch.float32)
    mask = torch.tensor(rng.rand(1, H, W, 9), dtype=torch.float32)
    samples = _samples(x, offset, mask, r)
    for y0, x0 in ((4, 16), (0, 0)):
        idx, wt = _corner_table(offset, mask, 0, y0, x0, r, H, W)
        for chunk in range(-(-cin // CK)):
            win = _window(x, 0, y0, x0, r, chunk).double()
            for t in range(9):
                for p in range(TH * TW):
                    py, px = divmod(p, TW)
                    y, xx = y0 + py, x0 + px
                    if y >= H or xx >= W:
                        continue
                    a = torch.zeros(8, 4, dtype=torch.float64)
                    for k in range(4):
                        pos = idx[t, k, p]
                        slots = np.arange(8) ^ (pos & 7)
                        a += float(wt[t, k, p]) * win[pos, slots]
                    n = y * W + xx
                    live = min(CK, cin - chunk * CK)
                    want = samples[t][n, chunk * CK:chunk * CK + live]
                    np.testing.assert_allclose(a.reshape(-1)[:live], want,
                                               rtol=1e-5, atol=1e-6)


def _hat(u):
    return torch.clamp(1 - u.abs(), min=0)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_data_walk_positions_add_up_grad_x(r):
    """The data kernel's support walk by its window positions (row =
    tile row + R + 1 + ty + ky, column = pixel column + R + 1 + tx + kx,
    |ky|, |kx| <= R) summed into per-tile grad-x windows and flushed to
    the map (window position - R - 1 + tile origin, inside the map): the
    plain version's grad x, with G_t = g w[t]^T in float64."""
    H, W, cin, cout = 9, 21, 12, 5
    h = r + 1
    x, offset, mask, weight, g = _neck_inputs(60 + r, cin, cout, H, W, r)
    offset[0, ::2, ::3] = torch.round(offset[0, ::2, ::3])
    ts = [t.double().requires_grad_() for t in (x, offset, mask)]
    out = dcn.deform_conv2d_local_plain(*ts, weight.double(), None, r)
    ref = torch.autograd.grad(out, ts[0], g.double())[0][0]
    wh, ww = TH + 2 * h, TW + 2 * h
    grad = torch.zeros(H, W, cin, dtype=torch.float64)
    om = offset.double()[0]
    for y0 in range(0, H, TH):
        for x0 in range(0, W, TW):
            gx = torch.zeros(wh, ww, cin, dtype=torch.float64)
            for t in range(9):
                ty, tx = t // 3 - 1, t % 3 - 1
                wt = weight.double()[t // 3, t % 3]
                for p in range(TH * TW):
                    py, px = divmod(p, TW)
                    y, xx = y0 + py, x0 + px
                    if y >= H or xx >= W:
                        continue
                    G = g.double()[0, y, xx] @ wt.T
                    tyd = ty + om[y, xx, 2 * t].clamp(-r, r)
                    txd = tx + om[y, xx, 2 * t + 1].clamp(-r, r)
                    m = mask.double()[0, y, xx, t]
                    for ky in range(-r, r + 1):
                        for kx in range(-r, r + 1):
                            wk = _hat(tyd - (ty + ky)) * _hat(txd - (tx + kx))
                            row, col = py + h + ty + ky, px + h + tx + kx
                            assert 0 <= row < wh and 0 <= col < ww
                            gx[row, col] += wk * m * G
            for row in range(wh):
                for col in range(ww):
                    yy, xc = y0 - h + row, x0 - h + col
                    if 0 <= yy < H and 0 <= xc < W:
                        grad[yy, xc] += gx[row, col]
    np.testing.assert_allclose(grad.numpy(), ref.numpy(), rtol=1e-9,
                               atol=1e-12)
