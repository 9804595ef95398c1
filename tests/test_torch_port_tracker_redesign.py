"""The algorithms of the redesigned tracker kernels (csrc/tracker.cu), on
the CPU, as numpy / PyTorch models written here (the kernels run only on
the card, where chip_smoke.py's tracker phase holds them against their
plain versions).

greedy_assign runs in two passes: a parallel pass records, for every
row, how many entries lie below 1e16, whether it holds a NaN and its
first C = 4 candidate columns in (value, column) order; a serial pass
takes the live rows 32 at a time, in rounds: each pending row proposes
its first candidate no earlier row took, the rows before the first one
whose proposal an earlier row of the round also made, or that needs a
rescan, are settled, and a row needs its rescan against the taken
columns when every candidate is taken and it has more than C entries
below 1e16, or when it holds a NaN. The model is held exactly against JAX
``engine/device_tracker.greedy_assign`` on adversarial cases, beside the
port's plain version (the kernel's oracle, unchanged).

splat_pre_hm writes each pixel of a 16 x 128 tile once: the max over
the valid slots whose clipped box meets the tile, or 0. The model is
held against the plain version (exactly: the same float32 operations
and the same exp) and against JAX ``render_pre_hm``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centertrack_tpu.engine import device_tracker as jdt
from centertrack_tpu.ops import gaussian as jgaussian
from centertrack_tpu_torch.ops import gaussian, tracker

torch.set_num_threads(2)

CANDS = 4          # csrc/tracker.cu kCands
TILE = (16, 128)   # csrc/tracker.cu kTileRows, kTileCols
SLOT_BATCH = 256   # csrc/tracker.cu kSplatThreads: slots per batch


# ---- greedy_assign ------------------------------------------------------

def greedy_two_pass(dist):
    """The kernel's two passes on one stream's (K, T) float32 distances:
    returns the (K,) int32 match and the rows that took each serial
    route ("candidate": settled in a round, "rescan", "none": settled
    with no match, no candidate free and at most C entries below 1e16),
    and the number of rounds."""
    k, t = dist.shape
    below = dist < 1e16            # False for NaN
    nan = np.isnan(dist).any(axis=1)
    count = below.sum(axis=1)
    cands = []
    for i in range(k):             # parallel pass
        cols = np.nonzero(below[i])[0]
        # value, then column; -0.0 and +0.0 compare equal, as in argmin
        order = np.lexsort((cols, dist[i, cols]))
        cands.append(cols[order[:CANDS]])
    taken = np.zeros(t, bool)
    match = np.full(k, -1, np.int32)
    routes = {"candidate": [], "rescan": [], "none": [], "rounds": 0}

    def rescan(i):
        row, open_ = dist[i], ~taken
        if np.isnan(row[open_]).any():
            return -1
        ok = open_ & (row < 1e16)
        if not ok.any():
            return -1
        return int(np.nonzero(ok & (row == row[ok].min()))[0][0])

    for base in range(0, k, 32):   # serial pass: a warp, a group a time
        group = range(base, min(base + 32, k))
        pending = [i for i in group if count[i] > 0 or nan[i]]
        while pending:
            routes["rounds"] += 1
            props, stop, needs = {}, None, False
            for i in pending:      # the round's proposals, in row order
                free = [j for j in cands[i] if not taken[j]]
                props[i] = int(free[0]) if free and not nan[i] else -1
                needs = nan[i] or (not free and count[i] > CANDS)
                earlier = [q for q in pending if q < i]
                if needs or (props[i] >= 0 and any(
                        props[q] == props[i] for q in earlier)):
                    stop = i
                    break
            settled = [i for i in pending if stop is None or i < stop]
            for i in settled:
                match[i] = props[i]
                if props[i] >= 0:
                    taken[props[i]] = True
                routes["candidate" if props[i] >= 0 else "none"].append(i)
            pending = [i for i in pending if i not in settled]
            if stop is not None and needs:
                col = match[stop] = rescan(stop)
                if col >= 0:
                    taken[col] = True
                routes["rescan"].append(stop)
                pending.remove(stop)
    return match, routes


def _case(name):
    """(K, T) float32 distances of one adversarial case, from a numpy
    seed."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "ties":                 # integer distances: many ties
        d = rng.randint(0, 3, (40, 24)).astype(np.float32)
        d[rng.rand(*d.shape) < 0.3] = 1e18
        d[3, :5] = -0.0                # -0 ties +0 by column
        d[3, 2] = 0.0
    elif name == "nan_untaken":        # matches nothing, takes nothing
        d = np.full((6, 10), 1e18, np.float32)
        d[0, 3] = 1.0
        d[1, [2, 5]] = [4.0, np.nan]
        d[2, [2, 7]] = [2.0, 3.0]      # takes 2: row 1 took nothing
    elif name == "nan_taken":          # a NaN in a taken column is 1e18
        d = np.full((6, 10), 1e18, np.float32)
        d[0, 3] = 1.0
        d[1, [3, 6]] = [np.nan, 5.0]   # matches 6
        d[2, [3, 4]] = [np.nan, np.nan]  # only NaNs, one taken: none
        d[4, 6] = np.nan               # a NaN row with nothing below 1e16
    elif name == "all_live":           # every row live
        d = rng.uniform(0, 100, (100, 256)).astype(np.float32)
    elif name == "exhaustion":         # 6 rows take row 6's 6 best
        d = rng.uniform(50, 100, (12, 40)).astype(np.float32)
        for i in range(6):
            d[i, :] = 1e18
            d[i, 10 + i] = 0.5
        d[6, 10:16] = np.arange(6, dtype=np.float32)
        d[7, [10, 11, 12, 13]] = 1.0   # exactly C candidates, all taken
        d[7, 14:] = 1e18
        d[7, :10] = 1e18
    elif name == "between":            # 1e16 <= v < 1e18 never match
        d = np.full((30, 50), 1e18, np.float32)
        d[rng.rand(*d.shape) < 0.4] = 5e16
        d[::4, 7] = 3e15               # below 1e16: a match for one row
        d[5, :] = 2e17
        d[9, :] = np.inf
    elif name == "t1":
        d = rng.choice(np.float32([1.0, 2.0, 1e18, 3e16]), (50, 1))
        d[7, 0] = np.nan
    else:                              # t1024: the widest map
        d = np.full((100, 1024), 1e18, np.float32)
        live = rng.rand(100) < 0.5
        d[live] = rng.uniform(0, 1e4, (live.sum(), 1024))
        d[rng.rand(*d.shape) < 0.8] = 1e18
        d[10, 1000:] = 0.0
        d[11, 1001:1005] = 0.0
    return d.astype(np.float32)


CASES = ["ties", "nan_untaken", "nan_taken", "all_live", "exhaustion",
         "between", "t1", "t1024"]


@pytest.mark.parametrize("name", CASES)
def test_two_pass_greedy_matches_jax(name):
    """The kernel's two passes give JAX's greedy_assign, row for row;
    the port's plain version (the kernel's oracle) gives it too."""
    d = _case(name)
    ref = np.asarray(jdt.greedy_assign(jnp.asarray(d)))
    got, _ = greedy_two_pass(d)
    np.testing.assert_array_equal(got, ref)
    plain = tracker.greedy_assign_plain(torch.from_numpy(d)[None])[0]
    np.testing.assert_array_equal(plain.numpy(), ref)


def test_cases_take_every_serial_route():
    """The cases reach what the serial pass does besides the candidate
    fast path: a rescan after the candidates are exhausted (with more
    than C entries below 1e16), none after them (exactly C, all taken),
    a rescan of a NaN row that then matches, one that matches nothing,
    and dead rows that are never visited."""
    _, ex = greedy_two_pass(_case("exhaustion"))
    assert 6 in ex["rescan"] and 7 in ex["none"]
    m, nt = greedy_two_pass(_case("nan_taken"))
    assert {1, 2, 4} <= set(nt["rescan"]) and m[1] == 6 and m[2] == -1
    m, nu = greedy_two_pass(_case("nan_untaken"))
    assert 1 in nu["rescan"] and m[1] == -1 and m[2] == 2
    _, btw = greedy_two_pass(_case("between"))
    visited = set(btw["candidate"] + btw["rescan"] + btw["none"])
    assert 5 not in visited and 9 not in visited


def test_exhaustion_rescan_takes_the_next_best_column():
    """Row 6's four candidates (10..13) and its next two columns were
    taken by rows 0..5: its rescan takes its best remaining column, JAX's
    choice, outside its candidates."""
    d = _case("exhaustion")
    m, _ = greedy_two_pass(d)
    assert list(m[:6]) == [10, 11, 12, 13, 14, 15]
    assert m[6] == np.asarray(jdt.greedy_assign(jnp.asarray(d)))[6]
    assert m[6] not in range(10, 16) and m[6] >= 0


# ---- splat_pre_hm -------------------------------------------------------

def splat_tiled(height, width, cts, radii, ks, valid):
    """The kernel's tiles on one stream: each 16 x 128 tile keeps, batch
    by batch of 256 slots, the valid slots whose clipped box meets it,
    and writes each pixel once, the max of 0 and of the kept slots'
    values above it, in the kernel's float32 operations."""
    canvas = torch.zeros(height, width)
    th, tw = TILE
    r_all = radii.clamp(max=gaussian.MAX_RADIUS)
    for ty0 in range(0, height, th):
        for tx0 in range(0, width, tw):
            tile = torch.zeros(min(th, height - ty0), min(tw, width - tx0))
            for s0 in range(0, len(valid), SLOT_BATCH):
                for s in range(s0, min(s0 + SLOT_BATCH, len(valid))):
                    r = int(r_all[s])
                    cx, cy = (int(v) for v in cts[s])
                    x0, x1 = max(cx - r, 0, tx0), min(cx + r, width - 1,
                                                      tx0 + tw - 1)
                    y0, y1 = max(cy - r, 0, ty0), min(cy + r, height - 1,
                                                      ty0 + th - 1)
                    if not valid[s] or r < 0 or x0 > x1 or y0 > y1:
                        continue
                    sigma = torch.tensor((2.0 * r + 1.0) / 6.0)
                    denom = 2.0 * sigma * sigma + 1e-12
                    dy = torch.arange(y0, y1 + 1).float()[:, None] - cy
                    dx = torch.arange(x0, x1 + 1).float()[None, :] - cx
                    g = torch.exp(-(dx * dx + dy * dy) / denom) * ks[s]
                    win = tile[y0 - ty0:y1 - ty0 + 1, x0 - tx0:x1 - tx0 + 1]
                    win.copy_(torch.where(g > win, g, win))
            canvas[ty0:ty0 + tile.shape[0], tx0:tx0 + tile.shape[1]] = tile
    return canvas


def _slots(seed, height, width, t):
    """Slots that straddle tile edges and the map's edges, radii past
    the cap and negative, invalid slots."""
    rng = np.random.RandomState(seed)
    cts = np.stack([rng.randint(-20, width + 20, t),
                    rng.randint(-20, height + 20, t)], 1).astype(np.int32)
    radii = rng.randint(-2, 40, t).astype(np.int32)
    radii[::17] = 200
    ks = rng.uniform(0.1, 1.0, t).astype(np.float32)
    valid = rng.rand(t) < 0.7
    cts[:4] = [[127, 15], [128, 16], [0, 0], [width - 1, height - 1]]
    return cts, radii, ks, valid


# maps past 128 x 128 pixels: JAX renders smaller ones densely
@pytest.mark.parametrize("height, width, t", [
    (40, 502, 12),     # W past three tiles, not a multiple of 4
    (67, 260, 300),    # H not a multiple of 16; two batches of slots
    (136, 240, 256)])  # the s4 map of the 544 x 960 path, T = 256
def test_tiled_splat_matches_plain_and_jax(height, width, t):
    cts, radii, ks, valid = _slots(height + width, height, width, t)
    args = [torch.from_numpy(a)[None] for a in (cts, radii, ks, valid)]
    plain = gaussian.splat_pre_hm_plain(height, width, *args)[0]
    got = splat_tiled(height, width, *(a[0] for a in args))
    torch.testing.assert_close(got, plain, atol=0, rtol=0)
    ref = np.asarray(jgaussian.render_pre_hm(
        height, width, jnp.asarray(cts), jnp.asarray(radii),
        jnp.asarray(ks), jnp.asarray(valid), compact=True))
    np.testing.assert_allclose(got.numpy(), ref[..., 0], atol=1e-6, rtol=0)
