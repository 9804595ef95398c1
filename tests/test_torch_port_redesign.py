"""What the redesigned bf16 DCN kernels (csrc/dcn_local_bf16.cu,
csrc/dcn_local_bwd_bf16.cu) rely on, checked on the CPU: the haloed
window (an output pixel's value and its gradient reach x only within
R + 1 rows and columns of it, in the port's plain version and in the
JAX package's op), and the launch plans the launchers hand the kernels
(``ops/dcn.fwd_bf16_plan``, ``bwd_data_bf16_plan``) at every DLA-34
neck shape, at B=1 and B=8, R=1 and R=2, and a ragged shape; the
smoke's bf16 cases, R=3 among them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from centertrack_tpu.ops import dcn as jdcn
from centertrack_tpu_torch.ops import dcn

torch.set_num_threads(2)

H, W, CIN, COUT = 13, 14, 4, 3
PY, PX = 6, 7   # the output pixel whose gradient is traced


def _inputs(seed, r, dtype):
    """x, offset (spread past +/-R, as the smoke's), mask, weight, bias."""
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(1, H, W, CIN),
            rng.uniform(-(r + 1.5), r + 1.5, (1, H, W, 18)),
            rng.rand(1, H, W, 9), rng.randn(3, 3, CIN, COUT) * 0.3,
            rng.randn(COUT))
    return [torch.tensor(a, dtype=torch.float32).to(dtype) for a in arrs]


def _outside(r):
    """Pixels more than R + 1 rows or columns from (PY, PX)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return (np.abs(yy - PY) > r + 1) | (np.abs(xx - PX) > r + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 2])
def test_grad_x_of_one_pixel_stays_in_its_halo(r, dtype):
    """One nonzero output-gradient pixel: the plain version's grad x is
    zero outside +/-(R + 1) of it and not zero inside; at float32 so is
    JAX's vjp of its op, and the two agree."""
    x, offset, mask, weight, bias = _inputs(20 + r, r, dtype)
    g = torch.zeros(1, H, W, COUT, dtype=dtype)
    g[0, PY, PX] = torch.tensor([1.0, -0.5, 0.25], dtype=dtype)
    xs = x.clone().requires_grad_()
    out = dcn.deform_conv2d_local_plain(xs, offset, mask, weight, bias, r)
    out.backward(g)
    grad = xs.grad[0].float().abs().sum(-1).numpy()
    outside = _outside(r)
    assert (grad[outside] == 0).all()
    assert (grad[~outside] > 0).any()
    if dtype == torch.float32:
        jx = jnp.asarray(x.numpy())
        _, vjp = jax.vjp(lambda a: jdcn.deform_conv2d_local(
            a, jnp.asarray(offset.numpy()), jnp.asarray(mask.numpy()),
            jnp.asarray(weight.numpy()), jnp.asarray(bias.numpy()), r), jx)
        jgrad = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
        assert (np.abs(jgrad[0]).sum(-1)[outside] == 0).all()
        np.testing.assert_allclose(xs.grad.numpy(), jgrad, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 2])
def test_output_pixel_reads_only_its_halo(r, dtype):
    """Replacing every x value outside +/-(R + 1) of an output pixel
    leaves that pixel's output unchanged, bit for bit."""
    x, offset, mask, weight, bias = _inputs(30 + r, r, dtype)
    out = dcn.deform_conv2d_local_plain(x, offset, mask, weight, bias, r)
    far = torch.from_numpy(_outside(r))[None, :, :, None]
    other = torch.where(far, torch.randn(x.shape).to(dtype) * 7, x)
    out2 = dcn.deform_conv2d_local_plain(other, offset, mask, weight, bias,
                                         r)
    assert torch.equal(out[0, PY, PX], out2[0, PY, PX])
    assert not torch.equal(out, out2)


# --- the launch plans --------------------------------------------------------

RAGGED = ("ragged", 17, 30, 72, 40)
SHAPES = [(n, h, w, ci, co) for n, h, w, ci, co, *_ in chip_smoke.NECK_SHAPES]
PLANS = {"fwd": dcn.fwd_bf16_plan, "data": dcn.bwd_data_bf16_plan}


def _cases():
    return [(kind, s, b, r) for kind in sorted(PLANS)
            for s in SHAPES + [RAGGED] for b in (1, 8) for r in (1, 2)]


@pytest.mark.parametrize("kind, shape, b, r", _cases())
def test_plan_covers_pixels_and_k_once_and_fits(kind, shape, b, r):
    """Tiles cover every output pixel once (the kernels' tile order:
    image, tile row, tile column); the splits' K ranges partition the
    steps (taps x Cin chunks) without an empty one; a launch has at
    least two blocks per SM unless every step is its own split, and its
    splits are those of the rule its plan names: the data kernel's the
    wave rule's (``_wave_splits``, as the float32 planners'), the
    forward's two blocks per SM (``_k_splits``: none once the tiles
    give them); the shared memory fits a block of the H100."""
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
    if kind == "data":
        assert plan["split_rule"] == "waves"
        assert plan["splits"] == dcn._wave_splits(
            plan["tiles"], plan["steps"],
            dcn._resident(plan["smem_bytes"], 128))
    else:
        assert plan["split_rule"] == "two_per_sm"
        if plan["tiles"] * cols >= dcn.TARGET_BLOCKS // 2:
            assert plan["splits"] == 1
    assert plan["smem_bytes"] <= dcn.SMEM_LIMIT == 227 * 1024
    if kind == "fwd":
        assert plan["n_tile"] in (64, 128, 256)
        assert plan["n_tile"] >= min(cout, 256)
        assert cols * plan["n_tile"] >= cout


def test_plan_refuses_a_window_past_shared_memory():
    """A halo too wide for 227 KB refuses the window design: the plan
    takes the gather route, which names the shared memory it would
    need."""
    for plan in (dcn.fwd_bf16_plan(1, 34, 60, 256, 256, 8),
                 dcn.bwd_data_bf16_plan(1, 34, 60, 256, 256, 4)):
        assert plan["route"] == "gather"
        assert plan["reason"].startswith("shared memory")
        assert int(plan["reason"].split()[2]) > dcn.SMEM_LIMIT


def test_data_plan_refuses_max_offset_past_its_walk():
    """The data kernel's support walk is built for max_offset up to
    BF16_DATA_MAX_OFFSET (4): the planner takes 4 where the window fits
    and, past it, takes the gather route, naming the limit."""
    assert dcn.BF16_DATA_MAX_OFFSET == 4
    plan = dcn.bwd_data_bf16_plan(1, 34, 60, 64, 64, 4)
    assert plan["route"] == "window"
    assert plan["smem_bytes"] <= dcn.SMEM_LIMIT
    plan = dcn.bwd_data_bf16_plan(1, 34, 60, 64, 16, 5)
    assert plan["route"] == "gather"
    assert plan["reason"] == "max_offset 5 > 4"


def test_smoke_bf16_cases_cover_the_neck_and_every_walk():
    """The smoke's bf16 checks run every neck shape at B=1 and at the
    training batch, the ragged shape, and R=1, 2 and 3 (the data kernel's
    two walk instantiations, R=1 and R up to 4), and both planners take
    every case."""
    cases = chip_smoke._dcn_cases()
    neck = {(h, w, ci, co) for _, h, w, ci, co, *_ in SHAPES}
    for b in (1, chip_smoke.TRAIN_B):
        assert neck <= {(h, w, ci, co) for _, bb, h, w, ci, co, _, _, r
                        in cases if bb == b and r == 1}
    assert {r for *_, r in cases} == {1, 2, 3}
    assert any(c[0] == "ragged" for c in cases)
    for _, b, h, w, ci, co, _, _, r in cases:
        for plan in PLANS.values():
            assert plan(b, h, w, ci, co, r)["smem_bytes"] <= dcn.SMEM_LIMIT


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[6], RAGGED])
def test_launchers_allocate_the_planned_scratch(monkeypatch, shape):
    """The bf16 launchers (their ctypes calls stood in) hand the kernels
    the plan's numbers and allocate the plan's float32 scratch: the
    forward's split partials, the data kernel's grad-x accumulator and
    its grad offset / mask partials; none when the launch is not
    split."""
    _, h, w, cin, cout = shape
    r = 1
    calls, floats = [], []
    monkeypatch.setattr(dcn, "_kernel", lambda symbol: (
        lambda *argv: calls.append((symbol, argv)) or 0))
    monkeypatch.setattr(dcn, "_stream", lambda t: 0)
    empty = torch.empty

    def recording_empty(*size, **kw):
        t = empty(*size, **kw)
        if t.dtype == torch.float32:
            floats.append(t.numel())
        return t

    monkeypatch.setattr(dcn.torch, "empty", recording_empty)
    x = torch.zeros(1, h, w, cin, dtype=torch.bfloat16)
    offset = torch.zeros(1, h, w, 18, dtype=torch.bfloat16)
    mask = torch.zeros(1, h, w, 9, dtype=torch.bfloat16)
    weight = torch.zeros(3, 3, cin, cout, dtype=torch.bfloat16)
    g = torch.zeros(1, h, w, cout, dtype=torch.bfloat16)

    fwd = dcn.fwd_bf16_plan(1, h, w, cin, cout, r)
    dcn.launch_fwd_bf16(x, offset, mask, weight, None, r)
    symbol, argv = calls.pop()
    assert symbol == "dcn_local_fwd_bf16"
    assert argv[13:18] == (4, 16, 64, fwd["n_tile"], fwd["splits"])
    assert argv[18] == fwd["smem_bytes"]
    assert floats == ([fwd["scratch"]] if fwd["scratch"] else [])
    assert (argv[6] is None) == (fwd["splits"] == 1)
    if fwd["splits"] > 1:
        assert fwd["scratch"] == fwd["splits"] * h * w * cout

    floats.clear()
    data = dcn.bwd_data_bf16_plan(1, h, w, cin, cout, r)
    dcn.launch_bwd_data_bf16(x, offset, mask, weight, g, r)
    symbol, argv = calls.pop()
    assert symbol == "dcn_local_bwd_data_bf16"
    assert argv[16:21] == (4, 16, 64, data["splits"], data["smem_bytes"])
    assert floats == [data["grad_acc"]] + ([data["scratch"]]
                                           if data["scratch"] else [])
    assert data["grad_acc"] == h * w * cin
    assert (argv[9] is None) == (data["splits"] == 1)
    if data["splits"] > 1:
        assert data["scratch"] == data["splits"] * h * w * 27
