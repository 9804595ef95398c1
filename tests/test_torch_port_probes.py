"""The port's toolchain probes (ops/probes.py, the plain versions of the
kernels in csrc/probes.cu) against the JAX package's Pallas probes
(tools/pallas_probe.py P0-P6, tools/pallas_probe2.py P10-P15) on the
CPU, on the same seeded inputs.

The JAX probes build their inputs with ``jnp.ones`` (P6's indices with
``jnp.zeros``) and run ``pl.pallas_call`` without ``interpret``. The
tests run them unmodified: the probe module's ``jnp`` is replaced by a
stand-in whose ``ones`` (and ``zeros``, where queued) return the seeded
arrays and which passes everything else to ``jax.numpy``, its ``pl`` by
one whose ``pallas_call`` runs in interpret mode, and, for P10-P15, its
``_run`` by one that keeps the output (the original sums it in bf16,
which saturates).

Agreement, chip_smoke.probe_agreement, the criterion the card's check
uses: every probe but P3 bit for bit (NaN rows of P6 included; P1 and
P2 keep the probe's order of multiplies and adds); P3 within 2 bf16 ulps
+ 1e-3 max|ref| per element, the bf16 DCN's rule: its nine
(1024x64)@(64x64) products may be summed in another order than XLA's.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from centertrack_tpu.tools import pallas_probe as jprobe
from centertrack_tpu.tools import pallas_probe2 as jprobe2
from centertrack_tpu_torch.ops import probes
from centertrack_tpu_torch.tools import pallas_probe, pallas_probe2
from jax.experimental import pallas as pl

# port probe -> (JAX module, JAX function)
JAX_PROBES = {
    "p0_copy": (jprobe, "p0_copy"),
    "p1_fma12": (jprobe, "p1_fma12"),
    "p2_fma30": (jprobe, "p2_fma30"),
    "p3_tap_loop": (jprobe, "p3_tap_loop"),
    "p4_sublane_slice": (jprobe, "p4_sublane_slice"),
    "p5_lane_slice": (jprobe, "p5_lane_slice"),
    "p6_gather": (jprobe, "p6_gather"),
    "p10_aligned": (jprobe2, "p10_aligned"),
    "p11_leading_offset": (jprobe2, "p11_leading_offset"),
    "p12_sublane_offset": (jprobe2, "p12_sublane_offset"),
    "p13_value_slice": (jprobe2, "p13_value_slice"),
    "p14_4d_leading": (jprobe2, "p14_4d_leading"),
    "p15_dynamic_leading": (jprobe2, "p15_dynamic_leading"),
}


class _SeededJnp:
    """``jax.numpy`` with ``ones`` / ``zeros`` returning queued arrays."""

    def __init__(self, ones=(), zeros=()):
        self._queues = {"ones": list(ones), "zeros": list(zeros)}

    def __getattr__(self, name):
        queue = self._queues.get(name)
        if queue:
            def make(shape, dtype=None):
                a = queue.pop(0)
                assert a.shape == tuple(shape), (name, a.shape, shape)
                return jnp.asarray(a, dtype)
            return make
        return getattr(jnp, name)


class _InterpretPl:
    """``jax.experimental.pallas`` with ``pallas_call`` in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call,
                                                 interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bits(t):
    """A probe's output as bits, so that NaN rows compare too."""
    return t.view(torch.int16)


def run_jax(name, inputs, monkeypatch):
    """The unmodified JAX probe on ``inputs`` (torch CPU tensors), in
    interpret mode; its output as a torch tensor."""
    module, fn = JAX_PROBES[name]
    arrays = [_np(t) for t in inputs]
    if name == "p6_gather":
        stand_in = _SeededJnp(ones=arrays[:1], zeros=arrays[1:])
    else:
        stand_in = _SeededJnp(ones=arrays)
    monkeypatch.setattr(module, "jnp", stand_in)
    monkeypatch.setattr(module, "pl", _InterpretPl())
    if module is jprobe:
        out = getattr(module, fn)()
    else:
        kept = {}
        monkeypatch.setattr(module, "_run", lambda n, f, *a, res=None:
                            kept.setdefault("out", jax.jit(f)(*a)))
        getattr(module, fn)({})
        out = kept["out"]
    out = np.asarray(out)
    if out.dtype == jnp.bfloat16:   # as bits: NaNs keep their pattern
        return torch.from_numpy(out.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(out.copy())


@pytest.mark.parametrize("name", probes.NAMES)
def test_probe_matches_jax(name, monkeypatch):
    inputs = probes.seeded_inputs(name, seed=11)
    got = probes.run(name, *inputs)
    ref = run_jax(name, inputs, monkeypatch)
    chip_smoke.probe_agreement(name, got, ref)
    assert torch.isfinite(got).any()


def test_p3_clamps_the_shift_index_at_the_last_slab(monkeypatch):
    """P3 reads slab min(s, 24): with only slab 24 non-zero the output is
    JAX's (whose index past 24 reads slab 24 on the CPU), and the slabs
    a wrapped index would reach (0..5) are never read."""
    xs, hy, hx, m, w = probes.seeded_inputs("p3_tap_loop", seed=3)
    only_last = torch.zeros_like(xs)
    only_last[24] = xs[24]
    got = probes.run("p3_tap_loop", only_last, hy, hx, m, w)
    chip_smoke.probe_agreement(
        "p3_tap_loop", got,
        run_jax("p3_tap_loop", [only_last, hy, hx, m, w], monkeypatch))
    # of the 81 reads of each tap loop, 4 are of slab 24 itself and 11
    # reach it through the clamp
    assert sum(probes.p3_shift(t, a, b) == 24 for t in range(9)
               for a in range(3) for b in range(3)) == 4 + 11
    changed = xs.clone()
    changed[:6] = 100.0
    assert torch.equal(probes.run("p3_tap_loop", changed, hy, hx, m, w),
                       probes.run("p3_tap_loop", xs, hy, hx, m, w))


def test_p6_wraps_once_and_fills_nan_outside(monkeypatch):
    table = probes.seeded_inputs("p6_gather", seed=5)[0]
    idx = torch.zeros(256, dtype=torch.int32)
    idx[:8] = torch.tensor([-1, 512, -513, 0, 511, -512, 700, 3])
    got = probes.run("p6_gather", table, idx)
    chip_smoke.probe_agreement("p6_gather", got,
                               run_jax("p6_gather", [table, idx],
                                       monkeypatch))
    assert torch.equal(got[0], table[511])
    assert torch.isnan(got[[1, 2, 6]].float()).all()
    assert torch.equal(got[[3, 4, 5, 7]], table[[0, 511, 0, 3]])


def test_p15_returns_program_one(monkeypatch):
    (x,) = probes.seeded_inputs("p15_dynamic_leading", seed=7)
    got = probes.run("p15_dynamic_leading", x)
    chip_smoke.probe_agreement(
        "p15_dynamic_leading", got,
        run_jax("p15_dynamic_leading", [x], monkeypatch))
    program = [sum(x[0, t + a:t + a + 8].float() for a in range(3))
               for t in range(2)]
    assert torch.equal(got[0], program[1].to(torch.bfloat16))
    assert not torch.equal(got[0], program[0].to(torch.bfloat16))


def test_pallas_probe_main_reports_the_jax_names(tmp_path, capsys):
    out = tmp_path / "probe.json"
    assert pallas_probe.main([str(out), "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(report) == [fn.__name__ for fn in jprobe.PROBES]
    assert all(v.startswith("OK (") for v in report.values())
    assert json.loads(out.read_text()) == report


def _jax_probe2_names(monkeypatch):
    names = []
    monkeypatch.setattr(jprobe2, "_run", lambda n, *a, res=None:
                        names.append(n))
    for fn in (jprobe2.p10_aligned, jprobe2.p11_leading_offset,
               jprobe2.p12_sublane_offset, jprobe2.p13_value_slice,
               jprobe2.p14_4d_leading, jprobe2.p15_dynamic_leading):
        fn({})
    return names


def test_pallas_probe2_main_reports_the_jax_names(tmp_path, capsys,
                                                  monkeypatch):
    out = tmp_path / "probe2.json"
    assert pallas_probe2.main([str(out), "--device", "cpu"]) == 0
    report = json.loads(out.read_text())
    assert list(report) == ["device"] + _jax_probe2_names(monkeypatch)
    # all-ones inputs: the float32 sums of 8 x 240 x 64 outputs
    sums = [2, 3, 3, 3, 15, 3]
    assert [v for k, v in report.items() if k != "device"] == [
        f"OK sum={s * 8 * 240 * 64:.3f}" for s in sums]
    assert '"p15_dynamic_leading_offset"' in capsys.readouterr().out


def test_probe_mains_fail_without_a_card():
    """On the default device, without a card every probe fails, is
    reported so, and the exit code is not 0."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes run on it")
    assert pallas_probe.main([]) == 1
    assert pallas_probe2.main([]) == 1


@pytest.mark.parametrize("name, change, error", [
    ("p0_copy", lambda ins: [ins[0][:8]], ValueError),
    ("p1_fma12", lambda ins: [ins[0].float(), ins[1]], TypeError),
    ("p3_tap_loop", lambda ins: ins[:4] + [ins[4].float()], TypeError),
    ("p6_gather", lambda ins: [ins[0], ins[1].long()], TypeError),
    ("p11_leading_offset", lambda ins: [ins[0][:, :, :240]], ValueError),
    ("p14_4d_leading", lambda ins: [ins[0].transpose(2, 3).contiguous()
                                    .transpose(2, 3)], ValueError),
    ("p5_lane_slice", lambda ins: ins * 2, TypeError),
])
def test_probe_raises_on_a_wrong_input(name, change, error, monkeypatch):
    """Wrong shape, dtype, layout or count raises before any launch."""
    monkeypatch.setattr(probes, "route", lambda *a: pytest.fail(
        "a wrong input reached a launcher"))
    with pytest.raises(error):
        probes.run(name, *change(probes.seeded_inputs(name, seed=0)))


def _fake_kernels(monkeypatch, rc=0):
    calls = []

    def fake_kernel(symbol):
        def launch(*argv):
            calls.append((symbol, argv))
            return rc
        return launch
    monkeypatch.setattr(probes, "_kernel", fake_kernel)
    monkeypatch.setattr(probes, "_stream", lambda t: 0)
    for name in probes.NAMES:
        monkeypatch.setitem(probes.PLAIN, name, lambda *a: pytest.fail(
            "the plain version was reached"))
    return calls


@pytest.mark.parametrize("name", ["p3_tap_loop", "p15_dynamic_leading"])
def test_cuda_route_launches_the_kernel_and_counts(name, monkeypatch):
    """A CUDA call goes to the launcher, never to the plain version: it
    passes the inputs' pointers, a fresh output and the stream, and
    counts one launch (the ctypes call is a stand-in here)."""
    calls = _fake_kernels(monkeypatch)
    inputs = probes.seeded_inputs(name, seed=0)
    fn = probes.route(name, torch.device("cuda"))
    before = probes.LAUNCHES[name]
    out = fn(*inputs)
    assert probes.LAUNCHES[name] == before + 1
    assert len(calls) == 1 and calls[0][0] == "probe_" + name
    argv = calls[0][1]
    assert argv[:len(inputs)] == tuple(t.data_ptr() for t in inputs)
    assert len(argv) == len(inputs) + 2 and argv[-1] == 0
    assert tuple(out.shape) == probes.SPECS[name][1]


def test_cuda_launch_failure_raises_without_counting(monkeypatch):
    _fake_kernels(monkeypatch, rc=719)
    inputs = probes.seeded_inputs("p0_copy", seed=0)
    before = probes.LAUNCHES["p0_copy"]
    with pytest.raises(RuntimeError, match="probe_p0_copy launch failed: "
                                           "CUDA error 719"):
        probes.route("p0_copy", torch.device("cuda"))(*inputs)
    assert probes.LAUNCHES["p0_copy"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        probes.route("p0_copy", torch.device("meta"))


def test_smoke_probe_bound_counts_bytes_and_operations():
    """chip_smoke's probe bounds: P10 moves the (8, 240, 64) bf16 part
    of its window that its output doubles, and that output; P3 is bound
    by its float32 operations; P6 reads only the table rows its valid
    indices select."""
    ms, by = chip_smoke.probe_bound_ms(
        "p10_aligned", probes.seeded_inputs("p10_aligned", seed=0))
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 491_520 / chip_smoke.PEAK_BYTES_S)
    ms, by = chip_smoke.probe_bound_ms(
        "p3_tap_loop", probes.seeded_inputs("p3_tap_loop", seed=0))
    assert by == "operations"
    assert ms == pytest.approx(1e3 * chip_smoke.PROBE_OPS["p3_tap_loop"]
                               / chip_smoke.PEAK_FP32_FLOPS)
    table = probes.seeded_inputs("p6_gather", seed=0)[0]
    idx = torch.tensor([3, -509, 600] * 85 + [3], dtype=torch.int32)
    ms, by = chip_smoke.probe_bound_ms("p6_gather", [table, idx])
    assert by == "bytes"   # one distinct row: 3 and -509 are row 3
    assert ms == pytest.approx(1e3 * (256 + 256 * 4 + 256 * 128 * 2)
                               / chip_smoke.PEAK_BYTES_S)
    assert set(chip_smoke.PROBE_OPS) == set(chip_smoke.PROBE_REPLACES) \
        == set(probes.NAMES)


_WIN = 240 * 64 * 2   # bytes of one bf16 window row


@pytest.mark.parametrize("name, read", [
    ("p0_copy", 16 * 128 * 4),
    ("p1_fma12", 8 * 16 * 128 * 2 + 8 * 4),       # 12 terms: all 8 slabs
    ("p3_tap_loop", 19 * 8 * 128 * 64 * 2          # slabs 6..24 of 25
     + 2 * 9 * 3 * 8 * 128 * 4 + 9 * 8 * 128 * 4 + 9 * 64 * 64 * 2),
    ("p4_sublane_slice", 10 * 128 * 8 * 4),        # x[1:11]
    ("p5_lane_slice", 16 * 130 * 4),               # x[:, 3:133]
    ("p11_leading_offset", 10 * _WIN),             # rows 0..9, cols :240
    ("p12_sublane_offset", 8 * 242 * 64 * 2),      # rows 0..7, cols :242
    # rows 0 and 9 240 columns, 1 and 8 241, 2..7 all 242
    ("p13_value_slice", (2 * 240 + 2 * 241 + 6 * 242) * 64 * 2),
    ("p14_4d_leading", 5 * 10 * _WIN),             # the whole input
    ("p15_dynamic_leading", 10 * _WIN),            # program 1: rows 1..10
])
def test_smoke_probe_bound_counts_only_the_bytes_read(name, read):
    """A probe's bound counts the input bytes its output depends on, not
    the whole input, and its output once."""
    inputs = probes.seeded_inputs(name, seed=0)
    masks = chip_smoke.probe_reads(name, inputs)
    assert sum(int(m.sum()) * t.element_size()
               for m, t in zip(masks, inputs)) == read
    shape, dtype = probes.SPECS[name][1:]
    written = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    ms, _ = chip_smoke.probe_bound_ms(name, inputs)
    assert ms == pytest.approx(1e3 * max(
        (read + written) / chip_smoke.PEAK_BYTES_S,
        chip_smoke.PROBE_OPS[name] / chip_smoke.PEAK_FP32_FLOPS))


def test_smoke_probe_reads_are_what_the_output_depends_on():
    """Changing an input element outside ``probe_reads`` leaves the
    probe's output as it was; the windows' masks hold each term."""
    for name in ("p3_tap_loop", "p4_sublane_slice", "p5_lane_slice",
                 "p6_gather", "p11_leading_offset", "p12_sublane_offset",
                 "p13_value_slice", "p15_dynamic_leading"):
        inputs = probes.seeded_inputs(name, seed=2)
        mask = chip_smoke.probe_reads(name, inputs)[0]
        want = _bits(probes.run(name, *inputs))
        changed = inputs[0].clone()
        changed[~mask] = 7
        assert torch.equal(_bits(probes.run(name, changed, *inputs[1:])),
                           want), name
        changed = inputs[0].clone()
        changed[mask] += 1
        assert not torch.equal(_bits(probes.run(name, changed, *inputs[1:])),
                               want), name


@pytest.mark.parametrize("name", ["p0_copy", "p6_gather", "p14_4d_leading",
                                  "p1_fma12", "p3_tap_loop"])
def test_smoke_probe_agreement_holds_each_criterion(name):
    """chip_smoke's check of a probe kernel against its plain version:
    bit-for-bit probes refuse a one-ulp flip, P3 accepts one ulp and
    refuses 5% of max|ref|."""
    ref = probes.PLAIN[name](*probes.seeded_inputs(name, seed=1))
    assert chip_smoke.probe_agreement(name, ref.clone(), ref)["bit_equal"]
    flipped = ref.clone()
    flat = flipped.view(-1)
    i = int(torch.isfinite(flat.float()).nonzero()[0])
    bits = flat.view(torch.int16 if ref.dtype == torch.bfloat16
                     else torch.int32)
    bits[i] += 1
    if name == "p3_tap_loop":
        assert not chip_smoke.probe_agreement(name, flipped,
                                              ref)["bit_equal"]
        flat[i] += 0.05 * ref.float().abs().max()
    with pytest.raises(RuntimeError, match="differ"):
        chip_smoke.probe_agreement(name, flipped, ref)
