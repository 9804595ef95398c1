"""chip_smoke.py on a machine without a GPU, and its helpers: it must
fail with no result line when CUDA is missing or when it stands alone,
and its copy of the frame generator must match bench.py's."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import bench
import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_smoke_fails_without_cuda_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("seed", [0, 3])
def test_smoke_frames_match_the_bench_generator(seed):
    ours = chip_smoke.synth_frames(3, height=120, width=200, n_obj=3,
                                   seed=seed)
    ref = bench.synth_frames(3, height=120, width=200, n_obj=3, seed=seed)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_dcn_bound_counts_operations_and_bytes():
    n, cin, cout = 136 * 240, 64, 64
    ms, by = chip_smoke.dcn_bound_ms(n, cin, cout)
    ops = 2 * n * 9 * cin * cout + 8 * n * 9 * cin
    assert by == "operations"
    assert ms == pytest.approx(1e3 * ops / chip_smoke.PEAK_FP32_FLOPS)
    # one input and one output channel: the bytes bound
    ms1, by1 = chip_smoke.dcn_bound_ms(n, 1, 1)
    assert by1 == "bytes"
    assert ms1 == pytest.approx(
        1e3 * 4 * (n + 27 * n + 9 + 1 + n) / chip_smoke.PEAK_BYTES_S)


def test_neck_shapes_are_the_models_dcn_layers():
    """The smoke's per-shape table lists every DCN layer of DLA-34
    dcn_local1 once: 16 launches per frame."""
    from collections import Counter
    from centertrack_tpu_torch.config import (Config, MOT_META, parse_task,
                                              set_heads)
    from centertrack_tpu_torch.models.layers import DCNLayer
    from centertrack_tpu_torch.models.model import create_model
    cfg = set_heads(parse_task(Config(task="tracking", pre_hm=True,
                                      dla_node="dcn_local1")), MOT_META)
    layers = Counter(tuple(m.weight.shape[2:])
                     for m in create_model(cfg, "cpu").modules()
                     if isinstance(m, DCNLayer))
    table = Counter()
    for _, _, _, cin, cout, per_frame, _ in chip_smoke.NECK_SHAPES:
        table[(cin, cout)] += per_frame
    assert layers == table and sum(table.values()) == 16


def test_profile_phase_runs_on_a_small_detector(capsys):
    """The optional --profile phase over a 96x160 detector on the CPU
    (no device events there; the card's numbers come from chip runs)."""
    import json
    from centertrack_tpu_torch.config import Config, parse_task, set_heads
    from centertrack_tpu_torch.engine.fused import FusedDetector
    from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

    class Meta:
        num_categories = 1
        default_resolution = [96, 160]
        mean = chip_smoke.MOT_META.mean
        std = chip_smoke.MOT_META.std

    cfg = set_heads(parse_task(Config(task="tracking", pre_hm=True,
                                      max_age=3, dla_node="dcn_local1")),
                    Meta)
    det = FusedDetector(cfg, *load_jax_ckpt(chip_smoke.CKPT), Meta,
                        device="cpu")
    frames = chip_smoke.synth_frames(5, height=192, width=320, n_obj=3)
    chip_smoke.phase_profile(det, frames, cfg, 2)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["phase"] == "profile" and row["frames"] == 2
    assert row["wall_ms_per_frame"] > 0
    assert row["host_top"] and all(
        h["self_cpu_ms_per_frame"] >= 0 for h in row["host_top"])


def test_synth_clip_returns_the_frames_and_the_drawn_boxes():
    frames, boxes = chip_smoke.synth_clip(3, height=120, width=200,
                                          n_obj=3, seed=5)
    for a, b in zip(frames, chip_smoke.synth_frames(3, height=120,
                                                    width=200, n_obj=3,
                                                    seed=5)):
        np.testing.assert_array_equal(a, b)
    assert boxes.shape == (3, 3, 4)
    # the last object is drawn last: its box is its colour but for the
    # white centre dot
    for f, img in enumerate(frames):
        x1, y1, x2, y2 = boxes[f, -1].astype(int)
        patch = img[y1:y2, x1:x2].reshape(-1, 3)
        colours, counts = np.unique(patch, axis=0, return_counts=True)
        assert len(colours) == 2 and (colours == 255).all(1).any()
        assert counts.max() > 0.8 * len(patch)


def test_dcn_bwd_bound_counts_operations_and_bytes():
    n, cin, cout = 136 * 240, 64, 64
    (d_ms, d_by), (w_ms, w_by) = chip_smoke.dcn_bwd_bound_ms(n, cin, cout)
    assert d_by == w_by == "operations"
    assert d_ms == pytest.approx(1e3 * (2 * n * 9 * cin * cout
                                        + 38 * n * 9 * cin)
                                 / chip_smoke.PEAK_FP32_FLOPS)
    assert w_ms == pytest.approx(chip_smoke.dcn_bound_ms(n, cin, cout)[0])
    (d1, by1), (w1, wby1) = chip_smoke.dcn_bwd_bound_ms(n, 1, 1)
    assert by1 == wby1 == "bytes"
    assert d1 == pytest.approx(1e3 * 4 * (2 * n + 54 * n + 9 + n)
                               / chip_smoke.PEAK_BYTES_S)


def test_train_batch_feeds_a_training_step():
    """The smoke's descriptor batch at 96x160 on the CPU: the keys the
    JAX dataset emits, GT peaks at the object centres, finite losses
    from one Trainer step."""
    from centertrack_tpu_torch.config import Config, parse_task, set_heads
    from centertrack_tpu_torch.data.render import render_batch
    from centertrack_tpu_torch.engine.trainer import Trainer
    from centertrack_tpu_torch.models.model import (create_model,
                                                    params_from_jax)
    from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

    class Meta:
        num_categories = 1
        default_resolution = [96, 160]

    cfg = set_heads(parse_task(Config(task="tracking", pre_hm=True,
                                      dla_node="dcn_local1")), Meta)
    frames, boxes = chip_smoke.synth_clip(3, height=192, width=320,
                                          n_obj=4, seed=1)
    batch = chip_smoke.train_batch(cfg, frames, boxes, "cpu")
    from test_trainer import tiny_batch
    assert set(batch) == set(tiny_batch())
    assert batch["image"].shape == (2, 96, 160, 3)
    live = batch["mask"] > 0
    assert live.sum() == 8
    hm = render_batch(batch, cfg)["hm"]
    for i in range(2):
        for ind in batch["ind"][i][live[i]]:
            assert hm[i].reshape(-1)[ind] == 1.0
    model = create_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(*load_jax_ckpt(chip_smoke.CKPT)))
    losses = Trainer(cfg, model, "cpu").train_step(batch, 1e-4)
    assert all(np.isfinite(float(v)) for v in losses.values())


def _standin_launchers(monkeypatch, wrong=None):
    """The three DCN launchers replaced by CPU stand-ins built from the
    plain version; the one named ``wrong`` returns a result 1e-3 off."""
    import torch

    from centertrack_tpu_torch.ops import dcn

    def vjp(x, offset, mask, weight, g, r):
        ts = [t.detach().requires_grad_() for t in (x, offset, mask,
                                                    weight)]
        with torch.enable_grad():   # backward runs with grad mode off
            out = dcn.deform_conv2d_local_plain(*ts, None, r)
        return torch.autograd.grad(out, ts, g)

    def off(kind, ts):
        return tuple(t * (1 + 1e-3) for t in ts) if kind == wrong else ts

    monkeypatch.setattr(dcn, "launch_fwd", lambda *a: off(
        "fwd", (dcn.deform_conv2d_local_plain(*a),))[0])
    monkeypatch.setattr(dcn, "launch_bwd_data", lambda *a: off(
        "data", vjp(*a)[:3]))
    monkeypatch.setattr(dcn, "launch_bwd_weight", lambda x, o, m, g, c, r:
                        off("weight", (vjp(x, o, m, torch.zeros(
                            3, 3, x.shape[3], c), g, r)[3],))[0])
    return dcn


@pytest.mark.parametrize("wrong", [None, "fwd", "data", "weight"])
def test_record_launches_holds_each_launch_against_the_plain_version(
        monkeypatch, wrong):
    """_RecordLaunches around DCNLocal (launchers stood in on the CPU):
    one launch of each kernel is recorded and passes; a launch whose
    result is 1e-3 off (past REL_TOL and GRAD_REL_TOL) fails."""
    import torch
    dcn = _standin_launchers(monkeypatch, wrong)
    rng = np.random.RandomState(0)
    ts = [torch.from_numpy(a.astype(np.float32)).requires_grad_() for a in (
        rng.randn(2, 5, 6, 4), rng.uniform(-2.5, 2.5, (2, 5, 6, 18)),
        rng.rand(2, 5, 6, 9), rng.randn(3, 3, 4, 3), rng.randn(3))]
    with chip_smoke._RecordLaunches() as rec:
        dcn.DCNLocal.apply(*ts, 1).backward(torch.ones(2, 5, 6, 3))
    assert [c[0] for c in rec.calls] == ["fwd", "data", "weight"]
    if wrong is None:
        worst = rec.check(1)
        assert set(worst) == {"fwd", "data", "weight"}
        assert max(worst.values()) < 1e-6
    else:
        with pytest.raises(RuntimeError, match="rel err"):
            rec.check(1)


def test_record_launches_requires_every_launch(monkeypatch):
    """A launch count other than the one asked for fails the check, so a
    route that bypasses the patched launchers cannot pass it unseen."""
    import torch
    dcn = _standin_launchers(monkeypatch)
    x = torch.randn(1, 4, 4, 2)
    with chip_smoke._RecordLaunches() as rec:
        dcn.DCNLocal.apply(x, torch.zeros(1, 4, 4, 18), torch.ones(1, 4, 4, 9),
                           torch.randn(3, 3, 2, 2), None, 1)
    assert [c[0] for c in rec.calls] == ["fwd"]
    with pytest.raises(RuntimeError, match="expected 1 of each"):
        rec.check(1)
    with chip_smoke._RecordLaunches() as rec:
        pass
    with pytest.raises(RuntimeError, match="expected 16 of each"):
        rec.check(16)


def test_dcn_bound_bf16_adds_tensor_and_sampling_work_against_bytes():
    """Contraction at the bf16 tensor-core peak plus sampling at the fp32
    peak, against bf16 bytes; the 16 neck launches of a 544x960 frame
    come to 0.049 ms, every one bound by operations."""
    n, cin, cout = 136 * 240, 64, 64
    ms, by = chip_smoke.dcn_bound_ms_bf16(n, cin, cout)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * (
        2 * n * 9 * cin * cout / chip_smoke.PEAK_BF16_FLOPS
        + 8 * n * 9 * cin / chip_smoke.PEAK_FP32_FLOPS))
    ms1, by1 = chip_smoke.dcn_bound_ms_bf16(n, 1, 1)
    assert by1 == "bytes"
    assert ms1 == pytest.approx(
        1e3 * 2 * (n + 27 * n + 9 + 1 + n) / chip_smoke.PEAK_BYTES_S)
    frame = [chip_smoke.dcn_bound_ms_bf16(h * w, ci, co)
             for _, h, w, ci, co, k, _ in chip_smoke.NECK_SHAPES
             for _ in range(k)]
    assert {b for _, b in frame} == {"operations"}
    assert sum(m for m, _ in frame) == pytest.approx(0.0491, abs=1e-4)


def test_bf16_agreement_counts_ulps_and_the_tolerance():
    """bf16_ulp is the spacing of bf16 at each value; bf16_agreement
    counts elements more than one ulp apart and those past
    BF16_ULPS ulps + BF16_REL_OF_MAX max|ref|."""
    import torch
    ref = torch.tensor([1.0, 3.0, -6.0, 100.0, 0.01]).bfloat16()
    np.testing.assert_array_equal(
        chip_smoke.bf16_ulp(ref).numpy(),
        [2.0 ** -7, 2.0 ** -6, 2.0 ** -5, 2.0 ** -1, 2.0 ** -14])
    ulp = chip_smoke.bf16_ulp(ref)
    # one ulp off everywhere: nothing past either bound
    err, past_ulp, past_tol = chip_smoke.bf16_agreement(
        (ref.float() + ulp).bfloat16(), ref)
    assert (past_ulp, past_tol) == (0, 0) and err == 0.5
    # 0.05 off at 0.01: past one ulp, within 1e-3 * 100 = 0.1
    off = ref.float().clone()
    off[4] += 0.05
    _, past_ulp, past_tol = chip_smoke.bf16_agreement(off.bfloat16(), ref)
    assert (past_ulp, past_tol) == (1, 0)
    # three ulps off at 3.0 (> 2 ulps + 0.1): past the tolerance
    off = ref.float().clone()
    off[1] += 0.2
    _, past_ulp, past_tol = chip_smoke.bf16_agreement(off.bfloat16(), ref)
    assert (past_ulp, past_tol) == (1, 1)


def test_rows_against_compares_paths_frame_by_frame():
    """The comparison of the bf16 path's rows with the float32 path's,
    on two 96x160 detectors on the CPU over three frames: the rows of a
    path against themselves agree exactly; bf16 against float32 counts
    the frames and bounds the differences."""
    from centertrack_tpu_torch.config import Config, parse_task, set_heads
    from centertrack_tpu_torch.engine.fused import FusedDetector
    from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

    class Meta:
        num_categories = 1
        default_resolution = [96, 160]
        mean = chip_smoke.MOT_META.mean
        std = chip_smoke.MOT_META.std

    frames = chip_smoke.synth_frames(3, height=192, width=320, n_obj=4)
    packed = {}
    for dtype in ("float32", "bfloat16"):
        cfg = set_heads(parse_task(Config(
            task="tracking", pre_hm=True, max_age=3, dla_node="dcn_local1",
            compute_dtype=dtype)), Meta)
        det = FusedDetector(cfg, *load_jax_ckpt(chip_smoke.CKPT), Meta,
                            device="cpu")
        packed[dtype] = [det.run(f).numpy() for f in frames]
    same = chip_smoke.rows_against(packed["float32"], packed["float32"],
                                   cfg.out_thresh)
    assert same["rows_unpaired"] == 0 and same["pairs"] >= 5
    assert same["pairs_same_track_id"] == same["pairs"]
    assert same["track_ids_one_to_one"]
    assert same["max_score_diff"] == same["max_bbox_diff_px"] == 0
    vs = chip_smoke.rows_against(packed["bfloat16"], packed["float32"],
                                 cfg.out_thresh)
    assert len(vs["rows_per_frame"]) == 3 and vs["pairs"] >= 5
    assert 0 < vs["max_score_diff"] < 0.1


@pytest.mark.parametrize("wrong", [False, True])
def test_record_launches_holds_bf16_launches_to_the_bf16_tolerance(
        monkeypatch, wrong):
    """_RecordLaunches(("bf16",)) around bf16 calls whose launcher is a
    CPU stand-in built from the plain version: exact launches pass; a
    launch 3% off (past 2 ulps + 1e-3 max|ref|) fails."""
    import torch

    from centertrack_tpu_torch.ops import dcn

    def launch(*a):
        out = dcn.deform_conv2d_local_plain(*a)
        return (out.float() * 1.03).bfloat16() if wrong else out

    monkeypatch.setattr(dcn, "launch_fwd_bf16", launch)
    rng = np.random.RandomState(1)
    ts = [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in (
        rng.randn(1, 5, 6, 4), rng.uniform(-2.5, 2.5, (1, 5, 6, 18)),
        rng.rand(1, 5, 6, 9), rng.randn(3, 3, 4, 3), rng.randn(3))]
    with chip_smoke._RecordLaunches(("bf16",)) as rec:
        for _ in range(2):
            dcn.route(torch.device("cuda"), torch.bfloat16)(*ts, 1)
    assert dcn.launch_fwd_bf16 is launch
    if wrong:
        with pytest.raises(RuntimeError, match="past the tolerance"):
            rec.check(2)
    else:
        assert rec.check(2) == {"bf16": 0.0}


def test_rows_against_leaves_out_near_threshold_rows_and_tied_peaks():
    """Rows are paired by centre, not by rank. A bf16 path whose rows
    carry an extra peak tied exactly with its neighbour, and a score
    just above the threshold that the other path has just below: with a
    margin and ties collapsed they agree; a renumbered track keeps the
    ids one to one; a tie of two objects far apart is no NMS tie and
    both rows stay."""
    def packed(rows):
        p = np.zeros((6, 13), np.float32)
        for i, (score, tid, x) in enumerate(rows):
            p[i, 0], p[i, 10], p[i, 2] = score, tid, x
            p[i, 6:10] = (x - 5, 0, x + 5, 10)
        return p

    a = packed([(0.9, 1, 100), (0.5, 2, 300), (0.5, 3, 308),
                (0.305, 4, 500)])
    b = packed([(0.501, 2, 301), (0.901, 1, 100), (0.297, 0, 500)])
    strict = chip_smoke.rows_against([a], [b], 0.3)
    assert strict["rows_per_frame"] == [[4, 2]]
    assert strict["rows_unpaired"] == 2 and strict["pairs"] == 2
    loose = chip_smoke.rows_against([a], [b], 0.3, 1e-2, collapse_ties=True)
    assert loose["rows_per_frame"] == [[2, 2]]
    assert loose["rows_unpaired"] == 0
    assert loose["pairs"] == loose["pairs_same_track_id"] == 2
    assert loose["max_score_diff"] == pytest.approx(1e-3, rel=1e-3)
    assert loose["max_bbox_diff_px"] == 1
    renumbered = packed([(0.901, 7, 100), (0.501, 9, 301)])
    other = chip_smoke.rows_against([a], [renumbered], 0.3, 1e-2, True)
    assert other["pairs_same_track_id"] == 0
    assert other["track_ids_one_to_one"]
    # equal scores of two distinct objects (not neighbouring peaks) are
    # both kept, and a row's partner left out is reported by its score
    apart = packed([(0.9, 1, 100), (0.5, 2, 300), (0.5, 3, 600)])
    kept = chip_smoke.rows_against([apart], [b], 0.3, 1e-2, True)
    assert kept["rows_per_frame"] == [[3, 2]]
    assert kept["unpaired_scores"] == [pytest.approx(0.5)]


def test_rows_against_counts_id_swaps_on_exact_ties_apart():
    """With ties collapsed (bf16), two pairs of a frame that swap track
    ids are counted apart where one path scores the two rows exactly
    equal (no score order: the tracker numbered them by the decode's
    tie-break), and they stay out of the one-to-one map; a swap of rows
    whose scores differ in both paths, and any swap without
    ``collapse_ties``, still counts as differing ids. So are cycles of
    tied rows, and the ids shifted by a tied neighbour that one path's
    tracker numbered."""
    def packed(rows):
        p = np.zeros((6, 13), np.float32)
        for i, (score, tid, x) in enumerate(rows):
            p[i, 0], p[i, 10], p[i, 2] = score, tid, x
            p[i, 6:10] = (x - 5, 0, x + 5, 10)
        return p

    kernel = packed([(0.9, 1, 100), (0.615, 8, 144), (0.615, 9, 1752)])
    plain = packed([(0.9, 1, 100), (0.615, 8, 1752), (0.608, 9, 144)])
    tie = chip_smoke.rows_against([kernel, kernel], [plain, kernel], 0.3,
                                  1e-2, collapse_ties=True)
    assert tie["pairs"] == 6 and tie["pairs_same_track_id"] == 4
    assert tie["pairs_renumbered_on_exact_tie"] == 2
    assert tie["track_ids_one_to_one"]
    strict = chip_smoke.rows_against([kernel], [plain], 0.3)
    assert strict["pairs_renumbered_on_exact_tie"] == 0
    apart = packed([(0.9, 1, 100), (0.62, 8, 144), (0.615, 9, 1752)])
    untied = chip_smoke.rows_against([apart], [plain], 0.3, 1e-2, True)
    assert untied["pairs_same_track_id"] == 1
    assert untied["pairs_renumbered_on_exact_tie"] == 0
    # three rows born tied, numbered in a cycle: counted apart; the same
    # cycle with one score apart in both paths is not
    k3 = packed([(0.98, 1, 100), (0.98, 2, 400), (0.98, 3, 700)])
    p3 = packed([(0.98, 2, 100), (0.98, 3, 400), (0.98, 1, 700)])
    cycle = chip_smoke.rows_against([k3], [p3], 0.3, 1e-2, True)
    assert cycle["pairs_renumbered_on_exact_tie"] == 3
    assert cycle["track_ids_one_to_one"]
    k3[0, 0] = p3[0, 0] = 0.99
    open_cycle = chip_smoke.rows_against([k3], [p3], 0.3, 1e-2, True)
    assert open_cycle["pairs_renumbered_on_exact_tie"] == 0
    assert open_cycle["pairs_same_track_id"] == 0
    # a tied neighbour of one path, numbered as a new track, shifts the
    # ids of the tracks born after it: counted apart once renumbered; the
    # same shift without the tie is not
    k4 = packed([(0.91, 1, 352), (0.8, 2, 968), (0.7, 3, 1176),
                 (0.6, 4, 1096)])
    p5 = packed([(0.91, 1, 352), (0.91, 2, 359.6), (0.8, 3, 968),
                 (0.7, 4, 1176), (0.6, 5, 1096)])
    shift = chip_smoke.rows_against([k4], [p5], 0.3, 1e-2, True)
    assert shift["pairs"] == 4 and shift["pairs_same_track_id"] == 1
    assert shift["pairs_renumbered_on_exact_tie"] == 3
    assert shift["track_ids_one_to_one"]
    assert [t[:3] for t in shift["tied_left_out"]] == [[0, 1, 2]]
    p5[1, 0] = 0.905
    untied = chip_smoke.rows_against([k4], [p5], 0.3, 1e-2, True)
    assert untied["pairs_renumbered_on_exact_tie"] == 0


def test_dcn_bwd_bound_bf16_counts_tensor_and_fp32_work_against_bytes():
    """The backward kernels' operations at bf16: the contraction at the
    bf16 tensor-core peak, the bilinear work (38 and 8 per sampled
    value) at the fp32 peak, against bf16 bytes; the 16 neck launches of
    a 544x960 image come to 0.126 ms (data) and 0.049 ms (weight), every
    one bound by operations."""
    n, cin, cout = 136 * 240, 64, 64
    (d_ms, d_by), (w_ms, w_by) = chip_smoke.dcn_bwd_bound_ms_bf16(
        n, cin, cout)
    assert d_by == w_by == "operations"
    contraction = 2 * n * 9 * cin * cout / chip_smoke.PEAK_BF16_FLOPS
    assert d_ms == pytest.approx(1e3 * (
        contraction + 38 * n * 9 * cin / chip_smoke.PEAK_FP32_FLOPS))
    assert w_ms == pytest.approx(chip_smoke.dcn_bound_ms_bf16(
        n, cin, cout)[0])
    (d1, by1), (w1, wby1) = chip_smoke.dcn_bwd_bound_ms_bf16(n, 1, 1)
    assert by1 == wby1 == "bytes"
    assert d1 == pytest.approx(1e3 * 2 * (2 * n + 54 * n + 9 + n)
                               / chip_smoke.PEAK_BYTES_S)
    assert w1 == pytest.approx(1e3 * 2 * (n + 27 * n + n + 9)
                               / chip_smoke.PEAK_BYTES_S)
    image = [chip_smoke.dcn_bwd_bound_ms_bf16(h * w, ci, co)
             for _, h, w, ci, co, k, _ in chip_smoke.NECK_SHAPES
             for _ in range(k)]
    assert {b for pair in image for _, b in pair} == {"operations"}
    assert sum(d for (d, _), _ in image) == pytest.approx(0.1259, abs=1e-4)
    assert sum(w for _, (w, _) in image) == pytest.approx(0.0491, abs=1e-4)


@pytest.mark.parametrize("wrong", [None, "bf16", "data_bf16",
                                   "weight_bf16"])
def test_record_launches_holds_the_bf16_backward_kernels(monkeypatch,
                                                         wrong):
    """_RecordLaunches over the three bf16 kinds around DCNLocal at bf16,
    its launchers stood in on the CPU by the plain bf16 version: one
    launch of each is recorded and passes; a launch 3% off (past 2 ulps
    + 1e-3 max|ref|) fails."""
    import torch

    from centertrack_tpu_torch.ops import dcn

    def off(kind, ts):
        return tuple((t.float() * 1.03).bfloat16() if kind == wrong else t
                     for t in ts)

    def vjp(x, offset, mask, weight, g, r):
        ts = [t.detach().requires_grad_() for t in (x, offset, mask,
                                                    weight)]
        with torch.enable_grad():
            out = dcn.deform_conv2d_local_plain(*ts, None, r)
        return torch.autograd.grad(out, ts, g)

    monkeypatch.setattr(dcn, "launch_fwd_bf16", lambda *a: off(
        "bf16", (dcn.deform_conv2d_local_plain(*a),))[0])
    monkeypatch.setattr(dcn, "launch_bwd_data_bf16", lambda *a: off(
        "data_bf16", vjp(*a)[:3]))
    monkeypatch.setattr(dcn, "launch_bwd_weight_bf16",
                        lambda x, o, m, g, c, r: off("weight_bf16", (vjp(
                            x, o, m, torch.zeros(3, 3, x.shape[3], c,
                                                 dtype=x.dtype), g, r)[3],
                        ))[0])
    rng = np.random.RandomState(2)
    ts = [torch.from_numpy(a.astype(np.float32)).bfloat16().requires_grad_()
          for a in (rng.randn(2, 5, 6, 4), rng.uniform(-2.5, 2.5,
                                                       (2, 5, 6, 18)),
                    rng.rand(2, 5, 6, 9), rng.randn(3, 3, 4, 3),
                    rng.randn(3))]
    kinds = chip_smoke.TRAIN_KINDS["dcn_local1", "bfloat16"]
    with chip_smoke._RecordLaunches(kinds) as rec:
        dcn.DCNLocal.apply(*ts, 1).backward(
            torch.from_numpy(rng.randn(2, 5, 6, 3)).bfloat16())
    assert [c[0] for c in rec.calls] == list(kinds)
    if wrong is None:
        assert set(rec.check(1)) == set(kinds)
    else:
        with pytest.raises(RuntimeError, match="past the tolerance"):
            rec.check(1)


@pytest.mark.parametrize("node", ["dcn", "dcn_mix"])
def test_exact_cases_are_the_models_exact_layers(node):
    """The exact phase's per-frame launches list every exact DCN layer of
    DLA-34 at ``node`` once (dcn: 16; dcn_mix: the 5 on the stride-16 and
    -32 maps), and PATH_KERNELS counts the path's launches of each
    kernel: the exact layers and, at dcn_mix, the 11 clamped ones."""
    from collections import Counter
    from centertrack_tpu_torch.config import (Config, MOT_META, parse_task,
                                              set_heads)
    from centertrack_tpu_torch.models.layers import DCNLayer
    from centertrack_tpu_torch.models.model import create_model
    cfg = set_heads(parse_task(Config(task="tracking", pre_hm=True,
                                      dla_node=node)), MOT_META)
    modes = Counter()
    exact = Counter()
    for m in create_model(cfg, "cpu").modules():
        if isinstance(m, DCNLayer):
            modes[m.mode] += 1
            if m.mode == "gather":
                exact[tuple(m.weight.shape[2:])] += 1
    table = Counter()
    for _, b, _, _, cin, cout, per_frame, _ in chip_smoke._exact_cases():
        if b == 1 and per_frame[node]:
            table[(cin, cout)] += per_frame[node]
    assert exact == table
    for dtype in ("float32", "bfloat16"):
        want = chip_smoke.PATH_KERNELS.get((node, dtype))
        if want is None:
            continue
        assert sum(n for k, n in want.items() if "exact" in k) == \
            modes["gather"]
        assert sum(n for k, n in want.items() if "local" in k) == \
            modes["local"]


@pytest.mark.parametrize("wrong", [None, "exact", "exact_bf16"])
def test_record_launches_holds_the_exact_kernels(monkeypatch, wrong):
    """_RecordLaunches(("exact", "exact_bf16")) around calls of the exact
    launchers, stood in on the CPU by the plain version: launches equal to
    it pass (counts by kind); a float32 launch 1e-3 off (past REL_TOL) or
    a bf16 one 3% off (past 2 ulps + 1e-3 max|ref|) fails."""
    import torch

    from centertrack_tpu_torch.ops import dcn

    def stand_in(kind, scale):
        def launch(*a):
            out = dcn.deform_conv2d_plain(*a)
            return (out.float() * scale).to(out.dtype) if wrong == kind \
                else out
        return launch

    monkeypatch.setattr(dcn, "launch_exact_fwd", stand_in("exact", 1.001))
    monkeypatch.setattr(dcn, "launch_exact_fwd_bf16",
                        stand_in("exact_bf16", 1.03))
    rng = np.random.RandomState(2)
    ts = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(1, 5, 6, 4), rng.randn(1, 5, 6, 18) * 3,
        rng.rand(1, 5, 6, 9), rng.randn(3, 3, 4, 3), rng.randn(3))]
    with chip_smoke._RecordLaunches(("exact", "exact_bf16")) as rec:
        dcn.launch_exact_fwd(*ts)
        for _ in range(2):
            dcn.launch_exact_fwd_bf16(*(t.bfloat16() for t in ts))
    if wrong:
        with pytest.raises(RuntimeError, match="rel err|past the tolerance"):
            rec.check({"exact": 1, "exact_bf16": 2})
    else:
        assert rec.check({"exact": 1, "exact_bf16": 2}) == {
            "exact": 0.0, "exact_bf16": 0.0}
    with pytest.raises(RuntimeError, match="expected"):
        rec.check(1)


@pytest.mark.parametrize("name", ["ddd", "pose"])
def test_task_neck_cases_are_the_task_models_dcn_layers(name):
    """The kernel phase's ddd and pose neck shapes are the DCN layers of
    the task's network at its input (448x800, 512x512): the same
    channels, 16 layers, every map size of the network's own."""
    import torch
    from collections import Counter
    from centertrack_tpu_torch.models.layers import DCNLayer
    from centertrack_tpu_torch.models.model import create_model
    cfg = chip_smoke._task_cfg(name, "float32")
    model = create_model(cfg, "cpu")
    seen = Counter()
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.update([(o.shape[2], o.shape[3],
                                      m.weight.shape[2], m.weight.shape[3])]))
        for m in model.modules() if isinstance(m, DCNLayer)]
    h, w = chip_smoke.TASKS[name]["input"]
    with torch.no_grad():
        model(torch.zeros(1, h, w, 3), torch.zeros(1, h, w, 3),
              torch.zeros(1, h, w, 1))
    for hook in hooks:
        hook.remove()
    cases = [c for c in chip_smoke._task_neck_cases()
             if c[0].startswith(name + " ")]
    table = Counter()
    for (_, _, ch, cw, cin, cout, *_), (*_, k, _) in zip(
            cases, chip_smoke.NECK_SHAPES):
        table[(ch, cw, cin, cout)] += k
    assert seen == table and sum(table.values()) == 16


def test_task_rows_against_pairs_extras_and_counts_snap_flips():
    """task_rows_against on fetch_full-like rows: rows paired by centre,
    each extra's largest difference as a share of its tolerance (angles
    modulo 2 pi), a keypoint past its tolerance counted as a snap flip
    and left out with its row's kps_score, rows near the threshold
    allowed to go unpaired."""
    rng = np.random.RandomState(0)

    def row(ct, score, tid):
        return {"ct": np.float32(ct), "score": score, "tracking_id": tid,
                "bbox": np.float32([*ct, ct[0] + 9, ct[1] + 9]),
                "rot_y": np.pi - 1e-4, "dep": 20.0,
                "hps": rng.uniform(0, 100, 34).astype(np.float32),
                "kps_score": 0.5}
    ref = [[row([10, 10], 0.9, 1), row([50, 40], 0.5, 2),
            row([30, 70], 0.4, 4)]]
    got = [[dict(r) for r in ref[0]]]
    got[0][0]["rot_y"] = -np.pi + 2e-4           # 3e-4 across the wrap
    got[0][0]["dep"] = 20.0 + 0.5 * (1e-3 * 20 + 1e-3)
    got[0][1]["hps"] = got[0][1]["hps"].copy()
    got[0][1]["hps"][4] += 7.0                   # joint 2 snapped elsewhere
    got[0][1]["kps_score"] = 0.9
    got[0].append(row([80, 80], 0.1 + 5e-4, 3))  # near the threshold
    vs = chip_smoke.task_rows_against(got, ref, 0.1,
                                      ("rot_y", "dep", "hps", "kps_score"))
    assert vs["pairs"] == 3 and vs["rows_unpaired"] == 1
    assert vs["rows_unpaired_past_margin"] == 0
    share = vs["max_share_of_tol"]
    assert share["rot_y"] == pytest.approx(0.3, rel=1e-3)
    assert share["dep"] == pytest.approx(0.5, rel=1e-3)
    assert share["hps"] == 0 and share["kps_score"] == 0
    assert (vs["hps_flips"], vs["hps_compared"]) == (1, 51)
    chip_smoke._check_pairs("test", vs, 1e-3)
    got[0][0]["dep"] = 25.0
    with pytest.raises(RuntimeError):
        chip_smoke._check_pairs("test", chip_smoke.task_rows_against(
            got, ref, 0.1, ("dep",)), 1e-3)
    # the ids are held as asked: two rows under one id fail "same" and
    # "one_to_one" and pass where another check holds them (ids=None)
    merged = [[dict(r) for r in ref[0]]]
    merged[0][1]["tracking_id"] = 1
    vs = chip_smoke.task_rows_against(merged, ref, 0.1, ("dep",))
    assert not vs["track_ids_one_to_one"]
    chip_smoke._check_pairs("test", vs, 1e-3, ids=None)
    for ids in ("same", "one_to_one"):
        with pytest.raises(RuntimeError):
            chip_smoke._check_pairs("test", vs, 1e-3, ids=ids)
