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
