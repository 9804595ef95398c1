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
