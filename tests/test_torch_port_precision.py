"""The float32 path sets its own precision (``utils.precision``): on the
CPU, with the process's flags set to TF32 on in each way torch offers,
``FusedDetector.run``, ``Trainer.train_step`` and ``Trainer.val_step``
at float32 run their network with TF32 off in cuDNN and cuBLAS and
cuDNN still enabled, and give the caller's flags back; at bfloat16 they
touch nothing."""

import os

import bench
import pytest
import torch

from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.engine.trainer import Trainer
from centertrack_tpu_torch.models.model import create_model
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt
from centertrack_tpu_torch.utils.precision import full_float32, read_flags

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = {"cudnn_enabled": True, "cudnn_allow_tf32": False,
       "cudnn_conv": "ieee", "cudnn_rnn": "ieee", "cuda_matmul": "ieee",
       "float32_matmul_precision": "highest"}


class Meta:
    """The local1 checkpoint's training size."""
    num_categories, default_resolution, num_joints = 1, (96, 160), 17
    mean = [0.40789654, 0.44719302, 0.47026115]
    std = [0.28863828, 0.27408164, 0.27809835]


def _tf32_on(how):
    """The process's flags set to TF32 on: torch's defaults (cuDNN
    convolutions in TF32), plus matmuls by the legacy calls, or
    everything by the new API's top-level setting."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if how == "legacy":
        cudnn.allow_tf32 = True
        matmul.allow_tf32 = True
    elif how == "new":
        torch.backends.fp32_precision = "tf32"
    assert cudnn.conv.fp32_precision == "tf32"
    assert cudnn.enabled


@pytest.fixture
def process_flags():
    """Puts the process's precision settings back after the test."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    cpu_matmul = torch.backends.mkldnn.matmul
    saved = (torch.backends.fp32_precision, cudnn.conv.fp32_precision,
             cudnn.rnn.fp32_precision, matmul.fp32_precision,
             cpu_matmul.fp32_precision)
    yield
    torch.backends.fp32_precision = saved[0]
    cudnn.allow_tf32 = True
    cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = saved[1:3]
    torch.set_float32_matmul_precision("highest")
    matmul.fp32_precision, cpu_matmul.fp32_precision = saved[3:]


@pytest.mark.parametrize("how", ["default", "legacy", "new"])
def test_full_float32_turns_tf32_off_and_restores(process_flags, how):
    _tf32_on(how)
    before = read_flags()
    with full_float32("float32"):
        assert read_flags() == OFF
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert read_flags() == before
    with full_float32("bfloat16"):
        assert read_flags() == before
    assert read_flags() == before


def _cfg(dtype, **kw):
    return set_heads(parse_task(Config(
        task="tracking", pre_hm=True, track_thresh=0.3, new_thresh=0.3,
        max_age=3, dla_node="dcn_local1", compute_dtype=dtype, **kw)), Meta)


def _recording(model):
    """The flags read at each call of ``model``'s forward."""
    seen = []
    model.register_forward_pre_hook(
        lambda module, args: seen.append(read_flags()))
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["default", "new"])
def test_fused_detector_run_sets_its_own_precision(process_flags, dtype,
                                                   how):
    params, batch_stats = load_jax_ckpt(
        os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt"))
    det = FusedDetector(_cfg(dtype), params, batch_stats, Meta,
                        device="cpu")
    seen = _recording(det.model)
    frame = bench.synth_frames(1, height=192, width=320, n_obj=3, seed=2)[0]
    _tf32_on(how)
    before = read_flags()
    packed = det.run(frame)
    assert torch.isfinite(packed).all()
    assert seen == [OFF if dtype == "float32" else before]
    assert read_flags() == before


def _batch(cfg, n):
    """A descriptor batch of ``n`` images with one object each."""
    h, w = cfg.input_h, cfg.input_w
    oh, ow, m = cfg.output_h, cfg.output_w, 4
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(n, h, w, 3, generator=g),
             "pre_img": torch.randn(n, h, w, 3, generator=g),
             "ind": torch.zeros(n, m, dtype=torch.int64),
             "cat": torch.zeros(n, m, dtype=torch.int64),
             "mask": torch.zeros(n, m),
             "hm_cts": torch.zeros(n, m, 2, dtype=torch.int32),
             "hm_radii": torch.zeros(n, m, dtype=torch.int32),
             "hm_valid": torch.zeros(n, m, dtype=torch.bool),
             "ignore_boxes": torch.zeros(n, 1, 4),
             "ignore_cat": torch.zeros(n, 1, dtype=torch.int32),
             "ignore_valid": torch.zeros(n, 1, dtype=torch.bool),
             "pre_cts_int": torch.zeros(n, 2 * m, 2, dtype=torch.int32),
             "pre_radii": torch.zeros(n, 2 * m, dtype=torch.int32),
             "pre_ks": torch.zeros(n, 2 * m),
             "pre_valid": torch.zeros(n, 2 * m, dtype=torch.bool)}
    for head in ("reg", "wh", "tracking"):
        batch[head] = torch.zeros(n, m, 2)
        batch[head + "_mask"] = torch.zeros(n, m, 2)
    ct = torch.tensor([ow // 2, oh // 2], dtype=torch.int32)
    batch["ind"][:, 0] = int(ct[1]) * ow + int(ct[0])
    batch["mask"][:, 0] = 1
    batch["hm_cts"][:, 0] = ct
    batch["hm_radii"][:, 0] = 2
    batch["hm_valid"][:, 0] = True
    batch["wh"][:, 0] = torch.tensor([6.0, 8.0])
    for head in ("reg", "wh", "tracking"):
        batch[head + "_mask"][:, 0] = 1
    return batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_steps_set_their_own_precision(process_flags, dtype):
    cfg = _cfg(dtype, batch_size=1, input_h=64, input_w=64)
    trainer = Trainer(cfg, create_model(cfg, "cpu"), device="cpu")
    seen = _recording(trainer.model)
    batch = _batch(cfg, 1)
    _tf32_on("legacy")
    before = read_flags()
    losses = trainer.train_step(batch, 1e-4)
    assert torch.isfinite(losses["tot"])
    assert read_flags() == before
    trainer.val_step(batch)
    assert read_flags() == before
    want = OFF if dtype == "float32" else before
    assert seen == [want, want]
