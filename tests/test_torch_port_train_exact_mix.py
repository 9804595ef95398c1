"""The port's training step at dla_node "dcn_mix" (5 exact DCNv2 nodes
on the stride-16 and -32 maps, 11 clamped ones at R=2 below them)
against the JAX package on the CPU, as tests/test_torch_port_train_exact.py
holds "dcn": one DLA-34 step at 64x64, B=2, on the committed
exact-trained checkpoint and the float32 slice's seeded batch, at the
float32 step's tolerances of tests/test_torch_port_train.py. JAX's
value_and_grad runs op by op here: compiling the whole dcn_mix step
(the clamped nodes' R=2 schedules) takes twice as long on the CPU as
running it. On the card the same step runs both ops' kernels
(chip_smoke.py's train_dcn_mix phases)."""

import numpy as np
import pytest

from test_torch_port_train_exact import HEADS, ckpt_dcn, step_pair  # noqa

NODE = "dcn_mix"


def _pair(ckpt):
    return step_pair(NODE, ckpt, jit=False)


def test_step_runs_exact_and_clamped_nodes(ckpt_dcn):
    """The port's network at dcn_mix holds exact (gather) and clamped
    (local) DCN layers."""
    assert _pair(ckpt_dcn)[6] == {"DCNLayer:gather", "DCNLayer:local"}


@pytest.mark.parametrize("head", HEADS)
def test_mix_train_step_loss_matches_jax(ckpt_dcn, head):
    """Each head's loss, rel 1e-5."""
    jl, tl = _pair(ckpt_dcn)[:2]
    np.testing.assert_allclose(tl[head], jl[head], rtol=1e-5)


def test_mix_train_step_every_gradient_matches_jax(ckpt_dcn):
    """All 243 gradient leaves: |port - JAX| <= 1e-4 max|JAX leaf| +
    1e-6 max|any gradient|, as at dcn."""
    jg, tg = _pair(ckpt_dcn)[2:4]
    assert set(jg) == set(tg) and len(jg) == 243
    floor = 1e-6 * max(np.abs(v).max() for v in jg.values())
    for path in jg:
        np.testing.assert_allclose(
            tg[path], jg[path], rtol=0,
            atol=1e-4 * np.abs(jg[path]).max() + floor,
            err_msg="/".join(path))


def test_mix_train_step_batch_stats_match_jax(ckpt_dcn):
    """All 114 running statistics after the step, within 1e-5 of each
    leaf's largest value."""
    jbs, tbs = _pair(ckpt_dcn)[4:6]
    assert set(jbs) == set(tbs) and len(jbs) == 114
    for path in jbs:
        np.testing.assert_allclose(tbs[path], jbs[path], rtol=0,
                                   atol=1e-5 * np.abs(jbs[path]).max(),
                                   err_msg="/".join(path))
