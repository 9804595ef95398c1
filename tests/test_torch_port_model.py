"""The port's model (centertrack_tpu_torch.models) against the JAX
package: the checkpoint reader, the weight bridge over the committed
local1 checkpoint, UpBilinear with an asymmetric kernel, the DLA-34
dcn_local1 forward at its training size, and the decode."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.models.layers import UpBilinear as JUpBilinear
from centertrack_tpu.models.model import create_model as jcreate_model
from centertrack_tpu.ops import decode as jdecode
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.models.layers import UpBilinear
from centertrack_tpu_torch.models.model import (create_model,
                                                params_from_jax)
from centertrack_tpu_torch.ops import decode
from centertrack_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")


class TrainMeta:
    """The local1 checkpoint's training size."""
    num_categories = 1
    default_resolution = [96, 160]
    num_joints = 17


def _leaves(tree):
    return sum(_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


@pytest.fixture(scope="module")
def ckpt():
    return checkpoint.load_jax_ckpt(CKPT)


def _cfgs():
    kw = dict(task="tracking", pre_hm=True, track_thresh=0.3,
              new_thresh=0.3, max_age=3, dla_node="dcn_local1")
    return (set_heads(parse_task(Config(**kw)), TrainMeta),
            jset_heads(jparse_task(JConfig(**kw)), TrainMeta))


def test_checkpoint_reads_float32_trees(ckpt):
    params, batch_stats = ckpt
    assert _leaves(params) == 243 and _leaves(batch_stats) == 114
    leaf = params["backbone"]["dla_up"]["ida_0"]["node_1"]["conv"]["weight"]
    assert leaf.dtype == np.float32 and leaf.shape == (3, 3, 256, 256)


@pytest.mark.parametrize("spelling", ["numpy._core", "numpy.core"])
def test_checkpoint_unpickler_maps_numpy_core(tmp_path, spelling):
    """A pickle naming either numpy module path loads under either
    numpy major version."""
    tree = {"params": {"a": {"kernel": np.arange(6, dtype=np.float16)
                             .reshape(2, 3)}},
            "batch_stats": {}}
    raw = pickle.dumps(tree, protocol=3)   # newline-ended GLOBAL names
    for name in (b"numpy._core", b"numpy.core"):
        raw = raw.replace(name + b".multiarray",
                          spelling.encode() + b".multiarray")
    path = tmp_path / "t.ckpt"
    path.write_bytes(raw)
    params, _ = checkpoint.load_jax_ckpt(str(path))
    np.testing.assert_array_equal(params["a"]["kernel"],
                                  np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    assert params["a"]["kernel"].dtype == np.float32


def test_checkpoint_unpickler_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.ckpt"
    path.write_bytes(pickle.dumps({"params": os.getcwd}))
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.load_jax_ckpt(str(path))


def test_bridge_consumes_every_leaf_once(ckpt):
    params, batch_stats = ckpt
    sd = params_from_jax(params, batch_stats)
    n_bn = _leaves(batch_stats) // 2
    assert len(sd) == 243 + 114 + n_bn   # + num_batches_tracked per BN
    model = create_model(_cfgs()[0], "cpu")
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
    node = params["backbone"]["dla_up"]["ida_0"]["node_1"]["conv"]
    got = model.backbone.dla_up.ida_0.node_1.conv
    np.testing.assert_array_equal(got.weight.detach().numpy(), node["weight"])
    np.testing.assert_array_equal(
        got.conv_offset_mask.weight.detach().numpy(),
        node["conv_offset_mask"]["kernel"].transpose(3, 2, 0, 1))


def test_bridge_raises_on_unknown_and_missing_leaves(ckpt):
    params, batch_stats = ckpt
    extra = dict(params, backbone=dict(params["backbone"],
                                       odd={"gamma": np.zeros(3)}))
    with pytest.raises(ValueError, match="odd/gamma"):
        params_from_jax(extra, batch_stats)
    heads = dict(params["heads"])
    heads.pop("wh")
    sd = params_from_jax(dict(params, heads=heads), batch_stats)
    with pytest.raises(RuntimeError, match="Missing key"):
        create_model(_cfgs()[0], "cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("factor", [2, 4])
def test_up_bilinear_matches_jax_with_asymmetric_kernel(factor):
    """The JAX layer convolves the dilated input without flipping its
    kernel; a kernel that is not symmetric shows any flip error."""
    rng = np.random.RandomState(factor)
    c, k = 3, 2 * factor
    kernel = rng.randn(k, k, 1, c).astype(np.float32)
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    ref = JUpBilinear(c, factor).apply({"params": {"kernel": kernel}}, x)
    up = UpBilinear(c, factor)
    sd = params_from_jax({"up_1": {"kernel": kernel}}, {})
    up.load_state_dict({"weight": sd["up_1.weight"]})
    with torch.no_grad():
        out = up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (2, 5 * factor, 7 * factor, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.fixture(scope="module")
def forward_pair(ckpt):
    """Both packages' DLA-34 dcn_local1 forward at 96x160 on the same
    seeded inputs, with the committed local1 weights."""
    params, batch_stats = ckpt
    cfg, jcfg = _cfgs()
    rng = np.random.RandomState(7)
    x = rng.randn(1, 96, 160, 3).astype(np.float32)
    pre_img = rng.randn(1, 96, 160, 3).astype(np.float32)
    pre_hm = rng.rand(1, 96, 160, 1).astype(np.float32)
    jmodel = jcreate_model(jcfg.arch, jcfg.heads_dict, jcfg.head_convs_dict,
                           jcfg)
    jout = jax.jit(lambda v, a, b, c: jmodel.apply(v, a, b, c, train=False))(
        {"params": params, "batch_stats": batch_stats}, x, pre_img,
        pre_hm)[-1]
    model = create_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(params, batch_stats), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(pre_img),
                    torch.from_numpy(pre_hm))[-1]
    return ({k: np.array(v) for k, v in jout.items()},
            {k: v.contiguous() for k, v in out.items()})


@pytest.mark.parametrize("head", ["hm", "reg", "tracking", "wh"])
def test_dla34_local1_forward_matches_jax(forward_pair, head):
    jout, out = forward_pair
    assert out[head].shape == jout[head].shape == (1, 24, 40,
                                                   1 if head == "hm" else 2)
    np.testing.assert_allclose(out[head].numpy(), jout[head], atol=1e-4,
                               rtol=0)


def test_generic_decode_matches_jax_on_the_forward(forward_pair):
    """Decode of the same head maps: every peak with a score above 1e-3
    (below that, suppressed zeros tie and top-K orders them freely)."""
    jout, _ = forward_pair
    ref = jdecode.generic_decode(jdecode.sigmoid_output(
        {k: jnp.asarray(v) for k, v in jout.items()}), k=100,
        num_classes=1)
    got = decode.generic_decode(decode.sigmoid_output(
        {k: torch.from_numpy(v.copy()) for k, v in jout.items()}), k=100)
    keep = np.asarray(ref["scores"])[0] > 1e-3
    assert keep.sum() >= 5
    for key in ("scores", "inds", "clses", "cts", "bboxes", "tracking"):
        np.testing.assert_allclose(got[key][0].numpy()[keep],
                                   np.asarray(ref[key])[0][keep],
                                   atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("num_classes", [1, 3])
def test_decode_matches_jax_on_distinct_scores(num_classes):
    """Random maps with all-distinct heat values: every one of the K
    rows agrees, ties aside."""
    rng = np.random.RandomState(num_classes)
    h, w, k = 20, 28, 30
    heat = rng.permutation(h * w * num_classes).reshape(
        1, h, w, num_classes).astype(np.float32) / (h * w * num_classes)
    maps = {"hm": heat,
            "reg": rng.rand(1, h, w, 2).astype(np.float32),
            "wh": (rng.rand(1, h, w, 2) * 9 - 1).astype(np.float32),
            "tracking": rng.randn(1, h, w, 2).astype(np.float32)}
    ref = jdecode.generic_decode({k_: jnp.asarray(v) for k_, v in
                                  maps.items()}, k=k,
                                 num_classes=num_classes)
    got = decode.generic_decode({k_: torch.from_numpy(v) for k_, v in
                                 maps.items()}, k=k)
    for key in ("scores", "inds", "clses", "xs", "ys", "bboxes",
                "tracking"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-6, rtol=0, err_msg=key)


def test_nms_heat_matches_jax():
    rng = np.random.RandomState(11)
    heat = rng.rand(2, 17, 23, 2).astype(np.float32)
    np.testing.assert_array_equal(
        decode.nms_heat(torch.from_numpy(heat)).numpy(),
        np.asarray(jdecode.nms_heat(jnp.asarray(heat))))


def test_create_model_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the model is built there")
    with pytest.raises(RuntimeError, match="no GPU"):
        create_model(_cfgs()[0])


@pytest.mark.parametrize("cfg_kw, what", [
    (dict(dla_node="dcn"), "exact DCNv2"),
    (dict(dla_node="gcn"), "not ported"),
    (dict(arch="res_18"), "not ported"),
])
def test_create_model_refuses_what_is_not_ported(cfg_kw, what):
    base = dict(task="tracking", pre_hm=True, dla_node="dcn_local1")
    base.update(cfg_kw)
    cfg = set_heads(parse_task(Config(**base)), TrainMeta)
    with pytest.raises(NotImplementedError, match=what):
        create_model(cfg, "cpu")
