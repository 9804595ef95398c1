"""Checkpoints of the port (centertrack_tpu_torch.models.model
save_model / load_model / _merge_tree / load_backbone, the optimizer
state in optax's layout, engine.checkpoint.CheckpointManager and
Trainer.resume / start / fit) against the JAX package on the CPU.

Tolerances: none. Trees, optimizer moments and counts are equal
exactly, in both directions, and a resumed training step is bit for bit
the uninterrupted one.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centertrack_tpu.config import Config as JConfig
from centertrack_tpu.config import parse_task as jparse_task
from centertrack_tpu.config import set_heads as jset_heads
from centertrack_tpu.engine.trainer import make_optimizer as jmake_optimizer
from centertrack_tpu.models.model import _merge_tree as j_merge_tree
from centertrack_tpu.models.model import load_model as jload_model
from centertrack_tpu.models.model import save_model as jsave_model
from centertrack_tpu_torch.config import Config, parse_task, set_heads
from centertrack_tpu_torch.data.datasets import CustomDataset
from centertrack_tpu_torch.data.loader import DataLoader
from centertrack_tpu_torch.engine.checkpoint import CheckpointManager
from centertrack_tpu_torch.engine.fused import FusedDetector
from centertrack_tpu_torch.engine.trainer import Trainer, make_optimizer
from centertrack_tpu_torch.models import model as port_model
from centertrack_tpu_torch.models.layers import BatchNorm
from centertrack_tpu_torch.models.model import (create_model, load_backbone,
                                                load_model,
                                                optimizer_from_jax,
                                                optimizer_to_jax,
                                                params_from_jax,
                                                params_to_jax, save_model,
                                                write_payload)
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")


class Meta:
    num_categories = 1
    default_resolution = [96, 160]
    num_joints = 17
    mean = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
    std = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)


def _cfgs(optim="adam", **kw):
    kw = dict(task="tracking", pre_hm=True, dla_node="dcn_local1",
              optim=optim, lr=3e-4, **kw)
    return (set_heads(parse_task(Config(**kw)), Meta),
            jset_heads(jparse_task(JConfig(**kw)), Meta))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.fixture(scope="module")
def ckpt():
    return load_jax_ckpt(CKPT)


def _seeded_opt_state(jcfg, params, seed, count=7):
    """JAX's make_optimizer(cfg).init(params) with seeded moments and
    counts: the layout is read from optax, not written here."""
    state = jmake_optimizer(jcfg).init(params)
    rng = np.random.RandomState(seed)
    rand = lambda a: rng.randn(*a.shape).astype(np.float32)
    inner = state.inner_state[0]
    if jcfg.optim == "adam":
        inner = inner._replace(
            count=jnp.asarray(count, jnp.int32),
            mu=jax.tree.map(rand, params),
            nu=jax.tree.map(lambda a: np.abs(rand(a)), params))
    else:
        inner = inner._replace(trace=jax.tree.map(rand, params))
    return state._replace(count=jnp.asarray(count, jnp.int32),
                          inner_state=(inner,) + tuple(state.inner_state[1:]))


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_jax_checkpoint_with_opt_state_reads_in_the_port(optim, ckpt,
                                                         tmp_path):
    cfg, jcfg = _cfgs(optim)
    params, batch_stats = ckpt
    opt_state = _seeded_opt_state(jcfg, params, 1)
    path = str(tmp_path / "jax.ckpt")
    jsave_model(path, 5, params, batch_stats, opt_state)
    model = create_model(cfg, "cpu")
    optimizer = make_optimizer(cfg, model.parameters())
    out = load_model(path, model, optimizer, verbose=False)
    assert out["epoch"] == 5 and out["steps"] == 7 and out["log"] == []
    got_p, got_b = params_to_jax(model)
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_b, batch_stats)
    _assert_trees_equal(optimizer_to_jax(model, optimizer, steps=7),
                        flax.serialization.to_state_dict(opt_state))


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_port_checkpoint_reads_in_jax(optim, ckpt, tmp_path):
    """The port's save_model payload read by JAX's load_model onto its
    templates: parameters, statistics and the optimizer state equal."""
    cfg, jcfg = _cfgs(optim)
    params, batch_stats = ckpt
    model = create_model(cfg, "cpu")
    model.load_state_dict(params_from_jax(params, batch_stats))
    optimizer = make_optimizer(cfg, model.parameters())
    seeded = flax.serialization.to_state_dict(
        _seeded_opt_state(jcfg, params, 2, count=11))
    optimizer_from_jax(model, optimizer, seeded)
    path = str(tmp_path / "port.ckpt")
    save_model(path, 3, model, optimizer, steps=11)
    loaded = jload_model(path, params, batch_stats,
                         jmake_optimizer(jcfg).init(params), verbose=False)
    assert loaded["epoch"] == 3
    _assert_trees_equal(loaded["params"], params_to_jax(model)[0])
    _assert_trees_equal(loaded["batch_stats"], params_to_jax(model)[1])
    _assert_trees_equal(flax.serialization.to_state_dict(
        loaded["opt_state"]), seeded)


def _tree(hm_classes=3, wh=True, conv_out=8):
    z = lambda *s: np.arange(np.prod(s), dtype=np.float32).reshape(s) / 7
    heads = {"hm": {"out": {"kernel": z(1, 1, 8, hm_classes),
                            "bias": z(hm_classes)}}}
    if wh:
        heads["wh"] = {"out": {"kernel": z(1, 1, 8, 2), "bias": z(2)}}
    return {"backbone": {"conv": {"kernel": z(3, 3, 4, conv_out),
                                  "bias": z(conv_out)},
                         "bn": {"scale": z(conv_out)}},
            "heads": heads}


def _neg(tree):
    return jax.tree.map(lambda a: -a - 1, tree)


MERGE_CASES = {
    "equal": (_tree(), _neg(_tree()), {}),
    "shape_mismatch_skipped": (_tree(), _neg(_tree(conv_out=6)), {}),
    "reuse_hm_80_to_3": (_tree(), _neg(_tree(hm_classes=80)),
                         dict(reuse_hm=True)),
    "reuse_hm_2_to_3": (_tree(), _neg(_tree(hm_classes=2)),
                        dict(reuse_hm=True)),
    "reset_hm_80": (_tree(), _neg(_tree(hm_classes=80)),
                    dict(reset_hm=True)),
    "reset_hm_1": (_tree(hm_classes=1), _neg(_tree(hm_classes=1)),
                   dict(reset_hm=True)),
    "reset_and_reuse_hm_1": (_tree(hm_classes=1), _neg(_tree(hm_classes=1)),
                             dict(reset_hm=True, reuse_hm=True)),
    "missing_leaves": (_tree(), _neg(_tree(wh=False)), {}),
    "dropped_leaves": (_tree(wh=False), _neg(_tree()), {}),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_tree_matches_jax(case):
    tmpl, loaded, kw = MERGE_CASES[case]
    log, jlog = [], []
    got = port_model._merge_tree(tmpl, loaded, kw.get("reset_hm", False),
                                 kw.get("reuse_hm", False), log)
    want = j_merge_tree(tmpl, loaded, kw.get("reset_hm", False),
                        kw.get("reuse_hm", False), jlog)
    _assert_trees_equal(got, want)
    assert log == jlog
    if case != "equal":
        assert log


def test_load_model_with_reset_hm_keeps_the_hm_head(ckpt, tmp_path,
                                                    capsys):
    """A 1-class hm head in the file, reset_hm: the model keeps its own
    hm head and prints JAX's lines for it; everything else is loaded."""
    cfg, _ = _cfgs()
    model = create_model(cfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = load_model(CKPT, model, reset_hm=True)
    printed = capsys.readouterr().out.splitlines()
    assert printed == out["log"] and out["log"]
    assert all(line.startswith("Skip loading parameter heads/hm/")
               for line in out["log"])
    want = params_from_jax(*ckpt)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        ref = before[k] if k.startswith("heads.hm.") and k.endswith(
            ("out.weight", "out.bias")) else want[k]
        assert torch.equal(v, ref), k


def test_load_backbone_keeps_the_fresh_heads(ckpt, tmp_path):
    cfg, _ = _cfgs()
    params, batch_stats = ckpt
    path = str(tmp_path / "backbone.ckpt")
    jsave_model(path, 0, {"backbone": params["backbone"]},
                {"backbone": batch_stats["backbone"]})
    model = create_model(cfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_backbone(path, model)
    want = params_from_jax(params, batch_stats)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, want[k] if k.startswith("backbone.")
                           else before[k]), k


def _small_model(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), BatchNorm(4))
    with torch.no_grad():
        model[1].running_mean.normal_()
    return model


def test_checkpoint_manager_keeps_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    models = {}
    for step in range(1, 5):
        models[step] = _small_model(step)
        opt = torch.optim.Adam(models[step].parameters(), lr=1e-3)
        models[step](torch.randn(1, 3, 5, 5)).sum().backward()
        opt.step()
        mgr.save(step, models[step], opt)
    mgr.close()
    # a write cut short leaves only its temporary file
    with open(mgr.path(9) + ".tmp123", "wb") as f:
        f.write(b"cut")
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(mgr.directory)) == [
        "step_3.ckpt", "step_4.ckpt", "step_9.ckpt.tmp123"]
    fresh = _small_model(0)
    opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    step, out = CheckpointManager(mgr.directory).restore(model=fresh,
                                                          optimizer=opt)
    assert step == 4 and out["epoch"] == 4 and out["steps"] == 1
    for k, v in models[4].state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k
    assert all(float(s["step"]) == 1.0 for s in opt.state.values())
    step, payload = mgr.restore(3)
    assert step == 3 and set(payload) == {"epoch", "params", "batch_stats",
                                          "opt_state"}
    # JAX's load_model reads the manager's files
    assert jload_model(mgr.path(3), verbose=False)["epoch"] == 3


@pytest.fixture(scope="module")
def resume_batches(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume"))
    ann, img_dir = selftest.make_dataset(root, num_videos=1, frames=6,
                                         width=96, height=64, seed=3)
    cfg = selftest.build_cfg(ann, img_dir, dla_node="dcn", batch_size=2,
                             input_h=64, input_w=96)
    batches = list(DataLoader(CustomDataset(cfg, "train"), 2, shuffle=True,
                              num_workers=2, seed=1))
    return cfg, batches


def _assert_states_equal(a, b):
    for k, v in a.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(b.model.state_dict()[k], v), k


def test_resume_is_bit_for_bit(resume_batches, tmp_path):
    """DLA-34 (dcn) at 64x96, B=2, batches from the port's pipeline: two
    steps, saved through CheckpointManager, a fresh model and Trainer
    resumed from the manager (the selftest's call), a third step: every
    parameter, statistic and Adam moment equal bit for bit to three
    uninterrupted steps."""
    cfg, batches = resume_batches
    assert len(batches) == 3
    straight = Trainer(cfg, create_model(cfg, "cpu"), "cpu")
    cut = Trainer(cfg, create_model(cfg, "cpu"), "cpu")
    for b in batches[:2]:
        straight.train_step(b, 5e-4)
        cut.train_step(b, 5e-4)
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    manager.save(2, cut.model, cut.optimizer, cut.steps)
    other = dict(cfg.__dict__, seed=cfg.seed + 1)
    resumed = Trainer(cfg, create_model(Config(**other), "cpu"), "cpu")
    assert resumed.resume(manager) == 2 and resumed.steps == 2
    manager.close()
    straight.train_step(batches[2], 5e-4)
    resumed.train_step(batches[2], 5e-4)
    _assert_states_equal(straight, resumed)
    for p, q in zip(straight.model.parameters(), resumed.model.parameters()):
        s, r = straight.optimizer.state[p], resumed.optimizer.state[q]
        if not s:   # never had a gradient (DLA's unused projections)
            assert not r["exp_avg"].any() and not r["exp_avg_sq"].any()
            continue
        assert float(s["step"]) == float(r["step"]) == 3.0
        assert torch.equal(s["exp_avg"], r["exp_avg"])
        assert torch.equal(s["exp_avg_sq"], r["exp_avg_sq"])


def test_trainer_start_and_fit_follow_the_cfg(resume_batches, tmp_path):
    """fit with a save_dir writes model_last.ckpt each epoch (optimizer
    state included) and model_<e>.ckpt at cfg.save_point (without);
    start resumes from model_last with cfg.resume, from cfg.load_model,
    or merges cfg.load_backbone onto the fresh init; resume applies
    cfg.reset_hm."""
    cfg, batches = resume_batches
    with_cfg = lambda **kw: Config(**dict(cfg.__dict__, **kw))
    save_dir = str(tmp_path / "exp")
    trained = Trainer(with_cfg(save_point=(1,), num_epochs=2),
                      create_model(cfg, "cpu"), "cpu")
    assert trained.start(save_dir) == 0
    trained.fit(batches[:1], start_epoch=0, log_every=0, save_dir=save_dir)
    assert sorted(os.listdir(save_dir)) == ["model_1.ckpt",
                                            "model_last.ckpt"]
    last = load_model(os.path.join(save_dir, "model_last.ckpt"))
    assert last["epoch"] == 2 and "opt_state" in last
    first = load_model(os.path.join(save_dir, "model_1.ckpt"))
    assert first["epoch"] == 1 and "opt_state" not in first

    fresh = lambda c: Trainer(c, create_model(with_cfg(seed=cfg.seed + 1),
                                              "cpu"), "cpu")
    resumed = fresh(with_cfg(resume=True))
    assert resumed.start(save_dir) == 2 and resumed.steps == 2
    _assert_states_equal(trained, resumed)
    loaded = fresh(with_cfg(load_model=os.path.join(save_dir,
                                                    "model_1.ckpt")))
    assert loaded.start() == 1 and loaded.steps == 0

    params, batch_stats = params_to_jax(trained.model)
    backbone = str(tmp_path / "backbone.ckpt")
    write_payload(backbone, {"epoch": 0,
                             "params": {"backbone": params["backbone"]},
                             "batch_stats": {"backbone":
                                             batch_stats["backbone"]}})
    pre = fresh(with_cfg(load_backbone=backbone))
    init = {k: v.clone() for k, v in pre.model.state_dict().items()}
    assert pre.start() == 0 and pre.steps == 0
    for k, v in pre.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            ref = trained.model.state_dict()[k] if k.startswith(
                "backbone.") else init[k]
            assert torch.equal(v, ref), k

    reset = fresh(with_cfg(reset_hm=True))
    init = {k: v.clone() for k, v in reset.model.state_dict().items()}
    assert reset.resume(os.path.join(save_dir, "model_last.ckpt")) == 2
    for k, v in reset.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        hm_out = k.startswith("heads.hm.") and k.endswith(("out.weight",
                                                           "out.bias"))
        ref = init[k] if hm_out else trained.model.state_dict()[k]
        assert torch.equal(v, ref), k


def test_fused_detector_without_params(ckpt, tmp_path):
    """No params: cfg.load_model's checkpoint, merged onto the init, gives
    the same rows as the same weights passed in; without load_model the
    net keeps create_model's initialisation."""
    cfg, _ = _cfgs()
    frame = np.random.RandomState(0).randint(0, 256, (96, 160, 3)).astype(
        np.uint8)
    ref = FusedDetector(cfg, *ckpt, Meta, device="cpu")
    det = FusedDetector(Config(**dict(cfg.__dict__, load_model=CKPT)),
                        dataset_meta=Meta, device="cpu")
    assert torch.equal(det.run(frame), ref.run(frame))
    fresh = FusedDetector(cfg, dataset_meta=Meta, device="cpu")
    init = create_model(cfg, "cpu").state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, init[k]), k
