"""The port's CLI (centertrack_tpu_torch/cli: opts, main, test), its
Logger and tools/convert_mot_det_to_results against the JAX package's on
the CPU.

cli.main trains DLA-34 (dcn_local1, 96x160, B=2) on a JPEG clip of the
port's selftest generator with --device cpu for 2 epochs of one
iteration from the committed checkpoint (written as an epoch-0 file),
then --resume trains a third; the run writes JAX's layout
(exp/<task>/<exp_id>/ with opt.txt, logs_*/log.txt, model_last.ckpt and
model_<epoch>.ckpt) and JAX's models/model.load_model reads its
model_last.ckpt. Then cli.test of the port and of JAX with the same
--load_model --save_results: the two saved JSONs must cover the same
images with the same track ids, boxes within 1e-3 px and scores within
1e-4.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from centertrack_tpu.cli import opts as jopts
from centertrack_tpu.cli import test as jtest
from centertrack_tpu.models.model import load_model as jload_model
from centertrack_tpu.tools import convert_mot_det_to_results as jconvert
from centertrack_tpu.utils.logger import AverageMeter as JAverageMeter
from centertrack_tpu_torch.cli import main as cli_main
from centertrack_tpu_torch.cli import opts
from centertrack_tpu_torch.cli import test as cli_test
from centertrack_tpu_torch.config import Config, finalize
from centertrack_tpu_torch.models.model import (create_model, load_model,
                                                save_model)
from centertrack_tpu_torch.tools import convert_mot_det_to_results as convert
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils.logger import AverageMeter, Logger

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")


def _argv(ann, img_dir):
    return ["tracking", "--dataset", "custom",
            "--custom_dataset_ann_path", ann,
            "--custom_dataset_img_path", img_dir, "--num_classes", "1",
            "--input_h", "96", "--input_w", "160",
            "--dla_node", "dcn_local1", "--batch_size", "2",
            "--num_workers", "1", "--pre_hm", "--same_aug_pre",
            "--not_rand_crop", "--flip", "0", "--track_thresh", "0.3",
            "--exp_id", "e2e"]


@pytest.fixture(scope="module")
def domain(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    ann, img_dir = selftest.make_dataset(os.path.join(root, "data"),
                                         num_videos=2, frames=4, seed=3,
                                         hard=True)
    # the committed weights as an epoch-0 checkpoint: training starts at
    # the epoch a loaded checkpoint saved, as in JAX's cli.main
    cfg = finalize(Config(task="tracking", dataset="custom", num_classes=1,
                          input_h=96, input_w=160, pre_hm=True,
                          dla_node="dcn_local1",
                          custom_dataset_ann_path=ann,
                          custom_dataset_img_path=img_dir))
    model = create_model(cfg, "cpu")
    load_model(CKPT, model, verbose=False)
    start = os.path.join(root, "start.ckpt")
    save_model(start, 0, model)
    return root, ann, img_dir, start


def test_cli_train_resume_test_against_jax(domain, monkeypatch):
    root, ann, img_dir, start = domain
    monkeypatch.chdir(root)
    argv = _argv(ann, img_dir)
    train = argv + ["--device", "cpu", "--num_iters", "1",
                    "--val_intervals", "1"]
    cli_main.main(train + ["--num_epochs", "2", "--load_model", start])
    save_dir = os.path.join(root, "exp", "tracking", "e2e")
    last = os.path.join(save_dir, "model_last.ckpt")
    for name in ("model_last.ckpt", "model_1.ckpt", "model_2.ckpt",
                 "opt.txt"):
        assert os.path.exists(os.path.join(save_dir, name)), name
    logs = glob.glob(os.path.join(save_dir, "logs_*", "log.txt"))
    assert logs and "epoch: 2 |" in open(logs[0]).read()
    with open(os.path.join(save_dir, "opt.txt")) as f:
        assert f"torch version: {torch.__version__}" in f.read()
    ckpt2 = jload_model(last)
    assert ckpt2["epoch"] == 2 and ckpt2.get("opt_state") is not None

    # --resume: model_last.ckpt, one more epoch
    cli_main.main(train + ["--num_epochs", "3", "--resume"])
    ckpt3 = jload_model(last)        # JAX reads the port's file
    assert ckpt3["epoch"] == 3
    l2 = jload_model(os.path.join(save_dir, "model_2.ckpt"))["params"]
    moved = [not np.array_equal(a, b) for a, b in zip(
        _leaves(l2), _leaves(ckpt3["params"]))]
    assert any(moved)

    # cli.test of both packages on the same checkpoint
    test_argv = argv + ["--load_model", last, "--save_results"]
    saved = os.path.join(save_dir, "save_results_custom.json")
    cli_test.main(test_argv + ["--device", "cpu"])
    with open(saved) as f:
        got = json.load(f)
    os.remove(saved)
    jtest.main(test_argv)
    with open(saved) as f:
        want = json.load(f)
    with open(ann) as f:
        n_images = len(json.load(f)["images"])
    assert sorted(got) == sorted(want) and len(got) == n_images
    tracks = 0
    for img_id in want:
        g, w = got[img_id], want[img_id]
        assert [d["tracking_id"] for d in g] == [d["tracking_id"] for d in w]
        for a, b in zip(g, w):
            assert a["active"] == b["active"]
            assert abs(a["score"] - b["score"]) <= 1e-4
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-3)
            tracks += a["active"] > 0
    assert tracks > 0


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)


def test_every_jax_flag_parses():
    jparser, parser = jopts.build_parser(), opts.build_parser()
    want = {o for a in jparser._actions for o in a.option_strings}
    have = {o for a in parser._actions for o in a.option_strings}
    assert want <= have and have - want == {"--device"}
    # each JAX flag at JAX's default gives the same config
    jargs = jparser.parse_args(["tracking"])
    argv = ["tracking"]
    for a in jparser._actions:
        if not a.option_strings or a.dest == "help" or a.default is None:
            continue
        if a.nargs == 0:
            continue
        argv += [a.option_strings[0], str(a.default)]
    args = parser.parse_args(argv)
    cfg = opts.args_to_config(args)
    jcfg = jopts.args_to_config(jargs)
    for name in (f for f in Config.__dataclass_fields__):
        assert getattr(cfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("flag,value,item", [
    ("--num_devices", "2", "A10"), ("--hp_weight", "2.0", "A9"),
    ("--velocity", None, "A9"), ("--grad_checkpoint", None, "A11"),
    ("--vis_thresh", "0.5", "A11"), ("--backbone", "resnet", "A13"),
    ("--reg_loss", "sl1", "A14"), ("--custom_input_h", "64", "A14")])
def test_unported_flag_raises_naming_its_item(flag, value, item):
    """A flag of an item not ported raises naming it. A9's flags are
    ported (the ddd and pose tasks): they parse into the port's Config
    as into JAX's, with their help."""
    argv = ["tracking", flag] + ([value] if value else [])
    if item == "A9":
        cfg, _ = opts.parse(argv)
        jcfg, _ = jopts.parse(argv)
        name = flag[2:]
        assert getattr(cfg, name) == getattr(jcfg, name) != getattr(
            Config(), name)
        action, = [a for a in opts.build_parser()._actions
                   if a.dest == name]
        assert action.help == opts.HELP[name]
    else:
        with pytest.raises(NotImplementedError, match=item):
            opts.parse(argv)
    # JAX's parser takes the same flag
    jopts.build_parser().parse_args(argv)


def test_resume_and_ignored_flags():
    cfg, args = opts.parse(["tracking", "--dataset", "mot", "--resume",
                            "--exp_id", "x", "--local_impl", "taploop"])
    assert cfg.load_model == os.path.join("exp", "tracking", "x",
                                          "model_last.ckpt")
    assert args.device == "cuda"
    cfg, _ = opts.parse(["tracking", "--dataset", "mot", "--resume",
                         "--load_model", "a.ckpt"])
    assert cfg.load_model == "a.ckpt"
    jcfg, _ = jopts.parse(["tracking", "--dataset", "mot", "--keep_res",
                           "--input_res", "512", "--test_scales", "1.0"])
    cfg, _ = opts.parse(["tracking", "--dataset", "mot", "--keep_res",
                         "--input_res", "512", "--test_scales", "1.0"])
    for name in ("fix_res", "input_h", "input_w", "input_res", "pad",
                 "test_scales", "test_dataset"):
        assert getattr(cfg, name) == getattr(jcfg, name), name


def test_cli_without_gpu_raises(domain, monkeypatch):
    """Without --device cpu both entry points ask for the card, and raise
    where there is none."""
    root, ann, img_dir, start = domain
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        cli_test.main(_argv(ann, img_dir) + ["--load_model", start])
    with pytest.raises(RuntimeError, match="no GPU"):
        cli_main.main(_argv(ann, img_dir) + ["--num_epochs", "1"])


def test_convert_mot_det_to_results_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    images, videos = [], []
    for v, seq in enumerate(("SEQ-01", "SEQ-02")):
        videos.append({"id": v + 1, "file_name": seq})
        for f in range(1, 5):
            images.append({"id": 10 * v + f, "video_id": v + 1,
                           "frame_id": f, "file_name": f"{seq}/{f}.jpg"})
        os.makedirs(tmp_path / seq / "det")
        rows = [[f, -1, *rng.uniform(0, 500, 2), *rng.uniform(10, 90, 2),
                 rng.rand(), -1, -1, -1] for f in range(1, 7)
                for _ in range(3)]
        np.savetxt(tmp_path / seq / "det" / "det_val_half.txt", rows,
                   delimiter=",", fmt="%.3f")
    ann = tmp_path / "val_half.json"
    ann.write_text(json.dumps({"images": images, "videos": videos,
                               "annotations": [], "categories": []}))
    args = ["--ann_path", str(ann), "--data_path", str(tmp_path),
            "--split", "val_half"]
    convert.main(args + ["--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["convert"] + args + [
        "--out", str(tmp_path / "jax.json")])
    jconvert.main()
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads((tmp_path / "jax.json").read_text())
    assert sum(len(v) for v in got.values()) == 2 * 4 * 3


def test_logger_and_meter_match_jax(tmp_path):
    meter, jmeter = AverageMeter(), JAverageMeter()
    for v, n in ((1.5, 2), (0.25, 3), (4.0, 1)):
        meter.update(v, n)
        jmeter.update(v, n)
    assert (meter.val, meter.sum, meter.count, meter.avg) == (
        jmeter.val, jmeter.sum, jmeter.count, jmeter.avg)
    logger = Logger(Config(task="tracking"), str(tmp_path))
    logger.write("epoch: 1 | tot 1.0 |")
    logger.scalar_summary("train_tot", 1.0, 1)
    logger.close()
    text = open(glob.glob(str(tmp_path / "logs_*" / "log.txt"))[0]).read()
    assert text.endswith("epoch: 1 | tot 1.0 |\n")
    assert "  dla_node: dcn" in (tmp_path / "opt.txt").read_text()


def test_group_videos_and_results_io_match_jax(domain, tmp_path):
    """cli.test's helpers against JAX's: --multi_stream's split of the
    split's images into videos by resolution, the saved results' JSON
    form, and load_external_results."""
    from centertrack_tpu.config import Config as JConfig
    from centertrack_tpu.config import finalize as jfinalize
    from centertrack_tpu.data.datasets import get_dataset as jget_dataset
    from centertrack_tpu_torch.data.datasets import get_dataset

    _, ann, img_dir, _ = domain
    kw = dict(task="tracking", dataset="custom", num_classes=1, input_h=96,
              input_w=160, custom_dataset_ann_path=ann,
              custom_dataset_img_path=img_dir)
    cfg = finalize(Config(**kw), get_dataset("custom"))
    jcfg = jfinalize(JConfig(**kw), jget_dataset("custom"))
    got = cli_test._group_videos(cfg, get_dataset("custom")(cfg, "val"))
    want = jtest._group_videos(jcfg, jget_dataset("custom")(jcfg, "val"))
    strip = lambda by: {k: [[(i, os.path.basename(p)) for i, p, _ in v]
                            for v in vids] for k, vids in by.items()}
    assert strip(got) == strip(want) and len(got[(96, 160)]) == 2
    row = {"score": np.float32(0.5), "class": 1, "tracking_id": np.int64(3),
           "bbox": np.float32([1, 2, 3, 4]), "ct": [2.0, 3.0]}
    assert cli_test._jsonable(row) == jtest._jsonable(row)
    path = tmp_path / "dets.json"
    path.write_text(json.dumps({"7": [cli_test._jsonable(row)]}))
    assert cli_test.load_external_results(str(path), None) == \
        jtest.load_external_results(str(path), None)
