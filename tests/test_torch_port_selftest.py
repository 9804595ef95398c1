"""The port's selftest (centertrack_tpu_torch.tools.selftest) against
the JAX package's on the CPU: the dataset it writes, its drawing, its
CLEAR-MOT evaluation of a tracked video, and its main end to end.

Tolerances: annotations equal exactly (file names but for the
extension); drawn pixels equal exactly to cv2's drawing of the same
objects (0 circle-edge pixels allowed to differ); MOTA counts equal.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from centertrack_tpu.tools import selftest as jselftest
from centertrack_tpu_torch.models.model import load_model
from centertrack_tpu_torch.tools import selftest
from centertrack_tpu_torch.utils import image_io
from centertrack_tpu_torch.utils.checkpoint import load_jax_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "assets", "selftest_local1_fp16.ckpt")
# circle-edge pixels allowed to differ from cv2.circle's
CIRCLE_EDGE_PIXELS = 0


@pytest.mark.parametrize("hard", [True, False])
def test_make_dataset_equals_jax(hard, tmp_path, monkeypatch):
    """The port's PNG dataset against JAX's: the annotations equal but for
    '.png' in place of '.jpg', and every image equal to the array JAX
    handed cv2.imwrite (before its JPEG encoding)."""
    drawn = {}

    def capture(path, img):
        drawn[os.path.basename(path)] = img.copy()
        return True
    monkeypatch.setattr(jselftest.cv2, "imwrite", capture)
    jann, _ = jselftest.make_dataset(str(tmp_path / "jax"), hard=hard)
    monkeypatch.undo()
    ann, img_dir = selftest.make_dataset(str(tmp_path / "port"), hard=hard)
    with open(ann) as f:
        got = json.load(f)
    with open(jann) as f:
        want = json.load(f)
    for im in want["images"]:
        assert im["file_name"].endswith(".jpg")
        im["file_name"] = im["file_name"][:-4] + ".png"
    assert got == want
    assert len(drawn) == len(got["images"]) == 144
    differ = 0
    for im in got["images"]:
        ours = image_io.read(os.path.join(img_dir, im["file_name"]))
        differ += int((ours != drawn[im["file_name"][:-4] + ".jpg"]).any(
            axis=2).sum())
    assert differ <= CIRCLE_EDGE_PIXELS


def test_drawing_matches_cv2():
    """Filled rectangles and circles at random places, partly or wholly
    outside the image, against cv2.rectangle / cv2.circle."""
    rng = np.random.RandomState(0)
    for _ in range(1500):
        h, w = rng.randint(5, 40, 2)
        ours = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ref = ours.copy()
        c = (int(rng.randint(-5, w + 5)), int(rng.randint(-5, h + 5)))
        r = int(rng.randint(0, 12))
        selftest.draw_circle(ours, c, r, (255, 255, 255))
        cv2.circle(ref, c, r, (255, 255, 255), -1)
        x1, y1 = int(rng.randint(-5, w + 5)), int(rng.randint(-5, h + 5))
        x2, y2 = x1 + int(rng.randint(-3, 20)), y1 + int(rng.randint(-3, 20))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        selftest.draw_rectangle(ours, (x1, y1), (x2, y2), color)
        cv2.rectangle(ref, (x1, y1), (x2, y2), color, -1)
        np.testing.assert_array_equal(ours, ref)


COUNTS = ("num_objects", "num_matches", "num_false_positives", "num_misses",
          "num_switches", "mota")


def test_evaluate_matches_jax(tmp_path):
    """One 6-frame video of the selftest domain at 96x160 (the committed
    local1 checkpoint's training size), PNG frames read by both: the
    port's evaluate (FusedDetector) against JAX's (its host Detector),
    equal CLEAR-MOT counts. JAX's device tracker keeps an aged copy of a
    track matched from slot 0 (ROADMAP C3), but evaluate scores active
    tracks only, so the copy never counts."""
    ann, img_dir = selftest.make_dataset(str(tmp_path), num_videos=1,
                                         frames=6, seed=1)
    params, batch_stats = load_jax_ckpt(CKPT)
    cfg = selftest.build_cfg(ann, img_dir, dla_node="dcn_local1")
    jcfg = jselftest.build_cfg(ann, img_dir, dla_node="dcn_local1")
    got = selftest.evaluate(cfg, params, batch_stats, ann, img_dir,
                            device="cpu")
    want = jselftest.evaluate(jcfg, params, batch_stats, ann, img_dir)
    for k in COUNTS:
        assert got[k] == want[k], k
    assert got["num_objects"] >= 12 and got["num_matches"] > 0


@pytest.mark.parametrize("args", [["--epochs", "1"],
                                  ["--epochs", "2", "--resume_at", "1"]])
def test_main_runs_end_to_end(args, tmp_path):
    """main on a one-video dataset on the CPU: trains (and, with
    --resume_at, saves through CheckpointManager and resumes), saves the
    checkpoint, tracks and scores."""
    path = str(tmp_path / "out.ckpt")
    overall = selftest.main(args + [
        "--num_videos", "1", "--frames", "4", "--batch_size", "2",
        "--dla_node", "dcn_local1", "--device", "cpu", "--num_workers", "2",
        "--root", str(tmp_path / "data"), "--save_ckpt", path])
    assert overall["num_objects"] > 0 and np.isfinite(overall["mota"])
    assert load_model(path)["epoch"] == int(args[1])
    if "--resume_at" in args:
        assert os.listdir(tmp_path / "data" / "ckpt") == ["step_1.ckpt"]


@pytest.mark.parametrize("workers,processes", [(2, False), (3, True)])
def test_train_builds_its_loader_from_the_cfg(workers, processes, tmp_path,
                                              monkeypatch):
    """train's DataLoader takes cfg.num_workers and cfg.process_workers
    (recorded, then the run is stopped before its first step)."""
    from centertrack_tpu_torch.data import loader

    ann, img_dir = selftest.make_dataset(str(tmp_path), num_videos=1,
                                         frames=4)
    cfg = selftest.build_cfg(ann, img_dir, dla_node="dcn_local1",
                             batch_size=2, num_workers=workers,
                             process_workers=processes)
    seen = {}

    class Stop(Exception):
        pass

    def recording(dataset, batch_size, **kw):
        seen.update(kw, batch_size=batch_size)
        raise Stop

    monkeypatch.setattr(loader, "DataLoader", recording)
    with pytest.raises(Stop):
        selftest.train(cfg, device="cpu", ckpt_dir=str(tmp_path / "ckpt"))
    assert seen == {"batch_size": 2, "shuffle": True, "num_workers": workers,
                    "seed": cfg.seed, "use_processes": processes}

