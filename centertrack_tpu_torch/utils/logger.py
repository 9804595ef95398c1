"""Experiment logging (reference: src/lib/logger.py; JAX:
centertrack_tpu/utils/logger.py).

Writes opt.txt (the full config, the commit, the torch version and the
device), a timestamped logs_<time>/log.txt, and tensorboardX scalars when
tensorboardX is installed.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time

import torch

try:
    from tensorboardX import SummaryWriter
    HAS_TB = True
except Exception:
    HAS_TB = False


class Logger:
    def __init__(self, cfg, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        time_str = time.strftime("%Y-%m-%d-%H-%M")

        # opt.txt: full config + git hash + library versions
        # (reference: logger.py:28-41)
        with open(os.path.join(save_dir, "opt.txt"), "w") as f:
            f.write("==> commit hash: {}\n".format(self._git_hash()))
            f.write(f"==> torch version: {torch.__version__} "
                    f"(CUDA {torch.version.cuda})\n")
            f.write(f"==> devices: {self._devices_safe()}\n\n")
            f.write("==> Config:\n")
            for field in dataclasses.fields(cfg):
                f.write(f"  {field.name}: {getattr(cfg, field.name)}\n")

        log_dir = os.path.join(save_dir, f"logs_{time_str}")
        os.makedirs(log_dir, exist_ok=True)
        self.log = open(os.path.join(log_dir, "log.txt"), "w")
        self.start_line = True
        self.writer = SummaryWriter(log_dir=log_dir) if HAS_TB else None

    @staticmethod
    def _git_hash():
        try:
            return subprocess.check_output(
                ["git", "rev-parse", "HEAD"],
                stderr=subprocess.DEVNULL).decode().strip()
        except Exception:
            return "unknown"

    @staticmethod
    def _devices_safe():
        try:
            if torch.cuda.is_available():
                return ", ".join(torch.cuda.get_device_name(i)
                                 for i in range(torch.cuda.device_count()))
            return "cpu"
        except Exception:
            return "unavailable"

    def write(self, txt: str) -> None:
        if self.start_line:
            time_str = time.strftime("%Y-%m-%d-%H-%M")
            self.log.write(f"{time_str}: {txt}")
        else:
            self.log.write(txt)
        self.start_line = False
        if "\n" in txt:
            self.start_line = True
            self.log.flush()
        if not txt.endswith("\n"):
            self.log.write("\n")
            self.start_line = True
            self.log.flush()

    def scalar_summary(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def close(self) -> None:
        self.log.close()
        if self.writer is not None:
            self.writer.close()


class AverageMeter:
    """(reference: src/lib/utils/utils.py:7-23)"""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        if self.count > 0:
            self.avg = self.sum / self.count
