"""Checkpoint manager of a training run (JAX: engine/checkpoint.py,
which wraps orbax's; reference: src/lib/model/model.py:92-101).

The card's machine has no orbax, so each step's checkpoint is one file,
``step_<N>.ckpt`` in ``directory``, holding ``models.model.save_model``'s
payload ({epoch: N, params, batch_stats, opt_state} in JAX's layout,
readable by JAX's ``load_model``). This manager does not read orbax's
checkpoint directories that JAX's ``CheckpointManager`` writes.

A save takes the model's and the optimizer's state on the caller's
thread (host copies), then writes on a writer thread: a temporary file,
then ``os.replace``, so a file is whole or absent and a write cut short
leaves only a temporary file, which is ignored. After each write the
oldest files past ``max_to_keep`` are removed. ``close`` (and ``save``
with ``wait=True``) waits for the writes.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from centertrack_tpu_torch.models.model import (load_model, model_payload,
                                                write_payload)

_NAME = re.compile(r"^step_(\d+)\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(1)
        self._pending = []

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.ckpt")

    def all_steps(self) -> List[int]:
        """The steps with a whole checkpoint on disk, in order."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write(self, step: int, payload) -> None:
        write_payload(self.path(step), payload)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def save(self, step: int, model, optimizer=None, steps: int = 0,
             wait: bool = False) -> None:
        """Checkpoint ``model`` (and ``optimizer``; ``steps``: SGD's step
        count) as step ``step``."""
        payload = model_payload(step, model, optimizer, steps)
        self._pending.append(self._writer.submit(self._write, step,
                                                 payload))
        if wait:
            self.wait_until_finished()

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def restore(self, step: Optional[int] = None, model=None,
                optimizer=None, reset_hm: bool = False,
                reuse_hm: bool = False):
        """None without a checkpoint; else (step, x): with ``model``, x is
        ``load_model``'s result after loading the checkpoint into
        ``model`` (and ``optimizer``), else the raw payload. ``step``
        defaults to the latest."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return step, load_model(self.path(step), model, optimizer,
                                reset_hm=reset_hm, reuse_hm=reuse_hm,
                                verbose=False)

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown(wait=True)
