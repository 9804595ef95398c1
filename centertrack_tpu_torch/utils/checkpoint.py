"""Read the JAX package's committed checkpoints (``assets/*.ckpt``).

Each file is a plain pickle of ``{"epoch", "params", "batch_stats"}``,
nested dicts of numpy arrays stored in float16. Files written by
numpy 2.x name ``numpy._core.multiarray``, which numpy 1.x spells
``numpy.core.multiarray``; the unpickler below maps between the two so
either numpy reads either file, and it refuses any global outside numpy.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("numpy._core") or module.startswith(
                "numpy.core"):
            try:
                return super().find_class(module, name)
            except (ModuleNotFoundError, AttributeError):
                if module.startswith("numpy._core"):
                    alt = "numpy.core" + module[len("numpy._core"):]
                else:
                    alt = "numpy._core" + module[len("numpy.core"):]
                return super().find_class(alt, name)
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}, not a numpy type")


def _to_fp32(tree):
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype == np.float16 else a


def load_jax_ckpt(path: str) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a JAX checkpoint as float32 numpy trees."""
    with open(path, "rb") as f:
        payload = _NumpyUnpickler(f).load()
    return _to_fp32(payload["params"]), _to_fp32(payload["batch_stats"])
