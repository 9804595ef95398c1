"""Read checkpoints in the JAX package's format (``assets/*.ckpt``;
JAX: models/model.py load_model); ``models.model.save_model`` writes
them.

Each file is a plain pickle of ``{"epoch", "params", "batch_stats"}``
and, for a resume, ``"opt_state"``: nested dicts of numpy arrays
(float16 in the committed files, float32 in the ones
``models.model.save_model`` writes). Files written by
numpy 2.x name ``numpy._core.multiarray``, which numpy 1.x spells
``numpy.core.multiarray``; the unpickler below maps between the two so
either numpy reads either file, reads a pickled ``jax.Array`` as the
numpy array it holds, and refuses any other global outside numpy.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np


def _jax_array_as_numpy(fun, args, arr_state, aval_state):
    """The numpy value of a pickled ``jax.Array`` (what JAX's
    ``_reconstruct_array`` builds before it puts it on a device): JAX's
    save_model pickles the optimizer state as jax Arrays."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _jax_array_as_numpy
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


def read_payload(path: str) -> Dict:
    """The checkpoint's payload dict as it was written."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def load_jax_ckpt(path: str) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a JAX checkpoint as float32 numpy trees."""
    payload = read_payload(path)
    return _to_fp32(payload["params"]), _to_fp32(payload["batch_stats"])

