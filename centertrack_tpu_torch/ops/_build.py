"""Build the port's CUDA sources with plain ``nvcc`` and load them with
``ctypes``.

Each source in ``centertrack_tpu_torch/csrc`` exposes a plain
``extern "C"`` launcher. At first use it is compiled for ``sm_90a`` into
``<repo>/build/torch_kernels/<name>-<hash>.so``, keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, written under
a temporary name and moved into place, so concurrent builds never see a
half-written library. The compile runs under a timeout; a later process
finds the library and loads it without compiling.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 300

_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": compile seconds (0 when cached), "log": nvcc output}
build_info: Dict[str, dict] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda/bin or PATH, else raise."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built with the CUDA toolkit")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    for header in sorted(os.listdir(CSRC_DIR)):
        if header.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, header), "rb") as f:
                digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; return its path."""
    out = library_path(name)
    if os.path.exists(out):
        build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _libs[name] = lib
    return lib
