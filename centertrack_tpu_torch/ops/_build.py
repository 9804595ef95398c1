"""Build the port's CUDA sources with plain ``nvcc``, and its host C
source with the host compiler, and load them with ``ctypes``.

Each CUDA source in ``centertrack_tpu_torch/csrc`` exposes a plain
``extern "C"`` launcher. At first use it is compiled for ``sm_90a`` into
``<repo>/build/torch_kernels/<name>-<hash>.so``, keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, written under
a temporary name and moved into place, so concurrent builds never see a
half-written library. The compile runs under a timeout; a later process
finds the library and loads it without compiling. The host source
(``csrc/image_codec.c``, the JPEG and PNG codec) is built the same way
by ``cc -O2 -shared -fPIC`` (``build_host``, ``load_host``), here and on
the card's machine alike; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_CC_FLAGS = ["-O2", "-shared", "-fPIC"]
BUILD_TIMEOUT_S = 300

_libs: Dict[str, ctypes.CDLL] = {}
# one build and load at a time within a process (the loader's threads
# reach the codec at once)
_lock = threading.Lock()
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


def _compile(name: str, out: str, tool: str,
             command: Callable[[str], List[str]]) -> str:
    """Unless ``out`` exists, run ``command(tmp)`` (a compile writing the
    library to ``tmp``, a temporary name) and move its result to ``out``;
    raise with the compiler's output if it fails."""
    if os.path.exists(out):
        build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return out
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = command(tmp)    # finds the compiler, or raises
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{tool} failed on {name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; return its path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    return _compile(name, library_path(name), "nvcc", lambda tmp: [
        find_nvcc(), *NVCC_FLAGS, "-o", tmp, src])


def find_cc() -> str:
    """The host C compiler: $CC, else cc or gcc on PATH, else raise."""
    for candidate in (os.environ.get("CC"), "cc", "gcc"):
        found = candidate and shutil.which(candidate)
        if found:
            return found
    raise RuntimeError("no host C compiler (looked for $CC, cc and gcc on "
                       "PATH): the port's image codec is built with one")


def host_library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".c"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(HOST_CC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-host-{digest.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """Compile the host source csrc/<name>.c unless its library exists;
    return its path."""
    src = os.path.join(CSRC_DIR, name + ".c")
    return _compile(name, host_library_path(name), "cc", lambda tmp: [
        find_cc(), *HOST_CC_FLAGS, "-o", tmp, src])


def _load(key: str, build_library: Callable[[], str]) -> ctypes.CDLL:
    lib = _libs.get(key)
    if lib is None:
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                lib = ctypes.CDLL(build_library())
                _libs[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    return _load(name, lambda: build(name))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source csrc/<name>.c, built at first
    use. Its functions release the GIL while they run (``ctypes.CDLL``)."""
    return _load(name + ".c", lambda: build_host(name))


_symbols: Dict[str, object] = {}


def launcher(name: str, symbol: str, n_ptr: int, n_int: int):
    """The extern "C" launcher ``symbol`` of csrc/<name>.cu (its library
    built at first use) as a ctypes function of ``n_ptr`` pointers,
    ``n_int`` ints and the stream, returning its CUDA error code."""
    fn = _symbols.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _symbols[symbol] = fn
    return fn
