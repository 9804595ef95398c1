"""The float32 path's precision, set by the package itself.

The port's float32 path is full float32: its kernels contract in
3xTF32 and are held to the plain float32 version, and the JAX package's
float32 reference runs full float32. PyTorch's defaults run cuDNN's
float32 convolutions in TF32 (about 2^-11 per product), so
``FusedDetector.run``, ``Trainer.train_step`` and ``Trainer.val_step``
run their float32 work under ``full_float32``, whatever the process-wide
flags say, and give the caller's flags back afterwards. There is no
option to turn TF32 on: the JAX package has none.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32(compute_dtype: str):
    """While active, and only when ``compute_dtype`` is "float32": cuDNN
    convolutions (and RNNs) and cuBLAS matmuls in full float32; the
    caller's settings come back on exit. At any other compute dtype
    nothing is touched.

    It sets torch's ``fp32_precision`` settings (torch 2.9 and later) to
    "ieee": ``torch.backends.cudnn.conv`` and ``.rnn`` both, after the
    legacy ``torch.backends.cudnn.allow_tf32 = False`` (the legacy flag
    is held against both: with any of them out of step, reading it
    raises), and ``torch.backends.cuda.matmul`` after
    ``torch.set_float32_matmul_precision("highest")`` (the legacy matmul
    setting, held against it likewise). A cuDNN convolution reads its
    op's own setting, the conv one. The legacy ``allow_tf32 = False``
    alone would not do: it writes "none", which inherits the parent
    setting (``torch.backends.fp32_precision``) and so leaves TF32 on
    where a caller set it there. Nor ``torch.backends.cudnn.flags``,
    whose ``enabled`` defaults to False and would turn cuDNN off.
    ``enabled``, ``benchmark`` and ``deterministic`` are not touched. The
    settings read back on exit are the effective ones (a "none" reads as
    what it inherits), so the caller gets the same effective precision
    back; a legacy setting that cannot be read (the caller mixed the two
    APIs and they disagree) is left as this sets it."""
    if compute_dtype != "float32":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    # set_float32_matmul_precision also writes the CPU's (mkldnn) matmul
    # setting, which is put back too
    cpu_matmul = torch.backends.mkldnn.matmul
    saved = (_legacy(lambda: cudnn.allow_tf32), cudnn.conv.fp32_precision,
             cudnn.rnn.fp32_precision, matmul.fp32_precision,
             _legacy(torch.get_float32_matmul_precision),
             cpu_matmul.fp32_precision)
    try:
        cudnn.allow_tf32 = False
        cudnn.conv.fp32_precision = "ieee"
        cudnn.rnn.fp32_precision = "ieee"
        torch.set_float32_matmul_precision("highest")
        matmul.fp32_precision = "ieee"
        yield
    finally:
        legacy, conv, rnn, mm, mm_legacy, cpu_mm = saved
        if legacy is not None:
            cudnn.allow_tf32 = legacy
        cudnn.conv.fp32_precision = conv
        cudnn.rnn.fp32_precision = rnn
        if mm_legacy is not None:
            torch.set_float32_matmul_precision(mm_legacy)
        matmul.fp32_precision = mm
        cpu_matmul.fp32_precision = cpu_mm


def _legacy(read):
    """A legacy precision setting (``torch.backends.cudnn.allow_tf32``,
    ``torch.get_float32_matmul_precision()``), or None where reading it
    raises: its settings were made by both APIs and disagree."""
    try:
        return read()
    except RuntimeError:
        return None


def read_flags() -> dict:
    """The precision settings ``full_float32`` governs, as torch reports
    them (a legacy one None where it cannot be read), and
    whether cuDNN is enabled."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return {"cudnn_enabled": cudnn.enabled,
            "cudnn_allow_tf32": _legacy(lambda: cudnn.allow_tf32),
            "cudnn_conv": cudnn.conv.fp32_precision,
            "cudnn_rnn": cudnn.rnn.fp32_precision,
            "cuda_matmul": matmul.fp32_precision,
            "float32_matmul_precision": _legacy(
                torch.get_float32_matmul_precision)}
