"""Baseline JPEG and PNG row filters through the port's host codec
(``csrc/image_codec.c``, built with the host compiler at first use by
``ops/_build.load_host`` and called through ``ctypes``, which releases
the GIL for each call, so the loader's threads decode at once).

``decode`` gives what ``cv2.imread(path)`` gives for a JPEG file (BGR
``uint8`` (H, W, 3)), bit for bit: sequential Huffman JPEGs (SOF0, SOF1)
of 8 bits, 1 or 3 components, sampling factors up to 2x2, restart
intervals and any Huffman tables. Progressive (SOF2), lossless,
hierarchical and arithmetic-coded files, 12-bit samples, CMYK, and an
EXIF orientation other than 1 (cv2 rotates those) raise
``NotImplementedError`` naming ROADMAP A6d; truncated or corrupt data
raises ``ValueError``. ``encode`` gives the bytes of
``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, quality])`` for BGR
(H, W, 3) (4:2:0) or gray (H, W) (one component) ``uint8`` input.
``png_unfilter`` undoes PNG's five row filters. There is no Python
decoder behind the C one: a failed build or load raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from centertrack_tpu_torch.ops import _build

# the codec's status codes (csrc/image_codec.c)
OK, UNSUPPORTED, CORRUPT, SMALL, NOMEM = range(5)
MSG_LEN = 256
# the most bytes an 8x8 block can take (DC and 63 AC codes of 26 bits,
# every byte stuffed) and the markers' bytes, for the encoder's buffer
BLOCK_BYTES = 420
HEADER_BYTES = 1024

_fns = None


def _lib():
    global _fns
    if _fns is None:
        lib = _build.load_host("image_codec")
        p, size, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        sigs = {"jpeg_info": [p, size, p, p, i],
                "jpeg_decode": [p, size, p, i, i, p, i],
                "jpeg_encode": [p, i, i, i, i, p, size, p, p, i],
                "png_unfilter": [p, p, i, i, i]}
        fns = {}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            fns[name] = fn
        _fns = fns
    return _fns


def _check(rc: int, msg, path: str):
    text = msg.value.decode(errors="replace")
    if rc == UNSUPPORTED:
        raise NotImplementedError(
            f"{path}: {text}: not decoded by the port (ROADMAP A6d: "
            f"progressive and arithmetic JPEG, 12-bit, CMYK, EXIF "
            f"orientation)")
    if rc == CORRUPT:
        raise ValueError(f"{path}: {text}")
    if rc == NOMEM:
        raise MemoryError(f"{path}: {text}")
    if rc != OK:
        raise RuntimeError(f"{path}: image codec status {rc}: {text}")


def decode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> BGR uint8 (H, W, 3), as ``cv2.imread``."""
    fns = _lib()
    buf = np.frombuffer(data, np.uint8)
    msg = ctypes.create_string_buffer(MSG_LEN)
    dims = (ctypes.c_int * 2)()
    _check(fns["jpeg_info"](buf.ctypes.data, buf.size, dims, msg, MSG_LEN),
           msg, path)
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    _check(fns["jpeg_decode"](buf.ctypes.data, buf.size, out.ctypes.data,
                              dims[0], dims[1], msg, MSG_LEN), msg, path)
    return out


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """BGR (H, W, 3) or gray (H, W) uint8 -> the bytes of
    ``cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, quality])``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"JPEG encoding takes uint8 (H, W) or (H, W, 3), "
                         f"got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    if channels == 1:
        blocks = -(-height // 8) * -(-width // 8)
    else:
        blocks = 6 * -(-height // 16) * -(-width // 16)
    out = np.empty(HEADER_BYTES + BLOCK_BYTES * blocks, np.uint8)
    written = ctypes.c_size_t()
    msg = ctypes.create_string_buffer(MSG_LEN)
    _check(_lib()["jpeg_encode"](img.ctypes.data, height, width, channels,
                                 int(quality), out.ctypes.data, out.size,
                                 ctypes.byref(written), msg, MSG_LEN),
           msg, "<encode>")
    return out[:written.value].tobytes()


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """PNG's five row filters undone (PNG spec 9.2): ``raw`` holds
    ``height`` rows of a filter-type byte and ``stride`` bytes, ``bpp``
    bytes a pixel. Returns (height, stride) uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data of {raw.size} bytes, not the "
                         f"{height * (stride + 1)} of its header")
    out = np.empty((height, stride), np.uint8)
    bad = _lib()["png_unfilter"](raw.ctypes.data, out.ctypes.data, height,
                                 stride, bpp)
    if bad:
        raise ValueError(f"PNG filter type {raw[(bad - 1) * (stride + 1)]} "
                         f"does not exist")
    return out
