"""Image files without OpenCV: the port's stand-in for ``cv2.imread``
and ``cv2.imwrite`` (JAX: data/generic.py:195, tools/selftest.py).

``read`` returns a BGR ``uint8`` (H, W, 3) array, as ``cv2.imread``
does, bit for bit (gray is replicated, alpha dropped), because the
pipeline's mean and std are in BGR order. It routes by content, not by
extension: a JPEG (SOI ``FF D8``) goes to the port's C codec
(``utils/jpeg``: baseline Huffman JPEG, libjpeg-turbo's arithmetic), a
PNG to ``zlib`` and the codec's row unfilter (8-bit gray, gray + alpha,
RGB and RGBA, not interlaced, every filter type). ``write`` takes BGR
(H, W, 3) or gray (H, W) ``uint8``: a ``.jpg`` or ``.jpeg`` path gets
the bytes ``cv2.imwrite`` writes (quality 95 unless given), a ``.png``
path each row filtered with whichever of types 0-2 (none, sub, up)
leaves the smallest sum of absolute bytes. Any other format raises
``NotImplementedError``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from centertrack_tpu_torch.utils import jpeg

JPEG_SOI = b"\xff\xd8"
JPEG_EXTENSIONS = (".jpg", ".jpeg")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _not_supported(path: str):
    return NotImplementedError(
        f"{path}: only JPEG and PNG images are read and written by the "
        f"port")


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3)."""
    if not data.startswith(PNG_SIGNATURE):
        raise _not_supported(path)
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {color}, "
            f"interlace {interlace}; the port reads 8-bit gray, gray+alpha, "
            f"RGB and RGBA, not interlaced")
    channels = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pixels = jpeg.png_unfilter(raw, height, width * channels,
                               channels).reshape(
        height, width, channels)
    if channels <= 2:
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., 2::-1])


def read(path: str) -> np.ndarray:
    """``cv2.imread(path)`` for a JPEG or PNG file: BGR uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SOI):
        return jpeg.decode(data, path)
    return decode_png(data, path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """BGR (H, W, 3) or gray (H, W) uint8 -> PNG bytes, each row filtered
    by the cheapest of types 0-2."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write takes uint8 (H, W) or (H, W, 3), got "
                         f"{img.dtype} {img.shape}")
    if img.ndim == 3:
        pixels, color, bpp = img[..., ::-1], 2, 3
    else:
        pixels, color, bpp = img, 0, 1
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(pixels).reshape(height, width * bpp)
    sub = rows.copy()
    sub[:, bpp:] -= rows[:, :-bpp]
    up = rows.copy()
    up[1:] -= rows[:-1]
    cand = np.stack([rows, sub, up])
    # the cheapest filter by the sum of bytes read as signed
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=2)
    kind = cost.argmin(axis=0).astype(np.uint8)
    body = np.concatenate(
        [kind[:, None], cand[kind, np.arange(height)]], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header) +
            _chunk(b"IDAT", zlib.compress(body.tobytes(), level)) +
            _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray, quality: int = 95) -> None:
    """``cv2.imwrite(path, img)`` for a ``.jpg``, ``.jpeg`` (at
    ``quality``, cv2's ``IMWRITE_JPEG_QUALITY``) or ``.png`` path."""
    ext = os.path.splitext(path)[1].lower()
    if ext in JPEG_EXTENSIONS:
        data = jpeg.encode(img, quality)
    elif ext == ".png":
        data = encode_png(img)
    else:
        raise _not_supported(path)
    with open(path, "wb") as f:
        f.write(data)
