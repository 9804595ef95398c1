"""Image files without OpenCV: the port's stand-in for ``cv2.imread``
and ``cv2.imwrite`` (JAX: data/generic.py:195, tools/selftest.py).

PNG only, through ``zlib`` and numpy: 8-bit gray, gray + alpha, RGB
and RGBA, not interlaced, every filter type on reading. ``read`` returns
a BGR ``uint8`` (H, W, 3) array, as ``cv2.imread`` does (gray is
replicated, alpha dropped), because the pipeline's mean and std are in
BGR order. ``write`` takes BGR (H, W, 3) or gray (H, W) ``uint8`` and
filters each row with whichever of types 0-2 (none, sub, up) leaves the
smallest sum of absolute bytes, so that every row decodes without a
per-pixel loop. Any other format (JPEG first) raises
``NotImplementedError``: JPEG decoding is ROADMAP A6b.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _not_png(path: str):
    return NotImplementedError(
        f"{path}: only PNG images are read and written by the port; "
        f"JPEG and other formats wait for ROADMAP A6b (JPEG decoding)")


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


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """PNG's five row filters undone (PNG spec 9.2): None, Sub and Up in
    numpy, Average and Paeth byte by byte."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            # sub: a running sum mod 256 over each byte position of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(stride)
            up = prior.tolist()
            for i, v in enumerate(line.tolist()):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp
                                  else 0)
                cur[i] = (v + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind} does not exist")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> BGR uint8 (H, W, 3)."""
    if not data.startswith(PNG_SIGNATURE):
        raise _not_png(path)
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
    pixels = _unfilter(raw, height, width * channels, channels).reshape(
        height, width, channels)
    if channels <= 2:
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., 2::-1])


def read(path: str) -> np.ndarray:
    """``cv2.imread(path)`` for a PNG file: BGR uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
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


def write(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` for a ``.png`` path."""
    if os.path.splitext(path)[1].lower() != ".png":
        raise _not_png(path)
    with open(path, "wb") as f:
        f.write(encode_png(img))
