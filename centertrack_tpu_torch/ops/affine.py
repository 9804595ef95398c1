"""Affine transform construction and application (host-side numpy),
the geometry of the reference (reference: src/lib/utils/image.py:29-102),
with the 3-point solve done in numpy instead of cv2."""

from __future__ import annotations

import numpy as np


def get_dir(src_point, rot_rad):
    """Rotate a 2-vector by rot_rad (reference: image.py:84-91)."""
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([
        src_point[0] * cs - src_point[1] * sn,
        src_point[0] * sn + src_point[1] * cs,
    ], dtype=np.float32)


def get_3rd_point(a, b):
    """Third point completing a right triangle (reference: image.py:79-81)."""
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 affine mapping src (3, 2) -> dst (3, 2), as
    cv2.getAffineTransform (reference: image.py:65-68)."""
    a = np.concatenate([src, np.ones((3, 1), np.float64)], axis=1)
    trans_t = np.linalg.solve(a, dst.astype(np.float64))
    return trans_t.T.astype(np.float64)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=0):
    """Center/scale/rot -> 2x3 affine (reference: image.py:37-70)."""
    if not isinstance(scale, np.ndarray) and not isinstance(scale, list):
        scale = np.array([scale, scale], dtype=np.float32)
    scale_tmp = np.asarray(scale, dtype=np.float32)
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def transform_preds_with_trans(coords, trans):
    """A 2x3 affine applied to an (N, 2) array (reference:
    image.py:20-26): float32 points, the product in ``trans``' dtype."""
    target = np.ones((coords.shape[0], 3), np.float32)
    target[:, :2] = coords
    return (trans @ target.T).T[:, :2]


def invert_affine(trans: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine transform."""
    m = np.eye(3, dtype=np.float64)
    m[:2, :] = trans
    return np.linalg.inv(m)[:2, :]


def affine_transform(pt, t):
    """A 2x3 affine applied to one point (reference: image.py:73-76)."""
    new_pt = np.array([pt[0], pt[1], 1.0], dtype=np.float32)
    return (t @ new_pt)[:2]
