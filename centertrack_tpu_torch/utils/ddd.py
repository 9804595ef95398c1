"""Monocular-3D box math (reference: src/lib/utils/ddd_utils.py; JAX:
centertrack_tpu/utils/ddd.py), in numpy."""

from __future__ import annotations

import numpy as np


def compute_corners_3d(dim, rotation_y):
    """(reference: ddd_utils.py:8-22) -> (8, 3) corners."""
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
    l, w, h = dim[2], dim[1], dim[0]
    x_corners = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y_corners = [0, 0, 0, 0, -h, -h, -h, -h]
    z_corners = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = np.array([x_corners, y_corners, z_corners], dtype=np.float32)
    return (r @ corners).T


def compute_box_3d(dim, location, rotation_y):
    """(reference: ddd_utils.py:24-31)"""
    corners = compute_corners_3d(dim, rotation_y)
    return corners + np.asarray(location, np.float32).reshape(1, 3)


def project_to_image(pts_3d, p):
    """(reference: ddd_utils.py:33-42): (N,3) cam pts -> (N,2) pixels."""
    pts_3d_homo = np.concatenate(
        [pts_3d, np.ones((pts_3d.shape[0], 1), np.float32)], axis=1)
    pts_2d = (p @ pts_3d_homo.T).T
    return pts_2d[:, :2] / pts_2d[:, 2:]


def unproject_2d_to_3d(pt_2d, depth, p):
    """(reference: ddd_utils.py:91-100)"""
    z = depth - p[2, 3]
    x = (pt_2d[0] * depth - p[0, 3] - p[0, 2] * z) / p[0, 0]
    y = (pt_2d[1] * depth - p[1, 3] - p[1, 2] * z) / p[1, 1]
    return np.array([x, y, z], dtype=np.float32).reshape(3)


def alpha2rot_y(alpha, x, cx, fx):
    """Observation angle -> yaw (reference: ddd_utils.py:102-114)."""
    rot_y = alpha + np.arctan2(x - cx, fx)
    if rot_y > np.pi:
        rot_y -= 2 * np.pi
    if rot_y < -np.pi:
        rot_y += 2 * np.pi
    return rot_y


def rot_y2alpha(rot_y, x, cx, fx):
    """(reference: ddd_utils.py:116-128)"""
    alpha = rot_y - np.arctan2(x - cx, fx)
    if alpha > np.pi:
        alpha -= 2 * np.pi
    if alpha < -np.pi:
        alpha += 2 * np.pi
    return alpha


def ddd2locrot(center, alpha, dim, depth, calib):
    """amodal center + depth + alpha -> 3D location + yaw
    (reference: ddd_utils.py:131-136)."""
    locations = unproject_2d_to_3d(center, depth, calib)
    locations[1] += dim[0] / 2
    rotation_y = alpha2rot_y(alpha, center[0], calib[0, 2], calib[0, 0])
    return locations, rotation_y


def ddd2locrot_batch(centers, alphas, dims, depths, calib):
    """Batched 3D lift: (N,2) amodal centers + (N,) alpha + (N,3) dim +
    (N,) depth -> ((N,3) locations, (N,) yaw). Same math as
    ``ddd2locrot`` applied row-wise, expressed as array ops so the
    post-process stage does one call per image instead of one per box.
    """
    centers = np.asarray(centers, np.float32).reshape(-1, 2)
    depths = np.asarray(depths, np.float32).reshape(-1)
    dims = np.asarray(dims, np.float32).reshape(-1, 3)
    alphas = np.asarray(alphas, np.float32).reshape(-1)
    z = depths - calib[2, 3]
    x = (centers[:, 0] * depths - calib[0, 3] - calib[0, 2] * z) / calib[0, 0]
    y = (centers[:, 1] * depths - calib[1, 3] - calib[1, 2] * z) / calib[1, 1]
    y = y + dims[:, 0] / 2  # ground-plane anchor, as in ddd2locrot
    locs = np.stack([x, y, z], axis=1)
    rot_y = alphas + np.arctan2(centers[:, 0] - calib[0, 2], calib[0, 0])
    rot_y = np.where(rot_y > np.pi, rot_y - 2 * np.pi, rot_y)
    rot_y = np.where(rot_y < -np.pi, rot_y + 2 * np.pi, rot_y)
    return locs.astype(np.float32), rot_y.astype(np.float32)


def project_3d_bbox(location, dim, rotation_y, calib):
    """(reference: ddd_utils.py:138-141)"""
    return project_to_image(compute_box_3d(dim, location, rotation_y), calib)
