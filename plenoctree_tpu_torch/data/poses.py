"""Camera pose synthesis (host numpy): orbits around the scene.

A copy of the pinhole-orbit part of plenoctree_tpu/data/poses.py (the LLFF
recentring/spiral helpers wait for the LLFF loader).
"""

import numpy as np


def trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta, phi, radius):
    """Spherical orbit pose (degrees), NeRF convention."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
            dtype=np.float32,
        )
        @ c2w
    )
    return c2w


def orbit_pose(theta, radius=2.2, height=0.8):
    """Look-at pose on a z-up circle around the origin (OpenGL convention:
    the camera looks along -z). Same orbit as
    scripts/bench_octree_render.py::orbit_pose, the serving benchmark's."""
    cam = np.array(
        [radius * np.cos(theta), radius * np.sin(theta), height], np.float32
    )
    fwd = -cam / np.linalg.norm(cam)
    up = np.array([0, 0, 1], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = -up2
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = cam
    return c2w
