"""Camera poses of the benchmark's traffic (host numpy, float32 4x4 c2w).

`orbit_pose` is the geometry of plenoctree_tpu_torch/data/poses.py::
orbit_pose (the smoke's serving orbit); `pose_spherical` that of
pose_spherical there (NeRF's Blender cameras). Copied, so that the traffic
does not move when the program's helpers do.
"""

import numpy as np


def orbit_pose(theta, radius=2.2, height=0.8):
    """Look-at pose on a z-up circle around the origin, at azimuth `theta`
    (radians); the camera looks along its -z axis."""
    cam = np.array([radius * np.cos(theta), radius * np.sin(theta), height], np.float32)
    return look_at(cam)


def look_at(cam):
    cam = np.asarray(cam, np.float32)
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


def hemisphere_pose(azimuth, elevation, distance):
    """Look-at pose at `distance` from the origin, at `azimuth` and
    `elevation` (radians) above the z = 0 plane."""
    ce = np.cos(elevation)
    cam = distance * np.array([ce * np.cos(azimuth), ce * np.sin(azimuth), np.sin(elevation)])
    return look_at(cam)


def pose_spherical(theta, phi, radius):
    """NeRF's Blender camera at azimuth `theta` and elevation `phi` (degrees)."""
    def trans_t(t):
        m = np.eye(4, dtype=np.float32)
        m[2, 3] = t
        return m

    def rot_phi(p):
        c, s = np.cos(p), np.sin(p)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float32)

    def rot_theta(th):
        c, s = np.cos(th), np.sin(th)
        return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float32)

    c2w = rot_theta(theta / 180.0 * np.pi) @ (rot_phi(phi / 180.0 * np.pi) @ trans_t(radius))
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)
    return (flip @ c2w).astype(np.float32)
