"""Camera pose synthesis (host numpy): orbits around the scene and the
LLFF pose machinery (average pose, recentring, the spiral render path,
spherify).

A copy of plenoctree_tpu/data/poses.py (the port imports nothing of the
JAX package), plus `orbit_pose`, the serving benchmark's orbit.
"""

import numpy as np


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    """Look-at camera basis [right, up', forward, pos] as a 3x4."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


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


def poses_avg(poses):
    """Average LLFF pose (original NeRF code convention)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    """Recenter poses around their average."""
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses44 = np.linalg.inv(c2w) @ poses44
    poses_[:, :3, :4] = poses44[:, :3, :4]
    return poses_


def spiral_path(poses, bds, n_views=120, n_rots=2, zrate=0.5, dt=0.75):
    """Spiral render path for forward-facing scenes."""
    c2w = poses_avg(poses)
    up = normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = poses[:, :3, 3]
    rads = np.array(list(np.percentile(np.abs(tt), 90, 0)) + [1.0])
    hwf = c2w[:, 4:5]
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return np.array(render_poses, dtype=np.float32)[:, :3, :4]


def spherify_poses(poses, bds, make_render_path=False):
    """Normalize 360 captures to a centered sphere; optionally build a
    circular render path. Returns (poses_reset, render_poses | None, bds)."""
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # Closest point to all camera axes.
    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0)) @ b_i.mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    render_poses = None
    if make_render_path:
        centroid = np.mean(poses_reset[:, :3, 3], 0)
        zh = centroid[2]
        radcircle = np.sqrt(rad**2 - zh**2)
        new_poses = []
        for th in np.linspace(0.0, 2.0 * np.pi, 120):
            camorigin = np.array(
                [radcircle * np.cos(th), radcircle * np.sin(th), zh]
            )
            up = np.array([0, 0, -1.0])
            vec2 = normalize(camorigin)
            vec0 = normalize(np.cross(vec2, up))
            vec1 = normalize(np.cross(vec2, vec0))
            new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
        new_poses = np.stack(new_poses, 0)
        new_poses = np.concatenate(
            [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
            -1,
        )
        render_poses = new_poses[:, :3, :4]

    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        -1,
    )
    return poses_reset, render_poses, bds
