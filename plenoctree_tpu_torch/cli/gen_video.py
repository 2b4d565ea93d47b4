"""Render a spherical-orbit video from a trained NeRF-SH model.

Port of plenoctree_tpu/cli/gen_video.py: the same flags
(elevation, num_views, height, width, camera_angle_x, intrin, radius, fps,
up_axis, write_poses), the same poses (`np.linspace(-180, 180, n + 1)[:-1]`
around the elevation), the same focal (or the mean of K[0, 0] and K[1, 1]
of --intrin) and the same layout: `train_dir/video/e{-elev*10:03}/frames/
{i:04}.png`, then `video.mp4` beside them. Each frame is
engine.render_image of the newest checkpoint (the plain forward, as the
JAX package's inference model; LLFF disparities normalised; with --device
cuda each chunk split over every visible GPU, shaped by --mesh_shape), written
through the port's PNG writer. The mp4 is written only where imageio can
write one; otherwise the CLI prints the JAX CLI's "mp4 write unavailable"
line and keeps the frames, which are the product.

Under `python -m torch.distributed.run` (or in a process group its caller
made) every rank renders its share of each chunk on its own device and
rank 0 alone writes the poses, the frames and the video, as the JAX CLI's
process 0 (see cli/eval.py).

Usage:
  python -m plenoctree_tpu_torch.cli.gen_video --config nerf_sh/config/blender \\
      --train_dir <ckpt dir> [--elevation -30 --num_views 40] --device cuda
"""

import argparse
import os

import numpy as np
import torch

from plenoctree_tpu_torch import engine, parallel
from plenoctree_tpu_torch.data.poses import pose_spherical
from plenoctree_tpu_torch.data.rays import generate_rays, namedtuple_map
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.utils import config as config_lib
from plenoctree_tpu_torch.utils import io as io_utils

SEED = 20200823  # the JAX CLI's PRNGKey seed (model init before the restore)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--elevation", type=float, default=-30.0,
                        help="Elevation angle (negative is above)")
    parser.add_argument("--num_views", type=int, default=40,
                        help="The number of views to generate.")
    parser.add_argument("--height", type=int, default=800, help="The size of images to generate.")
    parser.add_argument("--width", type=int, default=800, help="The size of images to generate.")
    parser.add_argument("--camera_angle_x", type=float, default=0.7,
                        help="Camera angle in rad in x direction (sets focal).")
    parser.add_argument("--intrin", default=None,
                        help="Intrinsics file; overrides camera_angle_x")
    parser.add_argument("--radius", type=float, default=4.0,
                        help="Radius to origin of camera path.")
    parser.add_argument("--fps", type=int, default=20, help="FPS of generated video")
    parser.add_argument("--up_axis", type=int, default=1,
                        help="up axis for camera views; 1-6: Z up/Z down/Y up/Y down/X up/X down")
    parser.add_argument("--write_poses", default=None,
                        help="Specify to write poses to given file (4N x 4)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on; 'cuda' raises when there is no GPU")
    parallel.mesh.add_dist_backend_flag(parser)
    config_lib.add_flags(parser, extra=("radius",))
    return parser


def orbit_poses(num_views, elevation, radius, up_axis):
    """[num_views, 4, 4] orbit poses, as the JAX CLI makes them."""
    return np.stack(
        [
            pose_spherical(angle, elevation, radius, up_axis - 1)
            for angle in np.linspace(-180, 180, num_views + 1)[:-1]
        ],
        0,
    )


def write_mp4(path, frames, fps):
    """Write frames [N, H, W, 3] in [0, 1] as an mp4 through imageio, the
    JAX CLI's writer; returns the error where there is none to write with."""
    try:
        import imageio

        imageio.mimwrite(path, (np.clip(frames, 0.0, 1.0) * 255).astype(np.uint8), fps=fps,
                         quality=8)
    except Exception as e:  # no imageio, or no ffmpeg backend for it
        return e
    return None


def main(argv=None, devices=None):
    """Returns the video directory (frames/ and, where written, video.mp4).
    `devices` overrides the device list the renders are split over."""
    cfg = config_lib.parse_flags(build_parser(), argv)
    if cfg.train_dir is None:
        raise ValueError("train_dir must be set. None set now.")
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")
    with parallel.mesh.cli_group(cfg.dist_backend, device) as (rank, _, device):
        return _render_video(cfg, parallel.cli_devices(cfg, device, devices), rank == 0)


def _render_video(cfg, devices, lead):
    device = devices[0]
    say = print if lead else (lambda *a, **k: None)  # the JAX CLI's h0print
    say("* Generating poses")
    render_poses = orbit_poses(cfg.num_views, cfg.elevation, cfg.radius, cfg.up_axis)
    if cfg.write_poses and lead:
        np.savetxt(cfg.write_poses, render_poses.reshape(-1, 4))
        say("Saved poses to", cfg.write_poses)

    focal = 0.5 * cfg.width / np.tan(0.5 * cfg.camera_angle_x)
    if cfg.intrin is not None:
        say("Load focal length from intrin file")
        K = np.loadtxt(cfg.intrin)
        focal = (K[0, 0] + K[1, 1]) * 0.5

    say("* Generating rays")
    rays = generate_rays(cfg.width, cfg.height, focal, render_poses)

    say("* Creating model")
    model, _ = get_model_state(cfg, seed=SEED, restore=True, device=device)
    model.eval()

    vid_name = "e{:03}".format(int(-cfg.elevation * 10))
    video_dir = os.path.join(cfg.train_dir, "video", vid_name)
    frames_dir = os.path.join(video_dir, "frames")
    say(" Saving to", video_dir)
    if lead:
        os.makedirs(frames_dir, exist_ok=True)

    frames = []
    for i in range(cfg.num_views):
        say(f"** View {i + 1}/{cfg.num_views}")
        pred_color, _, _ = engine.render_image(
            model, namedtuple_map(lambda x: x[i], rays), chunk=cfg.chunk, device=device,
            normalize_disp=cfg.dataset == "llff", devices=devices,
        )
        if lead:
            io_utils.save_img(pred_color, os.path.join(frames_dir, f"{i:04}.png"))
            frames.append(pred_color)
    if not lead:
        return video_dir

    vid_path = os.path.join(video_dir, "video.mp4")
    say("* Writing video", vid_path)
    err = write_mp4(vid_path, np.stack(frames), cfg.fps)
    if err is not None:
        say(f"  mp4 write unavailable ({err}); frames kept in {frames_dir}")
    say("* Done")
    return video_dir


if __name__ == "__main__":
    main()
