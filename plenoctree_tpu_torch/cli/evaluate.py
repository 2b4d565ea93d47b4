"""Evaluate a PlenOctree on the test set.

Port of plenoctree_tpu/cli/evaluate.py: render every test view from the
tree, print PSNR/SSIM/LPIPS, write `<input>.results.json`, optionally write
images or a video. As in the JAX CLI, the views go through the exact march
(`VolumeRenderer`) unless `--fast_eval` asks for the tile renderer, the
serving path. LPIPS is NaN unless VGG-LPIPS weights are found
($LPIPS_WEIGHTS_NPZ; see ops/lpips.py).

Usage:
  python -m plenoctree_tpu_torch.cli.evaluate --input tree.npz \\
      --config nerf_sh/config/blender --dataset synthetic [--fast_eval]
"""

import argparse
import json
import os

import numpy as np

from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.octree import N3Tree
from plenoctree_tpu_torch.octree.evaluate import eval_octree
from plenoctree_tpu_torch.utils import config as config_lib


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", default="./tree_opt.npz", help="Input octree npz")
    parser.add_argument("--write_vid", default=None, help="write rendered video (*.mp4)")
    parser.add_argument("--write_images", default=None, help="write images to directory")
    parser.add_argument(
        "--synthetic_resolution", type=int, default=64,
        help="image side of the procedural scene (--dataset synthetic)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to render on; 'cuda' raises when there is no GPU",
    )
    config_lib.add_flags(parser)
    return parser


def main(argv=None):
    np.random.seed(20200823)
    args = config_lib.parse_flags(build_parser(), argv)

    dataset = get_dataset("test", args)
    print("N3Tree load", args.input)
    tree = N3Tree.load(args.input)

    want_frames = args.write_vid is not None or args.write_images is not None
    avg_psnr, avg_ssim, avg_lpips, frames = eval_octree(
        tree, dataset, args, want_lpips=True, want_frames=want_frames,
        device=args.device,
    )
    print("Average PSNR", avg_psnr, "SSIM", avg_ssim, "LPIPS", avg_lpips)
    with open(args.input + ".results.json", "w") as f:
        json.dump({"psnr": avg_psnr, "ssim": avg_ssim, "lpips": avg_lpips}, f)

    if args.write_vid is not None and len(frames):
        import imageio

        print("Writing to", args.write_vid)
        try:
            imageio.mimwrite(args.write_vid, frames)
        except Exception as e:  # no ffmpeg backend installed
            print(f"  mp4 write unavailable ({e}); use --write_images instead")
    if args.write_images is not None and len(frames):
        import imageio

        print("Writing to", args.write_images)
        os.makedirs(args.write_images, exist_ok=True)
        for idx, frame in enumerate(frames):
            imageio.imwrite(os.path.join(args.write_images, f"{idx:03d}.png"), frame)
    return avg_psnr, avg_ssim, avg_lpips


if __name__ == "__main__":
    main()
