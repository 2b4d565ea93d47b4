"""Extract a PlenOctree from a trained NeRF-SH model.

Port of plenoctree_tpu/cli/extract.py: restore the newest checkpoint of
--train_dir (the port's or the JAX package's msgpack format), optionally
auto-scale the bbox to the sigma support, build the tree from the dense
grid (sigma or visibility-weight mask), fill the leaves with antialiased
NeRF samples, relu the sigma channel and save `--output`; then, with
`--eval` (the default), evaluate it on the test views through the exact
march, as the JAX CLI does (the tile renderer with `--fast_eval`). The
NeRF is queried on `--device` (the fused trunk kernel with --use_pallas on
a GPU), and with `--device cuda` over every visible GPU, shaped by
--mesh_shape as in the JAX CLI: each dispatch of --point_chunk points per
device split over them (octree/extract.py).

SG models (sg_dim > 0) give SG{sg_dim} trees whose extra_data [N, 4]
holds (softplus lambda, cartesian mu). use_viewdirs models
(nerf_sh/config/misc/proj) give SH trees of degree --sh_deg by
Monte-Carlo SH projection over --projection_samples directions.

Usage:
  python -m plenoctree_tpu_torch.cli.extract --train_dir <ckpt dir> \\
      --config nerf_sh/config/blender --dataset synthetic --use_pallas \\
      --compute_dtype bfloat16 --output tree.npz
"""

import argparse
import json
import os

import torch

from plenoctree_tpu_torch import parallel
from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.models.nerf import get_model_state
from plenoctree_tpu_torch.octree import N3Tree
from plenoctree_tpu_torch.octree import extract as extract_lib
from plenoctree_tpu_torch.utils import config as config_lib

SEED = 20200823  # the JAX CLI's PRNGKey seed (model init before the restore)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output", default="./tree.npz", help="Output file")
    config_lib.add_bool_flag(parser, "eval", True, "Evaluate after building the octree")
    parser.add_argument(
        "--synthetic_resolution", type=int, default=64,
        help="image side of the procedural scene (--dataset synthetic)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to query the NeRF on; 'cuda' raises when there is no GPU",
    )
    config_lib.add_flags(parser)
    return parser


def main(argv=None, devices=None):
    """Returns the extracted tree (and, with --eval, writes
    `<output>.results.json`). `devices` overrides the device list the NeRF
    queries are split over (a device may repeat)."""
    cfg = config_lib.parse_flags(build_parser(), argv)
    if cfg.train_dir is None:
        raise ValueError("train_dir must be set. None set now.")
    if cfg.dataset != "synthetic" and cfg.data_dir is None:
        raise ValueError("data_dir is required")
    if cfg.tree_branch_n != 2:
        # The extraction grid is base-2, as in the reference, whose dense
        # grid hardcodes 2**(init_grid_depth+1) though it exposes the flag.
        raise ValueError(
            "--tree_branch_n != 2 is not supported by extraction (the dense "
            "evaluation grid is base-2, as in the reference)"
        )
    if cfg.use_viewdirs and cfg.sh_deg < 0:
        raise ValueError(
            "a use_viewdirs model is extracted by SH projection: set --sh_deg to the "
            "target degree (nerf_sh/config/misc/proj sets 4)"
        )
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False")

    devices = parallel.cli_devices(cfg, device, devices)
    device = devices[0]
    if len(devices) == 1:
        devices = None
    print("* Loading NeRF")
    model, state = get_model_state(cfg, seed=SEED, restore=True, device=device)
    print("  from step", state.step)

    data_format = None
    extra_data = None
    if cfg.sg_dim > 0:
        data_format = f"SG{cfg.sg_dim}"
        extra_data = extract_lib.sg_extra_data(
            model.sg_lambda.detach().cpu().numpy(), model.sg_mu_spher.detach().cpu().numpy()
        )
    elif cfg.sh_deg > 0:
        data_format = f"SH{(cfg.sh_deg + 1) ** 2}"
    if data_format is not None:
        print("Detected format:", data_format)

    base_dir = os.path.dirname(cfg.output)
    if base_dir:
        os.makedirs(base_dir, exist_ok=True)

    dataset = get_dataset("train", cfg)
    if cfg.bbox_from_data:
        bbox = getattr(dataset, "bbox", None)
        if bbox is None:
            raise ValueError("--bbox_from_data needs a dataset with a bbox (NSVF)")
        center = (bbox[:3] + bbox[3:6]) * 0.5
        radius = (bbox[3:6] - bbox[:3]) * 0.5 * cfg.data_bbox_scale
        print("Bounding box from data: c", center, "r", radius)
    else:
        center = list(map(float, str(cfg.center).split()))
        if len(center) == 1:
            center *= 3
        radius = list(map(float, str(cfg.radius).split()))
        if len(radius) == 1:
            radius *= 3

    points_fn = extract_lib.make_points_fn(model, device)
    if cfg.autoscale:
        center, radius = extract_lib.auto_scale(cfg, center, radius, points_fn, device, devices)
        print("Autoscale result center", center, "radius", radius)

    radius = [r * cfg.bbox_scale for r in radius]
    if cfg.bbox_cube:
        radius = [max(radius)] * 3

    num_rgb_channels = cfg.num_rgb_channels
    if cfg.sh_deg >= 0:
        num_rgb_channels *= (cfg.sh_deg + 1) ** 2
    elif cfg.sg_dim > 0:
        num_rgb_channels *= cfg.sg_dim
    data_dim = 1 + num_rgb_channels
    print("data dim is", data_dim)

    print("* Creating model")
    tree = N3Tree(
        N=cfg.tree_branch_n,
        data_dim=data_dim,
        init_reserve=500000,
        depth_limit=cfg.init_grid_depth,
        radius=radius,
        center=center,
        data_format=data_format,
        extra_data=extra_data,
    )
    extract_lib.step1_build(cfg, tree, points_fn, dataset, device=device, devices=devices)
    cross_fn = extract_lib.make_cross_fn(model, device) if cfg.use_viewdirs else None
    extract_lib.step2_fill(cfg, tree, points_fn, device=device, cross_fn=cross_fn,
                           devices=devices)
    tree.relu_sigma_()
    tree.shrink_to_fit()
    print(tree)

    print("* Saving", cfg.output)
    tree.save(cfg.output, compress=False)

    if cfg.eval:
        from plenoctree_tpu_torch.octree.evaluate import eval_octree

        test_set = get_dataset("test", cfg)
        print("* Evaluation (before fine tune)")
        avg_psnr, avg_ssim, avg_lpips, _ = eval_octree(
            tree, test_set, cfg, want_lpips=True, device=device
        )
        print("Average PSNR", avg_psnr, "SSIM", avg_ssim, "LPIPS", avg_lpips)
        with open(cfg.output + ".results.json", "w") as f:
            json.dump(
                {
                    "psnr": avg_psnr,
                    "ssim": avg_ssim,
                    "lpips": avg_lpips,
                    "capacity": int(tree.n_internal),
                    "n_leaves": int(tree.n_leaves),
                },
                f,
            )
    return tree


if __name__ == "__main__":
    main()
