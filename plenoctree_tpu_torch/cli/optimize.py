"""Optimize a PlenOctree by fine-tuning on the train set.

Port of plenoctree_tpu/cli/optimize.py, `--tile_opt` path: SGD (lr ~1e7)
or Adam directly on leaf data through the tile compositor and its CUDA
backward kernel, per-image MSE steps, validation early stopping (the best
snapshot is saved), optional train-split holdout. The same flags, plus
`--device` and `--synthetic_resolution`.

Not ported, each raising NotImplementedError that names ROADMAP.md: the
exact-march optimizer (without `--tile_opt`), and NDC (LLFF) scenes, which
the JAX CLI sends to the march.

Usage:
  python -m plenoctree_tpu_torch.cli.optimize --input tree.npz \\
      --config nerf_sh/config/blender --dataset synthetic --tile_opt \\
      --output tree_opt.npz
"""

import argparse

import numpy as np

from plenoctree_tpu_torch.data import get_dataset
from plenoctree_tpu_torch.octree import N3Tree
from plenoctree_tpu_torch.octree.tile_opt import optimize_tree_tiles
from plenoctree_tpu_torch.utils import config as config_lib


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", default="./tree.npz", help="Input octree npz from extraction")
    parser.add_argument("--output", default="./tree_opt.npz", help="Output octree npz")
    parser.add_argument("--render_interval", type=int, default=0, help="render interval")
    parser.add_argument("--val_interval", type=int, default=2, help="validation interval")
    parser.add_argument("--num_epochs", type=int, default=80, help="epochs to train for")
    config_lib.add_bool_flag(parser, "sgd", True, "use SGD optimizer instead of Adam")
    parser.add_argument("--lr", type=float, default=1e7, help="optimizer step size")
    parser.add_argument("--sgd_momentum", type=float, default=0.0, help="sgd momentum")
    config_lib.add_bool_flag(parser, "sgd_nesterov", False, "sgd nesterov momentum")
    parser.add_argument("--write_vid", default=None, help="write rendered video to path (*.mp4)")
    config_lib.add_bool_flag(parser, "split_train", None, "split train set instead of val set")
    parser.add_argument(
        "--split_holdout_prop", type=float, default=0.2, help="holdout proportion for split_train"
    )
    config_lib.add_bool_flag(parser, "nosave", False, "do not save (for speed)")
    config_lib.add_bool_flag(
        parser, "continue_on_decrease", False, "keep training even if val PSNR decreases"
    )
    parser.add_argument(
        "--opt_rays_per_step", type=int, default=0,
        help="subsample rays per step (march optimizer only; 0 = full image)",
    )
    config_lib.add_bool_flag(
        parser, "tile_opt", False,
        "optimize through the tile-compositing renderer and its CUDA backward "
        "kernel (the only optimizer ported so far)",
    )
    parser.add_argument(
        "--tile_grid_c", type=int, default=64, help="tile optimizer coarse partition resolution"
    )
    parser.add_argument(
        "--synthetic_resolution", type=int, default=64,
        help="image side of the procedural scene (--dataset synthetic)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to optimize on; 'cuda' raises when there is no GPU",
    )
    config_lib.add_flags(parser)
    return parser


def main(argv=None):
    """Returns (best_tree or None, best val PSNR)."""
    np.random.seed(20200823)
    args = config_lib.parse_flags(build_parser(), argv)
    if args.config is not None and "llff" in str(args.config):
        raise NotImplementedError(
            "NDC (LLFF) scenes are optimized through the exact march in the JAX "
            "package, which is not ported yet (ROADMAP.md)"
        )
    if not args.tile_opt:
        raise NotImplementedError(
            "the exact-march optimizer is not ported yet (ROADMAP.md); pass "
            "--tile_opt to optimize through the tile renderer"
        )

    def get_data(stage):
        dataset = get_dataset(stage, args)
        images = dataset.images.reshape(-1, dataset.h, dataset.w, 3)
        return dataset.focal, dataset.camtoworlds, images

    focal, train_c2w, train_gt = get_data("train")
    if args.split_train:
        test_sz = int(train_c2w.shape[0] * args.split_holdout_prop)
        print("Splitting train to train/val manually, holdout", test_sz)
        perm = np.random.permutation(train_c2w.shape[0])
        test_c2w, test_gt = train_c2w[perm[:test_sz]], train_gt[perm[:test_sz]]
        train_c2w, train_gt = train_c2w[perm[test_sz:]], train_gt[perm[test_sz:]]
    else:
        print("Using given val set")
        test_focal, test_c2w, test_gt = get_data("val")
        assert focal == test_focal

    print("N3Tree load", args.input)
    tree = N3Tree.load(args.input)

    print(f"Using {'SGD' if args.sgd else 'Adam'}, lr {args.lr}")
    best_tree, best_psnr = optimize_tree_tiles(
        tree,
        train_c2w,
        train_gt,
        test_c2w,
        test_gt,
        focal,
        args,
        num_epochs=args.num_epochs,
        lr=args.lr,
        use_sgd=args.sgd,
        sgd_momentum=args.sgd_momentum,
        val_interval=args.val_interval,
        continue_on_decrease=args.continue_on_decrease,
        grid_c=args.tile_grid_c,
        device=args.device,
    )
    if not args.nosave:
        if best_tree is not None:
            print("Saving best model to", args.output)
            best_tree.save(args.output, compress=False)
        else:
            print("Did not improve upon initial model")
    return best_tree, best_psnr


if __name__ == "__main__":
    main()
