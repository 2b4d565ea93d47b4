"""Compress PlenOctrees for web serving (median-cut palette quantization).

Port of plenoctree_tpu/cli/compress.py: the same argparse surface and
output npz keys (quant_colors, quant_map, sigma, data_retained), through
the port's median cut (octree/quantize.py: the native library where it
loads, as in the JAX package, else numpy). Host code only: it takes no
device. Its last line names the path the median cuts took (`native:`).

Usage:
  python -m plenoctree_tpu_torch.cli.compress x.npz [y.npz ...] [--bits 16] [--out_dir d]
"""

import argparse
import os
import os.path as osp
import sys

from plenoctree_tpu_torch import native
from plenoctree_tpu_torch.octree.quantize import compress_tree_npz


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("input", type=str, nargs="+", help="Input npz(s)")
    parser.add_argument("--noquant", action="store_true", help="Disable quantization")
    parser.add_argument("--bits", type=int, default=16, help="Quantization bits (order)")
    parser.add_argument(
        "--out_dir", type=str, default="min_alt", help="Where to write compressed npz"
    )
    parser.add_argument(
        "--overwrite", action="store_true", help="Overwrite existing compressed npz"
    )
    parser.add_argument("--weighted", action="store_true", help="Use weighted median cut")
    parser.add_argument(
        "--sigma_thresh", type=float, default=2.0, help="Kill voxels under this sigma"
    )
    parser.add_argument(
        "--retain", type=int, default=0,
        help="Do not compress first x SH coeffs (quality escape hatch)",
    )
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    print("Quantization", "disabled, only applying deflate" if args.noquant else "enabled")

    for fname in args.input:
        fname_c = osp.join(args.out_dir, osp.basename(fname))
        print("Compressing", fname, "to", fname_c)
        if not args.overwrite and osp.exists(fname_c):
            print(" > skip")
            continue
        did = compress_tree_npz(
            fname, fname_c, bits=args.bits, sigma_thresh=args.sigma_thresh, retain=args.retain,
            weighted=args.weighted, noquant=args.noquant,
        )
        if not did:
            print(" > skip since source already compressed")
            continue
        print(
            " > Size", osp.getsize(fname) // (1024 * 1024), "MB ->",
            osp.getsize(fname_c) // (1024 * 1024), "MB",
        )
    print("native:", native.summary())


if __name__ == "__main__":
    sys.exit(main())
