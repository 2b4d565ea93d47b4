"""Total wall-clock hours of train runs from their timings.txt.

Port of plenoctree_tpu's nerf_sh/parse_timing.py shim (which calls
plenoctree_tpu/utils/io.py::timings_total_hours): prints one
`<path> <hours> hours` line per file.

Usage:
  python -m plenoctree_tpu_torch.cli.parse_timing <train_dir>/timings.txt ...
"""

import sys

from plenoctree_tpu_torch.utils.io import timings_total_hours


def main(argv=None):
    for path in sys.argv[1:] if argv is None else argv:
        print(path, f"{timings_total_hours(path):.2f} hours")


if __name__ == "__main__":
    main()
