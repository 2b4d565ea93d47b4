"""plenoctree_tpu_torch — the PyTorch/CUDA port of plenoctree_tpu.

A second package beside the JAX reference (`plenoctree_tpu/`), mirroring its
module paths (`octree/tile_render.py` <-> `plenoctree_tpu_torch/octree/
tile_render.py`). It imports torch and never jax. The only things it takes
from the JAX package are the shared tree contract: the numpy
`plenoctree_tpu.octree.n3tree.N3Tree` (svox-compatible `tree.npz`) and the
ctypes host runtime `plenoctree_tpu.native`.

Kernels: CUDA C++ sources live in `csrc/`, their Python wrappers in
`kernels/`; each wrapper keeps a plain PyTorch version beside it, used for
CPU tensors and as the kernel's oracle.
"""

import torch

__version__ = "0.1.0"

# Full f32 everywhere: phase 1's plane tests, the tree-space transform and
# the SSIM filter mirror JAX sites that ask for precision="highest"; TF32
# (three decimal digits) would flip hit and mask tests at cell boundaries.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
