"""PlenOctree conversion and serving: the tree, the tile renderer and
optimizer, and extraction from a trained NeRF.

`N3Tree` is the port's own copy of the JAX package's numpy class
(svox-compatible `tree.npz`, same keys): both packages load the same files.
"""

from plenoctree_tpu_torch.octree.n3tree import DataFormat, N3Tree  # noqa: F401
