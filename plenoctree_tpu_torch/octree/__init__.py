"""PlenOctree serving: the shared N3Tree contract and the tile renderer.

`N3Tree` is the JAX package's own numpy class (svox-compatible `tree.npz`),
reused as it is rather than copied: both packages load the same files.
"""

from plenoctree_tpu.octree.n3tree import DataFormat, N3Tree  # noqa: F401
