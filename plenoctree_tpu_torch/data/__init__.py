"""Host-side data: rays, poses, the synthetic scene and dataset loaders."""

from plenoctree_tpu_torch.data.datasets import get_dataset  # noqa: F401
from plenoctree_tpu_torch.data.rays import Rays  # noqa: F401
