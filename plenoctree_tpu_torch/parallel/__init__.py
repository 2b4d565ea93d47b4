"""Data parallelism across devices and processes (parallel/mesh.py), tensor
parallelism over the "model" axis (parallel/partition.py), and a local
process-group launcher with the train-step checks (parallel/ranks.py)."""

from plenoctree_tpu_torch.parallel import partition  # noqa: F401
from plenoctree_tpu_torch.parallel.mesh import (  # noqa: F401
    Layout,
    Mesh,
    all_gather_rows,
    all_reduce_mean_,
    broadcast_,
    broadcast_params_,
    cli_devices,
    init_distributed,
    init_groups,
    layout,
    make_mesh,
    pad_to_multiple,
    shard_batch,
)
