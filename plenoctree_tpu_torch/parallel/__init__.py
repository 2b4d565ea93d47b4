"""Data parallelism across devices and processes (parallel/mesh.py) and a
local process-group launcher with the data-parallel step check
(parallel/ranks.py)."""

from plenoctree_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_reduce_mean_,
    broadcast_,
    broadcast_params_,
    cli_devices,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    shard_batch,
)
