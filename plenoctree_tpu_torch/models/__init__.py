"""NeRF-SH models: the trunk MLP, the coarse/fine NeRF, and weight carry-across."""
