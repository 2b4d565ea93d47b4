"""Sum of table rows over an index stream: the CUDA kernel's wrapper and its
plain PyTorch version.

`gather_sum` is the port of the three gather-probe Pallas kernels of
scripts/bench_gather.py (`pallas_vmem`, `pallas_vmem_tile`) and
scripts/bench_gather2.py (`pallas_run`), csrc/gather_sum.cu:

  idx int32 (any shape, read as the flat stream), table [T, D] f32
  ->  out [groups, D] f32, out[g] = sum of table[idx.flat[p]] over the
      positions p with p % groups == g (groups 1 or 8).

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. The kernel trusts the indices to lie in
[0, T).
"""

import ctypes

import torch

from plenoctree_tpu_torch.kernels._build import load_library

launches = 0  # kernel launches by gather_sum in this process

_SOURCES = ("gather_sum.cu",)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_MAX_D = 64


def build():
    """Compile (once per process) and load the kernel library."""
    lib = load_library("gather_sum", _SOURCES)
    if not getattr(lib, "_pn_bound", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pn_gather_sum.restype = i32
        lib.pn_gather_sum.argtypes = [ptr, i64, ptr] + [i32] * 5 + [ptr, i32, ptr, ptr]
        lib.pn_gather_sum_blocks.restype = i32
        lib.pn_gather_sum_blocks.argtypes = [i64, i32]
        lib.pn_gather_error_string.restype = ctypes.c_char_p
        lib.pn_gather_error_string.argtypes = [i32]
        lib._pn_bound = True
    return lib


def gather_sum_reference(idx, table, groups=1):
    """The plain version: one row gather, then a sum per residue class."""
    D = table.shape[1]
    return table.index_select(0, idx.reshape(-1)).reshape(-1, groups, D).sum(0)


def gather_sum(idx, table, groups=1, unroll=1, smem_table=False):
    """out [groups, D] = sums of table rows over idx's flat stream by
    position mod groups; see the module docstring.

    CUDA tensors launch the kernel (`unroll` rows in flight per lane group;
    `smem_table` copies the table into each block's shared memory first);
    CPU tensors run `gather_sum_reference`.
    """
    global launches
    if table.dim() != 2:
        raise ValueError(f"table must be [T, D], got shape {tuple(table.shape)}")
    if groups not in (1, 8):
        raise ValueError(f"groups must be 1 or 8, got {groups}")
    if idx.numel() % groups:
        raise ValueError(f"the stream length {idx.numel()} is not a multiple of groups={groups}")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if table.device.type == "cpu":
        return gather_sum_reference(idx, table, groups)
    if table.device.type != "cuda":
        raise ValueError(f"gather_sum: unsupported device {table.device}")
    T, D = table.shape
    if idx.dtype != torch.int32 or table.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and table float32, got {idx.dtype}, {table.dtype}")
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("idx and table must be contiguous")
    if D % 4 or not 4 <= D <= _MAX_D:
        raise ValueError(f"D must be a multiple of 4 in [4, {_MAX_D}], got {D}")
    if unroll not in (1, 8):
        raise ValueError(f"unroll must be 1 or 8, got {unroll}")
    if smem_table and T * D * 4 > _MAX_SMEM:
        raise ValueError(f"a {T}x{D} f32 table needs {T * D * 4} B of shared memory (> {_MAX_SMEM})")
    lib = build()
    n = idx.numel()
    blocks = lib.pn_gather_sum_blocks(n, int(smem_table))
    partial = torch.empty((blocks, groups, D), dtype=torch.float32, device=table.device)
    out = torch.empty((groups, D), dtype=torch.float32, device=table.device)
    err = lib.pn_gather_sum(
        idx.data_ptr(), n, table.data_ptr(), T, D, groups, unroll, int(smem_table),
        partial.data_ptr(), blocks, out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gather_sum kernel launch failed: {lib.pn_gather_error_string(err).decode()}")
    launches += 1
    return out
