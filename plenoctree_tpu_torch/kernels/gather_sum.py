"""Sum of table rows over an index stream: the CUDA kernels' wrapper and
their plain PyTorch version.

`gather_sum` is the port of the three gather-probe Pallas kernels of
scripts/bench_gather.py (`pallas_vmem`, `pallas_vmem_tile`) and
scripts/bench_gather2.py (`pallas_run`), csrc/gather_sum.cu:

  idx int32 (any shape, read as the flat stream), table [T, D] f32
  ->  out [groups, D] f32, out[g] = sum of table[idx.flat[p]] over the
      positions p with p % groups == g (groups 1 or 8).

Where the table sits while the rows are gathered (`placement`):
  "sliced"  cut into row slices, one per block's shared memory, the stream
            routed to the slices by a stable counting sort (a table up to the
            card's aggregate shared memory: the Pallas kernels' VMEM table);
  "smem"    the whole table in every block's shared memory (<= 227 KB);
  "l2"      read through L2 (and HBM), UNROLL rows in flight per lane group;
  "auto"    smem where the table fits one block, else sliced where its
            slices fit, else l2.
`plan` sizes each launch; the kernels' sums run in a fixed order, so reruns
are bitwise equal, and `addition_chain` gives a launch's longest f32
addition chain (the tests' and chip_smoke.py's tolerance).

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernels or raises. The kernels trust the indices to lie in
[0, T).
"""

import ctypes

import torch

from plenoctree_tpu_torch.kernels._build import load_library

launches = 0  # gather_sum calls that launched the kernels, in this process

_SOURCES = ("gather_sum.cu",)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_MAX_D = 64
_L2_GROUPS = 256 // 16  # 16-lane row groups per L2 block
_WARPS = 512 // 32  # warps per SMEM / SLICED block
_CHUNK = 8192  # stream positions per routing block (32 per thread)
_CODES = {"l2": 0, "smem": 1, "sliced": 2}
PLACEMENTS = ("auto", "sliced", "smem", "l2")
# A slice's bytes: small enough that two sliced_sum blocks (slice, an 8 KB
# reduction buffer, up to 8.4 KB of bucket offsets) share an SM's 228 KB.
SLICE_MAX_BYTES = 88 * 1024
_SMS = {}  # device index -> multiprocessor count


def build():
    """Compile (once per process) and load the kernel library."""
    lib = load_library("gather_sum", _SOURCES)
    if not getattr(lib, "_pn_bound", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pn_gather_sum.restype = i32
        lib.pn_gather_sum.argtypes = [ptr, i64, ptr] + [i32] * 9 + [ptr, ptr, ptr]
        lib.pn_gather_error_string.restype = ctypes.c_char_p
        lib.pn_gather_error_string.argtypes = [i32]
        lib._pn_bound = True
    return lib


def sm_count(device):
    """The device's multiprocessor count (asked once per device)."""
    i = torch.device(device).index
    i = torch.cuda.current_device() if i is None else i
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _cdiv(a, b):
    return -(-a // b)


def plan(n, T, D, groups=1, placement="auto", sms=132):
    """How a launch over n indices into a [T, D] table is laid out, for a
    card with `sms` multiprocessors: {"placement", "blocks" (l2, smem: the
    blocks, one [groups, D] partial each), "S", "rps" (sliced: S slices of
    rps rows, the last one possibly short), "C" (sliced: routing chunks of
    _CHUNK positions), "ws_ints" (the int32 workspace)}. Raises
    ValueError where the placement cannot hold the table."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    row = D * 4
    smem_fits = T * row <= _MAX_SMEM - 16
    rps = _cdiv(T, 2 * sms)
    sliced_fits = rps * row <= SLICE_MAX_BYTES
    if placement == "auto":
        placement = "smem" if smem_fits else ("sliced" if sliced_fits else "l2")
    gd = groups * D
    if placement == "smem":
        if not smem_fits:
            raise ValueError(f"a {T}x{D} f32 table needs {T * row} B of shared memory (> {_MAX_SMEM - 16})")
        blocks = max(1, min(sms, _cdiv(n, 32 * _WARPS)))  # one 227 KB block per SM
        return dict(placement=placement, blocks=blocks, S=0, rps=0, C=0, ws_ints=blocks * gd)
    if placement == "l2":
        blocks = max(1, min(8 * sms, _cdiv(n, _L2_GROUPS)))
        return dict(placement=placement, blocks=blocks, S=0, rps=0, C=0, ws_ints=blocks * gd)
    if not sliced_fits:
        raise ValueError(f"a {T}x{D} f32 table in {2 * sms} slices needs {rps * row} B of shared "
                         f"memory a slice (> {SLICE_MAX_BYTES})")
    if n >= 2**31:
        raise ValueError(f"the sliced placement routes at most 2^31 - 1 indices, got {n}")
    S = _cdiv(T, rps)
    B = groups * S
    C = _cdiv(n, _CHUNK)
    return dict(placement=placement, blocks=0, S=S, rps=rps, C=C, ws_ints=B * C + B + n + S * gd)


def addition_chain(idx, table, groups=1, placement="auto", sms=132):
    """The longest chain of f32 additions behind one output of a launch on
    these inputs. L2: the rows one lane group adds in turn, then the
    block's groups of its residue. SMEM and SLICED: the rows one slot adds
    (4 of each 32-entry tile its warp takes), then (where a warp's slots
    share a residue: SMEM with G = 1, every SLICED bucket) the lane's 4
    slots and its half-warp partner, then the block's warps of the residue
    (16, or 16 / G for SLICED, whose warps split over the G buckets). Then
    the finish pass (a strided run per lane, a 5-step shuffle tree). For
    the sliced placement the longest bucket counts, from the data."""
    n, (T, D) = idx.numel(), table.shape
    p = plan(n, T, D, groups, placement, sms)
    if p["placement"] == "l2":
        return _cdiv(n, _L2_GROUPS * p["blocks"]) + _L2_GROUPS // groups + _cdiv(p["blocks"], 32) + 5
    if p["placement"] == "smem":
        slot = 4 * _cdiv(_cdiv(n, 32), _WARPS * p["blocks"])
        return slot + (4 if groups == 1 else 0) + _WARPS + _cdiv(p["blocks"], 32) + 5
    pos = torch.arange(n, device=idx.device)
    bins = (pos % groups) * p["S"] + idx.reshape(-1).long() // p["rps"]
    longest = int(torch.bincount(bins, minlength=groups * p["S"]).max())
    w = _WARPS // groups  # warps per bucket
    return 4 * _cdiv(_cdiv(longest, 32), w) + 4 + w + _cdiv(p["S"], 32) + 5


def gather_sum_reference(idx, table, groups=1):
    """The plain version: one row gather, then a sum per residue class."""
    D = table.shape[1]
    return table.index_select(0, idx.reshape(-1)).reshape(-1, groups, D).sum(0)


def gather_sum(idx, table, groups=1, unroll=1, placement="auto"):
    """out [groups, D] = sums of table rows over idx's flat stream by
    position mod groups; see the module docstring.

    CUDA tensors launch the kernels (`placement` as above; `unroll` rows in
    flight per lane group, 1 or 8); CPU tensors run `gather_sum_reference`.
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
    if unroll not in (1, 8):
        raise ValueError(f"unroll must be 1 or 8, got {unroll}")
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
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
    if table.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary (float4 rows)")
    n = idx.numel()
    out = torch.empty((groups, D), dtype=torch.float32, device=table.device)
    if n == 0:
        return out.zero_()
    p = plan(n, T, D, groups, placement, sm_count(table.device))
    lib = build()
    ws = torch.empty(p["ws_ints"], dtype=torch.int32, device=table.device)
    err = lib.pn_gather_sum(
        idx.data_ptr(), n, table.data_ptr(), T, D, groups, unroll, _CODES[p["placement"]],
        p["S"], p["rps"], p["C"], p["blocks"], ws.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"gather_sum kernel launch failed: {lib.pn_gather_error_string(err).decode()}")
    launches += 1
    return out
