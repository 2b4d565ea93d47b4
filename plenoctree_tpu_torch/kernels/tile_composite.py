"""Tile compositing and its backward: the CUDA kernels' wrappers and their
plain PyTorch versions.

`composite_tiles` is the port of plenoctree_tpu/octree/tile_render.py::
_tile_kernel and `composite_tiles_bwd` the port of plenoctree_tpu/octree/
tile_opt.py::_tile_bwd_kernel (both in csrc/tile_composite.cu). Their
arguments keep the JAX p2_args layout, so one set of phase-1 inputs can feed
the TPU kernels, the CUDA kernels and the plain versions:

  meta [T,1,4] i32 (n_pieces), piece_c0/lo/hi/mask [T,1,ccap] i32,
  o/invd/aux [T,RAYS,4] f32, mdir [T,1,4] f32, basis [T,RAYS,bd] f32,
  soa [n_blk, fields, quantum] f32  ->  out [T,RAYS,8] f32
  (rgb(nc), transmittance exp(-cum), zero pad);
  backward: the same, plus out and its cotangent g [T,RAYS,8] f32
  ->  gsoa, the shape of soa (the gradient of sum(g * out) w.r.t. soa).

The wrappers run the plain versions for CPU tensors only; for CUDA tensors
they launch the kernel or raise.
"""

import ctypes

import torch

from plenoctree_tpu_torch.kernels._build import load_library
from plenoctree_tpu_torch.utils import tracing

launches = 0  # kernel launches by composite_tiles in this process
bwd_launches = 0  # kernel launches by composite_tiles_bwd in this process
# Of `launches`, those of an instantiation that holds each ray's basis in
# registers (csrc/tile_composite.cu picks it by the colour head's shape).
reg_basis_launches = 0

_SOURCES = ("tile_composite.cu",)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_MAX_CHANNELS = 7
_MAX_RUNROWS = 256  # the kernels sort a chunk's live rows in one warp, 8 per lane
# The backward keeps a chunk gradient per chunk in flight: two of them at
# runrows 256 would not fit in a block's shared memory.
_MAX_BWD_RUNROWS = 128
_MAX_BWD_BASIS = 32  # the backward's tensor-core products take the basis in two m16 tiles
# The plain version does the state-independent work (row gathers, hit tests,
# precedence, decode) for as many chunks at once as keep a [tiles, chunks,
# rays, runrows] tensor within this many elements.
_BATCH_ELEMS = 1 << 22


def _fma(a, b, c):
    """a*b + c rounded once to a's dtype, like a fused multiply-add (the
    product of two f32 values is exact in f64). XLA contracts `a*b - c` and
    `a*b + c` into FMAs on the CPU and the TPU, and the CUDA kernel uses
    fmaf for its slab test, so mirroring them keeps all three rounding
    alike."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    return (a.double() * f64(b) + f64(c)).to(a.dtype)


def build():
    """Compile (once per process) and load the kernel library."""
    return _bind(load_library("tile_composite", _SOURCES))


def _bind(lib):
    """Set the C signatures on a build of csrc/tile_composite.cu (this tree's
    or, for bench_tile, another's with the same C interface)."""
    if not getattr(lib, "_pn_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pn_tile_composite.restype = i32
        lib.pn_tile_composite.argtypes = (
            [ptr] * 12 + [i32] * 9 + [f32] * 3 + [i32, ptr]
        )
        lib.pn_tile_composite_smem_bytes.restype = ctypes.c_size_t
        lib.pn_tile_composite_smem_bytes.argtypes = [i32] * 5
        lib.pn_tile_composite_bwd.restype = i32
        lib.pn_tile_composite_bwd.argtypes = [ptr] * 14 + [i32] * 9 + [f32, i32, ptr]
        lib.pn_tile_composite_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.pn_tile_composite_bwd_smem_bytes.argtypes = [i32] * 6
        if hasattr(lib, "pn_tile_bwd_counts"):
            lib.pn_tile_bwd_counts.restype = i32
            lib.pn_tile_bwd_counts.argtypes = [ptr, i32]
        if hasattr(lib, "pn_tile_composite_reg_basis"):
            lib.pn_tile_composite_reg_basis.restype = i32
            lib.pn_tile_composite_reg_basis.argtypes = [i32] * 3
            lib.pn_tile_composite_occupancy.restype = i32
            lib.pn_tile_composite_occupancy.argtypes = [i32] * 5 + [ptr]
        lib.pn_cuda_error_string.restype = ctypes.c_char_p
        lib.pn_cuda_error_string.argtypes = [i32]
        lib._pn_bound = True
    return lib


def bwd_atomic_counts(reset=False):
    """(float4 atomics, non-zero floats they carried) that the backward
    kernel has added into gradient soas since the last reset."""
    lib = build()
    out = (ctypes.c_ulonglong * 2)()
    rc = lib.pn_tile_bwd_counts(ctypes.cast(out, ctypes.c_void_p), int(reset))
    _raise_on(lib, rc, "pn_tile_bwd_counts")
    return int(out[0]), int(out[1])


def forward_occupancy(rays, basis_dim, n_channels, runrows, quantum):
    """The forward instantiation that composite_tiles would launch for these
    shapes, as the card holds it: {"blocks_per_sm" (at its shared memory),
    "registers" (a thread), "local_bytes" (a thread: spills), "smem_bytes" (a
    block), "reg_basis" (1: the ray's basis in registers)}."""
    lib = build()
    out = (ctypes.c_int * 5)()
    rc = lib.pn_tile_composite_occupancy(rays, basis_dim, n_channels, runrows, quantum,
                                         ctypes.cast(out, ctypes.c_void_p))
    _raise_on(lib, rc, "pn_tile_composite_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "smem_bytes", "reg_basis"),
                    map(int, out)))


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: CUDA error {rc} ({lib.pn_cuda_error_string(rc).decode()})"
        )


def _check_args(args, soa, basis_dim, n_channels, sigma_row, runrows, quantum):
    (meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis) = args
    dev = soa.device
    T, rays = o.shape[0], o.shape[1]
    ccap = piece_c0.shape[-1]
    want = {
        "meta": (meta, torch.int32, (T, 1, 4)),
        "piece_c0": (piece_c0, torch.int32, (T, 1, ccap)),
        "piece_lo": (piece_lo, torch.int32, (T, 1, ccap)),
        "piece_hi": (piece_hi, torch.int32, (T, 1, ccap)),
        "piece_mask": (piece_mask, torch.int32, (T, 1, ccap)),
        "o": (o, torch.float32, (T, rays, 4)),
        "invd": (invd, torch.float32, (T, rays, 4)),
        "aux": (aux, torch.float32, (T, rays, 4)),
        "mdir": (mdir, torch.float32, (T, 1, 4)),
        "basis": (basis, torch.float32, (T, rays, basis_dim)),
        "soa": (soa, torch.float32, (soa.shape[0], soa.shape[1], quantum)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, soa on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rays % 32 or rays > 1024:
        raise ValueError(f"rays per tile must be a multiple of 32 up to 1024, got {rays}")
    if quantum % 4 or runrows % quantum or runrows & (runrows - 1):
        raise ValueError(
            f"runrows ({runrows}) must be a power of two and a multiple of quantum "
            f"({quantum}), itself a multiple of 4"
        )
    if runrows > _MAX_RUNROWS:
        raise ValueError(f"the CUDA kernels take runrows up to {_MAX_RUNROWS}, got {runrows}")
    if not 1 <= n_channels <= _MAX_CHANNELS:
        raise ValueError(f"n_channels must be in [1, {_MAX_CHANNELS}], got {n_channels}")
    if soa.shape[1] < 6 + n_channels * basis_dim + 1:
        raise ValueError(f"soa has {soa.shape[1]} fields, too few for the data layout")
    # The kernels stage the first sigma_row + 1 rows of each piece and read
    # the colour rows below sigma_row.
    if sigma_row != 6 + n_channels * basis_dim:
        raise ValueError(
            f"sigma_row must follow the colour rows (6 + {n_channels} * {basis_dim}), got {sigma_row}"
        )
    if soa.data_ptr() % 16:
        raise ValueError("soa must start on a 16-byte boundary (its blocks are bulk-copied)")


def composite_tiles(
    meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa,
    *, fmt, basis_dim, n_channels, sigma_row, runrows, quantum, step_eps,
    stop_thresh, od_cap,
):
    """Composite every tile's phase-1 pieces; see the module docstring.

    CUDA tensors launch the kernel (csrc/tile_composite.cu); CPU tensors run
    `composite_tiles_reference`. The kernel trusts phase 1's piece
    descriptors to address rows inside `soa`. Traced as `tile.composite`; on
    CUDA with the count `reg_basis`, 1 where the instantiation launched
    holds each ray's basis in registers, else 0.
    """
    global launches, reg_basis_launches
    args = (meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis)
    kw = dict(
        fmt=fmt, basis_dim=basis_dim, n_channels=n_channels, sigma_row=sigma_row,
        runrows=runrows, quantum=quantum, step_eps=step_eps,
        stop_thresh=stop_thresh, od_cap=od_cap,
    )
    if soa.device.type == "cpu":
        with tracing.span("tile.composite"):
            return composite_tiles_reference(*args, soa, **kw)
    if soa.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {soa.device}")
    lib = build()
    reg = lib.pn_tile_composite_reg_basis(basis_dim, n_channels, quantum)
    with tracing.span("tile.composite", reg_basis=reg):
        _check_args(args, soa, basis_dim, n_channels, sigma_row, runrows, quantum)
        out = _launch_fwd(lib, args, soa, **kw)
    launches += 1
    reg_basis_launches += reg
    return out


def _launch_fwd(lib, args, soa, *, fmt, basis_dim, n_channels, sigma_row, runrows, quantum,
                step_eps, stop_thresh, od_cap):
    """One launch of `lib`'s forward kernel on checked arguments."""
    T, rays = args[5].shape[0], args[5].shape[1]
    fields = soa.shape[1]
    # The kernel stages each piece's first sigma_row + 1 rows (the soa's
    # padding rows past sigma are not copied).
    smem = lib.pn_tile_composite_smem_bytes(rays, basis_dim, sigma_row + 1, runrows, quantum)
    if smem > _MAX_SMEM:
        raise ValueError(f"tile kernel needs {smem} B of shared memory (> {_MAX_SMEM})")
    out = torch.empty((T, rays, 8), dtype=torch.float32, device=soa.device)
    with torch.cuda.device(soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pn_tile_composite(
            *(t.data_ptr() for t in args), soa.data_ptr(), out.data_ptr(),
            T, rays, args[1].shape[-1], basis_dim, n_channels, sigma_row, fields,
            runrows, quantum, float(step_eps), float(stop_thresh), float(od_cap),
            int(fmt in ("SH", "SG")), stream,
        )
    _raise_on(lib, rc, "tile_composite launch")
    return out


def _gather_chunks(
    act, k, KB, n_pieces, piece_c0, piece_lo, piece_hi, piece_mask, soa, mdir, quantum, G,
):
    """Chunks k .. k+KB-1 of the tiles `act`, as the TPU kernels see them.

    Returns (valid [A, KB, G] piece slots in use, c0 [A, KB, G] row starts,
    live [A, KB, R] rows inside their run, f [A, KB, fields, R] the staged
    soa rows, before [A, KB, R, R] the within-chunk precedence
    `key_i < key_j | (key_i == key_j & i < j)` with key = 0.5 (lo + hi) .
    mdir, cmask [A, KB] the OR of the chunk's quad-group masks)."""
    dev = soa.device
    A = act.numel()
    R = G * quantum
    fields = soa.shape[1]
    ccap = piece_c0.shape[-1]
    slot = (k + torch.arange(KB, device=dev))[:, None] * G + torch.arange(G, device=dev)  # [KB, G]
    valid = slot[None] < n_pieces[act, None, None]  # [A, KB, G]
    slot_c = slot.clamp(max=ccap - 1)
    c0 = piece_c0[act, 0][:, slot_c].long()  # [A, KB, G]
    lo = torch.where(valid, piece_lo[act, 0][:, slot_c], 0)
    hi = torch.where(valid, piece_hi[act, 0][:, slot_c], 0)
    gmask = torch.where(valid, piece_mask[act, 0][:, slot_c], 0)
    rowid = c0[..., None] + torch.arange(quantum, device=dev)  # [A, KB, G, q]
    live = ((rowid >= lo[..., None]) & (rowid < hi[..., None])).reshape(A, KB, R)
    f = soa[c0 // quantum].permute(0, 1, 3, 2, 4).reshape(A, KB, fields, R)
    md = mdir[act, 0][:, None]  # [A, 1, 4]
    key = 0.5 * (
        (f[:, :, 0] + f[:, :, 3]) * md[..., 0:1]
        + (f[:, :, 1] + f[:, :, 4]) * md[..., 1:2]
        + (f[:, :, 2] + f[:, :, 5]) * md[..., 2:3]
    )
    lane = torch.arange(R, device=dev)
    tie = lane[:, None] < lane[None, :]
    before = (key[..., :, None] < key[..., None, :]) | (
        (key[..., :, None] == key[..., None, :]) & tie
    )
    cmask = gmask[..., 0]
    for g in range(1, G):
        cmask = cmask | gmask[..., g]  # [A, KB]
    return valid, c0, live, f, before, cmask


def composite_tiles_reference(
    meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa,
    *, fmt, basis_dim, n_channels, sigma_row, runrows, quantum, step_eps,
    stop_thresh, od_cap,
):
    """Plain PyTorch version of the tile kernel (same signature and result).

    Chunks hold G = runrows/quantum pieces each. For a batch of chunks, over
    the tiles that still have pieces and are not saturated, the pieces' rows
    expand into dense [T, chunks, R] row tensors, and the within-chunk
    occlusion is the masked precedence matmul of the TPU kernel
    (`before[i, j] = key_i < key_j | (key_i == key_j & i < j)`, in f32).
    The ray state (optical depth, colour) then advances chunk by chunk;
    quad groups whose mask bit is clear or whose rays are all past od_cap
    keep their state, as on the TPU.
    """
    dev = soa.device
    f32 = soa.dtype
    T, rays = o.shape[0], o.shape[1]
    R = runrows
    G = runrows // quantum
    gsz = rays // 4
    nc, bd = n_channels, basis_dim
    n_pieces = meta[:, 0, 0].long()
    n_chunks = (n_pieces + G - 1) // G
    max_chunks = int(n_chunks.max()) if T else 0
    oi = o * invd
    dscale, tmin, tmax = aux[..., 0], aux[..., 1], aux[..., 2]
    grp = torch.arange(rays, device=dev) // gsz
    cum = torch.zeros(T, rays, dtype=f32, device=dev)
    acc = torch.zeros(T, rays, nc, dtype=f32, device=dev)
    sigmoid = fmt in ("SH", "SG")

    k = 0
    while k < max_chunks:
        saturated = (cum > od_cap).all(dim=1)
        act = torch.nonzero((n_chunks > k) & ~saturated).squeeze(1)
        if act.numel() == 0:
            break
        A = act.numel()
        KB = max(1, min(max_chunks - k, _BATCH_ELEMS // (A * rays * R)))
        _, _, live, f, before, cmask = _gather_chunks(
            act, k, KB, n_pieces, piece_c0, piece_lo, piece_hi, piece_mask, soa, mdir,
            quantum, G,
        )
        sigma = torch.where(live, f[:, :, sigma_row].clamp(min=0.0), 0.0)  # [A, KB, R]

        inv = invd[act][:, None]  # [A, 1, rays, 4]
        oia = oi[act][:, None]
        tn = tf = None
        for a in range(3):
            iv = inv[..., a : a + 1]
            t1 = _fma(f[:, :, a][:, :, None, :], iv, -oia[..., a : a + 1])
            t2 = _fma(f[:, :, 3 + a][:, :, None, :], iv, -oia[..., a : a + 1])
            tn_a = torch.minimum(t1, t2)
            tf_a = torch.maximum(t1, t2)
            tn = tn_a if tn is None else torch.maximum(tn, tn_a)
            tf = tf_a if tf is None else torch.minimum(tf, tf_a)
        entry = torch.maximum(tn, tmin[act][:, None, :, None])
        hit = (tf > entry) & (entry <= tmax[act][:, None, :, None])
        sdt = torch.where(
            hit, sigma[:, :, None, :] * (tf - entry + step_eps) * dscale[act][:, None, :, None], 0.0
        )  # [A, KB, rays, R]
        front = torch.matmul(sdt, before.to(f32))  # optical depth in front, within a chunk
        bas = basis[act][:, None]  # [A, 1, rays, bd]
        rgb = []
        for c in range(nc):
            raw = torch.matmul(bas, f[:, :, 6 + c * bd : 6 + (c + 1) * bd])  # [A, KB, rays, R]
            rgb.append(0.5 * torch.tanh(0.5 * raw) + 0.5 if sigmoid else raw)
        fade = 1.0 - torch.exp(-sdt)

        cum_a, acc_a = cum[act], acc[act]
        for j in range(KB):
            light = torch.exp(-(cum_a[:, :, None] + front[:, j]))
            alive = light > stop_thresh
            contrib = torch.where(alive, light * fade[:, j], 0.0)
            acc_add = torch.stack([(contrib * x[:, j]).sum(-1) for x in rgb], -1)
            cum_add = torch.where(alive, sdt[:, j], 0.0).sum(-1)
            group_min = cum_a.reshape(A, 4, gsz).amin(-1)
            on = (((cmask[:, j, None] >> grp[None, :]) & 1) == 1) & (group_min[:, grp] <= od_cap)
            cum_a = torch.where(on, cum_a + cum_add, cum_a)
            acc_a = torch.where(on[..., None], acc_a + acc_add, acc_a)
        cum[act], acc[act] = cum_a, acc_a
        k += KB

    out = torch.zeros(T, rays, 8, dtype=f32, device=dev)
    out[..., :nc] = acc
    out[..., nc] = torch.exp(-cum)
    return out


def composite_tiles_bwd(
    meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa, out, g,
    *, fmt, basis_dim, n_channels, sigma_row, runrows, quantum, step_eps,
):
    """Gradient of sum(g * out) with respect to soa, where out is the tile
    kernel's exact-mode output (stop_thresh 0, no saturation exits) on the
    same arguments; see the module docstring.

    CUDA tensors launch the kernel (csrc/tile_composite.cu,
    `tile_composite_bwd_kernel`); CPU tensors run
    `composite_tiles_bwd_reference`. The kernel adds each chunk's gradients
    into the result with float atomics, whose order changes from run to run:
    two runs agree to f32 summation-order rounding, not bit for bit. Traced
    as `tile.composite_bwd` (under autograd, on its worker thread: no parent).
    """
    global bwd_launches
    args = (meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis)
    kw = dict(
        fmt=fmt, basis_dim=basis_dim, n_channels=n_channels, sigma_row=sigma_row,
        runrows=runrows, quantum=quantum, step_eps=step_eps,
    )
    with tracing.span("tile.composite_bwd"):
        if soa.device.type == "cpu":
            return composite_tiles_bwd_reference(*args, soa, out, g, **kw)
        if soa.device.type != "cuda":
            raise ValueError(f"composite_tiles_bwd: unsupported device {soa.device}")
        _check_args(args, soa, basis_dim, n_channels, sigma_row, runrows, quantum)
        T, rays = o.shape[0], o.shape[1]
        for name, t in (("out", out), ("g", g)):
            if (t.device != soa.device or t.dtype != torch.float32
                    or tuple(t.shape) != (T, rays, 8)):
                raise ValueError(
                    f"{name} must be a float32 [{T}, {rays}, 8] tensor on {soa.device}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if basis_dim > _MAX_BWD_BASIS or runrows > _MAX_BWD_RUNROWS:
            raise ValueError(
                f"the CUDA tile backward takes basis_dim up to {_MAX_BWD_BASIS} and runrows up "
                f"to {_MAX_BWD_RUNROWS}, got {basis_dim} and {runrows}"
            )
        gsoa = _launch_bwd(build(), args, soa, out, g, **kw)
    bwd_launches += 1
    return gsoa


def _launch_bwd(lib, args, soa, out, g, *, fmt, basis_dim, n_channels, sigma_row, runrows,
                quantum, step_eps):
    """One launch of `lib`'s backward kernel on checked arguments."""
    T, rays = args[5].shape[0], args[5].shape[1]
    fields = soa.shape[1]
    smem = lib.pn_tile_composite_bwd_smem_bytes(rays, basis_dim, n_channels, sigma_row + 1,
                                                runrows, quantum)
    if smem > _MAX_SMEM:
        raise ValueError(f"tile backward kernel needs {smem} B of shared memory (> {_MAX_SMEM})")
    gsoa = torch.zeros_like(soa)
    with torch.cuda.device(soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pn_tile_composite_bwd(
            *(t.data_ptr() for t in args), soa.data_ptr(), out.data_ptr(), g.data_ptr(),
            gsoa.data_ptr(), T, rays, args[1].shape[-1], basis_dim, n_channels, sigma_row,
            fields, runrows, quantum, float(step_eps), int(fmt in ("SH", "SG")), stream,
        )
    _raise_on(lib, rc, "tile_composite_bwd launch")
    return gsoa


def _slab_bwd(box, o, invd):
    """The backward's slab test, `(box - o) * invd` as the JAX backward
    writes it (the forward's is the FMA form `box*invd - o*invd`)."""
    return (box - o) * invd


def composite_tiles_bwd_reference(
    meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa, out, g,
    *, fmt, basis_dim, n_channels, sigma_row, runrows, quantum, step_eps,
):
    """Plain PyTorch version of the tile backward (same signature and result).

    The forward replayed in its chunk order, with no autograd graph (the
    identity of plenoctree_tpu/octree/tile_opt.py): for hit i of a ray,
        dL/dsdt_i = gsum_i light_i exp(-sdt_i) - suffix_i,
        suffix_i = T_all - prefix_i - e_i,  e_i = gsum_i contrib_i,
    with gsum = sum_c g_c rgb_c, T_all = sum_{c <= nc} g_c out_c from the
    forward output, and prefix_i the sum of e over the hits in front of i
    (earlier chunks, then the within-chunk precedence matmul). The sigma
    row's gradient is sum_rays dL/dsdt dtv where sigma > 0; a colour row's
    sum_rays basis g_c contrib rgb_c (1 - rgb_c) (SH/SG) or basis g_c
    contrib (RGBA); geometry rows get none. The slab test is the JAX
    backward's `(box - o) * invd` (the forward's is the FMA form), and a
    quad group whose chunk-mask bit is clear is skipped. Chunks are batched
    as in `composite_tiles_reference`; each chunk's row gradients are added
    into its pieces' soa blocks with index_add_.
    """
    dev = soa.device
    f32 = soa.dtype
    T, rays = o.shape[0], o.shape[1]
    R = runrows
    G = runrows // quantum
    gsz = rays // 4
    nc, bd = n_channels, basis_dim
    fields = soa.shape[1]
    n_pieces = meta[:, 0, 0].long()
    n_chunks = (n_pieces + G - 1) // G
    max_chunks = int(n_chunks.max()) if T else 0
    dscale, tmin, tmax = aux[..., 0], aux[..., 1], aux[..., 2]
    grp = torch.arange(rays, device=dev) // gsz
    t_all = (g[..., : nc + 1] * out[..., : nc + 1]).sum(-1)  # [T, rays]
    cum = torch.zeros(T, rays, dtype=f32, device=dev)
    pref = torch.zeros(T, rays, dtype=f32, device=dev)
    gsoa = torch.zeros_like(soa)
    sigmoid = fmt in ("SH", "SG")

    k = 0
    while k < max_chunks:
        act = torch.nonzero(n_chunks > k).squeeze(1)
        A = act.numel()
        KB = max(1, min(max_chunks - k, _BATCH_ELEMS // (A * rays * R)))
        valid, c0, live, f, before, cmask = _gather_chunks(
            act, k, KB, n_pieces, piece_c0, piece_lo, piece_hi, piece_mask, soa, mdir,
            quantum, G,
        )
        before = before.to(f32)
        sigma = f[:, :, sigma_row].clamp(min=0.0)  # [A, KB, R]

        o_a = o[act][:, None]  # [A, 1, rays, 4]
        inv = invd[act][:, None]
        tn = tf = None
        for a in range(3):
            iv = inv[..., a : a + 1]
            t1 = _slab_bwd(f[:, :, a][:, :, None, :], o_a[..., a : a + 1], iv)
            t2 = _slab_bwd(f[:, :, 3 + a][:, :, None, :], o_a[..., a : a + 1], iv)
            tn_a = torch.minimum(t1, t2)
            tf_a = torch.maximum(t1, t2)
            tn = tn_a if tn is None else torch.maximum(tn, tn_a)
            tf = tf_a if tf is None else torch.minimum(tf, tf_a)
        entry = torch.maximum(tn, tmin[act][:, None, :, None])
        hit = (tf > entry) & (entry <= tmax[act][:, None, :, None]) & live[:, :, None, :]
        dtv = torch.where(hit, (tf - entry + step_eps) * dscale[act][:, None, :, None], 0.0)
        sdt = sigma[:, :, None, :] * dtv  # [A, KB, rays, R]
        front = torch.matmul(sdt, before)
        esdt = torch.exp(-sdt)
        bas = basis[act][:, None]  # [A, 1, rays, bd]
        gout = g[act]  # [A, rays, 8]
        rgb = []
        gsum = None
        for c in range(nc):
            raw = torch.matmul(bas, f[:, :, 6 + c * bd : 6 + (c + 1) * bd])  # [A, KB, rays, R]
            rgb.append(0.5 * torch.tanh(0.5 * raw) + 0.5 if sigmoid else raw)
            term = gout[:, None, :, c : c + 1] * rgb[c]
            gsum = term if gsum is None else gsum + term

        cum_a, pref_a, tall_a = cum[act], pref[act], t_all[act]
        contribs, dsdts, ons = [], [], []
        for j in range(KB):
            on = ((cmask[:, j, None] >> grp[None, :]) & 1) == 1  # [A, rays]
            light = torch.exp(-(cum_a[:, :, None] + front[:, j]))
            contrib = light * (1.0 - esdt[:, j])
            e = gsum[:, j] * contrib
            p_before = pref_a[:, :, None] + torch.matmul(e, before[:, j])
            suffix = tall_a[:, :, None] - p_before - e
            dsdts.append(torch.where(hit[:, j], gsum[:, j] * light * esdt[:, j] - suffix, 0.0))
            contribs.append(contrib)
            ons.append(on)
            cum_a = torch.where(on, cum_a + sdt[:, j].sum(-1), cum_a)
            pref_a = torch.where(on, pref_a + e.sum(-1), pref_a)
        cum[act], pref[act] = cum_a, pref_a

        on = torch.stack(ons, 1)[..., None]  # [A, KB, rays, 1]
        use = hit & on
        contrib = torch.stack(contribs, 1)
        dsdt = torch.stack(dsdts, 1)
        grow = torch.zeros(A, KB, fields, R, dtype=f32, device=dev)
        grow[:, :, sigma_row] = torch.where(on, dsdt * dtv, 0.0).sum(2) * (sigma > 0.0)
        for c in range(nc):
            gc = gout[:, None, :, c : c + 1]
            draw = gc * contrib * rgb[c] * (1.0 - rgb[c]) if sigmoid else gc * contrib
            draw = torch.where(use, draw, 0.0)
            grow[:, :, 6 + c * bd : 6 + (c + 1) * bd] = torch.matmul(bas.transpose(-1, -2), draw)
        blocks = grow.reshape(A, KB, fields, G, quantum).permute(0, 1, 3, 2, 4)
        gsoa.index_add_(0, (c0 // quantum)[valid], blocks[valid])
        k += KB
    return gsoa
