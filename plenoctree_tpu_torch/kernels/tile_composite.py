"""Tile compositing: the CUDA kernel's wrapper and its plain PyTorch version.

`composite_tiles` is the port of plenoctree_tpu/octree/tile_render.py::
_tile_kernel (csrc/tile_composite.cu). Its arguments keep the JAX p2_args
layout, so one set of phase-1 inputs can feed the TPU kernel, the CUDA
kernel and `composite_tiles_reference`:

  meta [T,1,4] i32 (n_pieces), piece_c0/lo/hi/mask [T,1,ccap] i32,
  o/invd/aux [T,RAYS,4] f32, mdir [T,1,4] f32, basis [T,RAYS,bd] f32,
  soa [n_blk, fields, quantum] f32  ->  out [T,RAYS,8] f32
  (rgb(nc), transmittance exp(-cum), zero pad).

The wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""

import ctypes

import torch

from plenoctree_tpu_torch.kernels._build import load_library

launches = 0  # kernel launches by composite_tiles in this process

_SOURCES = ("tile_composite.cu",)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_MAX_CHANNELS = 7
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
    lib = load_library("tile_composite", _SOURCES)
    if not getattr(lib, "_pn_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pn_tile_composite.restype = i32
        lib.pn_tile_composite.argtypes = (
            [ptr] * 12 + [i32] * 9 + [f32] * 3 + [i32, ptr]
        )
        lib.pn_tile_composite_smem_bytes.restype = ctypes.c_size_t
        lib.pn_tile_composite_smem_bytes.argtypes = [i32] * 5
        lib.pn_cuda_error_string.restype = ctypes.c_char_p
        lib.pn_cuda_error_string.argtypes = [i32]
        lib._pn_bound = True
    return lib


def _check_args(args, soa, basis_dim, n_channels, runrows, quantum):
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
    if not 1 <= n_channels <= _MAX_CHANNELS:
        raise ValueError(f"n_channels must be in [1, {_MAX_CHANNELS}], got {n_channels}")
    if soa.shape[1] < 6 + n_channels * basis_dim + 1:
        raise ValueError(f"soa has {soa.shape[1]} fields, too few for the data layout")


def composite_tiles(
    meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa,
    *, fmt, basis_dim, n_channels, sigma_row, runrows, quantum, step_eps,
    stop_thresh, od_cap,
):
    """Composite every tile's phase-1 pieces; see the module docstring.

    CUDA tensors launch the kernel (csrc/tile_composite.cu); CPU tensors run
    `composite_tiles_reference`. The kernel trusts phase 1's piece
    descriptors to address rows inside `soa`.
    """
    global launches
    args = (meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis)
    kw = dict(
        fmt=fmt, basis_dim=basis_dim, n_channels=n_channels, sigma_row=sigma_row,
        runrows=runrows, quantum=quantum, step_eps=step_eps,
        stop_thresh=stop_thresh, od_cap=od_cap,
    )
    if soa.device.type == "cpu":
        return composite_tiles_reference(*args, soa, **kw)
    if soa.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {soa.device}")
    _check_args(args, soa, basis_dim, n_channels, runrows, quantum)
    lib = build()
    T, rays = o.shape[0], o.shape[1]
    fields = soa.shape[1]
    smem = lib.pn_tile_composite_smem_bytes(rays, basis_dim, fields, runrows, quantum)
    if smem > _MAX_SMEM:
        raise ValueError(f"tile kernel needs {smem} B of shared memory (> {_MAX_SMEM})")
    out = torch.empty((T, rays, 8), dtype=torch.float32, device=soa.device)
    with torch.cuda.device(soa.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pn_tile_composite(
            *(t.data_ptr() for t in args), soa.data_ptr(), out.data_ptr(),
            T, rays, piece_c0.shape[-1], basis_dim, n_channels, sigma_row, fields,
            runrows, quantum, float(step_eps), float(stop_thresh), float(od_cap),
            int(fmt in ("SH", "SG")), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"tile_composite launch failed: CUDA error {rc} "
            f"({lib.pn_cuda_error_string(rc).decode()})"
        )
    launches += 1
    return out


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
    fields = soa.shape[1]
    ccap = piece_c0.shape[-1]
    n_pieces = meta[:, 0, 0].long()
    n_chunks = (n_pieces + G - 1) // G
    max_chunks = int(n_chunks.max()) if T else 0
    oi = o * invd
    dscale, tmin, tmax = aux[..., 0], aux[..., 1], aux[..., 2]
    lane = torch.arange(R, device=dev)
    tie = lane[:, None] < lane[None, :]
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
        sigma = torch.where(live, f[:, :, sigma_row].clamp(min=0.0), 0.0)  # [A, KB, R]
        md = mdir[act, 0][:, None]  # [A, 1, 4]
        key = 0.5 * (
            (f[:, :, 0] + f[:, :, 3]) * md[..., 0:1]
            + (f[:, :, 1] + f[:, :, 4]) * md[..., 1:2]
            + (f[:, :, 2] + f[:, :, 5]) * md[..., 2:3]
        )
        before = (key[..., :, None] < key[..., None, :]) | (
            (key[..., :, None] == key[..., None, :]) & tie
        )
        cmask = gmask[..., 0]
        for g in range(1, G):
            cmask = cmask | gmask[..., g]  # [A, KB]

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
