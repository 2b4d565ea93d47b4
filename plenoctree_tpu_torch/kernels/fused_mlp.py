"""Fused NeRF trunk: the CUDA kernels' wrappers and their plain PyTorch versions.

Port of plenoctree_tpu/kernels/fused_mlp.py with both of its variants.
`fused_trunk` runs the whole trunk + fused sigma/rgb head (csrc/fused_mlp.cu,
forward kernel) and `fused_trunk_bwd` its backward (recompute + reverse walk
+ weight gradients); `FusedTrunkFn.apply(meta, x, basis, *flat_w)` ties them
into autograd. Both take the JAX package's `pack_params_traced` layout:

  flat_w = [w_0 [d_in, W], b_0 [1, W], ..., w_head [K, 1 + C], b_head [1, 1 + C]]

(f32, flax's [in, out] kernels in call order; the head is [W_sigma | W_rgb])
and its `meta`. Without variants x is [N, d_in] encoded points, fed to the
kernel as bf16 as the JAX `prep` does. The variants:

  * meta["posenc"] = (min_deg, max_deg): x is the raw [N, 3] f32 sample and
    the kernel builds the encoding [x, sin(2^f x)..., cos(2^f x)...]
    (frequency-major, xyz-minor, cos as sin(x 2^f + pi/2) rounded in f32)
    itself, rounded to bf16 where the default path rounds it;
  * meta["sh_dim"] = K: a per-row SH basis [N, K] f32 comes in and the
    head's C*K coefficients are contracted against it in f32 in the
    epilogue: rgb [N, C]. The backward forms the coefficients' cotangent
    g_rgb[:, c] * basis[:, k] in f32; the basis gets no gradient.

Outputs are (sigma [N, n_sigma], rgb [N, C]) in f32.

CUDA tensors launch the kernels or raise; CPU tensors run the plain
versions. `fwd_launches` / `bwd_launches` count kernel launches;
`posenc_launches` / `sh_launches` count the launches (either kernel) that
ran each variant (kernels/__init__.py moves them for a replayed CUDA
graph).
"""

import collections
import ctypes
import functools

import torch

from plenoctree_tpu_torch.kernels._build import load_library
from plenoctree_tpu_torch.ops.posenc import posenc as _posenc

fwd_launches = 0  # forward kernel launches in this process
bwd_launches = 0  # backward kernel launches in this process
posenc_launches = 0  # launches with the in-kernel positional encoding
sh_launches = 0  # launches with the in-kernel SH decode

_SOURCES = ("fused_mlp.cu",)


def _layer_has_x(i, skip):
    """Whether layer i's input holds the encoded x: layer 0, and the layer
    after every skip concat (concat after layer j when j % skip == 0, j > 0)."""
    return i == 0 or ((i - 1) % skip == 0 and i - 1 > 0)


def _check_meta(meta):
    """The variants' settings, as pack_params_traced builds them: posenc
    (min_deg, max_deg) with min_deg >= 0 (the JAX kernel builds its scales
    by an integer shift and asserts it) and d_in = 3 (1 + 2F); sh_dim
    dividing the head's colour columns."""
    pe = meta.get("posenc")
    if pe:
        lo, hi = pe
        if lo < 0:
            raise ValueError(f"in-kernel posenc needs min_deg >= 0, got {lo}")
        if meta["d_in"] != 3 * (1 + 2 * (hi - lo)):
            raise ValueError(f"posenc {tuple(pe)} encodes to {3 * (1 + 2 * (hi - lo))} "
                             f"features, but d_in is {meta['d_in']}")
    sh = meta.get("sh_dim") or 0
    if sh < 0 or (sh and (meta["d_out"] - meta["n_sigma"]) % sh):
        raise ValueError(f"sh_dim {sh} does not divide the head's "
                         f"{meta['d_out'] - meta['n_sigma']} colour columns")


def _rgb_width(meta):
    nr = meta["d_out"] - meta["n_sigma"]
    sh = meta.get("sh_dim") or 0
    return nr // sh if sh else nr


def _round16(v):
    return (v + 15) // 16 * 16


def _pow2_16(v):
    """The least of 16, 32, 64, 128, 256 (the wgmma widths the kernels
    instantiate) that holds v; v itself past 256 (the kernels refuse it)."""
    return next((w for w in (16, 32, 64, 128, 256) if w >= v), v)


KS = 64  # weight rows (K) per slab of the stream


# _layout's result; n_fwd: the forward's slabs, the first of `slabs`.
Layout = collections.namedtuple(
    "Layout", "layers xp np w_total b_total slabs stream_bytes n_fwd")


def _layout(meta):
    """The kernels' packed layouts, defined here only (the kernels read them
    through `_desc`).

    layers: per layer (h rows, x rows, N, w_off, b_off). Layer i's K = h
    rows + x rows: width h rows (none for layer 0), then xp = d_in rounded
    up to 16 x rows where the layer reads x; N is width, or for the head np
    = d_out rounded up to a wgmma width (16, 32, 64, 128, 256). The f32
    gradients come back as [K_i, N_i] row-major at w_off, the biases at
    b_off (w_total, b_total elements).

    slabs: the bf16 weight stream the kernels copy into shared memory, as
    (layer, part, k0, k, byte offset): K-slabs of at most KS rows, each a
    K-major wgmma B image (see _kimg) of [rows, k]. First the forward's,
    layers 0..depth, part 0 (h rows) then part 1 (x rows): W_i[rows k0..k0+k]^T
    (rows = N_i); then the backward's dh operands, layers depth..1:
    W_i[:width, k0..k0+k] (rows = width, k over N_i).
    """
    depth, width, skip = meta["depth"], meta["width"], meta["skip_layer"]
    xp, np_ = _round16(meta["d_in"]), _pow2_16(meta["d_out"])
    layers, w_off, b_off = [], 0, 0
    for i in range(depth + 1):
        k_h = width if i > 0 else 0
        k_x = xp if _layer_has_x(i, skip) else 0
        n = width if i < depth else np_
        layers.append((k_h, k_x, n, w_off, b_off))
        w_off += (k_h + k_x) * n
        b_off += n
    slabs, off = [], 0

    def take(i, part, seg_k, rows):
        nonlocal off
        for k0 in range(0, seg_k, KS):
            k = min(KS, seg_k - k0)
            slabs.append((i, part, k0, k, off))
            off += k * rows * 2

    for i, (k_h, k_x, n, _, _) in enumerate(layers):
        take(i, 0, k_h, n)
        take(i, 1, k_x, n)
    n_fwd = len(slabs)
    for i in range(depth, 0, -1):
        take(i, 0, layers[i][2], width)
    return Layout(layers, xp, np_, w_off, b_off, slabs, off, n_fwd)


def _desc(meta):
    """The C entry points' layout and variant arguments: (the per-layer
    descriptor as a ctypes int64 array, n_layers, d_in, d_out, n_sigma,
    posenc on, min_deg, max_deg, sh_dim, the slab table as a ctypes int64
    array, n_slabs, stream bytes)."""
    lay = _layout(meta)
    flat = [v for layer in lay.layers for v in layer]
    slabs = [v for slab in lay.slabs for v in slab]
    pe = meta.get("posenc") or (0, 0)
    return ((ctypes.c_longlong * len(flat))(*flat), len(lay.layers), meta["d_in"],
            meta["d_out"], meta["n_sigma"], int(bool(meta.get("posenc"))), pe[0], pe[1],
            meta.get("sh_dim") or 0, (ctypes.c_longlong * len(slabs))(*slabs), len(lay.slabs),
            lay.stream_bytes)


def _kimg(m):
    """[R, K] (R, K multiples of 8) -> its K-major core-matrix image, flat:
    [K/8][R/8][8 rows][8 k], each 8x8 block 128 contiguous bytes in bf16.
    It is the wgmma B operand of a product with K = K and N = R, read with
    leading byte offset R * 16 (between 8-blocks of K) and stride byte
    offset 128 (between 8-blocks of R)."""
    r, k = m.shape
    return m.reshape(r // 8, 8, k // 8, 8).permute(2, 0, 1, 3).reshape(-1)


@functools.lru_cache(maxsize=32)
def _stream_index(meta_items, device):
    """For each bf16 element of the weight stream, the index of the weight
    it holds in the row-major padded layout (each layer [K_i, N_i] at
    w_off): the stream built from arange (cached per layout and device)."""
    meta = dict(meta_items)
    lay = _layout(meta)
    ids = torch.arange(lay.w_total, dtype=torch.int64)
    out = torch.empty(lay.stream_bytes // 2, dtype=torch.int64)
    for j, (i, part, k0, k, off) in enumerate(lay.slabs):
        k_h, k_x, n, w_off, _ = lay.layers[i]
        w = ids[w_off : w_off + (k_h + k_x) * n].view(k_h + k_x, n)
        if j < lay.n_fwd:  # W_i[rows]^T: N_i x k
            img = _kimg(w[part * k_h + k0 : part * k_h + k0 + k].t())
        else:  # W_i[:width, k0:k0+k]: width x k
            img = _kimg(w[: meta["width"], k0 : k0 + k])
        out[off // 2 : off // 2 + img.numel()] = img
    return out.to(device)


def pack(flat_w, meta):
    """flat_w (f32, [in, out]) -> (the bf16 weight stream, f32 packed
    biases), what both kernels read (_layout): the weights padded to the
    row-major layout, then gathered into the stream. FusedTrunkFn packs
    once per call and hands the result to the backward."""
    lay = _layout(meta)
    with torch.no_grad():
        w_all = torch.cat([
            torch.nn.functional.pad(w, (0, n - w.shape[1], 0, k_h + k_x - w.shape[0])).reshape(-1)
            for w, (k_h, k_x, n, _, _) in zip(flat_w[0::2], lay.layers)
        ])
        b_pack = torch.cat([
            torch.nn.functional.pad(b.reshape(-1), (0, n - b.numel()))
            for b, (_, _, n, _, _) in zip(flat_w[1::2], lay.layers)
        ]).float()
        key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in meta.items()))
        stream = w_all.to(torch.bfloat16)[_stream_index(key, w_all.device)]
    return stream, b_pack


def _unpack_grads(dw, db, flat_w, meta):
    """Packed f32 gradients -> a list shaped like flat_w."""
    out = []
    for i, (k_h, k_x, n, w_off, b_off) in enumerate(_layout(meta)[0]):
        w, b = flat_w[2 * i], flat_w[2 * i + 1]
        k = k_h + k_x
        out.append(dw[w_off : w_off + k * n].view(k, n)[: w.shape[0], : w.shape[1]].clone())
        out.append(db[b_off : b_off + w.shape[1]].reshape(b.shape).clone())
    return out


def build():
    """Compile (once per process) and load the kernel library."""
    lib = load_library("fused_mlp", _SOURCES)
    if not getattr(lib, "_pn_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        i64p = ctypes.POINTER(ctypes.c_longlong)
        desc = [i64p] + [i32] * 8 + [i64p, i32, ctypes.c_longlong]  # see _desc
        lib.pn_fused_mlp_fwd.restype = i32
        lib.pn_fused_mlp_fwd.argtypes = [ptr] * 6 + [i32] + desc + [ptr]
        lib.pn_fused_mlp_bwd_workspace_bytes.restype = ctypes.c_size_t
        lib.pn_fused_mlp_bwd_workspace_bytes.argtypes = [i32] + desc
        lib.pn_fused_mlp_bwd.restype = i32
        lib.pn_fused_mlp_bwd.argtypes = [ptr] * 9 + [i32] + desc + [ptr]
        lib.pn_fused_mlp_error_string.restype = ctypes.c_char_p
        lib.pn_fused_mlp_error_string.argtypes = [i32]
        lib._pn_bound = True
    return lib


def _check_args(flat_w, x, meta, basis=None, grads=()):
    """Validate what the kernels take; raise on anything else."""
    _check_meta(meta)
    depth, n = meta["depth"], x.shape[0] if x.dim() else 0
    if len(flat_w) != 2 * (depth + 1):
        raise ValueError(f"flat_w must hold {2 * (depth + 1)} arrays, got {len(flat_w)}")
    if meta.get("posenc"):
        if x.dtype != torch.float32:
            raise TypeError(f"with in-kernel posenc x must be float32, got {x.dtype}")
        x_dim = 3
    else:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
        x_dim = meta["d_in"]
    if x.dim() != 2 or x.shape[1] != x_dim:
        raise ValueError(f"x must be [N, {x_dim}], got {tuple(x.shape)}")
    sh = meta.get("sh_dim") or 0
    if sh:
        if basis is None:
            raise ValueError(f"meta['sh_dim'] = {sh} needs a basis [N, {sh}]")
        if basis.dtype != torch.float32:
            raise TypeError(f"basis must be float32, got {basis.dtype}")
        if tuple(basis.shape) != (n, sh):
            raise ValueError(f"basis must be [{n}, {sh}], got {tuple(basis.shape)}")
    elif basis is not None:
        raise ValueError("a basis was given but meta['sh_dim'] is 0")
    if grads:
        want = [(n, meta["n_sigma"]), (n, _rgb_width(meta))]
        if [tuple(g.shape) for g in grads] != want:
            raise ValueError(f"cotangents must be {want}, got {[tuple(g.shape) for g in grads]}")
    for t in list(flat_w) + list(grads) + ([basis] if basis is not None else []):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"weights and cotangents must be float32, got {t.dtype}")


def _raise_on(lib, rc, what):
    """Raise on a C entry point's CUDA error code (cudaErrorInvalidValue
    also where the kernels cannot take the layout)."""
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} ({lib.pn_fused_mlp_error_string(rc).decode()})"
        )


def _x_for_kernel(x, meta):
    """x as the kernel reads it: raw f32 coords under posenc, else bf16."""
    if meta.get("posenc"):
        return x.detach().float().contiguous()
    return x.detach().to(torch.bfloat16).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count_variants(meta):
    global posenc_launches, sh_launches
    posenc_launches += bool(meta.get("posenc"))
    sh_launches += bool(meta.get("sh_dim"))


def _fwd_kernel(packed, x, meta, basis):
    global fwd_launches
    lib = build()
    n = x.shape[0]
    w_pack, b_pack = packed
    xk = _x_for_kernel(x, meta)
    basis = None if basis is None else basis.detach().contiguous()
    sigma = torch.empty((n, meta["n_sigma"]), dtype=torch.float32, device=x.device)
    rgb = torch.empty((n, _rgb_width(meta)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pn_fused_mlp_fwd(
            xk.data_ptr(), _ptr(basis), w_pack.data_ptr(), b_pack.data_ptr(), sigma.data_ptr(),
            rgb.data_ptr(), n, *_desc(meta), stream,
        )
    _raise_on(lib, rc, "fused_mlp forward")
    fwd_launches += 1
    _count_variants(meta)
    return sigma, rgb


def _bwd_kernel(packed, flat_w, x, g_sigma, g_rgb, meta, basis):
    global bwd_launches
    lib = build()
    n = x.shape[0]
    desc = _desc(meta)
    lay = _layout(meta)
    w_pack, b_pack = packed
    xk = _x_for_kernel(x, meta)
    basis = None if basis is None else basis.detach().contiguous()
    g_sigma, g_rgb = g_sigma.contiguous(), g_rgb.contiguous()
    dw = torch.zeros(lay.w_total, dtype=torch.float32, device=x.device)
    db = torch.zeros(lay.b_total, dtype=torch.float32, device=x.device)
    ws_bytes = lib.pn_fused_mlp_bwd_workspace_bytes(n, *desc)
    ws = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pn_fused_mlp_bwd(
            xk.data_ptr(), _ptr(basis), w_pack.data_ptr(), b_pack.data_ptr(), g_sigma.data_ptr(),
            g_rgb.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(), n, *desc, stream,
        )
    _raise_on(lib, rc, "fused_mlp backward")
    bwd_launches += 1
    _count_variants(meta)
    return _unpack_grads(dw, db, flat_w, meta)


def _on_device(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def fused_trunk(flat_w, x, meta, basis=None):
    """(sigma [N, n_sigma], rgb [N, C]) f32 of the trunk + head (C = the
    head's colour columns, or their count / sh_dim with the SH decode).

    CUDA tensors launch the forward kernel; CPU tensors run
    `fused_trunk_reference`.
    """
    _check_args(flat_w, x, meta, basis)
    if x.device.type == "cpu":
        return fused_trunk_reference(flat_w, x, meta, basis)
    _on_device(x, "fused_trunk")
    return _fwd_kernel(pack([w.detach() for w in flat_w], meta), x, meta, basis)


def fused_trunk_bwd(flat_w, x, g_sigma, g_rgb, meta, basis=None):
    """f32 gradients of <(sigma, rgb), (g_sigma, g_rgb)> w.r.t. every array of
    flat_w (same shapes); x and the basis get none. CUDA tensors launch the
    backward kernels; CPU tensors run `fused_trunk_bwd_reference`."""
    g_sigma, g_rgb = g_sigma.float(), g_rgb.float()
    _check_args(flat_w, x, meta, basis, (g_sigma, g_rgb))
    if x.device.type == "cpu":
        return fused_trunk_bwd_reference(flat_w, x, g_sigma, g_rgb, meta, basis)
    _on_device(x, "fused_trunk_bwd")
    flat_w = [w.detach() for w in flat_w]
    return _bwd_kernel(pack(flat_w, meta), flat_w, x, g_sigma, g_rgb, meta, basis)


def _dot_bf(a, b):
    """a @ b with bf16-rounded operands and an f32 result, accumulated in
    f32 (a bf16 matmul would round its output to bf16)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def _encoded(x, meta):
    """The trunk's input as the kernels round it: the encoding of the raw
    points under posenc (f32, then bf16), else x itself, as bf16 values in
    f32."""
    pe = meta.get("posenc")
    if pe:
        x = _posenc(x.float(), pe[0], pe[1])
    return x.to(torch.bfloat16).float()


def _forward_acts(flat_w, x, meta):
    """Forward of the trunk as the TPU kernel computes it; returns (head
    output f32, bf16-valued f32 activations per trunk layer, the encoded x
    as f32 of its bf16 values)."""
    depth, skip = meta["depth"], meta["skip_layer"]
    xb = _encoded(x, meta)
    h = xb
    acts = []
    out = None
    for i in range(depth + 1):
        pre = _dot_bf(h, flat_w[2 * i]) + flat_w[2 * i + 1].reshape(1, -1)
        if i == depth:
            out = pre
        else:
            h = torch.relu(pre).to(torch.bfloat16).float()
            acts.append(h)
            if i % skip == 0 and i > 0:
                h = torch.cat([h, xb], dim=-1)
    return out, acts, xb


def fused_trunk_reference(flat_w, x, meta, basis=None):
    """Plain PyTorch version of the forward kernel (same arguments and
    result): bf16 operands, f32 accumulation, bias and ReLU in f32, bf16
    activations between layers, the head in f32; with sh_dim, rgb[:, c] =
    sum_k coeff[:, c*K + k] * basis[:, k] in f32."""
    _check_meta(meta)
    out, _, _ = _forward_acts(flat_w, x, meta)
    ns, sh = meta["n_sigma"], meta.get("sh_dim") or 0
    rgb = out[:, ns:]
    if sh:
        rgb = (rgb.reshape(rgb.shape[0], -1, sh) * basis.float()[:, None, :]).sum(-1)
    return out[:, :ns].contiguous(), rgb.contiguous()


def fused_trunk_bwd_reference(flat_w, x, g_sigma, g_rgb, meta, basis=None):
    """Plain PyTorch version of the backward kernels, layer by layer as
    _make_bwd_kernel: recompute, then dW += h^T dpre and dh = dpre W^T with
    bf16 operands (the cotangents are rounded to bf16 at every product), db
    the f32 sum of the f32 dpre, the ReLU mask from the bf16 activations.
    With sh_dim the head's cotangent is g_rgb[:, c] * basis[:, k] in f32."""
    _check_meta(meta)
    depth, skip, width = meta["depth"], meta["skip_layer"], meta["width"]
    sh = meta.get("sh_dim") or 0
    with torch.no_grad():
        _, acts, xb = _forward_acts(flat_w, x, meta)
        g_rgb = g_rgb.float()
        if sh:
            g_rgb = (g_rgb[:, :, None] * basis.float()[:, None, :]).reshape(g_rgb.shape[0], -1)
        g = torch.cat([g_sigma.float(), g_rgb], dim=-1)
        grads = [None] * len(flat_w)

        def layer_input(i):
            h_in = acts[i - 1] if i > 0 else xb
            if i > 0 and _layer_has_x(i, skip):
                h_in = torch.cat([h_in, xb], dim=-1)
            return h_in

        def accum(i, dpre):
            grads[2 * i] = _dot_bf(layer_input(i).t(), dpre)
            grads[2 * i + 1] = dpre.sum(0).reshape(flat_w[2 * i + 1].shape)

        accum(depth, g)
        dh = _dot_bf(g, flat_w[2 * depth].t())[:, :width]
        for i in range(depth - 1, -1, -1):
            dpre = dh * (acts[i] > 0)
            accum(i, dpre)
            if i > 0:
                dh = _dot_bf(dpre, flat_w[2 * i].t())[:, :width]
    return grads


class FusedTrunkFn(torch.autograd.Function):
    """Autograd around the kernels: `apply(meta, x, basis, *flat_w)` (basis
    None without the SH decode). Saves (x, basis, flat_w) and, on the card,
    the packed weights, and recomputes in the backward, as the JAX custom
    VJP does; x and the basis get no gradient (the JAX package
    stop-gradients both: sample positions and view directions are inputs)."""

    @staticmethod
    def forward(ctx, meta, x, basis, *flat_w):
        ctx.meta = meta
        ctx.save_for_backward(x, basis, *flat_w)
        _check_args(flat_w, x, meta, basis)
        if x.device.type == "cpu":
            ctx.packed = None
            return fused_trunk_reference(flat_w, x, meta, basis)
        _on_device(x, "FusedTrunkFn")
        ctx.packed = pack([w.detach() for w in flat_w], meta)
        return _fwd_kernel(ctx.packed, x, meta, basis)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        x, basis, *flat_w = ctx.saved_tensors
        meta = ctx.meta
        g_sigma, g_rgb = g_sigma.float(), g_rgb.float()
        _check_args(flat_w, x, meta, basis, (g_sigma, g_rgb))
        if ctx.packed is None:
            grads = fused_trunk_bwd_reference(flat_w, x, g_sigma, g_rgb, meta, basis)
        else:
            grads = _bwd_kernel(ctx.packed, flat_w, x, g_sigma, g_rgb, meta, basis)
        return (None, None, None, *grads)
