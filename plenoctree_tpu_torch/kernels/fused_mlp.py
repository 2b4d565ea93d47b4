"""Fused NeRF trunk: the CUDA kernels' wrappers and their plain PyTorch versions.

Port of plenoctree_tpu/kernels/fused_mlp.py (the default variant: no
in-kernel posenc, no in-kernel SH decode). `fused_trunk` runs the whole
trunk + fused sigma/rgb head (csrc/fused_mlp.cu, forward kernel) and
`fused_trunk_bwd` its backward (recompute + reverse walk + split-K weight
gradients); `FusedTrunkFn.apply(meta, x, *flat_w)` ties them into
autograd. Both take the JAX
package's `pack_params_traced` layout:

  flat_w = [w_0 [d_in, W], b_0 [1, W], ..., w_head [K, 1 + C], b_head [1, 1 + C]]

(f32, flax's [in, out] kernels in call order; the head is [W_sigma | W_rgb])
and x [N, d_in] encoded points, fed to the kernel as bf16 as the JAX `prep`
does. Outputs are (sigma [N, n_sigma], rgb [N, d_out - n_sigma]) in f32.

CUDA tensors launch the kernels or raise; CPU tensors run the plain
versions. `fwd_launches` / `bwd_launches` count kernel launches.
"""

import ctypes

import torch

from plenoctree_tpu_torch.kernels._build import load_library

fwd_launches = 0  # forward kernel launches in this process
bwd_launches = 0  # backward kernel launches in this process

_SOURCES = ("fused_mlp.cu",)


def _layer_has_x(i, skip):
    """Whether layer i's input holds the encoded x: layer 0, and the layer
    after every skip concat (concat after layer j when j % skip == 0, j > 0)."""
    return i == 0 or ((i - 1) % skip == 0 and i - 1 > 0)


def _check_meta(meta):
    if meta.get("posenc") or meta.get("sh_dim"):
        raise NotImplementedError(
            "the fused trunk's in-kernel posenc and SH-decode variants are not "
            "ported yet (ROADMAP.md, B1/B2)"
        )


def _round16(v):
    return (v + 15) // 16 * 16


def _layout(meta):
    """The kernels' packed weight layout, defined here only (the kernels
    read it through `_desc`): per layer (h rows, x rows, N, w_off, b_off),
    and (xp, np, w_total, b_total). Layer i's K = h rows + x rows: width h
    rows (none for layer 0), then xp = d_in rounded up to 16 x rows where
    the layer reads x; N is width, or np = d_out rounded up to 16 for the
    head."""
    depth, width, skip = meta["depth"], meta["width"], meta["skip_layer"]
    xp, np_ = _round16(meta["d_in"]), _round16(meta["d_out"])
    layers, w_off, b_off = [], 0, 0
    for i in range(depth + 1):
        k_h = width if i > 0 else 0
        k_x = xp if _layer_has_x(i, skip) else 0
        n = width if i < depth else np_
        layers.append((k_h, k_x, n, w_off, b_off))
        w_off += (k_h + k_x) * n
        b_off += n
    return layers, xp, np_, w_off, b_off


def _desc(meta):
    """The C entry points' layout arguments: (the per-layer descriptor as a
    ctypes int64 array, n_layers, d_in, d_out, n_sigma)."""
    layers = _layout(meta)[0]
    flat = [v for layer in layers for v in layer]
    return ((ctypes.c_longlong * len(flat))(*flat), len(layers), meta["d_in"], meta["d_out"],
            meta["n_sigma"])


def _pack(flat_w, meta):
    """flat_w (f32, [in, out]) -> (bf16 packed weights, f32 packed biases).
    A layer's real rows ([h | x]) and columns come first in its padded
    block, so each layer is one corner copy."""
    layers, _, _, w_total, b_total = _layout(meta)
    dev = flat_w[0].device
    w_pack = torch.zeros(w_total, dtype=torch.bfloat16, device=dev)
    b_pack = torch.zeros(b_total, dtype=torch.float32, device=dev)
    for i, (k_h, k_x, n, w_off, b_off) in enumerate(layers):
        w = flat_w[2 * i]
        w_pack[w_off : w_off + (k_h + k_x) * n].view(k_h + k_x, n)[: w.shape[0], : w.shape[1]] = w
        b_pack[b_off : b_off + w.shape[1]] = flat_w[2 * i + 1].reshape(-1)
    return w_pack, b_pack


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
        desc = [ctypes.POINTER(ctypes.c_longlong)] + [i32] * 4  # see _desc
        lib.pn_fused_mlp_fwd.restype = i32
        lib.pn_fused_mlp_fwd.argtypes = [ptr] * 5 + [i32] + desc + [ptr]
        lib.pn_fused_mlp_bwd_workspace_bytes.restype = ctypes.c_size_t
        lib.pn_fused_mlp_bwd_workspace_bytes.argtypes = [i32] + desc
        lib.pn_fused_mlp_bwd.restype = i32
        lib.pn_fused_mlp_bwd.argtypes = [ptr] * 8 + [i32] + desc + [ptr]
        lib.pn_fused_mlp_error_string.restype = ctypes.c_char_p
        lib.pn_fused_mlp_error_string.argtypes = [i32]
        lib._pn_bound = True
    return lib


def _check_args(flat_w, x, meta, grads=()):
    """Validate what the kernels take; raise on anything else."""
    _check_meta(meta)
    depth, d_in = meta["depth"], meta["d_in"]
    if len(flat_w) != 2 * (depth + 1):
        raise ValueError(f"flat_w must hold {2 * (depth + 1)} arrays, got {len(flat_w)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != d_in:
        raise ValueError(f"x must be [N, {d_in}], got {tuple(x.shape)}")
    for t in list(flat_w) + list(grads):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"weights and cotangents must be float32, got {t.dtype}")


def _raise_on(lib, rc, what):
    """Raise on a C entry point's CUDA error code (cudaErrorInvalidValue
    also where the kernels cannot take the layout: width over 256, more
    than 17 layers)."""
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} ({lib.pn_fused_mlp_error_string(rc).decode()})"
        )


def fused_trunk(flat_w, x, meta):
    """(sigma [N, n_sigma], rgb [N, d_out - n_sigma]) f32 of the trunk + head.

    CUDA tensors launch the forward kernel; CPU tensors run
    `fused_trunk_reference`.
    """
    global fwd_launches
    _check_args(flat_w, x, meta)
    if x.device.type == "cpu":
        return fused_trunk_reference(flat_w, x, meta)
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk: unsupported device {x.device}")
    lib = build()
    n = x.shape[0]
    ns, d_out = meta["n_sigma"], meta["d_out"]
    xb = x.detach().to(torch.bfloat16).contiguous()
    w_pack, b_pack = _pack([w.detach() for w in flat_w], meta)
    sigma = torch.empty((n, ns), dtype=torch.float32, device=x.device)
    rgb = torch.empty((n, d_out - ns), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pn_fused_mlp_fwd(
            xb.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), sigma.data_ptr(),
            rgb.data_ptr(), n, *_desc(meta), stream,
        )
    _raise_on(lib, rc, "fused_mlp forward")
    fwd_launches += 1
    return sigma, rgb


def fused_trunk_bwd(flat_w, x, g_sigma, g_rgb, meta):
    """f32 gradients of <(sigma, rgb), (g_sigma, g_rgb)> w.r.t. every array of
    flat_w (same shapes); x gets none. CUDA tensors launch the backward
    kernels; CPU tensors run `fused_trunk_bwd_reference`."""
    global bwd_launches
    g_sigma = g_sigma.float()
    g_rgb = g_rgb.float()
    _check_args(flat_w, x, meta, (g_sigma, g_rgb))
    if x.device.type == "cpu":
        return fused_trunk_bwd_reference(flat_w, x, g_sigma, g_rgb, meta)
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk_bwd: unsupported device {x.device}")
    lib = build()
    n = x.shape[0]
    desc = _desc(meta)
    _, _, _, w_total, b_total = _layout(meta)
    xb = x.detach().to(torch.bfloat16).contiguous()
    w_pack, b_pack = _pack([w.detach() for w in flat_w], meta)
    g_sigma, g_rgb = g_sigma.contiguous(), g_rgb.contiguous()
    dw = torch.zeros(w_total, dtype=torch.float32, device=x.device)
    db = torch.zeros(b_total, dtype=torch.float32, device=x.device)
    ws_bytes = lib.pn_fused_mlp_bwd_workspace_bytes(n, *desc)
    ws = torch.empty(max(ws_bytes, 1), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pn_fused_mlp_bwd(
            xb.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), g_sigma.data_ptr(),
            g_rgb.data_ptr(), dw.data_ptr(), db.data_ptr(), ws.data_ptr(), n,
            *desc, stream,
        )
    _raise_on(lib, rc, "fused_mlp backward")
    bwd_launches += 1
    return _unpack_grads(dw, db, flat_w, meta)


def _dot_bf(a, b):
    """a @ b with bf16-rounded operands and an f32 result, accumulated in
    f32 (a bf16 matmul would round its output to bf16)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def _forward_acts(flat_w, x, meta):
    """Forward of the trunk as the TPU kernel computes it; returns (head
    output f32, bf16-valued f32 activations per trunk layer, x as f32 of its
    bf16 values)."""
    depth, skip = meta["depth"], meta["skip_layer"]
    xb = x.to(torch.bfloat16).float()
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


def fused_trunk_reference(flat_w, x, meta):
    """Plain PyTorch version of the forward kernel (same arguments and
    result): bf16 operands, f32 accumulation, bias and ReLU in f32, bf16
    activations between layers, the head in f32."""
    _check_meta(meta)
    out, _, _ = _forward_acts(flat_w, x, meta)
    ns = meta["n_sigma"]
    return out[:, :ns].contiguous(), out[:, ns:].contiguous()


def fused_trunk_bwd_reference(flat_w, x, g_sigma, g_rgb, meta):
    """Plain PyTorch version of the backward kernels, layer by layer as
    _make_bwd_kernel: recompute, then dW += h^T dpre and dh = dpre W^T with
    bf16 operands (the cotangents are rounded to bf16 at every product), db
    the f32 sum of the f32 dpre, the ReLU mask from the bf16 activations."""
    _check_meta(meta)
    depth, skip, width = meta["depth"], meta["skip_layer"], meta["width"]
    with torch.no_grad():
        _, acts, xb = _forward_acts(flat_w, x, meta)
        g = torch.cat([g_sigma.float(), g_rgb.float()], dim=-1)
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
    """Autograd around the kernels: saves (flat_w, x) and recomputes in the
    backward, as the JAX custom VJP does; x gets no gradient (the JAX
    package stop-gradients it: sample positions never need one)."""

    @staticmethod
    def forward(ctx, meta, x, *flat_w):
        ctx.meta = meta
        ctx.save_for_backward(x, *flat_w)
        return fused_trunk(list(flat_w), x, meta)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        x, *flat_w = ctx.saved_tensors
        grads = fused_trunk_bwd(flat_w, x, g_sigma, g_rgb, ctx.meta)
        return (None, None, *grads)

