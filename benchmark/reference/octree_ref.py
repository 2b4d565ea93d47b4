"""Plain reference of the octree frames: a per-ray march over the scene's
finest grid, in float64 PyTorch.

It imports nothing of the program. Its inputs are the benchmark's own: the
dense map of data leaves (benchmark/scene.py::grid_ids), each leaf's data row,
the colour lobes, the pose and the camera. The semantics are the published
PlenOctree volume rendering (svox) that the served and the optimized frames
compute:

  * a ray leaves the camera through pixel (x, y) along
    rot @ ((x - W/2) / f, -(y - H/2) / f, -1) (pixel corners, as the
    program's tile inputs), and enters the unit tree box at its slab entry
    + 1e-5 (clamped to 0), leaving it at its slab exit - 1e-5;
  * each data leaf it crosses is one segment of length (exit - entry +
    step_size) * (world units per tree unit), optical depth
    s = max(sigma, 0) * length;
  * front to back, a segment whose light before it, exp(-sum of s in
    front), exceeds stop_thresh adds light * (1 - exp(-s)) * colour and
    its s; the colour is sigmoid(basis . coefficients) per channel (SH: the
    real SH basis of the view direction; SG: exp(lambda (mu . d - 1)));
  * the pixel is the sum plus exp(-total s) * background;
  * served frames skip leaves with sigma <= sigma_thresh; optimized frames
    keep every leaf and stop nowhere.

The march is a 3-D DDA at the finest grid's resolution: every data leaf of
the scene's tree is one finest cell (benchmark/scene.py), and cells without
data hold no leaf that can add anything.

`render` gives colours; `loss_and_grad` the optimized frame's clamped-image
MSE and its gradient with respect to every leaf row (a second march from
the finished colours: for segment i of a ray, d out_c / d s_i =
light_{i+1} c_i - (out_c - A_c,i), A the colour accumulated up to i);
`count` the (ray, leaf) pairs a frame composites and the leaves it reads,
for benchmark/roofline.py.
"""

import math

import torch

_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
          -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def sh_basis(deg, d):
    """Real SH basis up to degree 3 at unit directions d [N, 3] -> [N, (deg+1)^2]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = [torch.full_like(x, _SH_C0)]
    if deg >= 1:
        out += [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x]
    if deg >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [_SH_C2[0] * xy, _SH_C2[1] * yz, _SH_C2[2] * (2 * zz - xx - yy), _SH_C2[3] * xz,
                _SH_C2[4] * (xx - yy)]
    if deg >= 3:
        out += [_SH_C3[0] * y * (3 * xx - yy), _SH_C3[1] * xy * z,
                _SH_C3[2] * y * (4 * zz - xx - yy), _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                _SH_C3[4] * x * (4 * zz - xx - yy), _SH_C3[5] * z * (xx - yy),
                _SH_C3[6] * x * (xx - 3 * yy)]
    if deg > 3:
        raise ValueError("the reference's SH basis stops at degree 3")
    return torch.stack(out, -1)


def color_basis(fmt, bd, viewdirs, extra):
    if fmt == "SH":
        return sh_basis(int(round(math.sqrt(bd))) - 1, viewdirs)
    lam, mu = extra[:, 0], extra[:, 1:4]
    return torch.exp(lam[None] * (viewdirs @ mu.T - 1.0))


def pixel_rays(c2w, height, width, focal, pix, dtype=torch.float64):
    """(origin [3], directions [N, 3]) in world space of flat pixels pix."""
    dev = pix.device
    c2w = torch.as_tensor(c2w, dtype=dtype, device=dev)
    y = torch.div(pix, width, rounding_mode="floor").to(dtype)
    x = (pix % width).to(dtype)
    cam = torch.stack([(x - width * 0.5) / focal, -(y - height * 0.5) / focal,
                       -torch.ones_like(x)], -1)
    return c2w[:3, 3], cam @ c2w[:3, :3].T


class Scene:
    """What the reference reads: the leaf map [R, R, R] int32 (-1: no data
    leaf), leaf rows [L, 3 * bd + 1] (coefficients per channel, then
    sigma), the SG lobes [bd, 4] or None, and the tree's placement."""

    def __init__(self, grid, data, extra, fmt, bd, radius, center):
        self.grid = grid.reshape(-1)
        self.res = grid.shape[0]
        self.data = data
        self.extra = extra
        self.fmt, self.bd = fmt, bd
        self.radius = torch.as_tensor(radius, dtype=torch.float64, device=data.device).expand(3)
        self.center = torch.as_tensor(center, dtype=torch.float64, device=data.device).expand(3)


def _prepare(scene, origin, d_world, dtype):
    viewdirs = d_world / d_world.norm(dim=-1, keepdim=True)
    invr = 0.5 / scene.radius.to(dtype)
    offset = 0.5 * (1.0 - scene.center.to(dtype) / scene.radius.to(dtype))
    o = (origin.to(dtype) * invr + offset).expand(d_world.shape).contiguous()
    dt = viewdirs * invr
    dscale = 1.0 / dt.norm(dim=-1)
    dn = dt * dscale[:, None]
    dn = torch.where(dn.abs() < 1e-6, torch.where(dn < 0, -1e-6, 1e-6).to(dtype), dn)
    inv = 1.0 / dn
    t0, t1 = (0.0 - o) * inv, (1.0 - o) * inv
    tmin = torch.minimum(t0, t1).amax(-1).clamp(min=0.0) + 1e-5
    tmax = torch.maximum(t0, t1).amin(-1) - 1e-5
    return viewdirs, o, dn, dscale, tmin, tmax


def _march(scene, origin, d_world, *, step_eps, stop_thresh, sigma_thresh, bg, dtype,
           out=None, g=None, counts=None):
    """One march of every ray. Returns out [N, 3] (colour + light * bg);
    with out and g [N, 3] given, the gradient [L, D] of sum(g * out); with
    counts = {} fills in 'pairs' and 'leaves'."""
    dev = d_world.device
    n = d_world.shape[0]
    bd, res = scene.bd, scene.res
    viewdirs, o, dn, dscale, tmin, tmax = _prepare(scene, origin, d_world, torch.float64)
    basis = color_basis(scene.fmt, bd, viewdirs.to(dtype), None if scene.extra is None
                        else scene.extra.to(dtype))
    data = scene.data.to(dtype)
    cum = torch.zeros(n, dtype=dtype, device=dev)
    acc = torch.zeros(n, 3, dtype=dtype, device=dev)
    grad = None if g is None else torch.zeros_like(data)
    touched = None
    if counts is not None:
        touched = counts.setdefault(
            "touched", torch.zeros(data.shape[0], dtype=torch.bool, device=dev))
    pairs = 0

    ray = torch.nonzero(tmax > tmin).squeeze(1)
    o, dn, tmin, tmax = o[ray], dn[ray], tmin[ray], tmax[ray]
    pos = o + tmin[:, None] * dn
    cell = torch.clamp((pos * res).floor().long(), 0, res - 1)
    stp = torch.where(dn > 0, 1, -1)
    nxt = (cell + (dn > 0).long()).to(torch.float64) / res
    tnext = (nxt - o) / dn
    tdelta = 1.0 / (res * dn.abs())
    t = tmin
    while ray.numel():
        lin = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        leaf = scene.grid[lin].long()
        tex, axis = tnext.min(1)
        seg = torch.nonzero((leaf >= 0) & (tex > t) & (t <= tmax)).squeeze(1)
        if seg.numel():
            r, lf = ray[seg], leaf[seg]
            rows = data[lf]
            sig_raw = rows[:, -1]
            sig = sig_raw.clamp(min=0.0)
            length = ((tex - t)[seg] + step_eps).to(dtype) * dscale[r].to(dtype)
            s = sig * length
            light = torch.exp(-cum[r])
            use = (sig > sigma_thresh) & (light > stop_thresh)
            coef = rows[:, : 3 * bd].reshape(-1, 3, bd)
            c = torch.sigmoid((coef * basis[r][:, None, :]).sum(-1))
            att = torch.exp(-s)
            contrib = torch.where(use, light * (1.0 - att), 0.0)
            acc[r] += contrib[:, None] * c
            cum[r] += torch.where(use, s, 0.0)
            if grad is not None:
                after = torch.where(use, light * att, light)
                ds = (g[r] * (after[:, None] * c - (out[r] - acc[r]))).sum(-1)
                gs = torch.where(use & (sig_raw > 0), ds * length, 0.0)
                gc = g[r] * (contrib[:, None] * c * (1.0 - c))  # [n, 3]
                rowg = torch.cat([(gc[:, :, None] * basis[r][:, None, :]).reshape(-1, 3 * bd),
                                  gs[:, None]], -1)
                grad.index_add_(0, lf, rowg)
            if touched is not None:
                pairs += int(use.sum())
                touched[lf[use]] = True
        # Step into the next cell along the axis whose boundary comes first.
        idx = torch.arange(cell.shape[0], device=dev)
        cell[idx, axis] += stp[idx, axis]
        t = tex
        tnext[idx, axis] += tdelta[idx, axis]
        live = ((cell >= 0) & (cell < res)).all(1) & (t <= tmax)
        if stop_thresh > 0:
            live &= torch.exp(-cum[ray]) > stop_thresh
        if not bool(live.all()):
            keep = torch.nonzero(live).squeeze(1)
            ray, cell, tnext, tdelta, stp, t, tmax = (
                x[keep] for x in (ray, cell, tnext, tdelta, stp, t, tmax))
            o, dn = o[keep], dn[keep]
    if counts is not None:
        counts["pairs"] = counts.get("pairs", 0) + pairs
    if grad is not None:
        return grad
    return acc + torch.exp(-cum)[:, None] * bg


def render(scene, c2w, height, width, focal, pix, *, step_eps, stop_thresh, sigma_thresh,
           bg=1.0, dtype=torch.float64):
    """Colours [N, 3] (dtype) of the flat pixels pix of one frame."""
    origin, d = pixel_rays(c2w, height, width, focal, pix)
    return _march(scene, origin, d, step_eps=step_eps, stop_thresh=stop_thresh,
                  sigma_thresh=sigma_thresh, bg=bg, dtype=dtype)


def to_u8(img):
    """The served frame's quantisation: round(clamp(x, 0, 1) * 255)."""
    return torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def loss_and_grad(scene, c2w, gt, height, width, focal, *, step_eps, bg=1.0,
                  dtype=torch.float64, block=1 << 19):
    """(loss, gradient [L, D]) of mean((clamp(frame, 0, 1) - gt)^2) over the
    whole frame, every leaf kept, no stop (the optimizer's exact mode); gt
    [H, W, 3]. A pixel exactly on a clamp bound passes half its gradient
    (as min(max(x, 0), 1) does under autograd); the sigma of a leaf whose
    sigma is not above 0 gets none (the clamp at 0). Rays in blocks."""
    dev = scene.data.device
    gt = gt.reshape(-1, 3).to(dev)
    total = gt.numel()
    sq = torch.zeros((), dtype=torch.float64, device=dev)
    grad = torch.zeros_like(scene.data, dtype=dtype)
    kw = dict(step_eps=step_eps, stop_thresh=0.0, sigma_thresh=-math.inf, bg=bg, dtype=dtype)
    for p0 in range(0, height * width, block):
        pix = torch.arange(p0, min(p0 + block, height * width), device=dev)
        origin, d = pixel_rays(c2w, height, width, focal, pix)
        out = _march(scene, origin, d, **kw)
        clipped = out.clamp(0.0, 1.0)
        diff = clipped - gt[pix].to(dtype)
        sq += (diff.double() ** 2).sum()
        gate = torch.where((out > 0) & (out < 1), 1.0,
                           torch.where((out == 0) | (out == 1), 0.5, 0.0)).to(dtype)
        g = 2.0 * diff * gate / total
        grad += _march(scene, origin, d, out=out, g=g, **kw)
    return float(sq / total), grad


def count(scene, c2w, height, width, focal, *, step_eps, stop_thresh, sigma_thresh,
          block=1 << 19):
    """{'pairs', 'leaves', 'rays'}: the (ray, leaf) pairs that one whole
    frame composites, the distinct leaves it reads, and its rays."""
    dev = scene.data.device
    c = {}
    for p0 in range(0, height * width, block):
        pix = torch.arange(p0, min(p0 + block, height * width), device=dev)
        origin, d = pixel_rays(c2w, height, width, focal, pix)
        _march(scene, origin, d, step_eps=step_eps, stop_thresh=stop_thresh,
               sigma_thresh=sigma_thresh, bg=1.0, dtype=torch.float32, counts=c)
    return {"pairs": c.get("pairs", 0), "leaves": int(c["touched"].sum()),
            "rays": height * width}
