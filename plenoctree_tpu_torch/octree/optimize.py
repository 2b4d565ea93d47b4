"""Octree fine-tuning through the exact march: SGD/Adam on leaf data.

Port of plenoctree_tpu/octree/optimize.py (parity: octree/optimization.py
:134-249 of the reference) — per-train-image full-image MSE, one optimizer
step per image (SGD lr ~1e7: leaf-data gradients of a mean MSE are tiny),
validation-PSNR early stopping keeping the best snapshot.

Each step re-marches the rays with the CURRENT sigma (octree/march.py,
no gradient: svox's backward likewise flows only through the cells its
forward marched), then one differentiable `shade` gathers full data rows
for the contributor slots; autograd carries the gradient back through that
gather. Loss and gradient accumulate on the device across chunks; the host
reads one scalar per image. This is the only optimizer for NDC (LLFF)
scenes; the tile optimizer (octree/tile_opt.py) covers pinhole scenes.

The march, the shade (forward and backward) and the update run inside
profiler ranges ("pn_march", "pn_shade", "pn_update"), so a torch.profiler
window can split a step's device time by part; the ranges cost nothing
without a profiler.
"""

import warnings

import numpy as np
import torch
from torch.profiler import record_function

from plenoctree_tpu_torch.data.rays import convert_to_ndc, generate_rays
from plenoctree_tpu_torch.octree import march as march_lib
from plenoctree_tpu_torch.octree import renderer as renderer_lib
from plenoctree_tpu_torch.ops.metrics import compute_psnr
from plenoctree_tpu_torch.utils.checkpoints import TrainState, adam_update

_F32 = torch.float32
# Rays x contributor slots per differentiable shade: the JAX package's bound
# (16384 x 256 slot-rows, sized for a 16 GB TPU). A larger one only changes
# the gradient's summation order.
SLOT_BUDGET = 16384 * 256
# Device bytes per slot-row and data channel at the differentiable shade's
# peak (the row gather, its coefficient copy and both gradients): 22.8 GiB
# for 65,536 x 512 slot-rows of 49 floats on the H100, ~15 B (PERF.md).
SHADE_BYTES_PER_SLOT_CHANNEL = 15


def default_slot_budget(device, data_dim):
    """Slot-rows per differentiable shade: the JAX package's bound on the
    CPU (the parity tests use it); on a GPU as many as fit in a quarter of
    its memory."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return SLOT_BUDGET
    mem = torch.cuda.get_device_properties(dev).total_memory
    return max(SLOT_BUDGET, mem // 4 // (SHADE_BYTES_PER_SLOT_CHANNEL * data_dim))


class TwoPhaseRenderer:
    """March-to-completion + shade helpers shared by train/val steps."""

    def __init__(self, arrays, fmt, basis_dim, opts, K=64):
        tables, meta = renderer_lib.split_arrays(arrays)
        self.data0 = tables.pop("data")
        self.tables = tables
        self.meta = meta
        self.fmt = fmt
        self.basis_dim = basis_dim
        self.opts = opts
        self.K = K
        self.device = self.data0.device

    def prep(self, o, d):
        dev = self.device
        return renderer_lib._prep_rays(
            self.tables,
            torch.as_tensor(o, dtype=_F32).to(dev),
            torch.as_tensor(d, dtype=_F32).to(dev),
            self.fmt,
            self.basis_dim,
        )

    def march(self, data, rp, n_rays):
        """March to completion under the current sigma (no gradient)."""
        with record_function("pn_march"):
            tables = dict(self.tables, sigma=data.detach()[:, -1].contiguous())
            carry = march_lib.init_carry(rp, n_rays, self.K)
            return march_lib.march_while(
                tables, rp, carry, self.meta, self.opts, cap=self.opts.max_segments
            )

    def _overflow(self, rp, carry):
        return march_lib.overflow_mask(rp, carry, self.opts, carry["cells"].shape[1]).any()

    @torch.no_grad()
    def render(self, data, o, d):
        """(rgb [R, C], overflow flag) as device tensors."""
        rp = self.prep(o, d)
        carry = self.march(data, rp, rp[0].shape[0])
        rgb = march_lib.shade(
            data, carry["cells"], carry["dts"], carry["count"], rp[6],
            self.fmt, self.basis_dim, self.opts.background_brightness,
        )
        return rgb, self._overflow(rp, carry)

    def sq_grad(self, data, cells, dts, count, basis, gt, mask):
        """(sum of the masked squared error of the clamped shade of these
        contributor slots, its gradient w.r.t. data), device tensors."""
        leaf = data.detach().requires_grad_(True)
        with torch.enable_grad(), record_function("pn_shade"):
            rgb = march_lib.shade(
                leaf, cells, dts, count, basis, self.fmt, self.basis_dim,
                self.opts.background_brightness,
            )
            # min(max()) rather than clamp: like jnp.clip, it halves the
            # gradient of a pixel exactly on a bound (background is 1).
            zero = torch.zeros((), dtype=_F32, device=self.device)
            rgb = torch.minimum(torch.maximum(rgb, zero), zero + 1.0)
            sq = torch.sum(((rgb - gt) ** 2) * mask)
            (grad,) = torch.autograd.grad(sq, leaf)
        return sq.detach(), grad

    def loss_grad(self, data, o, d, gt, mask):
        """March o, d under the current sigma, then `sq_grad`; returns
        (sq, grad, overflow flag)."""
        rp = self.prep(o, d)
        carry = self.march(data, rp, rp[0].shape[0])
        sq, grad = self.sq_grad(
            data, carry["cells"], carry["dts"], carry["count"], rp[6], gt, mask
        )
        return sq, grad, self._overflow(rp, carry)


def _image_rays(c2w, h, w, focal, ndc):
    rays = generate_rays(w, h, focal, np.asarray(c2w)[None])
    o = rays.origins.reshape(-1, 3)
    d = rays.directions.reshape(-1, 3)
    if ndc is not None:
        o, d = convert_to_ndc(o, d, ndc["focal"], ndc["width"], ndc["height"])
    return o.astype(np.float32), d.astype(np.float32)


def _pad_rows(x, chunk):
    if x.shape[0] == chunk:
        return x
    return np.pad(x, ((0, chunk - x.shape[0]), (0, 0)), mode="edge")


def _pad_chunk(o, d, i, chunk):
    return _pad_rows(o[i : i + chunk], chunk), _pad_rows(d[i : i + chunk], chunk)


def image_loss_grad(rend, data, o, d, gtf, chunk):
    """One image's summed squared error and gradient over edge-padded
    chunks of `chunk` rays (padding masked out), accumulated on the device.
    Returns (sq_total, grad, overflow) tensors."""
    sq_total = grad_acc = overflow = None
    for i in range(0, o.shape[0], chunk):
        oo, dd = _pad_chunk(o, d, i, chunk)
        gg = torch.tensor(_pad_rows(gtf[i : i + chunk], chunk), device=rend.device)
        n_real = min(chunk, o.shape[0] - i)
        mask = torch.zeros((chunk, 1), dtype=_F32, device=rend.device)
        mask[:n_real] = 1.0
        sq, g, ov = rend.loss_grad(data, oo, dd, gg, mask)
        sq_total = sq if sq_total is None else sq_total + sq
        grad_acc = g if grad_acc is None else grad_acc.add_(g)
        overflow = ov if overflow is None else overflow | ov
    return sq_total, grad_acc, overflow


def make_update(data, use_sgd, sgd_momentum, lr):
    """update(grad, denom): one optax step on `data`, in place, with the
    gradient grad / denom — sgd (with the momentum trace t = g +
    momentum * t when sgd_momentum > 0) or adam(lr, eps=1e-8). The
    division uses a device divisor, so it is a true one on the GPU too."""
    if use_sgd:
        momentum = torch.zeros_like(data) if sgd_momentum > 0 else None

        def rule(grad):
            if momentum is not None:
                momentum.mul_(sgd_momentum).add_(grad)
                grad = momentum
            data.add_(grad * -lr)

    else:
        adam = TrainState(
            step=0, params={"data": data},
            opt_state={"count": 0, "mu": {"data": torch.zeros_like(data)},
                       "nu": {"data": torch.zeros_like(data)}},
        )

        def rule(grad):
            # optax.adam(lr, eps=1e-8) = optax.adam(1.0) scaled by lr.
            adam_update(adam, {"data": grad}, lr)

    @torch.no_grad()
    def update(grad, denom):
        with record_function("pn_update"):
            rule(grad / torch.tensor(denom, dtype=grad.dtype, device=grad.device))

    return update


def optimize_tree(
    tree,
    train_c2w,
    train_gt,
    test_c2w,
    test_gt,
    focal,
    cfg,
    num_epochs=80,
    lr=1e7,
    use_sgd=True,
    sgd_momentum=0.0,
    val_interval=2,
    continue_on_decrease=False,
    chunk=None,
    ndc=None,
    rays_per_step=0,
    slot_budget=None,
    device="cuda",
):
    """Fine-tune leaf data; returns (best_tree_or_None, best_val_psnr).

    Rays go through the differentiable shade in chunks of at most `chunk`
    rays and `slot_budget` rays x contributor slots (edge-padded, the
    padding masked out). Left at None they are the JAX package's 16384 and
    SLOT_BUDGET on the CPU, and on a GPU no ray cap and
    `default_slot_budget` (a quarter of its memory).

    rays_per_step > 0 switches from the reference's full-image steps to
    uniformly subsampled rays per step (an unbiased minibatch of the same
    per-image MSE gradient), drawn from the JAX package's seeded stream.
    The updates are optax's: sgd (optional momentum trace) or
    adam(lr, eps=1e-8), applied in place.
    """
    h, w = np.asarray(train_gt[0]).shape[:2]
    dev = renderer_lib.resolve_device(device, "optimize_tree")
    slot_budget = slot_budget or default_slot_budget(dev, tree.data_dim)
    chunk = chunk or (slot_budget if dev.type == "cuda" else 16384)
    arrays = renderer_lib.tree_arrays(tree, device=dev)
    opts = renderer_lib.RenderOptions(
        step_size=cfg.renderer_step_size,
        max_segments=getattr(cfg, "max_segments", 0)
        or renderer_lib.default_max_segments(tree),
    )
    rend = TwoPhaseRenderer(
        arrays, tree.data_format.format, tree.data_format.basis_dim, opts,
        # Upfront K sizing from occupancy stats; cfg.contrib_slots overrides.
        K=getattr(cfg, "contrib_slots", 0)
        or march_lib.estimate_contrib_slots(tree, opts.sigma_thresh),
    )
    data = rend.data0

    update = make_update(data, use_sgd, sgd_momentum, lr)

    def grow_K():
        """Sticky contributor-slot regrowth (march.overflow_mask)."""
        if rend.K >= march_lib.K_MAX:
            warnings.warn(
                f"march contributor slots clipped at K={rend.K}; "
                "optimizing with truncated geometry"
            )
            return False
        rend.K *= 2
        print(f"** regrowing march contributor slots to K={rend.K}")
        return True

    def eff_chunk(n_rays):
        # Bound rays x K per differentiable shade: it gathers
        # [chunk, K, data_dim] rows and its backward keeps residuals of the
        # same size (the JAX package's formula); a chunk larger than the
        # image would only march padding.
        return min(chunk, max(2048, slot_budget // max(rend.K, 1)), n_rays)

    def run_test():
        while True:
            tpsnr = 0.0
            overflow = False
            for c2w, gt in zip(test_c2w, test_gt):
                o, d = _image_rays(c2w, h, w, focal, ndc)
                outs = []
                ck = eff_chunk(o.shape[0])
                for i in range(0, o.shape[0], ck):
                    rgb, ov = rend.render(data, *_pad_chunk(o, d, i, ck))
                    outs.append(rgb.cpu().numpy())
                    overflow = overflow or bool(ov)
                im = np.concatenate(outs, 0)[: o.shape[0]].reshape(h, w, 3)
                im = np.clip(im, 0.0, 1.0)
                mse = float(((im - np.asarray(gt)[..., :3]) ** 2).mean())
                tpsnr += float(compute_psnr(mse))
            if overflow and grow_K():
                continue
            return tpsnr / len(test_c2w)

    best_psnr = run_test()
    print("** initial val psnr", best_psnr)
    best_data = None
    ray_rng = np.random.default_rng(20200823)
    for epoch in range(num_epochs):
        tpsnr = 0.0
        for c2w, gt in zip(train_c2w, train_gt):
            o, d = _image_rays(c2w, h, w, focal, ndc)
            gtf = np.asarray(gt[..., :3], np.float32).reshape(-1, 3)
            if rays_per_step and rays_per_step < o.shape[0]:
                sel = ray_rng.integers(0, o.shape[0], size=rays_per_step)
                o, d, gtf = o[sel], d[sel], gtf[sel]
            while True:
                sq_total, grad, overflow = image_loss_grad(rend, data, o, d, gtf, eff_chunk(o.shape[0]))
                if bool(overflow) and grow_K():
                    continue  # redo this image with more slots, no update
                break
            # Mean over the rays actually marched (the reference's
            # full-image mean when rays_per_step is off).
            denom = float(o.shape[0] * 3)
            update(grad, denom)
            tpsnr += float(compute_psnr(float(sq_total) / denom))
        tpsnr /= len(train_c2w)
        print(f"epoch {epoch}: train_psnr {tpsnr:.4f}")

        if epoch % val_interval == val_interval - 1 or epoch == num_epochs - 1:
            val_psnr = run_test()
            print("** val psnr", val_psnr, "best", best_psnr)
            if val_psnr > best_psnr:
                best_psnr = val_psnr
                best_data = data.clone()
            elif not continue_on_decrease:
                print("Stop since overfitting")
                break
    if best_data is not None:
        best_tree = tree.clone()
        renderer_lib.write_back_data(best_tree, best_data)
        return best_tree, best_psnr
    return None, best_psnr
