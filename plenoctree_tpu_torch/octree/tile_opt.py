"""Differentiable tile-compositing octree optimization, in PyTorch + CUDA.

Port of plenoctree_tpu/octree/tile_opt.py (see its docstring for the
method): direct SGD/Adam on leaf data through the exact-mode tile
compositor (sigma/stop thresholds 0, an index built with keep_all=True, so
zero-sigma leaves can revive under the gradient, as svox renders current
data every step).

  * The frame's phase 1 (`TileRenderer.make_tile_inputs_fn`) runs without
    gradients; it depends only on the tree's geometry.
  * `CompositeTilesFn` is the compositor as an autograd function: the tile
    kernel forward, the tile backward kernel (`composite_tiles_bwd`,
    csrc/tile_composite.cu) backward, gradient with respect to the soa only.
  * Leaf data reach the soa's data rows through one gather of columns,
    `leaf_dataT[:, col_leaf]` (index_select), whose autograd is the
    instance -> leaf segment-sum (index_add): the replicas of one leaf sum.

Pinhole scenes only, as in the JAX package: the optimize CLI takes NDC
scenes through the march (octree/optimize.py).
"""

import numpy as np
import torch

from plenoctree_tpu_torch.kernels.tile_composite import composite_tiles, composite_tiles_bwd
from plenoctree_tpu_torch.ops.metrics import compute_psnr
from plenoctree_tpu_torch.octree.tile_render import (
    RUNROWS, TILE, TileRenderer, _untile, build_tile_index,
)
from plenoctree_tpu_torch.octree.optimize import make_update

_F32 = torch.float32


class CompositeTilesFn(torch.autograd.Function):
    """out = composite_tiles(*p2_args, soa) in exact mode (stop_thresh 0,
    od_cap 1e30), differentiable in soa: apply(kw, soa, *p2_args), where kw
    holds the kernel's static arguments (fmt, basis_dim, n_channels,
    sigma_row, runrows, quantum, step_eps)."""

    @staticmethod
    def forward(ctx, kw, soa, *p2_args):
        out = composite_tiles(*p2_args, soa, **kw, stop_thresh=0.0, od_cap=1e30)
        ctx.kw = kw
        ctx.save_for_backward(soa, out, *p2_args)
        return out

    @staticmethod
    def backward(ctx, g):
        soa, out, *p2_args = ctx.saved_tensors
        gsoa = composite_tiles_bwd(*p2_args, soa, out, g.contiguous(), **ctx.kw)
        return (None, gsoa) + (None,) * len(p2_args)


class TileOptimizer:
    """Differentiable full-frame renderer over a static tree topology.

    Same surface as the JAX TileOptimizer: `loss_and_grad(leaf_dataT, c2w,
    gt, height, width, fx)` — the clamped-image MSE and d(loss)/d(leaf_dataT)
    — and `render(leaf_dataT, c2w, height, width, fx)` for validation.
    leaf_dataT is [data_dim, n_kept] on the optimizer's device (transposed,
    so the per-step soa assembly is one gather along the column axis).
    `index` takes a keep_all tile index built earlier for the same tree (a
    regrowth rebuild reuses it instead of repeating the host build).
    """

    def __init__(
        self,
        tree,
        step_size=1e-4,
        background_brightness=1.0,
        grid_c=64,
        fine_c2=None,
        runrows=RUNROWS,
        rcap=256,
        ccap=None,
        quantum=128,
        tile=TILE,
        index=None,
        device="cuda",
    ):
        if index is None:
            index = build_tile_index(
                tree, 0.0, grid_c, fine_c2, runrows, keep_all=True, quantum=quantum
            )
        # Exact mode + keep-all: svox parity (no thresholds during opt).
        self.r = TileRenderer(
            tree,
            step_size=step_size,
            background_brightness=background_brightness,
            sigma_thresh=0.0,
            stop_thresh=0.0,
            grid_c=grid_c,
            fine_c2=fine_c2,
            runrows=runrows,
            rcap=rcap,
            ccap=ccap,
            quantum=quantum,
            tile=tile,
            index=index,
            device=device,
        )
        r = self.r
        idx = r.index
        self.device = r.device
        self.data_dim = int(idx["sigma_row"]) - 6 + 1
        self.n_kept = int(idx["n_kept"])
        self.col_leaf = torch.as_tensor(idx["col_leaf"]).to(self.device).long()
        self.keep_mask = np.asarray(idx["keep_mask"])
        # Static soa: geometry (and pad) rows stay; data rows come from
        # leaf_dataT at every step.
        self.static_soa = idx["soa"]
        kw = dict(r._kernel_kw)
        del kw["stop_thresh"], kw["od_cap"]
        self._kw = kw

    # -- leaf data <-> tree ------------------------------------------------

    def initial_leaf_dataT(self):
        tree = self.r.tree
        leaves = tree._leaf_nodes()[self.keep_mask]
        data = tree.data[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]]
        return torch.from_numpy(np.ascontiguousarray(data.astype(np.float32).T)).to(self.device)

    def write_back(self, tree, leaf_dataT):
        leaves = tree._leaf_nodes()[self.keep_mask]
        data = torch.as_tensor(leaf_dataT).detach().cpu().numpy().T
        tree.data[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]] = data

    # -- differentiable frame ---------------------------------------------

    def _assemble(self, leaf_dataT):
        """[D, n_kept] -> the blocked soa with its data rows from leaf_dataT:
        one column gather (autograd: the instance -> leaf segment-sum) and a
        block relayout."""
        D = self.data_dim
        pad = torch.zeros(D, 1, dtype=leaf_dataT.dtype, device=leaf_dataT.device)
        rows = torch.index_select(torch.cat([leaf_dataT, pad], dim=1), 1, self.col_leaf)
        nb, _, q = self.static_soa.shape
        blocked = rows.reshape(D, nb, q).permute(1, 0, 2)
        s = self.static_soa
        return torch.cat([s[:, :6], blocked, s[:, 6 + D :]], dim=1).contiguous()

    def _frame(self, leaf_dataT, c2w, height, width, fx):
        """(image [H, W, nc], n_max, nc_max, w1_over) as tensors; the image
        is differentiable in leaf_dataT."""
        r = self.r
        if r.w1cap is None:
            r.w1cap = int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / fx * r.grid_c) + 3))
        hp = -(-height // r.tile) * r.tile
        wp = -(-width // r.tile) * r.tile
        nc = r.n_channels
        idx = r.index
        tile_inputs = r.make_tile_inputs_fn(height, width, fx, r.rcap, r.w1cap, r.ccap)
        with torch.no_grad():
            p2_args, n_total, n_chunks, w1_over = tile_inputs(
                c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"]
            )
        soa = self._assemble(leaf_dataT)
        out = CompositeTilesFn.apply(self._kw, soa, *p2_args)
        img = out[:, :, :nc] + out[:, :, nc : nc + 1] * r.opts.background_brightness
        img = _untile(img, hp, wp, r.tile)[:height, :width]
        return img, n_total.max(), n_chunks.max(), w1_over.max()

    def loss_and_grad(self, leaf_dataT, c2w, gt, height, width, fx):
        """Returns ((loss, (img, n_max, nc_max, w1_over)), grad_leaf_dataT),
        all tensors on the optimizer's device."""
        leaf = leaf_dataT.detach().requires_grad_(True)
        gt = torch.tensor(np.asarray(gt, np.float32), device=self.device)
        with torch.enable_grad():
            img, n_max, nc_max, w1_over = self._frame(leaf, c2w, height, width, fx)
            # The reference clamps the render before the MSE
            # (octree/optimization.py:218-219). min(max()) rather than
            # clamp: like jnp.clip, it halves the gradient of a pixel that
            # lies exactly on a bound (a background pixel is exactly 1).
            one = torch.ones((), dtype=_F32, device=self.device)
            clipped = torch.minimum(torch.maximum(img, torch.zeros_like(one)), one)
            loss = torch.mean((clipped - gt) ** 2)
            (grad,) = torch.autograd.grad(loss, leaf)
        return (loss.detach(), (img.detach(), n_max, nc_max, w1_over)), grad

    @torch.no_grad()
    def render(self, leaf_dataT, c2w, height, width, fx):
        """(img [H, W, nc] numpy, n_max, nc_max, w1_over)."""
        img, n_max, nc_max, w1_over = self._frame(leaf_dataT, c2w, height, width, fx)
        return img.cpu().numpy(), int(n_max), int(nc_max), int(w1_over)


def optimize_tree_tiles(
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
    grid_c=64,
    device="cuda",
):
    """Tile-kernel octree fine-tuning; returns (best_tree_or_None, best_psnr).

    Port of plenoctree_tpu/octree/tile_opt.py::optimize_tree_tiles:
    per-image full-frame MSE steps with SGD (optional momentum) or Adam
    (optax.adam(lr, eps=1e-8)), both updating one leaf tensor in place;
    validation every val_interval epochs with early stop, the best snapshot
    written back into a clone of the tree. A saturated ccap (doubled, up to
    16384) or lateral-1 window (w1cap += overflow + 2) rebuilds the
    optimizer at the larger cap, keeping it for later frames, and redoes
    the step.
    """
    h, w = np.asarray(train_gt[0]).shape[:2]
    fx = float(focal)
    step_size = cfg.renderer_step_size

    state = {"rcap": 256, "ccap": 512, "w1cap": None}

    def build(prev=None):
        o = TileOptimizer(
            tree, step_size=step_size, grid_c=grid_c, rcap=state["rcap"],
            ccap=state["ccap"], index=None if prev is None else prev.r.index,
            device=device,
        )
        if state["w1cap"] is not None:
            o.r.w1cap = state["w1cap"]
        return o

    opt = build()
    leaf = opt.initial_leaf_dataT()

    def regrow(nc_max, w1_over):
        """True if a cap grew (the caller rebuilds and redoes the step)."""
        grew = False
        if nc_max > state["ccap"]:
            state["ccap"] = min(16384, state["ccap"] * 2)
            print(f"** regrowing tile ccap to {state['ccap']}")
            grew = True
        if w1_over > 0:
            cur = opt.r.w1cap or grid_c
            state["w1cap"] = min(grid_c, cur + int(w1_over) + 2)
            print(f"** regrowing tile w1cap to {state['w1cap']}")
            grew = True
        return grew

    update = make_update(leaf, use_sgd, sgd_momentum, lr)

    def run_test():
        nonlocal opt
        while True:
            tpsnr = 0.0
            grew = False
            for c2w, gt in zip(test_c2w, test_gt):
                img, _, nc_max, w1o = opt.render(leaf, c2w, h, w, fx)
                if regrow(nc_max, w1o):
                    opt = build(opt)
                    grew = True
                    break
                im = np.clip(img, 0.0, 1.0)
                mse = float(((im - np.asarray(gt)[..., :3]) ** 2).mean())
                tpsnr += float(compute_psnr(mse))
            if not grew:
                return tpsnr / len(test_c2w)

    best_psnr = run_test()
    print("** initial val psnr", best_psnr)
    best_leaf = None
    for epoch in range(num_epochs):
        tpsnr = 0.0
        for c2w, gt in zip(train_c2w, train_gt):
            gt3 = np.asarray(gt, np.float32)[..., :3]
            while True:
                (loss, (_, _, nc_max, w1o)), grad = opt.loss_and_grad(leaf, c2w, gt3, h, w, fx)
                if regrow(int(nc_max), int(w1o)):
                    opt = build(opt)
                    continue
                break
            update(grad, 1.0)  # the loss is already the image mean
            tpsnr += float(compute_psnr(float(loss)))
        tpsnr /= len(train_c2w)
        print(f"epoch {epoch}: train_psnr {tpsnr:.4f}")

        if epoch % val_interval == val_interval - 1 or epoch == num_epochs - 1:
            val_psnr = run_test()
            print("** val psnr", val_psnr, "best", best_psnr)
            if val_psnr > best_psnr:
                best_psnr = val_psnr
                best_leaf = leaf.clone()
            elif not continue_on_decrease:
                print("Stop since overfitting")
                break
    if best_leaf is not None:
        best_tree = tree.clone()
        opt.write_back(best_tree, best_leaf)
        return best_tree, best_psnr
    return None, best_psnr
