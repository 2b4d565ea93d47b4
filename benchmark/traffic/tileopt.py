"""Tile-optimization traffic: SGD steps of the PlenOctree optimizer, one
view a step.

Parameters (a traffic file of kind "tileopt"): `height`, `width`,
`focal_factor`, `views` (a fixed spiral of poses over the `elevation_deg`
band on the upper hemisphere at `distance`, cycled in an order drawn from
the seed), `grid_c` (and
`runrows`, `quantum` where the traffic sets them),
`checked_steps`, `warmup_steps`, `traced_units`. The learning rate is the
configuration's optimize.lr (the published --lr of its fleet file).

Entry: the port's TileOptimizer (exact mode, keep_all index) —
loss_and_grad on one view, the cap check the optimize loop makes
(octree/tile_opt.py::optimize_tree_tiles, which reads the frame's piece
count: a host sync), then its SGD update (octree/optimize.py::
make_update). The targets are images U(0, 1) drawn by the benchmark from
the seed. The caps are sized in set-up from phase 1 of every view, so no
regrowth falls in the window. opt_step_ms is the window's ms over its
steps.

Check: set-up drives the optimizer from the seed through its first
`checked_steps` steps (the window's own step), then hands the same leaf
tensor on. After the window the reference (benchmark/reference/
octree_ref.py::loss_and_grad, float64, SGD) follows those steps from the
same leaf rows. Compared: the worst relative gap of the steps' losses; per
group of the leaf rows (sigma, and each colour channel's coefficients) the
gap between the norms of the first gradient (the program's is -(change of
step 1) / lr) and of the change after the checked steps, over the larger of
the reference's norm of that group and of the median group, worst group.
"""

import time

import numpy as np
import torch

from benchmark import poses as poses_lib
from benchmark import port_inputs, roofline
from benchmark import scene as scene_lib
from benchmark.reference import octree_ref
from benchmark.trace import Stages, span


class Driver:
    def __init__(self, ctx):
        from plenoctree_tpu_torch.octree.optimize import make_update
        from plenoctree_tpu_torch.octree.tile_opt import TileOptimizer

        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.t, self.tr = cfg["tree"], tr
        t = self.t
        dev = self.dev = ctx.device
        self.lr = float(cfg["optimize"]["lr"])
        stage = Stages("set-up")
        tree, self.n_leaves = port_inputs.scene_tree(cfg, ctx.seed, dev)
        stage("scene and tree")

        self.h, self.w = tr["height"], tr["width"]
        self.focal = tr["focal_factor"] * tr["width"]
        # A fixed set of views (a golden-angle spiral over the elevation
        # band), in an order drawn from the seed: every seed does the same
        # work in another order.
        n = tr["views"]
        lo, hi = np.radians(tr["elevation_deg"])
        golden = (np.sqrt(5.0) - 1.0) / 2.0
        views = [poses_lib.hemisphere_pose(2.0 * np.pi * np.mod(golden * i, 1.0),
                                           lo + (hi - lo) * (i + 0.5) / n, tr["distance"])
                 for i in range(n)]
        order = np.random.default_rng(scene_lib.sub_seed(ctx.seed, "views")).permutation(n)
        self.poses = [views[i] for i in order]
        gen = scene_lib.generator(ctx.seed, "targets", dev)
        self.targets = [torch.rand((self.h, self.w, 3), generator=gen, device=dev).cpu().numpy()
                        for _ in self.poses]

        chunking = {k: tr[k] for k in ("runrows", "quantum") if k in tr}

        def build(ccap, w1cap, index=None):
            o = TileOptimizer(tree, step_size=t["step_size"], grid_c=tr["grid_c"], rcap=256,
                              ccap=ccap, index=index, device=dev, **chunking)
            o.r.w1cap = w1cap
            return o

        opt = build(512, None)
        stage("TileOptimizer (keep_all tile index)")
        r = opt.r
        w1cap = int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / self.focal * r.grid_c) + 3))
        nc_max = w1_over = 0
        idx = r.index
        for c2w in self.poses:  # phase 1 of every view: the caps it needs
            ti = r.make_tile_inputs_fn(self.h, self.w, self.focal, r.rcap, w1cap, r.ccap)
            with torch.no_grad():
                _, _, nck, w1o = ti(c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])
            nc_max, w1_over = max(nc_max, int(nck.max())), max(w1_over, int(w1o.max()))
        ccap = 512
        while ccap < nc_max and ccap < 16384:
            ccap *= 2
        if w1_over:
            w1cap = min(r.grid_c, w1cap + w1_over + 2)
        self.opt = build(ccap, w1cap, idx)
        del tree, opt, r, idx
        stage("caps from phase 1 of every view")
        self.leaf = self.opt.initial_leaf_dataT()
        self.update = make_update(self.leaf, True, 0.0, self.lr)
        # The checked steps: the window's own step, from the seed's leaf rows.
        self.snap = [self.leaf.to("cpu", copy=True)]
        self.losses = []
        for k in range(tr["checked_steps"]):
            self.losses.append(float(self._step(k)))
            if k == 0 or k == tr["checked_steps"] - 1:
                self.snap.append(self.leaf.to("cpu", copy=True))
        self.next = tr["checked_steps"]
        stage("checked steps")
        for _ in range(tr["warmup_steps"]):
            self._step(self.next)
            self.next += 1
        stage("warm-up steps")
        self.steps = 0
        self.window_s = 0.0

    def _step(self, k):
        i = k % len(self.poses)
        c2w, gt, h = self.poses[i], self.targets[i], self.h
        if self.ctx.fault == "half":  # the step sees the frame's top half
            h = self.h // 2
            gt = gt[:h]
        with span("opt.loss_and_grad"):
            (loss, (_, _, nc_max, w1o)), grad = self.opt.loss_and_grad(
                self.leaf, c2w, gt, h, self.w, self.focal)
        with span("opt.cap_check"):
            if int(nc_max) > self.opt.r.ccap or int(w1o) > 0:
                raise RuntimeError(f"an optimizer step outgrew the caps sized in set-up "
                                   f"(pieces {int(nc_max)}, lateral overflow {int(w1o)})")
        if self.ctx.fault != "frozen":
            with span("opt.update"):
                self.update(grad, 1.0)
        return loss

    def run(self, seconds=None, units=None):
        sync = torch.cuda.synchronize if self.dev.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        self.first = self.next
        while True:
            self._step(self.next)
            self.next += 1
            self.steps += 1
            if units is not None and self.steps >= units:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        sync()
        self.window_s = time.perf_counter() - t0

    def end_to_end(self):
        return {"opt_step_ms": 1e3 * self.window_s / self.steps}, self.steps, 0

    def _scene(self, dtype):
        return scene_lib.reference_scene(self.ctx.config, self.ctx.seed, self.dev, dtype)

    def _reference_steps(self, dtype):
        """(losses, first gradient [L, D], change [L, D]) of the reference's
        SGD steps in `dtype`."""
        sc = self._scene(dtype)
        start = sc.data.clone()
        losses, first = [], None
        for k in range(self.tr["checked_steps"]):
            i = k % len(self.poses)
            loss, grad = octree_ref.loss_and_grad(
                sc, self.poses[i], torch.as_tensor(self.targets[i]), self.h, self.w,
                self.focal, step_eps=self.t["step_size"], dtype=dtype)
            losses.append(loss)
            first = grad if first is None else first
            sc.data = sc.data - self.lr * grad.to(sc.data.dtype)
        return losses, first, sc.data - start

    def check(self, control=None):
        """[(name, value, limit)]; control='bf16' puts the reference in
        bfloat16 in the program's place."""
        limits = self.ctx.cell["limits"]
        self.opt = self.leaf = self.update = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        bd = self.t["basis_dim"]
        groups = {"red": slice(0, bd), "green": slice(bd, 2 * bd),
                  "blue": slice(2 * bd, 3 * bd), "sigma": slice(3 * bd, 3 * bd + 1)}
        losses, g1, change = self._reference_steps(torch.float64)
        if control is None:
            mine_losses = self.losses
            leaf0, leaf1, leaf3 = (s.double() for s in self.snap)
            mine_g1 = ((leaf0 - leaf1) / self.lr).T
            mine_change = (leaf3 - leaf0).T
        else:
            mine_losses, mine_g1, mine_change = self._reference_steps(torch.bfloat16)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(mine_losses, losses))

        def worst(mine, ref):
            nm = {g: float(mine[:, s].double().norm()) for g, s in groups.items()}
            nr = {g: float(ref[:, s].double().norm()) for g, s in groups.items()}
            med = float(np.median(list(nr.values())))
            return max(abs(nm[g] - nr[g]) / max(nr[g], med) for g in groups)

        return [("loss_gap", loss_gap, limits["loss_gap"]),
                ("grad_norm_gap", worst(mine_g1, g1), limits["grad_norm_gap"]),
                ("change_norm_gap", worst(mine_change, change), limits["change_norm_gap"])]

    def least(self, units):
        """Least seconds of the traced steps: kernel #3 exact and #4 on each
        step's view (the scene's leaves with sigma above 0), and the SGD
        update of the scene's leaf rows."""
        sc = self._scene(torch.float32)
        t = self.t
        d = 3 * t["basis_dim"] + 1
        fwd = bwd = 0.0
        for k in range(self.first, self.first + units):
            c = octree_ref.count(sc, self.poses[k % len(self.poses)], self.h, self.w, self.focal,
                                 step_eps=t["step_size"], stop_thresh=0.0, sigma_thresh=0.0)
            fwd += roofline.least_time(*roofline.tile_fwd_work(c, t["basis_dim"], 3, d),
                                       roofline.F32_FLOPS)
            bwd += roofline.least_time(*roofline.tile_bwd_work(c, t["basis_dim"], 3, d),
                                       roofline.F32_FLOPS)
        upd = units * roofline.least_time(0.0, roofline.sgd_update_bytes(self.n_leaves * d),
                                          roofline.F32_FLOPS)
        return {"bwd": bwd, "step": fwd + bwd + upd}
