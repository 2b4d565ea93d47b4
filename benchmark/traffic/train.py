"""Training traffic: NeRF-SH steps over Blender-shaped data.

Parameters (a traffic file of kind "train"): `batch_size`, the data
(`views`, `height`, `width`, `camera_angle_x`, `camera_radius`, and the
elevation range `elevation_deg` of the cameras on the upper hemisphere),
`warmup_steps` (steps after the checked ones, before the window),
`traced_units`, and `checked_steps`.

Entry: the port's engine.make_train_step over engine.device_batches of the
port's host Dataset sampler (image_batching false: each batch the given
number of rays of one random view), with the random draws of the step
(stratified jitter, fine-sample uniforms, sparsity points) made by the
benchmark from the seed on the device and handed in, so that the reference
can follow. Weights: the published init (glorot-uniform kernels, zero
biases), drawn on the device from the seed. train_rays_per_s is the rays of
the window's steps over its seconds, from a synchronised start to a
synchronised end.

Check: set-up drives the step from the seed through its first
`checked_steps` steps, through the window's own call and feed, then hands
the same model and optimizer state to the warm-up and the window. After the
window the reference (benchmark/reference/nerf_ref.py, float32, TF32 off)
follows those steps from the same initial parameters, batches and draws.
Compared (benchmark/reference/README in PERF.md): the worst relative gap
of the steps' losses; per parameter tensor ("leaf"), the gap between the
norms of the first gradient (the program's from its Adam first moment after
one step, m / (1 - b1)) and the gap between the norms of the parameters'
change after the checked steps, each over the larger of the reference's
norm of that leaf and of the median leaf, worst leaf. Leaves whose
reference gradient norm is under a thousandth of the median leaf's are left
out of the change.
"""

import time

import numpy as np
import torch

from benchmark import poses as poses_lib
from benchmark import roofline
from benchmark import scene as scene_lib
from benchmark.reference import nerf_ref
from benchmark.trace import Stages, span

B1 = 0.9


def _dataset_class():
    from plenoctree_tpu_torch.data.datasets import Dataset

    class SeededBlender(Dataset):
        """Blender-shaped views made in memory: the port's Dataset does the
        rest (rays, the batch sampler)."""

        def __init__(self, split, args, views):
            self._views = views
            super().__init__(split, args)

        def _load_renderings(self, args):
            self.images, self.camtoworlds, self.focal = self._views
            self.h, self.w = self.images.shape[1:3]
            self.resolution = self.h * self.w
            self.n_examples = self.images.shape[0]

    return SeededBlender


def make_views(tr, seed, device):
    """(images [V, H, W, 3] f32 host, c2w [V, 4, 4], focal): images U(0, 1)
    drawn on the device, cameras at seeded azimuths and elevations."""
    v, h, w = tr["views"], tr["height"], tr["width"]
    gen = scene_lib.generator(seed, "images", device)
    images = torch.rand((v, h, w, 3), generator=gen, device=device).cpu().numpy()
    rng = np.random.default_rng(scene_lib.sub_seed(seed, "cameras"))
    lo, hi = tr["elevation_deg"]
    c2w = np.stack([poses_lib.pose_spherical(th, -ph, tr["camera_radius"]) for th, ph in
                    zip(rng.uniform(-180.0, 180.0, v), rng.uniform(lo, hi, v))])
    focal = 0.5 * w / np.tan(0.5 * tr["camera_angle_x"])
    return images, c2w, float(focal)


def init_params(model, seed, device):
    """{name: tensor}: glorot-uniform kernels, zero biases, in one draw."""
    named = dict(model.named_parameters())
    kernels = [k for k, p in named.items() if k.endswith("kernel")]
    total = sum(named[k].numel() for k in kernels)
    u = torch.rand(total, generator=scene_lib.generator(seed, "weights", device), device=device)
    out, off = {}, 0
    for k, p in named.items():
        if k.endswith("kernel"):
            fan_in, fan_out = p.shape
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            out[k] = ((u[off: off + p.numel()] * 2 - 1) * lim).reshape(p.shape)
            off += p.numel()
        else:
            out[k] = torch.zeros_like(p)
    return out


class Driver:
    def __init__(self, ctx):
        from plenoctree_tpu_torch import engine
        from plenoctree_tpu_torch.models.nerf import get_model_state
        from plenoctree_tpu_torch.utils.config import default_config

        self.ctx = ctx
        stage = Stages("set-up")
        m, tr = dict(ctx.config["model"]), ctx.traffic
        if m.get("sg_dim", -1) > 0:
            raise ValueError("the train traffic's reference covers the SH head only")
        self.m, self.tr = m, tr
        dev = self.dev = ctx.device
        self.batch = tr["batch_size"]
        cfg = default_config(dataset="blender", batch_size=self.batch, **m)
        if dev.type != "cuda":
            cfg.use_pallas, cfg.compute_dtype = False, "float32"
        self.cfg = cfg
        model, state = get_model_state(cfg, seed=0, restore=False, device=dev)
        with torch.no_grad():
            init = init_params(model, ctx.seed, dev)
            for k, p in model.named_parameters():
                p.copy_(init[k])
        self.init = {k: v.detach().clone() for k, v in init.items()}
        self.model, self.state = model, state
        self.train_step = engine.make_train_step(model, cfg)
        stage("model")
        ds = _dataset_class()("train", cfg, make_views(tr, ctx.seed, dev))
        ds._rng = np.random.default_rng(scene_lib.sub_seed(ctx.seed, "batches"))
        self.batches = engine.device_batches(ds, dev)
        self.gen = scene_lib.generator(ctx.seed, "draws", dev)
        stage("data (views, rays)")
        # The checked steps: through the window's own call and feed.
        self.checked = []
        self.losses = []
        for k in range(tr["checked_steps"]):
            batch, draws = self._feed()
            self.checked.append((batch, {n: t.clone() for n, t in draws.items()}))
            stats = self._step(batch, draws)
            self.losses.append(float(stats.loss + stats.loss_c + stats.loss_sp))
            if k == 0:
                self.g1 = {n: mu.detach().clone() / (1 - B1)
                           for n, mu in self.state.opt_state["mu"].items()}
        self.after = {k: p.detach().clone() for k, p in model.named_parameters()}
        stage("checked steps")
        for _ in range(tr["warmup_steps"]):
            self._step(*self._feed())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stage("warm-up steps")
        self.steps = 0
        self.window_s = 0.0

    def _feed(self):
        with span("train.batch"):
            batch = next(self.batches)
            b, dev, g = self.batch, self.dev, self.gen
            r = self.m["sparsity_radius"]
            draws = {
                "t_rand": torch.rand((b, self.m["num_coarse_samples"]), generator=g, device=dev),
                "u": torch.rand((b, self.m["num_fine_samples"] + 1), generator=g, device=dev),
                "sp_points": torch.clamp(torch.rand((self.m["sparsity_npoints"], 3),
                                                    generator=g, device=dev) * (2 * r) - r,
                                         min=-r),
            }
        return batch, draws

    def _step(self, batch, draws):
        if self.ctx.fault == "half":  # the step sees half the batch
            b = self.batch // 2
            batch = {"pixels": batch["pixels"][:b],
                     "rays": type(batch["rays"])(*(r[:b] for r in batch["rays"]))}
            draws = {k: v if k == "sp_points" else v[:b] for k, v in draws.items()}
        with span("train.step"):
            if self.ctx.fault == "frozen":
                from plenoctree_tpu_torch import engine

                stats, _ = engine.loss_and_grads(self.model, batch, self.cfg, draws=draws)
                self.state.opt_state["count"] += 1
                return stats
            self.state, stats, _ = self.train_step(self.state, batch, draws=draws)
        return stats

    def run(self, seconds=None, units=None):
        sync = torch.cuda.synchronize if self.dev.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        while True:
            self._step(*self._feed())
            self.steps += 1
            if units is not None and self.steps >= units:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        sync()
        self.window_s = time.perf_counter() - t0

    def end_to_end(self):
        return {"train_rays_per_s": self.steps * self.batch / self.window_s}, self.steps, 0

    def check(self, control=None):
        """[(name, value, limit)]; control='fp8' puts the reference with
        float8 matrix-product operands in the program's place."""
        limits = self.ctx.cell["limits"]
        mine_losses, mine_g1 = self.losses, self.g1
        mine_change = {k: self.after[k] - self.init[k] for k in self.init}
        self.model = self.state = self.train_step = self.batches = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        batches = [_flat(b) for b, _ in self.checked]
        draws = [d for _, d in self.checked]
        losses, g1, params = nerf_ref.train_steps(self.init, batches, draws, self.m)
        change = {k: params[k] - self.init[k] for k in params}
        if control is not None:
            mine_losses, mine_g1, p2 = nerf_ref.train_steps(self.init, batches, draws, self.m,
                                                            quant=control)
            mine_change = {k: p2[k] - self.init[k] for k in p2}
        step_gaps = [abs(a - b) / abs(b) for a, b in zip(mine_losses, losses)]
        loss_gap = max(step_gaps)
        gnorm = {k: float(v.norm()) for k, v in g1.items()}
        med = float(np.median(list(gnorm.values())))
        moving = [k for k in g1 if gnorm[k] >= 1e-3 * med]
        grad_gap, grad_leaves = _worst_leaf(mine_g1, g1, list(g1))
        change_gap, change_leaves = _worst_leaf(mine_change, change, moving)
        self.detail = {"step_loss_gaps": step_gaps, "grad_leaf_gaps": grad_leaves,
                       "change_leaf_gaps": change_leaves, "grad_norms": gnorm,
                       "left_out": sorted(set(g1) - set(moving))}
        return [("loss_gap", loss_gap, limits["loss_gap"]),
                ("grad_norm_gap", grad_gap, limits["grad_norm_gap"]),
                ("change_norm_gap", change_gap, limits["change_norm_gap"])]

    def least(self, units):
        flops, nbytes = roofline.train_step_work(self.m, self.batch)
        return {"trunk": units * roofline.least_time(flops, nbytes, roofline.BF16_FLOPS),
                "step_flops": units * flops}


def _flat(batch):
    rays = batch["rays"]
    return {"pixels": batch["pixels"], "origins": rays.origins, "directions": rays.directions,
            "viewdirs": rays.viewdirs}


def _worst_leaf(mine, ref, names):
    """(max over leaves, per leaf) of | |mine| - |ref| | / max(|ref leaf|,
    |median leaf|)."""
    norms = {k: float(ref[k].norm()) for k in names}
    med = float(np.median(list(norms.values())))
    gaps = {k: abs(float(mine[k].float().norm()) - norms[k]) / max(norms[k], med)
            for k in names}
    return max(gaps.values()), gaps
