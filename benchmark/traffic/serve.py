"""Serving traffic: one closed-loop viewer of a static tree.

Parameters (a traffic file of kind "serve"): `height`, `width`,
`focal_factor` (focal = factor x width), the orbit (`orbit_radius`,
`orbit_height`: each frame a new pose on it, at azimuths that step by the
golden angle from a seeded start), the
renderer's `sigma_thresh`, `stop_thresh`, `grid_c` (and `runrows`,
`quantum` where the traffic sets them; the program's defaults otherwise),
`warmup_frames`
(orbit poses rendered in set-up, so the renderer's caps have grown before
the window), `traced_frames`, and the check's `check_frames` x
`check_pixels` (its limit is the cell file's).

Entry: the port's TileRenderer(..., output="u8").render_persp, which
returns the frame on the host (any cap-regrowth re-render inside it). A
frame's latency is that call's host-clock time; frame_ms is the window's
ms over the frames it completed.

Check: after the window, `check_frames` of the frames it served, drawn from
the seed, and `check_pixels` pixels of each, against the reference march
(benchmark/reference/octree_ref.py) of the same scene, pose and pixels,
quantised as the served frame is. The number compared: the share of those
pixel channels whose served value is not the reference's.
"""

import numpy as np
import torch

from benchmark import poses as poses_lib
from benchmark import port_inputs, roofline
from benchmark import scene as scene_lib
from benchmark.reference import octree_ref
from benchmark.trace import Stages, span


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.t, self.tr = cfg["tree"], tr
        dev = self.dev = ctx.device
        t = self.t
        stage = Stages("set-up")
        tree, _ = port_inputs.scene_tree(cfg, ctx.seed, dev)
        stage("scene and tree")

        from plenoctree_tpu_torch.octree.tile_render import TileRenderer

        self.h, self.w = tr["height"], tr["width"]
        self.focal = tr["focal_factor"] * tr["width"]
        chunking = {k: tr[k] for k in ("runrows", "quantum") if k in tr}
        self.r = TileRenderer(tree, step_size=t["step_size"], sigma_thresh=tr["sigma_thresh"],
                              stop_thresh=tr["stop_thresh"], grid_c=tr["grid_c"],
                              output="u8", device=dev, **chunking)
        del tree
        stage("TileRenderer (tile index)")
        # Frame k's azimuth: a golden-angle sequence from a seeded start, so
        # that any run of frames covers the orbit evenly and every seed
        # serves the same work in another order.
        rng = np.random.default_rng(scene_lib.sub_seed(ctx.seed, "azimuths"))
        golden = (np.sqrt(5.0) - 1.0) / 2.0
        steps = np.arange(tr["max_frames"])
        self.azimuths = 2.0 * np.pi * np.mod(rng.uniform() + golden * steps, 1.0)
        for k in range(tr["warmup_frames"]):
            self._frame(poses_lib.orbit_pose(2.0 * np.pi * k / tr["warmup_frames"],
                                             tr["orbit_radius"], tr["orbit_height"]))
        stage("warm-up frames")
        self.frames, self.lat, self.poses = [], [], []
        self.window_s = 0.0

    def pose(self, k):
        return poses_lib.orbit_pose(self.azimuths[k % len(self.azimuths)],
                                    self.tr["orbit_radius"], self.tr["orbit_height"])

    def _frame(self, c2w):
        with span("serve.render_persp"):
            img = self.r.render_persp(c2w, self.h, self.w, self.focal)
        if self.ctx.fault == "alter":
            img = np.clip(img.astype(np.int16) + 8, 0, 255).astype(np.uint8)
        return img

    def run(self, seconds=None, units=None):
        """Serve frames until `seconds` have passed, or `units` frames."""
        import time

        t0 = time.perf_counter()
        while True:
            k = len(self.frames)
            c2w = self.pose(k)
            a = time.perf_counter()
            img = self._frame(c2w)
            b = time.perf_counter()
            self.frames.append(img)
            self.lat.append(b - a)
            self.poses.append(c2w)
            if (units is not None and len(self.frames) >= units) or (
                    seconds is not None and b - t0 >= seconds):
                break
        self.window_s = time.perf_counter() - t0

    def end_to_end(self):
        n = len(self.frames)
        lat_ms = np.asarray(self.lat) * 1e3
        return {"frame_ms": 1e3 * self.window_s / n,
                "frame_ms_p95": float(np.percentile(lat_ms, 95))}, n, 0

    def _reference_scene(self, dtype=torch.float64):
        return scene_lib.reference_scene(self.ctx.config, self.ctx.seed, self.dev, dtype)

    def check(self, control=None):
        """[(name, value, limit)]. With control='bf16' the reference march
        in bfloat16 stands in for the program's frames."""
        tr = self.tr
        self.r = None  # the program's state is freed before the reference runs
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        sc = self._reference_scene()
        rng = np.random.default_rng(scene_lib.sub_seed(self.ctx.seed, "check"))
        n = len(self.frames)
        pick = rng.choice(n, size=min(tr["check_frames"], n), replace=False)
        off = total = 0
        kw = dict(step_eps=self.t["step_size"], stop_thresh=tr["stop_thresh"],
                  sigma_thresh=tr["sigma_thresh"])
        low = self._reference_scene(torch.bfloat16) if control == "bf16" else None
        for k in pick:
            pix = torch.as_tensor(rng.choice(self.h * self.w, size=tr["check_pixels"],
                                             replace=False), device=self.dev)
            ref = octree_ref.to_u8(octree_ref.render(sc, self.poses[k], self.h, self.w,
                                                     self.focal, pix, **kw))
            if low is not None:
                got = octree_ref.to_u8(octree_ref.render(low, self.poses[k], self.h, self.w,
                                                         self.focal, pix, dtype=torch.bfloat16,
                                                         **kw).double())
            else:
                got = torch.as_tensor(self.frames[k].reshape(-1, 3), device=self.dev)[pix]
            off += int((got != ref).sum())
            total += ref.numel()
        return [("pixel_off_share", off / total, self.ctx.cell["limits"]["pixel_off_share"])]

    def least(self, units):
        """Least seconds of kernel #3 over the first `units` frames served."""
        sc = self._reference_scene(torch.float32)
        tr, t = self.tr, self.t
        total = 0.0
        for c2w in self.poses[:units]:
            c = octree_ref.count(sc, c2w, self.h, self.w, self.focal, step_eps=t["step_size"],
                                 stop_thresh=tr["stop_thresh"], sigma_thresh=tr["sigma_thresh"])
            total += roofline.least_time(*roofline.tile_fwd_work(
                c, t["basis_dim"], 3, 3 * t["basis_dim"] + 1), roofline.F32_FLOPS)
        return {"composite": total}
