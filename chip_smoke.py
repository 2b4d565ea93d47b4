"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its wall time:
  1. device: the card's name and power limit;
  2. kernel build: nvcc builds csrc/tile_composite.cu into build/kernels/;
  3. model: bakes the synthetic scene into an SH16 (data_dim 49) octree at
     depth 7 (seeded N(0, 0.05) higher-order SH coefficients) and saves it
     as build/smoke/tree.npz;
  4. kernel vs plain: the CUDA tile kernel against composite_tiles_reference
     on the phase-1 inputs of one 800x800 pose, with both times and the
     time of the tile inputs (ray generation + phase 1) for that pose;
  5. main path: the eval CLI (`plenoctree_tpu_torch.cli.evaluate --fast_eval`)
     in-process on the synthetic test views at 200x200; its kernel launch
     count must be > 0;
  6. serving: a 24-pose 800x800 orbit, every frame timed (regrowth included).

It exits non-zero, and prints no result line, when CUDA is unavailable or
any phase fails. The last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TREE_DEPTH = 7
BASIS_DIM = 16  # SH degree 3: 3 * 16 + 1 = 49 floats per leaf
SH_NOISE = 0.05
SEED = 0
RES = 800
EVAL_RES = 200
N_ORBIT = 24
# Kernel vs plain version, same inputs: outputs lie in [0, 1] and both sum
# up to a few hundred f32 terms per ray, in different orders (sequential
# in the kernel, matmul in the plain version), so they may differ by a few
# hundred f32 ulps; hit tests and precedence are computed identically.
KERNEL_ATOL = 5e-5


def phase(label, t0, **fields):
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[phase] {label}: {time.time() - t0:.2f} s {extra}", flush=True)


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.data.synthetic import build_scene_tree
    from plenoctree_tpu_torch.kernels import _build
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer

    os.chdir(ROOT)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    t0 = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = gpu_name_and_power()
    phase("device", t0, card=repr(kind), nvidia_smi=repr(smi), count=torch.cuda.device_count())

    t0 = time.time()
    tile_composite.build()
    regs = [
        line.strip() for line in _build.build_logs.get("tile_composite", "").splitlines()
        if "registers" in line or "spill" in line
    ]
    phase("kernel build", t0, ptxas=repr("; ".join(regs)))

    t0 = time.time()
    tree = build_scene_tree(TREE_DEPTH, BASIS_DIM, SH_NOISE, SEED)
    out_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    tree_path = os.path.join(out_dir, "tree.npz")
    tree.save(tree_path, compress=False)
    tree = N3Tree.load(tree_path)
    phase(
        "model", t0, format=tree.data_format, data_dim=tree.data_dim,
        depth=tree.max_depth, leaves=tree.n_leaves, path=tree_path,
    )

    t0 = time.time()
    renderer = TileRenderer(
        tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, device=dev
    )
    t_index = time.time() - t0
    focal = 1.1 * RES
    c2w = orbit_pose(0.0)
    renderer.w1cap = int(
        min(renderer.grid_c, np.ceil(np.sqrt(3) * renderer.tile / focal * renderer.grid_c) + 3)
    )
    tile_inputs = renderer.make_tile_inputs_fn(
        RES, RES, focal, renderer.rcap, renderer.w1cap, renderer.ccap
    )
    idx = renderer.index
    p2, _, _, _ = tile_inputs(c2w, idx["csr"], idx["base"], renderer.extra_data, idx["blk_bbox"])
    soa = idx["soa"]
    kw = renderer._kernel_kw
    out_k = tile_composite.composite_tiles(*p2, soa, **kw)
    out_p = tile_composite.composite_tiles_reference(*p2, soa, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        raise RuntimeError("non-finite tile compositing output")
    max_abs_err = float((out_k - out_p).abs().max())
    ms_kernel = cuda_ms(lambda: tile_composite.composite_tiles(*p2, soa, **kw), 10)
    ms_plain = cuda_ms(lambda: tile_composite.composite_tiles_reference(*p2, soa, **kw), 2)
    ms_inputs = cuda_ms(
        lambda: tile_inputs(c2w, idx["csr"], idx["base"], renderer.extra_data, idx["blk_bbox"]), 5
    )
    n_pieces = p2[0][:, 0, 0]
    phase(
        "kernel vs plain", t0, tiles=p2[0].shape[0], pieces_max=int(n_pieces.max()),
        pieces_mean=float(n_pieces.float().mean()), index_build_s=round(t_index, 2),
        max_abs_err=max_abs_err, tol=KERNEL_ATOL, kernel_ms=ms_kernel, plain_ms=ms_plain,
        tile_inputs_ms=ms_inputs,
    )
    if not max_abs_err <= KERNEL_ATOL:
        raise RuntimeError(f"kernel disagrees with the plain version: {max_abs_err} > {KERNEL_ATOL}")

    t0 = time.time()
    tile_composite.launches = 0
    psnr, ssim, lpips = eval_cli.main([
        "--input", tree_path, "--config", "nerf_sh/config/blender",
        "--dataset", "synthetic", "--synthetic_resolution", str(EVAL_RES),
        "--fast_eval", "--device", "cuda",
    ])
    torch.cuda.synchronize()
    main_launches = tile_composite.launches
    with open(tree_path + ".results.json") as f:
        results = json.load(f)
    phase("main path", t0, psnr=psnr, ssim=ssim, lpips=lpips, launches=main_launches)
    if main_launches <= 0:
        raise RuntimeError("the eval CLI never launched the tile kernel")
    if not (math.isfinite(psnr) and math.isfinite(ssim)) or results["psnr"] != psnr:
        raise RuntimeError(f"bad eval results {results}")
    if psnr < 25.0 or ssim < 0.8:
        raise RuntimeError(f"eval quality too low: PSNR {psnr}, SSIM {ssim}")

    t0 = time.time()
    server = TileRenderer(
        tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2,
        index=renderer.index, output="u8", device=dev,
    )
    torch.cuda.reset_peak_memory_stats(dev)
    frame_ms = []
    for k in range(N_ORBIT):
        pose = orbit_pose(2.0 * np.pi * k / N_ORBIT)
        t1 = time.perf_counter()
        img = server.render_persp(pose, RES, RES, focal)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        if img.shape != (RES, RES, 3) or img.dtype != np.uint8 or img.min() == img.max():
            raise RuntimeError(f"bad served frame {k}: {img.shape} {img.dtype}")
    peak = torch.cuda.max_memory_allocated(dev)
    phase(
        "serving", t0, frames=N_ORBIT, median_ms=float(np.median(frame_ms)),
        best_ms=float(np.min(frame_ms)), first_ms=frame_ms[0],
        peak_mem_gib=peak / 2**30, ccap=server.ccap, w1cap=server.w1cap, gpu=repr(smi),
    )

    print(json.dumps({"kernels": [{
        "name": "tile_composite",
        "route": "cuda",
        "source": "plenoctree_tpu_torch/csrc/tile_composite.cu",
        "replaces": "plenoctree_tpu/octree/tile_render.py:711",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
