"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: tile serving and
NeRF-SH training.

    python3 chip_smoke.py

Phases, one line each with its wall time:
  1. device: the card's name and power limit;
  2. kernel build: nvcc builds csrc/tile_composite.cu and csrc/fused_mlp.cu
     into build/kernels/, in parallel (registers and spills per kernel);
  3. model: bakes the synthetic scene into an SH16 (data_dim 49) octree at
     depth 7 (seeded N(0, 0.05) higher-order SH coefficients) and saves it
     as build/smoke/tree.npz;
  4. kernel vs plain: the CUDA tile kernel against composite_tiles_reference
     on the phase-1 inputs of one 800x800 pose, with both times and the
     time of the tile inputs (ray generation + phase 1) for that pose;
  5. main path: the eval CLI (`plenoctree_tpu_torch.cli.evaluate --fast_eval`)
     in-process on the synthetic test views at 200x200; its kernel launch
     count must be > 0;
  6. serving: a 24-pose 800x800 orbit, every frame timed (regrowth included);
  7. trunk kernel vs plain: the fused trunk's forward and backward kernels
     against their plain versions at the fine MLP's bench shape (786,432 x
     63 -> 8x256 -> 1 + 48, seeded glorot weights and N(0, 0.05) biases,
     so the bias adds are checked) and at 10,000 rows (the sparsity pass,
     a ragged tile), with errors and kernel / plain ms;
  8. train main path: the train CLI (`plenoctree_tpu_torch.cli.train`)
     in-process, 200 steps of the blender SH16 config at batch 4096 with the
     fused kernels; both launch counts must be > 0, the train PSNR must
     rise, and the checkpoint must restore with equal params;
  9. train throughput: `plenoctree_tpu_torch.bench` in-process at batch
     4096: rays/s, ms/step, peak memory, and the trunk kernels' share of
     device time from one torch.profiler window.

It exits non-zero, and prints no result line, when CUDA is unavailable or
any phase fails. The last line is {"ok": true, "device": {...}}.
"""

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
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
# Fused trunk kernel vs plain version: the same bf16 rounding points, f32
# sums in another order. An activation whose f32 pre-activation lies near
# a bf16 rounding boundary rounds the other way and the difference
# propagates through the later layers. Measured with TRUNK_BIAS_STD
# biases: 3.0e-3 max abs at 786,432 rows, 2.3e-3 at 10,000, on outputs of
# magnitude ~0.8 (H100 80GB HBM3, 700 W; the JAX tests allow 2e-2). A
# dropped or misplaced bias add moves outputs by ~0.05.
TRUNK_FWD_ATOL = 6e-3
# Per-layer max |dW_kernel - dW_plain| / max |dW_plain| (weights and
# biases): each cotangent is rounded to bf16 before every product, and a
# one-ulp difference in dh rounds a dpre element the other way, which then
# feeds every layer below. Measured with TRUNK_BIAS_STD biases: 8.2e-3 at
# 786,432 rows, 1.0e-2 at 10,000 (same card; the JAX tests allow 0.05).
TRUNK_GRAD_RTOL = 2e-2
TRUNK_BIAS_STD = 0.05  # trained biases are non-zero: a dropped bias add must show
TRUNK_ROWS = (786432, 10000)  # the fine MLP's rows at the bench config; sparsity rows
TRAIN_STEPS = 200
BENCH_BATCH = 4096
BENCH_STEPS = 100


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


def build_all(build_fns):
    """Run every kernel build at once (one nvcc each); re-raise a failure."""
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported below, the smoke run fails
            errors.append(e)

    threads = [threading.Thread(target=run, args=(b,)) for b in build_fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def ptxas_summary(build_logs, name):
    return "; ".join(
        line.strip() for line in build_logs.get(name, "").splitlines()
        if "registers" in line or "spill" in line
    )


def trunk_vs_plain(dev):
    """Phase 7: the fused trunk kernels against their plain versions."""
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.models.params import init_trunk_params, trunk_weights
    from plenoctree_tpu_torch.ops.posenc import posenc

    params = init_trunk_params(np.random.default_rng(SEED), 63, 8, 256, 4, 1, 48,
                               bias_std=TRUNK_BIAS_STD)
    flat, meta = trunk_weights(params, 4, dev)
    results = {}
    for n in TRUNK_ROWS:
        t0 = time.time()
        rng = np.random.default_rng(SEED + n)
        pts = torch.tensor(rng.uniform(-1.5, 1.5, (n, 3)), dtype=torch.float32, device=dev)
        x = posenc(pts, 0, 10)
        gs = torch.tensor(rng.normal(size=(n, 1)) * 1e-3, dtype=torch.float32, device=dev)
        gr = torch.tensor(rng.normal(size=(n, 48)) * 1e-3, dtype=torch.float32, device=dev)
        s, r = fused_mlp.fused_trunk(flat, x, meta)
        grads = fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta)
        torch.cuda.synchronize()
        rs, rr = fused_mlp.fused_trunk_reference(flat, x, meta)
        ref = fused_mlp.fused_trunk_bwd_reference(flat, x, gs, gr, meta)
        if not all(torch.isfinite(t).all() for t in (s, r, *grads)):
            raise RuntimeError(f"non-finite fused trunk output at {n} rows")
        fwd_err = max(float((s - rs).abs().max()), float((r - rr).abs().max()))
        rel = [float((a - b).abs().max() / (b.abs().max() + 1e-30)) for a, b in zip(grads, ref)]
        bwd_abs = max(float((a - b).abs().max()) for a, b in zip(grads, ref))
        fwd_ms = cuda_ms(lambda: fused_mlp.fused_trunk(flat, x, meta), 10)
        fwd_plain = cuda_ms(lambda: fused_mlp.fused_trunk_reference(flat, x, meta), 3)
        bwd_ms = cuda_ms(lambda: fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta), 5)
        bwd_plain = cuda_ms(lambda: fused_mlp.fused_trunk_bwd_reference(flat, x, gs, gr, meta), 3)
        phase(
            f"trunk kernel vs plain ({n} rows)", t0, fwd_max_abs_err=fwd_err,
            fwd_tol=TRUNK_FWD_ATOL, grad_max_rel_err=max(rel), grad_tol=TRUNK_GRAD_RTOL,
            grad_rel_per_array=[round(e, 6) for e in rel], fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain,
            bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain,
        )
        if not fwd_err <= TRUNK_FWD_ATOL:
            raise RuntimeError(f"trunk forward disagrees: {fwd_err} > {TRUNK_FWD_ATOL}")
        if not max(rel) <= TRUNK_GRAD_RTOL:
            raise RuntimeError(f"trunk backward disagrees: {max(rel)} > {TRUNK_GRAD_RTOL}")
        results[n] = dict(fwd_err=fwd_err, bwd_abs=bwd_abs, fwd_ms=fwd_ms,
                          fwd_plain=fwd_plain, bwd_ms=bwd_ms, bwd_plain=bwd_plain)
    return results


def train_main_path(dev):
    """Phase 8: the train CLI; returns (fwd launches, bwd launches)."""
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils
    from plenoctree_tpu_torch.utils.metrics_writer import read_scalars

    t0 = time.time()
    train_dir = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build", "smoke"))
    fused_mlp.fwd_launches = 0
    fused_mlp.bwd_launches = 0
    model, state = train_cli.main([
        "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
        "--train_dir", train_dir, "--device", "cuda", "--use_pallas",
        "--compute_dtype", "bfloat16", "--batch_size", str(BENCH_BATCH), "--image_batching",
        "--max_steps", str(TRAIN_STEPS), "--lr_final", "5e-5", "--print_every", "1",
        "--save_every", str(TRAIN_STEPS), "--render_every", str(TRAIN_STEPS),
    ])
    torch.cuda.synchronize()
    launches = (fused_mlp.fwd_launches, fused_mlp.bwd_launches)
    psnr = [v for _, v in read_scalars(train_dir, "train_psnr")]
    test_psnr = read_scalars(train_dir, "test_psnr")
    rays_s = [v for _, v in read_scalars(train_dir, "train_rays_per_sec")]
    first, last = float(np.mean(psnr[:20])), float(np.mean(psnr[-20:]))
    ckpt_path = os.path.join(train_dir, f"checkpoint_{TRAIN_STEPS}")
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    restored = ckpt_utils.restore_checkpoint(train_dir, ckpt_utils.create_train_state(fresh))
    same = all(torch.equal(p, state.params[k]) for k, p in restored.params.items())
    phase(
        "train main path", t0, steps=len(psnr), fwd_launches=launches[0],
        bwd_launches=launches[1], psnr_first20=first, psnr_last20=last,
        test_psnr=test_psnr[-1][1] if test_psnr else None,
        rays_per_sec_median=float(np.median(rays_s[20:])) if len(rays_s) > 20 else None,
        checkpoint=os.path.basename(ckpt_path), restored_step=restored.step,
        params_equal=same,
    )
    if min(launches) <= 0:
        raise RuntimeError(f"the train CLI did not launch both trunk kernels: {launches}")
    if len(psnr) != TRAIN_STEPS or not all(math.isfinite(v) for v in psnr):
        raise RuntimeError(f"bad train PSNR trace ({len(psnr)} values)")
    if not last > first:
        raise RuntimeError(f"train PSNR did not rise: first 20 {first}, last 20 {last}")
    if not (os.path.isfile(ckpt_path) and restored.step == TRAIN_STEPS and same):
        raise RuntimeError("the checkpoint did not restore into a fresh TrainState")
    return launches


def train_throughput():
    """Phase 9: the port's bench at batch 4096."""
    from plenoctree_tpu_torch import bench

    t0 = time.time()
    res = bench.run(BENCH_BATCH, BENCH_STEPS, profile_window=3)
    phase(
        "train throughput", t0, rays_per_sec=res["rays_per_sec"],
        ms_per_step=res["ms_per_step"], peak_mem_gib=res["peak_mem_gib"],
        device_ms_per_step=res["device_ms_per_step"],
        trunk_kernel_ms_per_step=res["trunk_kernel_ms_per_step"],
        trunk_share=res["trunk_share"], top_kernels=json.dumps(res["top_kernels"]),
        vs_baseline=res["rays_per_sec"] / bench.BASELINE_RAYS_PER_SEC,
    )
    if not (math.isfinite(res["rays_per_sec"]) and math.isfinite(res["final_psnr"])):
        raise RuntimeError(f"bad bench result {res}")
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.data.synthetic import build_scene_tree
    from plenoctree_tpu_torch.kernels import _build
    from plenoctree_tpu_torch.kernels import fused_mlp
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
    build_all([tile_composite.build, fused_mlp.build])
    phase(
        "kernel build", t0, ptxas=repr(ptxas_summary(_build.build_logs, "tile_composite")),
        trunk_ptxas=repr(ptxas_summary(_build.build_logs, "fused_mlp")),
    )

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
    del server, renderer, idx, soa, p2, out_k, out_p
    torch.cuda.empty_cache()

    trunk = trunk_vs_plain(dev)
    fwd_launches, bwd_launches = train_main_path(dev)
    train_throughput()

    bench_rows = trunk[TRUNK_ROWS[0]]
    print(json.dumps({"kernels": [
        {
            "name": "tile_composite",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/tile_composite.cu",
            "replaces": "plenoctree_tpu/octree/tile_render.py:711",
            "launches": main_launches,
            "max_abs_err": max_abs_err,
            "ms": ms_kernel,
            "plain_ms": ms_plain,
        },
        {
            "name": "fused_mlp_fwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "plenoctree_tpu/kernels/fused_mlp.py:185",
            "launches": fwd_launches,
            "max_abs_err": max(r["fwd_err"] for r in trunk.values()),
            "ms": bench_rows["fwd_ms"],
            "plain_ms": bench_rows["fwd_plain"],
        },
        {
            "name": "fused_mlp_bwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "plenoctree_tpu/kernels/fused_mlp.py:268",
            "launches": bwd_launches,
            "max_abs_err": max(r["bwd_abs"] for r in trunk.values()),
            "ms": bench_rows["bwd_ms"],
            "plain_ms": bench_rows["bwd_plain"],
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
