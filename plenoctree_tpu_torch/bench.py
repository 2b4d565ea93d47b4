"""Benchmark: NeRF-SH training throughput of the port on one GPU.

    python -m plenoctree_tpu_torch.bench

The port's counterpart of the root bench.py (which measures the JAX
package): the same flagship config (nerf_sh/config/blender: 8x256 trunk,
SH degree 3, 64 coarse + 128 fine samples, sparsity loss on 10,000
points), bf16 compute with the fused trunk kernels, the procedural
synthetic dataset, 5 warm-up steps, then BENCH_STEPS (100) timed steps of
BENCH_BATCH (4096) rays. Env knobs as in bench.py: BENCH_BATCH,
BENCH_STEPS; and the model's kernel switches PN_POSENC_IN_KERNEL=1 and
PN_SH_IN_KERNEL=1 (the fused trunk's in-kernel posenc and SH decode),
which the JSON line reports.

Baseline: JaxNeRF on one V100 trains ~17,000 rays/s/GPU (bench.py's
docstring); vs_baseline = rays_per_sec_per_chip / 17000.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"posenc_in_kernel", "sh_in_kernel"}. It needs a CUDA device and fails
without one.
"""

import json
import os
import sys
import time

import torch

BASELINE_RAYS_PER_SEC = 17000.0


def switches():
    """The model's fused-kernel variant switches as this process sets them."""
    return {
        "posenc_in_kernel": os.environ.get("PN_POSENC_IN_KERNEL", "0") == "1",
        "sh_in_kernel": os.environ.get("PN_SH_IN_KERNEL", "0") == "1",
    }


def bench_config(batch_size):
    from plenoctree_tpu_torch.utils.config import default_config

    return default_config(
        dataset="synthetic", sh_deg=3, use_viewdirs=False, num_coarse_samples=64,
        num_fine_samples=128, batch_size=batch_size, image_batching=True,
        sparsity_npoints=10000, max_steps=2000000, compute_dtype="bfloat16",
        use_pallas=True,
    )


def run(batch_size=4096, steps=100, profile_window=0):
    """Train 5 warm-up + `steps` steps on the bench config; returns a dict of
    rays/s, ms/step, peak device memory, the variant switches and (with
    profile_window > 0) the fused trunk kernels' share of device time over
    that many extra steps, and the idle share 1 - device ms / ms per step."""
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.data import get_dataset
    from plenoctree_tpu_torch.models.nerf import get_model_state

    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark needs a CUDA device")
    device = torch.device("cuda")
    cfg = bench_config(batch_size)
    model, state = get_model_state(cfg, seed=0, restore=False, device=device)
    train_step = engine.make_train_step(model, cfg)
    batches = engine.device_batches(get_dataset("train", cfg), device)
    gen = torch.Generator(device=device).manual_seed(1)

    for _ in range(5):
        state, stats, _ = train_step(state, next(batches), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, stats, _ = train_step(state, next(batches), gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {
        "rays_per_sec": batch_size * steps / dt,
        "ms_per_step": 1e3 * dt / steps,
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "final_psnr": float(stats.psnr),
        "device": torch.cuda.get_device_name(0),
        **switches(),
    }
    if profile_window:
        out.update(_profile(train_step, state, batches, gen, profile_window))
        out["idle_share"] = 1.0 - out["device_ms_per_step"] / out["ms_per_step"]
    return out


def _profile(train_step, state, batches, gen, n_steps):
    """Device time by kernel over n_steps steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            state, _, _ = train_step(state, next(batches), gen)
        torch.cuda.synchronize()
    total, trunk, top = 0.0, 0.0, []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type.name != "CUDA" or not t:
            continue
        total += t
        if any(k in ev.key for k in ("fwd_kernel", "bwd_rows_kernel", "atb_kernel", "colsum")):
            trunk += t
        top.append((t, ev.key, ev.count))
    top.sort(reverse=True)
    return {
        "profile_steps": n_steps,
        "device_ms_per_step": total / 1e3 / n_steps,
        "trunk_kernel_ms_per_step": trunk / 1e3 / n_steps,
        "trunk_share": trunk / total if total else float("nan"),
        "top_kernels": [(k[:60], round(t / 1e3 / n_steps, 3), c // n_steps) for t, k, c in top[:12]],
    }


def main():
    batch_size = int(os.environ.get("BENCH_BATCH", 4096))
    steps = int(os.environ.get("BENCH_STEPS", 100))
    res = run(batch_size, steps)
    per_chip = res["rays_per_sec"]
    print(json.dumps({
        "metric": "train_rays_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": f"rays/s/chip (batch {batch_size}, 64c+128f, 8x256 SH16, {res['device']})",
        "vs_baseline": round(per_chip / BASELINE_RAYS_PER_SEC, 3),
        **switches(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
