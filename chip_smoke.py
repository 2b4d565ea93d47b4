"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: tile serving,
NeRF-SH training, PlenOctree conversion (extraction, tile optimization),
the gather probes, the exact march (evaluation and optimization), the SG
head, the NeRF eval, the conversion fleet and compression, real-capture
layouts: NSVF (octree/config/tt_sh25.json), LLFF with NDC serving, and the
view-conditioned head with extraction by SH projection; the JAX
package's checkpoints, orbit video, mesh and the train CLI's profiler;
and the multi-device paths, with the one card used as two devices (and
as two processes: inference CLIs and tensor-parallel training under
torch.distributed.run).

    python3 chip_smoke.py

Wherever a tile kernel is held against its plain version (phases 4, 11,
22, 24), the kernel runs on the whole 800x800 frame and the plain version
on PLAIN_SUBSET_TILES of its tiles, the tile with the most pieces among
them (tiles are independent); phases 4 and 11 also time one whole-frame
run of the plain version for the kernels line.

Phases, one line each with its wall time:
  1. device: the card's name and power limit;
  2. kernel build: nvcc builds csrc/tile_composite.cu, csrc/fused_mlp.cu
     and csrc/gather_sum.cu into build/kernels/, in parallel (registers and
     spills per kernel), in a thread beside phase 3's host work (its line
     follows phase 3's);
  3. model: bakes the synthetic scene into an SH16 (data_dim 49) octree at
     depth 7 (seeded N(0, 0.05) higher-order SH coefficients) and saves it
     as build/smoke/tree.npz; then renders the CLIs' synthetic views at
     200x200 once (memoized: every later CLI run reuses them), writes them
     as a blender-layout scene with the port's PNG writer and loads it back
     through the Blender loader (at --factor 0 and 2);
  4. kernel vs plain: the CUDA tile kernel against composite_tiles_reference
     on the phase-1 inputs of one 800x800 pose (the plain version on the
     tile subset), with both times and the time of the tile inputs (ray
     generation + phase 1) for that pose;
  5. main path: the eval CLI (`plenoctree_tpu_torch.cli.evaluate --fast_eval
     --shard_devices 1`)
     in-process on the synthetic test views at 200x200; its kernel launch
     count must be > 0;
  6. serving: a 24-pose 800x800 orbit, every frame timed (regrowth included);
  7. trunk kernel vs plain: the fused trunk's forward and backward kernels
     against their plain versions at the fine MLP's bench shape (786,432 x
     63 -> 8x256 -> 1 + 48, seeded glorot weights and N(0, 0.05) biases,
     so the bias adds are checked), for each variant: the default, the
     in-kernel posenc (raw [N, 3] points), the in-kernel SH decode (a
     degree-3 basis of random directions, rgb [N, 3]) and both, at 786,432,
     262,144 and 10,000 rows (a ragged tile; there the gradients are held
     to the noise floor, bench_trunk.TRUNK_SMALL_ROW_FACTOR times the plain
     version's distance from an f64 evaluation); errors, two backward runs
     bitwise equal, kernel / plain / library ms, the bound, the backward's
     workspace floor and the weight bytes read from L2 per row; and the
     SG25 head's cell (786,432 x 63 -> 8x256 -> 1 + 75, the head padded to
     128 columns) under the same bounds;
  8. train main path: the train CLI (`plenoctree_tpu_torch.cli.train`)
     in-process, 200 steps of the blender SH16 config at batch 4096 with the
     fused kernels (kernel switches off); both launch counts must be > 0,
     the train PSNR must rise, and the checkpoint must restore with equal
     params; then the same CLI for 40 steps with PN_POSENC_IN_KERNEL=1
     PN_SH_IN_KERNEL=1: both kernels launched, every launch on the posenc
     variant and the coarse and fine ones on the SH-decode variant (the
     wrapper's counters), the train PSNR rising;
  9. extract main path: the extract CLI (`plenoctree_tpu_torch.cli.extract`)
     in-process on phase 8's checkpoint_200 with the same model flags and
     octree/config/syn_sh16.json's extraction flags, cut to init_grid_depth
     6 (phase 21 extracts the same checkpoint at 8, and its tree takes the
     budgeted accel grid check);
     the trunk forward kernel's launch count must be > 0, the tree must be
     built by the native host library (its build_octree count > 0) and must
     save and reload; leaf count, eval PSNR (through the exact march, the
     JAX CLI's default) and wall-clock per step; then one 800x800 exact
     march frame of that tree, timed;
 10. train throughput: `plenoctree_tpu_torch.bench` in-process at batch
     4096, with the kernel switches off and then on: rays/s, ms/step, peak
     memory, and the trunk kernels' share of device time and the idle
     share from one torch.profiler window;
 11. tile bwd kernel vs plain: on the depth-7 tree in exact mode (the
     optimizer's keep_all index), one 800x800 pose: the tile kernel's
     exact-mode forward against composite_tiles_reference (KERNEL_ATOL),
     then, on that forward output and a seeded cotangent, the tile backward
     kernel on the whole frame, its cotangent zeroed outside the tile
     subset, against composite_tiles_bwd_reference on that subset:
     errors per field group, the difference between two whole-frame kernel
     runs, times, the pieces total, and
     one launch's float4 atomics into the gradient soa (with the non-zero
     floats they carry: one scalar atomic each in a scalar flush);
 12. optimize throughput: ms per optimizer step at 800x800 on that
     optimizer (median of 12 steps, CUDA events), peak memory, and the
     step's device time by kernel group (forward, backward, segment-sum,
     gather, other) from one torch.profiler window over 3 real steps, with
     the idle share and the tile inputs' time alone;
 13. optimize main path: the optimize CLI (`plenoctree_tpu_torch.cli.optimize
     --tile_opt`) in-process on the depth-7 tree with its DC colour
     coefficients washed to 0, 12 train / 4 val synthetic views at 200x200,
     syn_sh16's optimization flags for 1 epoch; the backward kernel's
     launch count must be > 0, the best val PSNR must beat the initial one
     by OPT_MIN_GAIN_DB, tree_opt.npz must load; then the eval CLI on it;
     then a control, the same CLI run at -lr (the gradient's sign flipped),
     which must not pass the gain check;
 14. gather kernel vs plain, and the probes: every gather_sum variant (the
     three Pallas probes' functions with the wrapper's placement, the 32k
     table sliced across the SMs, and with the L2 placement; the
     shared-memory placement on a 1k-row table) at K 256 x R 8192 indices
     into a 32k-row table, D 56, against its plain version and a float64
     sum (GATHER tolerance from each launch's longest addition chain),
     reruns bitwise equal, with ms, plain ms, embedding_bag ms and bound;
     then the probes' entry point (`plenoctree_tpu_torch.bench_gather.run`)
     in process, its kernel launches counted: one ns/row line per case;
 15. march full width: VolumeRenderer on the depth-7 tree, two 800x800
     orbit poses, exact (step 1e-5) and fast: ms/frame, K estimated and
     after regrowth, segment budget, accel level and reso, peak memory; the
     fast frame of pose 0 must match the served tile frame of that pose to
     MARCH_SERVED_MIN_PSNR;
 16. exact eval main path: the eval CLI without --fast_eval on the depth-7
     tree at 200x200, 4 views, with seeded random LPIPS weights: PSNR/SSIM
     above phase 5's floor, no tile kernel launch, LPIPS finite and equal
     on the card and the CPU for one image pair within LPIPS_RTOL (TF32 off);
 17. march optimize throughput: TwoPhaseRenderer.loss_grad over chunks of
     rays (as the optimize CLI sizes them on this card) + the SGD update at
     800x800 on the depth-7 tree: median ms per step, peak memory, and the
     device time by part (march, shade forward + backward, update) and idle
     share of one chunk + update from a profiler window;
 18. march optimize main path: the optimize CLI without --tile_opt on phase
     13's washed tree with the same flags: no tile kernel launch, the best
     val PSNR beats the initial one by OPT_MIN_GAIN_DB, tree_opt_march.npz
     loads;
 19. SG train main path: the train CLI on nerf_sh/config/misc/sg (SG25,
     8x256, 64 + 128 samples, batch 1024, sparsity loss) with the fused
     kernels, 200 steps on the synthetic scene: both trunk kernels launched
     on the 1 + 75 head, the train PSNR rising, checkpoint_200 restoring
     with equal params (sg_lambda, sg_mu_spher);
 20. NeRF eval main path: the NeRF eval CLI (`plenoctree_tpu_torch.cli.eval`)
     on phase 8's SH16 and phase 19's SG25 checkpoints over phase 3's
     blender scene (4 test views at 200x200): PSNR/SSIM, psnr.txt and
     ssim.txt, the PNGs read back; one 800x800 view timed (s/image);
 21. fleet main path: `python -m plenoctree_tpu_torch.cli.task_manager
     tasks.json --gpus "0 0"` (two workers on the card) on two tasks in the form of syn_sh16.json and
     syn_sg25.json (published flags, --num_epochs 80 -> 1, the model flags
     as trained) on those checkpoints and the synthetic scene's views at
     16x16 (12 train, 4 test, 4 val): rc 0, two results.txt lines without
     error, finite PSNRs, the wall-clock of each stage, each extraction's
     tree built by the native host library (its `native:` line); then one 800x800
     exact march frame of the SH16 tree (depth 8), timed, its accel grid
     budgeted (phase 9's check before its cut);
 22. SG25 tiles, on an SG25 tree of the depth-7 serving tree's topology
     (the fleet's trees exceed the tile index's 2^24 rows): one served
     800x800 frame (launches > 0), the serving kernel against its plain
     version (times, bound), both kernels' shared memory, then one
     exact-mode pose's forward and backward kernels against their plain
     versions (phase 11's checks);
 23. compression: the compress CLI (--bits 16) on both fleet trees: keys,
     palette sizes <= 2^16, MB before and after, wall-clock, one native
     median cut per quantized basis function; the SG25 tree
     decoded here and rendered at 800x800 through the march, within
     COMPRESS_MIN_PSNR of the uncompressed tree's frame and
     COMPRESS_PALETTE_MIN_PSNR of the frame of the uncompressed tree with
     the same sigma cut;
 24. NDC tile kernel vs plain (run right after phase 6, on its index): the
     depth-7 serving tree read as an NDC volume (make_ndc_config at
     800x800, focal NDC_FOCAL), a forward-facing pose's tile inputs (per-ray
     origins, segment-endpoint AABB group masks) through the tile kernel
     against composite_tiles_reference (KERNEL_ATOL), both times, the bound,
     the share of valid pieces whose mask is below 15; then an
     N_NDC_ORBIT-pose forward-facing orbit at 800x800, median ms/frame;
 25. T&T train main path (run right after phase 20): an NSVF-layout
     scene written by the port's writer (TT_VIEWS at FLEET_RES), the train
     CLI on nerf_sh/config/tt (SH25,
     batch 1024, 64 + 128 samples) with the fused kernels for 200 steps:
     both trunk kernels on the 1 + 75 head, PSNR rising, checkpoint_200
     restoring with equal params (phase 7 holds the SH25 head, raw and
     decoded in-kernel against a degree-4 basis, at 786,432 rows);
 26. T&T fleet main path (run beside phase 21, in a thread: both fleets
     are host-bound processes): the task manager as a subprocess on
     octree/config/tt_sh25.json as it stands ({%} scenes, --bbox_from_data,
     --split_train) cut to one scene and TT_EPOCHS of 40 epochs, with the
     trained model's flags: rc 0, a results.txt line without error, finite
     PSNRs, each stage's wall-clock, the bbox-derived centre and radius;
 27. LLFF NDC main path (with phase 28, run while the fleets of phases 21
     and 26 run in their threads): an LLFF capture written by the port's writer
     (LLFF_VIEWS at LLFF_RES) and a config with llff in its path; the train
     CLI for 200 steps with the fused kernels; the extract CLI (--center
     "0 0 0" --radius 1.05, init_grid_depth LLFF_DEPTH), the optimize CLI
     (the march, no tile launch), the evaluate CLI exact and --fast_eval
     (tile launches > 0), the NDC tile frame against the NDC march frame of
     a test pose (NDC_MIN_PSNR), and the NeRF eval CLI's --render_path
     (path_renders/, 120 poses);
 28. view-conditioned path: the train CLI on nerf_sh/config/misc/proj
     (use_viewdirs, the plain path: no trunk kernel launch) for 200 steps,
     then the extract CLI by SH projection to degree 4 (an SH25 tree,
     init_grid_depth PROJ_DEPTH): the tree reloads, its eval PSNR finite.

 29. JAX checkpoints on the card: the committed fixtures that the JAX
     package's savers wrote (tests/torch_fixtures/jax_ckpt: an orbax
     TrainState directory, an original JaxNeRF tree as orbax and as
     msgpack; a blender-config model cut to 2 x 16) restored through
     get_model_state(restore=True) on cuda: params, Adam mu, nu and count,
     and step bitwise equal to the fixture's want.npz (the JaxNeRF trees
     with a fresh Adam); one 200x200 render of the synthetic scene from the
     TrainState, finite;
 30. gen_video main path: the gen_video CLI in-process on phase 8's
     checkpoint_200 at the published 800x800, GEN_VIDEO_VIEWS of the
     published 40 views, --write_poses: the PNGs read back at 800x800, the
     poses file's poses on the radius, frame 0 bitwise equal to
     engine.render_image of pose 0; s/frame and the mp4 line printed;
 31. gen_mesh main path: the gen_mesh CLI in-process on that checkpoint with
     --use_pallas --compute_dtype bfloat16 at the published defaults (reso
     300, c1 -2, c2 2, iso 6.0, point_chunk 720720): the trunk forward
     kernel launched GEN_MESH_LAUNCHES times, mesh.obj non-empty, vertices
     and triangles, wall-clock per step (grid, sigma, marching, OBJ), peak
     device memory; where the model's sigma never reaches 6.0 the CLI runs
     again at GEN_MESH_FALLBACK_ISO of its maximum (a cut, printed); then one
     720,720-row dispatch of the grid through the forward kernel against the
     plain version (TRUNK_FWD_ATOL times the sigma's scale, max(1, max
     |sigma|): the bound was measured on outputs of magnitude ~0.8), kernel /
     plain / F.linear-chain ms and
     the bound, as phase 7; then the marching on the card against the
     marching on the CPU on a 64^3 sub-volume of the grid, bitwise;
 32. train extras: the train CLI for 12 steps of the blender config with
     the fused kernels, --profile_start_step 5 --profile_steps 3
     --render_every 6: timings.txt parses (total hours > 0), and the Chrome
     trace under train_dir/profile/ names both trunk kernels.
 33. data-parallel training: two gloo ranks on cuda:0
     (plenoctree_tpu_torch.parallel.ranks.run_ranks), each half of a
     4096-ray batch with handed-in draws, one step of the blender config at
     full width from phase 8's checkpoint_200 (its Adam moments) through
     the fused kernels, against a one-process step on the whole batch: the
     ranks' parameters bitwise equal, within TRUNK_GRAD_RTOL of the
     one-process step relative to the update, kernels #1/#2 launched 3
     times by each rank; then the train CLI under torch.distributed.run,
     two gloo ranks on cuda:0 for DP_STEPS steps (each rank's ms/step,
     all-reduce ms/step and launches; rank 0 alone writes; checkpoint_20
     restores), then (beside phase 36's rank starts) one rank with the
     default NCCL backend for 5 steps;
 34. sharded serving (run right after phase 6, on its index): the depth-7
     serving tree through TileRenderer(mesh=[cuda:0, cuda:0]) at 800x800,
     N_SHARDED_POSES orbit poses bitwise the one-device frames, phase 1
     run once per device a frame on its own half of the 2,500 tiles, kernel
     #3 launched twice a frame, each device's phase-1 ms (and the whole
     frame's on one device), median ms/frame of both (u8 output); the eval
     CLI's --shard_devices 2 refused on a one-GPU host (phase 5 runs the
     eval CLI with --shard_devices 1);
 35. sharded inference over [cuda:0, cuda:0]: engine.render_image at
     200x200 (chunk 8000: two 4000-ray slices) within the one-device
     render's own spread (a rerun, and chunk 4000) and bitwise the
     one-device render at the slice size; the extract CLI with
     --mesh_shape 2 at phase 9's flags, bitwise phase 9's tree; the
     gen_mesh CLI at 300^3 with --mesh_shape 2: GEN_MESH_LAUNCHES launches
     of kernel #1, the volume bitwise phase 31's;
 36. multi-process inference: the eval (phase 3's blender scene, 4 views at
     200x200), gen_video (2 views at 800x800) and gen_mesh (300^3, kernel
     #1) CLIs each under torch.distributed.run with 2 gloo ranks on cuda:0,
     side by side, against the same CLI in this process over [cuda:0,
     cuda:0]: the same files, bitwise (the eval scalars without their
     wall-clock); gen_mesh's kernel #1 launches per rank (19) and in the
     one process (38);
 37. tensor-parallel training: the train CLI for TP_STEPS steps in this
     process, then under torch.distributed.run with --mesh_shape 1,2 (2
     gloo ranks on cuda:0, --use_pallas: kernels #1/#2 on gathered
     weights): train losses within rtol 2e-5 and checkpoint params within
     rtol 5e-5 / atol 1e-6 of the one process's, both kernels launched 3
     times a step on each rank, each rank's ms/step and model-axis
     collectives' ms/step.

A "total" line gives the wall time of the run before the kernels line.
Each kernel in the final JSON line carries its bound: the larger of the
bytes it must move (each input read once, each output written once; for the
tile kernels the soa blocks its pieces name, once each; for gather_sum the
index stream and each distinct row once) over 3.35 TB/s and
the operations this run's data needs over the card's peak for their type
(989 TFLOP/s bf16 tensor cores for the trunk, 67 TFLOP/s f32 for the tile
kernels, counting only the slab tests of live rows with sigma > 0 against
the rays of their pieces' quad groups), and, for the trunk, the time of the
same MLP as a chain of bf16 torch.nn.functional.linear + relu calls (with
torch's posenc in front and the SH einsum behind for the variants), for
gather_sum the time of torch.nn.functional.embedding_bag(mode="sum").

It exits non-zero, and prints no result line, when CUDA is unavailable or
any phase fails. The last line is {"ok": true, "device": {...}}.
"""

import contextlib
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
# The tile kernels run on the whole 800x800 frame (2,500 tiles); their plain
# versions, at ~1.5-4.7 s a frame, run on a fixed subset of it: the tile
# with the most pieces and every (tiles // 63)-th tile from 0. Tiles are
# independent; the backward's gradient is a sum over tiles and linear in
# the cotangent, so the whole-frame kernel run with the cotangent zero
# outside the subset is held to the subset's plain gradient. The kernels
# line's plain ms is one timed whole-frame run of #3 (phase 4) and of #4
# (phase 11).
PLAIN_SUBSET_TILES = 64
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
# 786,432 rows (same card; the JAX tests allow 0.05). At TRUNK_SMALL_ROWS
# the measure is dominated by the algorithm's own rounding noise (the plain
# f32 version itself lies 1.1-2.8e-2 from an f64 evaluation of the same
# rounding points over six seeds, PERF.md), so those cells are held to
# bench_trunk.TRUNK_SMALL_ROW_FACTOR times the plain version's distance
# from that f64 evaluation instead.
TRUNK_GRAD_RTOL = 2e-2
TRUNK_BIAS_STD = 0.05  # trained biases are non-zero: a dropped bias add must show
TRUNK_ROWS = 786432  # the fine MLP's rows at the bench config (the kernels line's cell)
TRUNK_SMALL_ROWS = 10000
# Each trunk kernel variant (plenoctree_tpu_torch.bench_trunk.VARIANTS: the
# default, the in-kernel posenc, the in-kernel SH decode of degree 3, and
# both, which PN_POSENC_IN_KERNEL=1 PN_SH_IN_KERNEL=1 trains with) at the
# row counts of the training step's fine pass (786,432 rows) and coarse pass
# (262,144), and of the sparsity points (10,000, a ragged tile).
TRUNK_CELLS = dict.fromkeys(("default", "posenc", "sh", "posenc+sh"),
                            (786432, 262144, TRUNK_SMALL_ROWS))
TRUNK_CELLS["sg25"] = (TRUNK_ROWS,)  # the SG25 head's cell (the default variant)
# The SH25 head (nerf_sh/config/tt: 1 + 75 columns, padded to 128): its
# raw coefficients, and the in-kernel decode against a degree-4 basis.
TRUNK_CELLS["sh25"] = TRUNK_CELLS["sh25+sh"] = (TRUNK_ROWS,)
TRAIN_STEPS = 200
VARIANT_STEPS = 40  # the train CLI with both kernel switches on
BENCH_BATCH = 4096
BENCH_STEPS = 100
# Tile backward kernel vs plain version, per field group relative to the
# group's largest |gradient|: the same hit tests and precedence, sums in
# another order (measured 2.0e-7 at 800x800, H100 80GB HBM3, 700 W); two
# kernel runs differ by the order of their float atomics (measured 1.2e-7).
BWD_RTOL = 1e-5
BWD_RERUN_RTOL = 2e-6
# syn_sh16's extraction flags (octree/config/syn_sh16.json), cut from the
# default init_grid_depth 8 to 6 (7 until the real-capture phases needed
# the time; the fleet below extracts the same checkpoint at 8 with the
# published flags), and its optimization flags with 1 epoch (2 until the
# smoke was brought under half its time limit: one epoch already gains
# 2.13 dB with the tile and the march optimizer, 18.36 -> 20.49 dB on
# NVIDIA H100 80GB HBM3, 700 W).
EXTRACT_DEPTH = 6
EXTRACT_FLAGS = [
    "--autoscale", "--scale_alpha_thresh", "0.1", "--radius", "1.4", "--samples_per_cell", "256",
    "--no_early_stop", "--renderer_step_size", "1e-5", "--init_grid_depth", str(EXTRACT_DEPTH),
]
OPT_FLAGS = [
    "--num_epochs", "1", "--sgd", "--lr", "1e7", "--no_early_stop", "--renderer_step_size", "1e-5",
    "--val_interval", "1",
]
OPT_RES = 200
OPT_STEPS = 12
OPT_PROFILE_STEPS = 3
# The optimizer step's device-time split: the tile kernels by kernel name;
# the gather of leaf data into the soa's data rows and its autograd, the
# instance -> leaf segment-sum, by the op that launches them (the step runs
# no other index_select or index_add_).
OPT_STEP_KERNELS = {"backward_kernel": "tile_composite_bwd_kernel",
                    "forward_kernel": "tile_composite_kernel"}
OPT_STEP_OPS = {"gather": "aten::index_select", "segment_sum": "aten::index_add_"}
# Washing the DC colour coefficients turns the leaves grey; an SGD epoch
# over 12 views must win back at least this much val PSNR. It was set as
# the midpoint of this cell's two readings on the H100 over two epochs:
# +3.51 dB with the sound gradient (18.36 -> 21.87 dB in each of three
# runs) and +0.00 dB with the gradient's sign flipped (the control run
# below: the best snapshot stays the initial tree); the first epoch alone
# gains 2.13 dB (tile optimizer) and 2.13 dB (march), still above it (same
# card: NVIDIA H100 80GB HBM3, 700 W).
OPT_MIN_GAIN_DB = 1.75
# Gather kernel vs plain (phase 14), at the probes' sizes: K x R indices
# into a 32k-row (7.3 MB) table of N(0, 1) values, D = 56, each variant with
# the wrapper's own placement (the 32k-row table sliced across the SMs) and
# with the L2 placement (the kernel's first design); the shared-memory
# placement on the table's first 1024 rows. Each output sums n rows; kernel and plain version
# are held to a float64 sum of the same rows: an f32 running sum errs by at
# most 2^-24 of itself per addition, and a running sum of n zero-mean terms
# stays within ~4 sqrt(n) rms, so tol = 2^-24 * L * 4 sqrt(n) rms with L the
# launch's longest chain of additions (gather_sum.addition_chain: the rows
# one lane group adds in turn, the block's groups, the finish pass; for the
# sliced placement from this stream's longest bucket): 0.01-0.2 here.
GATHER_K, GATHER_R, GATHER_ROWS, GATHER_SMEM_ROWS, GATHER_D = 256, 8192, 1 << 15, 1024, 56
# The exact march (phases 15-18). The fast march frame and the served tile
# frame of one pose (same thresholds; the tile path's within-chunk order is
# approximate, the march's is per ray) must agree to this PSNR: predicted
# 35-50 dB before the first run (PERF.md), gated below that.
MARCH_SERVED_MIN_PSNR = 30.0
# LPIPS of one image pair on the card vs the CPU: f32 convolutions in
# another order agree to ~1e-7 relative; TF32 (cuDNN's default for f32
# convolutions) would move the distance by ~1e-3.
LPIPS_RTOL = 1e-4
# The march optimizer's step at 800x800 (chunks as the optimize CLI sizes
# them on this card), timed over this many steps; its device time by part
# (the profiler ranges of octree/optimize.py) from one profiled chunk: a
# profiler window over whole steps of ~10^5 small launches took ~130 s each.
# 1 step after the warm-up (3 until the smoke was brought under half its
# time limit: they read 5.11 / 4.99 / 5.26 s, within 6% of each other;
# NVIDIA H100 80GB HBM3, 700 W).
MARCH_OPT_STEPS = 1
MARCH_STEP_RANGES = {"march": "pn_march", "shade": "pn_shade", "update": "pn_update"}
# The SG head's slice (phases 19-23). SG25 trains with its config's batch
# (1024) and samples (64 + 128); every later stage gets the model flags it
# was trained with, as phase 9 does.
SG_CONFIG = "nerf_sh/config/misc/sg"
TRAINED_MODEL_FLAGS = ["--use_pallas", "--compute_dtype", "bfloat16"]
FLEET_EPOCHS = 1  # of the published 80, as phase 13 is cut
# Two fleet workers on the one card: each stage is a process start, an
# index or accel build and little device work, so the two tasks overlap
# (134-159 s one after the other, 93 s side by side; NVIDIA H100 80GB
# HBM3, 700 W).
FLEET_GPUS = "0 0"
# The fleet's views, 12 train / 4 test / 4 val of the synthetic scene, cut
# from the published 800x800. The extraction's visibility mask keeps more
# leaves the more rays it casts, and every stage does more work: with
# 2^20-point dispatches (python -m plenoctree_tpu_torch.bench_fleet, H100
# 80GB HBM3, 700 W) the fleet took 216 s at 48x48 (4.9M / 5.3M leaves at
# depth 8) and 282 s at 64x64 (7.1M / 7.7M), and compressing its trees
# 147 s and 241 s. At 32x32 the two fleets side by side took 129-134 s of
# a 915 s smoke run (H100 80GB HBM3, 700 W), hence 16x16, to keep the
# smoke under half its 1200 s limit.
FLEET_RES = 16
# The decoded 16-bit SG25 tree's frame against the uncompressed tree's:
# the compressor zeroes every voxel with sigma <= 2 (a thin fog over a
# 200-step NeRF's volume) and quantizes each basis function to 2^16 fp16
# colours. Predicted 25-35 dB against the uncompressed tree, 40-55 dB
# against the uncompressed tree with the same sigma cut (the palette's own
# error) before the first run (PERF.md); a decode that misplaces a channel
# or a basis function lands near 10 dB.
COMPRESS_MIN_PSNR = 20.0
COMPRESS_PALETTE_MIN_PSNR = 35.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
# Phases 24-27, the real-capture slice (cuts in PERF.md section 4):
TT_CONFIG = "nerf_sh/config/tt"  # SH25, 8x256, 64 + 128 samples, batch 1024
TT_TASKS = "octree/config/tt_sh25.json"
TT_EPOCHS = 1  # of the published 40
TT_VIEWS = (10, 4)  # NSVF fixture train (0_) / test (1_) views, at FLEET_RES
LLFF_RES = 64
LLFF_VIEWS = 20  # llffhold 8: views 0, 8, 16 are the test split
LLFF_DEPTH = 7  # extraction's init_grid_depth, cut from 8
# The NDC tile frame against the NDC march frame of the same pose (the
# bound of the JAX package's test_ndc_matches_march).
NDC_MIN_PSNR = 40.0
NDC_FOCAL = 1.25 * RES  # the JAX test's 40 / 32
N_NDC_ORBIT = 8
PROJ_CONFIG = "nerf_sh/config/misc/proj"  # use_viewdirs, projected to SH degree 4
PROJ_DEPTH = 5  # extraction's init_grid_depth, cut from 8
JAX_FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jax_ckpt")
JAX_FIXTURE_FLAGS = ["--net_depth", "2", "--net_width", "16"]  # make_jax_checkpoints.py
GEN_VIDEO_VIEWS = 2  # of the published 40
GEN_MESH_RESO = 300
GEN_MESH_CHUNK = 720720
GEN_MESH_LAUNCHES = -(-GEN_MESH_RESO ** 3 // GEN_MESH_CHUNK)  # 38
GEN_MESH_FALLBACK_ISO = 0.5  # x the grid's max sigma, where it stays below 6.0
MARCH_SUB = 64  # the sub-volume held card against CPU
EXTRAS_STEPS = 12
# The projection's chunk: 10 leaves per dispatch (8 samples x 1,000 of the
# 10,000 directions each, the JAX chunking rule), where the published 8192
# makes one leaf per dispatch (34k dispatches: 127 s at depth 5).
PROJ_CHUNK = 81920
# Phases 33-35, multi-device on the one card: the train CLI under
# torch.distributed.run (2 gloo ranks on cuda:0, then 1 NCCL rank), and
# serving and inference over [cuda:0, cuda:0].
DP_STEPS = 20
TP_STEPS = 20
NCCL_STEPS = 5
DP_CLI_TIMEOUT = 300
N_SHARDED_POSES = 4
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def tile_subset(p2):
    """The plain versions' tiles (PLAIN_SUBSET_TILES): the tile with the most
    pieces and every (tiles // 63)-th one, as an index tensor."""
    pieces = p2[0][:, 0, 0]
    n = pieces.shape[0]
    step = max(1, n // (PLAIN_SUBSET_TILES - 1))
    picked = sorted(set(range(0, n, step)[: PLAIN_SUBSET_TILES - 1]) | {int(pieces.argmax())})
    return torch.tensor(picked, device=pieces.device)


def take_tiles(p2, idx):
    return tuple(a[idx] for a in p2)


def timed_once_ms(fn):
    """One call's wall ms, the device synchronized on both sides (for the
    plain versions' whole-frame times: seconds each, no warm-up needed)."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t1) * 1e3


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


def native_build():
    """The port's native host library, built by g++ from the checkout's
    csrc/plenoctree_native.cc (with the kernels, in parallel): the run fails
    without it, since the extract, compress and fleet phases must take the
    native path, as the JAX package does on a host with g++."""
    from plenoctree_tpu_torch import native

    if native.get_lib() is None:
        raise RuntimeError(f"the native host library did not build or load: {native.build_error}")


def reset_native_calls():
    """Zero the native library's call counters; returns the live dict, so a
    phase reads its own calls after it ran."""
    from plenoctree_tpu_torch import native

    for k in native.calls:
        native.calls[k] = 0
    return native.calls


def fleet_native_lines(fleet_dir):
    """The extract stages' `native:` lines in a fleet's log (each stage's
    calls to the native library, in its own process)."""
    with open(os.path.join(fleet_dir, "fleet.log")) as f:
        return [x.split("native:", 1)[1].strip() for x in f if x.startswith("  native:")]


def blender_round_trip():
    """Phase 3b: the synthetic views written as a blender-layout scene with
    the port's PNG writer, then read back through the Blender loader (the
    port's PNG decoder; --factor 2 through its box mean): no PIL, imageio
    or cv2 on this host."""
    from plenoctree_tpu_torch.data import get_dataset
    from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene, write_blender_dataset
    from plenoctree_tpu_torch.utils.config import default_config

    t0 = time.time()
    scene = write_blender_dataset(os.path.join(ROOT, "build", "smoke", "blender"), 12, 4, EVAL_RES)
    t_write = time.time() - t0
    errs = {}
    for split, n, factor in (("test", 4, 0), ("train", 12, 2)):
        args = default_config(config="nerf_sh/config/blender", dataset="blender", data_dir=scene,
                              factor=factor, image_batching=False)
        ds = get_dataset(split, args)
        views, c2ws, _ = render_synthetic_scene(split, n, EVAL_RES, True, 2.0, 6.0)
        want = (views * 255).astype(np.uint8).astype(np.float32) / 255.0
        if factor:
            want = want.reshape(n, EVAL_RES // 2, 2, EVAL_RES // 2, 2, 3).mean((2, 4))
        got = ds.images.reshape(want.shape)
        errs[split] = float(np.abs(got - want).max())
        if not (np.array_equal(ds.camtoworlds, c2ws) and errs[split] <= 1e-6):
            raise RuntimeError(f"blender round trip ({split}, factor {factor}): {errs[split]}")
    phase("blender scene (write_png, Blender loader)", t0, path=scene, write_s=round(t_write, 2),
          max_abs_err=json.dumps(errs))


def trunk_vs_plain(dev):
    """Phase 7: the fused trunk kernels against their plain versions, for
    every variant at its TRUNK_CELLS row counts, on bench_trunk's draws;
    returns {(variant, rows): numbers}."""
    from plenoctree_tpu_torch import bench_trunk
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.models.params import init_trunk_params, trunk_weights

    params = init_trunk_params(np.random.default_rng(SEED), 63, 8, 256, 4, 1, 48,
                               bias_std=TRUNK_BIAS_STD)
    # The SG25 head (nerf_sh/config/misc/sg): 1 + 75 columns, padded to the
    # wgmma width 128 (the SH16 head's 1 + 48 take 64).
    sg_params = init_trunk_params(np.random.default_rng(SEED), 63, 8, 256, 4, 1, 75,
                                  bias_std=TRUNK_BIAS_STD)
    cells = [(name, params, pe, sh_dim) for name, (pe, sh_dim) in bench_trunk.VARIANTS.items()]
    cells.append(("sg25", sg_params, None, 0))
    # The SH25 head (nerf_sh/config/tt) has the SG25 head's shape.
    cells += [("sh25", sg_params, None, 0), ("sh25+sh", sg_params, None, 25)]
    results = {}
    for name, cell_params, pe, sh_dim in cells:
        flat, meta = trunk_weights(cell_params, 4, dev, pe, sh_dim)
        for n in TRUNK_CELLS[name]:
            t0 = time.time()
            n_rgb = cell_params["Dense_9"]["kernel"].shape[1]
            x, basis, gs, gr = bench_trunk.inputs(n, SEED, pe, sh_dim, dev, n_rgb)
            if name == "sg25":  # cotangents of the 75 SG amplitudes, drawn as before
                gr = torch.tensor(np.random.default_rng(SEED + n).normal(size=(n, 75)) * 1e-3,
                                  dtype=torch.float32, device=dev)
            s, r = fused_mlp.fused_trunk(flat, x, meta, basis)
            grads = fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta, basis)
            again = fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta, basis)
            torch.cuda.synchronize()
            rerun_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
            del again
            rs, rr = fused_mlp.fused_trunk_reference(flat, x, meta, basis)
            ref = fused_mlp.fused_trunk_bwd_reference(flat, x, gs, gr, meta, basis)
            if not all(torch.isfinite(t).all() for t in (s, r, *grads)):
                raise RuntimeError(f"non-finite fused trunk output ({name}, {n} rows)")
            if r.shape != rr.shape:
                raise RuntimeError(f"rgb shape {tuple(r.shape)}, want {tuple(rr.shape)}")
            fwd_err = max(float((s - rs).abs().max()), float((r - rr).abs().max()))
            rel = [float((a - b).abs().max() / (b.abs().max() + 1e-30)) for a, b in zip(grads, ref)]
            bwd_abs = max(float((a - b).abs().max()) for a, b in zip(grads, ref))
            floor = None  # (kernel vs f64, plain vs f64, within the factor)
            if n == TRUNK_SMALL_ROWS:
                exact = bench_trunk.bwd_f64(flat, x, gs, gr, meta, basis)
                floor = bench_trunk.within_noise_floor(grads, ref, exact)
                del exact
            del rs, rr, ref
            fwd = lambda: fused_mlp.fused_trunk(flat, x, meta, basis)
            bwd = lambda: fused_mlp.fused_trunk_bwd(flat, x, gs, gr, meta, basis)
            fwd_ms = cuda_ms(fwd, 10)
            bwd_ms = cuda_ms(bwd, 5)
            fwd_plain = cuda_ms(lambda: fused_mlp.fused_trunk_reference(flat, x, meta, basis), 3)
            bwd_plain = cuda_ms(
                lambda: fused_mlp.fused_trunk_bwd_reference(flat, x, gs, gr, meta, basis), 3)
            lib_fwd, lib_bwd = trunk_library(flat, x, gs, gr, meta, basis)
            bound_fwd = trunk_bound(flat, meta, n, 1)
            bound_bwd = trunk_bound(flat, meta, n, 3)
            res = dict(fwd_err=fwd_err, bwd_abs=bwd_abs, fwd_ms=fwd_ms, fwd_plain=fwd_plain,
                       bwd_ms=bwd_ms, bwd_plain=bwd_plain, lib_fwd=lib_fwd, lib_bwd=lib_bwd,
                       bound_fwd=bound_fwd, bound_bwd=bound_bwd, rerun_equal=rerun_equal,
                       ws_floor_ms=trunk_workspace_floor(meta, n),
                       **trunk_l2_bytes_per_row(meta))
            phase(
                f"trunk kernel vs plain ({name}, {n} rows)", t0, fwd_max_abs_err=fwd_err,
                fwd_tol=TRUNK_FWD_ATOL, grad_max_rel_err=max(rel),
                grad_tol=TRUNK_GRAD_RTOL if floor is None else None,
                grad_kernel_vs_f64=floor and floor[0], grad_plain_vs_f64=floor and floor[1],
                grad_floor_factor=floor and bench_trunk.TRUNK_SMALL_ROW_FACTOR,
                grad_rel_per_array=[round(e, 6) for e in rel], bwd_rerun_bitwise_equal=rerun_equal,
                fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain,
                library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd, bound_fwd=bound_fwd,
                bound_bwd=bound_bwd, bwd_workspace_floor_ms=res["ws_floor_ms"],
                l2_weight_bytes_per_row_fwd=res["l2_fwd"], l2_weight_bytes_per_row_bwd=res["l2_bwd"],
            )
            if not fwd_err <= TRUNK_FWD_ATOL:
                raise RuntimeError(f"trunk forward disagrees ({name}): {fwd_err} > {TRUNK_FWD_ATOL}")
            if floor is None and not max(rel) <= TRUNK_GRAD_RTOL:
                raise RuntimeError(
                    f"trunk backward disagrees ({name}): {max(rel)} > {TRUNK_GRAD_RTOL}")
            if floor is not None and not floor[2]:
                raise RuntimeError(
                    f"trunk backward off the noise floor ({name}, {n} rows): {floor[0]} from f64 > "
                    f"{bench_trunk.TRUNK_SMALL_ROW_FACTOR} x the plain version's {floor[1]}")
            if not rerun_equal:
                raise RuntimeError(f"trunk backward reruns differ ({name}, {n} rows)")
            results[name, n] = res
            del x, basis, gs, gr, s, r, grads
            torch.cuda.empty_cache()
    return results


def trunk_bound(flat, meta, n, passes):
    """The trunk's bound at n rows: 2 flops per multiply-add of every layer
    (passes=1 forward; 3 for the weight gradients: recompute, cotangents
    through the layers, dW) at the bf16 tensor-core peak, against the bytes
    each call must move once at the memory rate: x (the raw [n, 3] points
    under posenc, else [n, 63]) and the basis [n, K] with the SH decode,
    the weights, and the outputs [n, 1 + C] (forward) or the cotangents
    and the weight gradients (backward), in f32. The posenc sines and the
    decode's multiply-adds are not counted (under 1% of the flops)."""
    macs = sum(w.shape[0] * w.shape[1] for w in flat[0::2])
    flops = 2.0 * n * macs * passes
    sh = meta.get("sh_dim") or 0
    x_cols = 3 if meta.get("posenc") else meta["d_in"]
    out_cols = meta["n_sigma"] + ((meta["d_out"] - meta["n_sigma"]) // sh if sh else
                                  meta["d_out"] - meta["n_sigma"])
    weights = sum(w.numel() for w in flat) * 4
    nbytes = 4.0 * n * (x_cols + sh + out_cols) + weights * (1 if passes == 1 else 2)
    return bound_of(nbytes, flops, BF16_TC_FLOPS)


def trunk_workspace_floor(meta, n):
    """ms to write and read once, at the memory rate, the backward's
    workspace: per row each layer's bf16 input image (the x tile, every
    activation) and cotangent image (every layer's dpre)."""
    from plenoctree_tpu_torch.kernels import fused_mlp

    lay = fused_mlp._layout(meta)
    per_row = 2 * (lay.xp + meta["depth"] * meta["width"] + sum(l[2] for l in lay.layers))
    return 2.0 * per_row * n / HBM_BYTES_PER_S * 1e3


def trunk_l2_bytes_per_row(meta):
    """Weight bytes the kernels stream from L2 per row: the slabs a 128-row
    block tile reads, over 128 (forward: layers 0..depth; backward pass 1:
    the recompute's, without the head, and the dh products')."""
    from plenoctree_tpu_torch.kernels import fused_mlp

    lay = fused_mlp._layout(meta)
    fwd = lay.slabs[lay.n_fwd][4] if lay.n_fwd < len(lay.slabs) else lay.stream_bytes
    head = fwd - min(off for i, _, _, _, off in lay.slabs[: lay.n_fwd] if i == meta["depth"])
    return {"l2_fwd": fwd / 128.0, "l2_bwd": (lay.stream_bytes - head) / 128.0}


def trunk_library(flat, x, gs, gr, meta, basis=None):
    """The same MLP as a chain of bf16 torch.nn.functional.linear + relu
    calls (cuBLAS), with torch's posenc in front and the SH einsum behind
    for the variants: ms of the forward, and of forward + autograd backward
    to the weights (the kernel's backward recomputes the forward too)."""
    import torch.nn.functional as F

    from plenoctree_tpu_torch.ops.posenc import posenc

    depth, skip, pe = meta["depth"], meta["skip_layer"], meta.get("posenc")
    sh = meta.get("sh_dim") or 0
    w = [t.t().contiguous().bfloat16().requires_grad_() for t in flat[0::2]]
    b = [t.reshape(-1).bfloat16().requires_grad_() for t in flat[1::2]]
    g = torch.cat([gs, gr], dim=-1).bfloat16()

    def chain():
        xb = (posenc(x, pe[0], pe[1]) if pe else x).bfloat16()
        h = xb
        for i in range(depth):
            h = F.relu(F.linear(h, w[i], b[i]))
            if i % skip == 0 and i > 0:
                h = torch.cat([h, xb], dim=-1)
        out = F.linear(h, w[depth], b[depth])
        if sh:
            ns = meta["n_sigma"]
            rgb = torch.einsum("nck,nk->nc", out[:, ns:].float().reshape(out.shape[0], -1, sh),
                               basis)
            out = torch.cat([out[:, :ns].float(), rgb], dim=-1).bfloat16()
        return out

    def fwd():
        with torch.no_grad():
            chain()

    def fwd_bwd():
        torch.autograd.grad(chain(), w + b, g)

    return cuda_ms(fwd, 10), cuda_ms(fwd_bwd, 5)


def tile_work(p2, soa, sigma_row, quantum, extra_bytes):
    """(bytes, flops) a tile kernel needs on these phase-1 inputs: every
    input tensor once, the first sigma_row + 1 rows of each soa block the
    pieces name once (the rows a kernel reads; the soa's fields past
    sigma_row are padding), plus extra_bytes (outputs); flops: the slab
    test (6 FMAs) of every live sigma > 0 row of every piece against the
    rays of the piece's quad groups."""
    meta, c0, lo, hi, mask = (t[:, 0] for t in p2[:5])
    rays = p2[5].shape[1]
    valid = torch.arange(c0.shape[-1], device=c0.device)[None] < meta[:, :1]
    c0, lo, hi, mask = c0[valid].long(), lo[valid], hi[valid], mask[valid]
    blocks = c0 // quantum
    nbytes = sum(t.numel() * t.element_size() for t in p2) + extra_bytes
    nbytes += torch.unique(blocks).numel() * (sigma_row + 1) * quantum * soa.element_size()
    pairs = 0
    for i in range(0, c0.numel(), 1 << 16):
        sl = slice(i, i + (1 << 16))
        rows = c0[sl, None] + torch.arange(quantum, device=c0.device)
        live = (rows >= lo[sl, None]) & (rows < hi[sl, None]) & (soa[blocks[sl], sigma_row] > 0)
        groups = sum((mask[sl] >> k) & 1 for k in range(4))
        pairs += int((live.sum(1) * groups).sum()) * (rays // 4)
    return float(nbytes), 12.0 * pairs


def bound_of(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    # The CLI prints a line per step: keep them out of the smoke's output.
    with open(os.path.join(train_dir, "train.log"), "w") as log, contextlib.redirect_stdout(log):
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
    return launches, train_dir


@contextlib.contextmanager
def kernel_switches(on):
    """PN_POSENC_IN_KERNEL and PN_SH_IN_KERNEL set to 1 (on) or unset for
    the block, as a user sets them for the train CLI and the bench."""
    names = ("PN_POSENC_IN_KERNEL", "PN_SH_IN_KERNEL")
    old = {k: os.environ.get(k) for k in names}
    for k in names:
        if on:
            os.environ[k] = "1"
        else:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def train_variants_path():
    """Phase 8b: the train CLI with both kernel switches on, VARIANT_STEPS
    steps on phase 8's data and flags: both trunk kernels launched, every
    launch on the variant path (the wrapper's variant counters), train PSNR
    rising."""
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.utils.metrics_writer import read_scalars

    t0 = time.time()
    train_dir = tempfile.mkdtemp(prefix="train_var_", dir=os.path.join(ROOT, "build", "smoke"))
    fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
    fused_mlp.posenc_launches = fused_mlp.sh_launches = 0
    with kernel_switches(True), open(os.path.join(train_dir, "train.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        train_cli.main([
            "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--train_dir", train_dir, "--device", "cuda", "--use_pallas",
            "--compute_dtype", "bfloat16", "--batch_size", str(BENCH_BATCH), "--image_batching",
            "--max_steps", str(VARIANT_STEPS), "--lr_final", "5e-5", "--print_every", "1",
            "--save_every", str(VARIANT_STEPS), "--render_every", str(10 * VARIANT_STEPS),
        ])
    torch.cuda.synchronize()
    counts = dict(fwd=fused_mlp.fwd_launches, bwd=fused_mlp.bwd_launches,
                  posenc=fused_mlp.posenc_launches, sh=fused_mlp.sh_launches)
    psnr = [v for _, v in read_scalars(train_dir, "train_psnr")]
    first, last = float(np.mean(psnr[:10])), float(np.mean(psnr[-10:]))
    phase("train main path (PN_POSENC_IN_KERNEL=1 PN_SH_IN_KERNEL=1)", t0, steps=len(psnr),
          launches=json.dumps(counts), psnr_first10=first, psnr_last10=last)
    # Every step launches 3 forwards (coarse, fine, sparsity points) and 3
    # backwards, all with the in-kernel posenc; the SH decode runs in the
    # coarse and fine ones (the sparsity points need no colour).
    if min(counts["fwd"], counts["bwd"]) <= 0:
        raise RuntimeError(f"the variant train run did not launch both trunk kernels: {counts}")
    if counts["posenc"] != counts["fwd"] + counts["bwd"]:
        raise RuntimeError(f"not every trunk launch took the in-kernel posenc: {counts}")
    if counts["sh"] != 2 * (counts["fwd"] + counts["bwd"]) // 3:
        raise RuntimeError(f"the SH decode did not run in the coarse and fine passes: {counts}")
    if len(psnr) != VARIANT_STEPS or not all(math.isfinite(v) for v in psnr):
        raise RuntimeError(f"bad variant train PSNR trace ({len(psnr)} values)")
    if not last > first:
        raise RuntimeError(f"variant train PSNR did not rise: first 10 {first}, last 10 {last}")
    return counts


def train_throughput(switches_on):
    """Phase 10: the port's bench at batch 4096, with the kernel switches
    off or on."""
    from plenoctree_tpu_torch import bench

    t0 = time.time()
    with kernel_switches(switches_on):
        res = bench.run(BENCH_BATCH, BENCH_STEPS, profile_window=3)
    phase(
        f"train throughput (switches {'on' if switches_on else 'off'})", t0,
        posenc_in_kernel=res["posenc_in_kernel"], sh_in_kernel=res["sh_in_kernel"],
        rays_per_sec=res["rays_per_sec"], ms_per_step=res["ms_per_step"],
        peak_mem_gib=res["peak_mem_gib"], device_ms_per_step=res["device_ms_per_step"],
        trunk_kernel_ms_per_step=res["trunk_kernel_ms_per_step"],
        trunk_share=res["trunk_share"], idle_share=res["idle_share"],
        top_kernels=json.dumps(res["top_kernels"]),
        vs_baseline=res["rays_per_sec"] / bench.BASELINE_RAYS_PER_SEC,
    )
    if not (math.isfinite(res["rays_per_sec"]) and math.isfinite(res["final_psnr"])):
        raise RuntimeError(f"bad bench result {res}")
    if (res["posenc_in_kernel"], res["sh_in_kernel"]) != (switches_on, switches_on):
        raise RuntimeError(f"the bench ran with other switches: {res}")
    return res


def extract_main_path(train_dir):
    """Phase 9: the extract CLI on the train phase's checkpoint."""
    from plenoctree_tpu_torch.cli import extract as extract_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.renderer import VolumeRenderer

    t0 = time.time()
    out = os.path.join(ROOT, "build", "smoke", "extract", "tree.npz")
    fused_mlp.fwd_launches = 0
    native_calls = reset_native_calls()
    steps = {}
    lines = []

    def clock(text):
        for line in text.splitlines():
            if line.startswith("* "):
                steps[line[2:].strip()] = round(time.time() - t0, 2)
            lines.append(line)

    with contextlib.redirect_stdout(_Tee(clock)):
        tree = extract_cli.main([
            "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--train_dir", train_dir, "--device", "cuda", "--use_pallas",
            "--compute_dtype", "bfloat16", "--output", out, *EXTRACT_FLAGS,
        ])
    torch.cuda.synchronize()
    launches = fused_mlp.fwd_launches
    with open(out + ".results.json") as f:
        results = json.load(f)
    back = N3Tree.load(out)
    # One 800x800 frame of this tree through the march, in the eval's mode
    # (exact, step 1e-5); its accel grid is budgeted (a residual descent).
    t1 = time.time()
    vr = VolumeRenderer(tree, step_size=1e-5, device="cuda")
    build_s = time.time() - t1
    t1 = time.perf_counter()
    img = vr.render_persp(orbit_pose(0.0), RES, RES, 1.1 * RES, fast=False)
    frame_ms = (time.perf_counter() - t1) * 1e3
    phase(
        "extract main path", t0, fwd_launches=launches, leaves=tree.n_leaves,
        reloaded_leaves=back.n_leaves, depth=back.max_depth, eval_psnr=results["psnr"],
        eval_ssim=results["ssim"], step_clock_s=json.dumps(steps),
        march_800_exact_ms=frame_ms, march_host_build_s=round(build_s, 2),
        accel_level=vr.arrays["accel_level"], accel_reso=vr.arrays["accel_reso"],
        K_estimated=vr.contrib_slots, K_exact=vr._get_deferred(False).K,
        native_calls=json.dumps(native_calls),
    )
    if native_calls["build_octree"] <= 0:
        raise RuntimeError(f"the extract CLI did not build its tree natively: {native_calls}")
    # At this depth the full accel grid fits its budget; phase 21b holds the
    # fleet's depth-8 tree to a budgeted one.
    if not (np.isfinite(img).all() and vr.arrays["accel_level"] <= back.max_depth + 1):
        raise RuntimeError("bad march frame of the extracted tree, or a bad accel grid")
    if launches <= 0:
        raise RuntimeError("the extract CLI never launched the trunk forward kernel")
    if back.n_leaves != tree.n_leaves or back.max_depth != EXTRACT_DEPTH or tree.n_leaves == 0:
        raise RuntimeError(f"bad extracted tree: {back}")
    if not math.isfinite(results["psnr"]):
        raise RuntimeError(f"bad extraction eval {results}")
    return launches


class _Tee:
    """stdout that also hands each complete line to a callback."""

    def __init__(self, fn):
        self.fn, self.out, self.buf = fn, sys.stdout, ""

    def write(self, text):
        self.buf += text
        if "\n" in self.buf:
            done, self.buf = self.buf.rsplit("\n", 1)
            self.fn(done)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def exact_inputs(opt, c2w):
    """The optimizer's tile inputs for one 800x800 pose; fails if its caps
    would drop geometry."""
    focal = 1.1 * RES
    r = opt.r
    r.w1cap = r.w1cap or int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / focal * r.grid_c) + 3))
    ti = r.make_tile_inputs_fn(RES, RES, focal, r.rcap, r.w1cap, r.ccap)
    idx = r.index
    p2, _, nck, w1o = ti(c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])
    if int(nck.max()) > r.ccap or int(w1o.max()) > 0:
        raise RuntimeError(f"caps too small at 800x800: pieces {int(nck.max())}, w1 {int(w1o.max())}")
    return ti, p2


def tile_bwd_vs_plain(tree, label="tile bwd kernel vs plain", time_plain=True):
    """Phase 11 (and 22 on the SG25 tree): the tile backward kernel on the
    whole frame, with the cotangent zero outside the PLAIN_SUBSET_TILES
    subset, against its plain version on that subset (the kernel's rerun
    check and times with the whole cotangent); with time_plain, one timed
    whole-frame run of the plain backward (the kernels line's)."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.kernels import tile_composite as K
    from plenoctree_tpu_torch.octree.tile_opt import TileOptimizer

    t0 = time.time()
    opt = TileOptimizer(tree, step_size=1e-5, ccap=512, device="cuda")
    t_index = time.time() - t0
    ti, p2 = exact_inputs(opt, orbit_pose(0.3))
    soa, kw = opt.static_soa, opt._kw
    fwd = lambda: K.composite_tiles(*p2, soa, **kw, stop_thresh=0.0, od_cap=1e30)  # noqa: E731
    out = fwd()
    # The exact-mode forward against its plain version first: the backward
    # check below feeds this `out` to both sides, so it cannot see a wrong one.
    sub = tile_subset(p2)
    p2s = take_tiles(p2, sub)
    out_ref, fwd_plain_ms = timed_once_ms(
        lambda: K.composite_tiles_reference(*p2s, soa, **kw, stop_thresh=0.0, od_cap=1e30))
    fwd_err = float((out[sub] - out_ref).abs().max())
    del out_ref
    if not (bool(torch.isfinite(out).all()) and fwd_err <= KERNEL_ATOL):
        raise RuntimeError(f"exact-mode tile kernel disagrees with the plain version: {fwd_err}")
    g = torch.tensor(np.random.default_rng(SEED).normal(size=tuple(out.shape)), dtype=torch.float32,
                     device=out.device)
    K.bwd_atomic_counts(reset=True)
    got = K.composite_tiles_bwd(*p2, soa, out, g, **kw)
    torch.cuda.synchronize()
    quads, floats = K.bwd_atomic_counts(reset=True)  # one launch's float4 atomics
    again = K.composite_tiles_bwd(*p2, soa, out, g, **kw)
    torch.cuda.synchronize()
    # Held to the plain version at the main path's shape: the kernel on the
    # whole frame with the cotangent zero outside the subset. The backward
    # is linear in g, so that gradient is the subset tiles' alone.
    g_sub = torch.zeros_like(g)
    g_sub[sub] = g[sub]
    got_sub = K.composite_tiles_bwd(*p2, soa, out, g_sub, **kw)
    del g_sub
    ref, ms_p_sub = timed_once_ms(
        lambda: K.composite_tiles_bwd_reference(*p2s, soa, out[sub], g[sub], **kw))
    sr = kw["sigma_row"]
    errs = {}
    for name, sl in (("sigma", slice(sr, sr + 1)), ("colour", slice(6, sr))):
        errs[name] = (float((got_sub[:, sl] - ref[:, sl]).abs().max())
                      / float(ref[:, sl].abs().max()),
                      float((again[:, sl] - got[:, sl]).abs().max())
                      / float(got[:, sl].abs().max()))
    finite = bool(torch.isfinite(got).all())
    untouched = not bool(got[:, :6].any() or got[:, sr + 1 :].any())
    max_abs_err = float((got_sub - ref).abs().max())
    del got_sub, ref
    ms_k = cuda_ms(lambda: K.composite_tiles_bwd(*p2, soa, out, g, **kw), 5)
    ms_p = (timed_once_ms(lambda: K.composite_tiles_bwd_reference(*p2, soa, out, g, **kw))[1]
            if time_plain else None)
    ms_f = cuda_ms(fwd, 5)
    # The backward also reads `out` and `g` and writes the gradient soa's
    # non-padding rows (sigma_row + 1 per block).
    gsoa_bytes = soa.shape[0] * (sr + 1) * opt.r.quantum * soa.element_size()
    nbytes, flops = tile_work(p2, soa, sr, opt.r.quantum, out.numel() * 4 * 2 + gsoa_bytes)
    bound_ms, bound_by = bound_of(nbytes, flops, F32_FLOPS)
    fwd_bound = bound_of(*tile_work(p2, soa, sr, opt.r.quantum, out.numel() * 4), F32_FLOPS)
    pieces = p2[0][:, 0, 0]
    phase(
        label, t0, index_build_s=round(t_index, 2), tiles=pieces.numel(),
        pieces_total=int(pieces.sum()), pieces_max=int(pieces.max()), ccap=opt.r.ccap,
        plain_tiles=sub.numel(), plain_ms_on_subset=ms_p_sub,
        sigma_rel_err=errs["sigma"][0], colour_rel_err=errs["colour"][0], tol=BWD_RTOL,
        sigma_rerun_rel=errs["sigma"][1], colour_rerun_rel=errs["colour"][1],
        rerun_tol=BWD_RERUN_RTOL, max_abs_err=max_abs_err, kernel_ms=ms_k, plain_ms=ms_p,
        fwd_exact_max_abs_err=fwd_err, fwd_exact_tol=KERNEL_ATOL, fwd_exact_kernel_ms=ms_f,
        fwd_exact_plain_ms_on_subset=fwd_plain_ms, fwd_exact_bound_ms=fwd_bound[0], bound_ms=bound_ms,
        bound_by=bound_by, soa_gib=soa.numel() * 4 / 2**30, bwd_float4_atomics=quads,
        bwd_atomic_nonzero_floats=floats,
    )
    if not (finite and untouched):
        raise RuntimeError("tile backward kernel: non-finite or misplaced gradients")
    if not max(e[0] for e in errs.values()) <= BWD_RTOL:
        raise RuntimeError(f"tile backward kernel disagrees with the plain version: {errs}")
    if not max(e[1] for e in errs.values()) <= BWD_RERUN_RTOL:
        raise RuntimeError(f"two tile backward kernel runs differ too much: {errs}")
    del got, again
    return opt, ti, dict(max_abs_err=max_abs_err, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                         bound_by=bound_by, fwd_exact_err=fwd_err)


def device_split(prof, kernels, ops, n_steps):
    """Device ms per step from a torch.profiler window: per group of
    `kernels` (kernel-name substrings) and of `ops` (the device time of the
    kernels an op launched), the rest as "other"; and the top kernels as
    (ms per step, name, launches per step)."""
    ms = dict.fromkeys([*kernels, *ops], 0.0)
    total, top = 0.0, []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        t = t / 1e3 / n_steps
        if ev.device_type.name == "CUDA" and ev.key in ops.values():
            continue  # a profiler range's span on the device, not a kernel
        if ev.device_type.name == "CUDA" and t:
            total += t
            top.append((round(t, 3), ev.key[:60], ev.count // n_steps))
            name = next((n for n, k in kernels.items() if k in ev.key), None)
            if name:
                ms[name] += t
        else:
            name = next((n for n, k in ops.items() if k == ev.key), None)
            if name:
                ms[name] += t
    ms["other"] = total - sum(ms.values())
    top.sort(reverse=True)
    return ms, top[:8]


def optimize_throughput(opt, ti):
    """Phase 12: ms per optimizer step at 800x800, and its split."""
    from torch.profiler import ProfilerActivity, profile

    from plenoctree_tpu_torch.data.poses import orbit_pose

    t0 = time.time()
    focal = 1.1 * RES
    lr = float(OPT_FLAGS[OPT_FLAGS.index("--lr") + 1])
    leaf = opt.initial_leaf_dataT()
    poses = [orbit_pose(2.0 * np.pi * k / OPT_STEPS) for k in range(OPT_STEPS)]
    gts = []
    rng = np.random.default_rng(SEED)
    for c2w in poses[:2]:
        img, _, _, _ = opt.render(leaf, c2w, RES, RES, focal)
        gts.append(np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1).astype(np.float32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(k):
        (_, (_, _, nck, w1o)), grad = opt.loss_and_grad(leaf, poses[k], gts[k % 2], RES, RES, focal)
        with torch.no_grad():
            leaf.add_(grad * -lr)
        return nck, w1o

    step(0)  # warm-up
    step_ms = []
    for k in range(OPT_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        nck, w1o = step(k)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        if int(nck) > opt.r.ccap or int(w1o) > 0:
            raise RuntimeError(f"an optimizer step dropped geometry (nc {int(nck)}, w1 {int(w1o)})")
    peak = torch.cuda.max_memory_allocated()
    step_med = float(np.median(step_ms))

    # Where the same steps spend device time: one profiler window over the
    # real step (groups: OPT_STEP_KERNELS, OPT_STEP_OPS). Tile inputs (phase
    # 1), the soa relayout, the loss and the update are small kernels in "other";
    # the host time between kernels is the idle share. The tile inputs'
    # wall time is also taken alone, on the function the step calls.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(OPT_PROFILE_STEPS):
            step(k)
        torch.cuda.synchronize()
    split, top = device_split(prof, OPT_STEP_KERNELS, OPT_STEP_OPS, OPT_PROFILE_STEPS)
    device_ms = sum(split.values())
    idx = opt.r.index
    inputs_ms = cuda_ms(lambda: ti(poses[0], idx["csr"], idx["base"], opt.r.extra_data,
                                   idx["blk_bbox"]), 5)
    phase(
        "optimize throughput", t0, res=RES, steps=OPT_STEPS, ms_per_step_median=step_med,
        ms_per_step_best=float(np.min(step_ms)), peak_mem_gib=peak / 2**30,
        device_ms_per_step=device_ms, device_split_ms=json.dumps(split),
        idle_share=1.0 - device_ms / step_med, tile_inputs_alone_ms=inputs_ms,
        top_kernels=json.dumps(top),
    )
    if not all(math.isfinite(v) for v in step_ms):
        raise RuntimeError("bad optimizer step times")
    if not all(v > 0 for v in split.values()):
        raise RuntimeError(f"a group of the profiled step shows no device time: {split}")
    return step_med


def optimize_main_path(tree):
    """Phase 13: the optimize CLI (--tile_opt) on the washed tree, then the
    eval CLI on its output."""
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.cli import optimize as optimize_cli
    from plenoctree_tpu_torch.kernels import tile_composite as K
    from plenoctree_tpu_torch.octree import N3Tree

    t0 = time.time()
    out_dir = os.path.join(ROOT, "build", "smoke", "optimize")
    os.makedirs(out_dir, exist_ok=True)
    washed = tree.clone()
    bd = washed.data_format.basis_dim
    washed.data[..., [0, bd, 2 * bd]] = 0.0  # the degree-0 term of each channel
    src, dst = os.path.join(out_dir, "tree_washed.npz"), os.path.join(out_dir, "tree_opt.npz")
    washed.save(src, compress=False)
    common = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic",
              "--synthetic_resolution", str(OPT_RES), "--device", "cuda"]
    K.launches = K.bwd_launches = 0
    initial, vals = [], []

    def grab(text):
        for line in text.splitlines():
            if line.startswith("** initial val psnr"):
                initial.append(float(line.split()[-1]))
            elif line.startswith("** val psnr"):  # "** val psnr <psnr> best <best>"
                vals.append(float(line.split()[3]))

    with contextlib.redirect_stdout(_Tee(grab)):
        best_tree, best_psnr = optimize_cli.main(common + [
            "--input", src, "--output", dst, "--tile_opt", *OPT_FLAGS,
        ])
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    loaded = N3Tree.load(dst) if os.path.isfile(dst) else None
    phase(
        "optimize main path", t0, fwd_launches=launches[0], bwd_launches=launches[1],
        initial_val_psnr=initial[0] if initial else None, val_psnr_per_epoch=vals,
        best_val_psnr=best_psnr, min_gain_db=OPT_MIN_GAIN_DB, tree_opt_leaves=None if loaded is None else loaded.n_leaves,
    )
    if min(launches) <= 0:
        raise RuntimeError(f"the optimize CLI did not launch both tile kernels: {launches}")
    if not initial or not best_psnr > initial[0] + OPT_MIN_GAIN_DB:
        raise RuntimeError(f"val PSNR did not rise by {OPT_MIN_GAIN_DB} dB: {initial} -> {best_psnr}")
    if loaded is None or best_tree is None or loaded.n_leaves != tree.n_leaves:
        raise RuntimeError("tree_opt.npz missing or not the optimized tree")

    t0 = time.time()
    K.launches = 0
    psnr, ssim, _ = eval_cli.main(common + ["--input", dst, "--fast_eval"])
    torch.cuda.synchronize()
    phase("optimized tree eval", t0, psnr=psnr, ssim=ssim, launches=K.launches)
    if not (math.isfinite(psnr) and K.launches > 0):
        raise RuntimeError(f"bad eval of the optimized tree: PSNR {psnr}")

    # Control: the same run with the gradient's sign flipped (SGD at -lr)
    # must not pass the gain check, or the check cannot tell a broken
    # gradient from a sound one.
    t0 = time.time()
    i = OPT_FLAGS.index("--lr")
    flipped = OPT_FLAGS[:i] + OPT_FLAGS[i + 2 :] + [f"--lr=-{OPT_FLAGS[i + 1]}"]
    initial.clear()
    vals.clear()
    with contextlib.redirect_stdout(_Tee(grab)):
        _, ctrl_best = optimize_cli.main(common + [
            "--input", src, "--tile_opt", "--nosave", *flipped,
        ])
    gain = ctrl_best - initial[0]
    phase("optimize control (gradient sign flipped)", t0, initial_val_psnr=initial[0],
          val_psnr_after=vals, best_val_psnr=ctrl_best, gain_db=gain, min_gain_db=OPT_MIN_GAIN_DB)
    if not gain < OPT_MIN_GAIN_DB:
        raise RuntimeError(f"a sign-flipped gradient passed the gain check: {gain} dB")
    return launches[1], best_psnr


def gather_vs_plain():
    """Phase 14: every gather_sum variant, by placement, against its plain
    version and a float64 sum at the probes' sizes, reruns bitwise equal,
    with times (on the device's clock, each batch of 10 calls queued behind
    a device spin, as bench_gather times them) and bounds; then the probes'
    entry point (bench_gather.run), the kernel's main path, in process."""
    import torch.nn.functional as F

    from plenoctree_tpu_torch import bench_gather
    from plenoctree_tpu_torch.kernels import gather_sum as G

    t0 = time.time()
    rng = np.random.default_rng(SEED)
    dev = "cuda"
    D = GATHER_D
    sms = G.sm_count(dev)
    table = torch.tensor(rng.normal(size=(GATHER_ROWS, D)), dtype=torch.float32, device=dev)
    small = table[:GATHER_SMEM_ROWS].contiguous()

    def idx(rows, shape):
        return torch.tensor(rng.integers(0, rows, size=shape), dtype=torch.int32, device=dev)

    kr, rk = idx(GATHER_ROWS, (GATHER_K, GATHER_R)), idx(GATHER_ROWS, (GATHER_R, GATHER_K))
    ks = idx(GATHER_SMEM_ROWS, (GATHER_K, GATHER_R))
    variants = [  # name, index stream, table, groups, unroll, placement
        ("vmem_u1", kr, table, 1, 1, "auto"), ("vmem_u8", kr, table, 1, 8, "auto"),
        ("tile", kr, table, 8, 1, "auto"), ("vmem_rk", rk, table, 1, 1, "auto"),
        ("vmem_u1_l2", kr, table, 1, 1, "l2"), ("vmem_u8_l2", kr, table, 1, 8, "l2"),
        ("tile_l2", kr, table, 8, 1, "l2"), ("vmem_rk_l2", rk, table, 1, 1, "l2"),
        ("smem_1k", ks, small, 1, 8, "smem"), ("smem_1k_tile", ks, small, 8, 1, "smem"),
    ]
    timed = bench_gather._timer(torch.device(dev))

    def ms(fn, batches=3):
        return min(timed(lambda _: fn(), None) for _ in range(batches))

    res = {}
    yardsticks = {}  # (stream, table, groups) -> (plain ms, embedding_bag ms, its error)
    for name, ix, tab, groups, unroll, placement in variants:
        run = lambda: G.gather_sum(ix, tab, groups, unroll, placement)  # noqa: E731
        out, again = run(), run()
        torch.cuda.synchronize()
        ref = G.gather_sum_reference(ix, tab, groups)
        f64 = tab.double().index_select(0, ix.reshape(-1).long()).reshape(-1, groups, D).sum(0)
        n = ix.numel()
        chain = G.addition_chain(ix, tab, groups, placement, sms)
        tol = 2.0**-24 * chain * 4.0 * math.sqrt(n // groups) * float(tab.std())
        err = float((out.double() - f64).abs().max())
        plain_err = float((ref.double() - f64).abs().max())
        # embedding_bag's bags: the whole stream (G = 1), or its 8 residue
        # classes as the rows of a [8, n/8] index (made once, outside the timing).
        bags = ix.reshape(1, -1) if groups == 1 else ix.reshape(-1, groups).t().contiguous()
        key = (id(ix), id(tab), groups)
        if key not in yardsticks:
            yardsticks[key] = (
                ms(lambda: G.gather_sum_reference(ix, tab, groups), 1),
                ms(lambda: F.embedding_bag(bags, tab, mode="sum"), 1),
                float((F.embedding_bag(bags, tab, mode="sum").double() - f64).abs().max()),
            )
        plain_ms, library_ms, lib_err = yardsticks[key]
        distinct = int(torch.unique(ix).numel())
        bound = bound_of(n * 4 + distinct * D * 4 + groups * D * 4, float(n * D), F32_FLOPS)
        res[name] = dict(
            placement=G.plan(n, *tab.shape, groups, placement, sms)["placement"],
            ms=ms(run), plain_ms=plain_ms, library_ms=library_ms,
            max_abs_err=float((out - ref).abs().max()), err_vs_f64=err, plain_err_vs_f64=plain_err,
            library_err_vs_f64=lib_err, chain=chain, tol=tol,
            rerun_equal=bool(torch.equal(out, again)), bound_ms=bound[0], bound_by=bound[1],
            distinct_rows=distinct,
        )
        if not (err <= tol and plain_err <= tol and res[name]["rerun_equal"]):
            raise RuntimeError(f"gather_sum {name} disagrees: {res[name]}")
    phase("gather kernel vs plain", t0, **{k: json.dumps(v) for k, v in res.items()})

    # Where each placement's time goes: device us per call by kernel.
    t0 = time.time()
    split = {name: bench_gather.kernel_split(
        lambda: G.gather_sum(ix, tab, groups, unroll, placement))
        for name, ix, tab, groups, unroll, placement in variants
        if name in ("vmem_u1", "tile", "vmem_u1_l2", "smem_1k")}
    phase("gather kernels by name (us per call)", t0,
          **{k: json.dumps({n: round(us, 2) for n, us in v.items()}) for k, v in split.items()})

    t0 = time.time()
    G.launches = 0
    probes = bench_gather.run()
    launches = G.launches
    phase("gather probes (main path)", t0, launches=launches,
          ns_per_row=json.dumps({k: round(v, 4) for k, v in probes["ns_per_row"].items()}))
    if launches <= 0 or launches != sum(probes["launches"].values()):
        raise RuntimeError(f"the probes' gather_sum launches do not add up: {launches}, {probes['launches']}")
    by_case = probes["launches"]
    res["vmem_u1"]["launches"] = sum(by_case[c] for c in (
        "pallas_vmem_u1", "pallas_vmem_u8", "gather_sum_sliced_32k", "gather_sum_l2_32k",
        "gather_sum_smem_1k", "gather_sum_u8_1k", "gather_sum_u8_1m"))
    res["tile"]["launches"] = by_case["pallas_vmem_tile"]
    res["vmem_rk"]["launches"] = by_case["pallas_vmem"]
    return res


def march_full_width(tree, served0):
    """Phase 15: VolumeRenderer on the depth-7 SH16 tree at 800x800, two
    orbit poses, exact (step 1e-5) and fast; the fast frame of pose 0 against
    the served tile frame of that pose (u8, phase 6)."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.octree.renderer import VolumeRenderer

    t0 = time.time()
    vr = VolumeRenderer(tree, step_size=1e-5, device="cuda")
    build_s = time.time() - t0
    k_est = vr.contrib_slots
    focal = 1.1 * RES
    torch.cuda.reset_peak_memory_stats()
    ms, frames = {}, {}
    for fast in (False, True):
        ms[fast] = []
        for k in range(2):
            t1 = time.perf_counter()
            img = vr.render_persp(orbit_pose(2.0 * np.pi * k / N_ORBIT), RES, RES, focal, fast=fast)
            ms[fast].append((time.perf_counter() - t1) * 1e3)
            if img.shape != (RES, RES, 3) or not np.isfinite(img).all() or img.min() == img.max():
                raise RuntimeError(f"bad march frame (fast={fast}, pose {k})")
            frames[fast, k] = img
    peak = torch.cuda.max_memory_allocated()
    u8 = np.round(np.clip(frames[True, 0], 0.0, 1.0) * 255.0)
    psnr = -10.0 * math.log10(float(np.mean(((u8 - served0) / 255.0) ** 2)))
    phase(
        "march full width", t0, host_build_s=round(build_s, 2), exact_ms=ms[False], fast_ms=ms[True],
        K_estimated=k_est, K_exact=vr._get_deferred(False).K, K_fast=vr._get_deferred(True).K,
        max_segments=vr.opts.max_segments, accel_level=vr.arrays["accel_level"],
        accel_reso=vr.arrays["accel_reso"], peak_mem_gib=peak / 2**30,
        psnr_fast_vs_served=psnr, min_psnr=MARCH_SERVED_MIN_PSNR,
    )
    if not psnr >= MARCH_SERVED_MIN_PSNR:
        raise RuntimeError(f"fast march frame vs served frame: {psnr} dB < {MARCH_SERVED_MIN_PSNR}")
    return vr, frames


def random_lpips_weights(path):
    """Seeded random VGG16 + LPIPS-head weights in the npz layout (conv
    kernels HWIO N(0, 0.05), biases N(0, 0.01), heads U(0, 1)): the
    pretrained weights cannot be downloaded, so the value checks the path
    and is no perceptual score."""
    from plenoctree_tpu_torch.ops import lpips

    rng = np.random.default_rng(SEED)
    w, cin, i = {}, 3, 0
    for v in lpips._VGG_CFG:
        if v != "M":
            w[f"conv{i}/kernel"] = (rng.normal(size=(3, 3, cin, v)) * 0.05).astype(np.float32)
            w[f"conv{i}/bias"] = (rng.normal(size=(v,)) * 0.01).astype(np.float32)
            cin, i = v, i + 1
    for k, (_, c) in enumerate(lpips.tap_structure()):
        w[f"lin{k}"] = rng.random(size=(c,)).astype(np.float32)
    np.savez(path, **w)


def exact_eval_main_path(tree_path, vr):
    """Phase 16: the eval CLI without --fast_eval (the march) at 200x200,
    with random LPIPS weights; LPIPS of one pair on the card vs the CPU."""
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.ops.lpips import get_lpips_fn

    t0 = time.time()
    weights = os.path.join(ROOT, "build", "smoke", "lpips_random.npz")
    random_lpips_weights(weights)
    before = os.environ.get("LPIPS_WEIGHTS_NPZ")
    os.environ["LPIPS_WEIGHTS_NPZ"] = weights
    try:
        tile_composite.launches = 0
        psnr, ssim, lpips = eval_cli.main([
            "--input", tree_path, "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--synthetic_resolution", str(EVAL_RES), "--device", "cuda",
        ])
        torch.cuda.synchronize()
        tile_launches = tile_composite.launches
        images, c2ws, focal = render_synthetic_scene("test", 4, EVAL_RES, True, 2.0, 6.0)
        im = np.clip(vr.render_persp(c2ws[0], EVAL_RES, EVAL_RES, focal, fast=True), 0.0, 1.0)
        on_card = get_lpips_fn("cuda")(images[0], im)
        on_cpu = get_lpips_fn("cpu")(images[0], im)
    finally:
        if before is None:
            del os.environ["LPIPS_WEIGHTS_NPZ"]
        else:
            os.environ["LPIPS_WEIGHTS_NPZ"] = before
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    phase("exact eval main path", t0, psnr=psnr, ssim=ssim, lpips_random_weights=lpips,
          tile_launches=tile_launches, lpips_pair_card=on_card, lpips_pair_cpu=on_cpu,
          lpips_rel_diff=rel, lpips_rtol=LPIPS_RTOL)
    if not (math.isfinite(psnr) and math.isfinite(ssim)) or psnr < 25.0 or ssim < 0.8:
        raise RuntimeError(f"exact eval quality too low: PSNR {psnr}, SSIM {ssim}")
    if tile_launches != 0:
        raise RuntimeError("the eval CLI without --fast_eval launched the tile kernel")
    if not (math.isfinite(lpips) and lpips > 0 and rel <= LPIPS_RTOL):
        raise RuntimeError(f"bad LPIPS: {lpips}, card {on_card} vs CPU {on_cpu}")
    return psnr


def march_opt_throughput(vr, frames):
    """Phase 17: the march optimizer's step at 800x800 on the depth-7 tree
    (TwoPhaseRenderer.loss_grad over chunks + the SGD update), median of
    MARCH_OPT_STEPS, peak memory; the device time by part and the idle share
    of one chunk + update from a profiler window."""
    from torch.profiler import ProfilerActivity, profile

    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.octree.optimize import (
        TwoPhaseRenderer, _image_rays, default_slot_budget, image_loss_grad, make_update,
    )
    from plenoctree_tpu_torch.octree.renderer import RenderOptions

    t0 = time.time()
    focal = 1.1 * RES
    lr = float(OPT_FLAGS[OPT_FLAGS.index("--lr") + 1])
    opts = RenderOptions(step_size=1e-5, max_segments=vr.opts.max_segments)
    rend = TwoPhaseRenderer(vr.arrays, vr.fmt, vr.basis_dim, opts, K=vr._get_deferred(False).K)
    data = rend.data0.clone()  # the renderer's tables stay as they are
    chunk = default_slot_budget("cuda", data.shape[1]) // rend.K
    update = make_update(data, True, 0.0, lr)
    rng = np.random.default_rng(SEED)
    rays, gts = [], []
    for k in range(2):
        rays.append(_image_rays(orbit_pose(2.0 * np.pi * k / N_ORBIT), RES, RES, focal, None))
        img = frames[False, k] + 0.05 * rng.standard_normal(frames[False, k].shape)
        gts.append(np.clip(img, 0, 1).astype(np.float32).reshape(-1, 3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step(k, one_chunk=False):
        o, d = rays[k % 2]
        # One chunk: the one at the middle of the frame (the first rows of
        # an orbit frame are mostly background).
        s = slice((o.shape[0] - chunk) // 2, (o.shape[0] + chunk) // 2) if one_chunk else slice(None)
        sq, grad, over = image_loss_grad(rend, data, o[s], d[s], gts[k % 2][s], chunk)
        update(grad, float(o[s].shape[0] * 3))
        return over

    def timed(fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        over = fn()
        e1.record()
        torch.cuda.synchronize()
        if bool(over):
            raise RuntimeError(f"an optimizer step overflowed K={rend.K}")
        return e0.elapsed_time(e1)

    step(0)  # warm-up
    step_ms = [timed(lambda: step(k)) for k in range(MARCH_OPT_STEPS)]
    peak = torch.cuda.max_memory_allocated()
    step_med = float(np.median(step_ms))
    # One chunk of the step and the update, alone and in a profiler window
    # (backward on this thread, so the shade's range holds its backward
    # kernels too).
    chunk_ms = timed(lambda: step(0, one_chunk=True))
    with torch.autograd.set_multithreading_enabled(False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(0, one_chunk=True)
            torch.cuda.synchronize()
    split, top = device_split(prof, {}, MARCH_STEP_RANGES, 1)
    device_ms = sum(split.values())
    phase(
        "march optimize throughput", t0, res=RES, K=rend.K, chunk=chunk, steps=MARCH_OPT_STEPS,
        ms_per_step_median=step_med, ms_per_step=step_ms, peak_mem_gib=peak / 2**30,
        chunk_ms=chunk_ms, chunk_device_ms=device_ms, chunk_device_split_ms=json.dumps(split),
        chunk_idle_share=1.0 - device_ms / chunk_ms, top_kernels=json.dumps(top),
    )
    if not all(math.isfinite(v) for v in step_ms):
        raise RuntimeError("bad march optimizer step times")
    if not all(split[k] > 0 for k in MARCH_STEP_RANGES):
        raise RuntimeError(f"a part of the profiled step shows no device time: {split}")
    return step_med


def march_optimize_main_path(tile_best):
    """Phase 18: the optimize CLI without --tile_opt (the march) on phase
    13's washed tree with the same flags; it must not launch a tile kernel."""
    from plenoctree_tpu_torch.cli import optimize as optimize_cli
    from plenoctree_tpu_torch.kernels import tile_composite as K
    from plenoctree_tpu_torch.octree import N3Tree

    t0 = time.time()
    out_dir = os.path.join(ROOT, "build", "smoke", "optimize")
    src, dst = os.path.join(out_dir, "tree_washed.npz"), os.path.join(out_dir, "tree_opt_march.npz")
    K.launches = K.bwd_launches = 0
    initial, vals = [], []

    def grab(text):
        for line in text.splitlines():
            if line.startswith("** initial val psnr"):
                initial.append(float(line.split()[-1]))
            elif line.startswith("** val psnr"):
                vals.append(float(line.split()[3]))

    with contextlib.redirect_stdout(_Tee(grab)):
        best_tree, best_psnr = optimize_cli.main([
            "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--synthetic_resolution", str(OPT_RES), "--device", "cuda",
            "--input", src, "--output", dst, *OPT_FLAGS,
        ])
    torch.cuda.synchronize()
    launches = (K.launches, K.bwd_launches)
    loaded = N3Tree.load(dst) if os.path.isfile(dst) else None
    phase(
        "march optimize main path", t0, tile_launches=launches,
        initial_val_psnr=initial[0] if initial else None, val_psnr_per_epoch=vals,
        best_val_psnr=best_psnr, tile_opt_best_val_psnr=tile_best, min_gain_db=OPT_MIN_GAIN_DB,
        tree_opt_leaves=None if loaded is None else loaded.n_leaves,
    )
    if launches != (0, 0):
        raise RuntimeError(f"the march optimize CLI launched tile kernels: {launches}")
    if not initial or not best_psnr > initial[0] + OPT_MIN_GAIN_DB:
        raise RuntimeError(f"val PSNR did not rise by {OPT_MIN_GAIN_DB} dB: {initial} -> {best_psnr}")
    if loaded is None or best_tree is None or loaded.n_leaves != best_tree.n_leaves:
        raise RuntimeError("tree_opt_march.npz missing or not the optimized tree")


def sg_train_main_path():
    """Phase 19: the train CLI on nerf_sh/config/misc/sg (SG25) with the
    fused kernels: both trunk kernels launched (on the 1 + 75 head, the only
    trunk of the run), the train PSNR rising, checkpoint_200 restoring with
    equal params (sg_lambda and sg_mu_spher among them)."""
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils
    from plenoctree_tpu_torch.utils.metrics_writer import read_scalars

    t0 = time.time()
    train_dir = tempfile.mkdtemp(prefix="train_sg_", dir=os.path.join(ROOT, "build", "smoke"))
    fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
    with open(os.path.join(train_dir, "train.log"), "w") as log, contextlib.redirect_stdout(log):
        model, state = train_cli.main([
            "--config", SG_CONFIG, "--dataset", "synthetic", "--train_dir", train_dir,
            "--device", "cuda", *TRAINED_MODEL_FLAGS, "--max_steps", str(TRAIN_STEPS),
            "--lr_final", "5e-5", "--print_every", "1", "--save_every", str(TRAIN_STEPS),
            "--render_every", str(TRAIN_STEPS),
        ])
    torch.cuda.synchronize()
    launches = (fused_mlp.fwd_launches, fused_mlp.bwd_launches)
    psnr = [v for _, v in read_scalars(train_dir, "train_psnr")]
    test_psnr = read_scalars(train_dir, "test_psnr")
    first, last = float(np.mean(psnr[:20])), float(np.mean(psnr[-20:]))
    _, meta = model.MLP_1.flat_weights()
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    restored = ckpt_utils.restore_checkpoint(train_dir, ckpt_utils.create_train_state(fresh))
    same = all(torch.equal(p, state.params[k]) for k, p in restored.params.items())
    lam = torch.nn.functional.softplus(model.sg_lambda.detach())
    phase(
        "SG train main path", t0, config=SG_CONFIG, sg_dim=model.sg_dim, head_d_out=meta["d_out"],
        steps=len(psnr), fwd_launches=launches[0], bwd_launches=launches[1], psnr_first20=first,
        psnr_last20=last, test_psnr=test_psnr[-1][1] if test_psnr else None,
        restored_step=restored.step, params_equal=same,
        softplus_lambda_range=[round(float(lam.min()), 4), round(float(lam.max()), 4)],
    )
    if meta["d_out"] != 76 or min(launches) <= 0:
        raise RuntimeError(f"the SG train run did not launch both trunk kernels on the 1 + 75 "
                           f"head: d_out {meta['d_out']}, launches {launches}")
    if len(psnr) != TRAIN_STEPS or not all(math.isfinite(v) for v in psnr) or not last > first:
        raise RuntimeError(f"SG train PSNR did not rise: first 20 {first}, last 20 {last}")
    if not (restored.step == TRAIN_STEPS and same and "sg_mu_spher" in restored.params):
        raise RuntimeError("the SG checkpoint did not restore into a fresh TrainState")
    return train_dir


def nerf_eval_main_path(sh_dir, sg_dir):
    """Phase 20: the NeRF eval CLI on phase 8's SH16 checkpoint and phase
    19's SG25 one, on the blender scene of phase 3 (4 test views at
    200x200): PSNR/SSIM, psnr.txt / ssim.txt, the PNGs read back; then one
    800x800 view through the same renderer (engine.render_image at the
    CLI's chunk), timed."""
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.cli import eval as nerf_eval_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.data.rays import generate_rays
    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.utils import config as config_lib
    from plenoctree_tpu_torch.utils.png import read_png

    scene = os.path.join(ROOT, "build", "smoke", "blender")
    rays = generate_rays(RES, RES, 1.1 * RES, orbit_pose(0.0)[None])
    rays = type(rays)(*[r[0] for r in rays])
    for name, config, train_dir in (("SH16", "nerf_sh/config/blender", sh_dir),
                                    ("SG25", SG_CONFIG, sg_dir)):
        t0 = time.time()
        argv = ["--config", config, "--dataset", "blender", "--data_dir", scene,
                "--train_dir", train_dir, "--device", "cuda", *TRAINED_MODEL_FLAGS]
        with open(os.path.join(train_dir, "eval.log"), "w") as log, contextlib.redirect_stdout(log):
            psnr, ssim = nerf_eval_cli.main(argv)
        wall = time.time() - t0
        with open(os.path.join(train_dir, "psnr.txt")) as f:
            psnr_txt = float(f.read())
        with open(os.path.join(train_dir, "ssim.txt")) as f:
            ssim_txt = float(f.read())
        preds = os.path.join(train_dir, "test_preds")
        shapes = sorted({read_png(os.path.join(preds, n)).shape for n in os.listdir(preds)})
        cfg = config_lib.parse_flags(nerf_eval_cli.build_parser(), argv)
        model, _ = get_model_state(cfg, seed=nerf_eval_cli.SEED, restore=True, device="cuda")
        engine.render_image(model, rays, chunk=cfg.chunk, device="cuda")  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _, _ = engine.render_image(model, rays, chunk=cfg.chunk, device="cuda")
        s_per_image = time.perf_counter() - t1
        del model
        phase(f"NeRF eval main path ({name})", t0, psnr=psnr, ssim=ssim, psnr_txt=psnr_txt,
              ssim_txt=ssim_txt, eval_wall_s=round(wall, 2), png_shapes=shapes,
              n_png=len(os.listdir(preds)), chunk=cfg.chunk, s_per_800_image=s_per_image)
        if not (math.isfinite(psnr) and math.isfinite(ssim) and psnr_txt == psnr
                and ssim_txt == ssim):
            raise RuntimeError(f"bad NeRF eval ({name}): {psnr} {ssim} {psnr_txt} {ssim_txt}")
        if shapes != [(EVAL_RES, EVAL_RES, 1), (EVAL_RES, EVAL_RES, 3)] or len(os.listdir(preds)) != 8:
            raise RuntimeError(f"bad NeRF eval images ({name}): {shapes}")
        if img.shape != (RES, RES, 3) or not np.isfinite(img).all():
            raise RuntimeError(f"bad 800x800 NeRF view ({name})")


def fleet_main_path(sh_dir, sg_dir):
    """Phase 21: `python -m plenoctree_tpu_torch.cli.task_manager tasks.json
    --gpus "0 0"` (two workers on the one card, the tasks side by side) as a
    subprocess, on a task file with two tasks in the form of
    octree/config/syn_sh16.json and syn_sg25.json (bench_fleet.fleet_tasks:
    their configs and published extr/opt/eval flags, --num_epochs 80 ->
    FLEET_EPOCHS, plus the model flags the checkpoints were trained with)
    on phase 8's and phase 19's checkpoints and the synthetic scene written
    as a blender scene at FLEET_RES (12 train, 4 test, 4 val views): rc 0,
    one results.txt line per task without error and with finite PSNRs, and
    the wall-clock of each stage (from the worker's stage lines). Returns
    {name: the tree the fleet evaluated}."""
    from plenoctree_tpu_torch import bench_fleet
    from plenoctree_tpu_torch.data.synthetic import write_blender_dataset

    t0 = time.time()
    scene = os.path.join(ROOT, "build", "smoke", "fleet_scene")
    write_blender_dataset(scene, 12, 4, FLEET_RES)
    fleet_dir = os.path.join(ROOT, "build", "smoke", "fleet")
    tasks = bench_fleet.fleet_tasks(sh_dir, sg_dir, scene, FLEET_EPOCHS)
    rc, stages, lines, _ = bench_fleet.run_fleet(tasks, fleet_dir, gpus=FLEET_GPUS)
    native_lines = fleet_native_lines(fleet_dir)
    phase("fleet main path", t0, rc=rc, tasks=len(tasks), workers=FLEET_GPUS, epochs=FLEET_EPOCHS,
          views=FLEET_RES,
          stage_wall_s=json.dumps(stages),
          results=json.dumps([{k: v for k, v in r.items() if k != "scene"} for r in lines]),
          native=json.dumps(native_lines))
    if rc != 0 or len(lines) != 2 or any("error" in r for r in lines):
        raise RuntimeError(f"the fleet failed: rc {rc}, results {lines} (see {fleet_dir}/fleet.log)")
    if len(native_lines) != len(tasks) or not all(
            x.startswith("g++ library") and "build_octree=1" in x for x in native_lines):
        raise RuntimeError(f"a fleet extraction did not build its tree natively: {native_lines}")
    if not all(math.isfinite(r["raw_psnr"]) and math.isfinite(r["psnr"]) for r in lines):
        raise RuntimeError(f"non-finite fleet PSNRs: {lines}")
    return bench_fleet.fleet_trees(lines)


def fleet_tree_march(tree_path):
    """Phase 21b: one 800x800 exact march frame (step 1e-5, the eval's mode)
    of the fleet's depth-8 SH16 tree (phase 8's checkpoint at syn_sh16's
    published depth): its accel grid must be budgeted (a residual descent,
    level below depth + 1), as phase 9 checked before its depth was cut."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.renderer import VolumeRenderer

    t0 = time.time()
    tree = N3Tree.load(tree_path)
    vr = VolumeRenderer(tree, step_size=1e-5, device="cuda")
    build_s = time.time() - t0
    t1 = time.perf_counter()
    img = vr.render_persp(orbit_pose(0.0), RES, RES, 1.1 * RES, fast=False)
    frame_ms = (time.perf_counter() - t1) * 1e3
    phase("fleet tree march (depth 8)", t0, leaves=tree.n_leaves, depth=tree.max_depth,
          march_800_exact_ms=frame_ms, march_host_build_s=round(build_s, 2),
          accel_level=vr.arrays["accel_level"], accel_reso=vr.arrays["accel_reso"],
          K_estimated=vr.contrib_slots, K_exact=vr._get_deferred(False).K)
    if not (np.isfinite(img).all() and tree.max_depth == 8
            and vr.arrays["accel_level"] < tree.max_depth + 1):
        raise RuntimeError("bad march frame of the fleet's depth-8 tree, or an unbudgeted accel grid")


def sg25_scene_tree(tree):
    """An SG25 tree (data_dim 76, 88 soa fields) on the topology and sigma
    of the depth-7 serving tree: seeded N(0, 0.5) amplitudes and lobes
    (softplus-ed lambda in [0.5, 3), unit mu). The tile optimizer's index
    holds every leaf three times and refuses 2^24 rows (as the JAX
    package's does), which the fleet's depth-8 SG25 tree exceeds."""
    from plenoctree_tpu_torch.octree.n3tree import DataFormat

    rng = np.random.default_rng(SEED)
    sg = tree.clone()
    data = rng.normal(0.0, 0.5, tree.data.shape[:-1] + (76,)).astype(np.float32)
    data[..., -1] = tree.data[..., -1]
    sg.data, sg.data_dim, sg.data_format = data, 76, DataFormat("SG25")
    mu = rng.normal(size=(25, 3))
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    sg.extra_data = np.concatenate([rng.uniform(0.5, 3.0, (25, 1)), mu], -1).astype(np.float32)
    return sg


def sg_tiles(scene_tree):
    """Phase 22: the SG25 tile kernels, on an SG25 tree of the depth-7
    serving tree's topology (sg25_scene_tree; 3,664,893 leaves, bd 25, 82
    rows padded to 88 soa fields): one served 800x800 frame (launches
    counted) and the serving kernel against its plain version on that
    pose's inputs, with times and bound; both kernels' shared memory; then
    one exact-mode pose's forward and backward against
    composite_tiles_reference / composite_tiles_bwd_reference (phase 11's
    checks). The tile index holds every kept leaf three times and refuses
    2^24 rows, as the JAX package's does: the fleet's SG25 tree (6.1M
    leaves above the serving threshold at 64x64 views) does not fit."""
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.kernels import tile_composite as K
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer

    t0 = time.time()
    tree = sg25_scene_tree(scene_tree)
    focal = 1.1 * RES
    server = TileRenderer(tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2,
                          output="u8", device="cuda")
    build_s = time.time() - t0
    K.launches = 0
    server.render_persp(orbit_pose(0.0), RES, RES, focal)  # caps grow to this pose here
    t1 = time.perf_counter()
    frame = server.render_persp(orbit_pose(0.0), RES, RES, focal)
    frame_ms = (time.perf_counter() - t1) * 1e3
    launches = K.launches
    ti = server.make_tile_inputs_fn(RES, RES, focal, server.rcap, server.w1cap, server.ccap)
    idx = server.index
    p2 = ti(orbit_pose(0.0), idx["csr"], idx["base"], server.extra_data, idx["blk_bbox"])[0]
    soa, kw = idx["soa"], server._kernel_kw
    out = K.composite_tiles(*p2, soa, **kw)
    sub = tile_subset(p2)
    p2s = take_tiles(p2, sub)
    ref, serve_plain = timed_once_ms(lambda: K.composite_tiles_reference(*p2s, soa, **kw))
    serve_err = float((out[sub] - ref).abs().max())
    serve_ms = cuda_ms(lambda: K.composite_tiles(*p2, soa, **kw), 10)
    serve_bound = bound_of(*tile_work(p2, soa, kw["sigma_row"], kw["quantum"], out.numel() * 4),
                           F32_FLOPS)
    lib = K.build()
    rows = kw["sigma_row"] + 1  # the rows the kernels stage per piece
    smem_fwd = lib.pn_tile_composite_smem_bytes(p2[5].shape[1], kw["basis_dim"], rows,
                                                kw["runrows"], kw["quantum"])
    smem_bwd = lib.pn_tile_composite_bwd_smem_bytes(256, kw["basis_dim"], kw["n_channels"], rows,
                                                    kw["runrows"], kw["quantum"])
    phase("SG25 served frame", t0, format=repr(tree.data_format), leaves=tree.n_leaves,
          index_build_s=round(build_s, 2), frame_ms=frame_ms, launches=launches,
          kernel_max_abs_err=serve_err, tol=KERNEL_ATOL, kernel_ms=serve_ms,
          plain_tiles=sub.numel(), plain_ms_on_subset=serve_plain, bound_ms=serve_bound[0], bound_by=serve_bound[1],
          soa_fields=soa.shape[1], staged_rows=rows, fwd_smem_bytes=smem_fwd,
          bwd_smem_bytes=smem_bwd, max_smem=K._MAX_SMEM, bwd_smem_spare=K._MAX_SMEM - smem_bwd,
          ccap=server.ccap)
    if launches <= 0 or frame.shape != (RES, RES, 3) or frame.min() == frame.max():
        raise RuntimeError("the SG25 served frame launched no tile kernel, or is bad")
    if not serve_err <= KERNEL_ATOL:
        raise RuntimeError(f"SG25 serving kernel disagrees: {serve_err} > {KERNEL_ATOL}")
    del server, ti, idx, p2, p2s, soa, out, ref
    torch.cuda.empty_cache()
    tile_bwd_vs_plain(tree, "SG25 tile bwd kernel vs plain", time_plain=False)
    torch.cuda.empty_cache()


def compression_main_path(trees):
    """Phase 23: the compress CLI (--bits 16) on both fleet trees: keys,
    palette sizes, MB before and after, wall-clock; then the SG25 tree
    decoded here (quant_colors[quant_map] back into data, sigma from the
    npz; no package feature) and rendered at 800x800 through the march
    (fast mode, step 1e-5; the tile index cannot hold this tree, phase 22),
    against the uncompressed tree's frame (COMPRESS_MIN_PSNR) and against
    the frame of the uncompressed tree with the compressor's sigma cut (the
    palette's own error, COMPRESS_PALETTE_MIN_PSNR)."""
    from plenoctree_tpu_torch.cli import compress as compress_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.renderer import VolumeRenderer

    out = {}
    for name, src in trees.items():
        t0 = time.time()
        out_dir = os.path.join(ROOT, "build", "smoke", "compressed", name)
        native_calls = reset_native_calls()
        compress_cli.main([src, "--out_dir", out_dir, "--bits", "16", "--overwrite"])
        wall = time.time() - t0
        dst = os.path.join(out_dir, os.path.basename(src))
        z = np.load(dst)
        files = sorted(z.files)
        pal = z["quant_colors"].shape
        out[name] = dict(dst=dst, wall_s=wall, mb_before=os.path.getsize(src) / 2**20,
                         mb_after=os.path.getsize(dst) / 2**20, palette=pal,
                         kept=int((z["sigma"] > 0).sum()))
        phase(f"compression ({name})", t0, files=files, quant_colors_shape=list(pal),
              quant_map_shape=list(z["quant_map"].shape), kept_voxels=out[name]["kept"],
              mb_before=out[name]["mb_before"], mb_after=out[name]["mb_after"], wall_s=wall,
              native_calls=json.dumps(native_calls))
        if native_calls["median_cut"] != pal[0]:
            raise RuntimeError(f"the compress CLI ran {native_calls['median_cut']} native median "
                               f"cuts for {pal[0]} basis functions ({name})")
        if not {"quant_colors", "quant_map", "sigma"} <= set(files) or "data" in files:
            raise RuntimeError(f"bad compressed npz keys ({name}): {files}")
        if not pal[1] <= 2**16 or z["quant_map"].dtype != np.uint16:
            raise RuntimeError(f"bad palette ({name}): {pal}, {z['quant_map'].dtype}")

    t0 = time.time()
    sg_tree = N3Tree.load(trees["SG25"])
    z = np.load(out["SG25"]["dst"])
    qc, qm = z["quant_colors"].astype(np.float32), z["quant_map"]
    bd = qc.shape[0]
    n = sg_tree.n_internal
    full = sg_tree.data[:n]
    cut = sg_tree.clone()  # the compressor's sigma cut (default --sigma_thresh 2)
    cut.data[:n, ..., -1] = np.where(full[..., -1] > 2.0, full[..., -1], 0.0)
    decoded = sg_tree.clone()
    for i in range(bd):
        rgb = qc[i][qm[i]]  # [n, 2, 2, 2, 3]
        for c in range(3):
            decoded.data[:n, ..., c * bd + i] = rgb[..., c]
    decoded.data[:n, ..., -1] = z["sigma"]
    kept = full[..., -1] > 2.0
    coeff_err = float(np.abs(decoded.data[:n][kept][:, :-1] - full[kept][:, :-1]).mean())
    frames = {}
    for name, t in (("full", sg_tree), ("cut", cut), ("decoded", decoded)):
        vr = VolumeRenderer(t, step_size=1e-5, device="cuda")
        img = vr.render_persp(orbit_pose(0.0), RES, RES, 1.1 * RES, fast=True)
        frames[name] = np.clip(img, 0.0, 1.0).astype(np.float64)
        del vr
        torch.cuda.empty_cache()
    del cut, decoded

    def psnr(a, b):
        return -10.0 * math.log10(max(float(np.mean((a - b) ** 2)), 1e-20))

    vs_full, vs_cut = psnr(frames["decoded"], frames["full"]), psnr(frames["decoded"], frames["cut"])
    phase("compressed SG25 frame", t0, psnr_vs_uncompressed=vs_full, min_psnr=COMPRESS_MIN_PSNR,
          psnr_vs_same_sigma_cut=vs_cut, palette_min_psnr=COMPRESS_PALETTE_MIN_PSNR,
          psnr_cut_vs_uncompressed=psnr(frames["cut"], frames["full"]),
          mean_abs_coeff_err=coeff_err, kept_voxels=int(kept.sum()))
    if not (vs_full >= COMPRESS_MIN_PSNR and vs_cut >= COMPRESS_PALETTE_MIN_PSNR):
        raise RuntimeError(f"the decoded SG25 tree renders too far from the uncompressed one: "
                           f"{vs_full} dB (floor {COMPRESS_MIN_PSNR}), {vs_cut} dB with the same "
                           f"sigma cut (floor {COMPRESS_PALETTE_MIN_PSNR})")


def _train(config, train_dir, extra, steps=TRAIN_STEPS):
    """The train CLI in-process (its per-step lines to train.log); returns
    (model, state, launches (fwd, bwd), train PSNRs, last test PSNR)."""
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.utils.metrics_writer import read_scalars

    fused_mlp.fwd_launches = fused_mlp.bwd_launches = 0
    with open(os.path.join(train_dir, "train.log"), "w") as log, contextlib.redirect_stdout(log):
        model, state = train_cli.main([
            "--config", config, "--train_dir", train_dir, "--device", "cuda", *extra,
            "--max_steps", str(steps), "--lr_final", "5e-5", "--print_every", "1",
            "--save_every", str(steps), "--render_every", str(steps),
        ])
    torch.cuda.synchronize()
    psnr = [v for _, v in read_scalars(train_dir, "train_psnr")]
    test = read_scalars(train_dir, "test_psnr")
    return (model, state, (fused_mlp.fwd_launches, fused_mlp.bwd_launches), psnr,
            test[-1][1] if test else None)


def _restores_equal(model, state, train_dir):
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils

    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    restored = ckpt_utils.restore_checkpoint(train_dir, ckpt_utils.create_train_state(fresh))
    same = all(torch.equal(p, state.params[k]) for k, p in restored.params.items())
    return restored.step, same


def _check_train(label, psnr, restored_step, same, steps=TRAIN_STEPS):
    first, last = float(np.mean(psnr[:20])), float(np.mean(psnr[-20:]))
    if len(psnr) != steps or not all(math.isfinite(v) for v in psnr) or not last > first:
        raise RuntimeError(f"{label}: train PSNR did not rise: first 20 {first}, last 20 {last}")
    if not (restored_step == steps and same):
        raise RuntimeError(f"{label}: the checkpoint did not restore into a fresh TrainState")
    return first, last


def ndc_serving(tree, index, smi):
    """Phase 24 (run after phase 6, on its index): NDC serving of the
    depth-7 serving tree read as an NDC volume (make_ndc_config at 800x800,
    focal NDC_FOCAL): the tile inputs of a forward-facing pose (per-ray
    origins, segment-endpoint AABB group masks), the tile kernel against
    composite_tiles_reference (KERNEL_ATOL), both times, the bound and the
    share of valid pieces whose mask is below 15; then an N_NDC_ORBIT-pose
    forward-facing orbit at 800x800 (u8 frames), the median ms/frame."""
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.octree.renderer import make_ndc_config
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer

    t0 = time.time()
    ndc = make_ndc_config(RES, RES, NDC_FOCAL)
    r = TileRenderer(tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, index=index,
                     ndc=ndc, device="cuda")
    r.w1cap = int(min(r.grid_c, np.ceil(np.sqrt(3) * r.tile / NDC_FOCAL * r.grid_c) + 3))
    c2w = np.eye(4, dtype=np.float32)
    c2w[0, 3], c2w[1, 3] = 0.05, -0.03
    ti = r.make_tile_inputs_fn(RES, RES, NDC_FOCAL, r.rcap, r.w1cap, r.ccap)
    idx = r.index
    p2, _, _, _ = ti(c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"])
    soa, kw = idx["soa"], r._kernel_kw
    out_k = tile_composite.composite_tiles(*p2, soa, **kw)
    sub = tile_subset(p2)
    out_p, ms_plain = timed_once_ms(
        lambda: tile_composite.composite_tiles_reference(*take_tiles(p2, sub), soa, **kw))
    err = float((out_k[sub] - out_p).abs().max())
    ms_kernel = cuda_ms(lambda: tile_composite.composite_tiles(*p2, soa, **kw), 10)
    ms_inputs = cuda_ms(lambda: ti(c2w, idx["csr"], idx["base"], r.extra_data, idx["blk_bbox"]), 5)
    bound = bound_of(*tile_work(p2, soa, kw["sigma_row"], kw["quantum"], out_k.numel() * 4),
                     F32_FLOPS)
    n_pieces = p2[0][:, 0, 0]
    valid = torch.arange(p2[4].shape[-1], device=p2[4].device)[None] < n_pieces[:, None]
    masks = p2[4][:, 0][valid]
    o = p2[5][..., :3]
    below15 = float((masks < 15).float().mean()) if masks.numel() else float("nan")
    server = TileRenderer(tree, step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2,
                          index=index, ndc=ndc, output="u8", device="cuda")
    tile_composite.launches = 0  # the served orbit is the main path; the checks above are not
    frame_ms = []
    for k in range(N_NDC_ORBIT):
        pose = np.eye(4, dtype=np.float32)
        th = 2.0 * np.pi * k / N_NDC_ORBIT
        pose[0, 3], pose[1, 3] = 0.08 * np.cos(th), 0.08 * np.sin(th)
        t1 = time.perf_counter()
        img = server.render_persp(pose, RES, RES, NDC_FOCAL)
        frame_ms.append((time.perf_counter() - t1) * 1e3)
        if img.shape != (RES, RES, 3) or img.min() == img.max():
            raise RuntimeError(f"bad NDC served frame {k}")
    phase(
        "NDC tile kernel vs plain", t0, tiles=p2[0].shape[0], pieces_max=int(n_pieces.max()),
        pieces_mean=float(n_pieces.float().mean()), masks_below_15_share=below15,
        origins_per_ray=bool((o - o[:, :1]).abs().max() > 1e-4), max_abs_err=err,
        tol=KERNEL_ATOL, kernel_ms=ms_kernel, plain_tiles=sub.numel(),
        plain_ms_on_subset=ms_plain, tile_inputs_ms=ms_inputs,
        bound_ms=bound[0], bound_by=bound[1], orbit_frames=N_NDC_ORBIT,
        orbit_median_ms=float(np.median(frame_ms)), orbit_best_ms=float(np.min(frame_ms)),
        orbit_first_ms=frame_ms[0], orbit_launches=tile_composite.launches, gpu=repr(smi),
    )
    if not err <= KERNEL_ATOL:
        raise RuntimeError(f"NDC tile kernel disagrees with the plain version: {err}")
    if not (0.0 < below15 and int(n_pieces.sum()) > 0):
        raise RuntimeError(f"NDC group masks vacuous or no pieces: {below15}")
    if tile_composite.launches < N_NDC_ORBIT:
        raise RuntimeError(f"the NDC orbit launched the tile kernel {tile_composite.launches} times")
    return dict(max_abs_err=err, ms=ms_kernel, plain_ms=ms_plain, bound=bound)


def tt_train_main_path():
    """Phase 25: an NSVF-layout scene written by the port's writer
    (TT_VIEWS at FLEET_RES, bbox.txt [-1, 1]^3), then the train CLI on
    nerf_sh/config/tt (SH25: a 1 + 75 head, batch 1024, 64 + 128 samples)
    with the fused kernels, 200 steps: both trunk kernels launched on the
    1 + 75 head, the train PSNR rising, checkpoint_200 restoring with equal
    params. Returns (scene root, checkpoint root, scene name)."""
    from plenoctree_tpu_torch.data.synthetic import write_nsvf_dataset

    t0 = time.time()
    spec = json.load(open(os.path.join(ROOT, TT_TASKS)))
    scene_name = spec["scenes"][0]
    data_root = os.path.join(ROOT, "build", "smoke", "tt_data")
    train_root = os.path.join(ROOT, "build", "smoke", "tt_ckpt")
    scene = write_nsvf_dataset(os.path.join(data_root, scene_name), *TT_VIEWS, FLEET_RES)
    write_s = time.time() - t0
    train_dir = os.path.join(train_root, scene_name)
    os.makedirs(train_dir, exist_ok=True)
    model, state, launches, psnr, test_psnr = _train(
        TT_CONFIG, train_dir, ["--data_dir", scene, *TRAINED_MODEL_FLAGS])
    _, meta = model.MLP_1.flat_weights()
    step, same = _restores_equal(model, state, train_dir)
    first, last = _check_train("T&T train", psnr, step, same)
    phase("T&T train main path", t0, config=TT_CONFIG, scene=scene_name, views=FLEET_RES,
          write_s=round(write_s, 2), sh_deg=model.sh_deg, head_d_out=meta["d_out"],
          steps=len(psnr), fwd_launches=launches[0], bwd_launches=launches[1],
          psnr_first20=first, psnr_last20=last, test_psnr=test_psnr, restored_step=step,
          params_equal=same)
    if meta["d_out"] != 76 or min(launches) <= 0:
        raise RuntimeError(f"the T&T train run did not launch both trunk kernels on the 1 + 75 "
                           f"head: d_out {meta['d_out']}, launches {launches}")
    return data_root, train_root, scene_name


def tt_fleet_main_path(data_root, train_root, scene_name):
    """Phase 26: `python -m plenoctree_tpu_torch.cli.task_manager tasks.json
    --gpus "0"` on octree/config/tt_sh25.json as it stands (its {%} scene
    templating, --bbox_from_data --data_bbox_scale 1.2, --split_train
    --split_holdout_prop 0.1, and its other published flags), cut to one
    scene and --num_epochs 40 -> TT_EPOCHS, plus the trained model's flags,
    on phase 25's scene and checkpoint: rc 0, one results.txt line without
    error, finite PSNRs, the wall-clock of each stage, the extraction's
    `native:` line, and the tree's bbox-derived centre and radius."""
    from plenoctree_tpu_torch import bench_fleet
    from plenoctree_tpu_torch.octree import N3Tree

    t0 = time.time()
    spec = json.load(open(os.path.join(ROOT, TT_TASKS)))
    spec.update(data_root=data_root, train_root=train_root, scenes=[scene_name])
    task = spec["scene_tasks"][0]
    i = task["opt_flags"].index("--num_epochs")
    task["opt_flags"][i + 1] = str(TT_EPOCHS)
    for key in ("extr_flags", "opt_flags", "eval_flags"):
        task[key] = task[key] + TRAINED_MODEL_FLAGS
    fleet_dir = os.path.join(ROOT, "build", "smoke", "tt_fleet")
    rc, stages, lines, wall = bench_fleet.run_fleet(spec, fleet_dir)
    native_lines = fleet_native_lines(fleet_dir)
    ok = rc == 0 and len(lines) == 1 and "error" not in lines[0]
    tree = N3Tree.load(os.path.join(train_root, scene_name, "octrees", "tree.npz")) if ok else None
    phase("T&T fleet main path", t0, rc=rc, epochs=TT_EPOCHS, views=FLEET_RES,
          wall_s=round(wall, 2), stage_wall_s=json.dumps(stages),
          results=json.dumps([{k: v for k, v in r.items() if k != "scene"} for r in lines]),
          bbox_center=None if tree is None else ((0.5 - tree.offset) / tree.invradius).tolist(),
          bbox_radius=None if tree is None else (0.5 / tree.invradius).tolist(),
          leaves=None if tree is None else tree.n_leaves, depth=None if tree is None else
          tree.max_depth, native=json.dumps(native_lines))
    if not ok:
        raise RuntimeError(f"the T&T fleet failed: rc {rc}, results {lines} "
                           f"(see {fleet_dir}/fleet.log)")
    if not (math.isfinite(lines[0]["raw_psnr"]) and math.isfinite(lines[0]["psnr"])):
        raise RuntimeError(f"non-finite T&T fleet PSNRs: {lines}")
    if not np.allclose(0.5 / tree.invradius, 1.2, rtol=1e-5):
        raise RuntimeError("the tree's radius is not bbox.txt's times --data_bbox_scale 1.2")


def llff_main_path():
    """Phase 27: an LLFF capture written by the port's writer (LLFF_VIEWS
    forward-facing views at LLFF_RES), a config with llff in its path (so
    every stage runs in NDC), the train CLI for 200 steps with the fused
    kernels (SH16 at full width, batch 1024, 64 + 128 samples, near 0, far
    1 in NDC); then, with the model flags as trained, the extract CLI with
    --center "0 0 0" --radius 1.05 (init_grid_depth LLFF_DEPTH), the
    optimize CLI (the march, as for every NDC config), the evaluate CLI
    exact and with --fast_eval (the tile kernel must launch), the NDC tile
    frame against the NDC march frame of the same test pose (at least
    NDC_MIN_PSNR dB), and the NeRF eval CLI with --render_path (the spiral
    into path_renders/)."""
    from plenoctree_tpu_torch.cli import eval as nerf_eval_cli
    from plenoctree_tpu_torch.cli import evaluate as evaluate_cli
    from plenoctree_tpu_torch.cli import extract as extract_cli
    from plenoctree_tpu_torch.cli import optimize as optimize_cli
    from plenoctree_tpu_torch.data import get_dataset
    from plenoctree_tpu_torch.data.synthetic import write_llff_dataset
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.renderer import VolumeRenderer, make_ndc_config
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer
    from plenoctree_tpu_torch.utils import config as config_lib

    t0 = time.time()
    root = os.path.join(ROOT, "build", "smoke", "llff")
    scene = write_llff_dataset(os.path.join(root, "scene"), LLFF_VIEWS, LLFF_RES)
    config = os.path.join(root, "llff_smoke.yaml")
    with open(config, "w") as f:
        f.write("dataset: llff\nfactor: 0\nllffhold: 8\nnear: 0.0\nfar: 1.0\n"
                "white_bkgd: false\nimage_batching: true\nbatch_size: 1024\nsh_deg: 3\n"
                "use_viewdirs: false\n"
                "num_coarse_samples: 64\nnum_fine_samples: 128\nrandomized: true\n")
    train_dir = os.path.join(root, "train")
    os.makedirs(train_dir, exist_ok=True)
    model_flags = ["--config", config, "--data_dir", scene, "--train_dir", train_dir,
                   "--device", "cuda", *TRAINED_MODEL_FLAGS]
    model, state, launches, psnr, test_psnr = _train(config, train_dir, model_flags[2:4]
                                                     + TRAINED_MODEL_FLAGS)
    step, same = _restores_equal(model, state, train_dir)
    first, last = _check_train("LLFF train", psnr, step, same)
    del model, state
    phase("LLFF train main path", t0, views=LLFF_VIEWS, res=LLFF_RES, steps=len(psnr),
          fwd_launches=launches[0], bwd_launches=launches[1], psnr_first20=first,
          psnr_last20=last, test_psnr=test_psnr, restored_step=step, params_equal=same)
    if min(launches) <= 0:
        raise RuntimeError(f"the LLFF train run did not launch both trunk kernels: {launches}")

    def quiet(log_name, fn, argv):
        with open(os.path.join(root, log_name), "w") as log, contextlib.redirect_stdout(log):
            return fn(argv)

    t0 = time.time()
    tree_path = os.path.join(root, "tree.npz")
    opt_path = os.path.join(root, "tree_opt.npz")
    tree = quiet("extract.log", extract_cli.main, model_flags + [
        "--output", tree_path, "--center", "0 0 0", "--radius", "1.05",
        "--init_grid_depth", str(LLFF_DEPTH)])
    with open(tree_path + ".results.json") as f:
        raw = json.load(f)
    extract_s = time.time() - t0
    t1 = time.time()
    tile_composite.launches = 0
    _, best_psnr = quiet("optimize.log", optimize_cli.main, model_flags + [
        "--input", tree_path, "--output", opt_path, "--num_epochs", "1"])
    opt_launches = tile_composite.launches
    optimize_s = time.time() - t1
    best = opt_path if os.path.exists(opt_path) else tree_path
    t1 = time.time()
    march_psnr, _, _ = quiet("evaluate.log", evaluate_cli.main, model_flags + ["--input", best])
    march_s = time.time() - t1
    t1 = time.time()
    tile_composite.launches = 0
    tile_psnr, _, _ = quiet("evaluate_fast.log", evaluate_cli.main,
                            model_flags + ["--input", best, "--fast_eval"])
    fast_launches = tile_composite.launches
    fast_s = time.time() - t1
    cfg = config_lib.parse_flags(evaluate_cli.build_parser(), model_flags + ["--input", best])
    test = get_dataset("test", cfg)
    ndc = make_ndc_config(test.w, test.h, test.focal)
    best_tree = N3Tree.load(best)
    c2w = test.camtoworlds[0]
    tile_img = TileRenderer(best_tree, step_size=cfg.renderer_step_size, ndc=ndc,
                            device="cuda").render_persp(c2w, test.h, test.w, test.focal)
    march_img = VolumeRenderer(best_tree, step_size=cfg.renderer_step_size, ndc=ndc,
                               device="cuda").render_persp(c2w, test.h, test.w, test.focal,
                                                           fast=False)
    mse = float(((np.clip(tile_img, 0, 1) - np.clip(march_img, 0, 1)) ** 2).mean())
    tile_vs_march = 10.0 * math.log10(1.0 / max(mse, 1e-12))
    t1 = time.time()
    quiet("render_path.log", nerf_eval_cli.main, model_flags + ["--render_path"])
    path_s = time.time() - t1
    frames = sorted(os.listdir(os.path.join(train_dir, "path_renders")))
    phase("LLFF NDC main path", t0, leaves=tree.n_leaves, depth=tree.max_depth,
          raw_psnr=raw["psnr"], extract_s=round(extract_s, 2), best_val_psnr=best_psnr,
          optimize_s=round(optimize_s, 2), optimize_tile_launches=opt_launches,
          march_eval_psnr=march_psnr, march_eval_s=round(march_s, 2), fast_eval_psnr=tile_psnr,
          fast_eval_s=round(fast_s, 2), fast_eval_launches=fast_launches,
          tile_vs_march_psnr=tile_vs_march, min_psnr=NDC_MIN_PSNR,
          path_renders=len(frames), render_path_s=round(path_s, 2))
    if fast_launches <= 0 or opt_launches != 0:
        raise RuntimeError(f"NDC tile launches: fast eval {fast_launches}, optimize "
                           f"{opt_launches} (the march must optimize NDC configs)")
    if not all(math.isfinite(v) for v in (raw["psnr"], march_psnr, tile_psnr)):
        raise RuntimeError(f"non-finite LLFF PSNRs: {raw['psnr']} {march_psnr} {tile_psnr}")
    if not tile_vs_march >= NDC_MIN_PSNR:
        raise RuntimeError(f"NDC tile frame {tile_vs_march} dB from the march frame "
                           f"(< {NDC_MIN_PSNR})")
    if len(frames) != 240 or "119.png" not in frames:
        raise RuntimeError(f"--render_path wrote {len(frames)} files, want 240 (120 poses)")


def viewdirs_main_path():
    """Phase 28: the train CLI on nerf_sh/config/misc/proj (use_viewdirs:
    the view-conditioned branch, the plain path; no trunk kernel may
    launch), 200 steps on the synthetic scene; then the extract CLI on that
    checkpoint by SH projection to degree 4 (SH25 tree; init_grid_depth
    PROJ_DEPTH), the tree reloading and its eval PSNR finite."""
    from plenoctree_tpu_torch.cli import extract as extract_cli
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.octree import N3Tree

    t0 = time.time()
    train_dir = tempfile.mkdtemp(prefix="train_proj_", dir=os.path.join(ROOT, "build", "smoke"))
    flags = ["--dataset", "synthetic"]
    model, state, launches, psnr, test_psnr = _train(PROJ_CONFIG, train_dir, flags)
    step, same = _restores_equal(model, state, train_dir)
    first, last = _check_train("proj train", psnr, step, same)
    names = len(list(model.MLP_0.layers()))
    phase("view-conditioned train main path", t0, config=PROJ_CONFIG, steps=len(psnr),
          mlp_layers=names, fwd_launches=launches[0], bwd_launches=launches[1],
          psnr_first20=first, psnr_last20=last, test_psnr=test_psnr, restored_step=step,
          params_equal=same)
    if launches != (0, 0) or not model.use_viewdirs:
        raise RuntimeError(f"the view-conditioned run launched trunk kernels: {launches}")
    del model, state
    t0 = time.time()
    out = os.path.join(train_dir, "tree.npz")
    fused_mlp.fwd_launches = 0
    with open(os.path.join(train_dir, "extract.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        tree = extract_cli.main(["--config", PROJ_CONFIG, *flags, "--train_dir", train_dir,
                                 "--device", "cuda", "--output", out,
                                 "--init_grid_depth", str(PROJ_DEPTH),
                                 "--chunk", str(PROJ_CHUNK),
                                 "--synthetic_resolution", str(EVAL_RES)])
    with open(out + ".results.json") as f:
        results = json.load(f)
    back = N3Tree.load(out)
    phase("projection extract main path", t0, format=repr(back.data_format),
          data_dim=back.data_dim, leaves=back.n_leaves, depth=back.max_depth,
          eval_psnr=results["psnr"], eval_ssim=results["ssim"],
          fwd_launches=fused_mlp.fwd_launches)
    if repr(back.data_format) != "SH25" or back.n_leaves != tree.n_leaves or tree.n_leaves == 0:
        raise RuntimeError(f"bad projected tree: {back}")
    if not math.isfinite(results["psnr"]):
        raise RuntimeError(f"bad projection extraction eval {results}")


def jax_checkpoints_on_card():
    """Phase 29: the committed checkpoints the JAX package's savers wrote,
    restored on the card through get_model_state(restore=True); bitwise
    against want.npz; then one 200x200 render from the TrainState."""
    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.data.rays import generate_rays
    from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene
    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.utils import config as config_lib

    t0 = time.time()
    want = np.load(os.path.join(JAX_FIXTURES, "want.npz"))
    seconds, model = {}, None
    for name in ("train_state", "jaxnerf_orbax", "jaxnerf_msgpack"):
        cfg = config_lib.parse_flags(train_cli.build_parser(), [
            "--config", "nerf_sh/config/blender", "--train_dir", os.path.join(JAX_FIXTURES, name),
            *JAX_FIXTURE_FLAGS])
        t1 = time.perf_counter()
        m, state = get_model_state(cfg, restore=True, device="cuda")
        seconds[name] = round(time.perf_counter() - t1, 3)
        group = "train_state" if name == "train_state" else "jaxnerf"
        groups = [("params", state.params)]
        if name == "train_state":
            groups += [("mu", state.opt_state["mu"]), ("nu", state.opt_state["nu"])]
            count = int(want["train_state/count"])
        else:
            count = 0
            if any(bool(t.any()) for m_ in ("mu", "nu") for t in state.opt_state[m_].values()):
                raise RuntimeError(f"{name}: the imported Adam moments are not fresh")
        for g, tensors in groups:
            for k, t in tensors.items():
                if not (t.is_cuda and np.array_equal(t.detach().cpu().numpy(),
                                                      want[f"{group}/{g}/{k}"])):
                    raise RuntimeError(f"{name}: {g}/{k} differs from the fixture")
        if state.step != int(want[f"{group}/step"]) or state.opt_state["count"] != count:
            raise RuntimeError(f"{name}: step {state.step}, count {state.opt_state['count']}")
        if name == "train_state":
            model = m
    _, c2ws, focal = render_synthetic_scene("test", 4, EVAL_RES, True, 2.0, 6.0)
    rays = generate_rays(EVAL_RES, EVAL_RES, focal, c2ws[:1])
    rgb, _, _ = engine.render_image(model.eval(), type(rays)(*[r[0] for r in rays]),
                                    device="cuda")
    phase("JAX checkpoints on the card", t0, fixtures=len(seconds),
          restore_s=json.dumps(seconds), render_shape=list(rgb.shape),
          render_finite=bool(np.isfinite(rgb).all()), render_mean=float(rgb.mean()))
    if rgb.shape != (EVAL_RES, EVAL_RES, 3) or not np.isfinite(rgb).all():
        raise RuntimeError("bad render from the JAX TrainState")


def gen_video_main_path(train_dir):
    """Phase 30: the gen_video CLI on phase 8's checkpoint at 800x800."""
    import io

    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.cli import gen_video
    from plenoctree_tpu_torch.data.rays import generate_rays
    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.utils import config as config_lib
    from plenoctree_tpu_torch.utils.png import read_png

    t0 = time.time()
    poses_path = os.path.join(train_dir, "video_poses.txt")
    argv = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--train_dir", train_dir, "--device", "cuda", *TRAINED_MODEL_FLAGS,
            "--num_views", str(GEN_VIDEO_VIEWS), "--write_poses", poses_path]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        video_dir = gen_video.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    mp4_line = [ln.strip() for ln in out.getvalue().splitlines() if "mp4" in ln or "video" in ln]
    frames = [read_png(os.path.join(video_dir, "frames", f"{i:04}.png"))
              for i in range(GEN_VIDEO_VIEWS)]
    poses = np.loadtxt(poses_path).reshape(-1, 4, 4)
    radii = np.linalg.norm(poses[:, :3, 3], axis=-1)
    cfg = config_lib.parse_flags(gen_video.build_parser(), argv)
    focal = 0.5 * cfg.width / np.tan(0.5 * cfg.camera_angle_x)
    pose0 = gen_video.orbit_poses(cfg.num_views, cfg.elevation, cfg.radius, cfg.up_axis)[:1]
    rays = generate_rays(cfg.width, cfg.height, focal, pose0)
    model, _ = get_model_state(cfg, seed=gen_video.SEED, restore=True, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rgb, _, _ = engine.render_image(model.eval(), type(rays)(*[r[0] for r in rays]),
                                    chunk=cfg.chunk, device="cuda")
    s_render = time.perf_counter() - t1
    frame0 = (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)
    same = bool(np.array_equal(frame0, frames[0]))
    phase("gen_video main path", t0, views=GEN_VIDEO_VIEWS, res=cfg.width,
          s_per_frame_cli=wall / GEN_VIDEO_VIEWS, s_render_frame0=s_render,
          png_shapes=sorted({f.shape for f in frames}), poses=len(poses),
          radius_err=float(np.abs(radii - cfg.radius).max()), frame0_bitwise=same,
          mp4=repr(mp4_line[-2:] if len(mp4_line) > 1 else mp4_line))
    if any(f.shape != (RES, RES, 3) for f in frames) or len(frames) != GEN_VIDEO_VIEWS:
        raise RuntimeError("gen_video frames are not 800x800 RGB")
    if len(poses) != GEN_VIDEO_VIEWS or not np.abs(radii - cfg.radius).max() < 1e-5:
        raise RuntimeError(f"bad poses file: {len(poses)} poses, radii {radii}")
    if not same:
        raise RuntimeError("gen_video frame 0 differs from engine.render_image of pose 0")


def gen_mesh_main_path(train_dir):
    """Phase 31: the gen_mesh CLI on phase 8's checkpoint through kernel #1
    at the published 300^3; then one dispatch kernel vs plain, and the
    marching card vs CPU on a sub-volume."""
    import io

    from plenoctree_tpu_torch.cli import gen_mesh
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.ops.marching import marching_tetrahedra
    from plenoctree_tpu_torch.ops.posenc import posenc
    from plenoctree_tpu_torch.utils import config as config_lib

    t0 = time.time()
    argv = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--train_dir", train_dir, "--device", "cuda", *TRAINED_MODEL_FLAGS,
            "--reso", str(GEN_MESH_RESO), "--c1", "-2", "--c2", "2", "--iso", "6.0",
            "--point_chunk", str(GEN_MESH_CHUNK)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.fwd_launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        res = gen_mesh.main(argv)
    torch.cuda.synchronize()
    launches = fused_mlp.fwd_launches
    peak = torch.cuda.max_memory_allocated()
    iso, cut = 6.0, None
    if res["sigma_max"] < 6.0:
        iso = GEN_MESH_FALLBACK_ISO * res["sigma_max"]
        cut = f"max sigma {res['sigma_max']} < 6.0: iso {iso}"
        print(f"[phase] gen_mesh: {cut}", flush=True)
        with contextlib.redirect_stdout(io.StringIO()):
            res = gen_mesh.main(argv[:-4] + ["--iso", str(iso), "--point_chunk",
                                             str(GEN_MESH_CHUNK)])
    size = os.path.getsize(res["path"])
    phase("gen_mesh main path", t0, reso=GEN_MESH_RESO, point_chunk=GEN_MESH_CHUNK,
          fwd_launches=launches, want_launches=GEN_MESH_LAUNCHES, iso=iso, cut=repr(cut),
          sigma_max=res["sigma_max"], vertices=res["vertices"], triangles=res["triangles"],
          obj_mb=size / 2**20, seconds=json.dumps({k: round(v, 3) for k, v in res["seconds"].items()}),
          peak_mem_gib=peak / 2**30)
    if launches != GEN_MESH_LAUNCHES:
        raise RuntimeError(f"gen_mesh launched the trunk kernel {launches} times, "
                           f"want {GEN_MESH_LAUNCHES}")
    if size <= 0 or res["vertices"] <= 0 or res["triangles"] <= 0:
        raise RuntimeError(f"empty mesh: {res}")

    # One dispatch: the grid's first 720,720 points through the kernel and
    # the plain version, on the restored fine trunk.
    t0 = time.time()
    cfg = config_lib.parse_flags(gen_mesh.build_parser(), argv)
    model, _ = get_model_state(cfg, restore=True, device="cuda")
    mlp = model.MLP_1
    flat, meta = mlp.flat_weights(None, 0)
    flat = [w.detach() for w in flat]
    axes = gen_mesh.grid_axes([GEN_MESH_RESO] * 3, [-2.0] * 3, [2.0] * 3)
    pts = gen_mesh.device_grid(axes, "cuda")[:GEN_MESH_CHUNK]
    x = posenc(pts, model.min_deg_point, model.max_deg_point, model.legacy_posenc_order)
    s_k, _ = fused_mlp.fused_trunk(flat, x, meta)
    s_p, _ = fused_mlp.fused_trunk_reference(flat, x, meta)
    torch.cuda.synchronize()
    err = float((s_k - s_p).abs().max())
    # TRUNK_FWD_ATOL was measured on outputs of magnitude ~0.8; a bf16
    # activation that rounds the other way moves an output in proportion
    # to its scale, and the trained sigma reaches ~10 here.
    scale = max(1.0, float(s_p.abs().max()))
    tol = TRUNK_FWD_ATOL * scale
    ms = cuda_ms(lambda: fused_mlp.fused_trunk(flat, x, meta), 10)
    plain_ms = cuda_ms(lambda: fused_mlp.fused_trunk_reference(flat, x, meta), 3)
    gs = torch.zeros_like(s_k)
    gr = torch.zeros((x.shape[0], meta["d_out"] - meta["n_sigma"]), device="cuda")
    lib_ms, _ = trunk_library(flat, x, gs, gr, meta)
    bound = trunk_bound(flat, meta, x.shape[0], 1)
    # The marching, card against CPU, on a 64^3 sub-volume the surface crosses.
    vol = res["volume"]
    inside = (vol > iso).float()
    c = torch.nonzero(inside).float().mean(0).round().long() if inside.any() else \
        torch.full((3,), GEN_MESH_RESO // 2, device=vol.device)
    lo = [int(min(max(int(v) - MARCH_SUB // 2, 0), GEN_MESH_RESO - MARCH_SUB)) for v in c]
    sub = vol[lo[0]:lo[0] + MARCH_SUB, lo[1]:lo[1] + MARCH_SUB, lo[2]:lo[2] + MARCH_SUB]
    vg, tg = marching_tetrahedra(sub, iso)
    vc, tc = marching_tetrahedra(sub.cpu(), iso)
    march_equal = bool(torch.equal(vg.cpu(), vc) and torch.equal(tg.cpu(), tc))
    phase("gen_mesh dispatch kernel vs plain", t0, rows=GEN_MESH_CHUNK, max_abs_err=err,
          sigma_scale=scale, tol=tol, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
          bound_ms=bound[0], bound_by=bound[1], march_sub=MARCH_SUB, march_lo=lo,
          march_sub_triangles=len(tc), march_card_cpu_bitwise=march_equal)
    if not err <= tol:
        raise RuntimeError(f"gen_mesh dispatch: kernel sigma off by {err} > {tol}")
    if not march_equal or len(tc) == 0:
        raise RuntimeError(f"marching on the card differs from the CPU ({len(tc)} triangles)")
    return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound": bound, "volume": res["volume"]}


def train_extras_path():
    """Phase 32: the train CLI's timings.txt and profiler hooks."""
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.utils import io as io_utils

    t0 = time.time()
    train_dir = tempfile.mkdtemp(prefix="extras_", dir=os.path.join(ROOT, "build", "smoke"))
    with open(os.path.join(train_dir, "train.log"), "w") as log, contextlib.redirect_stdout(log):
        train_cli.main([
            "--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--train_dir", train_dir, "--device", "cuda", *TRAINED_MODEL_FLAGS,
            "--batch_size", str(BENCH_BATCH), "--image_batching",
            "--max_steps", str(EXTRAS_STEPS), "--print_every", "1",
            "--save_every", str(EXTRAS_STEPS), "--render_every", "6",
            "--profile_start_step", "5", "--profile_steps", "3",
        ])
    torch.cuda.synchronize()
    timings = os.path.join(train_dir, "timings.txt")
    steps = [s for s, _ in io_utils.parse_timings(timings)]
    hours = io_utils.timings_total_hours(timings)
    traces = sorted(os.listdir(os.path.join(train_dir, "profile")))
    with open(os.path.join(train_dir, "profile", traces[-1])) as f:
        text = f.read()
    names = {k: text.count(k) for k in ("fwd_kernel", "bwd_rows_kernel", "atb_kernel")}
    phase("train extras (timings, profiler)", t0, steps=EXTRAS_STEPS, timings_steps=steps,
          total_hours=hours, traces=traces, trace_mb=len(text) / 2**20,
          trunk_kernel_mentions=json.dumps(names))
    if steps != [0, 6, 12] or not hours > 0:
        raise RuntimeError(f"bad timings.txt: steps {steps}, {hours} hours")
    if not (names["fwd_kernel"] and (names["bwd_rows_kernel"] or names["atb_kernel"])):
        raise RuntimeError(f"the profiler trace does not name both trunk kernels: {names}")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_cli_flags(train_dir, steps):
    """The smoke's torchrun training config: blender at batch 4096 on 32x32
    synthetic views, printing every 5 steps, saving and rendering at the
    last."""
    return ["--config", "nerf_sh/config/blender", "--dataset", "synthetic",
            "--synthetic_resolution", "32", "--train_dir", train_dir, *TRAINED_MODEL_FLAGS,
            "--batch_size", str(BENCH_BATCH), "--image_batching", "--max_steps", str(steps),
            "--print_every", "5", "--save_every", str(steps), "--render_every", str(steps)]


def _torchrun(nproc, train_dir, extra, steps, log_name):
    """The train CLI under torch.distributed.run with nproc ranks on
    _train_cli_flags; returns (rc, its output, seconds)."""
    return _torchrun_cli("train", _train_cli_flags(train_dir, steps) + extra, log_name, nproc)


def _rank_lines(out):
    """{rank: (steps, ms/step, all-reduce ms/step, fwd launches, bwd launches)}
    from the train CLI's closing line of each rank."""
    import re

    got = {}
    pat = re.compile(r"\* rank (\d+)/\d+: (\d+) steps, ([\d.]+) ms/step, all-reduce ([\d.]+) "
                     r"ms/step, trunk launches fwd (\d+) bwd (\d+)")
    for line in out.splitlines():
        m = pat.search(line)
        if m:
            r, n, ms, ar, f, b = m.groups()
            got[int(r)] = (int(n), float(ms), float(ar), int(f), int(b))
    return got


def _torchrun_cli(module, argv, log_name, nproc=2):
    """`python -m torch.distributed.run --nproc_per_node nproc -m
    plenoctree_tpu_torch.cli.<module> argv`; returns (rc, output, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
           "-m", f"plenoctree_tpu_torch.cli.{module}", *argv]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.time()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=DP_CLI_TIMEOUT)
    out = res.stdout + res.stderr
    with open(os.path.join(ROOT, "build", "smoke", log_name), "w") as f:
        f.write(out)
    return res.returncode, out, time.time() - t0


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_file(a, b):
    """Bytes equal; metrics.jsonl records equal without their wall-clock."""
    with open(a, "rb") as f, open(b, "rb") as g:
        x, y = f.read(), g.read()
    if a.endswith("metrics.jsonl"):
        x, y = [[{k: v for k, v in json.loads(ln).items() if k != "ts"}
                 for ln in z.decode().splitlines()] for z in (x, y)]
    return x == y


def multiprocess_inference(train_dir):
    """Phase 36: the eval, gen_video and gen_mesh CLIs each under `python -m
    torch.distributed.run --nproc_per_node 2` with gloo on cuda:0 (the three
    launches side by side: each is two process starts and little device
    work), against the same CLI run in this process over [cuda:0, cuda:0]
    while they start (there each chunk splits into the same two slices a
    rank renders, so every row is computed from the same rows): rank 0's
    files bitwise the
    one process's, and no other file; each gen_mesh rank's launches of
    kernel #1 (GEN_MESH_LAUNCHES / 2: 19 dispatches of 2 x 720,720 points,
    half on each rank) and the one process's (GEN_MESH_LAUNCHES)."""
    import io
    import re
    import shutil

    from plenoctree_tpu_torch.cli import eval as nerf_eval_cli
    from plenoctree_tpu_torch.cli import gen_mesh, gen_video
    from plenoctree_tpu_torch.kernels import fused_mlp

    t0 = time.time()
    root = os.path.join(ROOT, "build", "smoke", "multiprocess")
    shutil.rmtree(root, ignore_errors=True)
    ckpt = sorted((n for n in os.listdir(train_dir) if re.fullmatch(r"checkpoint_\d+", n)),
                  key=lambda n: int(n.split("_")[1]))[-1]
    model = ["--config", "nerf_sh/config/blender", "--device", "cuda:0", *TRAINED_MODEL_FLAGS]
    clis = {
        "eval": (nerf_eval_cli, ["--dataset", "blender", "--data_dir",
                                 os.path.join(ROOT, "build", "smoke", "blender"), "--eval_once",
                                 "--chunk", "8000"]),
        "gen_video": (gen_video, ["--dataset", "synthetic", "--num_views", "2",
                                  "--chunk", "8000"]),
        "gen_mesh": (gen_mesh, ["--reso", str(GEN_MESH_RESO), "--c1", "-2", "--c2", "2",
                                "--iso", "6.0", "--point_chunk", str(GEN_MESH_CHUNK)]),
    }
    dirs, one_s, one_launches, runs = {}, {}, {}, {}
    for name in clis:
        dirs[name] = {}
        for side in ("one", "ranks"):
            d = os.path.join(root, name, side)
            os.makedirs(d)
            shutil.copy(os.path.join(train_dir, ckpt), d)
            dirs[name][side] = d

    def launch(name):
        flags = clis[name][1]
        runs[name] = _torchrun_cli(
            name, model + flags + ["--dist_backend", "gloo", "--train_dir", dirs[name]["ranks"]],
            f"multiprocess_{name}.log")

    # The ranks start up while this process runs the references.
    threads = [threading.Thread(target=launch, args=(n,)) for n in clis]
    for th in threads:
        th.start()
    try:
        for name, (module, flags) in clis.items():
            fused_mlp.fwd_launches = 0
            t1 = time.time()
            with contextlib.redirect_stdout(io.StringIO()):
                module.main(model + flags + ["--train_dir", dirs[name]["one"]],
                            devices=["cuda:0", "cuda:0"])
            torch.cuda.synchronize()
            one_s[name] = round(time.time() - t1, 2)
            one_launches[name] = fused_mlp.fwd_launches
    finally:
        for th in threads:
            th.join()
    result = {}
    for name in clis:
        rc, out, secs = runs[name]
        if rc != 0:
            raise RuntimeError(f"{name} under torchrun failed ({rc}):\n{out[-3000:]}")
        one, ranks = dirs[name]["one"], dirs[name]["ranks"]
        made = [f for f in _files(one) if f != ckpt]
        differ = [f for f in made if os.path.exists(os.path.join(ranks, f))
                  and not _same_file(os.path.join(one, f), os.path.join(ranks, f))]
        same = _files(ranks) == _files(one) and not differ
        result[name] = dict(files=len(made), bitwise=same, torchrun_s=round(secs, 2),
                            one_process_s=one_s[name])
        if not (made and same):
            texts = {f: [open(os.path.join(d, f)).read()[:400] for d in (one, ranks)]
                     for f in differ if not f.endswith(".png")}
            raise RuntimeError(f"{name} under 2 ranks wrote other files than one process: "
                               f"{_files(ranks)} vs {_files(one)}; differing {differ}: {texts}")
    lines = {int(r): int(n) for r, n in re.findall(
        r"\* rank (\d+)/2: sigma grid [\d.]+ s, trunk launches fwd (\d+)", runs["gen_mesh"][1])}
    per_rank = -(-GEN_MESH_RESO ** 3 // (2 * GEN_MESH_CHUNK))
    phase("multi-process inference CLIs (torchrun, 2 gloo ranks on cuda:0)", t0,
          clis=json.dumps(result), gen_mesh_launches_per_rank=json.dumps(lines),
          gen_mesh_launches_one_process=one_launches["gen_mesh"], want_per_rank=per_rank)
    if lines != {0: per_rank, 1: per_rank} or one_launches["gen_mesh"] != 2 * per_rank:
        raise RuntimeError(f"gen_mesh launches: ranks {lines}, one process "
                           f"{one_launches['gen_mesh']}, want {per_rank} per rank")


def _tp_rank_lines(out):
    """{rank: (steps, ms/step, model collectives ms/step, fwd, bwd)} from the
    train CLI's closing lines under a model axis."""
    import re

    got = {}
    pat = re.compile(r"\* rank (\d+)/\d+: (\d+) steps, ([\d.]+) ms/step.*model collectives "
                     r"([\d.]+) ms/step, trunk launches fwd (\d+) bwd (\d+)")
    for line in out.splitlines():
        m = pat.search(line)
        if m:
            r, n, ms, col, f, b = m.groups()
            got[int(r)] = (int(n), float(ms), float(col), int(f), int(b))
    return got


def tp_train_path():
    """Phase 37: tensor parallelism over "model". The train CLI in this
    process for TP_STEPS steps of the smoke's torchrun config (no group),
    then under torch.distributed.run with --mesh_shape 1,2 (2 gloo ranks on
    cuda:0, each Dense layer's columns split between them, the fused kernels
    on gathered weights): the train losses at every print step within
    tests/test_partition.py's rtol 2e-5 of the one process's, checkpoint
    params within rtol 5e-5 / atol 1e-6, kernels #1 and #2 launched 3 times
    a step on each rank; each rank's ms/step and its model-axis
    collectives' ms/step."""
    import io

    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.models.params import params_from_flax
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils
    from plenoctree_tpu_torch.utils.metrics_writer import read_scalars

    t0 = time.time()
    one_dir = tempfile.mkdtemp(prefix="tp_one_", dir=os.path.join(ROOT, "build", "smoke"))
    tp_dir = tempfile.mkdtemp(prefix="tp_", dir=os.path.join(ROOT, "build", "smoke"))
    flags = _train_cli_flags(one_dir, TP_STEPS) + ["--device", "cuda:0"]
    launches0 = (fused_mlp.fwd_launches, fused_mlp.bwd_launches)
    t1 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(flags)
    one_s = time.time() - t1
    one_launches = (fused_mlp.fwd_launches - launches0[0], fused_mlp.bwd_launches - launches0[1])
    rc, out, secs = _torchrun(2, tp_dir, ["--device", "cuda:0", "--dist_backend", "gloo",
                                          "--mesh_shape", "1,2"], TP_STEPS, "tp_train.log")
    if rc != 0:
        raise RuntimeError(f"torchrun --mesh_shape 1,2 failed with {rc}:\n{out[-3000:]}")
    lines = _tp_rank_lines(out)
    want = [v for _, v in read_scalars(one_dir, "train_loss")]
    got = [v for _, v in read_scalars(tp_dir, "train_loss")]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want)) if got else float("inf")
    a = ckpt_utils.read_checkpoint(os.path.join(one_dir, f"checkpoint_{TP_STEPS}"))
    b = ckpt_utils.read_checkpoint(os.path.join(tp_dir, f"checkpoint_{TP_STEPS}"))
    pa, pb = params_from_flax(a["variables"]["params"]), params_from_flax(b["variables"]["params"])
    param_excess = max(float(((pb[k] - pa[k]).abs() - (5e-5 * pa[k].abs() + 1e-6)).max())
                       for k in pa)
    params_bitwise = all(torch.equal(pa[k], pb[k]) for k in pa)
    phase("tensor-parallel train CLI (torchrun --mesh_shape 1,2, 2 gloo ranks on cuda:0)", t0,
          steps=TP_STEPS, seconds=round(secs, 2), one_process_s=round(one_s, 2),
          ranks=json.dumps({r: dict(zip(("steps", "ms_per_step", "model_collectives_ms_per_step",
                                         "fwd_launches", "bwd_launches"), v))
                            for r, v in lines.items()}),
          one_process_launches=one_launches, train_loss=json.dumps(got),
          train_loss_one_process=json.dumps(want), loss_max_rel=loss_rel,
          params_bitwise=params_bitwise, param_excess_over_tol=param_excess)
    want_lines = (TP_STEPS, 3 * TP_STEPS, 3 * TP_STEPS)
    if sorted(lines) != [0, 1] or any((v[0], v[3], v[4]) != want_lines for v in lines.values()):
        raise RuntimeError(f"bad TP rank lines {lines}, want steps/fwd/bwd {want_lines}")
    if len(got) != len(want) or not loss_rel <= 2e-5 or not param_excess <= 0.0:
        raise RuntimeError(f"TP training off one process: losses {got} vs {want}, "
                           f"params over tolerance by {param_excess}")


def dp_train_path(train_dir):
    """Phase 33: data-parallel training. Two gloo ranks on cuda:0, each half
    of a 4096-ray batch, one step of the blender config at full width from
    phase 8's checkpoint_200 (its Adam moments) against a one-process step
    on the whole batch; then the train CLI under torch.distributed.run, two
    gloo ranks on cuda:0 for DP_STEPS steps (one NCCL rank: nccl_train_path)."""
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.data.rays import Rays
    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.parallel.ranks import run_ranks, train_steps
    from plenoctree_tpu_torch.utils import checkpoints as ckpt_utils
    from plenoctree_tpu_torch.utils import config as config_lib

    t0 = time.time()
    argv = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--train_dir",
            train_dir, *TRAINED_MODEL_FLAGS]
    cfg = config_lib.parse_flags(train_cli.build_parser(), argv)
    flags = {k: v for k, v in vars(cfg).items() if hasattr(config_lib.default_config(), k)}
    model, state = get_model_state(cfg, restore=True, device="cpu")
    params = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    opt = {"count": state.opt_state["count"],
           **{m: {k: v.numpy() for k, v in state.opt_state[m].items()} for m in ("mu", "nu")}}
    rng = np.random.default_rng(SEED + 33)
    n, f32 = BENCH_BATCH, np.float32
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3)) * 0.3 - o / 4.0
    batch = {"pixels": rng.uniform(size=(n, 3)).astype(f32),
             "rays": Rays(*[a.astype(f32) for a in (o, d, d / np.linalg.norm(d, axis=-1,
                                                                              keepdims=True))])}
    draws = {"t_rand": rng.uniform(size=(n, cfg.num_coarse_samples)).astype(f32),
             "u": rng.uniform(size=(n, cfg.num_fine_samples + 1)).astype(f32),
             "sp_points": rng.uniform(-cfg.sparsity_radius, cfg.sparsity_radius,
                                      (cfg.sparsity_npoints, 3)).astype(f32)}
    kw = dict(cfg=flags, params=params, batches=[batch], draws=[draws], opt_state=opt,
              device="cuda:0", launches=True)
    one = train_steps(0, 1, **kw)
    t1 = time.time()
    two = run_ranks("plenoctree_tpu_torch.parallel.ranks:train_steps", 2, kw, timeout=300)
    ranks_s = time.time() - t1
    same = all(np.array_equal(two[0]["params"][-1][k], two[1]["params"][-1][k]) for k in params)
    worst, worst_grad = 0.0, 0.0
    for k, p0 in one["params"][0].items():
        update = float(np.abs(one["params"][-1][k] - p0).max())
        err = float(np.abs(two[0]["params"][-1][k] - one["params"][-1][k]).max())
        worst = max(worst, err / max(update, 1e-30))
        g1, g2 = one["grads"][0][k], two[0]["grads"][0][k]
        worst_grad = max(worst_grad, float(np.abs(g2 - g1).max() / max(np.abs(g1).max(), 1e-30)))
    launches = [(r["fwd_launches"], r["bwd_launches"]) for r in two]
    phase("data-parallel step vs one process", t0, ranks=2, backend="gloo", device="cuda:0",
          rows_per_rank=n // 2, ranks_bitwise_equal=same, update_rel_err=worst,
          grad_rel_err=worst_grad, tol=TRUNK_GRAD_RTOL, launches_per_rank=launches,
          all_reduce_ms=[r["all_reduce_ms"] for r in two], ranks_s=round(ranks_s, 2),
          loss=(one["stats"][0]["loss"], two[0]["stats"][0]["loss"]))
    if not same:
        raise RuntimeError("the two ranks' parameters differ after the step")
    if not worst <= TRUNK_GRAD_RTOL:
        raise RuntimeError(f"2-rank step off the one-process step: {worst} of the update")
    if launches != [(3, 3), (3, 3)]:
        raise RuntimeError(f"each rank must launch both trunk kernels 3 times: {launches}")

    t0 = time.time()
    dp_dir = tempfile.mkdtemp(prefix="dp_", dir=os.path.join(ROOT, "build", "smoke"))
    rc, out, secs = _torchrun(2, dp_dir, ["--device", "cuda:0", "--dist_backend", "gloo"],
                              DP_STEPS, "dp_train.log")
    lines = _rank_lines(out)
    if rc != 0:
        raise RuntimeError(f"torchrun (2 gloo ranks) failed with {rc}:\n{out[-3000:]}")
    names = sorted(os.listdir(dp_dir))
    with open(os.path.join(dp_dir, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    loss_steps = [r["step"] for r in rows if r["tag"] == "train_loss"]
    with open(os.path.join(dp_dir, "timings.txt")) as f:
        timing_steps = [int(ln.split()[0]) for ln in f.read().splitlines()]
    fresh, _ = get_model_state(cfg, restore=False, device="cuda")
    restored = ckpt_utils.restore_checkpoint(dp_dir, ckpt_utils.create_train_state(fresh))
    phase("data-parallel train CLI (torchrun, 2 gloo ranks on cuda:0)", t0, steps=DP_STEPS,
          seconds=round(secs, 2), ranks=json.dumps({r: dict(zip(
              ("steps", "ms_per_step", "all_reduce_ms_per_step", "fwd_launches", "bwd_launches"),
              v)) for r, v in lines.items()}),
          files=names, loss_steps=loss_steps, timings_steps=timing_steps,
          restored_step=restored.step)
    want = (DP_STEPS, 3 * DP_STEPS, 3 * DP_STEPS)
    if sorted(lines) != [0, 1] or any((v[0], v[3], v[4]) != want for v in lines.values()):
        raise RuntimeError(f"bad rank lines {lines}, want steps/fwd/bwd {want}")
    if loss_steps != list(range(5, DP_STEPS + 1, 5)) or timing_steps != [0, DP_STEPS]:
        raise RuntimeError(f"rank 0 alone must write: metrics {loss_steps}, timings {timing_steps}")
    if restored.step != DP_STEPS or f"checkpoint_{DP_STEPS}" not in names:
        raise RuntimeError(f"checkpoint_{DP_STEPS} did not restore: {names}")


def nccl_train_path():
    """Phase 33c: the train CLI under torch.distributed.run with one rank and
    the default NCCL backend for NCCL_STEPS steps (run beside phase 36's
    rank starts: its ms/step carries their host load, its all-reduce ms is
    CUDA events around NCCL's kernel)."""
    t0 = time.time()
    nccl_dir = tempfile.mkdtemp(prefix="nccl_", dir=os.path.join(ROOT, "build", "smoke"))
    rc, out, secs = _torchrun(1, nccl_dir, ["--device", "cuda"], NCCL_STEPS, "nccl_train.log")
    lines = _rank_lines(out)
    backend = "(nccl)" in out
    phase("data-parallel train CLI (torchrun, 1 NCCL rank)", t0, rc=rc, steps=NCCL_STEPS,
          seconds=round(secs, 2), nccl_group=backend, rank0=lines.get(0))
    if rc != 0 or not backend or lines.get(0, (0,))[0] != NCCL_STEPS:
        raise RuntimeError(f"torchrun with one NCCL rank failed ({rc}):\n{out[-3000:]}")


def sharded_serving(tree, index, smi, tree_path):
    """Phase 34: the serving tree over [cuda:0, cuda:0] (TileRenderer(mesh)):
    N_SHARDED_POSES orbit poses at 800x800 bitwise the one-device frames,
    kernel #3 launched twice a frame; ms/frame of both (u8 output); then
    the eval CLI's --shard_devices 2 refused on a one-GPU host (phase 5
    runs it with --shard_devices 1)."""
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer
    from plenoctree_tpu_torch.parallel import make_mesh

    t0 = time.time()
    focal = 1.1 * RES
    kw = dict(step_size=1e-4, sigma_thresh=1e-2, stop_thresh=1e-2, index=index)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    poses = [orbit_pose(2.0 * np.pi * k / N_SHARDED_POSES) for k in range(N_SHARDED_POSES)]
    single = TileRenderer(tree, device="cuda", **kw)
    sharded = TileRenderer(tree, mesh=mesh, **kw)
    frames = [single.render_persp(c2w, RES, RES, focal) for c2w in poses]
    sharded.w1cap, sharded.ccap = single.w1cap, single.ccap
    tile_composite.launches = 0
    ranges = []  # (device, tile range) of every phase-1 call the sharded frames make
    real_inputs = TileRenderer.make_tile_inputs_fn

    def spy(self, *a, tiles=None, device=None, **k):
        ranges.append((str(device), tiles))
        return real_inputs(self, *a, tiles=tiles, device=device, **k)

    TileRenderer.make_tile_inputs_fn = spy
    try:
        equal = []
        for c2w, want in zip(poses, frames):
            equal.append(bool(np.array_equal(sharded.render_persp(c2w, RES, RES, focal), want)))
        torch.cuda.synchronize()
    finally:
        TileRenderer.make_tile_inputs_fn = real_inputs
    launches = tile_composite.launches
    # Phase 1 alone: each device's tile range, and the whole frame on one.
    phase1_ms = []
    for dev, rep, _, tiles in sharded.tile_ranges(RES, RES):
        fn = sharded.make_tile_inputs_fn(RES, RES, focal, sharded.rcap, sharded.w1cap,
                                         sharded.ccap, tiles=tiles, device=dev)
        phase1_ms.append(cuda_ms(lambda: fn(poses[0], rep["csr"], rep["base"], rep["extra_data"],
                                            rep["blk_bbox"]), 3))
    idx = single.index
    fn = single.make_tile_inputs_fn(RES, RES, focal, single.rcap, single.w1cap, single.ccap)
    phase1_one = cuda_ms(lambda: fn(poses[0], idx["csr"], idx["base"], single.extra_data,
                                    idx["blk_bbox"]), 3)
    ms = {}
    for name, r in (("single", single), ("sharded", sharded)):
        srv = TileRenderer(tree, output="u8", device="cuda", mesh=r.mesh, **kw)
        srv.w1cap, srv.ccap = single.w1cap, single.ccap
        srv.render_persp(poses[0], RES, RES, focal)  # warm-up
        times = []
        for c2w in poses:
            t1 = time.perf_counter()
            srv.render_persp(c2w, RES, RES, focal)
            times.append((time.perf_counter() - t1) * 1e3)
        ms[name] = float(np.median(times))
    refused = None
    if torch.cuda.device_count() == 1:
        try:
            with contextlib.redirect_stdout(sys.stderr):
                eval_cli.main(["--input", tree_path, "--config", "nerf_sh/config/blender",
                               "--dataset", "synthetic", "--synthetic_resolution",
                               str(EVAL_RES), "--fast_eval", "--shard_devices", "2"])
        except ValueError as e:
            refused = str(e)
    half = -(-(RES // 16) ** 2 // 2)
    want_ranges = [("cuda:0", (0, half)), ("cuda:0", (half, (RES // 16) ** 2))] * N_SHARDED_POSES
    phase("sharded serving", t0, devices="cuda:0,cuda:0", poses=N_SHARDED_POSES, res=RES,
          bitwise_equal=equal, launches=launches, phase1_tile_ranges=json.dumps(ranges[:2]),
          phase1_calls=len(ranges), phase1_ms_per_device=phase1_ms,
          phase1_ms_one_device=phase1_one, median_ms_sharded=ms["sharded"],
          median_ms_single=ms["single"], shard2_refused=repr(refused), gpu=repr(smi))
    if not all(equal):
        raise RuntimeError(f"sharded frames differ from the one-device frames: {equal}")
    if ranges != want_ranges:
        raise RuntimeError(f"phase 1 did not run once per device on its tile range: {ranges}")
    if launches != 2 * N_SHARDED_POSES:
        raise RuntimeError(f"kernel #3 launched {launches} times over {N_SHARDED_POSES} frames")
    if torch.cuda.device_count() == 1 and refused is None:
        raise RuntimeError("--shard_devices 2 was not refused on a one-GPU host")


def sharded_inference(train_dir, one_device_volume):
    """Phase 35: inference over [cuda:0, cuda:0]: render_image at 200x200
    against one device, the extract CLI (depth 6, phase 9's flags) against
    phase 9's tree, gen_mesh at 300^3 with --mesh_shape 2 against phase
    31's volume, kernel #1's launches counted."""
    import io

    from plenoctree_tpu_torch import engine
    from plenoctree_tpu_torch.cli import extract as extract_cli
    from plenoctree_tpu_torch.cli import gen_mesh
    from plenoctree_tpu_torch.cli import train as train_cli
    from plenoctree_tpu_torch.data.rays import generate_rays
    from plenoctree_tpu_torch.data.synthetic import render_synthetic_scene
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.models.nerf import get_model_state
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.utils import config as config_lib

    devices = ["cuda:0", "cuda:0"]
    t0 = time.time()
    argv = ["--config", "nerf_sh/config/blender", "--dataset", "synthetic", "--train_dir",
            train_dir, "--device", "cuda", *TRAINED_MODEL_FLAGS]
    cfg = config_lib.parse_flags(train_cli.build_parser(), argv)
    model, _ = get_model_state(cfg, restore=True, device="cuda")
    _, c2ws, focal = render_synthetic_scene("test", 1, EVAL_RES, True, 2.0, 6.0)
    rays = generate_rays(EVAL_RES, EVAL_RES, focal, c2ws[:1])
    rays = type(rays)(*[np.asarray(r[0]) for r in rays])
    chunk = EVAL_RES * EVAL_RES // 5  # 8000: two 4000-ray slices, no tail
    t1 = time.perf_counter()
    one = engine.render_image(model, rays, chunk=chunk, device="cuda")
    one_s = time.perf_counter() - t1
    rerun = engine.render_image(model, rays, chunk=chunk, device="cuda")
    half = engine.render_image(model, rays, chunk=chunk // 2, device="cuda")
    t1 = time.perf_counter()
    many = engine.render_image(model, rays, chunk=chunk, device="cuda", devices=devices)
    many_s = time.perf_counter() - t1
    spread = max(float(np.abs(a - b).max()) for a, b in zip(one + one, rerun + half))
    err = max(float(np.abs(a - b).max()) for a, b in zip(many, one))
    same_rows = all(np.array_equal(a, b) for a, b in zip(many, half))
    phase("sharded render_image", t0, devices=",".join(devices), res=EVAL_RES, chunk=chunk,
          max_abs_err_vs_one=err, rerun_and_chunk_spread=spread,
          bitwise_vs_one_at_half_chunk=same_rows, one_s=round(one_s, 3),
          sharded_s=round(many_s, 3))
    if not (err <= spread and same_rows and all(np.isfinite(x).all() for x in many)):
        raise RuntimeError(f"sharded render_image: {err} beyond the spread {spread}, "
                           f"bitwise at the slice size {same_rows}")

    t0 = time.time()
    out = os.path.join(ROOT, "build", "smoke", "extract_sharded", "tree.npz")
    fused_mlp.fwd_launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        tree = extract_cli.main(argv + ["--output", out, "--noeval", "--mesh_shape", "2",
                                        *EXTRACT_FLAGS], devices=devices)
    torch.cuda.synchronize()
    launches = fused_mlp.fwd_launches
    tree = N3Tree.load(out)
    ref = N3Tree.load(os.path.join(ROOT, "build", "smoke", "extract", "tree.npz"))
    same_topology = tree.n_leaves == ref.n_leaves and np.array_equal(tree.child, ref.child)
    data_err = float(np.abs(tree.data - ref.data).max()) if same_topology else float("inf")
    phase("sharded extract", t0, devices=",".join(devices), depth=EXTRACT_DEPTH,
          fwd_launches=launches, leaves=tree.n_leaves, same_topology=same_topology,
          max_abs_err_vs_one_device=data_err)
    if not (same_topology and data_err == 0.0 and launches > 0):
        raise RuntimeError(f"sharded extraction differs from phase 9's tree ({data_err})")

    t0 = time.time()
    fused_mlp.fwd_launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        res = gen_mesh.main(argv + ["--reso", str(GEN_MESH_RESO), "--c1", "-2", "--c2", "2",
                                    "--iso", "6.0", "--point_chunk", str(GEN_MESH_CHUNK),
                                    "--mesh_shape", "2"], devices=devices)
    torch.cuda.synchronize()
    launches = fused_mlp.fwd_launches
    vol_equal = bool(torch.equal(res["volume"], one_device_volume.to(res["volume"].device)))
    phase("sharded gen_mesh", t0, devices=",".join(devices), reso=GEN_MESH_RESO,
          fwd_launches=launches, want_launches=GEN_MESH_LAUNCHES, volume_bitwise=vol_equal,
          vertices=res["vertices"], seconds=json.dumps({k: round(v, 3) for k, v in
                                                         res["seconds"].items()}))
    if launches != GEN_MESH_LAUNCHES or not vol_equal:
        raise RuntimeError(f"sharded gen_mesh: {launches} launches, volume equal {vol_equal}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plenoctree_tpu_torch.cli import evaluate as eval_cli
    from plenoctree_tpu_torch.data.poses import orbit_pose
    from plenoctree_tpu_torch.data.synthetic import build_scene_tree, render_synthetic_scene
    from plenoctree_tpu_torch import native
    from plenoctree_tpu_torch.kernels import _build
    from plenoctree_tpu_torch.kernels import fused_mlp
    from plenoctree_tpu_torch.kernels import gather_sum
    from plenoctree_tpu_torch.kernels import tile_composite
    from plenoctree_tpu_torch.octree import N3Tree
    from plenoctree_tpu_torch.octree.tile_render import TileRenderer

    start = time.time()
    os.chdir(ROOT)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    t0 = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = gpu_name_and_power()
    phase("device", t0, card=repr(kind), nvidia_smi=repr(smi), count=torch.cuda.device_count())

    # The kernels build (one nvcc each, and g++) while the host bakes the
    # model and renders the views; they are joined before the first launch.
    build_t0, build_s, build_error = time.time(), [], []

    def build():
        try:
            build_all([tile_composite.build, fused_mlp.build, gather_sum.build, native_build])
        except BaseException as e:  # re-raised below, after the join
            build_error.append(e)
        build_s.append(time.time() - build_t0)

    kernel_build = threading.Thread(target=build)
    kernel_build.start()

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

    # The CLIs' synthetic views at 200x200, rendered once on the host (the
    # three splits on threads: numpy's large ops release the GIL): the
    # renders are memoized in process, and phases 5, 13 (three CLI runs),
    # 16 and 18 reuse them.
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()

    def render_split(split, n_views):
        t1 = time.time()
        render_synthetic_scene(split, n_views, EVAL_RES, True, 2.0, 6.0)
        return split, round(time.time() - t1, 2)

    with ThreadPoolExecutor(3) as pool:
        split_s = dict(pool.map(lambda a: render_split(*a),
                                (("test", 4), ("train", 12), ("val", 4))))
    phase("synthetic views", t0, res=EVAL_RES, seconds_by_split=json.dumps(split_s))
    blender_round_trip()

    kernel_build.join()
    if build_error:
        raise build_error[0]
    phase(
        "kernel build", time.time() - build_s[0], beside="model, synthetic views, blender scene",
        ptxas=repr(ptxas_summary(_build.build_logs, "tile_composite")),
        trunk_ptxas=repr(ptxas_summary(_build.build_logs, "fused_mlp")),
        gather_ptxas=repr(ptxas_summary(_build.build_logs, "gather_sum")),
        native=repr(native.summary()), native_built_in_this_run=native.build_log is not None,
        gxx=repr(subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
                 .splitlines()[0]),
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
    sub = tile_subset(p2)
    out_p = tile_composite.composite_tiles_reference(*take_tiles(p2, sub), soa, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all() and torch.isfinite(out_p).all()):
        raise RuntimeError("non-finite tile compositing output")
    max_abs_err = float((out_k[sub] - out_p).abs().max())
    ms_kernel = cuda_ms(lambda: tile_composite.composite_tiles(*p2, soa, **kw), 10)
    _, ms_plain = timed_once_ms(lambda: tile_composite.composite_tiles_reference(*p2, soa, **kw))
    ms_inputs = cuda_ms(
        lambda: tile_inputs(c2w, idx["csr"], idx["base"], renderer.extra_data, idx["blk_bbox"]), 5
    )
    n_pieces = p2[0][:, 0, 0]
    fwd_bound = bound_of(*tile_work(p2, soa, kw["sigma_row"], kw["quantum"], out_k.numel() * 4),
                         F32_FLOPS)
    phase(
        "kernel vs plain", t0, tiles=p2[0].shape[0], pieces_max=int(n_pieces.max()),
        pieces_mean=float(n_pieces.float().mean()), index_build_s=round(t_index, 2),
        plain_tiles=sub.numel(), max_abs_err=max_abs_err, tol=KERNEL_ATOL, kernel_ms=ms_kernel, plain_ms=ms_plain,
        tile_inputs_ms=ms_inputs, bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
    )
    if not max_abs_err <= KERNEL_ATOL:
        raise RuntimeError(f"kernel disagrees with the plain version: {max_abs_err} > {KERNEL_ATOL}")

    t0 = time.time()
    tile_composite.launches = 0
    psnr, ssim, lpips = eval_cli.main([
        "--input", tree_path, "--config", "nerf_sh/config/blender",
        "--dataset", "synthetic", "--synthetic_resolution", str(EVAL_RES),
        "--fast_eval", "--shard_devices", "1", "--device", "cuda",
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
        if k == 0:
            served0 = img.astype(np.float64)  # phase 15's reference for the march
    peak = torch.cuda.max_memory_allocated(dev)
    phase(
        "serving", t0, frames=N_ORBIT, median_ms=float(np.median(frame_ms)),
        best_ms=float(np.min(frame_ms)), first_ms=frame_ms[0],
        peak_mem_gib=peak / 2**30, ccap=server.ccap, w1cap=server.w1cap, gpu=repr(smi),
    )
    del server, soa, p2, out_k, out_p
    ndc_serving(tree, renderer.index, smi)
    sharded_serving(tree, renderer.index, smi, tree_path)
    del renderer, idx
    torch.cuda.empty_cache()

    trunk = trunk_vs_plain(dev)
    with kernel_switches(False):
        (fwd_launches, bwd_launches), train_dir = train_main_path(dev)
    train_variants_path()
    with kernel_switches(False):
        extract_main_path(train_dir)
    train_throughput(False)
    train_throughput(True)
    torch.cuda.empty_cache()
    opt, ti, bwd = tile_bwd_vs_plain(tree)
    optimize_throughput(opt, ti)
    del opt, ti
    torch.cuda.empty_cache()
    tile_bwd_launches, tile_opt_best = optimize_main_path(tree)
    torch.cuda.empty_cache()
    gather = gather_vs_plain()
    vr, frames = march_full_width(tree, served0)
    exact_eval_main_path(tree_path, vr)
    march_opt_throughput(vr, frames)
    del vr, frames
    torch.cuda.empty_cache()
    march_optimize_main_path(tile_opt_best)
    torch.cuda.empty_cache()
    with kernel_switches(False):
        sg_dir = sg_train_main_path()
        nerf_eval_main_path(train_dir, sg_dir)
        tt_args = tt_train_main_path()
    torch.cuda.empty_cache()
    # The two fleets are host-bound processes: the T&T fleet runs beside
    # the synthetic one (their phase lines come from their threads).
    tt_error = []

    def tt_fleet():
        try:
            tt_fleet_main_path(*tt_args)
        except BaseException as e:  # re-raised below, after the join
            tt_error.append(e)

    fleet_trees = {}

    def syn_fleet():
        try:
            fleet_trees.update(fleet_main_path(train_dir, sg_dir))
        except BaseException as e:  # re-raised below, after the join
            tt_error.append(e)

    fleets = [threading.Thread(target=tt_fleet), threading.Thread(target=syn_fleet)]
    for th in fleets:
        th.start()
    # The LLFF and view-conditioned paths run here meanwhile: their phases
    # report quality and seconds, not device times, and the fleets' stages
    # are process starts and host work with little on the card.
    try:
        with kernel_switches(False):
            llff_main_path()
            viewdirs_main_path()
    finally:
        for th in fleets:
            th.join()
    if tt_error:
        raise tt_error[0]
    torch.cuda.empty_cache()
    fleet_tree_march(fleet_trees["SH16"])
    sg_tiles(tree)
    compression_main_path(fleet_trees)
    torch.cuda.empty_cache()
    jax_checkpoints_on_card()
    with kernel_switches(False):
        gen_video_main_path(train_dir)
        mesh_res = gen_mesh_main_path(train_dir)
        train_extras_path()
        dp_train_path(train_dir)
        sharded_inference(train_dir, mesh_res.pop("volume"))
        nccl_error = []

        def nccl():
            try:
                nccl_train_path()
            except BaseException as e:  # re-raised below, after the join
                nccl_error.append(e)

        nccl_thread = threading.Thread(target=nccl)
        nccl_thread.start()
        try:
            multiprocess_inference(train_dir)
        finally:
            nccl_thread.join()
        if nccl_error:
            raise nccl_error[0]
        tp_train_path()
    phase("total", start)

    bench_rows = trunk["default", TRUNK_ROWS]
    print(json.dumps({"kernels": [
        {
            "name": "tile_composite",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/tile_composite.cu",
            "replaces": "plenoctree_tpu/octree/tile_render.py:711",
            "launches": main_launches,
            "max_abs_err": max(max_abs_err, bwd["fwd_exact_err"]),  # serving and exact mode
            "ms": ms_kernel,
            "plain_ms": ms_plain,
            "bound_ms": fwd_bound[0],
            "bound_by": fwd_bound[1],
            "library_ms": None,
        },
        {
            "name": "fused_mlp_fwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "plenoctree_tpu/kernels/fused_mlp.py:185",
            "launches": fwd_launches,
            "max_abs_err": max(r["fwd_err"] for r in trunk.values()),  # every variant
            "ms": bench_rows["fwd_ms"],
            "plain_ms": bench_rows["fwd_plain"],
            "bound_ms": bench_rows["bound_fwd"][0],
            "bound_by": bench_rows["bound_fwd"][1],
            "library_ms": bench_rows["lib_fwd"],
        },
        {
            "name": "fused_mlp_bwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "plenoctree_tpu/kernels/fused_mlp.py:268",
            "launches": bwd_launches,
            "max_abs_err": max(r["bwd_abs"] for r in trunk.values()),  # every variant
            "ms": bench_rows["bwd_ms"],
            "plain_ms": bench_rows["bwd_plain"],
            "bound_ms": bench_rows["bound_bwd"][0],
            "bound_by": bench_rows["bound_bwd"][1],
            "library_ms": bench_rows["lib_bwd"],
        },
        {
            "name": "tile_composite_bwd",
            "route": "cuda",
            "source": "plenoctree_tpu_torch/csrc/tile_composite.cu",
            "replaces": "plenoctree_tpu/octree/tile_opt.py:44",
            "launches": tile_bwd_launches,
            "max_abs_err": bwd["max_abs_err"],
            "ms": bwd["ms"],
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd["bound_ms"],
            "bound_by": bwd["bound_by"],
            "library_ms": None,
        },
        *[
            {
                "name": name,
                "route": "cuda",
                "source": "plenoctree_tpu_torch/csrc/gather_sum.cu",
                "replaces": replaces,
                "launches": gather[v]["launches"],
                "max_abs_err": gather[v]["max_abs_err"],
                "ms": gather[v]["ms"],
                "plain_ms": gather[v]["plain_ms"],
                "bound_ms": gather[v]["bound_ms"],
                "bound_by": gather[v]["bound_by"],
                "library_ms": gather[v]["library_ms"],
            }
            for name, v, replaces in (
                ("gather_sum_vmem", "vmem_u1", "scripts/bench_gather.py:103"),
                ("gather_sum_tile", "tile", "scripts/bench_gather.py:143"),
                ("gather_sum_vmem_rk", "vmem_rk", "scripts/bench_gather2.py:124"),
            )
        ],
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
