"""The yardstick of the per-layer shares: published peaks, and the
operations and bytes each measured kernel needs, worked out from the
benchmark's own inputs (shapes, the scene, the pose), never from what the
program derived.

A least time is the larger of operations over the peak and bytes over the
memory rate, each input byte read once and each output byte written once.
Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), at its 700 W
power limit: a card set lower runs below them, so every share is reported
beside the card's power limit.

Frozen copies, so that a later change to the program cannot move them:
  * the trunk (kernels #1/#2) counts model FLOPs: 2 per multiply-add of every
    layer, the forward once and the backward at twice the forward (the
    cotangents and the weight gradients; a recompute that an implementation
    chooses is not counted). chip_smoke.py's trunk bound counts the
    backward at three forwards (it includes the recompute);
  * the tile kernels (#3 forward, #4 backward) count, per frame, the
    (ray, leaf) pairs that the volume rendering composites and the distinct
    leaves it reads (benchmark/reference/octree_ref.py::count, from the
    scene and the pose), where chip_smoke.py's bound counts the rows of
    the program's phase-1 pieces.
"""

BF16_FLOPS = 989e12  # dense bf16 tensor cores
F32_FLOPS = 67e12  # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def least_time(flops, nbytes, peak):
    """Seconds: the larger of flops / peak and bytes / the memory rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def trunk_macs(d_in, width, depth, skip, n_sigma, n_rgb):
    """Multiply-adds per row of one trunk with its two heads."""
    macs, k = 0, d_in
    for i in range(depth):
        macs += k * width
        k = width + d_in if (i % skip == 0 and i > 0) else width
    return macs + k * (n_sigma + n_rgb)


def trunk_params(d_in, width, depth, skip, n_sigma, n_rgb):
    """Weights and biases of one trunk with its two heads."""
    n, k = 0, d_in
    for i in range(depth):
        n += k * width + width
        k = width + d_in if (i % skip == 0 and i > 0) else width
    return n + k * (n_sigma + n_rgb) + n_sigma + n_rgb


def train_step_work(model, batch):
    """(flops, bytes) of one training step's trunk calls (kernels #1/#2):
    the coarse trunk on batch x Sc rows, the fine trunk on batch x (Sc + Sf)
    rows and on the sparsity points, each forward + backward. Bytes: each
    call's encoded input and raw outputs (f32) once, its cotangents read
    and, per trunk, the weights read twice and their gradients written
    once."""
    d_in = 3 + 6 * (model["max_deg_point"] - model["min_deg_point"])
    k = (model["sh_deg"] + 1) ** 2 if model.get("sh_deg", -1) >= 0 else model["sg_dim"]
    shape = dict(d_in=d_in, width=model["net_width"], depth=model["net_depth"],
                 skip=model["skip_layer"], n_sigma=1, n_rgb=3 * k)
    macs = trunk_macs(**shape)
    rows = batch * (2 * model["num_coarse_samples"] + model["num_fine_samples"])
    rows += model["sparsity_npoints"]
    flops = 2.0 * macs * rows * 3
    out_cols = 1 + 3 * k
    nbytes = F32 * rows * (d_in + 2 * out_cols) + 2 * 3 * F32 * trunk_params(**shape)
    return flops, nbytes


def tile_fwd_work(counts, basis_dim, n_channels, data_dim):
    """(flops, bytes) of kernel #3 on one frame: per composited (ray, leaf)
    pair the slab test (6 multiply-adds), the colour (basis_dim multiply-adds
    and a sigmoid per channel, counted as 2 flops) and the compositing
    (8 flops); bytes: each leaf read once (its box, 6 floats, and its data
    row) and each ray's colour and transmittance written once."""
    per_pair = 12 + n_channels * (2 * basis_dim + 2) + 8
    flops = float(counts["pairs"]) * per_pair
    nbytes = F32 * (counts["leaves"] * (6 + data_dim) + counts["rays"] * (n_channels + 1))
    return flops, nbytes


def tile_bwd_work(counts, basis_dim, n_channels, data_dim):
    """(flops, bytes) of kernel #4 on one frame: the forward's work again per
    pair, plus the gradient of each colour coefficient and of sigma (a
    multiply-add per coefficient, 10 flops for sigma); bytes: each leaf
    read once, each ray's colour, transmittance and cotangent read once,
    each leaf's gradient row written once."""
    fwd, _ = tile_fwd_work(counts, basis_dim, n_channels, data_dim)
    flops = fwd + float(counts["pairs"]) * (2 * n_channels * basis_dim + 10)
    nbytes = F32 * (counts["leaves"] * (6 + 2 * data_dim)
                    + counts["rays"] * 2 * (n_channels + 1))
    return flops, nbytes


def sgd_update_bytes(n_values):
    """Bytes of one SGD update of n_values f32 parameters: the parameter and
    its gradient read, the parameter written."""
    return 3.0 * F32 * n_values
