// Tile compositing for PlenOctree serving and its backward for the tile
// optimizer: one block per tile of pixels (16x16 by default, up to 32x32).
//
// tile_composite_kernel replaces plenoctree_tpu/octree/tile_render.py::
// _tile_kernel (the Pallas TPU kernel launched from TileRenderer._get_p2);
// tile_composite_bwd_kernel replaces plenoctree_tpu/octree/tile_opt.py::
// _tile_bwd_kernel (see the comment above it). Same inputs (the phase-1 piece
// list of each tile, per-ray origin/inverse-direction/aux/basis, the blocked
// soa [n_blk, fields, quantum]) and the same per-hit arithmetic; the TPU's
// DMA ring, semaphores, [R,R] precedence matmul and ones-column reductions
// are not carried over.
//
// What bounds it on an H100: (1) scattered soa reads: every chunk is a set
// of quantum-row blocks picked by phase 1 from a multi-GB table, so each
// block costs a DRAM round trip that the block cannot hide by itself; (2)
// per-ray serial work within a chunk: each ray walks the chunk's rows in
// front-to-back order with a running optical depth, so a chunk is
// runrows sequential steps per thread.
// What the design does about it: each piece is one contiguous
// fields x quantum block (about 28 KB per chunk for SH16 at runrows 128),
// staged into shared memory with coalesced 16-byte loads by all 256
// threads; many tiles are resident per SM, so one tile's loads overlap
// another's walk. The walk skips rows with zero sigma with a branch that is
// uniform over the block (every thread visits the same row), and decodes
// colour only for rays that hit a row while still alive. Quad-group masks
// from phase 1 and the saturation tests skip whole groups and tiles.
//
// Precedence: within a chunk, rows are sorted by (key, lane) with key =
// 0.5 (lo + hi) . mdir (bitonic sort in shared memory). That is exactly the
// strict total order `before = key_i < key_j | (key_i == key_j & i < j)` of
// the TPU kernel; keys are compared in f32.
//
// Numerics: f32 throughout (the TPU's use_bf16 operand rounding is not
// reproduced). Built with --fmad=false, so nothing is contracted behind the
// source's back: the slab test is an explicit fmaf (box*invd - o*invd with
// one rounding, as XLA computes it), everything else rounds as written,
// like the plain PyTorch version.
// Sums (optical depth in front, colour, opacity) are taken sequentially in
// front-to-back order rather than by a matmul: results agree with the plain
// version to f32 summation-order rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 7;  // rgb(nc) + transmittance fit in 8 outputs

struct Params {
  const int* meta;        // [T, 1, 4]: n_pieces
  const int* piece_c0;    // [T, 1, ccap]: quantum-aligned row start
  const int* piece_lo;    // [T, 1, ccap]: owning run's live rows [lo, hi)
  const int* piece_hi;
  const int* piece_mask;  // [T, 1, ccap]: 4-bit quad-group mask
  const float* o;         // [T, rays, 4]
  const float* invd;      // [T, rays, 4]
  const float* aux;       // [T, rays, 4]: delta_scale, tmin, tmax, pad
  const float* mdir;      // [T, 1, 4]
  const float* basis;     // [T, rays, basis_dim]
  const float* soa;       // [n_blk, fields, quantum]
  float* out;             // [T, rays, 8]
  int ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum;
  float step_eps, stop_thresh, od_cap;
  int sigmoid;  // 1: SH/SG (sigmoid of the decode), 0: RGBA (raw)
};

// Loads piece descriptors (c0, lo, hi, mask) of chunk `chunk` into s_piece
// [4, G] and stages its soa rows into buf [fields, R]: piece g is the
// contiguous block soa[c0/quantum], copied with coalesced 16-byte loads by
// the whole block. Slots past n_pieces get zero rows and empty runs.
__device__ __forceinline__ void stage_chunk(const int* c0_t, const int* lo_t, const int* hi_t, const int* mask_t,
                            int n_pieces, int chunk, int G, int quantum, int fields, int R,
                            const float* soa, float* buf, int* s_piece) {
  const int tid = threadIdx.x;
  if (tid < G) {
    const int pi = chunk * G + tid;
    const bool valid = pi < n_pieces;
    s_piece[tid] = valid ? c0_t[pi] : 0;
    s_piece[G + tid] = valid ? lo_t[pi] : 0;
    s_piece[2 * G + tid] = valid ? hi_t[pi] : 0;
    s_piece[3 * G + tid] = valid ? mask_t[pi] : 0;
  }
  __syncthreads();
  const int q4 = quantum / 4;
  const float4* soa4 = reinterpret_cast<const float4*>(soa);
  const int per_piece = fields * q4;
  for (int i = tid; i < G * per_piece; i += blockDim.x) {
    const int g = i / per_piece;
    const int rem = i - g * per_piece;
    const int f = rem / q4;
    const int l4 = rem - f * q4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (chunk * G + g < n_pieces) {
      const size_t blk = s_piece[g] / quantum;
      v = soa4[(blk * fields + f) * q4 + l4];
    }
    reinterpret_cast<float4*>(buf + f * R + g * quantum)[l4] = v;
  }
  __syncthreads();
}

// Per-row lane meta of the staged chunk, then its precedence order: dead
// lanes (outside the owning run, or past the piece count) get sigma 0; rows
// are sorted by (key, lane) ascending with key = 0.5 (lo + hi) . mdir
// (bitonic sort in shared memory), which is exactly the strict total order
// `before = key_i < key_j | (key_i == key_j & i < j)` of the TPU kernels.
__device__ __forceinline__ void sort_chunk(const float* buf, const int* s_piece, int G, int quantum, int R,
                           int sigma_row, float m0, float m1, float m2, float* s_key,
                           float* s_sigma, int* s_idx) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int r = tid; r < R; r += nthreads) {
    const int g = r / quantum;
    const int rowid = s_piece[g] + (r - g * quantum);
    const bool live = rowid >= s_piece[G + g] && rowid < s_piece[2 * G + g];
    s_sigma[r] = live ? fmaxf(buf[sigma_row * R + r], 0.f) : 0.f;
    s_key[r] = 0.5f * ((buf[0 * R + r] + buf[3 * R + r]) * m0 +
                       (buf[1 * R + r] + buf[4 * R + r]) * m1 +
                       (buf[2 * R + r] + buf[5 * R + r]) * m2);
    s_idx[r] = r;
  }
  __syncthreads();
  for (int size = 2; size <= R; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < R; i += nthreads) {
        const int j = i ^ stride;
        if (j > i) {
          const float ki = s_key[i], kj = s_key[j];
          const int ii = s_idx[i], ij = s_idx[j];
          const bool i_after_j = (ki > kj) || (ki == kj && ii > ij);
          if (i_after_j == ((i & size) == 0)) {
            s_key[i] = kj;
            s_key[j] = ki;
            s_idx[i] = ij;
            s_idx[j] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Instantiated twice (see pn_tile_composite): for tiles of up to 256 rays
// (16x16) with at most 64 registers, so 4 blocks fit on an SM (unbounded,
// ptxas takes 72 registers and 3 blocks fit; chip_smoke.py's serving frame
// read 15.41 ms with the bound and 18.12 ms without, in separate runs on an
// H100 80GB HBM3 at 700 W), and for tiles of up to 1024 rays (32x32), where
// the same 64-register cap is what lets 1024 threads launch at all.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) tile_composite_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int R = p.runrows;
  const int rays = blockDim.x;
  const int tid = threadIdx.x;
  const int G = R / p.quantum;
  const int bd = p.basis_dim;
  const int nc = p.n_channels;
  float* buf = reinterpret_cast<float*>(smem4);  // [fields, R]
  float* s_basis = buf + p.fields * R;           // [bd, rays]
  float* s_key = s_basis + bd * rays;            // [R]
  float* s_sigma = s_key + R;                    // [R]
  int* s_idx = reinterpret_cast<int*>(s_sigma + R);  // [R]
  int* s_piece = s_idx + R;                      // [4, G]: c0, lo, hi, mask

  const size_t tile = blockIdx.x;
  const size_t ray = tile * rays + tid;
  const int grp = tid / (rays / 4);
  const int n_pieces = p.meta[tile * 4];
  const int n_chunks = (n_pieces + G - 1) / G;
  const int* c0_t = p.piece_c0 + tile * p.ccap;
  const int* lo_t = p.piece_lo + tile * p.ccap;
  const int* hi_t = p.piece_hi + tile * p.ccap;
  const int* mask_t = p.piece_mask + tile * p.ccap;

  const float ivx = p.invd[ray * 4 + 0];
  const float ivy = p.invd[ray * 4 + 1];
  const float ivz = p.invd[ray * 4 + 2];
  const float oix = p.o[ray * 4 + 0] * ivx;
  const float oiy = p.o[ray * 4 + 1] * ivy;
  const float oiz = p.o[ray * 4 + 2] * ivz;
  const float dscale = p.aux[ray * 4 + 0];
  const float tmin = p.aux[ray * 4 + 1];
  const float tmax = p.aux[ray * 4 + 2];
  const float m0 = p.mdir[tile * 4 + 0];
  const float m1 = p.mdir[tile * 4 + 1];
  const float m2 = p.mdir[tile * 4 + 2];
  for (int k = 0; k < bd; ++k) s_basis[k * rays + tid] = p.basis[ray * bd + k];

  float cum = 0.f;
  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // Per-group saturation (a group whose every ray is past od_cap can gain
    // nothing more); the syncs also fence the previous chunk's buffer use.
    const bool unsat = cum <= p.od_cap;
    int g_unsat = 0;
    for (int g = 0; g < 4; ++g) g_unsat |= (__syncthreads_or(unsat && grp == g) != 0) << g;
    if (g_unsat == 0) break;  // whole tile saturated: uniform exit

    stage_chunk(c0_t, lo_t, hi_t, mask_t, n_pieces, chunk, G, p.quantum, p.fields, R, p.soa, buf,
                s_piece);
    sort_chunk(buf, s_piece, G, p.quantum, R, p.sigma_row, m0, m1, m2, s_key, s_sigma, s_idx);

    int cmask = 0;
    for (int g = 0; g < G; ++g) cmask |= s_piece[3 * G + g];
    if (((cmask >> grp) & 1) && ((g_unsat >> grp) & 1)) {
      float prefix = 0.f;  // optical depth of this chunk's hits in front
      float cum_add = 0.f;
      for (int q = 0; q < R; ++q) {
        const int r = s_idx[q];
        const float sigma = s_sigma[r];
        if (sigma == 0.f) continue;  // same row for every thread: uniform
        // Slab test in FMA form, t = box*invd - o*invd with one rounding,
        // as the TPU kernel (and XLA on the CPU) computes it.
        const float t1x = fmaf(buf[0 * R + r], ivx, -oix);
        const float t2x = fmaf(buf[3 * R + r], ivx, -oix);
        const float t1y = fmaf(buf[1 * R + r], ivy, -oiy);
        const float t2y = fmaf(buf[4 * R + r], ivy, -oiy);
        const float t1z = fmaf(buf[2 * R + r], ivz, -oiz);
        const float t2z = fmaf(buf[5 * R + r], ivz, -oiz);
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        const float entry = fmaxf(tn, tmin);
        if (!(tf > entry && entry <= tmax)) continue;
        const float sdt = sigma * (tf - entry + p.step_eps) * dscale;
        if (sdt == 0.f) continue;
        const float light = expf(-(cum + prefix));
        if (light > p.stop_thresh) {
          const float contrib = light * (1.f - expf(-sdt));
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c < nc) {
              const float* coef = buf + (6 + c * bd) * R + r;
              float raw = 0.f;
              for (int k = 0; k < bd; ++k) raw += s_basis[k * rays + tid] * coef[k * R];
              const float rgb = p.sigmoid ? 0.5f * tanhf(0.5f * raw) + 0.5f : raw;
              acc[c] += contrib * rgb;
            }
          }
          cum_add += sdt;
        }
        prefix += sdt;
      }
      cum += cum_add;  // opacity freezes once a ray stops (alive-gated)
    }
  }

  float* out = p.out + ray * 8;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float v = 0.f;
    if (c < nc) v = acc[c < kMaxChannels ? c : 0];
    if (c == nc) v = expf(-cum);
    out[c] = v;
  }
}

struct BwdParams {
  const int* meta;
  const int* piece_c0;
  const int* piece_lo;
  const int* piece_hi;
  const int* piece_mask;
  const float* o;
  const float* invd;
  const float* aux;
  const float* mdir;
  const float* basis;
  const float* soa;
  const float* out;  // [T, rays, 8]: the forward's output (rgb(nc), transmittance)
  const float* g;    // [T, rays, 8]: its cotangent
  float* gsoa;       // [n_blk, fields, quantum]: zero on entry, gradients added
  int ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum;
  float step_eps;
  int sigmoid;
};

// Backward of the exact-mode tile compositor (stop_thresh 0, no saturation
// exits) with respect to the soa: the port of plenoctree_tpu/octree/
// tile_opt.py::_tile_bwd_kernel.
//
// The forward replayed in its chunk order and (key, lane) precedence, one
// thread per ray. No reverse walk and no stored per-hit state: for hit i of
// a ray,
//   dL/dsdt_i = gsum_i * light_i * exp(-sdt_i) - suffix_i,
//   suffix_i  = T_all - prefix_i - e_i,   e_i = gsum_i * contrib_i,
// where gsum = sum_c g_c rgb_c, T_all = sum_{c <= nc} g_c out_c comes from
// the forward output, and prefix_i (the sum of e over the hits in front of i)
// runs in the sorted walk. Row gradients: sigma gets sum_rays dL/dsdt * dtv
// (only rows with sigma > 0 are visited, so the ReLU gate holds); colour
// coefficient (c, k) gets sum_rays basis_k * g_c * contrib * rgb_c(1-rgb_c)
// for SH/SG, basis_k * g_c * contrib for RGBA; geometry rows get none. A
// quad group whose chunk-mask bit is clear is skipped, as on the TPU.
//
// Numerics: the slab test is the TPU backward's own `(box - o) * invd`, a
// subtract and a multiply (the forward's is the FMA form); with --fmad=false
// nothing is contracted, so the hit decisions equal the JAX backward's and
// the plain version's on the same inputs. sdt = sigma * dtv with
// dtv = (tf - entry + eps) * dscale, in the TPU backward's order.
//
// Accumulation across rays and tiles: the TPU adds each chunk into the
// gradient soa by read-modify-write, race-free only because its grid runs in
// order. Here tiles run at once and share soa rows, so a chunk's row
// gradients [nc*bd + 1, R] are summed in shared memory first: per visited
// row, the warp reduce-scatters its values across lanes with shuffles (31
// shuffles for 32 values, lane l ends with value l's warp sum) and each lane
// adds one value with a shared-memory atomic. After the chunk, the non-zero
// entries go to device memory with float atomicAdd. The order of those
// atomics changes from run to run, so two runs agree to f32
// summation-order rounding, not bit for bit.
//
// What bounds it on an H100: the per-(ray, row) replay of the forward
// (slab test, decode) plus, per visited row, the warp reduction of
// nc*bd + 1 values; the soa reads are the forward's. Rows whose sigma is 0
// are skipped block-uniformly and the reduction only runs for warps with a
// hit.
//
// Instantiated for tiles of up to 256 rays (127 registers) and of up to
// 1024 rays, where the 1024-thread bound caps it at 64 registers (the
// reduce-scatter's 32 values then spill): large tiles launch, slowly.
template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) tile_composite_bwd_kernel(BwdParams p) {
  extern __shared__ float4 smem4[];
  const int R = p.runrows;
  const int rays = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int G = R / p.quantum;
  const int bd = p.basis_dim;
  const int nc = p.n_channels;
  const int ncb = nc * bd;
  const int nvals = ncb + 1;  // colour coefficients, then sigma
  float* buf = reinterpret_cast<float*>(smem4);  // [fields, R]
  float* s_basis = buf + p.fields * R;           // [bd, rays]
  float* s_draw = s_basis + bd * rays;           // [nc, rays]: per-channel colour cotangent
  float* s_gacc = s_draw + nc * rays;            // [nvals, R]: this chunk's row gradients
  float* s_key = s_gacc + nvals * R;             // [R]
  float* s_sigma = s_key + R;                    // [R]
  int* s_idx = reinterpret_cast<int*>(s_sigma + R);  // [R]
  int* s_piece = s_idx + R;                      // [4, G]

  const size_t tile = blockIdx.x;
  const size_t ray = tile * rays + tid;
  const int grp = tid / (rays / 4);
  const int n_pieces = p.meta[tile * 4];
  const int n_chunks = (n_pieces + G - 1) / G;
  const int* c0_t = p.piece_c0 + tile * p.ccap;
  const int* lo_t = p.piece_lo + tile * p.ccap;
  const int* hi_t = p.piece_hi + tile * p.ccap;
  const int* mask_t = p.piece_mask + tile * p.ccap;

  const float ox = p.o[ray * 4 + 0];
  const float oy = p.o[ray * 4 + 1];
  const float oz = p.o[ray * 4 + 2];
  const float ivx = p.invd[ray * 4 + 0];
  const float ivy = p.invd[ray * 4 + 1];
  const float ivz = p.invd[ray * 4 + 2];
  const float dscale = p.aux[ray * 4 + 0];
  const float tmin = p.aux[ray * 4 + 1];
  const float tmax = p.aux[ray * 4 + 2];
  const float m0 = p.mdir[tile * 4 + 0];
  const float m1 = p.mdir[tile * 4 + 1];
  const float m2 = p.mdir[tile * 4 + 2];
  for (int k = 0; k < bd; ++k) s_basis[k * rays + tid] = p.basis[ray * bd + k];

  float gc[kMaxChannels];
  float t_all = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    gc[c] = c < nc ? p.g[ray * 8 + c] : 0.f;
    if (c < nc) t_all += gc[c] * p.out[ray * 8 + c];
  }
  t_all += p.g[ray * 8 + nc] * p.out[ray * 8 + nc];

  float cum = 0.f;   // optical depth of the earlier chunks
  float pref = 0.f;  // sum of e over the earlier chunks
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    stage_chunk(c0_t, lo_t, hi_t, mask_t, n_pieces, chunk, G, p.quantum, p.fields, R, p.soa, buf,
                s_piece);
    sort_chunk(buf, s_piece, G, p.quantum, R, p.sigma_row, m0, m1, m2, s_key, s_sigma, s_idx);
    for (int i = tid; i < nvals * R; i += rays) s_gacc[i] = 0.f;
    __syncthreads();

    int cmask = 0;
    for (int g = 0; g < G; ++g) cmask |= s_piece[3 * G + g];
    const bool on = (cmask >> grp) & 1;
    float pre_sdt = 0.f;  // this chunk's optical depth in front
    float pre_e = 0.f;    // this chunk's e in front
    for (int q = 0; q < R; ++q) {
      const int r = s_idx[q];
      const float sigma = s_sigma[r];
      if (sigma == 0.f) continue;  // same row for every thread: uniform
      bool hit = false;
      float vsig = 0.f;
      if (on) {
        // (box - o) * invd: a subtract, then a multiply (see above).
        const float t1x = (buf[0 * R + r] - ox) * ivx;
        const float t2x = (buf[3 * R + r] - ox) * ivx;
        const float t1y = (buf[1 * R + r] - oy) * ivy;
        const float t2y = (buf[4 * R + r] - oy) * ivy;
        const float t1z = (buf[2 * R + r] - oz) * ivz;
        const float t2z = (buf[5 * R + r] - oz) * ivz;
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        const float entry = fmaxf(tn, tmin);
        hit = tf > entry && entry <= tmax;
        if (hit) {
          const float dtv = (tf - entry + p.step_eps) * dscale;
          const float sdt = sigma * dtv;
          const float light = expf(-(cum + pre_sdt));
          const float esdt = expf(-sdt);
          const float contrib = light * (1.f - esdt);
          float gsum = 0.f;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c < nc) {
              const float* coef = buf + (6 + c * bd) * R + r;
              float raw = 0.f;
              for (int k = 0; k < bd; ++k) raw += s_basis[k * rays + tid] * coef[k * R];
              const float rgb = p.sigmoid ? 0.5f * tanhf(0.5f * raw) + 0.5f : raw;
              gsum += gc[c] * rgb;
              s_draw[c * rays + tid] =
                  p.sigmoid ? gc[c] * contrib * rgb * (1.f - rgb) : gc[c] * contrib;
            }
          }
          const float e = gsum * contrib;
          const float suffix = t_all - (pref + pre_e) - e;
          const float dsdt = gsum * light * esdt - suffix;
          vsig = dsdt * dtv;
          pre_sdt += sdt;
          pre_e += e;
        }
      }
      if (!__any_sync(0xffffffffu, hit)) continue;  // no lane of this warp hit row r
      // Row r's nvals values, 32 at a time: value j < ncb is colour
      // coefficient (c, k) = (j / bd, j % bd), value ncb is sigma.
      for (int base = 0; base < nvals; base += 32) {
        float v[32];
        int c = base / bd;
        int k = base - c * bd;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = base + i;
          float x = 0.f;
          if (hit) {
            if (j < ncb) x = s_basis[k * rays + tid] * s_draw[c * rays + tid];
            else if (j == ncb) x = vsig;
          }
          v[i] = x;
          if (++k == bd) {
            k = 0;
            ++c;
          }
        }
        // Reduce-scatter: after the step of width w, a lane holds the
        // partial sums of the half of its values selected by its bit w.
#pragma unroll
        for (int w = 16; w >= 1; w >>= 1) {
          const bool upper = (lane & w) != 0;
#pragma unroll
          for (int i = 0; i < w; ++i) {
            const float send = upper ? v[i] : v[i + w];
            const float keep = upper ? v[i + w] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
          }
        }
        const int j = base + lane;
        if (j < nvals && v[0] != 0.f) atomicAdd(&s_gacc[j * R + r], v[0]);
      }
    }
    if (on) {
      cum += pre_sdt;
      pref += pre_e;
    }
    __syncthreads();

    // Add the chunk's row gradients into the pieces' soa blocks.
    const int per_piece = nvals * p.quantum;
    for (int i = tid; i < G * per_piece; i += rays) {
      const int g = i / per_piece;
      const int rem = i - g * per_piece;
      const int j = rem / p.quantum;
      const int l = rem - j * p.quantum;
      const float v = s_gacc[j * R + g * p.quantum + l];
      if (chunk * G + g < n_pieces && v != 0.f) {
        const size_t blk = s_piece[g] / p.quantum;
        atomicAdd(&p.gsoa[(blk * p.fields + 6 + j) * p.quantum + l], v);
      }
    }
    __syncthreads();  // s_piece and s_gacc are rewritten by the next chunk
  }
}

// Launches one instantiation of a kernel: one block of `rays` threads per
// tile, with its dynamic shared memory opted in above the 48 KB default.
template <typename Kernel, typename P>
int launch(Kernel kernel, const P& p, int n_tiles, int rays, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, rays, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t pn_tile_composite_smem_bytes(int rays, int basis_dim, int fields, int runrows, int quantum) {
  const int G = runrows / quantum;
  return sizeof(float) * ((size_t)fields * runrows + (size_t)basis_dim * rays + 3 * (size_t)runrows) +
         sizeof(int) * 4 * (size_t)G;
}

int pn_tile_composite(const int* meta, const int* piece_c0, const int* piece_lo, const int* piece_hi,
                      const int* piece_mask, const float* o, const float* invd, const float* aux,
                      const float* mdir, const float* basis, const float* soa, float* out, int n_tiles,
                      int rays, int ccap, int basis_dim, int n_channels, int sigma_row, int fields,
                      int runrows, int quantum, float step_eps, float stop_thresh, float od_cap,
                      int sigmoid, void* stream) {
  if (n_tiles == 0) return 0;
  if (rays % 32 != 0 || rays > 1024) return (int)cudaErrorInvalidValue;
  Params p{meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa, out,
           ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum,
           step_eps, stop_thresh, od_cap, sigmoid};
  const size_t smem = pn_tile_composite_smem_bytes(rays, basis_dim, fields, runrows, quantum);
  if (rays <= 256) return launch(tile_composite_kernel<256, 4>, p, n_tiles, rays, smem, stream);
  return launch(tile_composite_kernel<1024, 1>, p, n_tiles, rays, smem, stream);
}

size_t pn_tile_composite_bwd_smem_bytes(int rays, int basis_dim, int n_channels, int fields,
                                        int runrows, int quantum) {
  const int G = runrows / quantum;
  const size_t nvals = (size_t)n_channels * basis_dim + 1;
  return sizeof(float) * ((size_t)fields * runrows + (size_t)(basis_dim + n_channels) * rays +
                          nvals * runrows + 2 * (size_t)runrows) +
         sizeof(int) * ((size_t)runrows + 4 * (size_t)G);
}

int pn_tile_composite_bwd(const int* meta, const int* piece_c0, const int* piece_lo,
                          const int* piece_hi, const int* piece_mask, const float* o,
                          const float* invd, const float* aux, const float* mdir, const float* basis,
                          const float* soa, const float* out, const float* g, float* gsoa,
                          int n_tiles, int rays, int ccap, int basis_dim, int n_channels,
                          int sigma_row, int fields, int runrows, int quantum, float step_eps,
                          int sigmoid, void* stream) {
  if (n_tiles == 0) return 0;
  if (n_channels < 1 || n_channels > kMaxChannels || sigma_row != 6 + n_channels * basis_dim ||
      rays % 32 != 0 || rays > 1024)
    return (int)cudaErrorInvalidValue;
  BwdParams p{meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa, out,
              g, gsoa, ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum, step_eps,
              sigmoid};
  const size_t smem =
      pn_tile_composite_bwd_smem_bytes(rays, basis_dim, n_channels, fields, runrows, quantum);
  if (rays <= 256) return launch(tile_composite_bwd_kernel<256>, p, n_tiles, rays, smem, stream);
  return launch(tile_composite_bwd_kernel<1024>, p, n_tiles, rays, smem, stream);
}

const char* pn_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
