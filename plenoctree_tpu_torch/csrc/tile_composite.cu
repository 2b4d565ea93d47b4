// Tile compositing for PlenOctree serving: one block per 16x16-pixel tile.
//
// Replaces plenoctree_tpu/octree/tile_render.py::_tile_kernel (the Pallas TPU
// kernel launched from TileRenderer._get_p2). Same inputs (the phase-1 piece
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

__global__ void tile_composite_kernel(Params p) {
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

  const int q4 = p.quantum / 4;
  const float4* soa4 = reinterpret_cast<const float4*>(p.soa);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // Per-group saturation (a group whose every ray is past od_cap can gain
    // nothing more); the syncs also fence the previous chunk's buffer use.
    const bool unsat = cum <= p.od_cap;
    int g_unsat = 0;
    for (int g = 0; g < 4; ++g) g_unsat |= (__syncthreads_or(unsat && grp == g) != 0) << g;
    if (g_unsat == 0) break;  // whole tile saturated: uniform exit

    if (tid < G) {
      const int pi = chunk * G + tid;
      const bool valid = pi < n_pieces;
      s_piece[tid] = valid ? c0_t[pi] : 0;
      s_piece[G + tid] = valid ? lo_t[pi] : 0;
      s_piece[2 * G + tid] = valid ? hi_t[pi] : 0;
      s_piece[3 * G + tid] = valid ? mask_t[pi] : 0;
    }
    __syncthreads();

    // Stage the chunk: piece g is the contiguous block soa[c0/quantum].
    const int per_piece = p.fields * q4;
    for (int i = tid; i < G * per_piece; i += rays) {
      const int g = i / per_piece;
      const int rem = i - g * per_piece;
      const int f = rem / q4;
      const int l4 = rem - f * q4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (chunk * G + g < n_pieces) {
        const size_t blk = s_piece[g] / p.quantum;
        v = soa4[(blk * p.fields + f) * q4 + l4];
      }
      reinterpret_cast<float4*>(buf + f * R + g * p.quantum)[l4] = v;
    }
    __syncthreads();

    // Per-row lane meta: dead lanes (outside the owning run, or past the
    // piece count) get sigma 0; the precedence key along the mean direction.
    for (int r = tid; r < R; r += rays) {
      const int g = r / p.quantum;
      const int rowid = s_piece[g] + (r - g * p.quantum);
      const bool live = rowid >= s_piece[G + g] && rowid < s_piece[2 * G + g];
      s_sigma[r] = live ? fmaxf(buf[p.sigma_row * R + r], 0.f) : 0.f;
      s_key[r] = 0.5f * ((buf[0 * R + r] + buf[3 * R + r]) * m0 +
                         (buf[1 * R + r] + buf[4 * R + r]) * m1 +
                         (buf[2 * R + r] + buf[5 * R + r]) * m2);
      s_idx[r] = r;
    }
    __syncthreads();

    // Bitonic sort of (key, lane), ascending.
    for (int size = 2; size <= R; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < R; i += rays) {
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
  Params p{meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa, out,
           ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum,
           step_eps, stop_thresh, od_cap, sigmoid};
  const size_t smem = pn_tile_composite_smem_bytes(rays, basis_dim, fields, runrows, quantum);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(tile_composite_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tile_composite_kernel<<<n_tiles, rays, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* pn_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
