// Tile compositing for PlenOctree serving and its backward for the tile
// optimizer: one block per tile of pixels (16x16 by default); a tile of more
// than 256 rays (up to 32x32) runs as four blocks, one per quad group.
//
// tile_composite_kernel replaces plenoctree_tpu/octree/tile_render.py::
// _tile_kernel (the Pallas TPU kernel launched from TileRenderer._get_p2);
// tile_composite_bwd_kernel replaces plenoctree_tpu/octree/tile_opt.py::
// _tile_bwd_kernel (see the comment above it). Same inputs (the phase-1 piece
// list of each tile, per-ray origin/inverse-direction/aux/basis, the blocked
// soa [n_blk, fields, quantum]) and the same per-hit arithmetic; the TPU's
// DMA ring, semaphores and [R,R] precedence matmul are not carried over.
//
// What bounds it on an H100: (1) scattered soa reads: every chunk is a set
// of quantum-row blocks picked by phase 1 from a multi-GB table, each a DRAM
// round trip; (2) per-ray serial work within a chunk: each ray walks the
// chunk's rows in front-to-back order with a running optical depth.
// What the design does about it, in both kernels: a block is up to 8
// consumer warps (one thread per ray) and one producer warp.
// - Staging: each piece is the first sigma_row + 1 rows of one contiguous
//   fields x quantum block (the box, the data and sigma; the soa pads its
//   fields to a multiple of 8, and the padding is not copied): 28 KB per
//   chunk for SH16 at runrows 128, 41 KB for SG25, copied by the producer
//   with cp.async.bulk into one of two shared buffers and completed on that
//   buffer's mbarrier. The next chunk's copy is in flight while the
//   consumers walk the current one.
// - A compacted, sorted live list, built by the producer warp one chunk
//   ahead: the staged rows that are live (inside their run's [lo, hi))
//   with sigma > 0, compacted by ballot, sorted by (key, row) with key =
//   0.5 (lo + hi) . mdir as one u64 per row in registers (a shuffle
//   bitonic, up to 8 keys per lane), each row's box and sigma written as
//   two float4. The walk reads two vector loads per row and never meets a
//   dead row. (key, row) is exactly the strict total order `before = key_i
//   < key_j | (key_i == key_j & i < j)` of the TPU kernels (keys compared
//   as f32: -0 is taken as +0).
// - Hand-offs: in the forward, named barriers per buffer (READY: the list
//   is built; DONE: the consumers are done with it), the saturation test
//   one OR of each warp's group bits before READY; in the backward, whose
//   warps never need each other's state, mbarriers (FULL, EMPTY), so a
//   consumer warp can run a chunk ahead of the slowest one.
// - The forward's colour heads of the published configurations (n_channels
//   3 with basis_dim 1, 4, 9, 16 or 25: RGBA, SH degrees 0-4, SG25; at the
//   index's quantum of 128) each have their own instantiation, which holds
//   each ray's basis in registers: a colour term is one broadcast shared
//   load of the row's coefficient (at an offset fixed at compile time) and
//   one FMA. Any other shape runs the generic instantiation, which keeps the
//   basis in shared memory and reads basis_dim at run time.
// Occupancy: the forward keeps two blocks of 288 threads per SM: two
//   staging buffers and two live lists are 64.6 KB a block for SH16 and
//   92.3 KB for SG25 (the generic instantiation adds the basis, bd x 1 KB);
//   the backward one (its basis, two chunk gradients and the per-warp
//   cotangent tiles besides: 166 KB for SH16, 231 KB of the 227 KiB a block
//   may take for SG25).
//
// Numerics: f32 throughout (the TPU's use_bf16 operand rounding is not
// reproduced). Built with --fmad=false, so nothing is contracted behind the
// source's back: the forward's slab test is an explicit fmaf (box*invd -
// o*invd with one rounding, as XLA computes it), everything else rounds as
// written, like the plain PyTorch version, but for the register-basis
// instantiations' colour sums, one fmaf a term (one rounding where the
// generic sum rounds twice). The forward's sums (optical depth in front,
// colour, opacity) are taken sequentially in front-to-back order rather
// than by a matmul: results agree with the plain version to f32
// summation-order rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 7;  // rgb(nc) + transmittance fit in 8 outputs
constexpr int kThreads = 256;    // threads per block (rays of a tile or of a quad group)
constexpr int kMaxRows = 256;    // runrows: up to 8 sort keys per lane
constexpr int kSlots = 8;        // backward: live rows per tensor-core slice (mma N)
// The forward's register-basis instantiations: their channels and quantum.
constexpr int kRegChannels = 3;
constexpr int kRegQShift = 7;
constexpr int kRegQuantum = 1 << kRegQShift;

// Both kernels' view of a launch: per-tile inputs in the JAX p2_args layout.
struct Tiles {
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
  int rays, ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum;
  int sub;                // blocks per tile: 1, or 4 (one per quad group)
  int qshift;             // log2(quantum)
  int srows;              // rows staged per piece: sigma_row + 1 (the rest is padding)
};

struct Params {
  Tiles t;
  float* out;  // [T, rays, 8]
  float step_eps, stop_thresh, od_cap;
  int sigmoid;  // 1: SH/SG (sigmoid of the decode), 0: RGBA (raw)
};

struct BwdParams {
  Tiles t;
  const float* out;  // [T, rays, 8]: the forward's output (rgb(nc), transmittance)
  const float* g;    // [T, rays, 8]: its cotangent
  float* gsoa;       // [n_blk, fields, quantum]: zero on entry, gradients added
  float step_eps;
  int sigmoid;
};

__device__ unsigned long long g_bwd_counts[2];  // float4 atomics, non-zero floats they carry

// ---- Hopper primitives: mbarriers, bulk copies, tensor-core mma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait for the phase of the given parity to complete. A wait that has not
// ended after ~10 s of clock traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(a), "r"(parity)
      : "memory");
  if (ok) return;
  const long long t0 = clock64();
  while (!ok) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
    if (!ok && clock64() - t0 > 20000000000LL) __trap();
  }
}
// Bulk copy global -> shared, completing `bytes` of the barrier's transaction.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// d += a . b on one m16n8k8 TF32 tensor-core tile (f32 accumulation).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- Shared staging, the live list and the producer warp (both kernels) ----

// The forward's named barriers (0 is __syncthreads): READY + b, the
// producer has built the live list in buffer b; DONE + b, the consumers
// have walked buffer b.
constexpr int kReady = 1, kDone = 3;

__device__ __forceinline__ void nbar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void nbar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One block's shared state for the chunk pipeline; buffer b of a pair is
// at base + b * stride.
struct Stage {
  float* buf;          // [2][G][srows][quantum]: the staged pieces
  size_t buf_stride;   // floats per staging buffer
  int* piece;          // [2][4][G]: c0, lo, hi, mask of each staged chunk
  uint64_t* bar;       // [2]: one mbarrier per staging buffer
  float4* live;        // [2][2 * runrows]: (lo box, sigma), (hi box, row) per live row
  int* list;           // [2][2]: live rows and chunk mask of each list
  int* ring;           // [3]: per-chunk flags (k % 3): saturation bits, or any hit
  int* stop;           // the chunk at which the consumers stopped (forward), else INT_MAX
  int* blk;            // [4][G]: soa block of each piece of chunk k (k % 4)
};

// Producer lane 0: stage chunk `chunk` of the tile into buffer `b`: its piece
// descriptors (zero past n_pieces: no live rows), and one bulk copy per
// piece of its contiguous soa block.
__device__ __forceinline__ void issue_chunk(const Tiles& t, const Stage& s, int b, int chunk,
                                            size_t tile, int n_pieces, int G) {
  const size_t base = tile * t.ccap;
  const uint32_t bytes = (uint32_t)t.srows * t.quantum * 4;
  int* pc = s.piece + b * 4 * G;
  float* buf = s.buf + b * s.buf_stride;
  int valid = 0;
  for (int g = 0; g < G; ++g) valid += chunk * G + g < n_pieces;
  mbar_expect_tx(&s.bar[b], bytes * valid);
  for (int g = 0; g < G; ++g) {
    const int pi = chunk * G + g;
    const bool ok = pi < n_pieces;
    const int c0 = ok ? t.piece_c0[base + pi] : 0;
    pc[g] = c0;
    pc[G + g] = ok ? t.piece_lo[base + pi] : 0;
    pc[2 * G + g] = ok ? t.piece_hi[base + pi] : 0;
    pc[3 * G + g] = ok ? t.piece_mask[base + pi] : 0;
    if (ok) {
      const size_t blk = (size_t)(c0 >> t.qshift);
      bulk_g2s(buf + (size_t)g * t.srows * t.quantum, t.soa + blk * t.fields * t.quantum, bytes,
               &s.bar[b]);
    }
  }
}

// f32 key -> u32 in the same order (-0 taken as +0, as f32 compares it).
__device__ __forceinline__ uint32_t sortable(float key) {
  const uint32_t u = __float_as_uint(key + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One warp: sort n <= 32 * KPL u64 values ascending with a bitonic network,
// element e = lane * KPL + j in v[j] (strides below KPL compare within a
// lane's registers, the others across lanes by shuffle), then write the
// live list over the scratch the values came from.
template <int KPL>
__device__ __forceinline__ void sort_and_write(const Tiles& t, const float* buf, int n,
                                               float4* live) {
  const int lane = threadIdx.x & 31;
  const unsigned long long* scratch = reinterpret_cast<const unsigned long long*>(live);
  unsigned long long v[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int e = lane * KPL + j;
    v[j] = e < n ? scratch[e] : ~0ull;
  }
  __syncwarp();  // every value loaded before the list overwrites the scratch
  constexpr int N = 32 * KPL;
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1) {
      if (s < KPL) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          if ((j & s) == 0) {
            const bool asc = (((lane * KPL + j) & k) == 0);
            const unsigned long long a = v[j], b = v[j | s];
            const bool swap = (a > b) == asc;
            v[j] = swap ? b : a;
            v[j | s] = swap ? a : b;
          }
        }
      } else {
        const int ls = s / KPL;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, v[j], ls);
          const bool keep_min = ((lane & ls) == 0) == (((lane * KPL + j) & k) == 0);
          v[j] = keep_min ? (o < v[j] ? o : v[j]) : (o > v[j] ? o : v[j]);
        }
      }
    }
  }
  const int q = t.quantum;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int e = lane * KPL + j;
    if (e < n) {
      const int r = (int)(v[j] & 0xffffffffu);
      const float* row = buf + (size_t)(r >> t.qshift) * t.srows * q + (r & (q - 1));
      live[2 * e] = make_float4(row[0], row[q], row[2 * q], row[t.sigma_row * q]);
      live[2 * e + 1] = make_float4(row[3 * q], row[4 * q], row[5 * q], __int_as_float(r));
    }
  }
}

// The producer warp: the staged chunk in buffer b -> its live rows (inside
// their run, sigma > 0) in (key, row) order into list b, with their count
// and the chunk's quad-group mask.
__device__ __forceinline__ void build_live(const Tiles& t, const Stage& s, int b, float m0,
                                           float m1, float m2) {
  const int lane = threadIdx.x & 31;
  const int R = t.runrows, q = t.quantum, G = R / q;
  const float* buf = s.buf + b * s.buf_stride;
  const int* pc = s.piece + b * 4 * G;
  float4* live = s.live + b * 2 * R;
  unsigned long long* scratch = reinterpret_cast<unsigned long long*>(live);
  int n = 0;
  for (int i = 0; i < R; i += 32) {
    const int r = i + lane;
    bool ok = false;
    unsigned long long kv = 0;
    if (r < R) {
      const int g = r >> t.qshift, l = r & (q - 1);
      const float* row = buf + (size_t)g * t.srows * q + l;
      const int rowid = pc[g] + l;
      ok = rowid >= pc[G + g] && rowid < pc[2 * G + g] && row[t.sigma_row * q] > 0.f;
      if (ok) {
        const float key = 0.5f * ((row[0] + row[3 * q]) * m0 + (row[q] + row[4 * q]) * m1 +
                                  (row[2 * q] + row[5 * q]) * m2);
        kv = ((unsigned long long)sortable(key) << 32) | (unsigned)r;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (ok) scratch[n + __popc(bal & ((1u << lane) - 1))] = kv;
    n += __popc(bal);
  }
  __syncwarp();
  if (n <= 32) sort_and_write<1>(t, buf, n, live);
  else if (n <= 64) sort_and_write<2>(t, buf, n, live);
  else if (n <= 128) sort_and_write<4>(t, buf, n, live);
  else sort_and_write<8>(t, buf, n, live);
  if (lane == 0) {
    int cmask = 0;
    for (int g = 0; g < G; ++g) cmask |= pc[3 * G + g];
    s.list[2 * b] = n;
    s.list[2 * b + 1] = cmask;
  }
}

// The forward's producer warp, one chunk ahead of the consumers: stage
// chunk k into buffer k & 1 once the consumers are done with chunk k - 2,
// wait for its copy, build its live list, hand it over (READY). The
// consumers (forward) may stop at a chunk: they record it before their DONE
// of that chunk and take the next chunk's READY, so every barrier phase
// that one side opens the other completes.
__device__ void produce(const Tiles& t, const Stage& s, size_t tile, int n_pieces, int n_chunks,
                        float m0, float m1, float m2, int nb) {
  const int lane = threadIdx.x & 31;
  const int G = t.runrows / t.quantum;
  if (lane == 0) {
    for (int c = 0; c < 2 && c < n_chunks; ++c) issue_chunk(t, s, c, c, tile, n_pieces, G);
  }
  __syncwarp();
  for (int k = 0; k < n_chunks; ++k) {
    const int b = k & 1;
    if (k >= 2) {
      nbar_sync(kDone + b, nb);
      if (*(volatile int*)s.stop <= k - 2) return;
      if (lane == 0) issue_chunk(t, s, b, k, tile, n_pieces, G);
      __syncwarp();
    }
    mbar_wait(&s.bar[b], (k >> 1) & 1);
    build_live(t, s, b, m0, m1, m2);
    const int* pc = s.piece + b * 4 * G;
    for (int g = lane; g < G; g += 32) s.blk[(k & 3) * G + g] = pc[g] >> t.qshift;
    __syncwarp();
    nbar_arrive(kReady + b, nb);
  }
  for (int j = n_chunks > 2 ? n_chunks - 2 : 0; j < n_chunks; ++j) {
    if (*(volatile int*)s.stop <= j - 1) return;
    nbar_sync(kDone + (j & 1), nb);
  }
}

// The backward's producer warp. Its consumer warps do not wait for each
// other: each takes list k when FULL[b] completes and arrives on EMPTY[b]
// when it has walked chunk k and added its slices into chunk gradient b
// (one per chunk in flight: a warp can be one chunk ahead of the slowest).
// Once every consumer has arrived, the producer stages chunk k + 2 into
// the freed buffer and, while that copy flies, adds chunk k's gradient
// into the soa (float4 atomics for non-zero quads) and clears it.
__device__ void produce_bwd(const Tiles& t, const Stage& s, uint64_t* full, uint64_t* empty,
                            float* s_gacc, size_t gacc_stride, float* gsoa, size_t tile,
                            int n_pieces, int n_chunks, float m0, float m1, float m2) {
  const int lane = threadIdx.x & 31;
  const int G = t.runrows / t.quantum;
  const int q = t.quantum, q4 = q / 4, SR = t.runrows + 4;
  const int nvals = t.n_channels * t.basis_dim + 1;
  const int per_piece = nvals * q4;
  unsigned n_quads = 0, n_nonzero = 0;
  auto flush = [&](int j) {
    const int b = j & 1;
    mbar_wait(&empty[b], (j >> 1) & 1);
    if (j + 2 < n_chunks) {
      if (lane == 0) issue_chunk(t, s, b, j + 2, tile, n_pieces, G);
      __syncwarp();
    }
    if (!s.ring[b]) return;  // no warp hit a row of chunk j
    float* gacc = s_gacc + b * gacc_stride;
    const int* blk = s.blk + (j & 3) * G;
    for (int i = lane; i < G * per_piece; i += 32) {
      const int g = i / per_piece;
      const int rem = i - g * per_piece;
      const int row = rem / q4;
      const int l4 = rem - row * q4;
      float4* src = reinterpret_cast<float4*>(gacc + row * SR + g * q + 4 * l4);
      const float4 v = *src;
      const int nz = (v.x != 0.f) + (v.y != 0.f) + (v.z != 0.f) + (v.w != 0.f);
      if (nz && j * G + g < n_pieces) {
        atomicAdd(reinterpret_cast<float4*>(gsoa + (((size_t)blk[g] * t.fields + 6 + row) * q + 4 * l4)), v);
        ++n_quads;
        n_nonzero += nz;
      }
      if (nz) *src = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    if (lane == 0) s.ring[b] = 0;
  };
  if (lane == 0) {
    for (int c = 0; c < 2 && c < n_chunks; ++c) issue_chunk(t, s, c, c, tile, n_pieces, G);
  }
  __syncwarp();
  for (int k = 0; k < n_chunks; ++k) {
    const int b = k & 1;
    if (k >= 2) flush(k - 2);
    mbar_wait(&s.bar[b], (k >> 1) & 1);
    build_live(t, s, b, m0, m1, m2);
    const int* pc = s.piece + b * 4 * G;
    for (int g = lane; g < G; g += 32) s.blk[(k & 3) * G + g] = pc[g] >> t.qshift;
    __syncwarp();
    mbar_arrive(&full[b]);
  }
  for (int j = n_chunks > 2 ? n_chunks - 2 : 0; j < n_chunks; ++j) flush(j);
  n_quads = __reduce_add_sync(0xffffffffu, n_quads);
  n_nonzero = __reduce_add_sync(0xffffffffu, n_nonzero);
  if (lane == 0 && n_quads) {
    atomicAdd(&g_bwd_counts[0], (unsigned long long)n_quads);
    atomicAdd(&g_bwd_counts[1], (unsigned long long)n_nonzero);
  }
}

// Carves the pipeline's shared memory; `off` returns the first free byte.
__device__ __forceinline__ Stage carve_stage(unsigned char* smem, const Tiles& t, size_t& off) {
  Stage s;
  const int G = t.runrows / t.quantum;
  s.buf_stride = (size_t)t.srows * t.runrows;
  s.buf = reinterpret_cast<float*>(smem);
  off = 2 * s.buf_stride * 4;
  s.live = reinterpret_cast<float4*>(smem + off);
  off += (size_t)2 * t.runrows * 32;
  s.bar = reinterpret_cast<uint64_t*>(smem + off);
  off += 16;
  s.piece = reinterpret_cast<int*>(smem + off);
  off += (size_t)8 * G * 4;
  s.blk = reinterpret_cast<int*>(smem + off);
  off += (size_t)4 * G * 4;
  s.list = reinterpret_cast<int*>(smem + off);
  s.ring = s.list + 4;
  s.stop = s.ring + 3;
  off += 8 * 4;
  off = (off + 15) & ~(size_t)15;
  return s;
}

__host__ __device__ inline size_t stage_bytes(int rows, int runrows, int quantum) {
  const size_t G = runrows / quantum;
  return (((size_t)2 * rows * runrows * 4 + (size_t)2 * runrows * 32 + 16 + 48 * G + 32) + 15) &
         ~(size_t)15;
}

// Per-thread ray of a block: block b is quad group (b % sub) of tile b / sub;
// threads past the tile's rays (and the producer warp) are inactive.
struct Ray {
  size_t tile, ray;  // tile index, global ray index
  int grp;           // quad group 0..3
  bool active;
};
__device__ __forceinline__ Ray ray_of(const Tiles& t) {
  Ray r;
  r.tile = blockIdx.x / t.sub;
  const int per = t.rays / t.sub;
  const int rt = (int)(blockIdx.x % t.sub) * per + (int)threadIdx.x;  // ray within the tile
  r.active = (int)threadIdx.x < per;
  r.ray = r.tile * t.rays + (r.active ? rt : 0);
  r.grp = r.active ? rt / (t.rays / 4) : 0;
  return r;
}

// Setup shared by both kernels, by every thread: the mbarriers (one
// thread), the per-chunk flags, then a block barrier.
__device__ __forceinline__ void init_stage(const Stage& s) {
  if (threadIdx.x == 0) {
    mbar_init(&s.bar[0], 1);
    mbar_init(&s.bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s.ring[0] = s.ring[1] = s.ring[2] = 0;
    *s.stop = 0x7fffffff;
  }
}

// ---- The forward ----

// One instantiation per colour head for every tile size: the consumer warps
// (a tile's or a quad group's rays, up to 256) and the producer warp; two
// blocks per SM (see the occupancy note at the top). BD > 0: basis_dim BD,
// NC channels and quantum kRegQuantum, each consumer's basis in registers;
// BD 0: the generic kernel, the shape read at run time and the basis in
// shared memory.
template <int BD, int NC>
__global__ void __launch_bounds__(kThreads + 32, 2) tile_composite_kernel(const __grid_constant__ Params p) {
  constexpr bool kReg = BD > 0;
  constexpr int kAcc = kReg ? NC : kMaxChannels;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles& t = p.t;
  const int tid = threadIdx.x;
  const int nb = blockDim.x;       // consumers and the producer warp
  const int ncons = nb - 32;       // consumer threads
  const int bd = kReg ? BD : t.basis_dim;
  const int nc = kReg ? NC : t.n_channels;
  const int q = kReg ? kRegQuantum : t.quantum;
  const int qshift = kReg ? kRegQShift : t.qshift;
  const int srows = kReg ? 7 + NC * BD : t.srows;
  const int G = t.runrows / q;
  size_t off;
  const Stage s = carve_stage(smem, t, off);
  float* s_basis = reinterpret_cast<float*>(smem + off);  // generic: [bd, ncons]

  const Ray ry = ray_of(t);
  const int n_pieces = t.meta[ry.tile * 4];
  const int n_chunks = (n_pieces + G - 1) / G;
  const float m0 = t.mdir[ry.tile * 4 + 0];
  const float m1 = t.mdir[ry.tile * 4 + 1];
  const float m2 = t.mdir[ry.tile * 4 + 2];
  init_stage(s);
  if (!kReg && tid < ncons) {
    for (int k = 0; k < bd; ++k) s_basis[k * ncons + tid] = ry.active ? t.basis[ry.ray * bd + k] : 0.f;
  }
  __syncthreads();
  if (tid >= ncons) {
    produce(t, s, ry.tile, n_pieces, n_chunks, m0, m1, m2, nb);
    return;
  }

  float basis[kReg ? BD : 1];  // the ray's basis (register-basis instantiations)
#pragma unroll
  for (int k = 0; k < (kReg ? BD : 0); ++k) basis[k] = ry.active ? t.basis[ry.ray * BD + k] : 0.f;
  float ivx = 0.f, ivy = 0.f, ivz = 0.f, oix = 0.f, oiy = 0.f, oiz = 0.f;
  float dscale = 0.f, tmin = 0.f, tmax = 0.f;
  if (ry.active) {
    ivx = t.invd[ry.ray * 4 + 0];
    ivy = t.invd[ry.ray * 4 + 1];
    ivz = t.invd[ry.ray * 4 + 2];
    oix = t.o[ry.ray * 4 + 0] * ivx;
    oiy = t.o[ry.ray * 4 + 1] * ivy;
    oiz = t.o[ry.ray * 4 + 2] * ivz;
    dscale = t.aux[ry.ray * 4 + 0];
    tmin = t.aux[ry.ray * 4 + 1];
    tmax = t.aux[ry.ray * 4 + 2];
  }

  float cum = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int b = chunk & 1;
    // Per-group saturation (a group whose every ray is past od_cap can gain
    // nothing more): each warp ORs its rays' group bits once, before READY.
    const unsigned bits =
        __reduce_or_sync(0xffffffffu, (ry.active && cum <= p.od_cap) ? 1u << ry.grp : 0u);
    if ((tid & 31) == 0 && bits) atomicOr(&s.ring[chunk % 3], (int)bits);
    nbar_sync(kReady + b, nb);
    if (tid == 0) s.ring[(chunk + 2) % 3] = 0;  // read before this READY, next ORed after the next
    const int g_unsat = s.ring[chunk % 3];
    if (g_unsat == 0) {  // whole tile saturated: a uniform stop
      if (tid == 0) *s.stop = chunk;
      nbar_arrive(kDone + b, nb);
      if (chunk + 1 < n_chunks) nbar_sync(kReady + (b ^ 1), nb);
      break;
    }
    const int n_live = s.list[2 * b];
    if (((s.list[2 * b + 1] >> ry.grp) & 1) && ((g_unsat >> ry.grp) & 1) && ry.active) {
      mbar_wait(&s.bar[b], (chunk >> 1) & 1);  // the copy's data, seen by this thread
      const float* buf = s.buf + b * s.buf_stride;
      const float4* live = s.live + b * 2 * t.runrows;
      float prefix = 0.f;  // optical depth of this chunk's hits in front
      float cum_add = 0.f;
      for (int i = 0; i < n_live; ++i) {
        const float4 lo = live[2 * i];
        const float4 hi = live[2 * i + 1];
        // Slab test in FMA form, t = box*invd - o*invd with one rounding,
        // as the TPU kernel (and XLA on the CPU) computes it.
        const float t1x = fmaf(lo.x, ivx, -oix);
        const float t2x = fmaf(hi.x, ivx, -oix);
        const float t1y = fmaf(lo.y, ivy, -oiy);
        const float t2y = fmaf(hi.y, ivy, -oiy);
        const float t1z = fmaf(lo.z, ivz, -oiz);
        const float t2z = fmaf(hi.z, ivz, -oiz);
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        const float entry = fmaxf(tn, tmin);
        if (!(tf > entry && entry <= tmax)) continue;
        const float sdt = lo.w * (tf - entry + p.step_eps) * dscale;
        if (sdt == 0.f) continue;
        const float light = expf(-(cum + prefix));
        if (light > p.stop_thresh) {
          const float contrib = light * (1.f - expf(-sdt));
          const int r = __float_as_int(hi.w);
          const float* coef0 = buf + (size_t)(r >> qshift) * srows * q + (r & (q - 1)) + 6 * q;
          if constexpr (kReg) {
            // Term k of every channel in turn (three independent chains),
            // each channel's terms in the order k = 0..BD-1.
            float raw[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) raw[c] = 0.f;
#pragma unroll
            for (int k = 0; k < BD; ++k) {
#pragma unroll
              for (int c = 0; c < NC; ++c) raw[c] = fmaf(basis[k], coef0[(c * BD + k) * kRegQuantum], raw[c]);
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const float rgb = p.sigmoid ? 0.5f * tanhf(0.5f * raw[c]) + 0.5f : raw[c];
              acc[c] += contrib * rgb;
            }
          } else {
#pragma unroll
            for (int c = 0; c < kMaxChannels; ++c) {
              if (c < nc) {
                const float* coef = coef0 + c * bd * q;
                float raw = 0.f;
                for (int k = 0; k < bd; ++k) raw += s_basis[k * ncons + tid] * coef[k * q];
                const float rgb = p.sigmoid ? 0.5f * tanhf(0.5f * raw) + 0.5f : raw;
                acc[c] += contrib * rgb;
              }
            }
          }
          cum_add += sdt;
        }
        prefix += sdt;
      }
      cum += cum_add;  // opacity freezes once a ray stops (alive-gated)
    }
    nbar_arrive(kDone + b, nb);  // buffer b and its list are free
  }

  if (ry.active) {
    float* out = p.out + ry.ray * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = 0.f;
      if (c < nc) v = acc[c < kAcc ? c : 0];
      if (c == nc) v = expf(-cum);
      out[c] = v;
    }
  }
}

// ---- The backward ----

// Backward of the exact-mode tile compositor (stop_thresh 0, no saturation
// exits) with respect to the soa: the port of plenoctree_tpu/octree/
// tile_opt.py::_tile_bwd_kernel.
//
// The forward replayed in its chunk order and (key, row) precedence, one
// thread per ray, over the same live list. No reverse walk and no stored
// per-hit state: for hit i of a ray,
//   dL/dsdt_i = gsum_i * light_i * exp(-sdt_i) - suffix_i,
//   suffix_i  = T_all - prefix_i - e_i,   e_i = gsum_i * contrib_i,
// where gsum = sum_c g_c rgb_c, T_all = sum_{c <= nc} g_c out_c comes from
// the forward output, and prefix_i (the sum of e over the hits in front of i)
// runs in the sorted walk. Row gradients: sigma gets sum_rays dL/dsdt * dtv
// (only rows with sigma > 0 are live, so the ReLU gate holds); colour
// coefficient (c, k) gets sum_rays basis_k * g_c * contrib * rgb_c(1-rgb_c)
// for SH/SG, basis_k * g_c * contrib for RGBA; geometry rows get none. A
// quad group whose chunk-mask bit is clear is skipped, as on the TPU.
//
// The reduction over rays, as products (the TPU's basis^T . draw): each
// warp keeps a tile D[nc + 1][8 slots][32 rays] in shared memory. A live row
// that some lane of the warp hits takes the next slot: every lane writes its
// per-channel cotangent g_c contrib rgb(1-rgb) (or g_c contrib) and its
// dL/dsdt dtv, zero where it missed. Eight rows fill a slice, which goes
// through the tensor cores: per channel basis_warp^T [bd x 32] . D_c
// [32 x 8] as m16n8k8 TF32 mma (bd padded to 16 or 32), sigma as a ones
// row times D_sigma. Each operand is split x = hi + lo into two TF32 values
// and the product taken as hi.hi + hi.lo + lo.hi with f32 accumulation
// (3xTF32), which keeps f32 accuracy where plain TF32 keeps ~3 digits; the
// basis operand's split stays in registers for the whole tile. A slice's
// [bd, 8] partials go into the chunk's shared [nvals, runrows] gradient
// with shared-memory atomics (every warp adds to the same rows); there is
// one such gradient per chunk in flight.
//
// Accumulation across tiles: the TPU adds each chunk into the gradient soa
// by read-modify-write, race-free only because its grid runs in order. Here
// tiles run at once and share soa rows, so once every warp is done with a
// chunk the producer warp adds its gradient to device memory as float4
// atomics (4 consecutive rows of a field), for non-zero quads only. The
// order of those atomics changes from run to run, so two runs agree to f32
// summation-order rounding, not bit for bit.
//
// Numerics: the slab test is the TPU backward's own `(box - o) * invd`, a
// subtract and a multiply (the forward's is the FMA form); with --fmad=false
// nothing is contracted, so the hit decisions equal the JAX backward's and
// the plain version's on the same inputs. sdt = sigma * dtv with
// dtv = (tf - entry + eps) * dscale, in the TPU backward's order.
//
// What bounds it on an H100: the per-(ray, live row) replay of the forward
// (slab test, colour decode of every hit) by the busiest warps; the
// reduction is ~44 mma per 8 hit rows per warp, and the soa reads are the
// forward's.
template <int MT>  // m16 tiles of the basis: bd <= 16 * MT
__global__ void __launch_bounds__(kThreads + 32, 1) tile_composite_bwd_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tiles& t = p.t;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = blockDim.x;  // consumers and the producer warp
  const int ncons = nb - 32;  // consumer threads
  const int bd = t.basis_dim;
  const int nc = t.n_channels;
  const int ncb = nc * bd;
  const int nvals = ncb + 1;  // colour coefficients, then sigma
  const int R = t.runrows;
  const int SR = R + 4;  // row stride of the chunk gradient (spreads the mma partials' banks)
  const int G = R / t.quantum;
  size_t off;
  const Stage s = carve_stage(smem, t, off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + off);  // [2]: list b built
  uint64_t* empty = full + 2;                                // [2]: chunk in b walked
  off += 32;
  float* s_basis = reinterpret_cast<float*>(smem + off);  // [bd, ncons]
  off += (size_t)bd * ncons * 4;
  const size_t gacc_stride = (size_t)nvals * SR;
  float* s_gacc = reinterpret_cast<float*>(smem + off);  // [2][nvals, SR]: one per chunk in flight
  off += 2 * gacc_stride * 4;
  float* s_d = reinterpret_cast<float*>(smem + off) + (size_t)warp * (nc + 1) * kSlots * 32;
  off += (size_t)(ncons / 32) * (nc + 1) * kSlots * 32 * 4;
  int* s_slot = reinterpret_cast<int*>(smem + off) + warp * kSlots;  // live row of each slot

  const Ray ry = ray_of(t);
  const int n_pieces = t.meta[ry.tile * 4];
  const int n_chunks = (n_pieces + G - 1) / G;
  init_stage(s);
  if (tid == 0) {
    mbar_init(&full[0], 32);
    mbar_init(&full[1], 32);
    mbar_init(&empty[0], ncons);
    mbar_init(&empty[1], ncons);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * nvals * SR; i += nb) s_gacc[i] = 0.f;
  if (tid < ncons) {
    for (int k = 0; k < bd; ++k) s_basis[k * ncons + tid] = ry.active ? t.basis[ry.ray * bd + k] : 0.f;
  }
  __syncthreads();
  if (tid >= ncons) {
    produce_bwd(t, s, full, empty, s_gacc, gacc_stride, p.gsoa, ry.tile, n_pieces, n_chunks,
                t.mdir[ry.tile * 4 + 0], t.mdir[ry.tile * 4 + 1], t.mdir[ry.tile * 4 + 2]);
    return;
  }

  // The mma A operand, basis_warp^T [16 MT x 32 rays], split into TF32
  // hi + lo, for the whole tile: a[mt][kb] holds rows (k) lane/4 and
  // lane/4 + 8 of m-tile mt, columns (rays) 8 kb + lane%4 and + 4.
  uint32_t a_hi[MT][4][4], a_lo[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = mt * 16 + (lane >> 2) + 8 * (i & 1);
        const int ray = warp * 32 + kb * 8 + (lane & 3) + 4 * (i >> 1);
        const float x = k < bd ? s_basis[k * ncons + ray] : 0.f;
        a_hi[mt][kb][i] = to_tf32(x);
        a_lo[mt][kb][i] = to_tf32(x - __uint_as_float(a_hi[mt][kb][i]));
      }
    }
  }
  // sigma's A operand: a ones row (row 0), exact in TF32.
  const uint32_t one = (lane >> 2) == 0 ? __float_as_uint(1.f) : 0u;
  const uint32_t a_one[4] = {one, 0u, one, 0u};

  float ox = 0.f, oy = 0.f, oz = 0.f, ivx = 0.f, ivy = 0.f, ivz = 0.f;
  float dscale = 0.f, tmin = 0.f, tmax = 0.f;
  float gc[kMaxChannels];
  float t_all = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) gc[c] = 0.f;
  if (ry.active) {
    ox = t.o[ry.ray * 4 + 0];
    oy = t.o[ry.ray * 4 + 1];
    oz = t.o[ry.ray * 4 + 2];
    ivx = t.invd[ry.ray * 4 + 0];
    ivy = t.invd[ry.ray * 4 + 1];
    ivz = t.invd[ry.ray * 4 + 2];
    dscale = t.aux[ry.ray * 4 + 0];
    tmin = t.aux[ry.ray * 4 + 1];
    tmax = t.aux[ry.ray * 4 + 2];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      gc[c] = c < nc ? p.g[ry.ray * 8 + c] : 0.f;
      if (c < nc) t_all += gc[c] * p.out[ry.ray * 8 + c];
    }
    t_all += p.g[ry.ray * 8 + nc] * p.out[ry.ray * 8 + nc];
  }

  float* gacc = s_gacc;  // the current chunk's gradient

  // The warp's filled slots [0, ns) through the tensor cores into gacc.
  auto slice = [&](int ns) {
    __syncwarp();
    const int n = lane >> 2;  // slot of b0/b1
#pragma unroll 1
    for (int c = 0; c <= nc; ++c) {  // colour channels, then sigma
      const float* dc = s_d + c * kSlots * 32 + n * 32;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (c == nc && mt > 0) break;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          const int i0 = kb * 8 + (lane & 3);
          const float x0 = n < ns ? dc[i0 ^ (n << 2)] : 0.f;
          const float x1 = n < ns ? dc[(i0 + 4) ^ (n << 2)] : 0.f;
          const uint32_t h0 = to_tf32(x0), h1 = to_tf32(x1);
          const uint32_t l0 = to_tf32(x0 - __uint_as_float(h0));
          const uint32_t l1 = to_tf32(x1 - __uint_as_float(h1));
          if (c < nc) {
            mma_tf32(d, a_lo[mt][kb], h0, h1);
            mma_tf32(d, a_hi[mt][kb], l0, l1);
            mma_tf32(d, a_hi[mt][kb], h0, h1);
          } else {
            mma_tf32(d, a_one, l0, l1);
            mma_tf32(d, a_one, h0, h1);
          }
        }
        // d[i]: row (k) lane/4 + 8 (i >> 1), column (slot) 2 (lane%4) + (i & 1).
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = mt * 16 + (lane >> 2) + 8 * (i >> 1);
          const int col = 2 * (lane & 3) + (i & 1);
          const bool row_ok = c < nc ? k < bd : k == 0;
          if (row_ok && col < ns && d[i] != 0.f) {
            const int j = c < nc ? c * bd + k : ncb;
            atomicAdd(&gacc[j * SR + s_slot[col]], d[i]);
          }
        }
      }
    }
    __syncwarp();
  };

  float cum = 0.f;   // optical depth of the earlier chunks
  float pref = 0.f;  // sum of e over the earlier chunks
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int b = chunk & 1;
    mbar_wait(&full[b], (chunk >> 1) & 1);
    gacc = s_gacc + b * gacc_stride;
    const int n_live = s.list[2 * b];
    const bool on = ((s.list[2 * b + 1] >> ry.grp) & 1) && ry.active;
    const float* buf = s.buf + b * s.buf_stride;
    const float4* live = s.live + b * 2 * R;
    const int q = t.quantum;
    mbar_wait(&s.bar[b], (chunk >> 1) & 1);  // the copy's data, seen by this thread
    float pre_sdt = 0.f;  // this chunk's optical depth in front
    float pre_e = 0.f;    // this chunk's e in front
    int ns = 0;           // filled slots of the warp's tile
    bool any = false;
    for (int i = 0; i < n_live; ++i) {
      const float4 lo = live[2 * i];
      const float4 hi = live[2 * i + 1];
      bool hit = false;
      float vsig = 0.f;
      float draw[kMaxChannels];
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) draw[c] = 0.f;
      float tf = 0.f, entry = 0.f;
      if (on) {
        // (box - o) * invd: a subtract, then a multiply (see above).
        const float t1x = (lo.x - ox) * ivx;
        const float t2x = (hi.x - ox) * ivx;
        const float t1y = (lo.y - oy) * ivy;
        const float t2y = (hi.y - oy) * ivy;
        const float t1z = (lo.z - oz) * ivz;
        const float t2z = (hi.z - oz) * ivz;
        const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        entry = fmaxf(tn, tmin);
        hit = tf > entry && entry <= tmax;
      }
      if (!__any_sync(0xffffffffu, hit)) continue;  // no lane of this warp hits this row
      if (hit) {
        const float dtv = (tf - entry + p.step_eps) * dscale;
        const float sdt = lo.w * dtv;
        const float light = expf(-(cum + pre_sdt));
        const float esdt = expf(-sdt);
        const float contrib = light * (1.f - esdt);
        const int r = __float_as_int(hi.w);
        const float* coef0 = buf + (size_t)(r >> t.qshift) * t.srows * q + (r & (q - 1)) + 6 * q;
        float gsum = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) {
          if (c < nc) {
            const float* coef = coef0 + c * bd * q;
            float raw = 0.f;
            for (int k = 0; k < bd; ++k) raw += s_basis[k * ncons + tid] * coef[k * q];
            const float rgb = p.sigmoid ? 0.5f * tanhf(0.5f * raw) + 0.5f : raw;
            gsum += gc[c] * rgb;
            draw[c] = p.sigmoid ? gc[c] * contrib * rgb * (1.f - rgb) : gc[c] * contrib;
          }
        }
        const float e = gsum * contrib;
        const float suffix = t_all - (pref + pre_e) - e;
        const float dsdt = gsum * light * esdt - suffix;
        vsig = dsdt * dtv;
        pre_sdt += sdt;
        pre_e += e;
      }
      // Row i takes slot ns of the warp's tile (swizzled: conflict-free
      // writes here and fragment reads in slice()).
      float* dst = s_d + ns * 32 + (lane ^ (ns << 2));
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        if (c < nc) dst[c * kSlots * 32] = draw[c];
      dst[nc * kSlots * 32] = vsig;
      if (lane == 0) s_slot[ns] = __float_as_int(hi.w);
      any = true;
      if (++ns == kSlots) {
        slice(kSlots);
        ns = 0;
      }
    }
    if (ns > 0) slice(ns);
    if (any && lane == 0) s.ring[b] = 1;
    if (on) {
      cum += pre_sdt;
      pref += pre_e;
    }
    __syncwarp();
    mbar_arrive(&empty[b]);  // this thread is done with buffer b, list b and gradient b
  }
}

// Launches a kernel: `sub` blocks of `threads` threads per tile, with its
// dynamic shared memory opted in above the 48 KB default.
template <typename Kernel, typename P>
int launch(Kernel kernel, const P& p, int n_tiles, int sub, int threads, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles * sub, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Blocks per tile and threads per block for `rays` rays per tile: the
// consumer warps, then the producer warp.
void geometry(int rays, int* sub, int* threads) {
  *sub = rays > kThreads ? 4 : 1;
  *threads = ((rays / *sub + 31) / 32) * 32 + 32;
}

bool tiles_ok(int rays, int runrows, int quantum, int fields) {
  return rays % 32 == 0 && rays <= 4 * kThreads && runrows <= kMaxRows && quantum >= 4 &&
         (quantum & (quantum - 1)) == 0 && runrows % quantum == 0 && fields >= 6;
}

using FwdKernel = decltype(&tile_composite_kernel<0, 0>);

// The forward's instantiation for a colour head: its own for the published
// shapes (register basis), else the generic one.
FwdKernel fwd_kernel(int basis_dim, int n_channels, int quantum) {
  if (n_channels == kRegChannels && quantum == kRegQuantum) {
    switch (basis_dim) {
      case 1: return tile_composite_kernel<1, kRegChannels>;
      case 4: return tile_composite_kernel<4, kRegChannels>;
      case 9: return tile_composite_kernel<9, kRegChannels>;
      case 16: return tile_composite_kernel<16, kRegChannels>;
      case 25: return tile_composite_kernel<25, kRegChannels>;
    }
  }
  return tile_composite_kernel<0, 0>;
}

bool reg_basis(int basis_dim, int n_channels, int quantum) {
  return fwd_kernel(basis_dim, n_channels, quantum) != tile_composite_kernel<0, 0>;
}

size_t fwd_smem_bytes(int rays, int basis_dim, int n_channels, int rows, int runrows, int quantum) {
  int sub, threads;
  geometry(rays, &sub, &threads);
  const size_t basis = reg_basis(basis_dim, n_channels, quantum) ? 0 : (size_t)basis_dim * (threads - 32);
  return stage_bytes(rows, runrows, quantum) + sizeof(float) * basis;
}

}  // namespace

extern "C" {

// Shared memory of a forward block; `rows` is the rows staged per piece,
// sigma_row + 1 = 7 + n_channels * basis_dim.
size_t pn_tile_composite_smem_bytes(int rays, int basis_dim, int rows, int runrows, int quantum) {
  const int n_channels = basis_dim > 0 ? (rows - 7) / basis_dim : 0;
  return fwd_smem_bytes(rays, basis_dim, n_channels, rows, runrows, quantum);
}

// 1 where the forward for this colour head holds each ray's basis in
// registers, 0 where it runs the generic instantiation.
int pn_tile_composite_reg_basis(int basis_dim, int n_channels, int quantum) {
  return reg_basis(basis_dim, n_channels, quantum);
}

// The forward's instantiation for these shapes as a launch would take it:
// out5 = {blocks per SM at its shared memory, registers a thread, local
// memory a thread (spills), shared memory a block, 1 if it holds the basis
// in registers}.
int pn_tile_composite_occupancy(int rays, int basis_dim, int n_channels, int runrows, int quantum,
                                int* out5) {
  int sub, threads;
  geometry(rays, &sub, &threads);
  const FwdKernel kernel = fwd_kernel(basis_dim, n_channels, quantum);
  const size_t smem = fwd_smem_bytes(rays, basis_dim, n_channels, 7 + n_channels * basis_dim,
                                     runrows, quantum);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  out5[0] = blocks;
  out5[1] = attr.numRegs;
  out5[2] = (int)attr.localSizeBytes;
  out5[3] = (int)smem;
  out5[4] = reg_basis(basis_dim, n_channels, quantum);
  return 0;
}

int pn_tile_composite(const int* meta, const int* piece_c0, const int* piece_lo, const int* piece_hi,
                      const int* piece_mask, const float* o, const float* invd, const float* aux,
                      const float* mdir, const float* basis, const float* soa, float* out, int n_tiles,
                      int rays, int ccap, int basis_dim, int n_channels, int sigma_row, int fields,
                      int runrows, int quantum, float step_eps, float stop_thresh, float od_cap,
                      int sigmoid, void* stream) {
  if (n_tiles == 0) return 0;
  // The piece is staged up to sigma_row, and the colour rows lie below it.
  if (!tiles_ok(rays, runrows, quantum, fields) || n_channels < 1 || n_channels > kMaxChannels ||
      sigma_row != 6 + n_channels * basis_dim || sigma_row >= fields)
    return (int)cudaErrorInvalidValue;
  int sub, threads;
  geometry(rays, &sub, &threads);
  const Tiles tl{meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa,
                 rays, ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum, sub,
                 __builtin_ctz(quantum), sigma_row + 1};
  const Params p{tl, out, step_eps, stop_thresh, od_cap, sigmoid};
  const size_t smem = fwd_smem_bytes(rays, basis_dim, n_channels, sigma_row + 1, runrows, quantum);
  return launch(fwd_kernel(basis_dim, n_channels, quantum), p, n_tiles, sub, threads, smem, stream);
}

size_t pn_tile_composite_bwd_smem_bytes(int rays, int basis_dim, int n_channels, int rows,
                                        int runrows, int quantum) {
  int sub, threads;
  geometry(rays, &sub, &threads);
  const size_t cons = threads - 32;
  const size_t nvals = (size_t)n_channels * basis_dim + 1;
  return stage_bytes(rows, runrows, quantum) + 32 +
         sizeof(float) * ((size_t)basis_dim * cons + 2 * nvals * (runrows + 4) +
                          cons / 32 * (n_channels + 1) * kSlots * 32) +
         sizeof(int) * (cons / 32 * kSlots);
}

int pn_tile_composite_bwd(const int* meta, const int* piece_c0, const int* piece_lo,
                          const int* piece_hi, const int* piece_mask, const float* o,
                          const float* invd, const float* aux, const float* mdir, const float* basis,
                          const float* soa, const float* out, const float* g, float* gsoa,
                          int n_tiles, int rays, int ccap, int basis_dim, int n_channels,
                          int sigma_row, int fields, int runrows, int quantum, float step_eps,
                          int sigmoid, void* stream) {
  if (n_tiles == 0) return 0;
  if (!tiles_ok(rays, runrows, quantum, fields) || n_channels < 1 || n_channels > kMaxChannels ||
      sigma_row != 6 + n_channels * basis_dim || sigma_row >= fields || basis_dim < 1 ||
      basis_dim > 32)
    return (int)cudaErrorInvalidValue;
  int sub, threads;
  geometry(rays, &sub, &threads);
  const Tiles tl{meta, piece_c0, piece_lo, piece_hi, piece_mask, o, invd, aux, mdir, basis, soa,
                 rays, ccap, basis_dim, n_channels, sigma_row, fields, runrows, quantum, sub,
                 __builtin_ctz(quantum), sigma_row + 1};
  const BwdParams p{tl, out, g, gsoa, step_eps, sigmoid};
  const size_t smem = pn_tile_composite_bwd_smem_bytes(rays, basis_dim, n_channels, sigma_row + 1,
                                                       runrows, quantum);
  if (basis_dim <= 16)
    return launch(tile_composite_bwd_kernel<1>, p, n_tiles, sub, threads, smem, stream);
  return launch(tile_composite_bwd_kernel<2>, p, n_tiles, sub, threads, smem, stream);
}

// The backward kernels' float4 atomics into the gradient soa and the
// non-zero floats they carried, summed over launches since the last reset.
int pn_tile_bwd_counts(unsigned long long* out2, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out2, g_bwd_counts, 2 * sizeof(unsigned long long));
  if (e == cudaSuccess && reset) {
    const unsigned long long z[2] = {0, 0};
    e = cudaMemcpyToSymbol(g_bwd_counts, z, sizeof(z));
  }
  return (int)e;
}

const char* pn_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
