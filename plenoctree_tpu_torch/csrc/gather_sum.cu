// Sum of table rows picked by an index stream: the gather probes of the
// march's design, as CUDA kernels for sm_90a.
//
// Replaces three Pallas TPU kernels, which all compute
//   out[g, :] = sum over flat positions p with p % G == g of table[idx[p], :]
//   * scripts/bench_gather.py::pallas_vmem (call :127; unroll 1 and 8): G = 1,
//     idx [K, R];
//   * scripts/bench_gather.py::pallas_vmem_tile (call :168): G = 8, idx [K, R]
//     with R % 8 == 0, so the group of idx[k, r] is r % 8;
//   * scripts/bench_gather2.py::pallas_run (call :143): G = 1, idx [R, K].
// On the TPU the table sits in VMEM, a scalar loop reads one index at a
// time from SMEM and a [G, D] scratch carries the sum across the sequential
// grid. Here blocks run in parallel, and where the table sits is a choice
// (the wrapper's `placement`):
//
// * SLICED (the TPU kernels' own case, a table up to the card's aggregate
//   shared memory): the table is cut into S row slices, one per block
//   (2 per SM), each staged once into shared memory by a bulk copy
//   (cp.async.bulk on an mbarrier). A stable counting sort routes the index
//   stream to the slices' buckets, one per bin (p % G, slice): route_count
//   (each 8,192-position chunk's bin histogram), route_scan (each bin's
//   prefix over the chunks), route_scatter (each warp holds 1,024 positions
//   in registers and counts them per bin in its own 16-bit counters; a
//   ballot per bit of the bin number ranks a warp's lanes of one bin in
//   stream order; the chunk is sorted by bin in shared memory and copied
//   out, each bin's run to consecutive addresses). sliced_sum then sums each
//   bucket of its slice from shared memory, G buckets side by side. The
//   routing moves the stream about three times through L2 (~25 MB for 2M
//   indices) in place of ~470 MB of row reads from L2.
// * SMEM (a table that fits one block's shared memory): every block stages
//   the whole table by a bulk copy and sums its part of the stream from it.
// * L2 (anything larger, e.g. the 1M-row HBM probe): rows come through L2
//   (or from HBM) with __ldg, UNROLL rows in flight per lane group (the
//   kernel's first design).
//
// A group of 16 lanes owns one row at a time (one float4 a lane; at D = 56
// lanes 14 and 15 idle) and keeps its sums in registers. In SMEM and
// SLICED a warp reads its row indices as tiles of 32 (one coalesced load,
// then a shuffle per two rows) with UNROLL tiles in flight. A block
// reduces its groups in a fixed order into a [G, D] partial, and
// gather_sum_finish adds the partials in a fixed order (one warp per
// output: a strided run per lane, then a shuffle tree). No float atomics
// and a stable routing: reruns are bitwise equal. The kernels trust the
// indices to lie in [0, T).
//
// Bound on this card: the index stream plus each distinct row once plus the
// output, at 3.35 TB/s. The probes keep the row gathers (a histogram of the
// stream times the table would reach the bound and measure nothing the
// march can use), so the time per row depends on where the rows sit:
// shared memory, L2 or HBM. Shared-memory reads bound SMEM and SLICED's
// sums: 2 wavefronts per 224-byte row (1.75 with every lane busy) plus a
// shuffle per two rows.
//
// Plain C interface for ctypes (no PyTorch headers); launches on the given
// stream, allocates nothing (the wrapper passes one int32 workspace),
// returns the CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;   // lanes per row group
constexpr int kMaxD = 64;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use
constexpr int kL2Threads = 256;
constexpr int kSmemThreads = 512;
constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kPer = 32;                        // stream positions per routing thread
constexpr int kChunk = kPer * kRouteThreads;   // positions per routing chunk (block)
constexpr int kBulkPiece = 32768;  // bytes per cp.async.bulk instruction

enum Placement { kL2 = 0, kSmem = 1, kSliced = 2 };

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// ---- Hopper primitives: an mbarrier and bulk copies (as tile_composite.cu) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage `bytes` (a multiple of 16, 16-byte aligned at both ends) from
// global memory into shared memory: thread 0 arms the barrier and issues the
// bulk copies. The block must pass a __syncthreads() (the barrier is then
// initialised) before stage_wait.
__device__ void stage_issue(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  for (uint32_t off = 0; off < bytes; off += kBulkPiece) {
    const uint32_t n = bytes - off < kBulkPiece ? bytes - off : kBulkPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

// Wait for the staged bytes (the barrier's phase 0). A wait that has not
// ended after ~10 s of clock traps instead of hanging the card.
__device__ void stage_wait(uint64_t* bar) {
  const uint32_t a = smem_u32(bar);
  uint32_t ok = 0;
  const long long t0 = clock64();
  while (!ok) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(0)
        : "memory");
    if (!ok && clock64() - t0 > 20000000000LL) __trap();
  }
}

// The L2 kernel's block reduction of one float4 per lane group (rows of
// `red`, kMaxD floats each) into out[g * D + d] for the groups w with
// w % G == g, in order of w.
template <int G>
__device__ void reduce_groups(float* red, const float4& acc, bool on, int grp, int lane, int D,
                              int groups, float* out) {
  __syncthreads();
  if (on) reinterpret_cast<float4*>(red + grp * kMaxD)[lane] = acc;
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += blockDim.x) {
    const int g = t / D;
    const int d = t % D;
    float s = 0.f;
    for (int w = g; w < groups; w += G) s += red[w * kMaxD + d];
    out[t] = s;
  }
}

// ---- L2: rows through L2 / HBM ----

template <int G, int UNROLL>
__global__ void __launch_bounds__(kL2Threads)
l2_kernel(const int* __restrict__ idx, long long n, const float* __restrict__ table, int D,
          float* __restrict__ partial) {
  __shared__ float red[(kL2Threads / kLanes) * kMaxD];
  constexpr int kGroups = kL2Threads / kLanes;  // 16, a multiple of G
  const int lane = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  const int d4 = D / 4;
  const bool on = lane < d4;
  const float4* rows = reinterpret_cast<const float4*>(table);
  auto load_row = [&](int r) -> float4 {
    return on ? __ldg(rows + static_cast<long long>(r) * d4 + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  // Positions gg, gg + stride, ... in increasing order, so the sum's order
  // does not depend on UNROLL. stride is a multiple of G, so every position
  // of this group has p % G == grp % G.
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  long long p = static_cast<long long>(blockIdx.x) * kGroups + grp;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (; p + (UNROLL - 1) * stride < n; p += UNROLL * stride) {
    int r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = __ldg(idx + p + u * stride);
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = load_row(r[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add4(acc, v[u]);
  }
  for (; p < n; p += stride) add4(acc, load_row(__ldg(idx + p)));
  reduce_groups<G>(red, acc, on, grp, lane, D, kGroups,
                   partial + static_cast<long long>(blockIdx.x) * G * D);
}

// ---- Shared-memory rows: warp tiles ----

// The warps of the SMEM and SLICED kernels read their entries (row indices)
// as tiles of 32: one coalesced load per lane, then the two half-warps take
// the tile's entries 2k + h (k = 0..15) from it by shuffle, so 14 of each
// 16 lanes (at D = 56) load a float4 of a row from shared memory per entry
// while the next UNROLL tiles' entries are in flight. Entry 2k + h goes to
// the lane's accumulator k % 4: with tiles starting at multiples of 32, the
// stream positions of slot q of half-warp h are all = 2q + h (mod 8).
constexpr int kTile = 32;
constexpr int kWarps = kSmemThreads / 32;  // 16
constexpr int kSlots = 4;

// Tiles first, first + step, ... (tile t = entries [beg + 32 t, beg + 32 t
// + 32) of list, clipped to end), in increasing t, into acc[kSlots].
template <int UNROLL>
__device__ __forceinline__ void sum_tiles(const int* __restrict__ list, long long beg,
                                          long long end, long long first, long long step,
                                          int row0, const float4* rows4, int d4, float4* acc) {
  const int lane = threadIdx.x % 32;
  const int h = lane / kLanes;
  const int l16 = lane % kLanes;
  const bool on = l16 < d4;
  for (long long t = first; beg + t * kTile < end; t += step * UNROLL) {
    int r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = beg + (t + u * step) * kTile + lane;
      r[u] = e < end ? __ldg(list + e) - row0 : 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long tb = beg + (t + u * step) * kTile;
      if (tb >= end) break;  // the same for the whole warp
#pragma unroll
      for (int k = 0; k < kTile / 2; ++k) {
        const int j = 2 * k + h;
        const int row = __shfl_sync(0xffffffffu, r[u], j);
        if (on && tb + j < end) add4(acc[k % kSlots], rows4[row * d4 + l16]);
      }
    }
  }
}

// The SMEM kernel's [8, D] block sum: slot q of half-warp h holds the
// residue 2q + h (its tiles start at multiples of 32); out[g, d] = the sum
// over the warps in order. `red` (kWarps * 8 * kMaxD floats) may alias
// shared memory the block has finished reading.
__device__ void reduce_slots(float* red, float4* acc, int D, float* out) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int h = lane / kLanes;
  const int l16 = lane % kLanes;
  __syncthreads();
  if (l16 < D / 4) {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      reinterpret_cast<float4*>(red + (warp * 8 + 2 * q + h) * kMaxD)[l16] = acc[q];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 8 * D; t += blockDim.x) {
    const int g = t / D;
    const int d = t % D;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * 8 + g) * kMaxD + d];
    out[t] = s;
  }
}

// A block's [G, D] sum when warp w's slots all belong to residue w % G:
// each lane adds its slots, then its half-warp partner's; out[g, d] = the
// sum over the warps w = g, g + G, ... in order. `red` holds kWarps * kMaxD
// floats.
template <int G>
__device__ void reduce_warps(float* red, float4* acc, int D, float* out) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int l16 = lane % kLanes;
  __syncthreads();
  float4 a = acc[0];
#pragma unroll
  for (int q = 1; q < kSlots; ++q) add4(a, acc[q]);
  float4 b;
  b.x = __shfl_down_sync(0xffffffffu, a.x, kLanes);
  b.y = __shfl_down_sync(0xffffffffu, a.y, kLanes);
  b.z = __shfl_down_sync(0xffffffffu, a.z, kLanes);
  b.w = __shfl_down_sync(0xffffffffu, a.w, kLanes);
  add4(a, b);
  if (lane < kLanes && l16 < D / 4) reinterpret_cast<float4*>(red + warp * kMaxD)[l16] = a;
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += blockDim.x) {
    const int g = t / D;
    const int d = t % D;
    float s = 0.f;
    for (int w = g; w < kWarps; w += G) s += red[w * kMaxD + d];
    out[t] = s;
  }
}

// ---- SMEM: the whole table in every block ----

template <int G, int UNROLL>
__global__ void __launch_bounds__(kSmemThreads)
smem_kernel(const int* __restrict__ idx, long long n, const float* __restrict__ table, int D,
            size_t table_bytes, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const size_t red_bytes = kWarps * G * kMaxD * 4;
  const size_t region = table_bytes > red_bytes ? table_bytes : red_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem4) + region);
  stage_issue(smem4, table, static_cast<uint32_t>(table_bytes), bar);
  __syncthreads();
  stage_wait(bar);
  float4 acc[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  sum_tiles<UNROLL>(idx, 0, n, static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32,
                    static_cast<long long>(gridDim.x) * kWarps, 0, smem4, D / 4, acc);
  float* red = reinterpret_cast<float*>(smem4);
  float* out = partial + static_cast<long long>(blockIdx.x) * G * D;
  if constexpr (G == 1) {
    reduce_warps<1>(red, acc, D, out);
  } else {
    reduce_slots(red, acc, D, out);
  }
}

// ---- SLICED: routing ----

// Exclusive prefix sums of v[0, count) into out[0, count) (shared memory),
// by the whole block (a multiple of 32 threads, at most 1024): a run of
// entries per thread, a shuffle scan per warp, then one over the warps.
// `scratch` holds 32 ints; out may be v. count <= kScanPer * blockDim.x.
// Ends with a block barrier.
constexpr int kScanPer = 9;  // >= the most bins (8 * 264) over 256 threads
__device__ void block_exclusive_scan(const int* v, int count, int* out, int* scratch) {
  const int per = (count + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int val[kScanPer];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    val[k] = k < per && lo + k < count ? v[lo + k] : 0;
    s += val[k];
  }
  int x = s;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    const int w = lane < nw ? scratch[lane] : 0;
    int z = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    if (lane < nw) scratch[lane] = z - w;  // exclusive over the warps
  }
  __syncthreads();
  int run = scratch[warp] + x - s;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    if (k < per && lo + k < count) out[lo + k] = run;
    run += val[k];
  }
  __syncthreads();
}

// r / rps for 0 <= r < 2^24 (every row index of a sliced table), from a
// float product and one correction each way; inv = 1.0f / rps.
__device__ __forceinline__ int div_rows(int r, int rps, float inv) {
  int q = __float2int_rz(static_cast<float>(r) * inv);
  q += (q + 1) * rps <= r;
  q -= q * rps > r;
  return q;
}

// counts[c * B + b] = how many positions of chunk c (kChunk positions from
// c * kChunk) fall in bin b. Each thread loads its kPer indices at once.
template <int G>
__global__ void __launch_bounds__(kRouteThreads)
route_count(const int* __restrict__ idx, long long n, int rps, int S, int C,
            int* __restrict__ counts) {
  extern __shared__ int hist[];
  const int B = G * S;
  for (int b = threadIdx.x; b < B; b += blockDim.x) hist[b] = 0;
  const long long lo = static_cast<long long>(blockIdx.x) * kChunk + threadIdx.x;
  int r[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long p = lo + k * kRouteThreads;
    r[k] = p < n ? __ldg(idx + p) : -1;
  }
  __syncthreads();
  const int res = static_cast<int>(threadIdx.x % G) * S;  // kRouteThreads % G == 0
  const float inv = 1.0f / rps;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (r[k] >= 0) atomicAdd(&hist[res + div_rows(r[k], rps, inv)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) counts[static_cast<long long>(blockIdx.x) * B + b] = hist[b];
}

// counts [C, B] becomes each bin's exclusive prefix over the chunks; tot[b]
// the bin's total. A block of 32 warps takes 32 bins: it loads up to
// kScanRows chunks of them at once (rows of 32 bins, coalesced), then warp
// w scans bin w's column with shuffles, carrying its total to the next
// rows, and the block writes the rows back.
constexpr int kScanRows = 256;
__global__ void __launch_bounds__(1024)
route_scan(int* __restrict__ counts, int C, int B, int* __restrict__ tot) {
  __shared__ int rows[kScanRows][33];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b = blockIdx.x * 32 + lane;
  int carry = 0;  // warp `warp`'s bin, in every lane
  for (int c0 = 0; c0 < C; c0 += kScanRows) {
#pragma unroll
    for (int i = 0; i < kScanRows / 32; ++i) {
      const int c = c0 + i * 32 + warp;
      rows[i * 32 + warp][lane] = b < B && c < C ? counts[static_cast<long long>(c) * B + b] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScanRows / 32; ++i) {
      const int v = rows[i * 32 + lane][warp];
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      rows[i * 32 + lane][warp] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScanRows / 32; ++i) {
      const int c = c0 + i * 32 + warp;
      if (b < B && c < C) counts[static_cast<long long>(c) * B + b] = rows[i * 32 + warp][lane];
    }
    __syncthreads();
  }
  if (lane == 0 && blockIdx.x * 32 + warp < B) tot[blockIdx.x * 32 + warp] = carry;
}

// Bits of a bin number: B = G * S <= G * 2 * 132 slices (the wrapper's plan).
template <int G>
constexpr int kBinBits = G == 1 ? 9 : 12;

// The lanes of this warp whose bin equals mine, among the valid ones: one
// ballot per bit of the bin number.
template <int BITS>
__device__ __forceinline__ unsigned bin_peers(int b, bool valid) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
  for (int i = 0; i < BITS; ++i) {
    const unsigned m = __ballot_sync(0xffffffffu, (b >> i) & 1);
    peers &= ((b >> i) & 1) ? m : ~m;
  }
  return peers;
}

// Block c places its chunk's indices in sorted[] at their bins' buckets,
// each bin's entries in stream order: bucket b starts at the sum of tot
// over the bins before b, and chunk c's part of it at its prefix. Warp w
// holds the chunk's positions w * kPer * 32 .. in registers and counts them
// per bin in its own 16-bit counters (integer atomics: the counts do not
// depend on their order), which become its cursors, after warps 0..w-1's.
// Its lanes of one bin are then ranked in stream order by bin_peers. The
// chunk is sorted by bin in shared memory first, then copied out, each
// bin's run to consecutive addresses.
template <int G>
__global__ void __launch_bounds__(kRouteThreads)
route_scatter(const int* __restrict__ idx, long long n, int rps, int S, int C,
              const int* __restrict__ prefix, const int* __restrict__ tot, int* __restrict__ sorted) {
  extern __shared__ int sm[];
  const int B = G * S;
  const int Bp = (B + 1) & ~1;      // a warp's counter row, whole 32-bit words
  int* gdelta = sm;                 // [B]: global position - local position, per bin
  int* lstart = gdelta + B;         // [B]: the bin's first local position
  int* scratch = lstart + B;        // [32]
  int* stage = scratch + 32;        // [kChunk]: the chunk sorted by bin
  unsigned short* stage_bin = reinterpret_cast<unsigned short*>(stage + kChunk);  // [kChunk]
  unsigned short* cur = stage_bin + kChunk;  // [kRouteWarps][Bp]: counts, then cursors
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long lo = static_cast<long long>(blockIdx.x) * kChunk + warp * (kPer * 32) + lane;
  int r[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long p = lo + k * 32;
    r[k] = p < n ? __ldg(idx + p) : -1;
  }
  for (int i = threadIdx.x; i < kRouteWarps * Bp / 2; i += blockDim.x) reinterpret_cast<int*>(cur)[i] = 0;
  block_exclusive_scan(tot, B, gdelta, scratch);  // each bucket's start; ends with a barrier
  unsigned short* mine = cur + warp * Bp;
  unsigned* mine32 = reinterpret_cast<unsigned*>(mine);
  const int res = (lane % G) * S;  // position = lane (mod 32)
  const float inv = 1.0f / rps;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (r[k] >= 0) {
      const int b = res + div_rows(r[k], rps, inv);
      atomicAdd(mine32 + b / 2, 1u << (16 * (b & 1)));  // a count < 2^16 in each half
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kRouteWarps; ++w) c += cur[w * Bp + b];
    lstart[b] = c;  // the block's count, scanned below
  }
  __syncthreads();
  block_exclusive_scan(lstart, B, lstart, scratch);
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int run = lstart[b];
    gdelta[b] += prefix[static_cast<long long>(blockIdx.x) * B + b] - run;
    int c[kRouteWarps];
#pragma unroll
    for (int w = 0; w < kRouteWarps; ++w) c[w] = cur[w * Bp + b];
#pragma unroll
    for (int w = 0; w < kRouteWarps; ++w) {
      cur[w * Bp + b] = static_cast<unsigned short>(run);
      run += c[w];
    }
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool valid = r[k] >= 0;
    const int b = valid ? res + div_rows(r[k], rps, inv) : 0;
    const unsigned peers = bin_peers<kBinBits<G>>(b, valid);
    const int at = valid ? mine[b] : 0;
    __syncwarp();
    if (valid) {
      const int i = at + __popc(peers & lt);
      stage[i] = r[k];
      stage_bin[i] = static_cast<unsigned short>(b);
      if ((peers & lt) == 0) mine[b] = static_cast<unsigned short>(at + __popc(peers));  // the bin's lowest lane
    }
    __syncwarp();
  }
  __syncthreads();
  const long long left = n - static_cast<long long>(blockIdx.x) * kChunk;
  const int count = left < kChunk ? static_cast<int>(left) : kChunk;
  for (int i = threadIdx.x; i < count; i += blockDim.x) sorted[i + gdelta[stage_bin[i]]] = stage[i];
}

// ---- SLICED: the sums ----

// Block s stages rows [s * rps, min(T, (s + 1) * rps)) and sums each of its
// G buckets from shared memory into partial[s, g, :].
template <int G, int UNROLL>
__global__ void __launch_bounds__(kSmemThreads)
sliced_sum(const int* __restrict__ sorted, const int* __restrict__ tot, int S, int rps, int T,
           int D, const float* __restrict__ table, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int B = G * S;
  const int s = blockIdx.x;
  const int row0 = s * rps;
  const int rows = (T - row0 < rps ? T - row0 : rps);
  const int d4 = D / 4;
  const size_t slice_bytes = static_cast<size_t>(rps) * d4 * 16;
  // Shared memory: the slice | its barrier (16 B) | red [kWarps][kMaxD] |
  // base [B] (each bin's first entry in sorted) | scratch [32].
  uint64_t* bar = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(smem4) + slice_bytes);
  float* red = reinterpret_cast<float*>(bar + 2);
  int* base = reinterpret_cast<int*>(red + kWarps * kMaxD);
  int* scratch = base + B;
  stage_issue(smem4, table + static_cast<long long>(row0) * D,
              static_cast<uint32_t>(static_cast<size_t>(rows) * d4 * 16), bar);
  block_exclusive_scan(tot, B, base, scratch);  // overlaps the copy; ends with a barrier
  stage_wait(bar);
  // Warp w sums bucket (w % G, s): its tiles w / G, w / G + kWarps / G, ...
  const int warp = threadIdx.x / 32;
  const int b = (warp % G) * S + s;
  float4 acc[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  sum_tiles<UNROLL>(sorted, base[b], base[b] + tot[b], warp / G, kWarps / G, row0, smem4, d4, acc);
  reduce_warps<G>(red, acc, D, partial + static_cast<long long>(s) * G * D);
}

// ---- Every placement: the partials' fixed-order sum ----

// out[t] = sum of partial[k, t] over k < parts, t < gd: one warp per t,
// lane l adding k = l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void gather_sum_finish(const float* __restrict__ partial, int parts, int gd,
                                  float* __restrict__ out) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (t >= gd) return;
  float s = 0.f;
  for (int k = lane; k < parts; k += 32) s += partial[static_cast<long long>(k) * gd + t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[t] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define PN_TRY(x)                              \
  do {                                         \
    cudaError_t e_ = (x);                      \
    if (e_ != cudaSuccess) return e_;          \
  } while (0)

template <int G, int UNROLL>
cudaError_t launch(int placement, const int* idx, long long n, const float* table, int T, int D,
                   int S, int rps, int C, int blocks, int* ws, float* out,
                   cudaStream_t st) {
  const int gd = G * D;
  const size_t table_bytes = static_cast<size_t>(T) * D * 4;
  float* partial;
  int parts;
  if (placement == kL2) {
    partial = reinterpret_cast<float*>(ws);
    parts = blocks;
    l2_kernel<G, UNROLL><<<blocks, kL2Threads, 0, st>>>(idx, n, table, D, partial);
  } else if (placement == kSmem) {
    partial = reinterpret_cast<float*>(ws);
    parts = blocks;
    const size_t red = kWarps * G * kMaxD * 4;
    const size_t smem = (table_bytes > red ? table_bytes : red) + 16;
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    auto k = smem_kernel<G, UNROLL>;
    PN_TRY(allow_smem(k, smem));
    k<<<blocks, kSmemThreads, smem, st>>>(idx, n, table, D, table_bytes, partial);
  } else {
    // ws: counts/prefix [C, B] | tot [B] | sorted [n] | partial [S, G, D] f32
    const int B = G * S;
    int* counts = ws;
    int* tot = counts + static_cast<long long>(B) * C;
    int* sorted = tot + B;
    partial = reinterpret_cast<float*>(sorted + n);
    parts = S;
    const size_t count_smem = static_cast<size_t>(B) * 4;
    const size_t scatter_smem = (2 * static_cast<size_t>(B) + 32 + kChunk) * 4 +
                                (kChunk + kRouteWarps * static_cast<size_t>((B + 1) & ~1)) * 2;
    const size_t sum_smem = static_cast<size_t>(rps) * D * 4 + 16 + kWarps * kMaxD * 4 +
                            (static_cast<size_t>(B) + 32) * 4;
    if (scatter_smem > kMaxSmem || sum_smem > kMaxSmem || B > (1 << kBinBits<G>) ||
        B > kScanPer * kRouteThreads || T >= (1 << 24) ||
        static_cast<long long>(C) * kChunk < n) {
      return cudaErrorInvalidValue;
    }
    auto k1 = route_count<G>;
    auto k3 = route_scatter<G>;
    auto k4 = sliced_sum<G, UNROLL>;
    PN_TRY(allow_smem(k1, count_smem));
    PN_TRY(allow_smem(k3, scatter_smem));
    PN_TRY(allow_smem(k4, sum_smem));
    k1<<<C, kRouteThreads, count_smem, st>>>(idx, n, rps, S, C, counts);
    PN_TRY(cudaGetLastError());
    route_scan<<<(B + 31) / 32, 1024, 0, st>>>(counts, C, B, tot);
    PN_TRY(cudaGetLastError());
    k3<<<C, kRouteThreads, scatter_smem, st>>>(idx, n, rps, S, C, counts, tot, sorted);
    PN_TRY(cudaGetLastError());
    k4<<<S, kSmemThreads, sum_smem, st>>>(sorted, tot, S, rps, T, D, table, partial);
  }
  PN_TRY(cudaGetLastError());
  gather_sum_finish<<<(gd * 32 + 255) / 256, 256, 0, st>>>(partial, parts, gd, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [G, D] f32 = sums of table [T, D] f32 rows over the int32 index
// stream idx [n] (n >= 1) by position mod G. placement: 0 L2 (`blocks`
// blocks), 1 SMEM (`blocks` blocks), 2 SLICED (S slices of rps rows, C
// routing chunks of kChunk positions). ws: the int32 workspace the wrapper sizes
// (plenoctree_tpu_torch/kernels/gather_sum.py::plan).
int pn_gather_sum(const void* idx, long long n, const void* table, int T, int D, int G,
                  int unroll, int placement, int S, int rps, int C, int blocks,
                  void* ws, void* out, void* stream) {
  if (D < 4 || D > kMaxD || D % 4 != 0 || (G != 1 && G != 8) || (unroll != 1 && unroll != 8) ||
      n < 1 || placement < kL2 || placement > kSliced ||
      (placement != kSliced && blocks < 1) ||
      (placement == kSliced && (S < 1 || rps < 1 || C < 1 || static_cast<long long>(S) * rps < T))) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* tb = static_cast<const float*>(table);
  int* w = static_cast<int*>(ws);
  float* o = static_cast<float*>(out);
  if (G == 8) {
    return unroll == 8 ? launch<8, 8>(placement, ix, n, tb, T, D, S, rps, C, blocks, w, o, st)
                       : launch<8, 1>(placement, ix, n, tb, T, D, S, rps, C, blocks, w, o, st);
  }
  return unroll == 8 ? launch<1, 8>(placement, ix, n, tb, T, D, S, rps, C, blocks, w, o, st)
                     : launch<1, 1>(placement, ix, n, tb, T, D, S, rps, C, blocks, w, o, st);
}

const char* pn_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
