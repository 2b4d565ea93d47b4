// Sum of table rows picked by an index stream: the gather probes of the
// march's design, as one CUDA kernel for sm_90a.
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
// grid. Here blocks run in parallel: each 16-lane group owns one residue
// class of the flat stream and keeps its sum in registers; a block reduces
// its groups into a [G, D] partial in shared memory, and a second kernel
// adds the partials in a fixed order. No atomics: reruns are bitwise equal.
//
// One group of 16 lanes loads one row as float4s (D = 56: 14 loads, lanes
// 14 and 15 idle); UNROLL (1 or 8) independent rows are in flight per group
// (memory-level parallelism, the counterpart of the TPU unroll). With
// SMEM_TABLE each block first copies the whole table (<= 232,448 bytes,
// 1024 rows at D = 56) into dynamic shared memory: the nearest H100
// counterpart of a VMEM-resident table. Otherwise rows come through L2 (a
// 7.3 MB table fits in its 50 MB) or from HBM.
//
// Bound on this card: the index stream plus each distinct row once plus the
// output, at 3.35 TB/s. A gather from an L2-resident table is latency-bound
// (one dependent index load, then the row load), so it reads far from that
// bound; the probes measure ns per row by table size and access pattern.
//
// Plain C interface for ctypes (no PyTorch headers); launches on the given
// stream, allocates nothing, returns the CUDA error code.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;                          // lanes per row group
constexpr int kThreads = 256;
constexpr int kGroupsPerBlock = kThreads / kLanes;  // 16, a multiple of G
constexpr int kMaxD = 64;
constexpr size_t kMaxSmem = 232448;                 // bytes a block may use
constexpr size_t kReduceSmem = kGroupsPerBlock * kMaxD * sizeof(float);

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <int G, int UNROLL, bool SMEM_TABLE>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const int* __restrict__ idx, long long n,
                  const float* __restrict__ table, int T, int D,
                  float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  const int d4 = D / 4;
  const bool on = lane < d4;
  const float4* rows = reinterpret_cast<const float4*>(table);
  if constexpr (SMEM_TABLE) {
    const int total4 = T * d4;
    for (int i = threadIdx.x; i < total4; i += kThreads) smem4[i] = __ldg(rows + i);
    __syncthreads();
  }
  auto load_row = [&](int r) -> float4 {
    if (!on) return make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (SMEM_TABLE) {
      return smem4[r * d4 + lane];
    } else {
      return __ldg(rows + static_cast<long long>(r) * d4 + lane);
    }
  };

  // Positions gg, gg + stride, gg + 2 stride, ... in increasing order, so
  // the sum's order does not depend on UNROLL. stride is a multiple of G,
  // so every position of this group has p % G == grp % G.
  const long long stride = static_cast<long long>(gridDim.x) * kGroupsPerBlock;
  long long p = static_cast<long long>(blockIdx.x) * kGroupsPerBlock + grp;
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

  // Block reduction into [G, D] (the table's shared memory is reused).
  __syncthreads();
  if (on) reinterpret_cast<float4*>(smem + grp * kMaxD)[lane] = acc;
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int g = t / D;
    const int d = t % D;
    float s = 0.f;
    for (int w = g; w < kGroupsPerBlock; w += G) s += smem[w * kMaxD + d];
    partial[(static_cast<long long>(blockIdx.x) * G + g) * D + d] = s;
  }
}

// out[t] = sum over blocks b (in order) of partial[b, t], t < G * D.
__global__ void gather_sum_finish(const float* __restrict__ partial, int blocks, int gd,
                                  float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= gd) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<long long>(b) * gd + t];
  out[t] = s;
}

template <int G, int UNROLL, bool SMEM_TABLE>
cudaError_t launch(const int* idx, long long n, const float* table, int T, int D,
                   float* partial, int blocks, size_t smem, cudaStream_t stream) {
  auto kernel = gather_sum_kernel<G, UNROLL, SMEM_TABLE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(idx, n, table, T, D, partial);
  return cudaGetLastError();
}

template <int G>
cudaError_t dispatch(int unroll, int smem_table, const int* idx, long long n,
                     const float* table, int T, int D, float* partial, int blocks,
                     size_t smem, cudaStream_t s) {
  if (smem_table) {
    return unroll == 8 ? launch<G, 8, true>(idx, n, table, T, D, partial, blocks, smem, s)
                       : launch<G, 1, true>(idx, n, table, T, D, partial, blocks, smem, s);
  }
  return unroll == 8 ? launch<G, 8, false>(idx, n, table, T, D, partial, blocks, smem, s)
                     : launch<G, 1, false>(idx, n, table, T, D, partial, blocks, smem, s);
}

}  // namespace

extern "C" {

// Number of blocks (and [blocks, G, D] partials) a launch over n indices uses.
int pn_gather_sum_blocks(long long n, int smem_table) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long per_sm = smem_table ? 1 : 8;
  const long long want = (n + kGroupsPerBlock - 1) / kGroupsPerBlock;
  long long blocks = sms * per_sm < want ? sms * per_sm : want;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// Dynamic shared memory a launch needs, in bytes.
size_t pn_gather_sum_smem_bytes(int T, int D, int smem_table) {
  const size_t table = static_cast<size_t>(T) * D * sizeof(float);
  return smem_table && table > kReduceSmem ? table : kReduceSmem;
}

// out [G, D] f32 = sums of table [T, D] f32 rows over the int32 index
// stream idx [n] by position mod G; partial: [blocks, G, D] f32 workspace.
int pn_gather_sum(const void* idx, long long n, const void* table, int T, int D, int G,
                  int unroll, int smem_table, void* partial, int blocks, void* out,
                  void* stream) {
  if (D < 4 || D > kMaxD || D % 4 != 0 || (G != 1 && G != 8) ||
      (unroll != 1 && unroll != 8) || blocks < 1 || n < 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = pn_gather_sum_smem_bytes(T, D, smem_table);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* tb = static_cast<const float*>(table);
  float* part = static_cast<float*>(partial);
  cudaError_t err = G == 8 ? dispatch<8>(unroll, smem_table, ix, n, tb, T, D, part, blocks, smem, s)
                           : dispatch<1>(unroll, smem_table, ix, n, tb, T, D, part, blocks, smem, s);
  if (err != cudaSuccess) return err;
  const int gd = G * D;
  gather_sum_finish<<<(gd + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, blocks, gd, static_cast<float*>(out));
  return cudaGetLastError();
}

const char* pn_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
