// Fused NeRF trunk MLP on Hopper: forward and backward on wgmma, weights
// streamed by bulk copies through an mbarrier ring.
//
// Replaces the Pallas TPU kernels of plenoctree_tpu/kernels/fused_mlp.py:
// _make_fwd_kernel (launched from _pallas_fwd) and _make_bwd_kernel
// (launched from _pallas_bwd), with both variants. Same function: depth
// ReLU layers of `width`, a skip concat [h, x] after layer i when
// i % skip == 0 and i > 0, and one fused [K, 1 + C*K_sh] sigma/rgb head;
// bf16 operands with f32 accumulation, bias add and ReLU in f32, bf16
// activations between layers, the head in f32. The backward recomputes the
// forward, walks the layers in reverse with bf16 cotangents in every
// product (_dot_tn / _dot_nt) and returns f32 weight and bias gradients; no
// input gradients. Variants:
//  * in-kernel posenc: x is the raw f32 [n, 3] point and the x tile is
//    built here, [x, sin(x 2^f)..., sin(x 2^f + pi/2)...] (frequency-major,
//    xyz-minor, the exact power-of-two scale, the phase add rounded in f32,
//    the precise sinf), rounded to bf16 once, straight into shared memory;
//  * in-kernel SH decode: the head's f32 coefficients are contracted per
//    colour channel against a per-row basis [n, K] in the epilogue; the
//    backward forms the coefficients' cotangent g_rgb[c] basis[k] in f32.
//
// What bounds it on an H100: the tensor cores. Per row the trunk is
// 2 * 503,552 FLOP (8x256, d_in 63, head 49); the backward does three times
// that (recompute, cotangents, weight gradients) and moves its per-layer
// inputs and cotangents through a workspace in device memory (8.3 KB a row
// at 8x256, written once and read once: a floor of ~3.9 ms at 786,432 rows).
// The weights (~1 MB of bf16) stream from L2 once per 128-row block tile:
// 7.9 KB a row in the forward, 15.1 KB in backward pass 1.
//
// Design:
//  * Blocks of three warpgroups: one producer thread (its warpgroup gives
//    its registers to the others with setmaxnreg) streams the packed
//    weights, K-slab by K-slab (64 rows of K), with cp.async.bulk into a
//    ring of NSTAGE slabs guarded by full/empty mbarriers; two consumer
//    warpgroups each own a 64-row tile (one wgmma M) and run
//    wgmma.mma_async m64nNk16 (bf16 -> f32) on every slab as it lands, so
//    each slab serves 128 rows and no block-wide barrier guards a slab.
//    Blocks are persistent (one per SM) and walk 128-row tiles; the weight
//    sequence is the same for every tile, so the producer runs ahead into
//    the next tile while the consumers finish the current one.
//  * Operands live in shared memory as core-matrix images (8x8 bf16
//    blocks, 128 contiguous bytes each; no swizzle): a 64-row activation
//    tile is [F/8][8][8 rows][8 features], which is the K-major A operand
//    of the next layer (LBO 1 KB, SBO 128 B) and, in device memory, the
//    MN-major operand of the weight-gradient product. Weights are packed
//    once per call by kernels/fused_mlp.py (`_layout` defines the stream)
//    as K-major B images: W^T for the forward, W itself for the
//    backward's dh = dpre W^T.
//  * Epilogues run on the accumulator registers: bias (from shared memory)
//    + ReLU + bf16 conversion, written back as bf16 pairs into the image
//    the next layer reads; the backward keeps one ReLU-mask bit per
//    activation in shared memory (the thread that wrote it reads it back:
//    the dh accumulator has the activation's fragment layout). Workspace
//    tiles leave and enter shared memory as single bulk copies.
//  * Backward pass 1 (per 64-row tile): x tile, recompute (each activation
//    image bulk-stored to the workspace), head cotangent, then
//    dh = dpre_i W_i^T and dpre_{i-1} = dh * mask, each cotangent image
//    bulk-stored; per-tile f32 column sums of dpre (bias partials).
//    Pass 2: dW_i = In_i^T dpre_i as a wgmma product with K = rows (both
//    operands MN-major, read from the workspace images by bulk copies),
//    one block per (128-feature block of a layer's K, row split), into f32
//    partials that a fixed-order column sum adds: no atomics, bitwise
//    identical from run to run.
//
// Packed layouts (kernels/fused_mlp.py::_layout is their one definition
// and hands them over as tables that make_net checks): the weight stream is
// a list of slabs (layer, part h/x, k0, k, byte offset), the forward's
// (layers 0..depth) then the backward's (layers depth..1); gradients come
// back as f32 [K_i, N_i] row-major per layer at w_off (h rows, then xp x
// rows), biases at b_off.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;                    // rows per consumer warpgroup (the wgmma M)
constexpr int NCONS = 2;                  // consumer warpgroups per block
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int KS = 64;                    // weight rows (K) per slab
constexpr int MAX_N = 256;                // widest layer output (the wgmma N limit)
constexpr int MAX_XP = 64;                // widest padded x
constexpr int NSTAGE = 3;                 // weight slabs in flight
constexpr int SLAB_BYTES = KS * MAX_N * 2;
constexpr int MAX_LAYERS = 17;
constexpr int MAX_SLABS = 160;
constexpr int MAX_RGB = 4;                // decoded colour channels
constexpr int CHUNK_ROWS = 131072;        // rows per backward chunk
constexpr int P2_A_BYTES = 128 * TM * 2;  // pass 2: 128 features x 64 rows
constexpr int P2_STAGE = P2_A_BYTES + MAX_N * TM * 2;
constexpr int P2_NSTAGE = 4;
constexpr int MAX_ITEMS = 64;             // pass-2 (layer, segment, feature block) items
constexpr int SMEM_LIMIT = 232448;
// Core-matrix images of 64-row tiles: feature block stride (8 features x
// 64 rows) and row block stride, in bytes.
constexpr uint32_t IMG_FSTRIDE = TM * 16;
constexpr uint32_t IMG_RSTRIDE = 128;

struct Net {
  int depth, width, d_in, xp, d_out, np, n_sigma;
  int pe_on, pe_min, pe_max, sh_dim, n_rgb;
  int has_h[MAX_LAYERS], has_x[MAX_LAYERS], n[MAX_LAYERS], b_off[MAX_LAYERS];
  long long w_off[MAX_LAYERS];
  int b_total;
  long long w_total;
  int fs0[MAX_LAYERS + 1];                  // forward slabs of layer i: [fs0[i], fs0[i + 1])
  int bs_begin[MAX_LAYERS], bs_end[MAX_LAYERS];  // dh slabs of layer i >= 1
  unsigned slab_off[MAX_SLABS];             // byte offset in the weight stream
  unsigned slab_bytes[MAX_SLABS];
  unsigned slab_info[MAX_SLABS];            // part | k0 << 4 | k << 16
};

bool pow2_width(int v) { return v == 16 || v == 32 || v == 64 || v == 128 || v == 256; }

// Reads the wrapper's layer descriptor (5 values per layer: h rows, x rows,
// N, w_off, b_off) and slab table (5 per slab: layer, part, k0, k, byte
// offset) and checks that the kernels can take them: layer 0 reads x only,
// every later layer the width-wide h (and maybe x), trunk layers `width`
// wide; width and the head's np in {16, 32, 64, 128, 256}; xp <= 64; the
// slabs cover every layer's K in order, in 16-row multiples, inside the
// stream.
bool make_net(Net* L, const long long* desc, int n_layers, int d_in, int d_out, int n_sigma,
              int pe_on, int pe_min, int pe_max, int sh_dim, const long long* slabs, int n_slabs,
              long long stream_bytes) {
  if (n_layers < 2 || n_layers > MAX_LAYERS || n_slabs < 1 || n_slabs > MAX_SLABS) return false;
  const int depth = n_layers - 1, width = (int)desc[2], xp = (int)desc[1];
  const int np = (int)desc[5 * depth + 2];
  if (!pow2_width(width) || !pow2_width(np) || xp < d_in || xp > MAX_XP || xp % 16 || d_in < 1 ||
      np < d_out || n_sigma < 1 || n_sigma > d_out)
    return false;
  if (pe_on && (pe_min < 0 || pe_max <= pe_min || d_in != 3 * (1 + 2 * (pe_max - pe_min))))
    return false;
  if (sh_dim < 0 || (sh_dim && ((d_out - n_sigma) % sh_dim || (d_out - n_sigma) / sh_dim > MAX_RGB)))
    return false;
  *L = Net();
  L->depth = depth;
  L->width = width;
  L->d_in = d_in;
  L->xp = xp;
  L->d_out = d_out;
  L->np = np;
  L->n_sigma = n_sigma;
  L->pe_on = pe_on;
  L->pe_min = pe_min;
  L->pe_max = pe_max;
  L->sh_dim = sh_dim;
  L->n_rgb = sh_dim ? (d_out - n_sigma) / sh_dim : d_out - n_sigma;
  long long w = 0;
  int b = 0;
  for (int i = 0; i <= depth; ++i) {
    const long long* d = desc + 5 * i;
    const int k_h = (int)d[0], k_x = (int)d[1], nn = (int)d[2];
    if (k_h != (i > 0 ? width : 0) || (k_x != 0 && k_x != xp) || (i == 0 && k_x == 0) ||
        nn != (i < depth ? width : np) || d[3] != w || d[4] != b)
      return false;
    L->has_h[i] = k_h > 0;
    L->has_x[i] = k_x > 0;
    L->n[i] = nn;
    L->w_off[i] = w;
    L->b_off[i] = b;
    w += (long long)(k_h + k_x) * nn;
    b += nn;
  }
  L->b_total = b;
  L->w_total = w;
  // The slab table: forward slabs of layers 0..depth (h part, then x part,
  // k0 ascending), then dh slabs of layers depth..1 (k0 ascending over N_i).
  int s = 0;
  long long off = 0;
  auto take = [&](int layer, int part, int seg_k, int rows) -> bool {
    for (int k0 = 0; k0 < seg_k; k0 += KS) {
      const long long* e = slabs + 5 * s;
      const int k = seg_k - k0 < KS ? seg_k - k0 : KS;
      if (s >= n_slabs || e[0] != layer || e[1] != part || e[2] != k0 || e[3] != k || e[4] != off)
        return false;
      L->slab_off[s] = (unsigned)off;
      L->slab_info[s] = (unsigned)part | ((unsigned)k0 << 4) | ((unsigned)k << 16);
      L->slab_bytes[s] = (unsigned)(k * rows * 2);
      off += (long long)k * rows * 2;
      ++s;
    }
    return true;
  };
  for (int i = 0; i <= depth; ++i) {
    L->fs0[i] = s;
    if (L->has_h[i] && !take(i, 0, width, L->n[i])) return false;
    if (L->has_x[i] && !take(i, 1, xp, L->n[i])) return false;
  }
  L->fs0[depth + 1] = s;
  for (int i = depth; i >= 1; --i) {
    L->bs_begin[i] = s;
    if (!take(i, 0, L->n[i], width)) return false;
    L->bs_end[i] = s;
  }
  return s == n_slabs && off == stream_bytes && off < (1LL << 32);
}

// ---- Hopper primitives: mbarriers, bulk copies, wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset (between core matrices along K) and stride byte offset
// (between core matrices along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
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
// Bulk copy shared -> global, as one bulk group.
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk stores have read their shared memory / completed.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory -> visible to wgmma and bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier of one consumer warpgroup (named barrier 1 + c, 128 threads).
__device__ __forceinline__ void wg_bar(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// This thread's warpgroup, provably uniform across the warp (so that the
// role branches and setmaxnreg are warp-uniform to the compiler).
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0); }

// Keeps the compiler from moving accumulator reads above a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, N] (+)= A[64, 16] B[16, N], bf16 in, f32 accumulators in the
// m64nNk16 fragment layout: thread t of the warpgroup holds, for each
// 8-column block j, d[4j + 2h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h,
// 8 j + 2 (t % 4) + e]. T = 1 reads both operands MN-major.
template <int N, int T>
struct Wgmma;

template <>
struct Wgmma<16, 0> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<16, 1> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32, 0> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32, 1> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64, 0> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64, 1> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128, 0> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128, 1> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256, 0> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256, 1> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// ---- shared pieces of the forward and backward pass 1 ----

// Element offset of (row r, feature c) in a 64-row core-matrix image.
__device__ __forceinline__ int img_off(int r, int c) {
  return (c >> 3) * (TM * 8) + (r >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

// Feature c of the in-kernel positional encoding of the raw point p [3]:
// [p, sin(p 2^f)..., sin(p 2^f + pi/2)...] for f in [pe_min, pe_max),
// frequency-major and xyz-minor (ops/posenc.py's order). The scale is an
// exact power of two; the phase add rounds in f32 as in both JAX paths;
// sinf is the precise one (arguments reach 2^9 |p|).
__device__ __forceinline__ float posenc_feature(const Net& L, const float* p, int c) {
  if (c < 3) return p[c];
  const int nf = L.pe_max - L.pe_min, j = c - 3;
  const int cos_part = j >= 3 * nf, jj = cos_part ? j - 3 * nf : j;
  float a = ldexpf(p[jj % 3], L.pe_min + jj / 3);
  if (cos_part) a = __fadd_rn(a, 1.57079637f);  // float(pi / 2)
  return sinf(a);
}

// The x tile of rows [row0, row0 + 64) into its image (bf16, zero past
// d_in and past row n): the bf16 [n, d_in] input, or under posenc the
// encoding of the raw f32 [n, 3] points, staged in `pts` (64 x 3 floats)
// first so that no feature waits on a load. A whole bf16 tile is one
// contiguous run of 64 d_in values: it is read as 16-byte vectors. All
// threads of consumer warpgroup c call it.
__device__ void load_x(const Net& L, const void* x, int n, long long row0, bf16* xs, float* pts,
                       int c) {
  const int t = threadIdx.x % 128;
  if (L.pe_on) {
    const float* p = static_cast<const float*>(x) + row0 * 3;
    for (int i = t; i < TM * 3; i += 128) pts[i] = row0 + i / 3 < n ? __ldg(p + i) : 0.0f;
    wg_bar(c);
    for (int idx = t; idx < TM * L.xp; idx += 128) {
      const int r = idx / L.xp, col = idx % L.xp;
      xs[img_off(r, col)] = __float2bfloat16(
          row0 + r < n && col < L.d_in ? posenc_feature(L, pts + r * 3, col) : 0.0f);
    }
    return;
  }
  const bf16* xt = static_cast<const bf16*>(x) + row0 * L.d_in;
  if (row0 + TM <= n && (reinterpret_cast<uintptr_t>(xt) & 15) == 0) {
    for (int v = t; v < TM * L.d_in / 8; v += 128) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(xt) + v);
      const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int idx = 8 * v + k, r = idx / L.d_in;
        xs[img_off(r, idx - r * L.d_in)] = e[k];
      }
    }
    const int pad = L.xp - L.d_in;
    for (int idx = t; idx < TM * pad; idx += 128)
      xs[img_off(idx / pad, L.d_in + idx % pad)] = __float2bfloat16(0.0f);
    return;
  }
  for (int idx = t; idx < TM * L.xp; idx += 128) {
    const int r = idx / L.xp, c = idx % L.xp;
    const long long g = row0 + r;
    bf16 v = __float2bfloat16(0.0f);
    if (g < n && c < L.d_in) v = static_cast<const bf16*>(x)[g * L.d_in + c];
    xs[img_off(r, c)] = v;
  }
}

// The consumers' place in the weight ring.
struct Pipe {
  int stage;
  uint32_t phase;
};

// acc = sum over slabs [s0, s1) of A_part[64, k0:k0+k] W_slab: A is the
// image a_h (part 0) or a_x (part 1), each slab a K-major B image with
// `b_rows` columns (the layer's N). Releases each slab as soon as its
// products are done (wait_group 1 keeps one slab's products in flight).
template <int N>
__device__ __forceinline__ void run_slabs(float (&acc)[N / 2], const Net& L, int s0, int s1,
                                          uint32_t a_h, uint32_t a_x, uint32_t ring,
                                          uint64_t* full, uint64_t* empty, Pipe& p) {
  const uint32_t b_lbo = N * 16;
  const bool leader = threadIdx.x % 128 == 0;
  int prev = -1;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  wg_fence();
  for (int s = s0; s < s1; ++s) {
    const unsigned info = L.slab_info[s];
    const int k0 = (info >> 4) & 0xFFF, ks = info >> 16;
    const uint32_t a = ((info & 15) ? a_x : a_h) + (k0 / 8) * IMG_FSTRIDE;
    const uint32_t b = ring + p.stage * SLAB_BYTES;
    mbar_wait(&full[p.stage], p.phase);
    for (int kk = 0; kk < ks / 16; ++kk)
      Wgmma<N, 0>::mma(acc, make_desc(a + kk * 2 * IMG_FSTRIDE, IMG_FSTRIDE, IMG_RSTRIDE),
                       make_desc(b + kk * 2 * b_lbo, b_lbo, IMG_RSTRIDE), (s > s0 || kk > 0));
    wg_commit();
    wg_wait<1>();
    if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
    prev = p.stage;
    if (++p.stage == NSTAGE) {
      p.stage = 0;
      p.phase ^= 1;
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  if (leader) mbar_arrive(&empty[prev]);
}

// The producer (one thread): streams slabs [a0, a1) then [b0, b1) of the
// weight stream into the ring, once per tile of this block.
__device__ void produce(const Net& L, const unsigned char* stream, long long tiles, int a0,
                        int a1, int b0, int b1, unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int part = 0; part < 2; ++part) {
      for (int s = part ? b0 : a0; s < (part ? b1 : a1); ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], L.slab_bytes[s]);
        bulk_g2s(ring + stage * SLAB_BYTES, stream + L.slab_off[s], L.slab_bytes[s], &full[stage]);
        if (++stage == NSTAGE) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

template <int V>
struct IntC {
  static constexpr int value = V;
};
// f(IntC<N>()) for a layer width N in {16, 32, 64, 128, 256} (make_net
// admits no other).
template <class F>
__device__ __forceinline__ void with_n(int n, F&& f) {
  switch (n) {
    case 16: f(IntC<16>()); break;
    case 32: f(IntC<32>()); break;
    case 64: f(IntC<64>()); break;
    case 128: f(IntC<128>()); break;
    default: f(IntC<256>()); break;
  }
}

// Shared memory of the forward (bwd false) and backward pass-1 kernels: the
// weight ring, then per consumer its activation / cotangent image, its x
// image, its ReLU mask bits, its column-sum scratch and its tile's raw
// points, then the biases and the ring's barriers.
struct Plan {
  int act, xs, mask, red, pts, bias, bars, total, act_bytes, xs_bytes, mask_bytes;
};
__host__ __device__ inline int mask_words(int width) { return width / 64 > 0 ? width / 64 : 1; }
__host__ __device__ inline Plan plan(const Net& L, bool bwd) {
  Plan p;
  const int f = L.width > L.np ? L.width : L.np;
  p.act_bytes = TM * f * 2;
  p.xs_bytes = TM * L.xp * 2;
  p.mask_bytes = bwd ? L.depth * mask_words(L.width) * 128 * 4 : 0;
  int o = NSTAGE * SLAB_BYTES;
  p.act = o;
  o += NCONS * p.act_bytes;
  p.xs = o;
  o += NCONS * p.xs_bytes;
  p.mask = o;
  o += NCONS * p.mask_bytes;
  p.red = o;
  o += bwd ? NCONS * 4 * MAX_N * 4 : 0;
  p.pts = o;
  o += NCONS * TM * 3 * 4;
  p.bias = o;
  o += (L.b_total * 4 + 15) / 16 * 16;
  p.bars = o;
  o += 2 * NSTAGE * 8;
  p.total = o;
  return p;
}

// Forward epilogue of a trunk layer on the accumulators: h = bf16(relu(acc
// + b)) into the image `act`, as bf16 pairs; with `mask`, one bit per value
// at this thread's own fragment positions (mask[w * 128 + t], bit v % 32 of
// word v / 32 for accumulator v) for the backward's ReLU mask.
template <int N>
__device__ __forceinline__ void epi_relu(const float (&acc)[N / 2], const float* b, bf16* act,
                                         uint32_t* mask) {
  const int t = threadIdx.x % 128, r = 16 * (t / 32) + (t % 32) / 4, q = t % 4;
  constexpr int MW = (N / 2 + 31) / 32;
  uint32_t bits[MW];
#pragma unroll
  for (int w = 0; w < MW; ++w) bits[w] = 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 bb = *reinterpret_cast<const float2*>(b + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = 4 * j + 2 * h;
      const __nv_bfloat162 pk = __floats2bfloat162_rn(fmaxf(__fadd_rn(acc[v], bb.x), 0.0f),
                                                      fmaxf(__fadd_rn(acc[v + 1], bb.y), 0.0f));
      *reinterpret_cast<__nv_bfloat162*>(act + img_off(r + 8 * h, c)) = pk;
      bits[v / 32] |= (__bfloat162float(pk.x) > 0.0f ? 1u : 0u) << (v % 32);
      bits[v / 32] |= (__bfloat162float(pk.y) > 0.0f ? 1u : 0u) << ((v + 1) % 32);
    }
  }
  if (mask) {
#pragma unroll
    for (int w = 0; w < MW; ++w) mask[w * 128 + t] = bits[w];
  }
}

// Forward epilogue of the head: acc + b in f32 to sigma / rgb (rows < n);
// with the SH decode, rgb[c] = sum_k coeff[c K + k] basis[k]: this
// thread's products per channel, then a sum over the 4 threads that share
// the row.
template <int N>
__device__ __forceinline__ void epi_head(const Net& L, const float (&acc)[N / 2], const float* b,
                                         long long row0, int n, const float* __restrict__ basis,
                                         float* sigma, float* rgb) {
  const int t = threadIdx.x % 128, r = 16 * (t / 32) + (t % 32) / 4, q = t % 4;
  const int ns = L.n_sigma, K = L.sh_dim;
  float part[2][MAX_RGB];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int cc = 0; cc < MAX_RGB; ++cc) part[h][cc] = 0.0f;
    const long long g = row0 + r + 8 * h;
    if (g >= n) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e;
        if (c >= L.d_out) continue;
        const float v = __fadd_rn(acc[4 * j + 2 * h + e], b[c]);
        if (c < ns) {
          sigma[g * ns + c] = v;
        } else if (!K) {
          rgb[g * L.n_rgb + c - ns] = v;
        } else {
          const int jj = c - ns, ch = jj / K;
          const float pv = __fmul_rn(v, basis[g * K + jj % K]);
#pragma unroll
          for (int cc = 0; cc < MAX_RGB; ++cc)
            if (ch == cc) part[h][cc] = __fadd_rn(part[h][cc], pv);
        }
      }
    }
  }
  if (!K) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int cc = 0; cc < MAX_RGB; ++cc) {
      part[h][cc] = __fadd_rn(part[h][cc], __shfl_xor_sync(0xffffffffu, part[h][cc], 1));
      part[h][cc] = __fadd_rn(part[h][cc], __shfl_xor_sync(0xffffffffu, part[h][cc], 2));
    }
    const long long g = row0 + r + 8 * h;
    if (q == 0 && g < n) {
#pragma unroll
      for (int cc = 0; cc < MAX_RGB; ++cc)
        if (cc < L.n_rgb) rgb[g * L.n_rgb + cc] = part[h][cc];
    }
  }
}

// Backward epilogue of dh = dpre_i W_i^T: dpre_{i-1} = dh * mask in f32,
// as bf16 into the image `act`, and the f32 column sums of the tile's 64
// rows into bpart (each warp's 16 rows by shuffles, then the 4 warps in
// order through `red`).
template <int N>
__device__ __forceinline__ void epi_dpre(const float (&acc)[N / 2], const uint32_t* mask,
                                         bf16* act, float* red, float* bpart, int c) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const int r = 16 * w + l / 4, q = l % 4;
  constexpr int MW = (N / 2 + 31) / 32;
  uint32_t bits[MW];
#pragma unroll
  for (int i = 0; i < MW; ++i) bits[i] = mask[i * 128 + t];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = 4 * j + 2 * h;
      const float d0 = (bits[v / 32] >> (v % 32)) & 1u ? acc[v] : 0.0f;
      const float d1 = (bits[v / 32] >> ((v + 1) % 32)) & 1u ? acc[v + 1] : 0.0f;
      *reinterpret_cast<__nv_bfloat162*>(act + img_off(r + 8 * h, col)) =
          __floats2bfloat162_rn(d0, d1);
      cs0 = __fadd_rn(cs0, d0);
      cs1 = __fadd_rn(cs1, d1);
    }
#pragma unroll
    for (int off = 4; off < 32; off *= 2) {
      cs0 = __fadd_rn(cs0, __shfl_xor_sync(0xffffffffu, cs0, off));
      cs1 = __fadd_rn(cs1, __shfl_xor_sync(0xffffffffu, cs1, off));
    }
    if (l < 4) {
      red[w * MAX_N + col] = cs0;
      red[w * MAX_N + col + 1] = cs1;
    }
  }
  wg_bar(c);
  for (int col = t; col < N; col += 128)
    bpart[col] = __fadd_rn(__fadd_rn(red[col], red[MAX_N + col]),
                           __fadd_rn(red[2 * MAX_N + col], red[3 * MAX_N + col]));
}

// The head's cotangent g = [g_sigma, g_rgb] (with the SH decode the
// coefficients' g_rgb[c] basis[k], in f32), zero past d_out and past row
// n, as bf16 into the image `act`, and its f32 column sums into bpart.
__device__ void head_cotangent(const Net& L, bf16* act, float* red, const float* g_sigma,
                               const float* g_rgb, const float* basis, long long row0, int n,
                               float* bpart, int c) {
  const int t = threadIdx.x % 128, np = L.np, ns = L.n_sigma, K = L.sh_dim;
  const int rg = np >= 128 ? 1 : 128 / np;  // row groups summed apart, then in order
  for (int e = t; e < np * rg; e += 128) {
    const int col = e % np, g0 = e / np, jj = col - ns;
    float s = 0.0f;
    for (int r0 = g0; r0 < TM; r0 += 8 * rg) {
      float v[8];  // eight rows' loads in flight at once
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u * rg;
        const long long g = row0 + r;
        v[u] = 0.0f;
        if (r < TM && g < n && col < L.d_out) {
          if (col < ns)
            v[u] = g_sigma[g * ns + col];
          else if (!K)
            v[u] = g_rgb[g * L.n_rgb + jj];
          else
            v[u] = __fmul_rn(g_rgb[g * L.n_rgb + jj / K], basis[g * K + jj % K]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u * rg;
        if (r < TM) {
          s = __fadd_rn(s, v[u]);
          act[img_off(r, col)] = __float2bfloat16(v[u]);
        }
      }
    }
    red[g0 * np + col] = s;
  }
  wg_bar(c);
  for (int col = t; col < np; col += 128) {
    float s = 0.0f;
    for (int g0 = 0; g0 < rg; ++g0) s = __fadd_rn(s, red[g0 * np + col]);
    bpart[col] = s;
  }
}

// Common start of the ring kernels: biases into shared memory, barriers.
__device__ __forceinline__ void ring_setup(const Net& L, const Plan& P, unsigned char* smem,
                                           const float* bias) {
  float* bias_s = reinterpret_cast<float*>(smem + P.bias);
  for (int i = threadIdx.x; i < L.b_total; i += NTHREADS) bias_s[i] = bias[i];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P.bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[NSTAGE + s], NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS, 1)
    fwd_kernel(const __grid_constant__ Net L, const void* __restrict__ x,
               const float* __restrict__ basis, const unsigned char* __restrict__ stream,
               const float* __restrict__ bias, float* sigma, float* rgb, int n, long long tiles) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Plan P = plan(L, false);
  ring_setup(L, P, smem, bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P.bars);
  uint64_t* empty = full + NSTAGE;
  const int wg = warpgroup();
  if (wg == NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NCONS * 128)
      produce(L, stream, tiles, 0, L.fs0[L.depth + 1], 0, 0, smem, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg;
  bf16* act = reinterpret_cast<bf16*>(smem + P.act + c * P.act_bytes);
  bf16* xs = reinterpret_cast<bf16*>(smem + P.xs + c * P.xs_bytes);
  float* pts = reinterpret_cast<float*>(smem + P.pts) + c * TM * 3;
  const float* bias_s = reinterpret_cast<const float*>(smem + P.bias);
  const uint32_t ring = smem_u32(smem);
  Pipe p{0, 0};
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = (t * NCONS + c) * TM;
    load_x(L, x, n, row0, xs, pts, c);
    fence_proxy_async();
    wg_bar(c);
    for (int i = 0; i <= L.depth; ++i) {
      with_n(L.n[i], [&](auto nn) {
        constexpr int N = decltype(nn)::value;
        float acc[N / 2];
        run_slabs<N>(acc, L, L.fs0[i], L.fs0[i + 1], smem_u32(act), smem_u32(xs), ring, full,
                     empty, p);
        wg_bar(c);  // every warp's products are done: act may be overwritten
        if (i < L.depth) {
          epi_relu<N>(acc, bias_s + L.b_off[i], act, nullptr);
          fence_proxy_async();
          wg_bar(c);
        } else {
          epi_head<N>(L, acc, bias_s + L.b_off[i], row0, n, basis, sigma, rgb);
        }
      });
    }
  }
}

// Workspace of one backward chunk (tiles 64-row tiles, a multiple of
// NCONS): each tile's images, the bias partials and the pass-2 partials.
struct Ws {
  bf16* acts;        // layer i < depth: [tiles][64 x width] images at i * tiles * 64 * width
  bf16* x;           // [tiles][64 x xp]
  bf16* dpre;        // layer i at dpre_off[i]: [tiles][64 x N_i]
  float* bias_part;  // [tiles][b_total]
  float* part;       // [splits][w_total]
  long long dpre_off[MAX_LAYERS];
  int tiles, splits;
};

// Pass 1: per 64-row tile, the x image, the recompute, the head cotangent
// and the reverse walk; see the file comment.
__global__ void __launch_bounds__(NTHREADS, 1)
    bwd_rows_kernel(const __grid_constant__ Net L, const __grid_constant__ Ws W,
                    const void* __restrict__ x, const float* __restrict__ basis,
                    const unsigned char* __restrict__ stream, const float* __restrict__ bias,
                    const float* __restrict__ g_sigma, const float* __restrict__ g_rgb, int n,
                    long long row_base) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Plan P = plan(L, true);
  ring_setup(L, P, smem, bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P.bars);
  uint64_t* empty = full + NSTAGE;
  const long long pairs = W.tiles / NCONS;
  const int wg = warpgroup();
  if (wg == NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NCONS * 128)
      produce(L, stream, pairs, 0, L.fs0[L.depth], L.bs_begin[L.depth], L.bs_end[1], smem,
              full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg;
  const bool leader = threadIdx.x % 128 == 0;
  bf16* act = reinterpret_cast<bf16*>(smem + P.act + c * P.act_bytes);
  bf16* xs = reinterpret_cast<bf16*>(smem + P.xs + c * P.xs_bytes);
  float* pts = reinterpret_cast<float*>(smem + P.pts) + c * TM * 3;
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + P.mask + c * P.mask_bytes);
  float* red = reinterpret_cast<float*>(smem + P.red) + c * 4 * MAX_N;
  const float* bias_s = reinterpret_cast<const float*>(smem + P.bias);
  const uint32_t ring = smem_u32(smem);
  const int mw = mask_words(L.width);
  Pipe p{0, 0};
  for (long long t = blockIdx.x; t < pairs; t += gridDim.x) {
    const long long lt = t * NCONS + c;  // this consumer's tile in the chunk
    const long long row0 = row_base + lt * TM;
    float* bpart = W.bias_part + lt * L.b_total;
    if (leader) bulk_wait_read();  // the last tile's stores have read xs and act
    wg_bar(c);
    load_x(L, x, n, row0, xs, pts, c);
    fence_proxy_async();
    wg_bar(c);
    if (leader) bulk_s2g(W.x + lt * TM * L.xp, xs, TM * L.xp * 2);
    with_n(L.width, [&](auto nn) {
      constexpr int N = decltype(nn)::value;
      for (int i = 0; i < L.depth; ++i) {  // recompute, saving each activation
        float acc[N / 2];
        run_slabs<N>(acc, L, L.fs0[i], L.fs0[i + 1], smem_u32(act), smem_u32(xs), ring, full,
                     empty, p);
        if (leader) bulk_wait_read();
        wg_bar(c);
        epi_relu<N>(acc, bias_s + L.b_off[i], act, mask + i * mw * 128);
        fence_proxy_async();
        wg_bar(c);
        if (leader)
          bulk_s2g(W.acts + ((long long)i * W.tiles + lt) * TM * L.width, act, TM * L.width * 2);
      }
      if (leader) bulk_wait_read();
      wg_bar(c);
      head_cotangent(L, act, red, g_sigma, g_rgb, basis, row0, n, bpart + L.b_off[L.depth], c);
      fence_proxy_async();
      wg_bar(c);
      if (leader) bulk_s2g(W.dpre + W.dpre_off[L.depth] + lt * TM * L.np, act, TM * L.np * 2);
      for (int i = L.depth; i >= 1; --i) {  // dh = dpre_i W_i^T, then dpre_{i-1}
        float acc[N / 2];
        run_slabs<N>(acc, L, L.bs_begin[i], L.bs_end[i], smem_u32(act), smem_u32(act), ring,
                     full, empty, p);
        if (leader) bulk_wait_read();
        wg_bar(c);
        epi_dpre<N>(acc, mask + (i - 1) * mw * 128, act, red, bpart + L.b_off[i - 1], c);
        fence_proxy_async();
        wg_bar(c);
        if (leader)
          bulk_s2g(W.dpre + W.dpre_off[i - 1] + lt * TM * L.width, act, TM * L.width * 2);
      }
    });
  }
  if (leader) bulk_wait_all();
}

// Pass 2 work items: dW_i[m0 : m0 + mcount, :] of one K segment (seg 0:
// the h rows, fed by the activations of layer i - 1; seg 1: the x rows).
struct Items {
  int n_items;
  int layer[MAX_ITEMS], seg[MAX_ITEMS], m0[MAX_ITEMS], mcount[MAX_ITEMS];
};

// Pass-2 operands are read MN-major from the tile images: features along
// M (A) and N (B) in 8-blocks 1 KB apart, rows along K in 8-blocks 128 B
// apart.
constexpr uint32_t P2_LBO = IMG_RSTRIDE;
constexpr uint32_t P2_SBO = IMG_FSTRIDE;

template <int N>
__device__ __forceinline__ void atb_consume(const Net& L, const Ws& W, int li, int seg, int m0,
                                            int mcount, int t0, int t1, unsigned char* smem,
                                            uint64_t* full, uint64_t* empty, int c) {
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const bool leader = threadIdx.x % 128 == 0;
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  fence_acc(acc);
  wg_fence();
  for (int lt = t0; lt < t1; ++lt) {
    mbar_wait(&full[stage], phase);
    const uint32_t a = smem_u32(smem + stage * P2_STAGE) + c * (TM * TM * 2);
    const uint32_t b = smem_u32(smem + stage * P2_STAGE + P2_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk)
      Wgmma<N, 1>::mma(acc, make_desc(a + kk * 2 * IMG_RSTRIDE, P2_LBO, P2_SBO),
                       make_desc(b + kk * 2 * IMG_RSTRIDE, P2_LBO, P2_SBO), (lt > t0 || kk > 0));
    wg_commit();
    wg_wait<1>();
    if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == P2_NSTAGE) {
      stage = 0;
      phase ^= 1;
    }
  }
  wg_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
  const int t = threadIdx.x % 128, r = 16 * (t / 32) + (t % 32) / 4, q = t % 4;
  const int koff = seg && L.has_h[li] ? L.width : 0;
  float* out = W.part + (long long)blockIdx.y * L.w_total + L.w_off[li];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = TM * c + r + 8 * h;  // feature row within the item
    if (f >= mcount) continue;
    float* row = out + (long long)(koff + m0 + f) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * q) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// Pass 2: block (item, split) sums In^T dpre over the split's tiles into
// its partial; see the file comment.
__global__ void __launch_bounds__(NTHREADS, 1)
    atb_kernel(const __grid_constant__ Net L, const __grid_constant__ Ws W,
               const __grid_constant__ Items I) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int item = blockIdx.x, li = I.layer[item], seg = I.seg[item];
  const int m0 = I.m0[item], mcount = I.mcount[item], N = L.n[li];
  const int active = (mcount + TM - 1) / TM;  // consumers with features
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P2_NSTAGE * P2_STAGE);
  uint64_t* empty = full + P2_NSTAGE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P2_NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int t0 = (int)((long long)W.tiles * blockIdx.y / W.splits);
  const int t1 = (int)((long long)W.tiles * (blockIdx.y + 1) / W.splits);
  const int wg = warpgroup();
  if (wg == NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != NCONS * 128) return;
    const int kf = seg ? L.xp : L.width;  // features of the A images
    const bf16* a_src = (seg ? W.x : W.acts + (long long)(li - 1) * W.tiles * TM * L.width) +
                        (long long)m0 * TM;
    const bf16* b_src = W.dpre + W.dpre_off[li];
    const uint32_t a_bytes = mcount * TM * 2, b_bytes = N * TM * 2;
    int stage = 0;
    uint32_t phase = 0;
    for (int lt = t0; lt < t1; ++lt) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], a_bytes + b_bytes);
      unsigned char* dst = smem + stage * P2_STAGE;
      bulk_g2s(dst, a_src + (long long)lt * TM * kf, a_bytes, &full[stage]);
      bulk_g2s(dst + P2_A_BYTES, b_src + (long long)lt * TM * N, b_bytes, &full[stage]);
      if (++stage == P2_NSTAGE) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  if (wg >= active) return;
  with_n(N, [&](auto nn) {
    atb_consume<decltype(nn)::value>(L, W, li, seg, m0, mcount, t0, t1, smem, full, empty, wg);
  });
}

// out[c] += sum_{s < S} in[s * C + c], in a fixed order: for few rows one
// thread per column walks them in order; for many, 32 threads per column
// take every 32nd row and a tree adds their sums.
__global__ void colsum_rows_kernel(const float* __restrict__ in, int S, long long C,
                                   float* out) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += in[(long long)s * C + c];
  out[c] += acc;
}

__global__ void colsum_kernel(const float* __restrict__ in, int S, long long C, float* out) {
  __shared__ float red[32][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (c < C)
    for (int s = threadIdx.y; s < S; s += 32) acc += in[(long long)s * C + c];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.0f;
    for (int y = 0; y < 32; ++y) t += red[y][threadIdx.x];
    out[c] += t;
  }
}

#define PN_CHECK_LAUNCH()                  \
  do {                                     \
    cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

int colsum(const float* in, int S, long long C, float* out, cudaStream_t st) {
  if (S <= 64)
    colsum_rows_kernel<<<(unsigned)((C + 255) / 256), 256, 0, st>>>(in, S, C, out);
  else
    colsum_kernel<<<(unsigned)((C + 31) / 32), dim3(32, 32), 0, st>>>(in, S, C, out);
  PN_CHECK_LAUNCH();
  return 0;
}

int num_sms() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || v < 1)
    return 1;
  return v;
}

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// The pass-2 items of a layout: each K segment in blocks of 2 x 64 features.
bool make_items(const Net& L, Items* I) {
  *I = Items();
  int k = 0;
  for (int i = 0; i <= L.depth; ++i) {
    for (int seg = 0; seg < 2; ++seg) {
      if (!(seg ? L.has_x[i] : L.has_h[i])) continue;
      const int kf = seg ? L.xp : L.width;
      for (int m0 = 0; m0 < kf; m0 += NCONS * TM) {
        if (k >= MAX_ITEMS) return false;
        I->layer[k] = i;
        I->seg[k] = seg;
        I->m0[k] = m0;
        I->mcount[k] = kf - m0 < NCONS * TM ? kf - m0 : NCONS * TM;
        ++k;
      }
    }
  }
  I->n_items = k;
  return true;
}

// Splits of the rows in pass 2: about four blocks per SM over all items
// (items differ in cost, so finer blocks shorten the last wave).
int max_splits(const Net& L, const Items& I, int tiles) {
  const int s = (4 * num_sms() + I.n_items - 1) / I.n_items;
  return s < 1 ? 1 : (s > tiles ? tiles : s);
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// Carves a chunk workspace of `tiles` 64-row tiles and `splits` pass-2
// splits out of base (or only sizes it, base null).
size_t carve(const Net& L, int tiles, int splits, unsigned char* base, Ws* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  Ws w = Ws();
  const size_t rows = (size_t)tiles * TM;
  w.acts = reinterpret_cast<bf16*>(take(2 * (size_t)L.depth * rows * L.width));
  w.x = reinterpret_cast<bf16*>(take(2 * rows * L.xp));
  size_t d = 0;
  for (int i = 0; i <= L.depth; ++i) {
    w.dpre_off[i] = (long long)d;
    d += rows * L.n[i];
  }
  w.dpre = reinterpret_cast<bf16*>(take(2 * d));
  w.bias_part = reinterpret_cast<float*>(take(4 * (size_t)tiles * L.b_total));
  w.part = reinterpret_cast<float*>(take(4 * (size_t)splits * L.w_total));
  w.tiles = tiles;
  w.splits = splits;
  if (ws) *ws = w;
  return off;
}

int chunk_tiles(int n) {
  return (int)(round_up(n < CHUNK_ROWS ? n : CHUNK_ROWS, NCONS * TM) / TM);
}

}  // namespace

extern "C" {

// `desc`, `n_layers`: the per-layer descriptor; `slabs`, `n_slabs`,
// `stream_bytes`: the weight stream's slab table (make_net). `pe_on`,
// `pe_min`, `pe_max`: the in-kernel posenc (x is then f32 [n, 3], else
// bf16 [n, d_in]); `sh_dim`: the SH decode against `basis` (f32
// [n, sh_dim]; else unused). `w` is the packed weight stream, `b` the
// packed f32 biases.
int pn_fused_mlp_fwd(const void* x, const float* basis, const void* w, const float* b,
                     float* sigma, float* rgb, int n, const long long* desc, int n_layers,
                     int d_in, int d_out, int n_sigma, int pe_on, int pe_min, int pe_max,
                     int sh_dim, const long long* slabs, int n_slabs, long long stream_bytes,
                     void* stream) {
  Net L;
  if (!make_net(&L, desc, n_layers, d_in, d_out, n_sigma, pe_on, pe_min, pe_max, sh_dim, slabs,
                n_slabs, stream_bytes))
    return (int)cudaErrorInvalidValue;
  const Plan P = plan(L, false);
  if (P.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaError_t e =
      cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.total);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + NCONS * TM - 1) / (NCONS * TM);
  const int grid = (int)(tiles < num_sms() ? tiles : num_sms());
  fwd_kernel<<<grid, NTHREADS, P.total, (cudaStream_t)stream>>>(
      L, x, basis, static_cast<const unsigned char*>(w), b, sigma, rgb, n, tiles);
  PN_CHECK_LAUNCH();
  return 0;
}

size_t pn_fused_mlp_bwd_workspace_bytes(int n, const long long* desc, int n_layers, int d_in,
                                        int d_out, int n_sigma, int pe_on, int pe_min,
                                        int pe_max, int sh_dim, const long long* slabs,
                                        int n_slabs, long long stream_bytes) {
  Net L;
  Items I;
  if (n <= 0 ||
      !make_net(&L, desc, n_layers, d_in, d_out, n_sigma, pe_on, pe_min, pe_max, sh_dim, slabs,
                n_slabs, stream_bytes) ||
      !make_items(L, &I))
    return 0;
  const int tiles = chunk_tiles(n);
  return carve(L, tiles, max_splits(L, I, tiles), nullptr, nullptr);
}

// dw (f32, [K_i, N_i] per layer at w_off) and db (f32) are added to, so the
// caller zeroes them. workspace holds pn_fused_mlp_bwd_workspace_bytes(...)
// bytes.
int pn_fused_mlp_bwd(const void* x, const float* basis, const void* w, const float* b,
                     const float* g_sigma, const float* g_rgb, float* dw, float* db,
                     void* workspace, int n, const long long* desc, int n_layers, int d_in,
                     int d_out, int n_sigma, int pe_on, int pe_min, int pe_max, int sh_dim,
                     const long long* slabs, int n_slabs, long long stream_bytes, void* stream) {
  Net L;
  Items I;
  if (!make_net(&L, desc, n_layers, d_in, d_out, n_sigma, pe_on, pe_min, pe_max, sh_dim, slabs,
                n_slabs, stream_bytes) ||
      !make_items(L, &I))
    return (int)cudaErrorInvalidValue;
  const Plan P = plan(L, true);
  if (P.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int ws_tiles = chunk_tiles(n), ws_splits = max_splits(L, I, ws_tiles);
  Ws ws;
  carve(L, ws_tiles, ws_splits, static_cast<unsigned char*>(workspace), &ws);
  const int p2_smem = P2_NSTAGE * P2_STAGE + 2 * P2_NSTAGE * 8;
  cudaError_t e =
      cudaFuncSetAttribute(bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.total);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(atb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p2_smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned char* wb = static_cast<const unsigned char*>(w);
  for (long long base = 0; base < n; base += (long long)ws_tiles * TM) {
    Ws wc = ws;
    wc.tiles = chunk_tiles((int)(n - base < ws_tiles * TM ? n - base : ws_tiles * TM));
    wc.splits = ws_splits < wc.tiles ? ws_splits : wc.tiles;
    const int pairs = wc.tiles / NCONS;
    bwd_rows_kernel<<<pairs < num_sms() ? pairs : num_sms(), NTHREADS, P.total, st>>>(
        L, wc, x, basis, wb, b, g_sigma, g_rgb, n, base);
    PN_CHECK_LAUNCH();
    int rc = colsum(wc.bias_part, wc.tiles, L.b_total, db, st);
    if (rc) return rc;
    atb_kernel<<<dim3(I.n_items, wc.splits), NTHREADS, p2_smem, st>>>(L, wc, I);
    PN_CHECK_LAUNCH();
    rc = colsum(wc.part, wc.splits, L.w_total, dw, st);
    if (rc) return rc;
  }
  return 0;
}

const char* pn_fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
