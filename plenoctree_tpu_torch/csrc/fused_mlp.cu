// Fused NeRF trunk MLP on Hopper: forward and backward, bf16 tensor cores.
//
// Replaces the Pallas TPU kernels of plenoctree_tpu/kernels/fused_mlp.py:
// _make_fwd_kernel (launched from _pallas_fwd) and _make_bwd_kernel
// (launched from _pallas_bwd), default variant (no in-kernel posenc, no
// in-kernel SH decode). Same function: depth ReLU layers of `width`, a skip
// concat [h, x] after layer i when i % skip == 0 and i > 0, and one fused
// [K, 1 + C*K_sh] sigma/rgb head; bf16 operands with f32 accumulation, bias
// add and ReLU in f32, bf16 activations between layers, the head in f32.
// The backward recomputes the forward, walks the layers in reverse with
// bf16 cotangents in every product (_dot_tn / _dot_nt) and returns f32
// weight and bias gradients; no input gradients.
//
// What bounds it on an H100: the tensor cores. Per row the trunk is
// 2 * 503,552 FLOP (8x256, d_in 63, head 49); the training step pushes
// about 1.06M rows through it, so ~1.07 TFLOP forward and ~4.3 TFLOP with
// the backward's recompute and its two products per layer: ~4.3 ms at
// 989 TFLOP/s (bf16 dense). Activations never round-trip device memory in
// the forward; the backward writes each layer's input and cotangent once
// (bf16) for the weight-gradient products.
//
// Design (a simple kernel that is right; no wgmma or TMA yet):
//  * Forward: one block of 8 warps per 64-row tile. The tile's activation
//    lives in shared memory as bf16 [64, width] and is updated in place
//    (all warps finish reading a layer's input, sync, then write its
//    output). The encoded input x sits beside it, zero-padded to a multiple
//    of 16 columns, so a skip layer reads [h, x] as two K segments of one
//    product and no concat is materialised. Weights stay in device memory
//    (one MLP is ~1 MB of bf16, L2-resident) and are staged through shared
//    memory in 32-row slabs, double-buffered, with 16-byte cp.async copies
//    by the whole block.
//    Products are nvcuda::wmma 16x16x16 bf16 with f32 accumulators; each
//    warp owns up to two 16-column tiles of all four 16-row tiles. The
//    ragged last tile is masked in the kernel: rows past n read x = 0 and
//    write nothing.
//  * Backward, pass 1 (row-parallel): per 64-row tile, recompute the
//    forward and store each layer's bf16 activation to a workspace; load
//    g = [g_sigma, g_rgb] as bf16, then for each layer in reverse compute
//    dh = g_bf16 @ W_h^T (h-part rows only: the x part needs no gradient),
//    dpre = dh * (act > 0) in f32, store it as bf16, and write per-tile f32
//    column sums of dpre (the bias-gradient partials). At most 131,072 rows
//    go through one launch (~1.1 GB of workspace at width 256).
//  * Backward, pass 2: dW_i = In_i^T @ dpre_i per layer and K segment as a
//    split-K product over rows (64x64 output tiles, 1024-row splits, both
//    operands double-buffered through shared memory 64 rows at a time) into f32
//    partials, then a fixed-order reduction adds the partials to dW.
//    No atomics: results are bitwise identical from run to run.
//
// Packed layout (kernels/fused_mlp.py::_layout is its one definition and
// hands it to every entry point as a per-layer descriptor): layer i (the
// head is layer `depth`) has K_i = (i > 0 ? width : 0) + (has_x ? xp : 0)
// rows, h rows first, then x rows (d_in real, zero to xp), and N_i = width
// (head: np = d_out rounded up to 16, zero columns). Weights bf16 [K_i, N_i]
// row-major, biases f32 [N_i], layers back to back. Gradients come back in
// the same layout, in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

constexpr int TM = 64;                         // rows per tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXJ = 2;                        // 16-column tiles per warp
constexpr int MAX_N = NWARPS * MAXJ * 16;      // 256: widest layer output
constexpr int MAX_LAYERS = 17;                 // trunk layers + head
constexpr int CHUNK_ROWS = 131072;             // rows per backward launch
constexpr int ROWS_PER_SPLIT = 1024;           // pass-2 split-K depth

struct Layout {
  int depth, width, d_in, xp, d_out, np, n_sigma, lda, ldx;
  int has_h[MAX_LAYERS], has_x[MAX_LAYERS], k[MAX_LAYERS], n[MAX_LAYERS];
  long long w_off[MAX_LAYERS];
  int b_off[MAX_LAYERS];
  int b_total;
};

// Reads the wrapper's layer descriptor, 5 values per layer (h rows, x rows,
// N, w_off, b_off), and checks that the kernels can take it: layer 0 reads
// x only, every later layer reads the width-wide h (and maybe x), trunk
// layers are `width` wide, all widths are multiples of 16 up to MAX_N, and
// the layers lie back to back.
bool make_layout(Layout* L, const long long* desc, int n_layers, int d_in, int d_out,
                 int n_sigma) {
  if (n_layers < 2 || n_layers > MAX_LAYERS) return false;
  const int depth = n_layers - 1, width = (int)desc[2], xp = (int)desc[1];
  const int np = (int)desc[5 * depth + 2];
  if (width < 16 || width > MAX_N || width % 16 || xp < d_in || xp > MAX_N || xp % 16 ||
      d_in < 1 || np < d_out || np > MAX_N || np % 16 || n_sigma < 1 || n_sigma > d_out)
    return false;
  L->depth = depth;
  L->width = width;
  L->d_in = d_in;
  L->xp = xp;
  L->d_out = d_out;
  L->np = np;
  L->n_sigma = n_sigma;
  L->lda = (width > np ? width : np) + 8;  // +8 bf16: stagger banks
  L->ldx = xp + 8;
  long long w = 0;
  int b = 0;
  for (int i = 0; i <= depth; ++i) {
    const long long* d = desc + 5 * i;
    const int k_h = (int)d[0], k_x = (int)d[1], n = (int)d[2];
    if (k_h != (i > 0 ? width : 0) || (k_x != 0 && k_x != xp) || (i == 0 && k_x == 0) ||
        n != (i < depth ? width : np) || d[3] != w || d[4] != b)
      return false;
    L->has_h[i] = k_h > 0;
    L->has_x[i] = k_x > 0;
    L->k[i] = k_h + k_x;
    L->n[i] = n;
    L->w_off[i] = w;
    L->b_off[i] = b;
    w += (long long)L->k[i] * n;
    b += n;
  }
  L->b_total = b;
  return true;
}

constexpr int KS = 32;  // weight rows (K) per staged slab
constexpr int WS_ELEMS = (KS * (MAX_N + 8) > MAX_N * (KS + 8)) ? KS * (MAX_N + 8)
                                                               : MAX_N * (KS + 8);

size_t smem_bytes(const Layout& L) {  // activation, x, two weight slabs, scratch
  return sizeof(bf16) * ((size_t)TM * (L.lda + L.ldx) + 2 * WS_ELEMS) +
         sizeof(float) * NWARPS * 256;
}

// 16-byte asynchronous copy global -> shared (sm_80+), and its group fences.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of weight rows [k0, k0 + kslab) (TRANS: weight columns) of
// the block W into slab buffer `ws`; see mma_tiles.
template <bool TRANS>
__device__ __forceinline__ void stage_slab(bf16* ws, const bf16* __restrict__ W, int ldw,
                                           int k0, int kslab, int ncols) {
  if (!TRANS) {  // ws[k][c] = W[k0 + k][c], row stride ncols + 8
    const int vpr = ncols / 8;
    for (int v = threadIdx.x; v < kslab * vpr; v += NTHREADS) {
      const int k = v / vpr, c = (v % vpr) * 8;
      cp_async16(ws + k * (ncols + 8) + c, W + (size_t)(k0 + k) * ldw + c);
    }
  } else {  // ws[c][k] = W[c][k0 + k], row stride KS + 8
    const int vpr = kslab / 8;
    for (int v = threadIdx.x; v < ncols * vpr; v += NTHREADS) {
      const int c = v / vpr, k = (v % vpr) * 8;
      cp_async16(ws + c * (KS + 8) + k, W + (size_t)c * ldw + k0 + k);
    }
  }
  cp_async_commit();
}

// acc[r][j] += A[16r.., 0:K] @ B[0:K, 16*(warp + 8j)..] for this warp's tiles,
// with A row-major bf16 in shared memory and B a weight block in device
// memory: B = W [K, N] row-major (TRANS false), or B = W^T for a row-major
// W [nct*16.., ldw] (TRANS true: B[j][c] = W[c][j]). Every warp of the block
// must call it: K-slabs of KS weight rows go through two shared-memory
// buffers (`ws`, 2 * WS_ELEMS) with 16-byte cp.async copies by all threads;
// slab s + 1 is in flight while the warps multiply slab s.
template <bool TRANS>
__device__ __forceinline__ void mma_tiles(Acc (&acc)[4][MAXJ], const bf16* A, int lda,
                                          const bf16* __restrict__ W, int ldw, int K, int nct,
                                          bf16* ws) {
  const int warp = threadIdx.x / 32;
  const int ncols = nct * 16;
  stage_slab<TRANS>(ws, W, ldw, 0, min(KS, K), ncols);
  for (int k0 = 0, s = 0; k0 < K; k0 += KS, ++s) {
    const int kslab = min(KS, K - k0);  // a multiple of 16
    const bf16* cur = ws + (s & 1) * WS_ELEMS;
    if (k0 + KS < K) {
      // The other buffer was last read before the previous iteration's
      // closing sync, so it is free to fill.
      stage_slab<TRANS>(ws + ((s + 1) & 1) * WS_ELEMS, W, ldw, k0 + KS, min(KS, K - k0 - KS),
                        ncols);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp < nct) {
      for (int kk = 0; kk < kslab; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wmma::load_matrix_sync(a[r], A + r * 16 * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          const int ct = warp + j * NWARPS;
          if (ct < nct) {
            if (!TRANS) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
              wmma::load_matrix_sync(b, cur + kk * (ncols + 8) + ct * 16, ncols + 8);
#pragma unroll
              for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[r][j], a[r], b, acc[r][j]);
            } else {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
              wmma::load_matrix_sync(b, cur + ct * 16 * (KS + 8) + kk, KS + 8);
#pragma unroll
              for (int r = 0; r < 4; ++r) wmma::mma_sync(acc[r][j], a[r], b, acc[r][j]);
            }
          }
        }
      }
    }
    __syncthreads();  // the slab is consumed before the next one overwrites it
  }
}

__device__ __forceinline__ void zero_acc(Acc (&acc)[4][MAXJ]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) wmma::fill_fragment(acc[r][j], 0.0f);
}

// x tile -> shared memory (bf16, zero past d_in and past row n); optionally
// also to the workspace copy that pass 2 reads.
__device__ void load_x_tile(const Layout& L, const bf16* x, int n, long long row0, bf16* xs,
                            bf16* ws_x) {
  const bf16 zero = __float2bfloat16(0.0f);
  for (int idx = threadIdx.x; idx < TM * L.xp; idx += NTHREADS) {
    const int r = idx / L.xp, c = idx % L.xp;
    const long long row = row0 + r;
    const bf16 v = (row < n && c < L.d_in) ? x[row * L.d_in + c] : zero;
    xs[r * L.ldx + c] = v;
    if (ws_x) ws_x[(size_t)r * L.xp + c] = v;
  }
}

// Trunk layers 0..n_layers-1 on the tile in `act` (in place), reading x
// from `xs`. Saves each layer's bf16 activation to ws_acts (layer stride
// ws_stride rows) when given. With n_layers == depth + 1 the last is the
// head, written to sigma/rgb (f32, rows < n only).
__device__ void forward_layers(const Layout& L, const bf16* __restrict__ W,
                               const float* __restrict__ bias, bf16* act, const bf16* xs,
                               float* scr, bf16* wslab, int n_layers, bf16* ws_acts,
                               size_t ws_stride, int n, long long row0, float* sigma,
                               float* rgb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < n_layers; ++i) {
    const int N = L.n[i], nct = N / 16;
    const bf16* Wi = W + L.w_off[i];
    Acc acc[4][MAXJ];
    zero_acc(acc);
    int koff = 0;
    if (L.has_h[i]) {
      mma_tiles<false>(acc, act, L.lda, Wi, N, L.width, nct, wslab);
      koff = L.width;
    }
    if (L.has_x[i]) mma_tiles<false>(acc, xs, L.ldx, Wi + (size_t)koff * N, N, L.xp, nct, wslab);
    // (mma_tiles ended in a sync: every warp is done reading this layer's input)
    const float* bi = bias + L.b_off[i];
    const bool head = i == L.depth;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int ct = warp + j * NWARPS;
      if (ct >= nct) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wmma::store_matrix_sync(scr, acc[r][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = r * 16 + (e >> 4), col = ct * 16 + (e & 15);
          const float v = scr[e] + bi[col];
          if (!head) {
            const bf16 h = __float2bfloat16(fmaxf(v, 0.0f));
            act[row * L.lda + col] = h;
            if (ws_acts) ws_acts[(size_t)i * ws_stride * L.width + (size_t)row * L.width + col] = h;
          } else if (row0 + row < n && col < L.d_out) {
            const long long g = row0 + row;
            if (col < L.n_sigma)
              sigma[g * L.n_sigma + col] = v;
            else
              rgb[g * (L.d_out - L.n_sigma) + col - L.n_sigma] = v;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();  // act now holds this layer's output
  }
}

__global__ void __launch_bounds__(NTHREADS) fwd_kernel(Layout L, const bf16* __restrict__ x,
                                                       const bf16* __restrict__ W,
                                                       const float* __restrict__ bias,
                                                       float* sigma, float* rgb, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* xs = act + TM * L.lda;
  bf16* wslab = xs + TM * L.ldx;
  float* scr = reinterpret_cast<float*>(wslab + 2 * WS_ELEMS) + (threadIdx.x / 32) * 256;
  const long long row0 = (long long)blockIdx.x * TM;
  load_x_tile(L, x, n, row0, xs, nullptr);
  __syncthreads();
  forward_layers(L, W, bias, act, xs, scr, wslab, L.depth + 1, nullptr, 0, n, row0, sigma,
                 rgb);
}

// Workspace of one backward chunk (rows = CHUNK_ROWS or fewer, a multiple
// of TM): activations, the padded x copy, cotangents, bias partials and
// pass-2 partials, each 256-byte aligned.
struct Workspace {
  bf16* acts;       // [depth][rows][width]
  bf16* x;          // [rows][xp]
  bf16* dpre;       // layer i at dpre_off[i]: [rows][N_i]
  float* bias_part; // [rows / TM][b_total]
  float* part;      // [splits][max K_seg * N]
  size_t dpre_off[MAX_LAYERS];
};

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

size_t carve(const Layout& L, int rows, unsigned char* base, Workspace* ws) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  Workspace w;
  w.acts = reinterpret_cast<bf16*>(take(sizeof(bf16) * (size_t)L.depth * rows * L.width));
  w.x = reinterpret_cast<bf16*>(take(sizeof(bf16) * (size_t)rows * L.xp));
  size_t d = 0;
  for (int i = 0; i <= L.depth; ++i) {
    w.dpre_off[i] = d;
    d += (size_t)rows * L.n[i];
  }
  w.dpre = reinterpret_cast<bf16*>(take(sizeof(bf16) * d));
  w.bias_part = reinterpret_cast<float*>(take(sizeof(float) * (size_t)(rows / TM) * L.b_total));
  size_t seg = 0;
  for (int i = 0; i <= L.depth; ++i) {
    const size_t s = (size_t)(L.has_h[i] ? L.width : L.xp) * L.n[i];
    const size_t sx = (size_t)L.xp * L.n[i];
    seg = s > seg ? s : seg;
    seg = sx > seg ? sx : seg;
  }
  const int splits = (rows + ROWS_PER_SPLIT - 1) / ROWS_PER_SPLIT;
  w.part = reinterpret_cast<float*>(take(sizeof(float) * (size_t)splits * seg));
  if (ws) *ws = w;
  return off;
}

// Pass 1: recompute, then walk the layers back; see the file comment.
__global__ void __launch_bounds__(NTHREADS) bwd_rows_kernel(
    Layout L, const bf16* __restrict__ x, const bf16* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ g_sigma,
    const float* __restrict__ g_rgb, int n, long long row_base, int ws_rows, Workspace ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);  // activations, then cotangents
  bf16* xs = act + TM * L.lda;
  bf16* wslab = xs + TM * L.ldx;
  float* scr = reinterpret_cast<float*>(wslab + 2 * WS_ELEMS) + (threadIdx.x / 32) * 256;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  const size_t lrow0 = (size_t)tile * TM;  // first row inside the chunk
  const long long row0 = row_base + (long long)lrow0;
  float* bpart = ws.bias_part + (size_t)tile * L.b_total;

  load_x_tile(L, x, n, row0, xs, ws.x + lrow0 * L.xp);
  __syncthreads();
  forward_layers(L, W, bias, act, xs, scr, wslab, L.depth, ws.acts + lrow0 * L.width, ws_rows,
                 n, row0, nullptr, nullptr);

  // Head cotangent: g = [g_sigma, g_rgb], zero past d_out and past row n.
  const int nr = L.d_out - L.n_sigma;
  auto g_at = [&](int r, int c) -> float {
    const long long row = row0 + r;
    if (row >= n || c >= L.d_out) return 0.0f;
    return c < L.n_sigma ? g_sigma[row * L.n_sigma + c] : g_rgb[row * nr + c - L.n_sigma];
  };
  bf16* dp_head = ws.dpre + ws.dpre_off[L.depth] + lrow0 * L.np;
  for (int idx = threadIdx.x; idx < TM * L.np; idx += NTHREADS) {
    const int r = idx / L.np, c = idx % L.np;
    const bf16 v = __float2bfloat16(g_at(r, c));
    act[r * L.lda + c] = v;
    dp_head[(size_t)r * L.np + c] = v;
  }
  for (int c = threadIdx.x; c < L.np; c += NTHREADS) {
    float s = 0.0f;
    for (int r = 0; r < TM; ++r) s += g_at(r, c);
    bpart[L.b_off[L.depth] + c] = s;
  }
  __syncthreads();

  const int nct = L.width / 16;
  for (int i = L.depth; i >= 1; --i) {
    // dh = dpre_i (bf16, in `act`) @ W_i[0:width, :]^T
    const int N = L.n[i];
    Acc acc[4][MAXJ];
    zero_acc(acc);
    mma_tiles<true>(acc, act, L.lda, W + L.w_off[i], N, N, nct, wslab);
    // (mma_tiles ended in a sync: every warp is done reading dpre_i)
    const bf16* a_prev = ws.acts + ((size_t)(i - 1) * ws_rows + lrow0) * L.width;
    bf16* dp_out = ws.dpre + ws.dpre_off[i - 1] + lrow0 * L.width;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int ct = warp + j * NWARPS;
      if (ct >= nct) continue;
      float colsum = 0.0f;  // this lane's column is ct*16 + (lane & 15)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wmma::store_matrix_sync(scr, acc[r][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = r * 16 + (e >> 4), col = ct * 16 + (e & 15);
          const float a = __bfloat162float(a_prev[(size_t)row * L.width + col]);
          const float dp = a > 0.0f ? scr[e] : 0.0f;
          const bf16 db = __float2bfloat16(dp);
          act[row * L.lda + col] = db;
          dp_out[(size_t)row * L.width + col] = db;
          colsum += dp;
        }
        __syncwarp();
      }
      colsum += __shfl_xor_sync(0xffffffffu, colsum, 16);
      if (lane < 16) bpart[L.b_off[i - 1] + ct * 16 + lane] = colsum;
    }
    __syncthreads();  // act now holds dpre_{i-1}
  }
}

// Pass 2: part[s][k][c] = sum over rows of split s of A[row][k] * B[row][c]
// (A: [rows, lda] bf16, K columns used; B: [rows, N] bf16). One block per
// 64x64 output tile and split. The block stages 64-row chunks of its A and
// B column blocks in shared memory (16-byte cp.async copies, zero past K or
// N, double-buffered), then warp w multiplies row tile w/2 against column
// tiles 2*(w%2) and 2*(w%2)+1 out of shared memory.
constexpr int ATB_ROWS = 64;      // rows per staged chunk
constexpr int ATB_LD = 64 + 8;    // bf16 row stride of a staged chunk

__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* __restrict__ src, int ld,
                                           int col0, int ncols, int r0) {
  // 64 rows x 64 columns as 8-element (16-byte) vectors: 512 of them.
  for (int v = threadIdx.x; v < ATB_ROWS * 8; v += NTHREADS) {
    const int r = v / 8, c = (v % 8) * 8;
    if (col0 + c < ncols)
      cp_async16(dst + r * ATB_LD + c, src + (size_t)(r0 + r) * ld + col0 + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ATB_LD + c) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(NTHREADS) atb_kernel(const bf16* __restrict__ A, int lda,
                                                       int K, const bf16* __restrict__ B,
                                                       int N, int rows, float* part) {
  __shared__ __align__(128) bf16 As[2][ATB_ROWS * ATB_LD];
  __shared__ __align__(128) bf16 Bs[2][ATB_ROWS * ATB_LD];
  const int warp = threadIdx.x / 32;
  const int k0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int mt = warp / 2, nt0 = (warp % 2) * 2;
  const bool live_m = k0 + mt * 16 < K;
  const bool live0 = live_m && n0 + nt0 * 16 < N;
  const bool live1 = live_m && n0 + (nt0 + 1) * 16 < N;
  // Chunk rows: the split's rows, a multiple of ATB_ROWS (rows is a
  // multiple of the 64-row tile and ROWS_PER_SPLIT of ATB_ROWS).
  const int r_begin = blockIdx.z * ROWS_PER_SPLIT;
  const int r_end = min(rows, r_begin + ROWS_PER_SPLIT);
  Acc acc0, acc1;
  wmma::fill_fragment(acc0, 0.0f);
  wmma::fill_fragment(acc1, 0.0f);
  stage_cols(As[0], A, lda, k0, K, r_begin);
  stage_cols(Bs[0], B, N, n0, N, r_begin);
  cp_async_commit();
  for (int r = r_begin, s = 0; r < r_end; r += ATB_ROWS, ++s) {
    if (r + ATB_ROWS < r_end) {
      stage_cols(As[(s + 1) & 1], A, lda, k0, K, r + ATB_ROWS);
      stage_cols(Bs[(s + 1) & 1], B, N, n0, N, r + ATB_ROWS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[s & 1];
    const bf16* bs = Bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < ATB_ROWS; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, as + kk * ATB_LD + mt * 16, ATB_LD);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      if (live0) {
        wmma::load_matrix_sync(b, bs + kk * ATB_LD + nt0 * 16, ATB_LD);
        wmma::mma_sync(acc0, a, b, acc0);
      }
      if (live1) {
        wmma::load_matrix_sync(b, bs + kk * ATB_LD + (nt0 + 1) * 16, ATB_LD);
        wmma::mma_sync(acc1, a, b, acc1);
      }
    }
    __syncthreads();  // this buffer is consumed before it is filled again
  }
  float* out = part + (size_t)blockIdx.z * K * N + (size_t)(k0 + mt * 16) * N + n0;
  if (live0) wmma::store_matrix_sync(out + nt0 * 16, acc0, N, wmma::mem_row_major);
  if (live1) wmma::store_matrix_sync(out + (nt0 + 1) * 16, acc1, N, wmma::mem_row_major);
}

// out[c] += sum_{s < S} in[s * C + c], in a fixed order.
__global__ void colsum_kernel(const float* __restrict__ in, int S, int C, float* out) {
  __shared__ float red[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (c < C)
    for (int s = threadIdx.y; s < S; s += 32) acc += in[(size_t)s * C + c];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t = 0.0f;
    for (int y = 0; y < 32; ++y) t += red[y][threadIdx.x];
    out[c] += t;
  }
}

#define PN_CHECK_LAUNCH()                       \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

int colsum(const float* in, int S, size_t C, float* out, cudaStream_t st) {
  colsum_kernel<<<(unsigned)((C + 31) / 32), dim3(32, 32), 0, st>>>(in, S, (int)C, out);
  PN_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// `desc`, `n_layers`: the packed layout's layer descriptor (make_layout).
int pn_fused_mlp_fwd(const void* x, const void* w, const float* b, float* sigma, float* rgb,
                     int n, const long long* desc, int n_layers, int d_in, int d_out,
                     int n_sigma, void* stream) {
  Layout L;
  if (!make_layout(&L, desc, n_layers, d_in, d_out, n_sigma)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(L);
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((n + TM - 1) / TM);
  fwd_kernel<<<tiles, NTHREADS, smem, (cudaStream_t)stream>>>(
      L, static_cast<const bf16*>(x), static_cast<const bf16*>(w), b, sigma, rgb, n);
  PN_CHECK_LAUNCH();
  return 0;
}

size_t pn_fused_mlp_bwd_workspace_bytes(int n, const long long* desc, int n_layers, int d_in,
                                        int d_out, int n_sigma) {
  Layout L;
  if (!make_layout(&L, desc, n_layers, d_in, d_out, n_sigma) || n <= 0) return 0;
  const int rows = (int)(((long long)(n < CHUNK_ROWS ? n : CHUNK_ROWS) + TM - 1) / TM * TM);
  return carve(L, rows, nullptr, nullptr);
}

// dw (f32, packed layout) and db (f32) are added to, so the caller zeroes
// them. workspace holds pn_fused_mlp_bwd_workspace_bytes(...) bytes.
int pn_fused_mlp_bwd(const void* x, const void* w, const float* b, const float* g_sigma,
                     const float* g_rgb, float* dw, float* db, void* workspace, int n,
                     const long long* desc, int n_layers, int d_in, int d_out, int n_sigma,
                     void* stream) {
  Layout L;
  if (!make_layout(&L, desc, n_layers, d_in, d_out, n_sigma)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int ws_rows = (int)(((long long)(n < CHUNK_ROWS ? n : CHUNK_ROWS) + TM - 1) / TM * TM);
  Workspace ws;
  carve(L, ws_rows, static_cast<unsigned char*>(workspace), &ws);
  const size_t smem = smem_bytes(L);
  cudaError_t e = cudaFuncSetAttribute(bwd_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  for (long long base = 0; base < n; base += CHUNK_ROWS) {
    const long long left = n - base;
    const int rows = (int)(((left < ws_rows ? left : ws_rows) + TM - 1) / TM * TM);
    const int tiles = rows / TM;
    bwd_rows_kernel<<<tiles, NTHREADS, smem, st>>>(L, xb, wb, b, g_sigma, g_rgb, n, base,
                                                  ws_rows, ws);
    PN_CHECK_LAUNCH();
    int rc = colsum(ws.bias_part, tiles, (size_t)L.b_total, db, st);
    if (rc) return rc;
    const int splits = (rows + ROWS_PER_SPLIT - 1) / ROWS_PER_SPLIT;
    for (int i = 0; i <= L.depth; ++i) {
      const int N = L.n[i];
      const bf16* dpre = ws.dpre + ws.dpre_off[i];
      float* dwi = dw + L.w_off[i];
      int koff = 0;
      for (int seg = 0; seg < 2; ++seg) {
        const bf16* A;
        int K;
        if (seg == 0) {
          if (!L.has_h[i]) continue;
          A = ws.acts + (size_t)(i - 1) * ws_rows * L.width;
          K = L.width;
        } else {
          if (!L.has_x[i]) continue;
          A = ws.x;
          K = L.xp;
        }
        dim3 grid((unsigned)((K + 63) / 64), (unsigned)((N + 63) / 64), (unsigned)splits);
        atb_kernel<<<grid, NTHREADS, 0, st>>>(A, K, K, dpre, N, rows, ws.part);
        PN_CHECK_LAUNCH();
        rc = colsum(ws.part, splits, (size_t)K * N, dwi + (size_t)koff * N, st);
        if (rc) return rc;
        koff += K;
      }
    }
  }
  return 0;
}

const char* pn_fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
