// Fused pre-norm FFN: out = x + W2 . gelu_erf(W1 . LN(x) + b1) + b2.
//
// Replaces prediff_tpu/ops/pallas_ffn.py::fused_ffn (_ffn_kernel).  Weights
// in PyTorch layout: w1 (hidden, C), w2 (C, hidden), f32 in memory.
//
// Forward (ffn_forward, ffn_wgmma_kernel): at the UNet's shapes (3328 x 256
// -> 1024, 832 x 512 -> 2048) the work is ~3.5 GFLOP per call against ~7-13
// MB of traffic, far above the card's ridge point, so the tensor cores bound
// it (~0.0035 ms at 989 TFLOP/s bf16).  The hidden activation stays on chip,
// as in the TPU kernel, and the design is the conv's (conv3d.cu) on Hopper's
// own units, in one launch:
//   - The weights are bf16 copies laid out once per parameter version by the
//     wrapper (ops/weights.py), read as 64 x 64 (W1) and 256 x 64 (W2) TMA
//     tiles through a 4-stage mbarrier ring kept full by one producer warp;
//     nothing of the weights is converted per call.
//   - A block owns 128 token rows (two consumer warpgroups of 64) at C = 128
//     and 256.  LN(x) of its rows is computed once from the f32 x and written
//     to shared memory as bf16 in the 128-byte-swizzled K-major layout: the A
//     operand of the first product.  Per hidden chunk of 64: h = LN . W1c^T by
//     wgmma m64n64 into registers; + b1, exact-erf GELU (Drop: m1 at (token,
//     hidden column)), rounded to bf16 into a swizzled shared tile; out +=
//     gelu(h) . W2c^T by wgmma m64nCk16, accumulated in registers across the
//     chunks.  At C = 512 the 64 x 512 f32 accumulator (256 registers a
//     thread) does not fit beside h: a block owns 64 rows, each warpgroup
//     computes half of h's 64 columns (m64n32) and half of the output's
//     (m64n256), and h (double-buffered) is shared through shared memory.
//   - The hidden dimension is split over a thread-block cluster of 1, 2, 4
//     or 8 blocks (about one wave on 132 SMs: 26 x 4 blocks at 3328 x 256,
//     13 x 8 at 832 x 512).  Each parks its f32 partial in its own shared
//     memory; the blocks add them through distributed shared memory in rank
//     order (each a share of the columns), then + b2 (Drop: m2 at (token,
//     channel)) and + x.  No workspace, no atomics: two runs give the same bits.
// Rounding follows the TPU kernel: LN(x), the weights and gelu(h) are bf16
// operands; every sum is f32.
//
// Input gradient (ffn_bwd_dx): replaces pallas_ffn.py::fused_ffn_bwd_dx
// (_ffn_bwd_dx_kernel), flash-style: nothing of the forward is saved, the
// hidden activation is recomputed chunk by chunk and never leaves the chip.
// Per chunk of 64 hidden units: h = LN(x) . W1c^T + b1 and da = g . W2c
// (two products over C), dh = da * gelu'(h) in bf16, dln += dh . W1c.  The
// W1 chunk is staged once and read both ways (as W1c^T and as W1c).  Three
// products of 2 M C hidden each: bound by operations at the alignment
// shapes, like the forward.  A block owns 32 token rows (WMMA 16x16x16 on
// weights staged from f32), and the hidden dimension is split over a second
// grid axis into an f32 workspace; ffn_bwd_reduce_kernel adds the splits and
// applies the LayerNorm backward, which needs the whole dln row, then adds
// the residual's g.  Rounding follows the TPU kernel: LN(x), g, the weights
// and dh are bf16 operands; h, gelu' and every sum stay f32.
//
// All gradients (ffn_bwd_full): replaces pallas_ffn.py::fused_ffn_bwd_full
// (_ffn_bwd_full_kernel): dx as above and, from the same recomputed values,
// dgamma = sum dln . nhat, dbeta = sum dln, dW1 = dh^T . LN(x), db1 = sum dh,
// dW2 = g^T . gelu(h), db2 = sum g, every sum over all tokens.  The TPU kernel
// adds each token tile's share into outputs that stay resident across its
// sequential grid; here blocks run in no order, and a weight gradient
// (256 x 1024 or 512 x 2048 f32) is far more than a block's shared memory.
// So the dx kernel, in its Full form, also writes what the weight gradients
// contract over the tokens - gelu(h) and dh, rounded to bf16 as the TPU kernel
// rounds them before those products, and LN(x) in bf16 - and its per-block
// column sums of the f32 dh.  The two weight gradients are then transposed
// products over the tokens on the tensor cores (tn_gemm_kernel in
// grad_common.cuh), split over the tokens into an f32 workspace; the vector
// gradients are column sums per 32-row block; sum_partials_kernel adds every
// set of partials in a fixed order.  No atomics: two runs give the same bits.
// Five products of 2 M C hidden operations against ~(3 M C + 4 C hidden) f32
// bytes: bound by operations at the UNet's training shapes.
//
// Dropout (ffn_dropout_forward, ffn_dropout_bwd_full): replaces
// pallas_ffn.py::fused_ffn_dropout (_ffn_dropout_fwd_kernel) and
// fused_ffn_dropout_bwd_full (_ffn_dropout_bwd_full_kernel), the training
// path of the v1 recipe:
//   a = gelu(LN(x) . W1 + b1) . m1 / (1 - r_act),
//   out = x + (a . W2 + b2) . m2 / (1 - r_out).
// The TPU kernels draw m1 and m2 from a per-core generator seeded per token
// tile, in the same order over one grid in the forward and the backward.  The
// kernels here do not share a grid (the hidden dimension is split over a
// grid axis, and m2 falls on the sum of the splits), so a mask is a function
// of the logical element instead (philox.cuh): m1 of (token, hidden column)
// is applied to gelu(h) before the bf16 rounding; m2 of (token, channel) on
// the summed a . W2 + b2 and before the residual, which is never masked.
// The backward regenerates both: do = g . m2 / (1 - r_out) feeds dW2, db2
// and da, the residual's share of dx is the unmasked g; the stored bf16
// gelu(h) is the dropped, rescaled one and dz = da . gelu'(h) . m1 /
// (1 - r_act).  The Drop forms are separate template instances of the same
// bodies, so with both rates 0 they give the bits of the kernels without
// dropout.  The draws add ~100 integer operations per hidden
// element to kernels that stay bound by their products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <mma.h>

#include "grad_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;      // token rows per block
constexpr int kChunk = 64;     // hidden units per chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kPadB = 8;       // bf16 row padding (keeps 32-byte alignment)
constexpr int kPadF = 4;       // f32 row padding

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of kRows rows of x into bf16 rows of lnA (zeros past M), one
// warp per row, two-pass mean / var.
template <int C>
__device__ __forceinline__ void ln_rows_bf16(const float* __restrict__ x,
                                             const float* __restrict__ ln_w,
                                             const float* __restrict__ ln_b,
                                             __nv_bfloat16* lnA, int ldA, int row0, int M,
                                             float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int gr = row0 + r;
    __nv_bfloat16* dst = lnA + r * ldA;
    if (gr < M) {
      const float* xr = x + (size_t)gr * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += xr[c];
      const float mu = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        float d = xr[c] - mu;
        v += d * d;
      }
      const float rs = rsqrtf(warp_sum(v) / C + eps);
      for (int c = lane; c < C; c += 32)
        dst[c] = __float2bfloat16((xr[c] - mu) * rs * ln_w[c] + ln_b[c]);
    } else {
      for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16(0.f);
    }
  }
}

template <int C>
constexpr size_t bwd_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kRows * (C + kPadB) + kChunk * (C + kPadB) +
                                   C * (kChunk + kPadB) + kRows * (kChunk + kPadB)) +
         sizeof(float) * 2 * kRows * (kChunk + kPadF);
}

// Full: also write gelu(h) and dh as bf16 (M, hidden), LN(x) as bf16 (M, C)
// and this block's column sums of the f32 dh into db1_part (row blocks, hidden).
// Drop (with Full): g goes through the dropout d2 as it is staged (do, also
// written as bf16 (M, C) into do_out), gelu(h) and dh through d1.
template <int C, bool Full, bool Drop>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, float* __restrict__ part,
                  __nv_bfloat16* __restrict__ a_out, __nv_bfloat16* __restrict__ dh_out,
                  __nv_bfloat16* __restrict__ ln_out, float* __restrict__ db1_part, int M,
                  int hidden, int chunks_per_split, float eps, __nv_bfloat16* __restrict__ do_out,
                  philox::Drop d1, philox::Drop d2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldA = C + kPadB;
  constexpr int ldW2 = kChunk + kPadB;
  constexpr int ldH = kChunk + kPadB;
  constexpr int ldHf = kChunk + kPadF;
  __nv_bfloat16* lnA = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][ldA]
  __nv_bfloat16* gA = lnA + kRows * ldA;                         // [kRows][ldA]
  __nv_bfloat16* w1c = gA + kRows * ldA;                         // [kChunk][ldA]  (j, c)
  __nv_bfloat16* w2c = w1c + kChunk * ldA;                       // [C][ldW2]      (c, j)
  __nv_bfloat16* hb = w2c + C * ldW2;                            // [kRows][ldH]   dh
  float* hs = reinterpret_cast<float*>(hb + kRows * ldH);        // [kRows][ldHf]  h
  float* das = hs + kRows * ldHf;                                // [kRows][ldHf]  da

  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  ln_rows_bf16<C>(x, ln_w, ln_b, lnA, ldA, row0, M, eps);
  for (int i = tid; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const int gr = row0 + r;
    float gv = gr < M ? g[(size_t)gr * C + c] : 0.f;
    if (Drop) gv = philox::apply(d2, (unsigned long long)gr * C + c, gv);
    gA[r * ldA + c] = __float2bfloat16(gv);
  }

  // dln: this warp's output columns [warp * kCols, (warp + 1) * kCols), all rows.
  constexpr int kCols = C / 8;
  constexpr int kColTiles = kCols / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kColTiles];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int ct = 0; ct < kColTiles; ++ct) wmma::fill_fragment(acc[rt][ct], 0.f);
  const int hr = warp >> 2, hc = warp & 3;  // this warp's 16 x 16 tile of the chunk
  __syncthreads();
  if (Full && blockIdx.y == 0) {
    for (int i = tid; i < kRows * C; i += kThreads) {
      const int r = i / C, c = i % C;
      if (row0 + r < M) {
        ln_out[(size_t)(row0 + r) * C + c] = lnA[r * ldA + c];
        if (Drop) do_out[(size_t)(row0 + r) * C + c] = gA[r * ldA + c];
      }
    }
  }

  const int j_begin = blockIdx.y * chunks_per_split * kChunk;
  const int j_end = min(hidden, j_begin + chunks_per_split * kChunk);
  for (int j0 = j_begin; j0 < j_end; j0 += kChunk) {
    for (int i = tid; i < kChunk * C; i += kThreads) {
      const int n = i / C, k = i % C;
      w1c[n * ldA + k] = __float2bfloat16(w1[(size_t)(j0 + n) * C + k]);
    }
    for (int i = tid; i < C * kChunk; i += kThreads) {
      const int n = i / kChunk, k = i % kChunk;
      w2c[n * ldW2 + k] = __float2bfloat16(w2[(size_t)n * hidden + j0 + k]);
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc, dacc;
    wmma::fill_fragment(hacc, 0.f);
    wmma::fill_fragment(dacc, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, lnA + hr * 16 * ldA + kk, ldA);
      wmma::load_matrix_sync(bt, w1c + hc * 16 * ldA + kk, ldA);
      wmma::mma_sync(hacc, a, bt, hacc);
      wmma::load_matrix_sync(a, gA + hr * 16 * ldA + kk, ldA);
      wmma::load_matrix_sync(b, w2c + kk * ldW2 + hc * 16, ldW2);
      wmma::mma_sync(dacc, a, b, dacc);
    }
    wmma::store_matrix_sync(hs + hr * 16 * ldHf + hc * 16, hacc, ldHf, wmma::mem_row_major);
    wmma::store_matrix_sync(das + hr * 16 * ldHf + hc * 16, dacc, ldHf, wmma::mem_row_major);
    __syncthreads();
    float dh_sum = 0.f;  // Full: this thread's column (tid % kChunk) over its rows
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      const float h = hs[r * ldHf + k] + b1[j0 + k];
      const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
      const float pdf = expf(-0.5f * h * h) * 0.39894228040143268f;
      float dh = das[r * ldHf + k] * (cdf + h * pdf);
      float a = h * cdf;
      if (Drop && d1.thr != 0u) {  // one draw masks the activation and its gradient
        const bool kept =
            philox::draw(d1, (unsigned long long)(row0 + r) * hidden + j0 + k) >= d1.thr;
        dh = kept ? dh / d1.keep : 0.f;
        a = kept ? a / d1.keep : 0.f;
      }
      const __nv_bfloat16 dhb = __float2bfloat16(dh);
      hb[r * ldH + k] = dhb;
      if (Full) {
        dh_sum += dh;  // rows past M have g = 0, so dh = 0
        if (row0 + r < M) {
          const size_t o = (size_t)(row0 + r) * hidden + j0 + k;
          a_out[o] = __float2bfloat16(a);
          dh_out[o] = dhb;
        }
      }
    }
    __syncthreads();
    if (Full) das[tid] = dh_sum;  // das is free until the next chunk's products
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, hb + kk, ldH);
      wmma::load_matrix_sync(a1, hb + 16 * ldH + kk, ldH);
#pragma unroll
      for (int ct = 0; ct < kColTiles; ++ct) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w1c + kk * ldA + warp * kCols + ct * 16, ldA);
        wmma::mma_sync(acc[0][ct], a0, b, acc[0][ct]);
        wmma::mma_sync(acc[1][ct], a1, b, acc[1][ct]);
      }
    }
    __syncthreads();
    if (Full && tid < kChunk) {  // kThreads / kChunk threads share a column, added in order
      float t = das[tid];
      for (int q = 1; q < kThreads / kChunk; ++q) t += das[q * kChunk + tid];
      db1_part[(size_t)blockIdx.x * hidden + j0 + tid] = t;
    }
  }

  // This split's partial dln through shared memory (the W2 staging area).
  constexpr int ldO = C + kPadF;
  float* os = reinterpret_cast<float*>(w2c);
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int ct = 0; ct < kColTiles; ++ct)
      wmma::store_matrix_sync(os + rt * 16 * ldO + warp * kCols + ct * 16, acc[rt][ct], ldO,
                              wmma::mem_row_major);
  __syncthreads();
  float* dst = part + (size_t)blockIdx.y * M * C;
  for (int i = tid; i < kRows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const int gr = row0 + r;
    if (gr < M) dst[(size_t)gr * C + c] = os[r * ldO + c];
  }
}

// dx = g + LayerNorm backward of dln = sum_s part[s], one warp per row:
//   dnhat = dln * ln_w,  dx_ln = rs * (dnhat - mean(dnhat) - nhat * mean(dnhat * nhat)).
__global__ void ffn_bwd_reduce_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                      const float* __restrict__ ln_w,
                                      const float* __restrict__ part, float* __restrict__ dx,
                                      int M, int C, int splits, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t n = (size_t)M * C;
  const float* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = xr[c] - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / C + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    float dln = 0.f;
    for (int sp = 0; sp < splits; ++sp) dln += part[sp * n + (size_t)row * C + c];
    const float dnhat = dln * ln_w[c];
    s1 += dnhat;
    s2 += dnhat * (xr[c] - mu) * rs;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  for (int c = lane; c < C; c += 32) {
    float dln = 0.f;
    for (int sp = 0; sp < splits; ++sp) dln += part[sp * n + (size_t)row * C + c];
    const float nhat = (xr[c] - mu) * rs;
    dx[(size_t)row * C + c] = g[(size_t)row * C + c] + rs * (dln * ln_w[c] - m1 - nhat * m2);
  }
}

template <int C, bool Full, bool Drop = false>
cudaError_t launch_bwd(const float* x, const float* g, const float* ln_w, const float* ln_b,
                       const float* w1, const float* b1, const float* w2, float* part,
                       __nv_bfloat16* a_out, __nv_bfloat16* dh_out, __nv_bfloat16* ln_out,
                       float* db1_part, int M, int hidden, int splits, float eps,
                       cudaStream_t stream, __nv_bfloat16* do_out = nullptr,
                       philox::Drop d1 = philox::Drop{}, philox::Drop d2 = philox::Drop{}) {
  static_assert(Full || !Drop, "dropout runs only on the all-gradients form");
  static_assert(kThreads % kChunk == 0 && kThreads <= kRows * (kChunk + kPadF),
                "the dh column sums pass through the da tile");
  static_assert(sizeof(float) * kRows * (C + kPadF) <=
                    sizeof(__nv_bfloat16) * C * (kChunk + kPadB),
                "epilogue tile must fit the W2 staging area");
  constexpr size_t bytes = bwd_smem_bytes<C>();
  static_assert(bytes <= 232448, "exceeds the 227 KB of shared memory a block can use");
  cudaError_t err = cudaFuncSetAttribute(ffn_bwd_dx_kernel<C, Full, Drop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int chunks_per_split = hidden / kChunk / splits;
  ffn_bwd_dx_kernel<C, Full, Drop>
      <<<dim3((M + kRows - 1) / kRows, splits), kThreads, bytes, stream>>>(
          x, g, ln_w, ln_b, w1, b1, w2, part, a_out, dh_out, ln_out, db1_part, M, hidden,
          chunks_per_split, eps, do_out, d1, d2);
  return cudaGetLastError();
}

// part -> dx: the splits added in order, the LayerNorm backward, the residual's g.
cudaError_t bwd_reduce(const float* x, const float* g, const float* ln_w, const float* part,
                       float* dx, int M, int C, int splits, float eps, cudaStream_t stream) {
  constexpr int kRowsPerBlock = 8;  // one warp per row
  ffn_bwd_reduce_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                          stream>>>(x, g, ln_w, part, dx, M, C, splits, eps);
  return cudaGetLastError();
}

template <bool Full, bool Drop = false>
cudaError_t launch_bwd_c(int C, const float* x, const float* g, const float* ln_w,
                         const float* ln_b, const float* w1, const float* b1, const float* w2,
                         float* part, __nv_bfloat16* a_out, __nv_bfloat16* dh_out,
                         __nv_bfloat16* ln_out, float* db1_part, int M, int hidden, int splits,
                         float eps, cudaStream_t stream, __nv_bfloat16* do_out = nullptr,
                         philox::Drop d1 = philox::Drop{}, philox::Drop d2 = philox::Drop{}) {
  switch (C) {
    case 128: return launch_bwd<128, Full, Drop>(x, g, ln_w, ln_b, w1, b1, w2, part, a_out, dh_out, ln_out, db1_part, M, hidden, splits, eps, stream, do_out, d1, d2);
    case 256: return launch_bwd<256, Full, Drop>(x, g, ln_w, ln_b, w1, b1, w2, part, a_out, dh_out, ln_out, db1_part, M, hidden, splits, eps, stream, do_out, d1, d2);
    case 512: return launch_bwd<512, Full, Drop>(x, g, ln_w, ln_b, w1, b1, w2, part, a_out, dh_out, ln_out, db1_part, M, hidden, splits, eps, stream, do_out, d1, d2);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The forward on TMA + wgmma (the note at the top of the file).
namespace fwd {

using namespace hopper;

constexpr int kStages = 4, kStageBytes = 32768;   // ring of weight tiles
constexpr int kHC = 64;                           // hidden units per chunk
// two consumer warpgroups and a producer warpgroup, one thread of which
// issues the loads; setmaxnreg moves the producer's registers to the
// consumers (40 + 2 x 232 a thread: 128 x 40 + 256 x 232 <= 65536)
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxSplits = 8;                     // portable cluster size

template <int C>
struct Cfg {
  // C = 512: the two warpgroups split the columns of one 64-row tile
  static constexpr bool kSplitCols = C == 512;
  static constexpr int kBM = kSplitCols ? 64 : 128;        // token rows a block
  static constexpr int kN1 = kSplitCols ? 32 : 64;         // h columns a warpgroup
  static constexpr int kN2 = kSplitCols ? C / 2 : C;       // output columns a warpgroup
  static constexpr int kAcc = kN2 / 2, kHAcc = kN1 / 2;    // f32 accumulators a thread
  // a ring item: W1c's columns [i, i + kItemK) (64 x 64 boxes) or W2c's rows
  // [i, i + kItemK) (one kItemK x 64 box); kItems of each per chunk
  static constexpr int kItemK = C < 256 ? C : 256;
  static constexpr int kItems = C / kItemK;
  static constexpr int kItemBytes = kHC * kItemK * 2;
  static constexpr int kLnBytes = kBM * C * 2;
  static constexpr int kHBytes = 16384;   // one 128 x 64 bf16 tile, or two 64 x 64
  static constexpr int kSmem = 1024 + kLnBytes + kHBytes + kStages * kStageBytes;
  static_assert(kItemBytes <= kStageBytes, "an item fits a stage");
  static_assert(2 * kItems <= kStages, "a chunk's W2c and the next chunk's W1c fit the ring");
  static_assert(kConsumers * kAcc * 4 <= kStages * kStageBytes, "the partial fits the ring");
  static_assert(kSmem <= 232448, "exceeds the 227 KB of shared memory a block can use");
};

__device__ __forceinline__ float gelu_erf(float h) {
  return h * 0.5f * (1.f + erff(h * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (row tiles, 1, splits), clusters of (1, 1, splits): block z of a
// cluster adds hidden chunks [z, z + 1) * chunks / splits.
template <int C, bool Drop>
__global__ void __launch_bounds__(kThreads, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                 const __grid_constant__ CUtensorMap w2_map, const float* __restrict__ x,
                 const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 float* __restrict__ out, int M, int hidden, float eps, philox::Drop d1,
                 philox::Drop d2) {
  using K = Cfg<C>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ln_s = (raw + 1023) & ~1023u;   // 1024-byte aligned for the 128-byte swizzle
  const uint32_t h_s = ln_s + K::kLnBytes, ring = h_s + K::kHBytes;
  uint8_t* ln_g = smem_raw + (ln_s - raw);
  float* red = reinterpret_cast<float*>(ln_g + K::kLnBytes + K::kHBytes);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * K::kBM;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int chunks = hidden / kHC;
  const int c_begin = rank * chunks / splits, c_end = (rank + 1) * chunks / splits;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread keeps the ring full, W1c's items then W2c's per
    // chunk; the warpgroup then meets the consumers' two cluster barriers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int item = 0;
      for (int c = c_begin; c < c_end; ++c) {
        for (int it = 0; it < 2 * K::kItems; ++it, ++item) {
          const int s = item % kStages;
          mbar_wait(smem_u32(&empty[s]), ((item / kStages) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]), dst = ring + s * kStageBytes;
          mbar_expect_tx(bar, K::kItemBytes);
          if (it < K::kItems) {
            for (int b = 0; b < K::kItemK / 64; ++b)
              tma_load_2d(dst + b * 8192, &w1_map, bar, it * K::kItemK + b * 64, c * kHC);
          } else {
            tma_load_2d(dst, &w2_map, bar, c * kHC, (it - K::kItems) * K::kItemK);
          }
        }
      }
    }
    if (splits > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
    const int arow = K::kSplitCols ? 0 : 64 * wg;      // the warpgroup's rows of the tile
    const int ocol = K::kSplitCols ? K::kN2 * wg : 0;  // its output columns
    ln_rows_sw128<(C + 255) / 256, 8 / ((C + 255) / 256)>(x, ln_w, ln_b, ln_g, K::kBM, m0, M, C,
                                                          eps, tid / 32, kConsumers / 32);
    fence_async_smem();
    named_barrier(1, kConsumers);
    const int hcol = K::kSplitCols ? K::kN1 * wg : 0;   // the warpgroup's columns of h
    float acc[K::kAcc], hacc[K::kHAcc];   // hacc: each chunk's first wgmma overwrites it
#pragma unroll
    for (int e = 0; e < K::kAcc; ++e) acc[e] = 0.f;
    int item = 0;
    for (int c = c_begin; c < c_end; ++c) {
      const int j0 = c * kHC;
      const uint32_t hb = h_s + (K::kSplitCols ? ((c - c_begin) & 1) * 8192 : 0);
      // the chunk's b1 now: its loads are in flight while the product runs
      float bj[K::kN1 / 8][2];
#pragma unroll
      for (int jb = 0; jb < K::kN1 / 8; ++jb) {
        const float2 b = *reinterpret_cast<const float2*>(b1 + j0 + hcol + 8 * jb + 2 * (lane & 3));
        bj[jb][0] = b.x;
        bj[jb][1] = b.y;
      }
      // h = LN . W1c^T
      wgmma_fence();
#pragma unroll
      for (int it = 0; it < K::kItems; ++it) {
        const int s = (item + it) % kStages;
        mbar_wait(smem_u32(&full[s]), ((item + it) / kStages) & 1);
        const uint32_t st = ring + s * kStageBytes;
#pragma unroll
        for (int b = 0; b < K::kItemK / 64; ++b) {
          const int slice = it * (K::kItemK / 64) + b;
          const uint64_t da = sw128_desc(ln_s + slice * K::kBM * 128 + arow * 128);
          const uint64_t db = sw128_desc(st + b * 8192 + hcol * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_k16(hacc, da + 2 * kk, db + 2 * kk, slice + kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();   // also the previous chunk's out product: its W2c items go too
      fence_regs(hacc);
      if (lane == 0) {
#pragma unroll
        for (int it = 0; it < K::kItems; ++it) {
          mbar_arrive(smem_u32(&empty[(item + it) % kStages]));
          if (c > c_begin) mbar_arrive(smem_u32(&empty[(item - K::kItems + it) % kStages]));
        }
      }
      item += K::kItems;
      // gelu(h + b1), dropped, rounded to bf16 into the h tile
#pragma unroll
      for (int jb = 0; jb < K::kN1 / 8; ++jb) {
        const int j = hcol + 8 * jb + 2 * (lane & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = arow + warp * 16 + (lane >> 2) + 8 * half;
          float a0 = gelu_erf(hacc[4 * jb + 2 * half] + bj[jb][0]);
          float a1 = gelu_erf(hacc[4 * jb + 2 * half + 1] + bj[jb][1]);
          if (Drop) philox::apply2(d1, (unsigned long long)(m0 + r) * hidden + j0 + j, a0, a1);
          *reinterpret_cast<uint32_t*>(ln_g + (hb - ln_s) + sw128_offset(r, j)) =
              pack_bf16(a0, a1);
        }
      }
      fence_async_smem();
      if (K::kSplitCols)
        named_barrier(2, kConsumers);
      else
        named_barrier(2 + wg, 128);
      // out += gelu(h) . W2c^T
      wgmma_fence();
#pragma unroll
      for (int it = 0; it < K::kItems; ++it) {
        const int s = (item + it) % kStages;
        mbar_wait(smem_u32(&full[s]), ((item + it) / kStages) & 1);
        if (!K::kSplitCols || it == wg) {
          const uint64_t da = sw128_desc(hb + arow * 128);
          const uint64_t db = sw128_desc(ring + s * kStageBytes);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk);
        }
      }
      wgmma_commit();
      item += K::kItems;
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: rows r0 and r0 + 8 of the warpgroup's, columns ocol + 8 jb +
    // 2 (lane % 4) (+1): out = x + drop(sum + b2)
    const int row0 = m0 + arow + warp * 16 + (lane >> 2), row1 = row0 + 8;
    auto store = [&](int jb, float v0, float v1, float v2, float v3) {
      const int n = ocol + 8 * jb + 2 * (lane & 3);
      const float c0 = b2[n], c1 = b2[n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row1 : row0;
        if (row >= M) continue;
        const size_t o = (size_t)row * C + n;
        float y0 = (half ? v2 : v0) + c0, y1 = (half ? v3 : v1) + c1;
        if (Drop) philox::apply2(d2, o, y0, y1);
        const float2 xv = *reinterpret_cast<const float2*>(x + o);
        *reinterpret_cast<float2*>(out + o) = make_float2(xv.x + y0, xv.y + y1);
      }
    };
    if (splits == 1) {
#pragma unroll
      for (int jb = 0; jb < K::kN2 / 8; ++jb)
        store(jb, acc[4 * jb], acc[4 * jb + 1], acc[4 * jb + 2], acc[4 * jb + 3]);
      return;
    }
    // split over a cluster: park the partial, then each rank adds the partials
    // of its share of the columns (8-column groups jb = rank + t * splits) in
    // rank order and stores them, two groups at a time with every load (the
    // peers' partials, x, b2) in flight before any is used
    cg::cluster_group cluster = cg::this_cluster();
    named_barrier(1, kConsumers);   // the partial overwrites the ring: every wgmma has read it
#pragma unroll
    for (int e = 0; e < K::kAcc; ++e) red[e * kConsumers + tid] = acc[e];
    cluster.sync();
    const int mine = (K::kN2 / 8 - rank + splits - 1) / splits;
    for (int t = 0; t < mine; t += 2) {
      float part[2][kMaxSplits][4], xv[2][4], bv[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (t + i >= mine) break;
        const int jb = rank + (t + i) * splits, n = ocol + 8 * jb + 2 * (lane & 3);
#pragma unroll
        for (int q = 0; q < kMaxSplits; ++q) {
          if (q >= splits) break;
          const float* peer = cluster.map_shared_rank(red, q);
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][q][e] = peer[(4 * jb + e) * kConsumers + tid];
        }
        const float2 b = *reinterpret_cast<const float2*>(b2 + n);
        bv[i][0] = b.x;
        bv[i][1] = b.y;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row1 : row0;
          const float2 xr = row < M ? *reinterpret_cast<const float2*>(x + (size_t)row * C + n)
                                    : make_float2(0.f, 0.f);
          xv[i][2 * half] = xr.x;
          xv[i][2 * half + 1] = xr.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (t + i >= mine) break;
        const int jb = rank + (t + i) * splits, n = ocol + 8 * jb + 2 * (lane & 3);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < kMaxSplits; ++q) {
          if (q >= splits) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += part[i][q][e];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row1 : row0;
          if (row >= M) continue;
          const size_t o = (size_t)row * C + n;
          float y0 = v[2 * half] + bv[i][0], y1 = v[2 * half + 1] + bv[i][1];
          if (Drop) philox::apply2(d2, o, y0, y1);
          *reinterpret_cast<float2*>(out + o) =
              make_float2(xv[i][2 * half] + y0, xv[i][2 * half + 1] + y1);
        }
      }
    }
    cluster.sync();   // no block leaves while a peer may still read its partial
  }
}

template <int C, bool Drop>
cudaError_t launch(const CUtensorMap& w1, const CUtensorMap& w2, const float* x,
                   const float* ln_w, const float* ln_b, const float* b1, const float* b2,
                   float* out, int M, int hidden, int splits, float eps, philox::Drop d1,
                   philox::Drop d2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ffn_wgmma_kernel<C, Drop>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<C>::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + Cfg<C>::kBM - 1) / Cfg<C>::kBM, 1, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<C>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, ffn_wgmma_kernel<C, Drop>, w1, w2, x, ln_w, ln_b, b1,
                                       b2, out, M, hidden, eps, d1, d2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool Drop>
int forward(const float* x, const float* ln_w, const float* ln_b, const void* w1_map,
            const float* b1, const void* w2_map, const float* b2, float* out, int M, int C,
            int hidden, int splits, float eps, philox::Drop d1, philox::Drop d2,
            cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M < 1 || hidden < kHC || hidden % kHC || splits < 1 || splits > kMaxSplits ||
      splits > hidden / kHC || !aligned(x) || !aligned(ln_w) || !aligned(ln_b) || !aligned(b1) ||
      !aligned(b2) || (reinterpret_cast<uintptr_t>(out) & 7))
    return (int)cudaErrorInvalidValue;
  CUtensorMap w1, w2;
  memcpy(&w1, w1_map, sizeof(w1));
  memcpy(&w2, w2_map, sizeof(w2));
  switch (C) {
    case 128:
      return (int)launch<128, Drop>(w1, w2, x, ln_w, ln_b, b1, b2, out, M, hidden, splits, eps,
                                    d1, d2, stream);
    case 256:
      return (int)launch<256, Drop>(w1, w2, x, ln_w, ln_b, b1, b2, out, M, hidden, splits, eps,
                                    d1, d2, stream);
    case 512:
      return (int)launch<512, Drop>(w1, w2, x, ln_w, ln_b, b1, b2, out, M, hidden, splits, eps,
                                    d1, d2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fwd

}  // namespace

// x, out (M, C) f32; w1_map / w2_map the tensor maps of the bf16 copies of
// w1 (hidden, C) and w2 (C, hidden) (bf16_matrix_map, boxes of 64 and
// min(C, 256) rows); the cluster's `splits` of the hidden / 64 chunks.  One
// launch.
extern "C" int ffn_forward(const float* x, const float* ln_w, const float* ln_b,
                           const void* w1_map, const float* b1, const void* w2_map,
                           const float* b2, float* out, int M, int C, int hidden, int splits,
                           float eps, cudaStream_t stream) {
  return fwd::forward<false>(x, ln_w, ln_b, w1_map, b1, w2_map, b2, out, M, C, hidden, splits, eps,
                             philox::Drop{}, philox::Drop{}, stream);
}

// dx of the fused FFN for the output cotangent g; part: (splits, M, C) f32
// workspace; splits must divide hidden / 64.
extern "C" int ffn_bwd_dx(const float* x, const float* g, const float* ln_w, const float* ln_b,
                          const float* w1, const float* b1, const float* w2, float* part,
                          float* dx, int M, int C, int hidden, int splits, float eps,
                          cudaStream_t stream) {
  if (hidden % kChunk != 0 || splits < 1 || (hidden / kChunk) % splits != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_bwd_c<false>(C, x, g, ln_w, ln_b, w1, b1, w2, part, nullptr, nullptr,
                                        nullptr, nullptr, M, hidden, splits, eps, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)bwd_reduce(x, g, ln_w, part, dx, M, C, splits, eps, stream);
}

// Every gradient of the fused FFN for the output cotangent g.  Workspaces:
// part (splits, M, C) f32; a_bf, dh_bf (M, hidden) and ln_bf (M, C) bf16;
// db1_part (ceil(M / 32), hidden), vpart (ceil(M / 32), 3, C) and dw_part
// (ksplit, C, hidden) f32.  Out: dx (M, C), dw1 (hidden, C), db1 (hidden),
// dw2 (C, hidden), vec (3, C) = dgamma, dbeta, db2.
extern "C" int ffn_bwd_full(const float* x, const float* g, const float* ln_w,
                            const float* ln_b, const float* w1, const float* b1,
                            const float* w2, float* part, __nv_bfloat16* a_bf,
                            __nv_bfloat16* dh_bf, __nv_bfloat16* ln_bf, float* db1_part,
                            float* vpart, float* dw_part, float* dx, float* dw1, float* db1,
                            float* dw2, float* vec, int M, int C, int hidden, int splits,
                            int ksplit, float eps, cudaStream_t stream) {
  if (hidden % kChunk != 0 || splits < 1 || (hidden / kChunk) % splits != 0 || ksplit < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_bwd_c<true>(C, x, g, ln_w, ln_b, w1, b1, w2, part, a_bf, dh_bf, ln_bf,
                                       db1_part, M, hidden, splits, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = bwd_reduce(x, g, ln_w, part, dx, M, C, splits, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = gradk::ln_vec_grads(x, g, part, splits, vpart, vec, M, C, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = gradk::sum_partials(db1_part, db1, (size_t)hidden, (M + kRows - 1) / kRows, stream);
  if (err != cudaSuccess) return (int)err;
  err = gradk::weight_grad(dh_bf, ln_bf, dw_part, dw1, M, hidden, C, ksplit, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gradk::weight_grad(g, a_bf, dw_part, dw2, M, C, hidden, ksplit, stream);
}

// The fused FFN with dropout on gelu(h) (thr_act, keep_act = 1 - rate) and on
// the output before the residual (thr_out, keep_out); the masks are those of
// the stream (seed_lo, seed_hi, site), tensors 0 and 1.  Arguments as ffn_forward.
extern "C" int ffn_dropout_forward(const float* x, const float* ln_w, const float* ln_b,
                                   const void* w1_map, const float* b1, const void* w2_map,
                                   const float* b2, float* out, int M, int C, int hidden,
                                   int splits, float eps, unsigned seed_lo, unsigned seed_hi,
                                   unsigned site, unsigned thr_act, float keep_act,
                                   unsigned thr_out, float keep_out, cudaStream_t stream) {
  const philox::Drop d1{seed_lo, seed_hi, site, 0u, thr_act, keep_act};
  const philox::Drop d2{seed_lo, seed_hi, site, 1u, thr_out, keep_out};
  return fwd::forward<true>(x, ln_w, ln_b, w1_map, b1, w2_map, b2, out, M, C, hidden, splits, eps,
                            d1, d2, stream);
}

// Every gradient of ffn_dropout_forward for the output cotangent g, the masks
// regenerated from the same (seed, site).  Workspaces and outputs as
// ffn_bwd_full, and do_bf (M, C) bf16 for the dropped cotangent.
extern "C" int ffn_dropout_bwd_full(const float* x, const float* g, const float* ln_w,
                                    const float* ln_b, const float* w1, const float* b1,
                                    const float* w2, float* part, __nv_bfloat16* a_bf,
                                    __nv_bfloat16* dh_bf, __nv_bfloat16* ln_bf,
                                    __nv_bfloat16* do_bf, float* db1_part, float* vpart,
                                    float* dw_part, float* dx, float* dw1, float* db1,
                                    float* dw2, float* vec, int M, int C, int hidden,
                                    int splits, int ksplit, float eps, unsigned seed_lo,
                                    unsigned seed_hi, unsigned site, unsigned thr_act,
                                    float keep_act, unsigned thr_out, float keep_out,
                                    cudaStream_t stream) {
  if (hidden % kChunk != 0 || splits < 1 || (hidden / kChunk) % splits != 0 || ksplit < 1)
    return (int)cudaErrorInvalidValue;
  const philox::Drop d1{seed_lo, seed_hi, site, 0u, thr_act, keep_act};
  const philox::Drop d2{seed_lo, seed_hi, site, 1u, thr_out, keep_out};
  cudaError_t err = launch_bwd_c<true, true>(C, x, g, ln_w, ln_b, w1, b1, w2, part, a_bf, dh_bf,
                                             ln_bf, db1_part, M, hidden, splits, eps, stream,
                                             do_bf, d1, d2);
  if (err != cudaSuccess) return (int)err;
  err = bwd_reduce(x, g, ln_w, part, dx, M, C, splits, eps, stream);  // the residual: g unmasked
  if (err != cudaSuccess) return (int)err;
  err = gradk::ln_vec_grads(x, g, part, splits, vpart, vec, M, C, eps, stream, d2);  // db2 = sum do
  if (err != cudaSuccess) return (int)err;
  err = gradk::sum_partials(db1_part, db1, (size_t)hidden, (M + kRows - 1) / kRows, stream);
  if (err != cudaSuccess) return (int)err;
  err = gradk::weight_grad(dh_bf, ln_bf, dw_part, dw1, M, hidden, C, ksplit, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gradk::weight_grad(do_bf, a_bf, dw_part, dw2, M, C, hidden, ksplit, stream);
}
