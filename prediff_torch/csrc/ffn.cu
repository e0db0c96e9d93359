// Fused pre-norm FFN: out = x + W2 . gelu_erf(W1 . LN(x) + b1) + b2.
//
// Replaces prediff_tpu/ops/pallas_ffn.py::fused_ffn (_ffn_kernel).  Weights
// in PyTorch layout: w1 (hidden, C), w2 (C, hidden), f32 in memory.
//
// Bound: at the UNet's shapes (3328 x 256 -> 1024, 832 x 512 -> 2048) the
// work is ~3.5 GFLOP per call against ~7-13 MB of traffic, above the card's
// ridge point, so it is bound by operations.  The design keeps the hidden
// activation on chip as the TPU kernel did: a block owns kRows token rows;
// it writes LN(x) to shared memory as bf16 once, then loops over the hidden
// dimension in chunks of kChunk: h = gelu(LN . W1[chunk]^T + b1) lands in
// shared memory (f32, then bf16), and out += h . W2[:, chunk]^T accumulates in
// tensor-core fragments that stay in registers across all chunks.  Products
// run on the tensor cores through WMMA 16x16x16 bf16 with f32 accumulation,
// rounding at the TPU kernel's points (LN output, weights, hidden).  Weights
// are converted to bf16 while they are staged into shared memory.  wgmma and
// TMA are later work.
//
// Few token rows (832 at the 8x8 stage) give few row blocks, so the hidden
// dimension is also split over a second grid axis: block (i, s) sums the
// hidden chunks of split s into a partial (splits, M, C) f32 workspace, and
// ffn_reduce_kernel adds the splits in a fixed order with b2 and the
// residual.  No atomics: the result does not depend on block order.
//
// Input gradient (ffn_bwd_dx): replaces pallas_ffn.py::fused_ffn_bwd_dx
// (_ffn_bwd_dx_kernel), flash-style: nothing of the forward is saved, the
// hidden activation is recomputed chunk by chunk and never leaves the chip.
// Per chunk of 64 hidden units: h = LN(x) . W1c^T + b1 and da = g . W2c
// (two products over C), dh = da * gelu'(h) in bf16, dln += dh . W1c.  The
// W1 chunk is staged once and read both ways (as W1c^T and as W1c).  Three
// products of 2 M C hidden each: bound by operations at the alignment
// shapes, like the forward.  The hidden dimension is split over a second
// grid axis as in the forward; ffn_bwd_reduce_kernel adds the splits and
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
// is applied to gelu(h) in the main kernel, before the bf16 rounding; m2 of
// (token, channel) in ffn_reduce_kernel, on the summed a . W2 + b2 and before
// the residual, which is never masked.  The backward regenerates both:
// do = g . m2 / (1 - r_out) feeds dW2, db2 and da, the residual's share of dx
// is the unmasked g; the stored bf16 gelu(h) is the dropped, rescaled one and
// dz = da . gelu'(h) . m1 / (1 - r_act).  The Drop forms are separate template
// instances, so the kernels without dropout are untouched; with both rates 0
// they give the same bits.  The draws add ~100 integer operations per hidden
// element to kernels that stay bound by their products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "grad_common.cuh"
#include "philox.cuh"

using namespace nvcuda;

namespace {

constexpr int kRows = 32;      // token rows per block
constexpr int kChunk = 64;     // hidden units per chunk
constexpr int kKSlice = 64;    // depth of one W1 staging slice
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
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (kRows * (C + kPadB) + kChunk * (kKSlice + kPadB) +
                                   C * (kChunk + kPadB) + kRows * (kChunk + kPadB)) +
         sizeof(float) * kRows * (kChunk + kPadF);
}

// Drop: gelu(h) goes through the dropout d1 of element (token, hidden column).
template <int C, bool Drop>
__global__ void __launch_bounds__(kThreads)
ffn_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
           const float* __restrict__ ln_b, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           float* __restrict__ part, int M, int hidden, int chunks_per_split, float eps,
           philox::Drop d1) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldA = C + kPadB;
  constexpr int ldW1 = kKSlice + kPadB;
  constexpr int ldW2 = kChunk + kPadB;
  constexpr int ldH = kChunk + kPadB;
  constexpr int ldHf = kChunk + kPadF;
  __nv_bfloat16* lnA = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][ldA]
  __nv_bfloat16* w1s = lnA + kRows * ldA;                       // [kChunk][ldW1]  (n, k)
  __nv_bfloat16* w2s = w1s + kChunk * ldW1;                     // [C][ldW2]       (n, k)
  __nv_bfloat16* hb = w2s + C * ldW2;                           // [kRows][ldH]
  float* hs = reinterpret_cast<float*>(hb + kRows * ldH);       // [kRows][ldHf]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  ln_rows_bf16<C>(x, ln_w, ln_b, lnA, ldA, row0, M, eps);

  // This warp's output columns [warp * kCols, (warp + 1) * kCols), all rows.
  constexpr int kCols = C / 8;
  constexpr int kColTiles = kCols / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kColTiles];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int ct = 0; ct < kColTiles; ++ct) wmma::fill_fragment(acc[rt][ct], 0.f);
  // This warp's tile of the hidden chunk: rows hr*16, columns hc*16.
  const int hr = warp >> 2, hc = warp & 3;
  __syncthreads();

  const int j_begin = blockIdx.y * chunks_per_split * kChunk;
  const int j_end = min(hidden, j_begin + chunks_per_split * kChunk);
  for (int j0 = j_begin; j0 < j_end; j0 += kChunk) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc;
    wmma::fill_fragment(hacc, 0.f);
    for (int k0 = 0; k0 < C; k0 += kKSlice) {
      for (int i = tid; i < kChunk * kKSlice; i += kThreads) {
        const int n = i / kKSlice, k = i % kKSlice;
        w1s[n * ldW1 + k] = __float2bfloat16(w1[(size_t)(j0 + n) * C + k0 + k]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKSlice; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, lnA + hr * 16 * ldA + k0 + kk, ldA);
        wmma::load_matrix_sync(b, w1s + hc * 16 * ldW1 + kk, ldW1);
        wmma::mma_sync(hacc, a, b, hacc);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(hs + hr * 16 * ldHf + hc * 16, hacc, ldHf, wmma::mem_row_major);
    for (int i = tid; i < C * kChunk; i += kThreads) {
      const int n = i / kChunk, k = i % kChunk;
      w2s[n * ldW2 + k] = __float2bfloat16(w2[(size_t)n * hidden + j0 + k]);
    }
    __syncthreads();
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      const float h = hs[r * ldHf + k] + b1[j0 + k];
      float a = h * 0.5f * (1.f + erff(h * 0.70710678118654752f));
      if (Drop) a = philox::apply(d1, (unsigned long long)(row0 + r) * hidden + j0 + k, a);
      hb[r * ldH + k] = __float2bfloat16(a);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, hb + kk, ldH);
      wmma::load_matrix_sync(a1, hb + 16 * ldH + kk, ldH);
#pragma unroll
      for (int ct = 0; ct < kColTiles; ++ct) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w2s + (warp * kCols + ct * 16) * ldW2 + kk, ldW2);
        wmma::mma_sync(acc[0][ct], a0, b, acc[0][ct]);
        wmma::mma_sync(acc[1][ct], a1, b, acc[1][ct]);
      }
    }
    __syncthreads();
  }

  // Epilogue through shared memory (the W2 staging area is free now): this
  // split's partial sum, rows past M dropped.
  constexpr int ldO = C + kPadF;
  float* os = reinterpret_cast<float*>(w2s);
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

// out = x + drop(sum_s part[s] + b2), the splits added in order; the dropout
// d2 of element (token, channel) keeps everything when its thr is 0.
__global__ void ffn_reduce_kernel(const float* __restrict__ x, const float* __restrict__ part,
                                  const float* __restrict__ b2, float* __restrict__ out, int M,
                                  int C, int splits, philox::Drop d2) {
  const size_t n = (size_t)M * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int s = 1; s < splits; ++s) acc += part[s * n + i];
    out[i] = x[i] + philox::apply(d2, i, acc + b2[i % C]);
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

template <int C, bool Drop = false>
cudaError_t launch(const float* x, const float* ln_w, const float* ln_b, const float* w1,
                   const float* b1, const float* w2, float* part, int M, int hidden,
                   int splits, float eps, cudaStream_t stream,
                   philox::Drop d1 = philox::Drop{}) {
  static_assert(sizeof(float) * kRows * (C + kPadF) <=
                    sizeof(__nv_bfloat16) * C * (kChunk + kPadB),
                "epilogue tile must fit the W2 staging area");
  constexpr size_t bytes = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(ffn_kernel<C, Drop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int chunks_per_split = hidden / kChunk / splits;
  ffn_kernel<C, Drop><<<dim3((M + kRows - 1) / kRows, splits), kThreads, bytes, stream>>>(
      x, ln_w, ln_b, w1, b1, w2, part, M, hidden, chunks_per_split, eps, d1);
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

// out = x + drop(sum of the splits + b2) after the main kernel has filled part.
cudaError_t fwd_reduce(const float* x, const float* part, const float* b2, float* out, int M,
                       int C, int splits, philox::Drop d2, cudaStream_t stream) {
  const int threads = 256;
  const size_t want = ((size_t)M * C + threads - 1) / threads;
  const int blocks = want < 1024 ? (int)want : 1024;
  ffn_reduce_kernel<<<blocks, threads, 0, stream>>>(x, part, b2, out, M, C, splits, d2);
  return cudaGetLastError();
}

}  // namespace

// part: (splits, M, C) f32 workspace; splits must divide hidden / 64.
extern "C" int ffn_forward(const float* x, const float* ln_w, const float* ln_b,
                           const float* w1, const float* b1, const float* w2, const float* b2,
                           float* part, float* out, int M, int C, int hidden, int splits,
                           float eps, cudaStream_t stream) {
  if (hidden % kChunk != 0 || splits < 1 || (hidden / kChunk) % splits != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (C) {
    case 128: err = launch<128>(x, ln_w, ln_b, w1, b1, w2, part, M, hidden, splits, eps, stream); break;
    case 256: err = launch<256>(x, ln_w, ln_b, w1, b1, w2, part, M, hidden, splits, eps, stream); break;
    case 512: err = launch<512>(x, ln_w, ln_b, w1, b1, w2, part, M, hidden, splits, eps, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)fwd_reduce(x, part, b2, out, M, C, splits, philox::Drop{0u, 0u, 0u, 0u, 0u, 1.f},
                         stream);
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
// the stream (seed_lo, seed_hi, site), tensors 0 and 1.  Workspace as ffn_forward.
extern "C" int ffn_dropout_forward(const float* x, const float* ln_w, const float* ln_b,
                                   const float* w1, const float* b1, const float* w2,
                                   const float* b2, float* part, float* out, int M, int C,
                                   int hidden, int splits, float eps, unsigned seed_lo,
                                   unsigned seed_hi, unsigned site, unsigned thr_act,
                                   float keep_act, unsigned thr_out, float keep_out,
                                   cudaStream_t stream) {
  if (hidden % kChunk != 0 || splits < 1 || (hidden / kChunk) % splits != 0)
    return (int)cudaErrorInvalidValue;
  const philox::Drop d1{seed_lo, seed_hi, site, 0u, thr_act, keep_act};
  const philox::Drop d2{seed_lo, seed_hi, site, 1u, thr_out, keep_out};
  cudaError_t err;
  switch (C) {
    case 128: err = launch<128, true>(x, ln_w, ln_b, w1, b1, w2, part, M, hidden, splits, eps, stream, d1); break;
    case 256: err = launch<256, true>(x, ln_w, ln_b, w1, b1, w2, part, M, hidden, splits, eps, stream, d1); break;
    case 512: err = launch<512, true>(x, ln_w, ln_b, w1, b1, w2, part, M, hidden, splits, eps, stream, d1); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)fwd_reduce(x, part, b2, out, M, C, splits, d2, stream);
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
