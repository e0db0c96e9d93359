// Pieces shared by the all-gradients backward kernels (ffn.cu, attention.cu,
// groupnorm.cu).  A parameter gradient is a sum over every token, and CUDA
// blocks run in no order, so nothing here adds into a shared result: each
// block writes its partial sum into an f32 workspace and sum_partials_kernel
// adds the partials in a fixed order.  No atomics: the same inputs give the
// same bits on every run.
//
//   tn_gemm_kernel         part[z] = A[rows of split z]^T . B[rows of split z]
//                          (a weight gradient: both operands are (tokens, width)
//                          and the product contracts over the tokens), bf16
//                          operands on the tensor cores, f32 accumulation
//   ln_vec_partial_kernel  per block of 32 rows, the column sums of dln . nhat,
//                          dln and g: the LayerNorm scale / bias gradients and
//                          the output bias gradient (of g through the module's
//                          output dropout, where it has one)
//   sum_partials_kernel    out[i] = sum_z part[z][i], z in order
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "philox.cuh"

namespace gradk {

using namespace nvcuda;

constexpr int kTP = 64, kTQ = 64, kTK = 64;  // output tile P x Q, K rows per slice
constexpr int kTnThreads = 128;              // 4 warps, 32 x 32 of the tile each
constexpr int kTLd = 64 + 8;                 // bf16 staging row stride
constexpr int kTLdC = kTQ + 4;               // f32 epilogue row stride
constexpr int kVecRows = 32;                 // rows per block of ln_vec_partial_kernel
constexpr int kVecThreads = 256;

__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 8 consecutive values of a row as bf16; p is 32-byte (f32) or 16-byte (bf16) aligned.
__device__ __forceinline__ uint4 load8(const float* __restrict__ p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
}
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p) {
  return *reinterpret_cast<const uint4*>(p);
}

// part[z, p, q] = sum over the rows m of split z of A[m, p] * B[m, q].
// A (M, P) and B (M, Q) row-major, f32 (rounded to bf16 as they are staged)
// or bf16; P and Q multiples of 64; split z owns rows [z, z + 1) * rows_per_split,
// a multiple of kTK; rows past M count as zeros.
template <typename TA, typename TB>
__global__ void __launch_bounds__(kTnThreads)
tn_gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B, float* __restrict__ part,
               int M, int P, int Q, int rows_per_split) {
  __shared__ __align__(32) __nv_bfloat16 As[kTK * kTLd];  // [m][p]
  __shared__ __align__(32) __nv_bfloat16 Bs[kTK * kTLd];  // [m][q]
  __shared__ __align__(32) float Cs[kTP * kTLdC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ, p0 = blockIdx.y * kTP;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int wr = warp >> 1, wc = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int m0 = m_begin; m0 < m_end; m0 += kTK) {
    for (int i = tid; i < kTK * 8; i += kTnThreads) {
      const int r = i >> 3, c8 = (i & 7) * 8;
      const int m = m0 + r;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (m < m_end) {
        va = load8(A + (size_t)m * P + p0 + c8);
        vb = load8(B + (size_t)m * Q + q0 + c8);
      }
      *reinterpret_cast<uint4*>(As + r * kTLd + c8) = va;
      *reinterpret_cast<uint4*>(Bs + r * kTLd + c8) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * kTLd + wr * 32 + i * 16, kTLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kTLd + wc * 32 + j * 16, kTLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kTLdC + wc * 32 + j * 16, acc[i][j],
                              kTLdC, wmma::mem_row_major);
  __syncthreads();
  float* dst = part + ((size_t)blockIdx.z * P + p0) * Q + q0;
  for (int i = tid; i < kTP * kTQ; i += kTnThreads) {
    const int r = i / kTQ, n = i % kTQ;
    dst[(size_t)r * Q + n] = Cs[r * kTLdC + n];
  }
}

// out[i] = sum_z part[z * n + i], z = 0 .. splits - 1 in order.
static __global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int z = 1; z < splits; ++z) acc += part[z * n + i];
    out[i] = acc;
  }
}

// Block b owns rows [b, b + 1) * kVecRows of x, g (M, C) and of
// dln = sum_s dln_part[s] ((splits, M, C)); with nhat the normalised x it writes
//   vpart[b, 0, c] = sum_rows dln * nhat   (LayerNorm scale gradient)
//   vpart[b, 1, c] = sum_rows dln          (LayerNorm bias gradient)
//   vpart[b, 2, c] = sum_rows drop(g)      (output bias gradient; gdrop is the
//                                           output dropout of element (row, c),
//                                           which keeps everything at thr 0)
static __global__ void __launch_bounds__(kVecThreads)
ln_vec_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ dln_part, int splits, float* __restrict__ vpart,
                      int M, int C, float eps, philox::Drop gdrop) {
  __shared__ float mu_s[kVecRows], rs_s[kVecRows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kVecRows;
  for (int r = warp; r < kVecRows; r += kVecThreads / 32) {
    const int gr = row0 + r;
    float mu = 0.f, rs = 0.f;
    if (gr < M) {
      const float* xr = x + (size_t)gr * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += xr[c];
      mu = warp_sum_all(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = xr[c] - mu;
        v += d * d;
      }
      rs = rsqrtf(warp_sum_all(v) / C + eps);
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rs_s[r] = rs;
    }
  }
  __syncthreads();
  const size_t n = (size_t)M * C;
  const int rows = min(kVecRows, M - row0);
  for (int c = tid; c < C; c += kVecThreads) {
    float sg = 0.f, sb = 0.f, so = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t idx = (size_t)(row0 + r) * C + c;
      float dln = dln_part[idx];
      for (int s = 1; s < splits; ++s) dln += dln_part[s * n + idx];
      sg += dln * (x[idx] - mu_s[r]) * rs_s[r];
      sb += dln;
      so += philox::apply(gdrop, idx, g[idx]);
    }
    float* dst = vpart + (size_t)blockIdx.x * 3 * C;
    dst[c] = sg;
    dst[C + c] = sb;
    dst[2 * C + c] = so;
  }
}

template <typename TA, typename TB>
cudaError_t tn_gemm(const TA* A, const TB* B, float* part, int M, int P, int Q, int ksplit,
                    cudaStream_t stream) {
  int rows = (M + ksplit - 1) / ksplit;
  rows = (rows + kTK - 1) / kTK * kTK;
  tn_gemm_kernel<TA, TB><<<dim3(Q / kTQ, P / kTP, ksplit), kTnThreads, 0, stream>>>(
      A, B, part, M, P, Q, rows);
  return cudaGetLastError();
}

inline cudaError_t sum_partials(const float* part, float* out, size_t n, int splits,
                                cudaStream_t stream) {
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  sum_partials_kernel<<<(int)(want < 2048 ? want : 2048), threads, 0, stream>>>(part, out, n,
                                                                               splits);
  return cudaGetLastError();
}

// The weight gradient A^T . B into out (P, Q): straight into out with one
// split, else through ws ((ksplit, P, Q) f32) and the ordered sum.
template <typename TA, typename TB>
cudaError_t weight_grad(const TA* A, const TB* B, float* ws, float* out, int M, int P, int Q,
                        int ksplit, cudaStream_t stream) {
  if (ksplit == 1) return tn_gemm(A, B, out, M, P, Q, 1, stream);
  cudaError_t err = tn_gemm(A, B, ws, M, P, Q, ksplit, stream);
  if (err != cudaSuccess) return err;
  return sum_partials(ws, out, (size_t)P * Q, ksplit, stream);
}

// vec (3, C) = the column sums of ln_vec_partial_kernel over all rows;
// vpart: (ceil(M / 32), 3, C) f32 workspace.
inline cudaError_t ln_vec_grads(const float* x, const float* g, const float* dln_part,
                                int splits, float* vpart, float* vec, int M, int C, float eps,
                                cudaStream_t stream,
                                philox::Drop gdrop = philox::Drop{0u, 0u, 0u, 0u, 0u, 1.f}) {
  const int blocks = (M + kVecRows - 1) / kVecRows;
  ln_vec_partial_kernel<<<blocks, kVecThreads, 0, stream>>>(x, g, dln_part, splits, vpart, M, C,
                                                            eps, gdrop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(vpart, vec, (size_t)3 * C, blocks, stream);
}

}  // namespace gradk
