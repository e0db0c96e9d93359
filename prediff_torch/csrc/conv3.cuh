// SAME 3x3x3 stride-1 convolution as an implicit GEMM on the tensor cores,
// channel-last (B, T, H, W, K) -> (B, T, H, W, N): the whole-resblock
// kernels' four convs (resblock.cu; the standalone conv, conv3d.cu, is its own
// TMA + wgmma kernel):
//   part[z, m, n] = sum_{tap in split z, k} in[m + off(tap), k] . w[tap, k, n]
//   out[m, n]     = sum_z part[z, m, n] (+ bias[n]) (+ skip[m, n])
// with M = B*T*H*W tokens, w (27, K, N) f32 laid out as [tap][in][out] (a
// transposed conv is the same conv with flipped taps and in / out swapped),
// in f32 or bf16, part (splits, M, N) f32.
//
// A block owns kCM tokens x kCN output channels and walks its share of
// K = 27 taps x K channels in slices of kCK, gathering each tap's neighbour
// rows (zero outside the volume) into shared memory as bf16, so no padded
// copy or im2col matrix reaches device memory; the products run as WMMA bf16
// with f32 accumulation, and the next slice is loaded into registers while
// the tensor cores work on the current one.  Few tokens give few (token,
// channel) tiles, so the 27 taps are also split over a third grid axis
// (splits in {1, 3, 9, 27}, 27 / splits taps each) into the f32 workspace,
// and conv_epilogue_kernel adds the splits in a fixed order (no atomics: two
// runs are bit-equal) with the bias and the skip.  wgmma, TMA and a
// persistent schedule are later work.
//
// Needs K % kCK == 0 (a slice never straddles two taps; 16-byte row loads)
// and N % kCN == 0.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kCM = 32, kCN = 64, kCK = 32, kConvThreads = 128;  // 4 warps, 16 x 32 each
constexpr int kLdA = kCK + 8;   // bf16 row strides (keep 32-byte alignment)
constexpr int kLdB = kCN + 8;
constexpr int kLdO = kCN + 4;   // f32 epilogue row stride

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 8 consecutive channels of one row as bf16 (16-byte aligned).
__device__ __forceinline__ uint4 load8(const float* __restrict__ p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                    pack_bf16x2(b.z, b.w));
}
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename InT>
__global__ void __launch_bounds__(kConvThreads)
conv3_kernel(const InT* __restrict__ in, const float* __restrict__ w, float* __restrict__ part,
             int B, int T, int H, int W, int K, int N) {
  __shared__ __align__(32) __nv_bfloat16 As[kCM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kCK * kLdB];
  __shared__ __align__(32) float Os[kCM * kLdO];
  __shared__ int tok[kCM][4];  // (b, t, h, w) of each row; b = -1 past the end
  const int tid = threadIdx.x, warp = tid >> 5;
  const int M = B * T * H * W;
  const int m0 = blockIdx.y * kCM, n0 = blockIdx.x * kCN;
  if (tid < kCM) {
    const int m = m0 + tid;
    tok[tid][0] = m < M ? m / (T * H * W) : -1;
    tok[tid][1] = (m / (H * W)) % T;
    tok[tid][2] = (m / W) % H;
    tok[tid][3] = m % W;
  }
  const int wr = warp >> 1, wc = warp & 1;  // rows wr*16, columns wc*32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  const int ar = tid >> 2, aq = (tid & 3) * 8;  // this thread's A row and channel offset
  const int taps = 27 / gridDim.z;
  const int k_begin = blockIdx.z * taps * K, k_end = k_begin + taps * K;
  __syncthreads();

  uint4 a_next;       // the next K slice, staged in registers
  float4 b_next[4];
  auto fetch = [&](int k0) {
    const int tap = k0 / K, c0 = k0 % K;
    const int b = tok[ar][0];
    const int t = tok[ar][1] + tap / 9 - 1, h = tok[ar][2] + (tap / 3) % 3 - 1,
              x = tok[ar][3] + tap % 3 - 1;
    a_next = (b >= 0 && t >= 0 && t < T && h >= 0 && h < H && x >= 0 && x < W)
                 ? load8(in + ((((size_t)b * T + t) * H + h) * W + x) * K + c0 + aq)
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = tid + s * kConvThreads, k = i / (kCN / 4), n = (i % (kCN / 4)) * 4;
      b_next[s] = *reinterpret_cast<const float4*>(w + (size_t)(k0 + k) * N + n0 + n);
    }
  };
  auto stage = [&]() {
    *reinterpret_cast<uint4*>(As + ar * kLdA + aq) = a_next;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = tid + s * kConvThreads, k = i / (kCN / 4), n = (i % (kCN / 4)) * 4;
      *reinterpret_cast<uint2*>(Bs + k * kLdB + n) =
          make_uint2(pack_bf16x2(b_next[s].x, b_next[s].y), pack_bf16x2(b_next[s].z, b_next[s].w));
    }
  };
  fetch(k_begin);
  stage();
  __syncthreads();
  for (int k0 = k_begin; k0 < k_end; k0 += kCK) {
    const bool more = k0 + kCK < k_end;
    if (more) fetch(k0 + kCK);
#pragma unroll
    for (int kk = 0; kk < kCK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + wr * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Bs + kk * kLdB + wc * 32 + j * 16, kLdB);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Os + wr * 16 * kLdO + wc * 32 + j * 16, acc[j], kLdO,
                            wmma::mem_row_major);
  __syncthreads();
  float* dst = part + (size_t)blockIdx.z * M * N;
  for (int i = tid; i < kCM * kCN; i += kConvThreads) {
    const int r = i / kCN, n = i % kCN;
    if (m0 + r < M) dst[(size_t)(m0 + r) * N + n0 + n] = Os[r * kLdO + n];
  }
}

// out = sum_z part[z] (+ bias) (+ skip), the splits added in order.
template <typename OutT>
__global__ void conv_epilogue_kernel(const float* __restrict__ part, int splits,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ skip, OutT* __restrict__ out,
                                     int M, int N) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int z = 1; z < splits; ++z) v += part[z * n + i];
    if (bias != nullptr) v += bias[i % N];
    if (skip != nullptr) v += skip[i];
    store(out + i, v);
  }
}

// What conv() takes: the channel tiles, a tap split that divides 27, and a
// token count the grid's y axis holds.
bool conv_supported(int M, int K, int N, int splits) {
  return M >= 1 && K >= kCK && K % kCK == 0 && N >= kCN && N % kCN == 0 &&
         (splits == 1 || splits == 3 || splits == 9 || splits == 27) &&
         (M + kCM - 1) / kCM <= 65535;
}

// in (B, T, H, W, K), w (27, K, N) f32, bias (N) / skip (M, N) f32 or null,
// part (splits, M, N) f32 workspace, out (M, N).  Two launches.
template <typename InT, typename OutT>
cudaError_t conv(const InT* in, const float* w, const float* bias, const float* skip, float* part,
                 OutT* out, int B, int T, int H, int W, int K, int N, int splits,
                 cudaStream_t stream) {
  const int M = B * T * H * W;
  conv3_kernel<InT><<<dim3(N / kCN, (M + kCM - 1) / kCM, splits), kConvThreads, 0, stream>>>(
      in, w, part, B, T, H, W, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t want = ((size_t)M * N + 255) / 256;
  conv_epilogue_kernel<OutT><<<want < 1024 ? (int)want : 1024, 256, 0, stream>>>(
      part, splits, bias, skip, out, M, N);
  return cudaGetLastError();
}

}  // namespace
