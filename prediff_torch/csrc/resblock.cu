// Whole TimeEmbedResBlock (identity skip, non-scale-shift), channel-last
// (B, T, H, W, C) f32:
//   out = x + conv2(silu(GN2(h2 + emb))) + b2,   h2 = conv1(silu(GN1(x))) + b1,
// and its input gradient (dx, demb) for an output cotangent g.
//
// Replaces prediff_tpu/ops/pallas_resblock.py::fused_resblock
// (_resblock_fwd_kernel) and ::_fused_resblock_bwd (_resblock_bwd_kernel).
// The TPU kernel keeps the whole zero-padded volume in VMEM (about 660 KB at
// 6x16x16x128 in bf16) and carries each GroupNorm's sums across its
// sequential loop.  A Hopper block has at most 227 KB of shared memory and
// blocks run in no order, so the block runs as six launches each way (a
// conv is conv3_kernel + conv_epilogue_kernel):
//   forward   gn_silu_group_kernel  GN1 of x -> h1 = silu(.) in bf16
//             conv                   h2 = conv1(h1) + b1, stored bf16 (saved)
//             gn_silu_group_kernel  GN2 of h2 + emb -> h3 = silu(.) in bf16
//             conv                   out = conv2(h3) + b2 + x       (f32)
//   backward  conv                   dh3 = conv2^T(g) in bf16
//             gn_silu_bwd_group_kernel  dv = GN2 / SiLU backward in bf16,
//                                    demb = sum of dv over the tokens
//             conv                   dh1 = conv1^T(dv) in bf16
//             gn_silu_bwd_group_kernel  dx = GN1 / SiLU backward + g  (f32)
// A GroupNorm reduces over the whole volume, so a GN kernel gives one block
// to each (group, sample): it holds the group's statistics itself and makes
// its passes over the group's tokens (two-pass mean / variance, as the TPU
// kernel does; the backward also sums u and u * xhat, and dv's per-channel
// sums for demb).  A transposed conv is the same SAME conv with flipped taps
// and in / out channels swapped (pallas_resblock.py:545-546); the wrapper
// lays the weights out as (27, K, N) f32 for either direction, so one conv
// kernel serves all four.
//
// Bound: each 3x3x3 conv is 2 * 27 * C^2 operations per token; at the
// alignment shapes the convs' operations and the f32 weights' bytes are of
// one size (1536 tokens x 128: operations; 384 x 256: the 14 MB of weights),
// so the block sits near the card's ridge point.  The conv is the implicit
// GEMM of conv3.cuh (WMMA bf16, f32 accumulation, each tap's neighbour rows
// gathered into shared memory, no padded copy or im2col matrix in device
// memory), shared with the standalone conv of conv3d.cu.  The alignment
// shapes give so few (token, channel) tiles that the 27 taps are split kTapSplits ways
// (3 taps each) into an f32 (splits, M, N) workspace, which its epilogue adds
// in a fixed order with the bias and the skip.
//
// Rounding points follow the TPU kernel: h1, h2, h3, dh3, dv and dh1 are
// bf16, as are the conv weights and g as a conv operand; GN2's statistics
// are taken from the bf16 h2; every sum, x, out, dx and demb stay f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

#include "conv3.cuh"

namespace {

constexpr int kGnThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; every thread gets it.  red: >= 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red is free: every thread is past the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nw ? red[lane] : 0.f);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

__device__ __forceinline__ float silu_grad(float a) {
  const float s = 1.f / (1.f + expf(-a));
  return s * (1.f + a * (1.f - s));
}

// Mean and 1/sqrt(var + eps) of src (+ emb) over one (group, sample): N
// tokens x cpg channels, two passes.
template <typename InT>
__device__ void group_stats(const InT* __restrict__ src, const float* __restrict__ emb, int N,
                            int C, int cpg, float eps, float* red, float& mean, float& rstd) {
  const int count = N * cpg;
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int n = i / cpg, c = i % cpg;
    s += to_f(src[(size_t)n * C + c]) + (emb != nullptr ? emb[c] : 0.f);
  }
  mean = block_sum(s, red) / count;
  float v = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int n = i / cpg, c = i % cpg;
    const float d = to_f(src[(size_t)n * C + c]) + (emb != nullptr ? emb[c] : 0.f) - mean;
    v += d * d;
  }
  rstd = rsqrtf(block_sum(v, red) / count + eps);
}

// out = bf16(silu(GroupNorm(src + emb))), one block per (group, sample).
template <typename InT>
__global__ void __launch_bounds__(kGnThreads)
gn_silu_group_kernel(const InT* __restrict__ src, const float* __restrict__ emb,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     __nv_bfloat16* __restrict__ out, int N, int C, int groups, float eps) {
  __shared__ float red[32];
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / groups;
  const size_t off = (size_t)b * N * C + g * cpg;
  const InT* s = src + off;
  const float* e = emb != nullptr ? emb + (size_t)b * C + g * cpg : nullptr;
  float mean, rstd;
  group_stats(s, e, N, C, cpg, eps, red, mean, rstd);
  for (int i = threadIdx.x; i < N * cpg; i += blockDim.x) {
    const int n = i / cpg, c = i % cpg;
    const float v = to_f(s[(size_t)n * C + c]) + (e != nullptr ? e[c] : 0.f);
    const float a = (v - mean) * rstd * gamma[g * cpg + c] + beta[g * cpg + c];
    out[off + (size_t)n * C + c] = __float2bfloat16(silu(a));
  }
}

// Backward of y = silu(GroupNorm(src + emb)) for dy = dh (bf16), one block
// per (group, sample).  With u = dh * silu'(a) * gamma:
//   dv = rstd * (u - (sum(u) + xhat * sum(u * xhat)) / count)
// out = dv (+ skip); demb[c] = sum over tokens of dv (when demb != null).
// The block size must be a multiple of cpg, so each thread stays on one
// channel of the group.
template <typename InT, typename OutT>
__global__ void __launch_bounds__(kGnThreads)
gn_silu_bwd_group_kernel(const InT* __restrict__ src, const float* __restrict__ emb,
                         const __nv_bfloat16* __restrict__ dh, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const float* __restrict__ skip,
                         OutT* __restrict__ out, float* __restrict__ demb, int N, int C,
                         int groups, float eps) {
  __shared__ float red[kGnThreads];
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / groups;
  const int count = N * cpg;
  const size_t off = (size_t)b * N * C + g * cpg;
  const InT* s = src + off;
  const float* e = emb != nullptr ? emb + (size_t)b * C + g * cpg : nullptr;
  float mean, rstd;
  group_stats(s, e, N, C, cpg, eps, red, mean, rstd);
  const int c = threadIdx.x % cpg;  // this thread's channel in the group
  const float gam = gamma[g * cpg + c], bet = beta[g * cpg + c];
  const float ec = e != nullptr ? e[c] : 0.f;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const size_t idx = (size_t)(i / cpg) * C + c;
    const float xhat = (to_f(s[idx]) + ec - mean) * rstd;
    const float u = __bfloat162float(dh[off + idx]) * silu_grad(xhat * gam + bet) * gam;
    s1 += u;
    s2 += u * xhat;
  }
  const float S1 = block_sum(s1, red), S2 = block_sum(s2, red);
  float dsum = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const size_t idx = (size_t)(i / cpg) * C + c;
    const float xhat = (to_f(s[idx]) + ec - mean) * rstd;
    const float u = __bfloat162float(dh[off + idx]) * silu_grad(xhat * gam + bet) * gam;
    const float dv = rstd * (u - (S1 + xhat * S2) / count);
    dsum += dv;
    store(out + off + idx, dv + (skip != nullptr ? skip[off + idx] : 0.f));
  }
  if (demb != nullptr) {
    __syncthreads();
    red[threadIdx.x] = dsum;
    __syncthreads();
    if (threadIdx.x < cpg) {
      float t = 0.f;
      for (int j = threadIdx.x; j < blockDim.x; j += cpg) t += red[j];
      demb[(size_t)b * C + g * cpg + threadIdx.x] = t;
    }
  }
}

constexpr int kTapSplits = 9;   // the convs' tap split (3 taps each), csrc/conv3.cuh

template <typename InT, typename OutT>
cudaError_t conv(const InT* in, const float* w, const float* bias, const float* skip, float* part,
                 OutT* out, int B, int T, int H, int W, int C, cudaStream_t stream) {
  return conv<InT, OutT>(in, w, bias, skip, part, out, B, T, H, W, C, C, kTapSplits, stream);
}

bool supported(int C, int groups) {
  if (C % kCN != 0 || groups < 1 || C % groups != 0) return false;
  const int cpg = C / groups;
  return kGnThreads % cpg == 0;
}

}  // namespace

// Forward.  w1, w2: (27, C, C) f32 laid out as [tap][in][out]; h: (B, N, C)
// bf16 scratch; h2: (B, N, C) bf16, kept for the backward; part: the convs'
// (kTapSplits, B*N, C) f32 workspace; out (B, N, C) f32.
extern "C" int resblock_forward(const float* x, const float* emb, const float* w1,
                                const float* b1, const float* w2, const float* b2,
                                const float* g1s, const float* g1b, const float* g2s,
                                const float* g2b, __nv_bfloat16* h, __nv_bfloat16* h2,
                                float* part, float* out, int B, int T, int H, int W, int C,
                                int groups, float eps, cudaStream_t stream) {
  if (!supported(C, groups)) return (int)cudaErrorInvalidValue;
  const int N = T * H * W;
  const dim3 gn_grid(groups, B);
  gn_silu_group_kernel<float><<<gn_grid, kGnThreads, 0, stream>>>(x, nullptr, g1s, g1b, h, N, C,
                                                                  groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = conv(h, w1, b1, nullptr, part, h2, B, T, H, W, C, stream);
  if (err != cudaSuccess) return (int)err;
  gn_silu_group_kernel<__nv_bfloat16><<<gn_grid, kGnThreads, 0, stream>>>(h2, emb, g2s, g2b, h,
                                                                          N, C, groups, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)conv(h, w2, b2, x, part, out, B, T, H, W, C, stream);
}

// Backward.  w1t, w2t: (27, C, C) f32, the flipped taps laid out as
// [tap][out][in]; dh, dv: (B, N, C) bf16 scratch; part as in the forward;
// dx (B, N, C), demb (B, C).
extern "C" int resblock_backward(const float* x, const float* emb, const float* g,
                                 const __nv_bfloat16* h2, const float* w1t, const float* w2t,
                                 const float* g1s, const float* g1b, const float* g2s,
                                 const float* g2b, __nv_bfloat16* dh, __nv_bfloat16* dv,
                                 float* part, float* dx, float* demb, int B, int T, int H, int W,
                                 int C, int groups, float eps, cudaStream_t stream) {
  if (!supported(C, groups)) return (int)cudaErrorInvalidValue;
  const int N = T * H * W;
  const dim3 gn_grid(groups, B);
  cudaError_t err = conv(g, w2t, nullptr, nullptr, part, dh, B, T, H, W, C, stream);
  if (err != cudaSuccess) return (int)err;
  gn_silu_bwd_group_kernel<__nv_bfloat16, __nv_bfloat16><<<gn_grid, kGnThreads, 0, stream>>>(
      h2, emb, dh, g2s, g2b, nullptr, dv, demb, N, C, groups, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = conv(dv, w1t, nullptr, nullptr, part, dh, B, T, H, W, C, stream);
  if (err != cudaSuccess) return (int)err;
  gn_silu_bwd_group_kernel<float, float><<<gn_grid, kGnThreads, 0, stream>>>(
      x, nullptr, dh, g1s, g1b, g, dx, nullptr, N, C, groups, eps);
  return (int)cudaGetLastError();
}
