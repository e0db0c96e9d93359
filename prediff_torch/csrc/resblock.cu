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
// blocks run in no order, so the block runs as four launches forward and
// five backward:
//   forward   GN pass                GN1 of x -> h1 = silu(.) in bf16
//             conv                   h2 = conv1(h1) + b1, stored bf16 (saved)
//             GN pass                GN2 of h2 + emb -> h3 = silu(.) in bf16
//             conv                   out = conv2(h3) + b2 + x       (f32)
//   backward  to_bf16_kernel         g in bf16 (the conv's operand)
//             conv                   dh3 = conv2^T(g) in bf16
//             GN backward pass       dv = GN2 / SiLU backward in bf16,
//                                    demb = sum of dv over the tokens
//             conv                   dh1 = conv1^T(dv) in bf16
//             GN backward pass       dx = GN1 / SiLU backward + g  (f32)
// A GroupNorm reduces over the whole volume.  Each GN pass is one launch of
// row 1's design (groupnorm.cu gn_cluster_kernel): a thread-block cluster
// of 1-8 blocks per (group, sample) along the tokens (ops/groupnorm.
// gn_bwd_plan, one plan for both directions), the group's values read once
// into shared memory, Welford per thread and Chan merges across warps and
// ranks in rank order.  The forward passes are gn_silu_cluster_kernel below;
// the backward passes are gn_cluster.cuh's bwd_kernel, row 14's
// all-gradients kernel without dgamma / dbeta: the values and dh in shared
// memory (16-byte copies where the group's channels allow), the sums of u
// and u * xhat and demb's per-channel sums added over the ranks in rank
// order.  Only a group past a cluster of 8 blocks' shared memory takes the
// first design's kernels (gn_silu_group_kernel, gn_silu_bwd_group_kernel:
// one block per (group, sample) making its passes over the group's tokens,
// two-pass mean / variance), chosen by shape in the plan.  A transposed conv
// is the same SAME conv with flipped taps and in / out channels swapped
// (pallas_resblock.py:545-546).
//
// Bound: each 3x3x3 conv is 2 * 27 * C^2 operations per token; at the
// alignment shapes the convs' operations and the weights' bytes are of one
// size (1536 tokens x 128: operations; 384 x 256: the weights), so the block
// sits near the card's ridge point.  The four convs run on the standalone
// conv's kernel (conv_wgmma.cuh: TMA + wgmma, SAME padding from the TMA
// unit's zero fill, the taps split over a thread-block cluster whose
// partials are added in rank order through distributed shared memory), with
// the epilogues the block needs: + b1 stored bf16 (h2), + b2 + x stored f32
// (out), a plain bf16 store (dh3, dh1).  Their inputs h1, h3 and dv are
// bf16 already, so only g is rounded by a launch of its own.  The weights
// are the bf16 (27, N, K) layouts of ops/conv3d.py, the forward's and the
// flipped transpose, laid out once per parameter version with their tensor
// maps (conv3x3x3_weight_map), so nothing of them is converted per call.
//
// Rounding points follow the TPU kernel: h1, h2, h3, dh3, dv and dh1 are
// bf16, as are the conv weights and g as a conv operand; GN2's statistics
// are taken from the bf16 h2; every sum, x, out, dx and demb stay f32.  The
// bf16 forms (resblock_forward_bf16, resblock_backward_bf16: guidance on the
// alignment net's bf16 copy, as the TPU kernel runs on bf16 x) read x, emb
// and g in bf16, take g as the conv's operand without the cast launch, and
// write out and dx in bf16, the skip added in f32 and rounded once; demb
// stays f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <string.h>

#include "conv_wgmma.cuh"
#include "gn_cluster.cuh"
#include "welford.cuh"

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

using gnc::silu_grad;

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

// Mean and 1/sqrt(var + eps) of src (+ emb) over one (group, sample): N
// tokens x cpg channels, two passes.
template <typename InT, typename ET>
__device__ void group_stats(const InT* __restrict__ src, const ET* __restrict__ emb, int N,
                            int C, int cpg, float eps, float* red, float& mean, float& rstd) {
  const int count = N * cpg;
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int n = i / cpg, c = i % cpg;
    s += to_f(src[(size_t)n * C + c]) + (emb != nullptr ? to_f(emb[c]) : 0.f);
  }
  mean = block_sum(s, red) / count;
  float v = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int n = i / cpg, c = i % cpg;
    const float d = to_f(src[(size_t)n * C + c]) + (emb != nullptr ? to_f(emb[c]) : 0.f) - mean;
    v += d * d;
  }
  rstd = rsqrtf(block_sum(v, red) / count + eps);
}

// out = bf16(silu(GroupNorm(src + emb))), one block per (group, sample).
template <typename InT, typename ET>
__global__ void __launch_bounds__(kGnThreads)
gn_silu_group_kernel(const InT* __restrict__ src, const ET* __restrict__ emb,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     __nv_bfloat16* __restrict__ out, int N, int C, int groups, float eps) {
  __shared__ float red[32];
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / groups;
  const size_t off = (size_t)b * N * C + g * cpg;
  const InT* s = src + off;
  const ET* e = emb != nullptr ? emb + (size_t)b * C + g * cpg : nullptr;
  float mean, rstd;
  group_stats(s, e, N, C, cpg, eps, red, mean, rstd);
  for (int i = threadIdx.x; i < N * cpg; i += blockDim.x) {
    const int n = i / cpg, c = i % cpg;
    const float v = to_f(s[(size_t)n * C + c]) + (e != nullptr ? to_f(e[c]) : 0.f);
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
template <typename InT, typename OutT, typename ET, typename SkT>
__global__ void __launch_bounds__(kGnThreads)
gn_silu_bwd_group_kernel(const InT* __restrict__ src, const ET* __restrict__ emb,
                         const __nv_bfloat16* __restrict__ dh, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const SkT* __restrict__ skip,
                         OutT* __restrict__ out, float* __restrict__ demb, int N, int C,
                         int groups, float eps) {
  __shared__ float red[kGnThreads];
  const int g = blockIdx.x, b = blockIdx.y, cpg = C / groups;
  const int count = N * cpg;
  const size_t off = (size_t)b * N * C + g * cpg;
  const InT* s = src + off;
  const ET* e = emb != nullptr ? emb + (size_t)b * C + g * cpg : nullptr;
  float mean, rstd;
  group_stats(s, e, N, C, cpg, eps, red, mean, rstd);
  const int c = threadIdx.x % cpg;  // this thread's channel in the group
  const float gam = gamma[g * cpg + c], bet = beta[g * cpg + c];
  const float ec = e != nullptr ? to_f(e[c]) : 0.f;
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
    store(out + off + idx, dv + (skip != nullptr ? to_f(skip[off + idx]) : 0.f));
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

// ---------------------------------------------------------------------------
// The GroupNorm passes in one launch each, row 1's design (groupnorm.cu
// gn_cluster_kernel): a thread-block cluster of `ranks` blocks per (group,
// sample) along the tokens, rank r holding tokens r * tpr .. r * tpr + tpr - 1
// of the group's channels in shared memory as f32 (read once), Welford per
// thread, Chan merges down each warp, across the warps and across the ranks
// in rank order through distributed shared memory (gn_cluster.cuh
// cluster_stats: the same bits on every rank and run).  The backward passes
// are gn_cluster.cuh's kernel, which row 14 (groupnorm.cu) runs too.

// out = bf16(silu(GroupNorm(src + emb))), src and emb f32 or bf16 (B, N, C).
template <typename InT, typename ET>
__global__ void __launch_bounds__(kGnThreads)
gn_silu_cluster_kernel(const InT* __restrict__ src, const ET* __restrict__ emb,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       __nv_bfloat16* __restrict__ out, int N, int C, int cpg, int tpr,
                       float eps) {
  extern __shared__ float xs[];   // [tpr][cpg] src + emb
  const int ranks = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = blockIdx.x % ranks, g = blockIdx.x / ranks, b = blockIdx.y, tid = threadIdx.x;
  const int n0 = rank * tpr, count = max(0, min(tpr, N - n0)) * cpg;
  const size_t base = ((size_t)b * N + n0) * C + (size_t)g * cpg;
  const int c = tid % cpg, ch = g * cpg + c;
  const float e = emb != nullptr ? to_f(emb[(size_t)b * C + ch]) : 0.f;
  for (int i = tid; i < count; i += kGnThreads) xs[i] = to_f(src[base + (size_t)(i / cpg) * C + c]) + e;
  __syncthreads();
  float mean, rstd;
  const float no_emb[1] = {0.f};   // emb is in xs already
  gnc::cluster_stats<1, false>(xs, count, 1, no_emb, eps, mean, rstd);
  const float gam = gamma[ch], bet = beta[ch];
  for (int i = tid; i < count; i += kGnThreads)
    out[base + (size_t)(i / cpg) * C + c] = __float2bfloat16(silu((xs[i] - mean) * rstd * gam + bet));
}

bool supported(int C, int groups) {
  if (C % 64 != 0 || groups < 1 || C % groups != 0) return false;
  const int cpg = C / groups;
  return kGnThreads % cpg == 0;
}

// The output-channel tile, token box and cluster split of the four convs
// (ops/conv3d.conv_tiles).
struct Tiles {
  int bn, bt, bh, bw, splits;
};

template <int Epi>
cudaError_t rconv(const __nv_bfloat16* in, const void* w_map, const float* bias, void* out,
                  const void* skip, int B, int T, int H, int W, int C, const Tiles& t,
                  cudaStream_t stream) {
  CUtensorMap w;
  memcpy(&w, w_map, sizeof(w));
  return conv::conv<Epi>(in, w, bias, out, skip, B, T, H, W, C, C, t.bn, t.bt, t.bh, t.bw,
                         t.splits, stream);
}

// The GroupNorm passes: in clusters of `ranks` blocks per (group, sample),
// tpr tokens a rank, where ranks > 0; else one block per (group, sample).
struct GnTiles {
  int ranks, tpr;
};

template <typename... Params, typename... Args>
cudaError_t launch_gn(void (*kernel)(Params...), int groups, int B, const GnTiles& t, int cpg,
                      cudaStream_t stream, Args... args) {
  const size_t smem = sizeof(float) * (size_t)t.tpr * cpg;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * t.ranks, B);
  cfg.blockDim = dim3(kGnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename InT, typename ET>
cudaError_t gn_silu(const InT* src, const ET* emb, const float* gamma, const float* beta,
                    __nv_bfloat16* out, int B, int N, int C, int groups, const GnTiles& t,
                    float eps, cudaStream_t stream) {
  const int cpg = C / groups;
  if (t.ranks == 0) {
    gn_silu_group_kernel<InT, ET><<<dim3(groups, B), kGnThreads, 0, stream>>>(
        src, emb, gamma, beta, out, N, C, groups, eps);
    return cudaGetLastError();
  }
  return launch_gn(gn_silu_cluster_kernel<InT, ET>, groups, B, t, cpg, stream, src, emb, gamma,
                   beta, out, N, C, cpg, t.tpr, eps);
}

template <typename InT, typename OutT, typename ET, typename SkT>
cudaError_t gn_silu_bwd(const InT* src, const ET* emb, const __nv_bfloat16* dh,
                        const float* gamma, const float* beta, const SkT* skip, OutT* out,
                        float* demb, int B, int N, int C, int groups, const GnTiles& t, float eps,
                        cudaStream_t stream) {
  const int cpg = C / groups;
  if (t.ranks == 0) {
    gn_silu_bwd_group_kernel<InT, OutT, ET, SkT><<<dim3(groups, B), kGnThreads, 0, stream>>>(
        src, emb, dh, gamma, beta, skip, out, demb, N, C, groups, eps);
    return cudaGetLastError();
  }
  // 16-byte copies where the group's channels allow: x, g and dx are 16-byte
  // aligned (the wrapper), h2, dh and dv fresh allocations
  return gnc::bwd<InT, __nv_bfloat16, OutT, false>(B, N, C, groups, t.ranks, t.tpr,
                                                   cpg % 4 == 0 ? 4 : 1, src, emb, dh, gamma,
                                                   beta, skip, out, demb, nullptr, eps, stream);
}

bool gn_tiles_ok(const GnTiles& t, int N) {
  return t.ranks == 0 || ((t.ranks == 1 || t.ranks == 2 || t.ranks == 4 || t.ranks == 8) &&
                          t.tpr >= 1 && (long long)t.ranks * t.tpr >= N);
}

// The block's launches.  T: x, emb, out, g and dx in f32, or all in bf16
// (the bf16 form: g is the conv's operand as it is, no cast launch; the
// output and dx add the skip in f32 and are rounded once).
template <typename T>
int forward(const T* x, const T* emb, const void* w1_map, const float* b1, const void* w2_map,
            const float* b2, const float* g1s, const float* g1b, const float* g2s,
            const float* g2b, __nv_bfloat16* h, __nv_bfloat16* h2, T* out, int B, int T_, int H,
            int W, int C, int groups, int bn, int bt, int bh, int bw, int splits, int gn_ranks,
            int gn_tpr, float eps, cudaStream_t stream) {
  const int N = T_ * H * W;
  const GnTiles gt{gn_ranks, gn_tpr};
  if (!supported(C, groups) || !gn_tiles_ok(gt, N)) return (int)cudaErrorInvalidValue;
  const Tiles t{bn, bt, bh, bw, splits};
  cudaError_t err = gn_silu(x, static_cast<const T*>(nullptr), g1s, g1b, h, B, N, C, groups, gt,
                            eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = rconv<conv::kBf16>(h, w1_map, b1, h2, nullptr, B, T_, H, W, C, t, stream);
  if (err != cudaSuccess) return (int)err;
  err = gn_silu(static_cast<const __nv_bfloat16*>(h2), emb, g2s, g2b, h, B, N, C, groups, gt, eps,
                stream);
  if (err != cudaSuccess) return (int)err;
  constexpr int kOut = sizeof(T) == 4 ? conv::kF32Skip : conv::kBf16Skip;
  return (int)rconv<kOut>(h, w2_map, b2, out, x, B, T_, H, W, C, t, stream);
}

template <typename T>
int backward(const T* x, const T* emb, const T* g, const __nv_bfloat16* h2, const void* w1t_map,
             const void* w2t_map, const float* g1s, const float* g1b, const float* g2s,
             const float* g2b, __nv_bfloat16* gb, __nv_bfloat16* dh, __nv_bfloat16* dv, T* dx,
             float* demb, int B, int T_, int H, int W, int C, int groups, int bn, int bt, int bh,
             int bw, int splits, int gn_ranks, int gn_tpr, float eps, cudaStream_t stream) {
  const int N = T_ * H * W;
  const GnTiles gt{gn_ranks, gn_tpr};
  if (!supported(C, groups) || !gn_tiles_ok(gt, N) || (reinterpret_cast<uintptr_t>(g) & 15))
    return (int)cudaErrorInvalidValue;
  const Tiles t{bn, bt, bh, bw, splits};
  const __nv_bfloat16* g_op = reinterpret_cast<const __nv_bfloat16*>(g);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = conv::to_bf16(reinterpret_cast<const float*>(g), gb, (size_t)B * N * C, stream);
    if (err != cudaSuccess) return (int)err;
    g_op = gb;
  }
  err = rconv<conv::kBf16>(g_op, w2t_map, nullptr, dh, nullptr, B, T_, H, W, C, t, stream);
  if (err != cudaSuccess) return (int)err;
  err = gn_silu_bwd<__nv_bfloat16, __nv_bfloat16>(h2, emb, dh, g2s, g2b,
                                                  static_cast<const float*>(nullptr), dv, demb, B,
                                                  N, C, groups, gt, eps, stream);
  if (err != cudaSuccess) return (int)err;
  err = rconv<conv::kBf16>(dv, w1t_map, nullptr, dh, nullptr, B, T_, H, W, C, t, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gn_silu_bwd<T, T>(x, static_cast<const float*>(nullptr), dh, g1s, g1b, g, dx,
                                static_cast<float*>(nullptr), B, N, C, groups, gt, eps, stream);
}

}  // namespace

using bf16_t = __nv_bfloat16;

// Forward.  w1_map, w2_map: the tensor maps of the bf16 (27, C, C) forward
// layouts of k1, k2 (conv3x3x3_weight_map); h: (B, N, C) bf16 scratch; h2:
// (B, N, C) bf16, kept for the backward; out (B, N, C) f32; the convs'
// output-channel tile bn (the weight maps' box rows), token box (bt, bh, bw)
// and cluster split; the GroupNorm passes' clusters of
// gn_ranks blocks of gn_tpr tokens (gn_ranks 0: a block per (group, sample)).
extern "C" int resblock_forward(const float* x, const float* emb, const void* w1_map,
                                const float* b1, const void* w2_map, const float* b2,
                                const float* g1s, const float* g1b, const float* g2s,
                                const float* g2b, bf16_t* h, bf16_t* h2, float* out, int B,
                                int T, int H, int W, int C, int groups, int bn, int bt, int bh,
                                int bw, int splits, int gn_ranks, int gn_tpr, float eps,
                                cudaStream_t stream) {
  return forward(x, emb, w1_map, b1, w2_map, b2, g1s, g1b, g2s, g2b, h, h2, out, B, T, H, W, C,
                 groups, bn, bt, bh, bw, splits, gn_ranks, gn_tpr, eps, stream);
}

// The bf16 form: x, emb and out (B, N, C) bf16; the rest as resblock_forward.
extern "C" int resblock_forward_bf16(const bf16_t* x, const bf16_t* emb, const void* w1_map,
                                     const float* b1, const void* w2_map, const float* b2,
                                     const float* g1s, const float* g1b, const float* g2s,
                                     const float* g2b, bf16_t* h, bf16_t* h2, bf16_t* out, int B,
                                     int T, int H, int W, int C, int groups, int bn, int bt,
                                     int bh, int bw, int splits, int gn_ranks, int gn_tpr,
                                     float eps, cudaStream_t stream) {
  return forward(x, emb, w1_map, b1, w2_map, b2, g1s, g1b, g2s, g2b, h, h2, out, B, T, H, W, C,
                 groups, bn, bt, bh, bw, splits, gn_ranks, gn_tpr, eps, stream);
}

// Backward.  w1t_map, w2t_map: the tensor maps of the bf16 flipped, transposed
// (27, C, C) layouts of k1, k2; gb, dh, dv: (B, N, C) bf16 scratch; dx (B, N,
// C), demb (B, C); the tiles as in the forward.
extern "C" int resblock_backward(const float* x, const float* emb, const float* g,
                                 const bf16_t* h2, const void* w1t_map, const void* w2t_map,
                                 const float* g1s, const float* g1b, const float* g2s,
                                 const float* g2b, bf16_t* gb, bf16_t* dh, bf16_t* dv, float* dx,
                                 float* demb, int B, int T, int H, int W, int C, int groups,
                                 int bn, int bt, int bh, int bw, int splits, int gn_ranks,
                                 int gn_tpr, float eps, cudaStream_t stream) {
  return backward(x, emb, g, h2, w1t_map, w2t_map, g1s, g1b, g2s, g2b, gb, dh, dv, dx, demb, B, T,
                  H, W, C, groups, bn, bt, bh, bw, splits, gn_ranks, gn_tpr, eps, stream);
}

// The bf16 form: x, emb, g and dx bf16 (gb unused); demb f32 as in the f32 form.
extern "C" int resblock_backward_bf16(const bf16_t* x, const bf16_t* emb, const bf16_t* g,
                                      const bf16_t* h2, const void* w1t_map, const void* w2t_map,
                                      const float* g1s, const float* g1b, const float* g2s,
                                      const float* g2b, bf16_t* gb, bf16_t* dh, bf16_t* dv,
                                      bf16_t* dx, float* demb, int B, int T, int H, int W, int C,
                                      int groups, int bn, int bt, int bh, int bw, int splits,
                                      int gn_ranks, int gn_tpr, float eps, cudaStream_t stream) {
  return backward(x, emb, g, h2, w1t_map, w2t_map, g1s, g1b, g2s, g2b, gb, dh, dv, dx, demb, B, T,
                  H, W, C, groups, bn, bt, bh, bw, splits, gn_ranks, gn_tpr, eps, stream);
}
