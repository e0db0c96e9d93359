// silu(GroupNorm(x + emb[b])) for x (B, N, C) f32, channel-last.
//
// Replaces prediff_tpu/ops/pallas_groupnorm.py::fused_groupnorm_silu (its
// _stats_kernel + _apply_kernel).  The TPU carried per-group sums across a
// sequential grid; here blocks run in no order, so the statistics take two
// launches:
//   gn_stats_kernel  grid (splits, B): each block reads a slice of tokens,
//                    every thread keeps a Welford (count, mean, M2) per
//                    channel (coalesced: neighbouring threads, neighbouring
//                    channels), then the channels of each group are merged
//                    (Chan's formula) into one partial per (b, split, group).
//   gn_apply_kernel  grid (token tiles, B): merges the partials of its
//                    sample, then normalise + affine + SiLU in one pass.
// Welford and Chan's merge never form E[x^2] - E[x]^2, so there is no
// cancellation when |mean| >> std.  emb is added in both passes, so x + emb
// never reaches memory.  No matrix product: the work is bound by bytes
// (x read twice, y written once), and the design keeps each pass to one
// coalesced sweep.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannelsPerThread = 4;  // C <= 1024

struct Stat {
  float n, mean, m2;
};

__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  float n = a.n + b.n;
  if (b.n == 0.f) return a;
  float d = b.mean - a.mean;
  float wb = b.n / n;
  Stat r;
  r.n = n;
  r.mean = a.mean + d * wb;
  r.m2 = a.m2 + b.m2 + d * d * a.n * wb;
  return r;
}

__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                float* __restrict__ part, int N, int C, int groups, int tok_per_split) {
  extern __shared__ Stat sh_stat[];  // C entries
  const int split = blockIdx.x, b = blockIdx.y, nsplit = gridDim.x;
  const int n0 = split * tok_per_split;
  const int n1 = min(N, n0 + tok_per_split);
  Stat st[kMaxChannelsPerThread];
  float e[kMaxChannelsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxChannelsPerThread; ++k) {
    int c = threadIdx.x + k * kThreads;
    st[k] = Stat{0.f, 0.f, 0.f};
    e[k] = (emb != nullptr && c < C) ? emb[(size_t)b * C + c] : 0.f;
  }
  const float* xb = x + (size_t)b * N * C;
  for (int n = n0; n < n1; ++n) {
#pragma unroll
    for (int k = 0; k < kMaxChannelsPerThread; ++k) {
      int c = threadIdx.x + k * kThreads;
      if (c < C) {
        float v = xb[(size_t)n * C + c] + e[k];
        st[k].n += 1.f;
        float d = v - st[k].mean;
        st[k].mean += d / st[k].n;
        st[k].m2 += d * (v - st[k].mean);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxChannelsPerThread; ++k) {
    int c = threadIdx.x + k * kThreads;
    if (c < C) sh_stat[c] = st[k];
  }
  __syncthreads();
  const int cpg = C / groups;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    Stat acc = sh_stat[g * cpg];
    for (int j = 1; j < cpg; ++j) acc = merge(acc, sh_stat[g * cpg + j]);
    float* p = part + (((size_t)b * nsplit + split) * groups + g) * 3;
    p[0] = acc.n;
    p[1] = acc.mean;
    p[2] = acc.m2;
  }
}

__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                const float* __restrict__ part, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ y, int N, int C,
                int groups, int nsplit, int tok_per_block, float eps) {
  extern __shared__ float sh_norm[];  // mean[groups], rstd[groups]
  float* mean = sh_norm;
  float* rstd = sh_norm + groups;
  const int b = blockIdx.y;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    Stat acc{0.f, 0.f, 0.f};
    for (int s = 0; s < nsplit; ++s) {
      const float* p = part + (((size_t)b * nsplit + s) * groups + g) * 3;
      acc = merge(acc, Stat{p[0], p[1], p[2]});
    }
    mean[g] = acc.mean;
    rstd[g] = rsqrtf(acc.m2 / acc.n + eps);
  }
  __syncthreads();
  const int cpg = C / groups;
  const int t0 = blockIdx.x * tok_per_block;
  const int ntok = min(tok_per_block, N - t0);
  const size_t base = ((size_t)b * N + t0) * C;
  const float* eb = emb != nullptr ? emb + (size_t)b * C : nullptr;
  for (int i = threadIdx.x; i < ntok * C; i += kThreads) {
    int c = i % C;
    int g = c / cpg;
    float v = x[base + i] + (eb != nullptr ? eb[c] : 0.f);
    float t = (v - mean[g]) * rstd[g] * gamma[c] + beta[c];
    y[base + i] = t / (1.f + expf(-t));
  }
}

}  // namespace

extern "C" int gn_silu_forward(const float* x, const float* emb, const float* gamma,
                               const float* beta, float* y, float* part, int B, int N,
                               int C, int groups, int tok_per_split, int tok_per_block,
                               float eps, cudaStream_t stream) {
  if (C > kThreads * kMaxChannelsPerThread || C % groups != 0) return (int)cudaErrorInvalidValue;
  const int nsplit = (N + tok_per_split - 1) / tok_per_split;
  gn_stats_kernel<<<dim3(nsplit, B), kThreads, C * sizeof(Stat), stream>>>(
      x, emb, part, N, C, groups, tok_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = (N + tok_per_block - 1) / tok_per_block;
  gn_apply_kernel<<<dim3(nblk, B), kThreads, 2 * groups * sizeof(float), stream>>>(
      x, emb, part, gamma, beta, y, N, C, groups, nsplit, tok_per_block, eps);
  return (int)cudaGetLastError();
}
