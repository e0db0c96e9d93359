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
//
// All gradients (gn_silu_bwd_full): replaces
// pallas_groupnorm.py::fused_groupnorm_silu_bwd_full (_gn_bwd_full_kernel):
// dx, dgamma, dbeta and demb of y = silu(GroupNorm(x + emb)) for an output
// cotangent g, the group statistics recomputed, all f32.  The TPU kernel
// keeps a whole (N, C) sample in VMEM, refuses samples that do not fit, and
// adds dgamma / dbeta across its sequential batch grid.  Here one block owns
// one (group, sample), as the resblock's GroupNorm kernels do: it makes its
// passes over the group's N x C/groups values (mean, variance, the two sums of
// the normalisation's backward, then dx), which holds for every size, and
// each thread stays on one channel of the group so the per-channel sums
// (dgamma, dbeta, demb) fall out of the same passes.  With
//   a = xhat * gamma + beta,  dy = g * silu'(a),  u = dy * gamma:
//   dx = rstd * (u - (sum(u) + xhat * sum(u * xhat)) / count)
//   demb[b, c] = sum_tokens dx;  dgamma[c] = sum_{b, tokens} dy * xhat;  dbeta[c] = sum dy.
// dgamma and dbeta leave each block as a per-sample partial and
// sum_partials_kernel adds the samples in order: no atomics.  No matrix
// product: bound by bytes (x and g read, dx written).
#include <cuda_runtime.h>
#include <math.h>

#include "grad_common.cuh"

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block (a multiple of 32 threads); every thread gets it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red is free: every thread is past the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nw ? red[lane] : 0.f);
}

// Sum of v over the threads of each channel (threads c, c + cpg, ... in
// order) into out[c], c < cpg.  chan: blockDim floats.
__device__ void channel_sum(float v, float* chan, int cpg, float* out) {
  __syncthreads();
  chan[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < cpg) {
    float t = 0.f;
    for (int j = threadIdx.x; j < blockDim.x; j += cpg) t += chan[j];
    out[threadIdx.x] = t;
  }
}

// One block per (group, sample); the block size is a multiple of 32 and of
// cpg = C / groups, so each thread stays on one channel of its group.
// gpart (B, 2, C): this sample's share of dgamma and dbeta.
__global__ void __launch_bounds__(1024)
gn_silu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ emb,
                   const float* __restrict__ g, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ dx,
                   float* __restrict__ demb, float* __restrict__ gpart, int N, int C,
                   int groups, float eps) {
  extern __shared__ float chan[];  // blockDim floats
  __shared__ float red[32];
  const int grp = blockIdx.x, b = blockIdx.y, cpg = C / groups;
  const int count = N * cpg;
  const int c = threadIdx.x % cpg;  // this thread's channel in the group
  const int ch = grp * cpg + c;
  const size_t off = (size_t)b * N * C + ch;
  const float ec = emb != nullptr ? emb[(size_t)b * C + ch] : 0.f;
  const float gam = gamma[ch], bet = beta[ch];

  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) s += x[off + (size_t)(i / cpg) * C] + ec;
  const float mean = block_sum(s, red) / count;
  float v = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const float d = x[off + (size_t)(i / cpg) * C] + ec - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / count + eps);

  float s1 = 0.f, s2 = 0.f, dg = 0.f, db = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const size_t idx = off + (size_t)(i / cpg) * C;
    const float xhat = (x[idx] + ec - mean) * rstd;
    const float a = xhat * gam + bet;
    const float sig = 1.f / (1.f + expf(-a));
    const float dy = g[idx] * sig * (1.f + a * (1.f - sig));
    dg += dy * xhat;
    db += dy;
    s1 += dy * gam;
    s2 += dy * gam * xhat;
  }
  const float S1 = block_sum(s1, red), S2 = block_sum(s2, red);
  channel_sum(dg, chan, cpg, gpart + ((size_t)b * 2 + 0) * C + grp * cpg);
  channel_sum(db, chan, cpg, gpart + ((size_t)b * 2 + 1) * C + grp * cpg);

  float dsum = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const size_t idx = off + (size_t)(i / cpg) * C;
    const float xhat = (x[idx] + ec - mean) * rstd;
    const float a = xhat * gam + bet;
    const float sig = 1.f / (1.f + expf(-a));
    const float u = g[idx] * sig * (1.f + a * (1.f - sig)) * gam;
    const float d = rstd * (u - (S1 + xhat * S2) / count);
    dsum += d;
    dx[idx] = d;
  }
  if (demb != nullptr) channel_sum(dsum, chan, cpg, demb + (size_t)b * C + grp * cpg);
}

}  // namespace

// Every gradient of silu(GroupNorm(x + emb)) for the output cotangent g.
// threads: a multiple of 32 and of C / groups, at most 1024.  gpart (B, 2, C)
// f32 workspace; out: dx (B, N, C), demb (B, C) when emb is given, vec (2, C)
// = dgamma, dbeta.
extern "C" int gn_silu_bwd_full(const float* x, const float* emb, const float* g,
                                const float* gamma, const float* beta, float* dx, float* demb,
                                float* gpart, float* vec, int B, int N, int C, int groups,
                                int threads, float eps, cudaStream_t stream) {
  if (C % groups != 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      threads % (C / groups) != 0)
    return (int)cudaErrorInvalidValue;
  gn_silu_bwd_kernel<<<dim3(groups, B), threads, threads * sizeof(float), stream>>>(
      x, emb, g, gamma, beta, dx, emb != nullptr ? demb : nullptr, gpart, N, C, groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gradk::sum_partials(gpart, vec, (size_t)2 * C, B, stream);
}

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
