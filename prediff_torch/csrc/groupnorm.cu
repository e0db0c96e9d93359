// silu(GroupNorm(x + emb[b])) for x (B, N, C) f32, channel-last.
//
// Replaces prediff_tpu/ops/pallas_groupnorm.py::fused_groupnorm_silu (its
// _stats_kernel + _apply_kernel).  The TPU carried per-group sums across a
// sequential grid; here blocks run in no order.  The work is bound by bytes
// (x read once, y written once: ~7 MB at the UNet's widest site, 2 us at the
// card's memory rate), so the design reads x from device memory once.
//
// gn_cluster_kernel (one launch): a thread-block cluster of 1, 2, 4 or 8
// blocks per (sample, group), split along the tokens, so that B x groups x
// cluster fills the card at B = 1 (32 groups: clusters of 4).  Each block
// copies its tokens x the group's channels into shared memory by cp.async
// (16 bytes where the group's channels allow it, else 4), every value in
// flight at once; each thread runs Welford (count, mean, M2) over a strided
// strip of the tile, the warp's lanes and then the block's warps merge by
// Chan's formula in a fixed tree, and the ranks read each other's partials
// through distributed shared memory and merge them in rank order (every rank
// the same order, so every rank and every run gets the same bits).  Each
// block then normalises, applies the affine and SiLU from its shared tile and
// stores y.  No workspace, no atomics, no second read of x.  Welford and
// Chan's merge never form E[x^2] - E[x]^2, so there is no cancellation when
// |mean| >> std.  emb is added where a value is read from the tile, so
// x + emb never reaches memory.
//
// Where a (sample, group) does not fit the shared memory of a cluster of 8
// (ops/groupnorm.gn_plan, by shape), the two launches of the first design
// run instead:
//   gn_stats_kernel  grid (splits, B): each block reads a slice of tokens,
//                    every thread keeps a Welford (count, mean, M2) per
//                    channel, then the channels of each group are merged
//                    (Chan's formula) into one partial per (b, split, group).
//   gn_apply_kernel  grid (token tiles, B): merges the partials of its
//                    sample, then normalise + affine + SiLU in one pass.
//
// All gradients: replaces pallas_groupnorm.py::fused_groupnorm_silu_bwd_full
// (_gn_bwd_full_kernel): dx, dgamma, dbeta and demb of y = silu(GroupNorm(x
// + emb)) for an output cotangent g, the group statistics recomputed, all
// f32.  The TPU kernel keeps a whole (N, C) sample in VMEM, refuses samples
// that do not fit, and adds dgamma / dbeta across its sequential batch grid.
// With
//   a = xhat * gamma + beta,  dy = g * silu'(a),  u = dy * gamma:
//   dx = rstd * (u - (sum(u) + xhat * sum(u * xhat)) / count)
//   demb[b, c] = sum_tokens dx;  dgamma[c] = sum_{b, tokens} dy * xhat;  dbeta[c] = sum dy.
// No matrix product: bound by bytes (x and g read, dx written).
//
// gn_silu_bwd_cluster (the route wherever ops/groupnorm.gn_bwd_plan gives a
// plan): the forward's design, one launch of gn_cluster.cuh's bwd_kernel, a
// cluster of 1, 2, 4 or 8 blocks per (group, sample) along the tokens, each
// rank's x and g copied into shared memory once by cp.async (16 bytes where
// the group's channels allow), Welford statistics merged in rank order, one
// pass for u and the sums, one for dx (16-byte stores), each thread on fixed
// channels of the group so its dgamma / dbeta / demb sums are per channel;
// the sums are added over the block's threads and then over the ranks in
// order, rank 0 writing each sample's partial.  Then sum_partials_kernel
// adds the samples in order: two launches, no atomics.
//
// gn_silu_bwd_full, the first design, only where the plan gives none: a
// (group, sample) past a cluster of 8 blocks' shared memory, or a group
// width a 256-thread block cannot hold on fixed channels (256 * vw % cpg).
// One block owns one (group, sample) and makes its passes over the group's
// N x C/groups values in device memory (mean, variance, the two sums of the
// normalisation's backward, then dx), which holds for every size, each
// thread on one channel of the group; then sum_partials_kernel as above.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "gn_cluster.cuh"
#include "grad_common.cuh"
#include "io.cuh"
#include "welford.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannelsPerThread = 4;  // C <= 1024

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, const T* __restrict__ emb,
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
    e[k] = (emb != nullptr && c < C) ? to_f(emb[(size_t)b * C + c]) : 0.f;
  }
  const T* xb = x + (size_t)b * N * C;
  for (int n = n0; n < n1; ++n) {
#pragma unroll
    for (int k = 0; k < kMaxChannelsPerThread; ++k) {
      int c = threadIdx.x + k * kThreads;
      if (c < C) {
        float v = to_f(xb[(size_t)n * C + c]) + e[k];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ emb,
                const float* __restrict__ part, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y, int N, int C,
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
  const T* eb = emb != nullptr ? emb + (size_t)b * C : nullptr;
  for (int i = threadIdx.x; i < ntok * C; i += kThreads) {
    int c = i % C;
    int g = c / cpg;
    float v = to_f(x[base + i]) + (eb != nullptr ? to_f(eb[c]) : 0.f);
    float t = (v - mean[g]) * rstd[g] * gamma[c] + beta[c];
    store(y + base + i, t / (1.f + expf(-t)));
  }
}

// ---------------------------------------------------------------------------
// One launch: a cluster of `gridDim.x / groups` blocks per (sample, group)
// along the tokens, rank r taking tokens r * tpr .. r * tpr + tpr - 1.  VW
// values per copy: 4 (cpg % 4 == 0; 16 bytes by cp.async in f32, 8 bytes by
// a plain load in bf16, x and y aligned to it) or 1.  T: f32, or bf16 (the
// bf16 form: x, emb and y in bf16, widened into the same f32 tile, so the
// plan, the shared memory and the arithmetic are the f32 form's).
constexpr int kGnThreads = 256;

template <int VW, typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ emb,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ y, int N, int C, int cpg, int tpr, float eps) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [tpr][cpg] this rank's tokens
  float* es = xs + (size_t)tpr * cpg;            // [cpg] emb, gamma, beta of the group
  float* gs = es + cpg;
  float* bs = gs + cpg;
  __shared__ Stat warp_part[kGnThreads / 32];
  __shared__ Stat part;                          // this rank's partial, read by the cluster
  __shared__ float mean_rstd[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int g = blockIdx.x / ranks, b = blockIdx.y, tid = threadIdx.x;
  const int n0 = rank * tpr, nt = max(0, min(tpr, N - n0));
  const int count = nt * cpg, cw = cpg / VW;     // values, copies per token
  const size_t base = ((size_t)b * N + n0) * C + (size_t)g * cpg;

  for (int i = tid; i < nt * cw; i += kGnThreads) {
    const int t = i / cw, c = (i % cw) * VW;
    const T* src = x + base + (size_t)t * C + c;
    if constexpr (sizeof(T) == 2) {   // widened by the load
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(xs + t * cpg + c) = load4(src);
      else
        xs[t * cpg + c] = to_f(src[0]);
      continue;
    } else {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(xs + t * cpg + c));
      if (VW == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int c = tid; c < cpg; c += kGnThreads) {   // while the tile is in flight
    const int ch = g * cpg + c;
    es[c] = emb != nullptr ? to_f(emb[(size_t)b * C + ch]) : 0.f;
    gs[c] = gamma[ch];
    bs[c] = beta[ch];
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // Welford over values tid, tid + kGnThreads, ... of the tile; value i is
  // channel i % cpg, which advances by kGnThreads % cpg per step
  Stat st{0.f, 0.f, 0.f};
  const int step = kGnThreads % cpg;
  int c = tid % cpg;
  for (int i = tid; i < count; i += kGnThreads) {
    const float v = xs[i] + es[c];
    st.n += 1.f;
    const float d = v - st.mean;
    st.mean += d / st.n;
    st.m2 += d * (v - st.mean);
    c += step;
    if (c >= cpg) c -= cpg;
  }
  // lanes, then warps, then ranks, each merged in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) st = merge(st, shfl_down(st, o));
  if ((tid & 31) == 0) warp_part[tid >> 5] = st;
  __syncthreads();
  if (tid == 0) {
    Stat acc = warp_part[0];
    for (int w = 1; w < kGnThreads / 32; ++w) acc = merge(acc, warp_part[w]);
    part = acc;
  }
  cluster.sync();   // every rank's partial is written and visible
  if (tid == 0) {
    Stat acc = *cluster.map_shared_rank(&part, 0);
    for (int r = 1; r < ranks; ++r) acc = merge(acc, *cluster.map_shared_rank(&part, r));
    mean_rstd[0] = acc.mean;
    mean_rstd[1] = rsqrtf(acc.m2 / acc.n + eps);
  }
  __syncthreads();
  // this rank is done with its peers' partials; it waits for theirs on its own at the end
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  const float mean = mean_rstd[0], rstd = mean_rstd[1];
  for (int i = tid; i < nt * cw; i += kGnThreads) {
    const int t = i / cw, c0 = (i % cw) * VW;
    float out[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float v = (xs[t * cpg + c0 + e] + es[c0 + e] - mean) * rstd * gs[c0 + e] + bs[c0 + e];
      out[e] = v / (1.f + expf(-v));
    }
    T* dst = y + base + (size_t)t * C + c0;
    if (VW == 4)
      store4(dst, make_float4(out[0], out[1], out[2], out[3]));
    else
      store(dst, out[0]);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
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
template <typename T>
__global__ void __launch_bounds__(1024)
gn_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ emb,
                   const T* __restrict__ g, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ dx,
                   float* __restrict__ demb, float* __restrict__ gpart, int N, int C,
                   int groups, float eps) {
  extern __shared__ float chan[];  // blockDim floats
  __shared__ float red[32];
  const int grp = blockIdx.x, b = blockIdx.y, cpg = C / groups;
  const int count = N * cpg;
  const int c = threadIdx.x % cpg;  // this thread's channel in the group
  const int ch = grp * cpg + c;
  const size_t off = (size_t)b * N * C + ch;
  const float ec = emb != nullptr ? to_f(emb[(size_t)b * C + ch]) : 0.f;
  const float gam = gamma[ch], bet = beta[ch];

  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) s += to_f(x[off + (size_t)(i / cpg) * C]) + ec;
  const float mean = block_sum(s, red) / count;
  float v = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const float d = to_f(x[off + (size_t)(i / cpg) * C]) + ec - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / count + eps);

  float s1 = 0.f, s2 = 0.f, dg = 0.f, db = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const size_t idx = off + (size_t)(i / cpg) * C;
    const float xhat = (to_f(x[idx]) + ec - mean) * rstd;
    const float a = xhat * gam + bet;
    const float sig = 1.f / (1.f + expf(-a));
    const float dy = to_f(g[idx]) * sig * (1.f + a * (1.f - sig));
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
    const float xhat = (to_f(x[idx]) + ec - mean) * rstd;
    const float a = xhat * gam + bet;
    const float sig = 1.f / (1.f + expf(-a));
    const float u = to_f(g[idx]) * sig * (1.f + a * (1.f - sig)) * gam;
    const float d = rstd * (u - (S1 + xhat * S2) / count);
    dsum += d;
    store(dx + idx, d);
  }
  if (demb != nullptr) channel_sum(dsum, chan, cpg, demb + (size_t)b * C + grp * cpg);
}

// Every gradient of silu(GroupNorm(x + emb)) for the output cotangent g.
// threads: a multiple of 32 and of C / groups, at most 1024.  gpart (B, 2, C)
// f32 workspace; out: dx (B, N, C), demb (B, C) when emb is given, vec (2, C)
// = dgamma, dbeta (f32; T: x, emb, g and dx f32 or bf16).
template <typename T>
int bwd_full(const T* x, const T* emb, const T* g, const float* gamma, const float* beta, T* dx,
             float* demb, float* gpart, float* vec, int B, int N, int C, int groups, int threads,
             float eps, cudaStream_t stream) {
  if (C % groups != 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      threads % (C / groups) != 0)
    return (int)cudaErrorInvalidValue;
  gn_silu_bwd_kernel<T><<<dim3(groups, B), threads, threads * sizeof(float), stream>>>(
      x, emb, g, gamma, beta, dx, emb != nullptr ? demb : nullptr, gpart, N, C, groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gradk::sum_partials(gpart, vec, (size_t)2 * C, B, stream);
}

// The same gradients in one launch of clusters of `cluster` blocks (1, 2, 4
// or 8) per (group, sample), tpr tokens a rank (cluster * tpr >= N), vw
// values a copy (4: cpg % 4 == 0 and x, g, dx 16-byte aligned in f32, 8-byte
// in bf16; or 1); then the samples' partials added in order.
template <typename T>
int bwd_cluster(const T* x, const T* emb, const T* g, const float* gamma, const float* beta,
                T* dx, float* demb, float* gpart, float* vec, int B, int N, int C, int groups,
                int cluster, int tpr, int vw, float eps, cudaStream_t stream) {
  const cudaError_t err = gnc::bwd<T, T, T, true>(
      B, N, C, groups, cluster, tpr, vw, x, emb, g, gamma, beta, static_cast<const T*>(nullptr),
      dx, emb != nullptr ? demb : nullptr, gpart, eps, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gradk::sum_partials(gpart, vec, (size_t)2 * C, B, stream);
}

// One launch: clusters of `cluster` blocks (1, 2, 4 or 8) per (sample,
// group), tpr tokens a rank (cluster * tpr >= N), vw values per copy (4 or
// 1); the rank's tile and the group's emb, gamma and beta in shared memory.
template <typename T>
int cluster_forward(const T* x, const T* emb, const float* gamma, const float* beta, T* y, int B,
                    int N, int C, int groups, int cluster, int tpr, int vw, float eps,
                    cudaStream_t stream) {
  constexpr int kSmemCap = 232448 - 1024;   // beside the kernel's static shared memory
  if (groups < 1 || C % groups != 0 || B < 1 || B > 65535 || N < 1 || tpr < 1 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (long long)cluster * tpr < N || (vw != 1 && vw != 4))
    return (int)cudaErrorInvalidValue;
  const int cpg = C / groups;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
  };
  if (vw == 4 && (cpg % 4 != 0 || !aligned(x) || !aligned(y))) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)tpr * cpg + 3 * (size_t)cpg);
  if (smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  static bool configured[2] = {false, false};   // once per instance, at the most a block may take
  const int which = vw == 4;
  if (!configured[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        which ? gn_cluster_kernel<4, T> : gn_cluster_kernel<1, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err != cudaSuccess) return (int)err;
    configured[which] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cluster, B);
  cfg.blockDim = dim3(kGnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      which ? cudaLaunchKernelEx(&cfg, gn_cluster_kernel<4, T>, x, emb, gamma, beta, y, N, C, cpg,
                                 tpr, eps)
            : cudaLaunchKernelEx(&cfg, gn_cluster_kernel<1, T>, x, emb, gamma, beta, y, N, C, cpg,
                                 tpr, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The two launches of the first design, for the groups no cluster holds:
// part (B, ceil(N / tok_per_split), groups, 3) f32 workspace.
template <typename T>
int two_pass_forward(const T* x, const T* emb, const float* gamma, const float* beta, T* y,
                     float* part, int B, int N, int C, int groups, int tok_per_split,
                     int tok_per_block, float eps, cudaStream_t stream) {
  if (C > kThreads * kMaxChannelsPerThread || C % groups != 0) return (int)cudaErrorInvalidValue;
  const int nsplit = (N + tok_per_split - 1) / tok_per_split;
  gn_stats_kernel<T><<<dim3(nsplit, B), kThreads, C * sizeof(Stat), stream>>>(
      x, emb, part, N, C, groups, tok_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = (N + tok_per_block - 1) / tok_per_block;
  gn_apply_kernel<T><<<dim3(nblk, B), kThreads, 2 * groups * sizeof(float), stream>>>(
      x, emb, part, gamma, beta, y, N, C, groups, nsplit, tok_per_block, eps);
  return (int)cudaGetLastError();
}

}  // namespace

using bf16_t = __nv_bfloat16;

// The f32 forms, and the bf16 forms (x, emb, g, dx, y in bf16; gamma, beta
// and the f32 sums as in the f32 forms), of the four entry points above.
extern "C" int gn_silu_bwd_full(const float* x, const float* emb, const float* g,
                                const float* gamma, const float* beta, float* dx, float* demb,
                                float* gpart, float* vec, int B, int N, int C, int groups,
                                int threads, float eps, cudaStream_t stream) {
  return bwd_full(x, emb, g, gamma, beta, dx, demb, gpart, vec, B, N, C, groups, threads, eps,
                  stream);
}

extern "C" int gn_silu_bwd_full_bf16(const bf16_t* x, const bf16_t* emb, const bf16_t* g,
                                     const float* gamma, const float* beta, bf16_t* dx,
                                     float* demb, float* gpart, float* vec, int B, int N, int C,
                                     int groups, int threads, float eps, cudaStream_t stream) {
  return bwd_full(x, emb, g, gamma, beta, dx, demb, gpart, vec, B, N, C, groups, threads, eps,
                  stream);
}

extern "C" int gn_silu_bwd_cluster(const float* x, const float* emb, const float* g,
                                   const float* gamma, const float* beta, float* dx, float* demb,
                                   float* gpart, float* vec, int B, int N, int C, int groups,
                                   int cluster, int tpr, int vw, float eps, cudaStream_t stream) {
  return bwd_cluster(x, emb, g, gamma, beta, dx, demb, gpart, vec, B, N, C, groups, cluster, tpr,
                     vw, eps, stream);
}

extern "C" int gn_silu_bwd_cluster_bf16(const bf16_t* x, const bf16_t* emb, const bf16_t* g,
                                        const float* gamma, const float* beta, bf16_t* dx,
                                        float* demb, float* gpart, float* vec, int B, int N,
                                        int C, int groups, int cluster, int tpr, int vw,
                                        float eps, cudaStream_t stream) {
  return bwd_cluster(x, emb, g, gamma, beta, dx, demb, gpart, vec, B, N, C, groups, cluster, tpr,
                     vw, eps, stream);
}

extern "C" int gn_silu_cluster_forward(const float* x, const float* emb, const float* gamma,
                                       const float* beta, float* y, int B, int N, int C,
                                       int groups, int cluster, int tpr, int vw, float eps,
                                       cudaStream_t stream) {
  return cluster_forward(x, emb, gamma, beta, y, B, N, C, groups, cluster, tpr, vw, eps, stream);
}

extern "C" int gn_silu_cluster_forward_bf16(const bf16_t* x, const bf16_t* emb,
                                            const float* gamma, const float* beta, bf16_t* y,
                                            int B, int N, int C, int groups, int cluster, int tpr,
                                            int vw, float eps, cudaStream_t stream) {
  return cluster_forward(x, emb, gamma, beta, y, B, N, C, groups, cluster, tpr, vw, eps, stream);
}

extern "C" int gn_silu_forward(const float* x, const float* emb, const float* gamma,
                               const float* beta, float* y, float* part, int B, int N,
                               int C, int groups, int tok_per_split, int tok_per_block,
                               float eps, cudaStream_t stream) {
  return two_pass_forward(x, emb, gamma, beta, y, part, B, N, C, groups, tok_per_split,
                          tok_per_block, eps, stream);
}

extern "C" int gn_silu_forward_bf16(const bf16_t* x, const bf16_t* emb, const float* gamma,
                                    const float* beta, bf16_t* y, float* part, int B, int N,
                                    int C, int groups, int tok_per_split, int tok_per_block,
                                    float eps, cudaStream_t stream) {
  return two_pass_forward(x, emb, gamma, beta, y, part, B, N, C, groups, tok_per_split,
                          tok_per_block, eps, stream);
}
