// The backward of y = silu(GroupNorm(src + emb)) in one launch of a
// thread-block cluster per (group, sample), shared by groupnorm.cu (every
// gradient of the standalone GN+SiLU, all f32: dx, dgamma, dbeta, demb) and
// resblock.cu (the block's two GN passes: dv with demb, dx with the skip
// added; bf16 operands where the block keeps them).  The bf16 forms (guidance
// on the alignment net's bf16 copy) read src, emb, the cotangent and the skip
// in bf16 and write dx in bf16: every value is widened to f32 as it is read,
// so the arithmetic and the shared-memory tiles are the f32 form's.
//
// Row 1's design (groupnorm.cu gn_cluster_kernel) carried to the backward:
// the cluster's `ranks` blocks split the group's tokens, rank r holding
// tokens r * tpr .. r * tpr + tpr - 1.  Each block copies its tokens x the
// group's channels of src and of the cotangent into shared memory once (f32
// by cp.async, 16 bytes a copy where the group's channels allow it; bf16 by
// plain loads, widened), and loads emb, gamma and beta of its own channels
// while the copies are in flight: a thread stays on VW channels of the tile
// (kThreads * VW % width == 0), so they live in registers.  Then:
//   - Welford per thread over its values (+ emb), Chan merges down the
//     warp's lanes, across the warps in order and across the ranks in rank
//     order through distributed shared memory (never E[x^2] - E[x]^2, so no
//     cancellation when |mean| >> std);
//   - one pass over the tile: xhat, a = xhat gamma + beta, dy = g silu'(a),
//     u = dy gamma, stored back over the tile; s1 = sum u, s2 = sum u xhat,
//     and where asked the thread's own dgamma = sum dy xhat, dbeta = sum dy;
//   - S1, S2: each block's sums in a fixed tree, added over the ranks in rank
//     order;
//   - dx = rstd (u - (S1 + xhat S2) / count) (+ skip), stored VW values at a
//     time (16 bytes in f32); the thread keeps its sum of dx for demb;
//   - dgamma, dbeta and demb of each channel: the block's threads of the
//     channel in a fixed tree (the warp's lanes by xor, then the warps in
//     order), then the ranks in order; rank 0 writes demb[b] and
//     the sample's partials gpart[b] (added over the samples in order by the
//     caller: no atomics, the same bits on every run).
// One-channel groups (the UNet's 65) would make every token's row segment 4
// bytes, a 32-byte sector read for each: there a block takes kBundle
// neighbouring groups (32 bytes a row), each thread on one of them, and the
// statistics and the sums of u and u xhat are per channel, by the same trees
// stopped at the channel.
// Bound by bytes: src and the cotangent read once, dx written once.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <initializer_list>

#include "io.cuh"
#include "welford.cuh"

// Internal linkage, as every header here: each library keeps its own kernels
// and the launch stub cudaLaunchKernelEx resolves is its own.
namespace gnc {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// dynamic shared memory a block may take beside the kernel's own (< 12 KB)
constexpr int kSmemCap = 232448 - 12288;
// one-channel groups a block takes together, so that each token's row segment
// is 32 contiguous bytes and not 4 (the UNet's 65 one-channel groups)
constexpr int kBundle = 8;
constexpr int kMaxRanks = 8;   // the largest (portable) cluster

// v[r] = *peer(r) for each rank r < ranks: every load of distributed shared
// memory issued before the first is used, so a cluster of 8 pays one round
// trip and not eight; the caller adds them in rank order.
template <typename T, typename Peer>
__device__ __forceinline__ void gather_ranks(T (&v)[kMaxRanks], int ranks, Peer peer) {
#pragma unroll
  for (int r = 0; r < kMaxRanks; ++r)
    if (r < ranks) v[r] = peer(r);
}

__device__ __forceinline__ float silu_grad(float a) {
  const float s = 1.f / (1.f + expf(-a));
  return s * (1.f + a * (1.f - s));
}

// Sum of v over the block in a fixed tree (lanes by xor, then the warps'
// sums); every thread gets the same bits.  red: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // red is free: every thread is past the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// nv vectors of VW values of a rank's tile into dst[i * VW ..]: vector i is
// token i / cw, channels (i % cw) * VW .. of the group (src: the tile's first
// value, rows C apart).  f32 by cp.async (the caller commits and waits).
// Channels at or past nch (a bundle's ragged end) are zeros.
template <int VW>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int nv, int cw, int C,
                                          int nch) {
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    if ((i % cw) * VW >= nch) {
#pragma unroll
      for (int k = 0; k < VW; ++k) dst[(size_t)i * VW + k] = 0.f;
      continue;
    }
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + (size_t)i * VW));
    const float* s = src + (size_t)(i / cw) * C + (i % cw) * VW;
    if constexpr (VW == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(s) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(s) : "memory");
  }
}

template <int VW>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, int nv, int cw,
                                          int C, int nch) {
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const __nv_bfloat16* s = src + (size_t)(i / cw) * C + (i % cw) * VW;
    if ((i % cw) * VW >= nch) {
#pragma unroll
      for (int k = 0; k < VW; ++k) dst[(size_t)i * VW + k] = 0.f;
    } else if constexpr (VW == 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(s);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      *reinterpret_cast<float4*>(dst + (size_t)i * 4) = make_float4(lo.x, lo.y, hi.x, hi.y);
    } else {
      dst[i] = __bfloat162float(*s);
    }
  }
}

template <int VW>
__device__ __forceinline__ void get(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = p[0];
  }
}

template <int VW>
__device__ __forceinline__ void get(const __nv_bfloat16* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 q = load4(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VW>
__device__ __forceinline__ void put(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

template <int VW>
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// mean and rstd of each group over the cluster's tiles: this rank's nv
// vectors of xs, each value plus e of its channel; the tile is one group, or
// with PerChannel a bundle of one-channel groups (thread t's group is its
// channel t % cw).  Welford per thread over its vectors in order, Chan merges
// down the lanes of a group (a shfl_down tree), across the warps in order and
// across the ranks in rank order: every rank merges in the same order, so
// every rank and every run gets the same bits.
template <int VW, bool PerChannel>
__device__ void cluster_stats(const float* xs, int nv, int cw, const float (&e)[VW], float eps,
                              float& mean, float& rstd) {
  __shared__ Stat warp_part[kThreads / 32][kBundle];
  __shared__ Stat part[kBundle];
  __shared__ float2 mean_rstd[kBundle];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, ranks = (int)cluster.num_blocks();
  const int nc = PerChannel ? cw : 1;   // groups in the tile; lanes l, l + nc, ... share one
  Stat st{0.f, 0.f, 0.f};
  for (int i = tid; i < nv; i += kThreads) {
    float v[VW];
    get<VW>(xs + (size_t)i * VW, v);
#pragma unroll
    for (int k = 0; k < VW; ++k) push(st, v[k] + e[k]);
  }
  for (int o = 16; o >= nc; o >>= 1) st = merge(st, shfl_down(st, o));
  if ((tid & 31) < nc) warp_part[tid >> 5][tid & 31] = st;
  __syncthreads();
  if (tid < nc) {
    Stat acc = warp_part[0][tid];
    for (int w = 1; w < kThreads / 32; ++w) acc = merge(acc, warp_part[w][tid]);
    part[tid] = acc;
  }
  cluster.sync();   // every rank's partials are written and visible
  if (tid < nc) {
    Stat pr[kMaxRanks];
    gather_ranks(pr, ranks, [&](int r) { return cluster.map_shared_rank(part, r)[tid]; });
    Stat acc = pr[0];
#pragma unroll
    for (int r = 1; r < kMaxRanks; ++r)
      if (r < ranks) acc = merge(acc, pr[r]);
    mean_rstd[tid] = make_float2(acc.mean, rsqrtf(acc.m2 / acc.n + eps));
  }
  cluster.sync();   // every rank has read its peers' partials
  const float2 mr = mean_rstd[PerChannel ? tid % cw : 0];
  mean = mr.x;
  rstd = mr.y;
}

// out[q][c], c < ct: v[q] summed over the block's threads of channel c
// (thread j holds channels (j % cw) * VW ..) in a fixed tree: the lanes of a
// warp that share a channel (cw < 32) by an xor butterfly, then the warps'
// (or, cw >= 32, the threads') partials in order; NQ sums in one pass.
// dpart: NQ * kThreads * VW floats.
template <int VW, int NQ>
__device__ void channel_sums(const float (&v)[NQ][VW], float* dpart, int cw, int ct,
                             float* const (&out)[NQ]) {
  float w[NQ][VW];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      w[q][k] = v[q][k];
      for (int o = 16; o >= cw; o >>= 1) w[q][k] += __shfl_xor_sync(0xffffffffu, w[q][k], o);
    }
  }
  __syncthreads();   // dpart is free
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int k = 0; k < VW; ++k) dpart[(q * kThreads + threadIdx.x) * VW + k] = w[q][k];
  __syncthreads();
  const int step = cw < 32 ? 32 : cw;   // the threads that hold a channel's partials
  for (int c = threadIdx.x; c < ct; c += kThreads) {
    float t[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) t[q] = 0.f;
    for (int j = c / VW; j < kThreads; j += step)
#pragma unroll
      for (int q = 0; q < NQ; ++q) t[q] += dpart[(q * kThreads + j) * VW + c % VW];
#pragma unroll
    for (int q = 0; q < NQ; ++q) out[q][c] = t[q];
  }
}

// The backward above for the cotangent gin: out = dx (+ skip), demb (B, C)
// where given, and with Affine gpart (B, 2, C) = each sample's dgamma, dbeta.
// emb (ET) and skip (SkT) f32 or bf16, as src, gin and out.
// The tile is one group of cpg channels, or with Bundled (cpg == 1, VW == 1)
// kBundle one-channel groups (zeros past C), each thread on one of them, so
// the statistics and S1 / S2 are per channel.  Dynamic shared memory:
// smem_bytes(tpr, tile width).
template <typename InT, typename GT, typename OutT, typename ET, typename SkT, int VW, bool Affine,
          bool Bundled>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const InT* __restrict__ src, const ET* __restrict__ emb,
           const GT* __restrict__ gin, const float* __restrict__ gamma,
           const float* __restrict__ beta, const SkT* __restrict__ skip,
           OutT* __restrict__ out, float* __restrict__ demb, float* __restrict__ gpart, int N,
           int C, int cpg, int tpr, float eps) {
  const int ct = Bundled ? kBundle : cpg;        // channels in the tile
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [tpr][ct] src, then xhat
  float* gs = xs + (size_t)tpr * ct;             // [tpr][ct] the cotangent, then u
  float* chs = gs + (size_t)tpr * ct;            // [3][ct] this rank's dgamma, dbeta, demb
  __shared__ float red[32];
  __shared__ float s12[2][kBundle];   // this rank's sums of u and u xhat: the block's or a channel's
  __shared__ float dpart[(Bundled ? 4 : 2) * kThreads * VW];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int c_base = (blockIdx.x / ranks) * ct, nch = min(ct, C - c_base);
  const int n0 = rank * tpr, nt = max(0, min(tpr, N - n0));
  const int cw = ct / VW, nv = nt * cw;   // vectors a token, in the tile
  const size_t base = ((size_t)b * N + n0) * C + c_base;

  load_tile<VW>(xs, src + base, nv, cw, C, nch);
  load_tile<VW>(gs, gin + base, nv, cw, C, nch);
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int c0 = (tid % cw) * VW;   // this thread's channels: c0 .. c0 + VW - 1 of the tile
  const bool live = c0 < nch;       // false only past C in a bundle
  float e[VW], gam[VW], bet[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) {   // while the tiles are in flight
    const int ch = c_base + c0 + k;
    e[k] = emb != nullptr && live ? to_f(emb[(size_t)b * C + ch]) : 0.f;
    gam[k] = live ? gamma[ch] : 0.f;
    bet[k] = live ? beta[ch] : 0.f;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  float mean, rstd;
  cluster_stats<VW, Bundled>(xs, nv, cw, e, eps, mean, rstd);
  float s1 = 0.f, s2 = 0.f, dg[VW], db[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) dg[k] = db[k] = 0.f;
  for (int i = tid; i < nv; i += kThreads) {
    float xv[VW], gv[VW];
    get<VW>(xs + (size_t)i * VW, xv);
    get<VW>(gs + (size_t)i * VW, gv);
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float xhat = (xv[k] + e[k] - mean) * rstd;
      const float dy = gv[k] * silu_grad(xhat * gam[k] + bet[k]);
      const float u = dy * gam[k];
      s1 += u;
      s2 += u * xhat;
      if constexpr (Affine) {
        dg[k] += dy * xhat;
        db[k] += dy;
      }
      xv[k] = xhat;
      gv[k] = u;
    }
    put<VW>(xs + (size_t)i * VW, xv);
    put<VW>(gs + (size_t)i * VW, gv);
  }
  if constexpr (Bundled && Affine) {   // VW == 1: every sum is a channel's
    const float v[4][1] = {{s1}, {s2}, {dg[0]}, {db[0]}};
    float* const outs[4] = {s12[0], s12[1], chs, chs + ct};
    channel_sums<1, 4>(v, dpart, cw, ct, outs);
  } else if constexpr (Bundled) {
    const float v[2][1] = {{s1}, {s2}};
    float* const outs[2] = {s12[0], s12[1]};
    channel_sums<1, 2>(v, dpart, cw, ct, outs);
  } else {
    const float b1 = block_sum(s1, red), b2 = block_sum(s2, red);
    if (tid == 0) s12[0][0] = b1, s12[1][0] = b2;
    if constexpr (Affine) {
      float v[2][VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) v[0][k] = dg[k], v[1][k] = db[k];
      float* const outs[2] = {chs, chs + ct};
      channel_sums<VW, 2>(v, dpart, cw, ct, outs);
    }
  }
  cluster.sync();   // every rank's sums are written and visible
  const int cls = Bundled ? tid % cw : 0;
  float2 sr[kMaxRanks];
  gather_ranks(sr, ranks, [&](int r) {
    const float* p = cluster.map_shared_rank(&s12[0][0], r);
    return make_float2(p[cls], p[kBundle + cls]);
  });
  float S1 = 0.f, S2 = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxRanks; ++r) {
    if (r < ranks) {
      S1 += sr[r].x;
      S2 += sr[r].y;
    }
  }
  const float total = (float)N * cpg;
  float ds[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) ds[k] = 0.f;
  for (int i = tid; i < nv; i += kThreads) {
    float xv[VW], uv[VW], o[VW];
    get<VW>(xs + (size_t)i * VW, xv);
    get<VW>(gs + (size_t)i * VW, uv);
    const size_t at = base + (size_t)(i / cw) * C + c0;
    float sk[VW];
    if (skip != nullptr && live) get<VW>(skip + at, sk);
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float d = rstd * (uv[k] - (S1 + xv[k] * S2) / total);
      ds[k] += d;
      o[k] = skip != nullptr ? d + sk[k] : d;
    }
    if (live) put<VW>(out + at, o);
  }
  if (demb != nullptr) {
    float v[1][VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) v[0][k] = ds[k];
    float* const outs[1] = {chs + 2 * ct};
    channel_sums<VW, 1>(v, dpart, cw, ct, outs);
  }
  cluster.sync();   // the peers' sums are read no more; the channel sums are written
  if (rank == 0) {
    for (int c = tid; c < nch; c += kThreads) {
      const size_t ch = (size_t)c_base + c;
      float3 pr[kMaxRanks];   // dgamma, dbeta, demb of channel c on each rank
      gather_ranks(pr, ranks, [&](int r) {
        const float* peer = cluster.map_shared_rank(chs, r);
        return make_float3(Affine ? peer[c] : 0.f, Affine ? peer[ct + c] : 0.f,
                           demb != nullptr ? peer[2 * ct + c] : 0.f);
      });
      float3 t = make_float3(0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxRanks; ++r) {
        if (r < ranks) {
          t.x += pr[r].x;
          t.y += pr[r].y;
          t.z += pr[r].z;
        }
      }
      if constexpr (Affine) {
        gpart[(size_t)b * 2 * C + ch] = t.x;
        gpart[((size_t)b * 2 + 1) * C + ch] = t.y;
      }
      if (demb != nullptr) demb[(size_t)b * C + ch] = t.z;
    }
  }
  cluster.sync();   // no block leaves while rank 0 may still read its sums
}

// The dynamic shared memory of a rank: the two f32 tiles and three channel
// sums, ct channels wide.
inline size_t smem_bytes(int tpr, int ct) {
  return sizeof(float) * (2 * (size_t)tpr * ct + 3 * (size_t)ct);
}

inline bool aligned(const void* p, int bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename InT, typename GT, typename OutT, typename ET, typename SkT, int VW, bool Affine,
          bool Bundled>
cudaError_t launch(int B, int units, int ranks, int tpr, int cpg, int ct, cudaStream_t stream,
                   const InT* src, const ET* emb, const GT* gin, const float* gamma,
                   const float* beta, const SkT* skip, OutT* out, float* demb, float* gpart,
                   int N, int C, float eps) {
  auto* const kernel = &bwd_kernel<InT, GT, OutT, ET, SkT, VW, Affine, Bundled>;
  static bool configured = false;   // once per instance, at the most a block may take
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(units * ranks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(tpr, ct);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, src, emb, gin, gamma, beta, skip, out,
                                             demb, gpart, N, C, cpg, tpr, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether a cluster of `ranks` blocks of tpr tokens, vw values a copy, takes
// (B, N, C) in `groups` groups: the plan's rule (ops/groupnorm.gn_bwd_plan:
// one-channel groups in bundles of kBundle), checked again here with the
// pointers' alignment for the vector copies.
inline bool plan_ok(int B, int N, int C, int groups, int ranks, int tpr, int vw,
                    std::initializer_list<const void*> f32,
                    std::initializer_list<const void*> bf16) {
  if (groups < 1 || C % groups != 0 || B < 1 || B > 65535 || N < 1 || tpr < 1 ||
      (ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) || (long long)ranks * tpr < N ||
      (vw != 1 && vw != 4))
    return false;
  const int cpg = C / groups, ct = cpg == 1 ? kBundle : cpg;
  if (cpg % vw != 0 || (kThreads * vw) % ct != 0 || smem_bytes(tpr, ct) > (size_t)kSmemCap)
    return false;
  if (vw == 4) {
    for (const void* p : f32)
      if (!aligned(p, 16)) return false;
    for (const void* p : bf16)
      if (!aligned(p, 8)) return false;
  }
  return true;
}

// One launch for (B, N, C): clusters of `ranks` blocks per (group, sample),
// or per (bundle of kBundle one-channel groups, sample), vw values a copy (4
// or 1); cudaErrorInvalidValue where the plan does not hold.
template <typename InT, typename GT, typename OutT, bool Affine, typename ET, typename SkT>
cudaError_t bwd(int B, int N, int C, int groups, int ranks, int tpr, int vw, const InT* src,
                const ET* emb, const GT* gin, const float* gamma, const float* beta,
                const SkT* skip, OutT* out, float* demb, float* gpart, float eps,
                cudaStream_t stream) {
  const auto f32 = [](const void* p, bool is_f32) { return is_f32 ? p : nullptr; };
  constexpr bool in32 = sizeof(InT) == 4, g32 = sizeof(GT) == 4, o32 = sizeof(OutT) == 4;
  constexpr bool s32 = sizeof(SkT) == 4;
  if (!plan_ok(B, N, C, groups, ranks, tpr, vw,
               {f32(src, in32), f32(gin, g32), f32(out, o32), f32(skip, s32)},
               {f32(src, !in32), f32(gin, !g32), f32(out, !o32), f32(skip, !s32)}))
    return cudaErrorInvalidValue;
  const int cpg = C / groups;
  if (cpg == 1)
    return launch<InT, GT, OutT, ET, SkT, 1, Affine, true>(
        B, (C + kBundle - 1) / kBundle, ranks, tpr, cpg, kBundle, stream, src, emb, gin, gamma,
        beta, skip, out, demb, gpart, N, C, eps);
  if (vw == 4)
    return launch<InT, GT, OutT, ET, SkT, 4, Affine, false>(B, groups, ranks, tpr, cpg, cpg,
                                                            stream, src, emb, gin, gamma, beta,
                                                            skip, out, demb, gpart, N, C, eps);
  return launch<InT, GT, OutT, ET, SkT, 1, Affine, false>(B, groups, ranks, tpr, cpg, cpg, stream,
                                                          src, emb, gin, gamma, beta, skip, out,
                                                          demb, gpart, N, C, eps);
}

}  // namespace
}  // namespace gnc
