// The bf16 SAME 3x3x3 stride-1 convolution on TMA + wgmma, shared by the
// standalone conv (conv3d.cu, whose note describes the design) and the
// resblock (resblock.cu): out (B, T, H, W, N) = conv(xb (B, T, H, W, K) bf16,
// w bf16) with f32 accumulation, and the epilogues those callers need.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "io.cuh"

// Everything here has internal linkage (an unnamed namespace): each library
// built on this header keeps its own kernels (see grad_common.cuh).
namespace conv {
namespace {

namespace cg = cooperative_groups;
using namespace hopper;

// A block: kBM tokens (one box) x BN output channels (64, 128 or 256), K in
// slices of kBK; two consumer warpgroups of 64 rows each, one producer warp.
constexpr int kBM = 128, kBK = 64, kStages = 4;
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kATile = kBM * kBK * 2;                           // bytes: 16 KB
constexpr int kMaxSplits = 8;                                   // portable cluster size

template <int BN>
struct Tile {
  static constexpr int kBTile = BN * kBK * 2;                   // 8, 16 or 32 KB
  static constexpr int kStageBytes = kATile + kBTile;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + the 1024-byte alignment
  static constexpr int kAcc = BN / 2;                           // f32 accumulators a thread
  static_assert(kConsumers * kAcc * 4 <= kStages * kStageBytes, "split tile fits the ring");
};

// Tile geometry: the volume, the token box and the number of boxes per axis.
struct ConvGeom {
  int T, H, W, N, bt, bh, bw, nbt, nbh, nbw, k_slices;
};

// Element offset of row r of this block's box in out, or -1 outside the volume.
__device__ __forceinline__ long long row_offset(const ConvGeom& g, int r, int b, int t0, int h0,
                                                int w0) {
  const int t = t0 + r / (g.bh * g.bw), h = h0 + (r / g.bw) % g.bh, w = w0 + r % g.bw;
  if (t >= g.T || h >= g.H || w >= g.W) return -1;
  return ((((long long)b * g.T + t) * g.H + h) * g.W + w) * g.N;
}

// What the epilogue stores: f32 acc + bias (the standalone conv), bf16 of
// acc + bias (a bf16 activation or gradient of the resblock, the standalone
// conv's bf16 form), or acc + bias + skip (the resblock's output with its
// identity skip) in f32, or with a bf16 skip rounded once to bf16 (the
// resblock's bf16 form); the bias may be null.
enum Epilogue { kF32 = 0, kBf16 = 1, kF32Skip = 2, kBf16Skip = 3 };

template <int Epi>
__device__ __forceinline__ void store_pair(void* out, const void* __restrict__ skip, long long o,
                                           float v0, float v1) {
  if (Epi == kF32Skip || Epi == kBf16Skip) {
    const float2 s = Epi == kF32Skip ? load2(static_cast<const float*>(skip) + o)
                                     : load2(static_cast<const __nv_bfloat16*>(skip) + o);
    v0 += s.x;
    v1 += s.y;
  }
  if (Epi == kBf16 || Epi == kBf16Skip)
    store2(static_cast<__nv_bfloat16*>(out) + o, v0, v1);
  else
    store2(static_cast<float*>(out) + o, v0, v1);
}

template <int BN, int Epi>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                  void* __restrict__ out, const void* __restrict__ skip, const ConvGeom g) {
  using Cfg = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;   // 1024-byte aligned for the 128-byte swizzle
  float* red = reinterpret_cast<float*>(smem_raw + (ring - raw));
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  int tile = blockIdx.y;
  const int iw = tile % g.nbw;
  tile /= g.nbw;
  const int ih = tile % g.nbh;
  tile /= g.nbh;
  const int it = tile % g.nbt, b = tile / g.nbt;
  const int t0 = it * g.bt, h0 = ih * g.bh, w0 = iw * g.bw;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int slices = 27 * g.k_slices;
  const int i_begin = rank * slices / splits, i_end = (rank + 1) * slices / splits;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[Cfg::kAcc];
#pragma unroll
  for (int e = 0; e < Cfg::kAcc; ++e) acc[e] = 0.f;

  if (tid >= kConsumers) {
    // producer: one thread keeps the ring full
    if (tid == kConsumers) {
      for (int i = i_begin, j = 0; i < i_end; ++i, ++j) {
        const int s = j % kStages;
        mbar_wait(smem_u32(&empty[s]), ((j / kStages) & 1) ^ 1);
        const int tap = i / g.k_slices, c0 = (i % g.k_slices) * kBK;
        const uint32_t bar = smem_u32(&full[s]), a = ring + s * Cfg::kStageBytes;
        mbar_expect_tx(bar, Cfg::kStageBytes);
        tma_load_5d(a, &x_map, bar, c0, w0 + tap % 3 - 1, h0 + (tap / 3) % 3 - 1,
                    t0 + tap / 9 - 1, b);
        tma_load_3d(a + kATile, &w_map, bar, c0, n0, tap);
      }
    }
  } else {
    // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the box; four
    // wgmma per slice, one slice's group in flight
    const int lane = tid & 31, wg = tid / 128;
    for (int i = i_begin, j = 0; i < i_end; ++i, ++j) {
      const int s = j % kStages;
      mbar_wait(smem_u32(&full[s]), (j / kStages) & 1);
      const uint32_t a = ring + s * Cfg::kStageBytes;
      const uint64_t da = sw128_desc(a + wg * (kATile / 2)), db = sw128_desc(a + kATile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (j > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(j - 1) % kStages]));
    }
    wgmma_wait<0>();
  }

  // epilogue: rows r0 and r0 + 8 of the box, columns 8 jb + 2 (lane % 4) (+1)
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  if (splits == 1) {
    if (tid < kConsumers) {
      const long long o0 = row_offset(g, r0, b, t0, h0, w0);
      const long long o1 = row_offset(g, r0 + 8, b, t0, h0, w0);
#pragma unroll
      for (int jb = 0; jb < BN / 8; ++jb) {
        const int n = n0 + 8 * jb + cq;
        const float b0 = bias != nullptr ? bias[n] : 0.f, b1 = bias != nullptr ? bias[n + 1] : 0.f;
        if (o0 >= 0) store_pair<Epi>(out, skip, o0 + n, acc[4 * jb] + b0, acc[4 * jb + 1] + b1);
        if (o1 >= 0)
          store_pair<Epi>(out, skip, o1 + n, acc[4 * jb + 2] + b0, acc[4 * jb + 3] + b1);
      }
    }
    return;
  }
  // split over a cluster: park the partial tile, then each rank adds the
  // partials of its share of the columns in rank order and stores them
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < kConsumers) {
    // the partial overwrites the ring: every consumer warp's wgmma has read it
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
    for (int e = 0; e < Cfg::kAcc; ++e) red[e * kConsumers + tid] = acc[e];
  }
  cluster.sync();
  if (tid < kConsumers) {
    const long long o0 = row_offset(g, r0, b, t0, h0, w0);
    const long long o1 = row_offset(g, r0 + 8, b, t0, h0, w0);
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
      if (jb % splits != rank) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 0.f;
      for (int q = 0; q < splits; ++q) {
        const float* peer = cluster.map_shared_rank(red, q);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] += peer[(4 * jb + e) * kConsumers + tid];
      }
      const int n = n0 + 8 * jb + cq;
      const float b0 = bias != nullptr ? bias[n] : 0.f, b1 = bias != nullptr ? bias[n + 1] : 0.f;
      if (o0 >= 0) store_pair<Epi>(out, skip, o0 + n, v[0] + b0, v[1] + b1);
      if (o1 >= 0) store_pair<Epi>(out, skip, o1 + n, v[2] + b0, v[3] + b1);
    }
  }
  cluster.sync();   // no block leaves while a peer may still read its partial
}

// x (n f32, n % 8 == 0) -> bf16, round to nearest even.
__global__ void to_bf16_kernel(const float4* __restrict__ x, uint4* __restrict__ y, size_t n8) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = x[2 * i], c = x[2 * i + 1];
    __nv_bfloat162 p0 = __floats2bfloat162_rn(a.x, a.y), p1 = __floats2bfloat162_rn(a.z, a.w);
    __nv_bfloat162 p2 = __floats2bfloat162_rn(c.x, c.y), p3 = __floats2bfloat162_rn(c.z, c.w);
    y[i] = make_uint4(*reinterpret_cast<unsigned*>(&p0), *reinterpret_cast<unsigned*>(&p1),
                      *reinterpret_cast<unsigned*>(&p2), *reinterpret_cast<unsigned*>(&p3));
  }
}

template <int BN, int Epi>
cudaError_t launch_conv(const CUtensorMap& x_map, const CUtensorMap& w_map, const float* bias,
                        void* out, const void* skip, const ConvGeom& g, unsigned tiles,
                        int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(conv_wgmma_kernel<BN, Epi>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Tile<BN>::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.N / BN, tiles, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<BN>::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, conv_wgmma_kernel<BN, Epi>, x_map, w_map, bias, out, skip, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tensor map of a bf16 channel-last input (B, T, H, W, K): boxes of 64
// channels x the token box (bw, bh, bt) of one sample.
inline int encode_input_map(CUtensorMap* map, const void* xb, int B, int T, int H, int W, int K,
                            int bt, int bh, int bw) {
  const cuuint64_t dims[5] = {(cuuint64_t)K, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)K * 2, (cuuint64_t)W * K * 2,
                                 (cuuint64_t)H * W * K * 2, (cuuint64_t)T * H * W * K * 2};
  const cuuint32_t box[5] = {kBK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bt, 1};
  return hopper::encode_bf16(map, xb, 5, dims, strides, box);
}

// The conv of the bf16 input xb (B, T, H, W, K) with the weights' map (boxes
// of bn rows, conv3x3x3_weight_map) into out (B, T, H, W, N) by the epilogue
// Epi, in output-channel tiles of bn (64, 128 or 256), on the token box (bt,
// bh, bw) of kBM tokens and `splits` blocks of a cluster.  One launch.
template <int Epi>
cudaError_t conv(const void* xb, const CUtensorMap& w_map, const float* bias, void* out,
                 const void* skip, int B, int T, int H, int W, int K, int N, int bn, int bt,
                 int bh, int bw, int splits, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || K < kBK || K % kBK || (bn != 64 && bn != 128 &&
      bn != 256) || N < bn || N % bn || bt < 1 ||
      bh < 1 || bw < 1 || bt * bh * bw != kBM || bt > 256 || bh > 256 || bw > 256 ||
      splits < 1 || splits > kMaxSplits || splits > 27 * (K / kBK) ||
      (reinterpret_cast<uintptr_t>(xb) & 15))
    return cudaErrorInvalidValue;
  const ConvGeom g{T,  H, W, N, bt, bh, bw, (T + bt - 1) / bt, (H + bh - 1) / bh,
                   (W + bw - 1) / bw, K / kBK};
  const long long tiles = (long long)B * g.nbt * g.nbh * g.nbw;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap x_map;
  const int enc = encode_input_map(&x_map, xb, B, T, H, W, K, bt, bh, bw);
  if (enc != 0) return (cudaError_t)enc;
  if (bn == 256)
    return launch_conv<256, Epi>(x_map, w_map, bias, out, skip, g, (unsigned)tiles, splits, stream);
  if (bn == 128)
    return launch_conv<128, Epi>(x_map, w_map, bias, out, skip, g, (unsigned)tiles, splits, stream);
  return launch_conv<64, Epi>(x_map, w_map, bias, out, skip, g, (unsigned)tiles, splits, stream);
}

// x (n f32, n % 8 == 0) -> bf16 y, one launch.
inline cudaError_t to_bf16(const float* x, void* y, size_t n, cudaStream_t stream) {
  const size_t n8 = n / 8, want = (n8 + 255) / 256;
  to_bf16_kernel<<<want < 2048 ? (int)want : 2048, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint4*>(y), n8);
  return cudaGetLastError();
}

}  // namespace
}  // namespace conv
