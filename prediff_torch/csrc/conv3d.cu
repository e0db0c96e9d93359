// SAME 3x3x3 stride-1 convolution + bias, channel-last f32:
//   out (B, T, H, W, N) = conv(bf16(x) (B, T, H, W, K), bf16(w)) + bias
// with f32 accumulation; the bias is added in f32 and out is f32.  Its input
// gradient is the same launch on the cotangent with the flipped,
// channel-transposed weights (the wrapper lays them out), so one entry point
// serves both.
//
// Replaces prediff_tpu/ops/pallas_conv3d.py::fused_conv3x3x3 (body
// _conv_kernel) and the dx of its custom_vjp (fused_conv3x3x3_diff's
// _diff_bwd, the same kernel on the flipped weights).  The TPU kernel keeps
// the zero-padded input resident in VMEM and stages the 27 shifted row
// windows into an in-VMEM im2col block for one big-K GEMM.  Here the conv is
// an implicit GEMM on Hopper's own units, M = B*T*H*W tokens, N output
// channels, K = 27 taps x K input channels:
//   - A block owns a 128-token box of one sample in (t, h, w) (the wrapper's
//     plan: 1x8x16 at H = W = 16, 2x8x8 at H = W = 8) and 256 output
//     channels (128 where N is not a multiple of 256).  Each (tap,
//     64-channel slice) of A is one TMA load of a 5-D box (64 ch, bw, bh, bt,
//     1) from the bf16 input at the box origin moved by the tap; coordinates
//     outside the volume (-1, or T / H / W) come back as zeros from the TMA
//     unit, so SAME padding costs nothing and neither a padded copy nor an
//     im2col matrix reaches device memory.  64 bf16 channels are one 128-byte
//     row: the 128-byte swizzle wgmma's K-major operands want.  A box never
//     straddles two samples; a ragged box (T not a multiple of bt) reads
//     zeros and is masked at the store.
//   - The weights' tile (256 or 128 out x 64 in, K-contiguous) is a TMA load
//     too, from the bf16 (27, N, K) layout the wrapper keeps per parameter
//     version, with its tensor map (conv3x3x3_weight_map), so nothing of the
//     weights is converted or re-laid out per call.
//   - One producer warp keeps a ring of kStages (A, B) stages in flight
//     behind mbarriers; two consumer warpgroups, 64 rows each, run wgmma
//     m64n256k16 (or n128) bf16 -> f32, four per slice, one group in flight
//     while the next stage lands.  The large tile keeps the operands'
//     traffic from L2 down: each A box is read once per 256 output channels,
//     each weight tile once per 128 tokens (64 x 128 tiles moved twice the
//     bytes and were bound by L2 on an H100 SXM).
//   - Few output tiles at the UNet's shapes (26 at 3328 tokens x 256, 14 at
//     832 x 512): the wrapper splits the 27 x K/64 slices over a thread-block
//     cluster of `splits` blocks along z (1, 2, 4 or 8, one wave over the
//     SMs: clusters of 3, 5 or 6 leave SMs of a GPC idle).  Each block parks
//     its f32 partial tile in its own shared memory and, after a cluster
//     barrier, the blocks add the partials through distributed shared memory
//     in rank order (each block a share of the columns), add the bias and
//     store: one launch, no workspace, no atomics (two runs give the same
//     bits).
// x arrives as f32: a small kernel in the same call rounds it to bf16 once
// (into a scratch the wrapper allocates) before the conv reads it by TMA.
//
// Bound: 2 * 27 * K * N operations per token against ~4 (K + N) bytes per
// token and 27 * K * N * 2 bytes of weights; at the UNet's shapes (3328
// tokens x 256 -> 256, 832 x 512 -> 512) about 1,000 operations per byte,
// so the tensor cores bound it (~0.012 ms a call at 989 TFLOP/s bf16).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hopper;

// A block: kBM tokens (one box) x BN output channels (128 or 256), K in
// slices of kBK; two consumer warpgroups of 64 rows each, one producer warp.
constexpr int kBM = 128, kBK = 64, kStages = 4;
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kATile = kBM * kBK * 2;                           // bytes: 16 KB
constexpr int kMaxSplits = 8;                                   // portable cluster size

template <int BN>
struct Tile {
  static constexpr int kBTile = BN * kBK * 2;                   // 16 or 32 KB
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

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                  float* __restrict__ out, const ConvGeom g) {
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
        if (o0 >= 0)
          *reinterpret_cast<float2*>(out + o0 + n) =
              make_float2(acc[4 * jb] + b0, acc[4 * jb + 1] + b1);
        if (o1 >= 0)
          *reinterpret_cast<float2*>(out + o1 + n) =
              make_float2(acc[4 * jb + 2] + b0, acc[4 * jb + 3] + b1);
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
      if (o0 >= 0) *reinterpret_cast<float2*>(out + o0 + n) = make_float2(v[0] + b0, v[1] + b1);
      if (o1 >= 0) *reinterpret_cast<float2*>(out + o1 + n) = make_float2(v[2] + b0, v[3] + b1);
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

// The output-channel tile: 256 where N allows it, else 128.
int tile_n(int N) { return N % 256 == 0 ? 256 : 128; }

template <int BN>
cudaError_t launch_conv(const CUtensorMap& x_map, const CUtensorMap& w_map, const float* bias,
                        float* out, const ConvGeom& g, unsigned tiles, int splits,
                        cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(conv_wgmma_kernel<BN>,
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, conv_wgmma_kernel<BN>, x_map, w_map, bias, out, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The tensor map of a weight layout w (27, N, K) bf16, K contiguous: boxes of
// 64 in x the output-channel tile (256 where N allows, else 128) of one tap.
// `map` receives the 128-byte CUtensorMap.
extern "C" int conv3x3x3_weight_map(const void* w, int N, int K, void* map) {
  if (N < 128 || N % 128 || K < kBK || K % kBK || (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 27};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)tile_n(N), 1};
  CUtensorMap m;
  const int err = hopper::encode_bf16(&m, w, 3, dims, strides, box);
  if (err == 0) memcpy(map, &m, sizeof(m));
  return err;
}

// x (B, T, H, W, K) f32, xb (B, T, H, W, K) bf16 scratch, w_map the weights'
// map (conv3x3x3_weight_map), bias (N) f32 or null, out (B, T, H, W, N) f32;
// the token box (bt, bh, bw) of 128 tokens, and the cluster's `splits` of the
// 27 * K / 64 slices.  Two launches: the bf16 rounding of x, the conv.
extern "C" int conv3x3x3_forward(const float* x, void* xb, const void* w_map, const float* bias,
                                 float* out, int B, int T, int H, int W, int K, int N, int bt,
                                 int bh, int bw, int splits, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || K < kBK || K % kBK || N < 128 || N % 128 || bt < 1 ||
      bh < 1 || bw < 1 || bt * bh * bw != kBM || bt > 256 || bh > 256 || bw > 256 ||
      splits < 1 || splits > kMaxSplits || splits > 27 * (K / kBK) ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(xb) & 15))
    return (int)cudaErrorInvalidValue;
  const ConvGeom g{T,  H, W, N, bt, bh, bw, (T + bt - 1) / bt, (H + bh - 1) / bh,
                   (W + bw - 1) / bw, K / kBK};
  const long long tiles = (long long)B * g.nbt * g.nbh * g.nbw;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t n8 = (size_t)B * T * H * W * K / 8;
  const size_t want = (n8 + 255) / 256;
  to_bf16_kernel<<<want < 2048 ? (int)want : 2048, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<uint4*>(xb), n8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const cuuint64_t dims[5] = {(cuuint64_t)K, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)K * 2, (cuuint64_t)W * K * 2,
                                 (cuuint64_t)H * W * K * 2, (cuuint64_t)T * H * W * K * 2};
  const cuuint32_t box[5] = {kBK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bt, 1};
  CUtensorMap x_map, w;
  const int enc = hopper::encode_bf16(&x_map, xb, 5, dims, strides, box);
  if (enc != 0) return enc;
  memcpy(&w, w_map, sizeof(w));
  return (int)(tile_n(N) == 256
                   ? launch_conv<256>(x_map, w, bias, out, g, (unsigned)tiles, splits, stream)
                   : launch_conv<128>(x_map, w, bias, out, g, (unsigned)tiles, splits, stream));
}
