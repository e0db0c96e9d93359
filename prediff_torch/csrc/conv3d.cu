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
#include <cuda.h>   // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed; traps (a launch
// error, not a hung card) if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle: 8-row groups 1024 bytes apart; the tile starts 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x 128, f32, the warpgroup's accumulator layout) += A (64 x 16) . B (128 x 16)^T.
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 256, f32, the warpgroup's accumulator layout) += A (64 x 16) . B (256 x 16)^T.
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the
// runtime, so the library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 tensor map with 128-byte swizzle; dims and box innermost first,
// strides in bytes of dims 1.. .
int encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
  const int err = encode_bf16(&m, w, 3, dims, strides, box);
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
  const int enc = encode_bf16(&x_map, xb, 5, dims, strides, box);
  if (enc != 0) return enc;
  memcpy(&w, w_map, sizeof(w));
  return (int)(tile_n(N) == 256
                   ? launch_conv<256>(x_map, w, bias, out, g, (unsigned)tiles, splits, stream)
                   : launch_conv<128>(x_map, w, bias, out, g, (unsigned)tiles, splits, stream));
}
