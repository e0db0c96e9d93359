// Fused pre-norm FFN: out = x + W2 . act(W1 . LN(x) + b1) + b2.
//
// The activation is the TPU kernels' argument (pallas_ffn.py
// _apply_activation, _apply_activation_grad): exact-erf GELU, ReLU, leaky
// ReLU of slope 0.1 or SiLU, passed to every entry point as a small enum
// (enum Act).  Where b1 is added, in the forward and in both backwards, one
// warp-uniform switch a hidden chunk picks a straight-line copy of that loop
// for the activation (act_h_tile, dh_tile): one instance of each kernel
// serves all four, so the build does not grow with them.  Below, gelu stands for the
// activation and gelu' for its derivative (relu' = [h > 0], leaky' = 1 for
// h >= 0 else 0.1, silu' = s (1 + h (1 - s)), s = sigmoid(h)).
//
// Replaces prediff_tpu/ops/pallas_ffn.py::fused_ffn (_ffn_kernel).  Weights
// in PyTorch layout: w1 (hidden, C), w2 (C, hidden), f32 in memory.
//
// Forward (ffn_forward, ffn_wgmma_kernel): at the UNet's shapes (3328 x 256
// -> 1024, 832 x 512 -> 2048) the work is ~3.5 GFLOP per call against ~7-13
// MB of traffic, far above the card's ridge point, so the tensor cores bound
// it (~0.0035 ms at 989 TFLOP/s bf16).  The hidden activation stays on chip,
// as in the TPU kernel, and the design is the conv's (conv3d.cu) on Hopper's
// own units, in one launch:
//   - The weights are bf16 copies laid out once per parameter version by the
//     wrapper (ops/weights.py), read as 64 x 64 (W1) and 256 x 64 (W2) TMA
//     tiles through a 4-stage mbarrier ring kept full by one producer warp;
//     nothing of the weights is converted per call.
//   - A block owns 128 token rows (two consumer warpgroups of 64) at C = 128
//     and 256.  LN(x) of its rows is computed once from the f32 x and written
//     to shared memory as bf16 in the 128-byte-swizzled K-major layout: the A
//     operand of the first product.  Per hidden chunk of 64: h = LN . W1c^T by
//     wgmma m64n64 into registers; + b1, exact-erf GELU (Drop: m1 at (token,
//     hidden column)), rounded to bf16 into a swizzled shared tile; out +=
//     gelu(h) . W2c^T by wgmma m64nCk16, accumulated in registers across the
//     chunks.  At C = 512 the 64 x 512 f32 accumulator (256 registers a
//     thread) does not fit beside h: a block owns 64 rows, each warpgroup
//     computes half of h's 64 columns (m64n32) and half of the output's
//     (m64n256), and h (double-buffered) is shared through shared memory.
//   - The hidden dimension is split over a thread-block cluster of 1, 2, 4
//     or 8 blocks (about one wave on 132 SMs: 26 x 4 blocks at 3328 x 256,
//     13 x 8 at 832 x 512).  Each parks its f32 partial in its own shared
//     memory; the blocks add them through distributed shared memory in rank
//     order (each a share of the columns), then + b2 (Drop: m2 at (token,
//     channel)) and + x.  No workspace, no atomics: two runs give the same bits.
// Rounding follows the TPU kernel: LN(x), the weights and gelu(h) are bf16
// operands; every sum is f32.
//
// Input gradient (ffn_bwd_dx) and all gradients (ffn_bwd_full): replace
// pallas_ffn.py::fused_ffn_bwd_dx (_ffn_bwd_dx_kernel) and fused_ffn_bwd_full
// (_ffn_bwd_full_kernel), flash-style: nothing of the forward is saved, the
// hidden activation is recomputed chunk by chunk and never leaves the chip.
// Five products of 2 M C hidden operations against ~(3 M C + 4 C hidden) f32
// bytes: bound by operations at the UNet's training shapes (~0.018 ms).  One
// launch of ffn_bwd_kernel, on the forward's pieces:
//   - A block owns 64 token rows.  LN(x) is computed once into a swizzled
//     bf16 A tile, and do = g (. m2 / (1 - r_out)) is staged beside it as a
//     second one.  The weights are bf16 copies kept per parameter version
//     (ops/weights.py): W1 (hidden, C) as it is, and the transposed copies
//     W2^T (hidden, C) and W1^T (C, hidden), so that every product reads a
//     K-major B operand by TMA; a producer warp keeps a ring of their tiles
//     full.
//   - Per hidden chunk of 64, each of the two consumer warpgroups takes 32
//     of its columns: h = LN . W1c^T and da = do . W2c (wgmma m64n32), then
//     dh = da . gelu'(h + b1) (. m1 / (1 - r_act)) rounded to bf16 into a
//     shared dh tile; then dln += dh . W1c (wgmma m64n(C/2)), each warpgroup
//     on half of dln's columns, accumulated in registers across the chunks
//     (at C = 512 the 64 x 512 f32 accumulator does not fit one warpgroup).
//   - The hidden dimension is split over a thread-block cluster of 1, 2, 4
//     or 8 blocks (about one wave on 132 SMs).  Each parks its f32 dln
//     partial in its own shared memory; each rank adds the partials of a
//     share of the rows in rank order through distributed shared memory and
//     applies the LayerNorm backward, which needs whole dln rows, + g.
//   - All gradients: the weight gradients dW1 = dh^T . LN(x) and dW2 = do^T .
//     gelu(h) contract over the tokens, so the kernel writes their operands
//     width-major (a row per hidden unit or channel, tokens contiguous), in
//     bf16 as the TPU kernel rounds them: both are then K-major operands of
//     the wgmma TN product (grad_common.cuh wgrad_kernel, the tokens split
//     over a cluster).  The vector gradients are per-block column sums
//     (dln . nhat, dln, do, the f32 dh) added in a fixed order by
//     sum_partials_kernel.  No atomics: two runs give the same bits.
// Rounding follows the TPU kernel: LN(x), do, the weights and dh are bf16
// operands; h, gelu' and every sum stay f32.
//
// Dropout (ffn_dropout_forward, ffn_dropout_bwd_full): replaces
// pallas_ffn.py::fused_ffn_dropout (_ffn_dropout_fwd_kernel) and
// fused_ffn_dropout_bwd_full (_ffn_dropout_bwd_full_kernel), the training
// path of the v1 recipe:
//   a = gelu(LN(x) . W1 + b1) . m1 / (1 - r_act),
//   out = x + (a . W2 + b2) . m2 / (1 - r_out).
// The TPU kernels draw m1 and m2 from a per-core generator seeded per token
// tile, in the same order over one grid in the forward and the backward.  The
// kernels here do not share a grid (the hidden dimension is split over a
// grid axis, and m2 falls on the sum of the splits), so a mask is a function
// of the logical element instead (philox.cuh): m1 of (token, hidden column)
// is applied to gelu(h) before the bf16 rounding; m2 of (token, channel) on
// the summed a . W2 + b2 and before the residual, which is never masked.
// The backward regenerates both: do = g . m2 / (1 - r_out) feeds dW2, db2
// and da, the residual's share of dx is the unmasked g; the stored bf16
// gelu(h) is the dropped, rescaled one and dz = da . gelu'(h) . m1 /
// (1 - r_act).  Each Philox block is drawn once in the backward: do takes 8
// channels a thread (two whole blocks), and a pair of lanes that holds one
// block's four hidden units in two rows draws one block each and swaps
// halves (philox::draw_rows2).  The Drop forms are separate template
// instances of the same bodies, so with both rates 0 they give the bits of
// the kernels without dropout.  The draws add ~100 integer operations per
// hidden element to kernels that stay bound by their products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

#include "grad_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

// The activations, in the order of ops/ffn.py ACTIVATIONS.
enum Act : int { kGelu = 0, kRelu = 1, kLeaky = 2, kSilu = 3 };

// ---------------------------------------------------------------------------
// The forward on TMA + wgmma (the note at the top of the file).
namespace fwd {

using namespace hopper;

constexpr int kStages = 4, kStageBytes = 32768;   // ring of weight tiles
constexpr int kHC = 64;                           // hidden units per chunk
// two consumer warpgroups and a producer warpgroup, one thread of which
// issues the loads; setmaxnreg moves the producer's registers to the
// consumers (40 + 2 x 232 a thread: 128 x 40 + 256 x 232 <= 65536)
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxSplits = 8;                     // portable cluster size

template <int C>
struct Cfg {
  // C = 512: the two warpgroups split the columns of one 64-row tile
  static constexpr bool kSplitCols = C == 512;
  static constexpr int kBM = kSplitCols ? 64 : 128;        // token rows a block
  static constexpr int kN1 = kSplitCols ? 32 : 64;         // h columns a warpgroup
  static constexpr int kN2 = kSplitCols ? C / 2 : C;       // output columns a warpgroup
  static constexpr int kAcc = kN2 / 2, kHAcc = kN1 / 2;    // f32 accumulators a thread
  // a ring item: W1c's columns [i, i + kItemK) (64 x 64 boxes) or W2c's rows
  // [i, i + kItemK) (one kItemK x 64 box); kItems of each per chunk
  static constexpr int kItemK = C < 256 ? C : 256;
  static constexpr int kItems = C / kItemK;
  static constexpr int kItemBytes = kHC * kItemK * 2;
  static constexpr int kLnBytes = kBM * C * 2;
  static constexpr int kHBytes = 16384;   // one 128 x 64 bf16 tile, or two 64 x 64
  static constexpr int kSmem = 1024 + kLnBytes + kHBytes + kStages * kStageBytes;
  static_assert(kItemBytes <= kStageBytes, "an item fits a stage");
  static_assert(2 * kItems <= kStages, "a chunk's W2c and the next chunk's W1c fit the ring");
  static_assert(kConsumers * kAcc * 4 <= kStages * kStageBytes, "the partial fits the ring");
  static_assert(kSmem <= 232448, "exceeds the 227 KB of shared memory a block can use");
};

__device__ __forceinline__ float gelu_erf(float h) {
  return h * 0.5f * (1.f + erff(h * 0.70710678118654752f));
}

// act(h) of activation A, the TPU kernels' formulas.
template <int A>
__device__ __forceinline__ float activate(float h) {
  if constexpr (A == kRelu) return fmaxf(h, 0.f);
  else if constexpr (A == kLeaky) return h >= 0.f ? h : 0.1f * h;
  else if constexpr (A == kSilu) return h * (1.f / (1.f + expf(-h)));
  else return gelu_erf(h);
}

// act'(h) of activation A, and act(h) into a, as the backward recomputes it.
template <int A>
__device__ __forceinline__ float activate_grad(float h, float& a) {
  if constexpr (A == kRelu) {
    a = fmaxf(h, 0.f);
    return h > 0.f ? 1.f : 0.f;
  } else if constexpr (A == kLeaky) {
    a = h >= 0.f ? h : 0.1f * h;
    return h >= 0.f ? 1.f : 0.1f;
  } else if constexpr (A == kSilu) {
    const float s = 1.f / (1.f + expf(-h));
    a = h * s;
    return s * (1.f + h * (1.f - s));
  } else {
    const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
    const float pdf = expf(-0.5f * h * h) * 0.39894228040143268f;
    a = h * cdf;
    return cdf + h * pdf;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// act(h + b1) of a warpgroup's h accumulators (N1 columns from hcol, rows
// rbase + 8 half), dropped (Drop: m1 at (token, hidden column)), rounded to
// bf16 into the swizzled h tile.  The caller picks A by one warp-uniform
// switch on the kernel's act, so each case is the straight-line loop of one
// activation (a switch inside the unrolled loop spilled and slowed GELU).
template <int A, int N1, bool Drop>
__device__ __forceinline__ void act_h_tile(const float (&hacc)[N1 / 2],
                                           const float (&bj)[N1 / 8][2], int hcol, int lane,
                                           int rbase, const philox::Drop& d1, int m0, int hidden,
                                           int j0, uint8_t* tile) {
#pragma unroll
  for (int jb = 0; jb < N1 / 8; ++jb) {
    const int j = hcol + 8 * jb + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rbase + 8 * half;
      float a0 = activate<A>(hacc[4 * jb + 2 * half] + bj[jb][0]);
      float a1 = activate<A>(hacc[4 * jb + 2 * half + 1] + bj[jb][1]);
      if (Drop) philox::apply2(d1, (unsigned long long)(m0 + r) * hidden + j0 + j, a0, a1);
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(r, j)) = pack_bf16(a0, a1);
    }
  }
}

// grid (row tiles, 1, splits), clusters of (1, 1, splits): block z of a
// cluster adds hidden chunks [z, z + 1) * chunks / splits.
template <int C, bool Drop, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ffn_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                 const __grid_constant__ CUtensorMap w2_map, const T* __restrict__ x,
                 const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 T* __restrict__ out, int M, int hidden, float eps, int act,
                 philox::Drop d1, philox::Drop d2) {
  philox::load_key(d1);
  philox::load_key(d2);
  using K = Cfg<C>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ln_s = (raw + 1023) & ~1023u;   // 1024-byte aligned for the 128-byte swizzle
  const uint32_t h_s = ln_s + K::kLnBytes, ring = h_s + K::kHBytes;
  uint8_t* ln_g = smem_raw + (ln_s - raw);
  float* red = reinterpret_cast<float*>(ln_g + K::kLnBytes + K::kHBytes);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * K::kBM;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int chunks = hidden / kHC;
  const int c_begin = rank * chunks / splits, c_end = (rank + 1) * chunks / splits;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread keeps the ring full, W1c's items then W2c's per
    // chunk; the warpgroup then meets the consumers' two cluster barriers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int item = 0;
      for (int c = c_begin; c < c_end; ++c) {
        for (int it = 0; it < 2 * K::kItems; ++it, ++item) {
          const int s = item % kStages;
          mbar_wait(smem_u32(&empty[s]), ((item / kStages) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]), dst = ring + s * kStageBytes;
          mbar_expect_tx(bar, K::kItemBytes);
          if (it < K::kItems) {
            for (int b = 0; b < K::kItemK / 64; ++b)
              tma_load_2d(dst + b * 8192, &w1_map, bar, it * K::kItemK + b * 64, c * kHC);
          } else {
            tma_load_2d(dst, &w2_map, bar, c * kHC, (it - K::kItems) * K::kItemK);
          }
        }
      }
    }
    if (splits > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
    const int arow = K::kSplitCols ? 0 : 64 * wg;      // the warpgroup's rows of the tile
    const int ocol = K::kSplitCols ? K::kN2 * wg : 0;  // its output columns
    ln_rows_sw128<(C + 255) / 256, 8 / ((C + 255) / 256)>(x, ln_w, ln_b, ln_g, K::kBM, m0, M, C,
                                                          eps, tid / 32, kConsumers / 32);
    fence_async_smem();
    named_barrier(1, kConsumers);
    const int hcol = K::kSplitCols ? K::kN1 * wg : 0;   // the warpgroup's columns of h
    float acc[K::kAcc], hacc[K::kHAcc];   // hacc: each chunk's first wgmma overwrites it
#pragma unroll
    for (int e = 0; e < K::kAcc; ++e) acc[e] = 0.f;
    int item = 0;
    for (int c = c_begin; c < c_end; ++c) {
      const int j0 = c * kHC;
      const uint32_t hb = h_s + (K::kSplitCols ? ((c - c_begin) & 1) * 8192 : 0);
      // the chunk's b1 now: its loads are in flight while the product runs
      float bj[K::kN1 / 8][2];
#pragma unroll
      for (int jb = 0; jb < K::kN1 / 8; ++jb) {
        const float2 b = *reinterpret_cast<const float2*>(b1 + j0 + hcol + 8 * jb + 2 * (lane & 3));
        bj[jb][0] = b.x;
        bj[jb][1] = b.y;
      }
      // h = LN . W1c^T
      wgmma_fence();
#pragma unroll
      for (int it = 0; it < K::kItems; ++it) {
        const int s = (item + it) % kStages;
        mbar_wait(smem_u32(&full[s]), ((item + it) / kStages) & 1);
        const uint32_t st = ring + s * kStageBytes;
#pragma unroll
        for (int b = 0; b < K::kItemK / 64; ++b) {
          const int slice = it * (K::kItemK / 64) + b;
          const uint64_t da = sw128_desc(ln_s + slice * K::kBM * 128 + arow * 128);
          const uint64_t db = sw128_desc(st + b * 8192 + hcol * 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_k16(hacc, da + 2 * kk, db + 2 * kk, slice + kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();   // also the previous chunk's out product: its W2c items go too
      fence_regs(hacc);
      if (lane == 0) {
#pragma unroll
        for (int it = 0; it < K::kItems; ++it) {
          mbar_arrive(smem_u32(&empty[(item + it) % kStages]));
          if (c > c_begin) mbar_arrive(smem_u32(&empty[(item - K::kItems + it) % kStages]));
        }
      }
      item += K::kItems;
      // act(h + b1), dropped, rounded to bf16 into the h tile
      {
        const int rbase = arow + warp * 16 + (lane >> 2);
        uint8_t* tile = ln_g + (hb - ln_s);
        switch (act) {
          case kRelu:
            act_h_tile<kRelu, K::kN1, Drop>(hacc, bj, hcol, lane, rbase, d1, m0, hidden, j0, tile);
            break;
          case kLeaky:
            act_h_tile<kLeaky, K::kN1, Drop>(hacc, bj, hcol, lane, rbase, d1, m0, hidden, j0,
                                             tile);
            break;
          case kSilu:
            act_h_tile<kSilu, K::kN1, Drop>(hacc, bj, hcol, lane, rbase, d1, m0, hidden, j0, tile);
            break;
          default:
            act_h_tile<kGelu, K::kN1, Drop>(hacc, bj, hcol, lane, rbase, d1, m0, hidden, j0, tile);
        }
      }
      fence_async_smem();
      if (K::kSplitCols)
        named_barrier(2, kConsumers);
      else
        named_barrier(2 + wg, 128);
      // out += gelu(h) . W2c^T
      wgmma_fence();
#pragma unroll
      for (int it = 0; it < K::kItems; ++it) {
        const int s = (item + it) % kStages;
        mbar_wait(smem_u32(&full[s]), ((item + it) / kStages) & 1);
        if (!K::kSplitCols || it == wg) {
          const uint64_t da = sw128_desc(hb + arow * 128);
          const uint64_t db = sw128_desc(ring + s * kStageBytes);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk);
        }
      }
      wgmma_commit();
      item += K::kItems;
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: rows r0 and r0 + 8 of the warpgroup's, columns ocol + 8 jb +
    // 2 (lane % 4) (+1): out = x + drop(sum + b2)
    const int row0 = m0 + arow + warp * 16 + (lane >> 2), row1 = row0 + 8;
    auto store = [&](int jb, float v0, float v1, float v2, float v3) {
      const int n = ocol + 8 * jb + 2 * (lane & 3);
      const float c0 = b2[n], c1 = b2[n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row1 : row0;
        if (row >= M) continue;
        const size_t o = (size_t)row * C + n;
        float y0 = (half ? v2 : v0) + c0, y1 = (half ? v3 : v1) + c1;
        if (Drop) philox::apply2(d2, o, y0, y1);
        const float2 xv = load2(x + o);
        store2(out + o, xv.x + y0, xv.y + y1);
      }
    };
    if (splits == 1) {
#pragma unroll
      for (int jb = 0; jb < K::kN2 / 8; ++jb)
        store(jb, acc[4 * jb], acc[4 * jb + 1], acc[4 * jb + 2], acc[4 * jb + 3]);
      return;
    }
    // split over a cluster: park the partial, then each rank adds the partials
    // of its share of the columns (8-column groups jb = rank + t * splits) in
    // rank order and stores them, two groups at a time with every load (the
    // peers' partials, x, b2) in flight before any is used
    cg::cluster_group cluster = cg::this_cluster();
    named_barrier(1, kConsumers);   // the partial overwrites the ring: every wgmma has read it
#pragma unroll
    for (int e = 0; e < K::kAcc; ++e) red[e * kConsumers + tid] = acc[e];
    cluster.sync();
    const int mine = (K::kN2 / 8 - rank + splits - 1) / splits;
    for (int t = 0; t < mine; t += 2) {
      float part[2][kMaxSplits][4], xv[2][4], bv[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (t + i >= mine) break;
        const int jb = rank + (t + i) * splits, n = ocol + 8 * jb + 2 * (lane & 3);
#pragma unroll
        for (int q = 0; q < kMaxSplits; ++q) {
          if (q >= splits) break;
          const float* peer = cluster.map_shared_rank(red, q);
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][q][e] = peer[(4 * jb + e) * kConsumers + tid];
        }
        const float2 b = *reinterpret_cast<const float2*>(b2 + n);
        bv[i][0] = b.x;
        bv[i][1] = b.y;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row1 : row0;
          const float2 xr = row < M ? load2(x + (size_t)row * C + n) : make_float2(0.f, 0.f);
          xv[i][2 * half] = xr.x;
          xv[i][2 * half + 1] = xr.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (t + i >= mine) break;
        const int jb = rank + (t + i) * splits, n = ocol + 8 * jb + 2 * (lane & 3);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < kMaxSplits; ++q) {
          if (q >= splits) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += part[i][q][e];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row1 : row0;
          if (row >= M) continue;
          const size_t o = (size_t)row * C + n;
          float y0 = v[2 * half] + bv[i][0], y1 = v[2 * half + 1] + bv[i][1];
          if (Drop) philox::apply2(d2, o, y0, y1);
          store2(out + o, xv[i][2 * half] + y0, xv[i][2 * half + 1] + y1);
        }
      }
    }
    cluster.sync();   // no block leaves while a peer may still read its partial
  }
}

template <int C, bool Drop, typename T>
cudaError_t launch(const CUtensorMap& w1, const CUtensorMap& w2, const T* x,
                   const float* ln_w, const float* ln_b, const float* b1, const float* b2,
                   T* out, int M, int hidden, int splits, float eps, int act, philox::Drop d1,
                   philox::Drop d2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ffn_wgmma_kernel<C, Drop, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<C>::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + Cfg<C>::kBM - 1) / Cfg<C>::kBM, 1, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<C>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, ffn_wgmma_kernel<C, Drop, T>, w1, w2, x, ln_w, ln_b,
                                       b1, b2, out, M, hidden, eps, act, d1, d2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool Drop, typename T>
int forward(const T* x, const float* ln_w, const float* ln_b, const void* w1_map,
            const float* b1, const void* w2_map, const float* b2, T* out, int M, int C,
            int hidden, int splits, float eps, int act, philox::Drop d1, philox::Drop d2,
            cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M < 1 || hidden < kHC || hidden % kHC || splits < 1 || splits > kMaxSplits ||
      splits > hidden / kHC || act < kGelu || act > kSilu || !aligned(x) || !aligned(ln_w) ||
      !aligned(ln_b) || !aligned(b1) ||
      !aligned(b2) || (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap w1, w2;
  memcpy(&w1, w1_map, sizeof(w1));
  memcpy(&w2, w2_map, sizeof(w2));
  switch (C) {
    case 128:
      return (int)launch<128, Drop, T>(w1, w2, x, ln_w, ln_b, b1, b2, out, M, hidden, splits, eps,
                                    act, d1, d2, stream);
    case 256:
      return (int)launch<256, Drop, T>(w1, w2, x, ln_w, ln_b, b1, b2, out, M, hidden, splits, eps,
                                    act, d1, d2, stream);
    case 512:
      return (int)launch<512, Drop, T>(w1, w2, x, ln_w, ln_b, b1, b2, out, M, hidden, splits, eps,
                                    act, d1, d2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fwd

// ---------------------------------------------------------------------------
// The backwards on TMA + wgmma (the note at the top of the file).
namespace bwd {

using namespace hopper;

constexpr int kBM = 64;                            // token rows a block
constexpr int kHC = 64;                            // hidden units a chunk
constexpr int kStageBytes = 32768;                 // a ring stage
// two consumer warpgroups and a producer warpgroup, as the forward
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxSplits = 8;
constexpr int kLdT = kBM + 8;                      // row stride of the transposed staging tiles

template <int C>
struct Cfg {
  // a ring item: 64 rows (hidden units) x kItemK channels of W1c or W2^T c
  // (kItemK / 64 boxes of 64 x 64), or kItemK channels x 64 hidden units of
  // W1^T c (one box); kItems of each per chunk
  static constexpr int kItemK = C < 256 ? C : 256;
  static constexpr int kItems = C / kItemK;
  static constexpr int kItemBytes = kHC * kItemK * 2;
  static constexpr int kStages = C == 512 ? 2 : 4;
  static constexpr int kTileBytes = kBM * C * 2;     // the LN(x) and do tiles
  static constexpr int kDhBytes = kBM * kHC * 2;     // the dh tile
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kTBytes = 2 * kHC * kLdT * 2; // gelu(h)^T and dh^T staging
  static constexpr int kN2 = C / 2, kAcc = kN2 / 2;  // dln columns a warpgroup, f32 a thread
  static constexpr int kSmem = 1024 + 2 * kTileBytes + kDhBytes + kRingBytes + kTBytes;
  // after the products: the rank's dln partial (64 x C f32) from the LN tile
  // on, then the warps' column sums (8 x 2 x C f32)
  static constexpr int kRedBytes = kBM * C * 4, kVBytes = 8 * 2 * C * 4;
  static_assert(kItemBytes <= kStageBytes, "an item fits a stage");
  static_assert(kRedBytes + kVBytes <= kSmem - 1024, "the epilogue fits the tiles and the ring");
  static_assert(kConsumers * 8 * 4 <= kTBytes, "the do column sums fit the staging tiles");
  static_assert(kSmem + 2048 <= 232448, "exceeds the 227 KB of shared memory a block can use");
};

// grid (row tiles, 1, splits), clusters of (1, 1, splits): block z adds
// hidden chunks [z, z + 1) * chunks / splits; the ranks then add their dln
// partials in rank order, each for its share of the tile's rows.
// Full: also the width-major bf16 side outputs of the weight gradients
// (ld tokens a row): LN(x)^T, do^T (C, ld) by rank 0, gelu(h)^T (dropped)
// and dh^T (hidden, ld) for each rank's chunks; vpart[tile * splits + rank]
// (3, C): the rank's column sums of dln . nhat and dln over its rows and
// (rank 0) of do over the tile; db1_part[tile] (hidden): the column sums of
// the f32 dh, each rank for its chunks.
// dh = da . act'(h + b1) and a = act(h + b1) of a warpgroup's 32 columns of
// a chunk (rows rA + 8 half), both (Drop) . m1 / (1 - r_act) of (token,
// hidden unit); dh rounded to bf16 into the swizzled dh tile, a and dh
// transposed into the staging tiles (Full); dsum their column sums.  The
// caller picks A by one warp-uniform switch on the kernel's act.
template <int A, bool Full, bool Drop>
__device__ __forceinline__ void dh_tile(const float (&hacc)[16], const float (&dacc)[16],
                                        const float (&bj)[4][2], float (&dsum)[4][2], int hcol,
                                        int lane, int rA, const philox::Drop& d1, int m0,
                                        int hidden, int j0, uint8_t* dh_tile_g,
                                        __nv_bfloat16* at_s, __nv_bfloat16* dht_s) {
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    const int jl = hcol + 8 * jb + 2 * (lane & 3);
    unsigned w[2][2] = {{0u, 0u}, {0u, 0u}};
    if (Drop && d1.thr != 0u) {
      const unsigned long long eA = (unsigned long long)(m0 + rA) * hidden + j0 + jl;
      philox::draw_rows2(d1, eA, eA + 8ull * hidden, w[0], w[1]);
    }
    dsum[jb][0] = dsum[jb][1] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rA + 8 * half;
      float av[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a;
        const float dact = fwd::activate_grad<A>(hacc[4 * jb + 2 * half + e] + bj[jb][e], a);
        float dh = dacc[4 * jb + 2 * half + e] * dact;
        if (Drop && d1.thr != 0u) {
          const bool kept = w[half][e] >= d1.thr;
          dh = kept ? dh / d1.keep : 0.f;
          a = kept ? a / d1.keep : 0.f;
        }
        av[e] = a;
        dv[e] = dh;
        dsum[jb][e] += dh;   // rows past M have do = 0, so dh = 0
      }
      const uint32_t dhp = fwd::pack_bf16(dv[0], dv[1]);
      *reinterpret_cast<uint32_t*>(dh_tile_g + sw128_offset(r, jl)) = dhp;
      if (Full) {
        const __nv_bfloat162 ap = __floats2bfloat162_rn(av[0], av[1]);
        const __nv_bfloat162 hp = *reinterpret_cast<const __nv_bfloat162*>(&dhp);
        at_s[jl * kLdT + r] = ap.x;
        at_s[(jl + 1) * kLdT + r] = ap.y;
        dht_s[jl * kLdT + r] = hp.x;
        dht_s[(jl + 1) * kLdT + r] = hp.y;
      }
    }
  }
}

template <int C, bool Full, bool Drop, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_kernel(const __grid_constant__ CUtensorMap w1_map,
               const __grid_constant__ CUtensorMap w2t_map,
               const __grid_constant__ CUtensorMap w1t_map, const T* __restrict__ x,
               const T* __restrict__ g, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, const float* __restrict__ b1,
               T* __restrict__ dx, __nv_bfloat16* __restrict__ ln_t,
               __nv_bfloat16* __restrict__ do_t, __nv_bfloat16* __restrict__ a_t,
               __nv_bfloat16* __restrict__ dh_t, float* __restrict__ vpart,
               float* __restrict__ db1_part, int M, int hidden, int ld, float eps, int act,
               philox::Drop d1, philox::Drop d2) {
  philox::load_key(d1);
  philox::load_key(d2);
  using K = Cfg<C>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[K::kStages], empty[K::kStages];
  __shared__ float csum[kConsumers / 32][32];   // the warps' column sums of dh
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ln_s = (raw + 1023) & ~1023u;   // 1024-byte aligned for the 128-byte swizzle
  const uint32_t do_s = ln_s + K::kTileBytes, dh_s = do_s + K::kTileBytes;
  const uint32_t ring = dh_s + K::kDhBytes;
  uint8_t* base = smem_raw + (ln_s - raw);
  __nv_bfloat16* at_s = reinterpret_cast<__nv_bfloat16*>(base + 2 * K::kTileBytes + K::kDhBytes +
                                                         K::kRingBytes);   // [kHC][kLdT]
  __nv_bfloat16* dht_s = at_s + kHC * kLdT;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int chunks = hidden / kHC;
  const int c_begin = rank * chunks / splits, c_end = (rank + 1) * chunks / splits;
  const int slot = blockIdx.x * splits + rank;

  if (tid == 0) {
    for (int s = 0; s < K::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread keeps the ring full, per chunk W1c's items, then
    // W2^T c's, then W1^T c's, in the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      int item = 0;
      for (int c = c_begin; c < c_end; ++c) {
        for (int it = 0; it < 3 * K::kItems; ++it, ++item) {
          const int s = item % K::kStages;
          mbar_wait(smem_u32(&empty[s]), ((item / K::kStages) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]), dst = ring + s * kStageBytes;
          mbar_expect_tx(bar, K::kItemBytes);
          const int op = it / K::kItems, part = it % K::kItems;
          if (op < 2) {
            const CUtensorMap* map = op == 0 ? &w1_map : &w2t_map;
            for (int b = 0; b < K::kItemK / 64; ++b)
              tma_load_2d(dst + b * 8192, map, bar, part * K::kItemK + b * 64, c * kHC);
          } else {
            tma_load_2d(dst, &w1t_map, bar, c * kHC, part * K::kItemK);
          }
        }
      }
    }
    if (splits > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  const int hcol = 32 * wg;          // the warpgroup's columns of h, da and dh within a chunk
  const int ocol = K::kN2 * wg;      // its columns of dln
  ln_rows_sw128<(C + 255) / 256, 8 / ((C + 255) / 256)>(x, ln_w, ln_b, base, kBM, m0, M, C, eps,
                                                        tid / 32, kConsumers / 32);
  {
    // do = g (Drop: . m2 / (1 - r_out)) rounded to bf16 into the do tile, 8
    // columns a thread at a time (two whole Philox blocks); Full: the
    // thread's column sums of the f32 do
    constexpr int G = C / 8, kRowStep = kConsumers / G;
    const int g8 = tid % G;
    float cs[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) cs[k] = 0.f;
    for (int r = tid / G; r < kBM; r += kRowStep) {
      const int row = m0 + r;
      float v[8];
      if (row < M) {
        load8(g + (size_t)row * C + 8 * g8, v);
        if (Drop) philox::apply8(d2, (unsigned long long)row * C + 8 * g8, v);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = 0.f;
      }
      uint32_t packed[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cs[2 * k] += v[2 * k];
        cs[2 * k + 1] += v[2 * k + 1];
        packed[k] = fwd::pack_bf16(v[2 * k], v[2 * k + 1]);
      }
      *reinterpret_cast<uint4*>(base + K::kTileBytes + (8 * g8 >> 6) * kBM * 128 +
                                sw128_offset(r, (8 * g8) & 63)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    if (Full) {
      float* scratch = reinterpret_cast<float*>(at_s);
#pragma unroll
      for (int k = 0; k < 8; ++k) scratch[tid * 8 + k] = cs[k];
    }
  }
  fence_async_smem();
  named_barrier(1, kConsumers);
  if (Full) {
    // db2's partial: the threads of a column group in thread order
    const float* scratch = reinterpret_cast<const float*>(at_s);
    constexpr int G = C / 8;
    for (int c = tid; c < C; c += kConsumers) {
      float t = 0.f;
      for (int q = c / 8; q < kConsumers; q += G) t += scratch[q * 8 + c % 8];
      vpart[(size_t)slot * 3 * C + 2 * C + c] = rank == 0 ? t : 0.f;
    }
    if (rank == 0) {
      // LN(x)^T and do^T: 8 rows of one channel a thread, gathered from the swizzled tiles
      for (int i = tid; i < C * (kBM / 8); i += kConsumers) {
        const int c = i / (kBM / 8), r8 = (i % (kBM / 8)) * 8;
        const uint32_t off = (c >> 6) * kBM * 128;
        uint32_t lp[4], dp[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat16* l0 = reinterpret_cast<const __nv_bfloat16*>(
              base + off + sw128_offset(r8 + 2 * k, c & 63));
          const __nv_bfloat16* l1 = reinterpret_cast<const __nv_bfloat16*>(
              base + off + sw128_offset(r8 + 2 * k + 1, c & 63));
          __nv_bfloat162 lv, dv;
          lv.x = l0[0], lv.y = l1[0];
          dv.x = l0[K::kTileBytes / 2], dv.y = l1[K::kTileBytes / 2];
          lp[k] = *reinterpret_cast<uint32_t*>(&lv);
          dp[k] = *reinterpret_cast<uint32_t*>(&dv);
        }
        const size_t o = (size_t)c * ld + m0 + r8;
        *reinterpret_cast<uint4*>(ln_t + o) = make_uint4(lp[0], lp[1], lp[2], lp[3]);
        *reinterpret_cast<uint4*>(do_t + o) = make_uint4(dp[0], dp[1], dp[2], dp[3]);
      }
    }
    named_barrier(1, kConsumers);   // the scratch is staging again
  }

  float acc[K::kAcc];
#pragma unroll
  for (int e = 0; e < K::kAcc; ++e) acc[e] = 0.f;
  int item = 0;
  for (int c = c_begin; c < c_end; ++c) {
    const int j0 = c * kHC;
    float bj[4][2];   // the chunk's b1 at this thread's columns: in flight during the products
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      const float2 b = *reinterpret_cast<const float2*>(b1 + j0 + hcol + 8 * jb + 2 * (lane & 3));
      bj[jb][0] = b.x;
      bj[jb][1] = b.y;
    }
    // h = LN . W1c^T and da = do . W2^T c on the warpgroup's 32 columns: h's
    // items, then da's, one product group in flight behind the next (each
    // item released once its group is done)
    float hacc[16], dacc[16];
    const int rA = warp * 16 + (lane >> 2);
    constexpr int kHD = 2 * K::kItems;
#pragma unroll
    for (int q = 0; q < kHD; ++q) {
      const int op = q / K::kItems, it = q % K::kItems;
      const int s = (item + q) % K::kStages;
      mbar_wait(smem_u32(&full[s]), ((item + q) / K::kStages) & 1);
      const uint32_t st = ring + s * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < K::kItemK / 64; ++b) {
        const int slice = it * (K::kItemK / 64) + b;
        const uint64_t da = sw128_desc((op == 0 ? ln_s : do_s) + slice * kBM * 128);
        const uint64_t db = sw128_desc(st + b * 8192 + hcol * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (op == 0)
            wgmma_k16(hacc, da + 2 * kk, db + 2 * kk, slice + kk > 0);
          else
            wgmma_k16(dacc, da + 2 * kk, db + 2 * kk, slice + kk > 0);
        }
      }
      wgmma_commit();
      if (q + 1 < kHD)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      if (lane == 0) {
        if (q > 0) mbar_arrive(smem_u32(&empty[(item + q - 1) % K::kStages]));
        if (q + 1 == kHD) mbar_arrive(smem_u32(&empty[(item + q) % K::kStages]));
      }
    }
    item += kHD;
    fence_regs(hacc);
    fence_regs(dacc);
    // both warpgroups are past the previous chunk's reads of the dh tile and
    // the staging tiles
    named_barrier(1, kConsumers);
    // dh = da . act'(h + b1) and a = act(h + b1), both (Drop) . m1 / (1 -
    // r_act) of (token, hidden unit); dh rounded to bf16 into the dh tile
    float dsum[4][2];
    switch (act) {
      case kRelu:
        dh_tile<kRelu, Full, Drop>(hacc, dacc, bj, dsum, hcol, lane, rA, d1, m0, hidden, j0,
                                   base + (dh_s - ln_s), at_s, dht_s);
        break;
      case kLeaky:
        dh_tile<kLeaky, Full, Drop>(hacc, dacc, bj, dsum, hcol, lane, rA, d1, m0, hidden, j0,
                                    base + (dh_s - ln_s), at_s, dht_s);
        break;
      case kSilu:
        dh_tile<kSilu, Full, Drop>(hacc, dacc, bj, dsum, hcol, lane, rA, d1, m0, hidden, j0,
                                   base + (dh_s - ln_s), at_s, dht_s);
        break;
      default:
        dh_tile<kGelu, Full, Drop>(hacc, dacc, bj, dsum, hcol, lane, rA, d1, m0, hidden, j0,
                                   base + (dh_s - ln_s), at_s, dht_s);
    }
    fence_async_smem();
    named_barrier(1, kConsumers);
    // dln += dh . W1^T c on the warpgroup's columns
#pragma unroll
    for (int it = 0; it < K::kItems; ++it) {
      const int s = (item + it) % K::kStages;
      mbar_wait(smem_u32(&full[s]), ((item + it) / K::kStages) & 1);
      if (K::kItems == 1 || it == wg) {
        const uint64_t da = sw128_desc(dh_s);
        const uint64_t db = sw128_desc(ring + s * kStageBytes + (K::kItems == 1 ? ocol * 128 : 0));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
      }
    }
    if (Full) {
      // while the product runs: gelu(h)^T and dh^T of the chunk, 16 bytes (8
      // tokens of one hidden unit) a store, and the chunk's dh column sums
      for (int i = tid; i < kHC * (kBM / 8); i += kConsumers) {
        const int j = i / (kBM / 8), r8 = (i % (kBM / 8)) * 8;
        const size_t o = (size_t)(j0 + j) * ld + m0 + r8;
        *reinterpret_cast<uint4*>(a_t + o) = *reinterpret_cast<const uint4*>(at_s + j * kLdT + r8);
        *reinterpret_cast<uint4*>(dh_t + o) = *reinterpret_cast<const uint4*>(dht_s + j * kLdT + r8);
      }
#pragma unroll
      for (int jb = 0; jb < 4; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = dsum[jb][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
          dsum[jb][e] = t;
        }
      if (lane < 4) {
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          csum[tid / 32][8 * jb + 2 * lane] = dsum[jb][0];
          csum[tid / 32][8 * jb + 2 * lane + 1] = dsum[jb][1];
        }
      }
      named_barrier(2, kConsumers);
      if (tid < kHC) {   // a warpgroup's four warps in order
        const int w0 = (tid / 32) * 4;
        float t = csum[w0][tid % 32];
        for (int q = 1; q < 4; ++q) t += csum[w0 + q][tid % 32];
        db1_part[(size_t)blockIdx.x * hidden + j0 + tid] = t;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) {
#pragma unroll
      for (int it = 0; it < K::kItems; ++it) mbar_arrive(smem_u32(&empty[(item + it) % K::kStages]));
    }
    item += K::kItems;
  }
  fence_regs(acc);

  // the rank's dln partial, row-major f32 from the LN tile on (every product
  // of both warpgroups has read the tiles)
  float* red = reinterpret_cast<float*>(base);
  named_barrier(1, kConsumers);
  {
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int jb = 0; jb < K::kN2 / 8; ++jb) {
      const int n = ocol + 8 * jb + 2 * (lane & 3);
      *reinterpret_cast<float2*>(red + r0 * C + n) = make_float2(acc[4 * jb], acc[4 * jb + 1]);
      *reinterpret_cast<float2*>(red + (r0 + 8) * C + n) =
          make_float2(acc[4 * jb + 2], acc[4 * jb + 3]);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();
  else
    named_barrier(1, kConsumers);
  // dx = g + the LayerNorm backward of dln = the ranks' partials added in
  // rank order; a warp per row, rank r the rows [r, r + 1) * 64 / splits; a
  // lane 4 channels of each 128
  constexpr int kPer = C / 128;
  float sg[kPer][4], sb[kPer][4];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) sg[p][k] = sb[p][k] = 0.f;
  const int nr = kBM / splits;
  for (int r = rank * nr + tid / 32; r < (rank + 1) * nr; r += kConsumers / 32) {
    const int row = m0 + r;
    if (row >= M) break;
    float dl[kPer][4], xv[kPer][4];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = 4 * lane + 128 * p;
      const float4 xq = load4(x + (size_t)row * C + c);
      xv[p][0] = xq.x, xv[p][1] = xq.y, xv[p][2] = xq.z, xv[p][3] = xq.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) dl[p][k] = 0.f;
      for (int q = 0; q < splits; ++q) {
        const float* peer = splits > 1 ? cluster.map_shared_rank(red, q) : red;
        const float4 v = *reinterpret_cast<const float4*>(peer + r * C + c);
        dl[p][0] += v.x, dl[p][1] += v.y, dl[p][2] += v.z, dl[p][3] += v.w;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) s += xv[p][k];
    const float mu = gradk::warp_sum_all(s) / C;
    float var = 0.f;
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = xv[p][k] - mu;
        var += d * d;
      }
    const float rs = rsqrtf(gradk::warp_sum_all(var) / C + eps);
    float s1 = 0.f, s2 = 0.f, wv[kPer][4];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float4 wq = *reinterpret_cast<const float4*>(ln_w + 4 * lane + 128 * p);
      wv[p][0] = wq.x, wv[p][1] = wq.y, wv[p][2] = wq.z, wv[p][3] = wq.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float dn = dl[p][k] * wv[p][k];
        s1 += dn;
        s2 += dn * (xv[p][k] - mu) * rs;
      }
    }
    const float m1 = gradk::warp_sum_all(s1) / C, m2 = gradk::warp_sum_all(s2) / C;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const size_t o = (size_t)row * C + 4 * lane + 128 * p;
      const float4 gq = load4(g + o);
      const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float nhat = (xv[p][k] - mu) * rs;
        out[k] = gv[k] + rs * (dl[p][k] * wv[p][k] - m1 - nhat * m2);
        if (Full) {
          sg[p][k] += dl[p][k] * nhat;
          sb[p][k] += dl[p][k];
        }
      }
      store4(dx + o, make_float4(out[0], out[1], out[2], out[3]));
    }
  }
  if (Full) {
    // the rank's dgamma / dbeta partials: the warps' column sums in warp order
    float* vs = red + kBM * C;   // [warp][2][C], past every rank's partial
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = 4 * lane + 128 * p;
      *reinterpret_cast<float4*>(vs + (tid / 32) * 2 * C + c) =
          make_float4(sg[p][0], sg[p][1], sg[p][2], sg[p][3]);
      *reinterpret_cast<float4*>(vs + (tid / 32) * 2 * C + C + c) =
          make_float4(sb[p][0], sb[p][1], sb[p][2], sb[p][3]);
    }
    named_barrier(1, kConsumers);
    for (int i = tid; i < 2 * C; i += kConsumers) {
      float t = vs[i];
      for (int q = 1; q < kConsumers / 32; ++q) t += vs[q * 2 * C + i];
      vpart[(size_t)slot * 3 * C + i] = t;
    }
  }
  if (splits > 1) cluster.sync();   // no block leaves while a peer may still read its partial
}

template <int C, bool Full, bool Drop, typename T>
cudaError_t launch(const CUtensorMap& w1, const CUtensorMap& w2t, const CUtensorMap& w1t,
                   const T* x, const T* g, const float* ln_w, const float* ln_b,
                   const float* b1, T* dx, __nv_bfloat16* ln_t, __nv_bfloat16* do_t,
                   __nv_bfloat16* a_t, __nv_bfloat16* dh_t, float* vpart, float* db1_part, int M,
                   int hidden, int ld, int splits, float eps, int act, philox::Drop d1,
                   philox::Drop d2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ffn_bwd_kernel<C, Full, Drop, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<C>::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + kBM - 1) / kBM, 1, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<C>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, ffn_bwd_kernel<C, Full, Drop, T>, w1, w2t, w1t, x, g,
                                       ln_w, ln_b, b1, dx, ln_t, do_t, a_t, dh_t, vpart, db1_part,
                                       M, hidden, ld, eps, act, d1, d2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The backward kernel for C; checks the arguments (a refusal returns
// cudaErrorInvalidValue).
template <bool Full, bool Drop, typename T>
cudaError_t backward(const void* w1_map, const void* w2t_map, const void* w1t_map, const T* x,
                     const T* g, const float* ln_w, const float* ln_b, const float* b1,
                     T* dx, __nv_bfloat16* ln_t, __nv_bfloat16* do_t, __nv_bfloat16* a_t,
                     __nv_bfloat16* dh_t, float* vpart, float* db1_part, int M, int C, int hidden,
                     int ld, int splits, float eps, int act, philox::Drop d1, philox::Drop d2,
                     cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M < 1 || hidden < kHC || hidden % kHC || splits < 1 || splits > kMaxSplits ||
      (splits & (splits - 1)) || splits > hidden / kHC || act < kGelu || act > kSilu ||
      !aligned(x) || !aligned(g) ||
      !aligned(ln_w) || !aligned(ln_b) || !aligned(b1) || !aligned(dx) ||
      (Full && (ld % 64 || ld < (M + kBM - 1) / kBM * kBM || !aligned(ln_t) || !aligned(do_t) ||
                !aligned(a_t) || !aligned(dh_t))))
    return cudaErrorInvalidValue;
  CUtensorMap w1, w2t, w1t;
  memcpy(&w1, w1_map, sizeof(w1));
  memcpy(&w2t, w2t_map, sizeof(w2t));
  memcpy(&w1t, w1t_map, sizeof(w1t));
  switch (C) {
    case 128:
      return launch<128, Full, Drop, T>(w1, w2t, w1t, x, g, ln_w, ln_b, b1, dx, ln_t, do_t, a_t, dh_t,
                                     vpart, db1_part, M, hidden, ld, splits, eps, act, d1, d2,
                                     stream);
    case 256:
      return launch<256, Full, Drop, T>(w1, w2t, w1t, x, g, ln_w, ln_b, b1, dx, ln_t, do_t, a_t, dh_t,
                                     vpart, db1_part, M, hidden, ld, splits, eps, act, d1, d2,
                                     stream);
    case 512:
      return launch<512, Full, Drop, T>(w1, w2t, w1t, x, g, ln_w, ln_b, b1, dx, ln_t, do_t, a_t, dh_t,
                                     vpart, db1_part, M, hidden, ld, splits, eps, act, d1, d2,
                                     stream);
    default: return cudaErrorInvalidValue;
  }
}

// Every gradient: the kernel, then the vector gradients' partials added in
// order and the two weight gradients on the wgmma TN product.
template <bool Drop>
cudaError_t full(const void* w1_map, const void* w2t_map, const void* w1t_map, const float* x,
                 const float* g, const float* ln_w, const float* ln_b, const float* b1,
                 __nv_bfloat16* ln_t, __nv_bfloat16* do_t, __nv_bfloat16* a_t,
                 __nv_bfloat16* dh_t, float* vpart, float* db1_part, float* dx, float* dw1,
                 float* db1, float* dw2, float* vec, int M, int C, int hidden, int ld, int splits,
                 int wsplit1, int wsplit2, float eps, int act, philox::Drop d1, philox::Drop d2,
                 cudaStream_t stream) {
  cudaError_t err = backward<true, Drop, float>(w1_map, w2t_map, w1t_map, x, g, ln_w, ln_b, b1,
                                                dx, ln_t, do_t, a_t, dh_t, vpart, db1_part, M, C,
                                                hidden, ld, splits, eps, act, d1, d2, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM;
  err = gradk::sum_partials(vpart, vec, (size_t)3 * C, tiles * splits, stream);
  if (err != cudaSuccess) return err;
  err = gradk::sum_partials(db1_part, db1, (size_t)hidden, tiles, stream);
  if (err != cudaSuccess) return err;
  err = gradk::weight_grad(dh_t, ln_t, dw1, hidden, C, M, ld, wsplit1, stream);   // dh^T . LN(x)
  if (err != cudaSuccess) return err;
  return gradk::weight_grad(do_t, a_t, dw2, C, hidden, M, ld, wsplit2, stream);   // do^T . a
}

}  // namespace bwd

}  // namespace

// Every entry point takes the activation `act` after eps: 0 exact-erf GELU,
// 1 ReLU, 2 leaky ReLU (0.1), 3 SiLU (enum Act); any other value is refused
// with cudaErrorInvalidValue.
//
// x, out (M, C) f32; w1_map / w2_map the tensor maps of the bf16 copies of
// w1 (hidden, C) and w2 (C, hidden) (bf16_matrix_map, boxes of 64 and
// min(C, 256) rows); the cluster's `splits` of the hidden / 64 chunks.  One
// launch.
extern "C" int ffn_forward(const float* x, const float* ln_w, const float* ln_b,
                           const void* w1_map, const float* b1, const void* w2_map,
                           const float* b2, float* out, int M, int C, int hidden, int splits,
                           float eps, int act, cudaStream_t stream) {
  return fwd::forward<false>(x, ln_w, ln_b, w1_map, b1, w2_map, b2, out, M, C, hidden, splits, eps,
                             act, philox::Drop{}, philox::Drop{}, stream);
}

// The bf16 form of ffn_forward: x and out (M, C) bf16 (the residual added in
// f32 and rounded once); the rest as there.  One launch.
extern "C" int ffn_forward_bf16(const __nv_bfloat16* x, const float* ln_w, const float* ln_b,
                                const void* w1_map, const float* b1, const void* w2_map,
                                const float* b2, __nv_bfloat16* out, int M, int C, int hidden,
                                int splits, float eps, int act, cudaStream_t stream) {
  return fwd::forward<false>(x, ln_w, ln_b, w1_map, b1, w2_map, b2, out, M, C, hidden, splits, eps,
                             act, philox::Drop{}, philox::Drop{}, stream);
}

// dx of the fused FFN for the output cotangent g; w1_map, w2t_map, w1t_map
// the tensor maps of the bf16 copies of w1 (hidden, C) (boxes of 64 rows),
// w2^T (hidden, C) (64 rows) and w1^T (C, hidden) (min(C, 256) rows); the
// cluster's `splits` of the hidden / 64 chunks.  One launch.
extern "C" int ffn_bwd_dx(const float* x, const float* g, const float* ln_w, const float* ln_b,
                          const void* w1_map, const float* b1, const void* w2t_map,
                          const void* w1t_map, float* dx, int M, int C, int hidden, int splits,
                          float eps, int act, cudaStream_t stream) {
  return (int)bwd::backward<false, false>(w1_map, w2t_map, w1t_map, x, g, ln_w, ln_b, b1, dx,
                                          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M,
                                          C, hidden, 0, splits, eps, act, philox::Drop{},
                                          philox::Drop{}, stream);
}

// The bf16 form of ffn_bwd_dx: x, g and dx (M, C) bf16; the rest as there.
extern "C" int ffn_bwd_dx_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g, const float* ln_w,
                               const float* ln_b, const void* w1_map, const float* b1,
                               const void* w2t_map, const void* w1t_map, __nv_bfloat16* dx, int M,
                               int C, int hidden, int splits, float eps, int act,
                               cudaStream_t stream) {
  return (int)bwd::backward<false, false>(w1_map, w2t_map, w1t_map, x, g, ln_w, ln_b, b1, dx,
                                          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M,
                                          C, hidden, 0, splits, eps, act, philox::Drop{},
                                          philox::Drop{}, stream);
}

// Every gradient of the fused FFN for the output cotangent g.  Maps and
// splits as ffn_bwd_dx.  Workspaces: ln_t, do_t (C, ld) and a_t, dh_t
// (hidden, ld) bf16, width-major with ld >= M rounded up to 64 tokens;
// vpart (ceil(M / 64) * splits, 3, C) and db1_part (ceil(M / 64), hidden)
// f32.  wsplit1, wsplit2: the weight-gradient products' token splits.  Out:
// dx (M, C), dw1 (hidden, C), db1 (hidden), dw2 (C, hidden), vec (3, C) =
// dgamma, dbeta, db2.  Five launches.
extern "C" int ffn_bwd_full(const float* x, const float* g, const float* ln_w,
                            const float* ln_b, const void* w1_map, const float* b1,
                            const void* w2t_map, const void* w1t_map, __nv_bfloat16* ln_t,
                            __nv_bfloat16* do_t, __nv_bfloat16* a_t, __nv_bfloat16* dh_t,
                            float* vpart, float* db1_part, float* dx, float* dw1, float* db1,
                            float* dw2, float* vec, int M, int C, int hidden, int ld, int splits,
                            int wsplit1, int wsplit2, float eps, int act, cudaStream_t stream) {
  return (int)bwd::full<false>(w1_map, w2t_map, w1t_map, x, g, ln_w, ln_b, b1, ln_t, do_t, a_t,
                               dh_t, vpart, db1_part, dx, dw1, db1, dw2, vec, M, C, hidden, ld,
                               splits, wsplit1, wsplit2, eps, act, philox::Drop{}, philox::Drop{},
                               stream);
}

// The fused FFN with dropout on gelu(h) (thr_act, keep_act = 1 - rate) and on
// the output before the residual (thr_out, keep_out); the masks are those of
// the stream (seed_lo, seed_hi, site), tensors 0 and 1, from the element bases
// base_act and base_out (multiples of 4, philox.cuh); where seed_ptr is not
// null, the kernels read the seed words there (a device seed, philox.cuh) and
// seed_lo, seed_hi are unused.  Arguments as ffn_forward.
extern "C" int ffn_dropout_forward(const float* x, const float* ln_w, const float* ln_b,
                                   const void* w1_map, const float* b1, const void* w2_map,
                                   const float* b2, float* out, int M, int C, int hidden,
                                   int splits, float eps, int act,
                                   const unsigned long long* seed_ptr, unsigned seed_lo,
                                   unsigned seed_hi, unsigned site, unsigned thr_act,
                                   float keep_act, unsigned thr_out, float keep_out,
                                   unsigned long long base_act, unsigned long long base_out,
                                   cudaStream_t stream) {
  const philox::Drop d1{seed_lo, seed_hi, site, 0u, thr_act, keep_act, base_act >> 2,
                        seed_ptr};
  const philox::Drop d2{seed_lo, seed_hi, site, 1u, thr_out, keep_out, base_out >> 2,
                        seed_ptr};
  return fwd::forward<true>(x, ln_w, ln_b, w1_map, b1, w2_map, b2, out, M, C, hidden, splits, eps,
                            act, d1, d2, stream);
}

// Every gradient of ffn_dropout_forward for the output cotangent g, the masks
// regenerated from the same (seed, site).  Arguments as ffn_bwd_full; do_t
// holds the dropped cotangent.
extern "C" int ffn_dropout_bwd_full(const float* x, const float* g, const float* ln_w,
                                    const float* ln_b, const void* w1_map, const float* b1,
                                    const void* w2t_map, const void* w1t_map,
                                    __nv_bfloat16* ln_t, __nv_bfloat16* do_t, __nv_bfloat16* a_t,
                                    __nv_bfloat16* dh_t, float* vpart, float* db1_part, float* dx,
                                    float* dw1, float* db1, float* dw2, float* vec, int M, int C,
                                    int hidden, int ld, int splits, int wsplit1, int wsplit2,
                                    float eps, int act, const unsigned long long* seed_ptr,
                                    unsigned seed_lo, unsigned seed_hi, unsigned site,
                                    unsigned thr_act, float keep_act, unsigned thr_out,
                                    float keep_out, unsigned long long base_act,
                                    unsigned long long base_out, cudaStream_t stream) {
  const philox::Drop d1{seed_lo, seed_hi, site, 0u, thr_act, keep_act, base_act >> 2,
                        seed_ptr};
  const philox::Drop d2{seed_lo, seed_hi, site, 1u, thr_out, keep_out, base_out >> 2,
                        seed_ptr};
  return (int)bwd::full<true>(w1_map, w2t_map, w1t_map, x, g, ln_w, ln_b, b1, ln_t, do_t, a_t,
                              dh_t, vpart, db1_part, dx, dw1, db1, dw2, vec, M, C, hidden, ld,
                              splits, wsplit1, wsplit2, eps, act, d1, d2, stream);
}
