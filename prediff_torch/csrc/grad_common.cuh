// Pieces shared by the all-gradients backward kernels (ffn.cu, attention.cu,
// groupnorm.cu).  A parameter gradient is a sum over every token, and CUDA
// blocks run in no order, so nothing here adds into a shared result: partial
// sums are added in a fixed order (through distributed shared memory in rank
// order, or by sum_partials_kernel).  No atomics: the same inputs give the
// same bits on every run.
//
//   wgrad_kernel           out = A^T . B, a weight gradient: both operands are
//                          (tokens, width) and the product contracts over the
//                          tokens.  They are stored width-major (width rows of
//                          tokens, bf16), so both are K-major wgmma operands
//                          read by TMA, as the forwards' weights are; the
//                          tokens are split over a thread-block cluster whose
//                          partials are added in rank order
//   cast_t_kernel          a (tokens, width) f32 or bf16 matrix into that
//                          width-major bf16 layout (and, where asked, into
//                          bf16 as it is), f32 through a dropout mask
//   ln_vec_partial_kernel  per block of 8 rows, the column sums of dln . nhat,
//                          dln and g: the LayerNorm scale / bias gradients and
//                          the output bias gradient (of g through the module's
//                          output dropout, where it has one)
//   sum_partials_kernel    out[i] = sum_z part[z][i] in a fixed order
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "philox.cuh"

// Everything here has internal linkage (an unnamed namespace): each library
// built on this header (a separate .so with its own CUDA runtime) keeps its
// own kernels and launchers, and a kernel's address taken for
// cudaLaunchKernelEx is never resolved to another library's copy.
namespace gradk {
namespace {

constexpr int kVecRows = 8;                  // rows per block of ln_vec_partial_kernel
constexpr int kVecThreads = 256;

__device__ __forceinline__ float warp_sum_all(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The weight-gradient product on TMA + wgmma: out (P, Q) f32 = At (P, M) .
// Bt (Q, M)^T over the M tokens, At and Bt bf16 with a row stride of ld
// tokens (the width-major layout of the (tokens, width) operands).  A block
// owns a 128 x 128 tile of out (two consumer warpgroups of 64 rows, wgmma
// m64n128k16) and one share of the tokens' 64-token slices; the shares of a
// tile are a cluster of 1, 2, 4 or 8 blocks (grid z), which add their f32
// partials through distributed shared memory in rank order.  One producer
// warp keeps a 4-stage ring of 64-token slices of both operands full by TMA;
// tokens past M and rows past P or Q read as zeros.
namespace wgrad {

using namespace hopper;

constexpr int kBM = 128, kBN = 128, kStages = 4, kMaxSplits = 8;
constexpr int kATile = kBM * 128, kStage = kATile + kBN * 128;   // 16 + 16 KB
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kAcc = kBN / 2;                                     // f32 a consumer thread
constexpr int kSmem = 1024 + kStages * kStage;
static_assert(kConsumers * kAcc * 4 <= kStages * kStage, "the partial fits the ring");

// grid (Q tiles, P tiles, splits), clusters of (1, 1, splits): block z adds
// token slices [z, z + 1) * slices / splits.
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
             float* __restrict__ out, int P, int Q, int slices) {
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (ring - raw));
  const int tid = threadIdx.x;
  const int p0 = blockIdx.y * kBM, q0 = blockIdx.x * kBN;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int s_begin = rank * slices / splits, s_end = (rank + 1) * slices / splits;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {   // producer warp: one thread issues the loads
    if (tid == kConsumers) {
      for (int ks = s_begin, i = 0; ks < s_end; ++ks, ++i) {
        const int s = i % kStages;
        mbar_wait(smem_u32(&empty[s]), ((i / kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]), dst = ring + s * kStage;
        mbar_expect_tx(bar, kStage);
        tma_load_2d(dst, &a_map, bar, ks * 64, p0);
        tma_load_2d(dst + kATile, &b_map, bar, ks * 64, q0);
      }
    }
    if (splits > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
    return;
  }
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  for (int ks = s_begin, i = 0; ks < s_end; ++ks, ++i) {
    const int s = i % kStages;
    mbar_wait(smem_u32(&full[s]), (i / kStages) & 1);
    const uint32_t st = ring + s * kStage;
    const uint64_t da = sw128_desc(st + wg * 64 * 128), db = sw128_desc(st + kATile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(i - 1) % kStages]));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // rows r0 and r0 + 8 of the warpgroup's 64, columns 8 jb + 2 (lane % 4) (+1)
  const int row0 = p0 + wg * 64 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  auto store = [&](int jb, const float (&v)[4]) {
    const int n = q0 + 8 * jb + 2 * (lane & 3);
    if (n >= Q) return;
    if (row0 < P) *reinterpret_cast<float2*>(out + (size_t)row0 * Q + n) = make_float2(v[0], v[1]);
    if (row1 < P) *reinterpret_cast<float2*>(out + (size_t)row1 * Q + n) = make_float2(v[2], v[3]);
  };
  if (splits == 1) {
#pragma unroll
    for (int jb = 0; jb < kBN / 8; ++jb) {
      const float v[4] = {acc[4 * jb], acc[4 * jb + 1], acc[4 * jb + 2], acc[4 * jb + 3]};
      store(jb, v);
    }
    return;
  }
  // park the partial in the ring (every wgmma of both warpgroups has read it),
  // then each rank adds its share of the 8-column groups (jb = rank + t *
  // splits) over the cluster's ranks in rank order
  cg::cluster_group cluster = cg::this_cluster();
  named_barrier(1, kConsumers);
#pragma unroll
  for (int e = 0; e < kAcc; ++e) red[e * kConsumers + tid] = acc[e];
  cluster.sync();
  for (int jb = rank; jb < kBN / 8; jb += splits) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < splits; ++q) {
      const float* peer = cluster.map_shared_rank(red, q);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += peer[(4 * jb + e) * kConsumers + tid];
    }
    store(jb, v);
  }
  cluster.sync();   // no block leaves while a peer may still read its partial
}

}  // namespace wgrad

// The tensor map of a width-major bf16 operand of wgrad_kernel: rows x M
// tokens, row stride ld tokens (ld % 8 == 0), boxes of 64 tokens x 128 rows.
inline int encode_tokens_map(CUtensorMap* map, const __nv_bfloat16* base, int rows, int M,
                             int ld) {
  if (rows < 1 || M < 1 || ld < M || ld % 8 || (reinterpret_cast<uintptr_t>(base) & 15))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)wgrad::kBM};
  return hopper::encode_bf16(map, base, 2, dims, strides, box);
}

// out (P, Q) f32 = At (P, M) . Bt (Q, M)^T over M tokens (the weight gradient
// A^T . B of the (tokens, width) operands), At and Bt width-major bf16 with a
// row stride of ld tokens; splits (1, 2, 4 or 8, at most the 64-token
// slices) the cluster's split of the tokens.  One launch.
inline cudaError_t weight_grad(const __nv_bfloat16* At, const __nv_bfloat16* Bt, float* out, int P,
                               int Q, int M, int ld, int splits, cudaStream_t stream) {
  const int slices = (M + 63) / 64;
  if (P < 1 || Q < 2 || Q % 2 || splits < 1 || splits > wgrad::kMaxSplits || splits > slices ||
      (splits & (splits - 1)))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(wgrad::wgrad_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           wgrad::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap a, b;
  int enc = encode_tokens_map(&a, At, P, M, ld);
  if (enc == 0) enc = encode_tokens_map(&b, Bt, Q, M, ld);
  if (enc != 0) return (cudaError_t)enc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Q + wgrad::kBN - 1) / wgrad::kBN, (P + wgrad::kBM - 1) / wgrad::kBM, splits);
  cfg.blockDim = dim3(wgrad::kThreads);
  cfg.dynamicSmemBytes = wgrad::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, wgrad::wgrad_kernel, a, b, out, P, Q, slices);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// dst_t (W, ld) bf16 = src (M, W)^T and dst (M, W) bf16 = src, each where
// given: src f32 (through the dropout `drop` of element (row, column), which
// keeps everything at thr 0; rounded to nearest) or bf16.  32 x 32 tiles
// through shared memory, 4 columns a thread (one whole Philox block), both
// sides coalesced; W % 4 == 0, ld >= M rounded up to 32.
constexpr int kTT = 32, kTThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kTThreads)
cast_t_kernel(const T* __restrict__ src, __nv_bfloat16* __restrict__ dst,
              __nv_bfloat16* __restrict__ dst_t, int M, int W, int ld, philox::Drop drop) {
  philox::load_key(drop);
  __shared__ __nv_bfloat16 tile[kTT][kTT + 4];
  const int m0 = blockIdx.y * kTT, w0 = blockIdx.x * kTT;
  const int r = threadIdx.x / 8, c4 = (threadIdx.x % 8) * 4;
  const int m = m0 + r, w = w0 + c4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (m < M && w < W) {
    const size_t o = (size_t)m * W + w;
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + o);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      if (drop.thr != 0u) {
        const uint4 d = philox::block(drop, o);
        const unsigned u[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = u[k] >= drop.thr ? v[k] / drop.keep : 0.f;
      }
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(src + o);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    }
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  if (dst != nullptr && m < M && w < W)
    *reinterpret_cast<uint2*>(dst + (size_t)m * W + w) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  tile[r][c4] = lo.x, tile[r][c4 + 1] = lo.y, tile[r][c4 + 2] = hi.x, tile[r][c4 + 3] = hi.y;
  __syncthreads();
  // thread (r, c4) writes tokens m0 + c4 .. + 3 of column w0 + r
  if (dst_t != nullptr && w0 + r < W) {
    __nv_bfloat162 a, b;
    a.x = tile[c4][r], a.y = tile[c4 + 1][r], b.x = tile[c4 + 2][r], b.y = tile[c4 + 3][r];
    *reinterpret_cast<uint2*>(dst_t + (size_t)(w0 + r) * ld + m0 + c4) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
  }
}

template <typename T>
cudaError_t cast_t(const T* src, __nv_bfloat16* dst, __nv_bfloat16* dst_t, int M, int W, int ld,
                   cudaStream_t stream, philox::Drop drop = philox::Drop{0u, 0u, 0u, 0u, 0u, 1.f}) {
  if (W % 4 || (dst_t != nullptr && (ld % 8 || ld < (M + kTT - 1) / kTT * kTT)))
    return cudaErrorInvalidValue;
  cast_t_kernel<T><<<dim3((W + kTT - 1) / kTT, (M + kTT - 1) / kTT), kTThreads, 0, stream>>>(
      src, dst, dst_t, M, W, ld, drop);
  return cudaGetLastError();
}

// out[i] = sum_z part[z * n + i] in a fixed order: group q of a block's
// threads adds z = q, q + kSumGroups, ... in order, then the groups' sums
// are added in group order (a block: kSumCols consecutive i, read coalesced).
constexpr int kSumCols = 32, kSumGroups = 8;

__global__ void __launch_bounds__(kSumCols * kSumGroups)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, size_t n,
                    int splits) {
  __shared__ float red[kSumGroups][kSumCols];
  const int c = threadIdx.x % kSumCols, q = threadIdx.x / kSumCols;
  const size_t i = blockIdx.x * (size_t)kSumCols + c;
  float acc = 0.f;
  if (i < n)
    for (int z = q; z < splits; z += kSumGroups) acc += part[(size_t)z * n + i];
  red[q][c] = acc;
  __syncthreads();
  if (q == 0 && i < n) {
    float t = red[0][c];
#pragma unroll
    for (int k = 1; k < kSumGroups; ++k) t += red[k][c];
    out[i] = t;
  }
}

// Block b owns rows [b, b + 1) * kVecRows of x, g (M, C) and of
// dln = sum_s dln_part[s] ((splits, M, C)); with nhat the normalised x it writes
//   vpart[b, 0, c] = sum_rows dln * nhat   (LayerNorm scale gradient)
//   vpart[b, 1, c] = sum_rows dln          (LayerNorm bias gradient)
//   vpart[b, 2, c] = sum_rows drop(g)      (output bias gradient; gdrop is the
//                                           output dropout of element (row, c),
//                                           which keeps everything at thr 0)
__global__ void __launch_bounds__(kVecThreads)
ln_vec_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ dln_part, int splits, float* __restrict__ vpart,
                      int M, int C, float eps, philox::Drop gdrop) {
  philox::load_key(gdrop);
  __shared__ float mu_s[kVecRows], rs_s[kVecRows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kVecRows;
  for (int r = warp; r < kVecRows; r += kVecThreads / 32) {
    const int gr = row0 + r;
    float mu = 0.f, rs = 0.f;
    if (gr < M) {
      const float* xr = x + (size_t)gr * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += xr[c];
      mu = warp_sum_all(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = xr[c] - mu;
        v += d * d;
      }
      rs = rsqrtf(warp_sum_all(v) / C + eps);
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rs_s[r] = rs;
    }
  }
  __syncthreads();
  const size_t n = (size_t)M * C;
  const int rows = min(kVecRows, M - row0);
  for (int c = tid; c < C; c += kVecThreads) {
    float sg = 0.f, sb = 0.f, so = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t idx = (size_t)(row0 + r) * C + c;
      float dln = dln_part[idx];
      for (int s = 1; s < splits; ++s) dln += dln_part[s * n + idx];
      sg += dln * (x[idx] - mu_s[r]) * rs_s[r];
      sb += dln;
      so += philox::apply(gdrop, idx, g[idx]);
    }
    float* dst = vpart + (size_t)blockIdx.x * 3 * C;
    dst[c] = sg;
    dst[C + c] = sb;
    dst[2 * C + c] = so;
  }
}

inline cudaError_t sum_partials(const float* part, float* out, size_t n, int splits,
                                cudaStream_t stream) {
  sum_partials_kernel<<<(unsigned)((n + kSumCols - 1) / kSumCols), kSumCols * kSumGroups, 0,
                        stream>>>(part, out, n, splits);
  return cudaGetLastError();
}

// vec (3, C) = the column sums of ln_vec_partial_kernel over all rows;
// vpart: (ceil(M / kVecRows), 3, C) f32 workspace.
inline cudaError_t ln_vec_grads(const float* x, const float* g, const float* dln_part,
                                int splits, float* vpart, float* vec, int M, int C, float eps,
                                cudaStream_t stream,
                                philox::Drop gdrop = philox::Drop{0u, 0u, 0u, 0u, 0u, 1.f}) {
  const int blocks = (M + kVecRows - 1) / kVecRows;
  ln_vec_partial_kernel<<<blocks, kVecThreads, 0, stream>>>(x, g, dln_part, splits, vpart, M, C,
                                                            eps, gdrop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(vpart, vec, (size_t)3 * C, blocks, stream);
}

}  // namespace
}  // namespace gradk
