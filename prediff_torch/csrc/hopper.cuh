// Hopper primitives shared by the kernels that run on TMA and wgmma
// (conv3d.cu, ffn.cu, attention.cu): mbarriers, TMA tile loads, the wgmma
// descriptor of a 128-byte-swizzled K-major bf16 tile and the
// m64n{32,64,128,256}k16 bf16 -> f32 products, the fences around them, a
// LayerNorm that writes its rows as such a tile, and the host-side encoder
// of TMA tensor maps (fetched through the CUDA runtime, so no library links
// against libcuda).
//
// A K-major operand tile is rows of 64 bf16 (128 bytes) under the 128-byte
// swizzle: row r at byte r * 128 of its 1024-byte-aligned tile, its 16-byte
// group g stored at group g ^ (r % 8).  That is what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes, and what sw128_offset computes for a tile
// written by threads.
#pragma once
#include <cuda.h>   // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "io.cuh"

namespace hopper {

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

// A box at (c0 innermost, c1); rows past the matrix come back as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle: 8-row groups 1024 bytes apart; the tile starts 1024-byte aligned
// (+ 32 bytes per 16-deep step along K: desc + 2).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Byte offset of element (row, k), k < 64, in such a tile: where a TMA load
// with the 128-byte swizzle puts it.
__device__ __forceinline__ uint32_t sw128_offset(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + ((k & 7) << 1);
}

// d (64 x 32, f32, the warpgroup's accumulator layout) (+)= A (64 x 16) . B (32 x 16)^T;
// accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_k16(float (&d)[16], uint64_t da, uint64_t db,
                                          int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32, the warpgroup's accumulator layout) (+)= A (64 x 16) . B (64 x 16)^T;
// accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32, the warpgroup's accumulator layout) (+)= A (64 x 16) . B (128 x 16)^T;
// accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, f32, the warpgroup's accumulator layout) (+)= A (64 x 16) . B (256 x 16)^T;
// accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t da, uint64_t db,
                                          int accumulate = 1) {
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
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
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

// After wgmma_wait: the accumulator's registers are final here.  The wgmma
// asm tells the compiler only that it writes them; this keeps every later
// read of them after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory writes of this thread made visible to the async proxy
// (wgmma's operand reads, TMA) before a barrier hands them over.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a multiple of 32.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// LayerNorm (two-pass mean and variance, f32) of rows m0 .. m0 + rows - 1 of
// x (M, K), f32 or bf16 (widened as read), into a bf16 A operand of wgmma:
// K / 64 swizzled tiles of `rows` rows, tile s at `tile` + s * rows * 128
// (1024-byte aligned); rows past M
// are zeros.  One warp per row, warps `warp` + i * `warps`, kBatch rows of a
// warp at a time, interleaved through every step (their loads in flight
// together, their shuffle reductions side by side: a row alone is a chain of
// dependent shuffles that leaves the warp idle); a lane takes 8 consecutive
// columns at a time, so K <= 256 * kMaxPer and K % 64 == 0; its columns of w
// and b stay in registers.  x, w and b are 16-byte aligned.  The caller
// fences (fence_async_smem) and synchronises before a wgmma reads the tile.
template <int kMaxPer, int kBatch, typename XT>
__device__ __forceinline__ void ln_rows_sw128(const XT* __restrict__ x,
                                              const float* __restrict__ w,
                                              const float* __restrict__ b, uint8_t* tile,
                                              int rows, int m0, int M, int K, float eps, int warp,
                                              int warps) {
  const int lane = threadIdx.x & 31, groups = K >> 3;
  float ws[kMaxPer][8], bs[kMaxPer][8];
#pragma unroll
  for (int p = 0; p < kMaxPer; ++p) {
    const int q = lane + 32 * p;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 wv = q < groups ? reinterpret_cast<const float4*>(w + 8 * q)[h] : zero;
      const float4 bv = q < groups ? reinterpret_cast<const float4*>(b + 8 * q)[h] : zero;
      ws[p][4 * h] = wv.x, ws[p][4 * h + 1] = wv.y;
      ws[p][4 * h + 2] = wv.z, ws[p][4 * h + 3] = wv.w;
      bs[p][4 * h] = bv.x, bs[p][4 * h + 1] = bv.y;
      bs[p][4 * h + 2] = bv.z, bs[p][4 * h + 3] = bv.w;
    }
  }
  for (int r0 = warp; r0 < rows; r0 += kBatch * warps) {
    float v[kBatch][kMaxPer][8], mu[kBatch], rs[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = r0 + i * warps, gr = m0 + r;
#pragma unroll
      for (int p = 0; p < kMaxPer; ++p) {
        const int q = lane + 32 * p;
        if (r < rows && q < groups && gr < M) {
          load8(x + (size_t)gr * K + 8 * q, v[i][p]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[i][p][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxPer; ++p)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[i][p][e];
      mu[i] = s;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < kBatch; ++i) mu[i] += __shfl_xor_sync(0xffffffffu, mu[i], o);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      mu[i] /= K;
      float var = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxPer; ++p) {
        if (lane + 32 * p < groups) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[i][p][e] - mu[i];
            var += d * d;
          }
        }
      }
      rs[i] = var;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < kBatch; ++i) rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], o);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = r0 + i * warps, gr = m0 + r;
      if (r >= rows) break;
      rs[i] = rsqrtf(rs[i] / K + eps);
#pragma unroll
      for (int p = 0; p < kMaxPer; ++p) {
        const int q = lane + 32 * p;
        if (q >= groups) continue;
        uint32_t packed[4] = {0u, 0u, 0u, 0u};
        if (gr < M) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            __nv_bfloat162 t = __floats2bfloat162_rn(
                (v[i][p][2 * e] - mu[i]) * rs[i] * ws[p][2 * e] + bs[p][2 * e],
                (v[i][p][2 * e + 1] - mu[i]) * rs[i] * ws[p][2 * e + 1] + bs[p][2 * e + 1]);
            packed[e] = *reinterpret_cast<uint32_t*>(&t);
          }
        }
        const int k = 8 * q;
        *reinterpret_cast<uint4*>(tile + (k >> 6) * rows * 128 + sw128_offset(r, k & 63)) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the
// runtime, so the library needs no link against libcuda.
inline EncodeTiled encoder() {
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
// strides in bytes of dims 1.. .  Out-of-range elements of a box read as zeros.
inline int encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
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

// The map of a row-major bf16 matrix (rows, cols), cols contiguous: boxes of
// 64 columns (one 128-byte swizzled row) x box_rows rows.
inline int encode_bf16_matrix(CUtensorMap* map, const void* base, int rows, int cols,
                              int box_rows) {
  if (rows < 1 || cols < 64 || cols % 8 || box_rows < 1 || box_rows > 256 ||
      (reinterpret_cast<uintptr_t>(base) & 15))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode_bf16(map, base, 2, dims, strides, box);
}

}  // namespace hopper

// The 128-byte tensor map (into `map`) of a bf16 weight (rows, cols), cols
// contiguous, as hopper::encode_bf16_matrix gives it: what ops/weights.py
// keeps beside the weight's bf16 copy.  Every library built on this header
// exports it.
extern "C" int bf16_matrix_map(const void* w, int rows, int cols, int box_rows, void* map) {
  CUtensorMap m;
  const int err = hopper::encode_bf16_matrix(&m, w, rows, cols, box_rows);
  if (err == 0) memcpy(map, &m, sizeof(m));
  return err;
}
