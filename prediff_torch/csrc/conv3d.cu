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
//     channels (128 or 64 where N or a small volume asks for it: the widest
//     tile whose blocks fill half the SMs).  Each (tap,
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
// The bf16 form (conv3x3x3_forward_bf16: guidance on the alignment net's
// bf16 copy) reads a bf16 x as it is and writes acc + bias rounded to bf16.
// The kernel itself is in conv_wgmma.cuh, which the resblock (resblock.cu)
// shares with its bf16 and skip epilogues and a 64-channel output tile.
//
// Bound: 2 * 27 * K * N operations per token against ~4 (K + N) bytes per
// token and 27 * K * N * 2 bytes of weights; at the UNet's shapes (3328
// tokens x 256 -> 256, 832 x 512 -> 512) about 1,000 operations per byte,
// so the tensor cores bound it (~0.012 ms a call at 989 TFLOP/s bf16).
#include <cuda_runtime.h>
#include <string.h>

#include "conv_wgmma.cuh"

using namespace conv;

// The tensor map of a weight layout w (27, N, K) bf16, K contiguous: boxes of
// 64 in x the output-channel tile bn (64, 128 or 256) of one tap.  `map`
// receives the 128-byte CUtensorMap.
extern "C" int conv3x3x3_weight_map(const void* w, int N, int K, int bn, void* map) {
  if ((bn != 64 && bn != 128 && bn != 256) || N < bn || N % bn || K < kBK || K % kBK ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 27};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t box[3] = {kBK, (cuuint32_t)bn, 1};
  CUtensorMap m;
  const int err = hopper::encode_bf16(&m, w, 3, dims, strides, box);
  if (err == 0) memcpy(map, &m, sizeof(m));
  return err;
}

namespace {

bool conv_args_ok(const void* x, int B, int T, int H, int W, int K, int N, int bn, int bt,
                  int bh, int bw, int splits) {
  return !(B < 1 || T < 1 || H < 1 || W < 1 || K < kBK || K % kBK || N < 128 || N % 128 ||
           (bn != 64 && bn != 128 && bn != 256) || N % bn || bt < 1 || bh < 1 || bw < 1 ||
           bt * bh * bw != kBM || bt > 256 || bh > 256 || bw > 256 || splits < 1 ||
           splits > kMaxSplits || splits > 27 * (K / kBK) ||
           (reinterpret_cast<uintptr_t>(x) & 15) ||
           (long long)B * ((T + bt - 1) / bt) * ((H + bh - 1) / bh) * ((W + bw - 1) / bw) > 65535);
}

}  // namespace

// x (B, T, H, W, K) f32, xb (B, T, H, W, K) bf16 scratch, w_map the weights'
// map (conv3x3x3_weight_map, boxes of the output-channel tile bn), bias (N)
// f32 or null, out (B, T, H, W, N) f32; the token box (bt, bh, bw) of 128
// tokens, and the cluster's `splits` of the 27 * K / 64 slices
// (ops/conv3d.conv_plan).  Two launches: the bf16 rounding of x, the conv.
extern "C" int conv3x3x3_forward(const float* x, void* xb, const void* w_map, const float* bias,
                                 float* out, int B, int T, int H, int W, int K, int N, int bn,
                                 int bt, int bh, int bw, int splits, cudaStream_t stream) {
  if (!conv_args_ok(x, B, T, H, W, K, N, bn, bt, bh, bw, splits) ||
      (reinterpret_cast<uintptr_t>(xb) & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = to_bf16(x, xb, (size_t)B * T * H * W * K, stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap w;
  memcpy(&w, w_map, sizeof(w));
  return (int)conv::conv<kF32>(xb, w, bias, out, nullptr, B, T, H, W, K, N, bn, bt, bh, bw,
                               splits, stream);
}

// The bf16 form: x (B, T, H, W, K) bf16 is the conv's operand as it is (no
// cast launch), out (B, T, H, W, N) bf16 = acc + bias rounded once; the rest
// as conv3x3x3_forward.  One launch.
extern "C" int conv3x3x3_forward_bf16(const void* x, const void* w_map, const float* bias,
                                      void* out, int B, int T, int H, int W, int K, int N, int bn,
                                      int bt, int bh, int bw, int splits, cudaStream_t stream) {
  if (!conv_args_ok(x, B, T, H, W, K, N, bn, bt, bh, bw, splits))
    return (int)cudaErrorInvalidValue;
  CUtensorMap w;
  memcpy(&w, w_map, sizeof(w));
  return (int)conv::conv<kBf16>(x, w, bias, out, nullptr, B, T, H, W, K, N, bn, bt, bh, bw,
                                splits, stream);
}
