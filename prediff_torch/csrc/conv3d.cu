// SAME 3x3x3 stride-1 convolution + bias, channel-last f32:
//   out (B, T, H, W, N) = conv(x (B, T, H, W, K), w) + bias
// with bf16 operands (x and the weights rounded to bf16 as they are staged)
// and f32 accumulation; the bias is added in f32 and out is f32.  Its input
// gradient is the same launch on the cotangent with the flipped,
// channel-transposed weights (the wrapper lays them out), so one entry point
// serves both.
//
// Replaces prediff_tpu/ops/pallas_conv3d.py::fused_conv3x3x3 (body
// _conv_kernel) and the dx of its custom_vjp (fused_conv3x3x3_diff's
// _diff_bwd, the same kernel on the flipped weights).  The TPU kernel keeps
// the zero-padded input resident in VMEM, flattens it to rows and stages the
// 27 shifted row windows into an in-VMEM im2col block for one big-K GEMM.
// Here the conv is the implicit GEMM of conv3.cuh (also the whole-resblock
// kernels' conv): M = B*T*H*W tokens, N output channels, K = 27 x in
// channels, a block owning 32 tokens x 64 channels and gathering each tap's
// neighbour rows (zeros outside the volume) into shared memory, so neither
// the padded input nor an im2col matrix reaches device memory.
//
// Bound: 2 * 27 * K * N operations per token against ~4 (K + N) bytes per
// token and 27 * K * N * 4 bytes of weights; at the UNet's shapes (3328
// tokens x 256 -> 256, 832 x 512 -> 512) about 1,000 operations per byte,
// so the tensor cores bound it (~0.012 ms a call at 989 TFLOP/s bf16).  The
// WMMA tiles and the synchronous staging are far from that; what the design
// does is fill the card: the wrapper picks the fewest tap splits (1, 3 or 9)
// that give about two blocks per SM from the token and channel tiles.  Two
// launches a call (the conv, the epilogue that adds the splits and the bias
// in a fixed order).
#include "conv3.cuh"

// x (B, T, H, W, K) f32, w (27, K, N) f32 [tap][in][out], bias (N) f32 or
// null, part (splits, B*T*H*W, N) f32 workspace, out (B, T, H, W, N) f32.
extern "C" int conv3x3x3_forward(const float* x, const float* w, const float* bias,
                                 float* part, float* out, int B, int T, int H, int W, int K,
                                 int N, int splits, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || !conv_supported(B * T * H * W, K, N, splits))
    return (int)cudaErrorInvalidValue;
  return (int)conv<float, float>(x, w, bias, nullptr, part, out, B, T, H, W, K, N, splits,
                                 stream);
}
