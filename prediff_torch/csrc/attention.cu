// Whole axial attention layer on the natural (B, T, H, W, C) layout, f32:
//   out = proj(softmax(q . scale . k^T + relbias[h]) . v) + b_proj,
//   [q k v] = LN(x) . Wqkv^T   (no qkv bias, no residual).
//
// Replaces prediff_tpu/ops/pallas_attention.py::fused_axial_attention_5d
// (body _fused_layer_kernel_v4, plan axial_attention_plan).  Three launches:
//   fwd_gemm_kernel (LN fused)  qkv = LN(x) . Wqkv^T, q scaled   (tokens, 3C) bf16
//   axial_core_kernel           one block per (cuboid, head)    (tokens, C)  bf16
//   fwd_gemm_kernel             out = attn . Wproj^T + b_proj    (tokens, C)  f32
// The TPU kernel packed G cuboids into one dense R x R product under a
// block-diagonal -inf mask to feed its 128 x 128 matrix unit; that trick is
// not copied.  A cuboid here is vol rows that lie at a fixed stride in the
// natural layout (axis T: H*W tokens, axis H: W tokens, axis W: 1 token), so
// no reorder copy is made; vol (13, 16 or 8 on the UNet) need not be a
// power of two and every loop masks its ragged edge.
//
// Bound: the two projections carry nearly all the operations (8 C^2 per
// token); the core is ~vol/C of that.  At the UNet's shapes the layer moves
// ~7 MB and does ~1.8 GFLOP: bytes and operations give about the same least
// time (~0.002 ms).  The projections run on TMA + wgmma (the block below),
// with the weights as bf16 copies kept per parameter version
// (ops/weights.py), 128 x 256 (QKV, where that fills about half the SMs or
// more) or 128 x 128 output tiles a block, and LN(x)'s row statistics once
// per row tile; q . scale, k, v and the head outputs go to device memory as
// bf16, the core's operands (half the bytes of f32, rounded where the TPU
// kernel rounds them).  The small core runs on CUDA cores.
// Operands are rounded to bf16 at the TPU kernel's points: LN output,
// weights, q . scale, k, v, p and the attention output.
//
// Input gradient (axial_attention_bwd_dx): replaces
// pallas_attention.py::fused_axial_attention_5d_bwd_dx (body
// _fused_layer_bwd_dx_kernel_v4), flash-style: nothing of the forward is
// saved, everything is recomputed from x.  Six launches, the products on the
// forward's TMA + wgmma pieces (fwd_gemm_kernel) with bf16 weight copies kept
// per parameter version (ops/weights.py: W_qkv, and the transposes of W_proj
// and W_qkv, so that every product reads a K-major B operand):
//   fwd_gemm_kernel (LN fused)  qkv = LN(x) . Wqkv^T: bf16 q . scale, k, v
//   cast_t_kernel               do = g in bf16                   (tokens, C)
//   fwd_gemm_kernel             dattn = do . Wproj, bf16          (tokens, C)
//   axial_core_bwd_kernel       one block per (cuboid, head): s, p again,
//                               ds = p (dp - rowsum(dp p)), dq dk dv, bf16
//   fwd_gemm_kernel             dln = dqkv . Wqkv, f32            (tokens, C)
//   ln_backward_kernel          dx = LayerNorm backward of dln, one warp per row
// The three products carry 14 C^2 operations per token against ~12 C bytes,
// so the gradient is bound by operations like the forward.  One block per
// cuboid, as in the forward core, so no cross-cuboid mask is needed.
// Rounding follows the TPU kernel: g, dattn, ds, p, q . scale, k, v, dqkv
// and the weights are bf16 operands; p, dp, ds and every sum stay f32.
//
// All gradients (axial_attention_bwd_full): replaces
// pallas_attention.py::fused_axial_attention_5d_bwd_full (body
// _fused_layer_bwd_full_kernel_v4, no dropout seed): dx as above and, from
// the same recomputed values, dgamma = sum dln . nhat, dbeta = sum dln,
// dWqkv = dqkv^T . LN(x), dbias[h, i, j] = sum over cuboids of ds,
// dWproj = g^T . attn, dbproj = sum g.  The TPU kernel adds each grid cell's
// share into outputs that stay resident across its sequential grid and
// folds ds back to within-cuboid pairs with rep^T . ds . rep; here blocks
// run in no order and a block already is one cuboid, so dbias is a plain
// sum of the f32 ds over blocks.  The dx launches above run with additions:
// the LN+QKV product also writes LN(x)^T in bf16, width-major (a row per
// channel, tokens contiguous), and do^T beside do; the core, in its Full
// form, walks a few cuboids per block, adds their ds into a shared-memory
// tile it writes once as its partial, and writes the forward's head outputs
// (attn, bf16) that dWproj needs.  dqkv and attn are laid out width-major
// too (cast_t_kernel), so the two weight gradients are the wgmma TN product
// of grad_common.cuh (wgrad_kernel: both operands K-major by TMA, the tokens
// split over a cluster added in rank order); the vector gradients are column
// sums per 8-row block; sum_partials_kernel adds every set of partials in
// a fixed order.  No atomics: two runs give the same bits.  22 C^2
// operations per token in the five products against ~12 C f32 bytes per
// token plus 32 C^2 for the weights and their gradients: bound by operations
// at the UNet's training shapes.  The core stays on the CUDA cores over f32
// tiles of its bf16 inputs.
//
// Dropout (axial_attention_dropout_forward, axial_attention_dropout_bwd_full):
// replaces the seed= forms of fused_axial_attention_5d and
// fused_axial_attention_5d_bwd_full (the rate_attn / rate_proj branches of
// _fused_layer_kernel_v4 and _fused_layer_bwd_full_kernel_v4), the training
// path of the v1 recipe: p . m_a / (1 - r_attn) after the softmax and before
// p . v, and (attn . Wproj^T + b) . m_p / (1 - r_proj) on the output.  The TPU
// kernels draw an (R, R) mask per head and an (R, C) mask per grid cell from a
// per-core generator, cross-cuboid entries included, in one order over one
// grid forward and backward.  Here the forward core runs one cuboid per block
// and the backward core a few, so a mask is a function of the logical element
// instead (philox.cuh): m_a of (cuboid in the order of cuboid_rows, head, i, j),
// in-cuboid entries only, and m_p of the natural (token, channel).  The
// backward regenerates both: do = g . m_p / (1 - r_proj) is cast to bf16 for
// the dattn product and dWproj (4 channels a thread: one whole Philox block;
// dbproj sums the f32 do);
// dp = (dattn . v^T) . m_a / (1 - r_attn); the softmax backward uses the
// undropped p, while dv and the re-emitted head outputs use the dropped p.
// The Drop forms are separate template instances, so the kernels without
// dropout are untouched; with both rates 0 they give the same bits.
//
// General cuboids (cuboid_attention_forward, cuboid_attention_bwd_dx): replace
// pallas_attention.py::fused_cuboid_attention_layer_v4 and
// fused_cuboid_attention_layer_v4_bwd_dx (the same kernel bodies) for any
// unshifted, unpadded cuboid of vol <= 256 rows: a 3-D box with an 'l' or 'd'
// strategy per axis.  The caller reorders first (cuboid_reorder), so cuboid c
// is rows c * vol .. c * vol + vol - 1 in cuboid_reorder's order, which is the
// order the relative-position bias indexes.  The forward's launches are the
// axial layer's products (the QKV product is over rows, so their order does
// not matter to it) around a core of its own on the tensor cores
// (cuboid_tc_core_kernel: mma.sync m16n8k16 in bf16, k and v of the whole
// cuboid in shared memory, p in registers, one block per (cuboid, head, 16 to
// 64 query rows)); past the LN tile (C > 768) the QKV product runs on bf16 LN
// rows written by ln_bf16_rows_kernel.  The input gradient is the axial
// layer's dx launches (layer_bwd_launches) around a gradient core of its own
// on the tensor cores (below).  At the UNet's shapes the bytes the layer must
// move (x in and out, the weights) and its operations give about the same
// least time, as for the axial layer; the roundings are the axial kernels'.
// Their bf16 forms (cuboid_attention_forward_bf16, cuboid_attention_bwd_dx_bf16,
// a forecast on bf16 parameters) are the same launches with x, g, out and dx in
// bf16: the LN rows widened as read, the output rounded once as written; the
// kernels already round q . scale, k, v and the head outputs to bf16 between
// launches, so only the input and output bytes change.
//
// The general layer's all gradients (cuboid_attention_bwd_full) and its
// dropout forms (cuboid_attention_dropout_forward,
// cuboid_attention_dropout_bwd_full): replace
// pallas_attention.py::fused_cuboid_attention_layer_v4_bwd_full and the seed=
// forms of it and of fused_cuboid_attention_layer_v4 (bodies
// _fused_layer_bwd_full_kernel_v4 and _fused_layer_kernel_v4), the training
// path of every non-axial pattern.  The launches are the axial all-gradients
// ones (LN + QKV and the dattn / dln products on TMA + wgmma with the cached
// bf16 weights and their transposes, the width-major casts, the weight
// gradients on grad_common.cuh's TN product); the gradient core runs on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32, ldmatrix fragments, as the
// forward's core).  Where a cuboid's q . scale, k, v, dattn and its bf16 ds
// and dropped p fit one block (vol <= 64: the UNet's windows),
// cuboid_bwd_core_kernel takes a whole (cuboid, head) per block: each warp
// has 16 query rows of s, p, dp, D = rowsum(dp . p) (the TPU kernel's
// formula; D = dO . O holds under dropout too), ds = p (dp - D), dq and the
// head outputs in registers, hands its bf16 ds and dropped p to the block in
// shared memory, then takes 16 keys of dk = ds^T . q and dv = p_d^T . dO: one
// launch, no atomics, and the relative-bias gradient's f32 ds added into the
// block's partial by the thread that owns each element.  Larger cuboids (to
// vol 256) split in two launches on the same fragments: a query-row launch
// (dq, the head outputs, ds into a per-cuboid partial, and each row's max, sum
// and D) with k and v whole in shared memory, and a key-row launch that
// recomputes p and ds transposed from those statistics (dk, dv) with q and
// dattn whole in shared memory; the other operand's fragments come from
// device memory.  The TPU kernel folds its block-diagonal ds back with
// rep^T . ds . rep; here ds is already per cuboid.  Dropout: m_a of (cuboid,
// head, i, j) in cuboid_reorder's order and m_p of the reordered (token,
// channel), the layouts flax's einsum route drops, drawn as the forward draws
// them; the Drop forms are separate template instances, bit-equal to the
// kernels without dropout at rate 0.
//
// Grouped masked core (cuboid_attention_grouped): replaces
// pallas_attention.py::fused_cuboid_attention_grouped, the core of every
// shifted or padded window: out = masked_softmax(q . scale . k^T + bias[h]) . v
// in f32, with q, k, v, out (B, heads, cuboids, vol, hc) and the mask
// (cuboids, vol, vol) as bytes, shared over batch and heads.  A masked score
// is -1e18 after the bias; the normaliser sums over every key and p is
// multiplied by the mask before p . v, so a fully masked row gives 0.  vol is
// any size ("full" gives 3328).  Both products run on the tensor cores in
// 3xTF32: each f32 operand is split a = tf32(a) + tf32(a - tf32(a)) and
// mma.sync m16n8k8 adds small.big + big.small + big.big in f32, which keeps
// ~f32 accuracy (one TF32 pass keeps ~3 decimal digits, short of the core's
// 1e-5 of the output's max).  The tensor cores' f32 sums lose more than
// IEEE adds do (summed over all 3328 keys of the "full" pattern in one
// accumulator, the output was off by 2.5e-5 of its max on the H100), so
// p . v sums one key tile at a time and the tiles are added in f32 on the
// CUDA cores.  One block per (cuboid, batch and head, 64
// query rows x up to 64 output channels): 4 warps of 16 query rows, an
// online softmax over key tiles of 64 with the scores, p and the running
// max and sum in registers.  The score accumulator of m16n8 gives a thread
// keys 2c and 2c + 1 of each 8, where the A operand of m16n8k8 wants keys c
// and c + 4: p . v reads v's rows in that order instead (the sum over keys
// does not care), so p never leaves the registers.  q, k, v come in by
// 16-byte cp.async through the layout's strides, 64 channels at a time
// (zeros past hc and vol); bias and mask are read once per block.  Per row
// it moves q, k, v and out (16 hc bytes) against 4 vol hc operations: bound
// by bytes up to vol ~80 at f32 rates (the UNet's 64), by operations above.
// Its bf16 form (cuboid_attention_grouped_bf16) reads q, k, v in bf16, widened
// into the same f32 tiles, and rounds out once: k and v are exact in TF32, so
// the passes on their small parts (zero) are left out and each product takes
// two TF32 passes, q . scale and p still split; the f32 form's sums on the
// widened inputs, bit for bit, whatever the scale.
//
// Round-1 per-cuboid core (cuboid_core_forward): replaces
// pallas_attention.py::fused_cuboid_attention (bodies _attn_kernel_nomask and
// _attn_kernel_masked), the same function as the grouped core on the
// cuboid-major (B, cuboids, heads, vol, hc) layout.  It is grouped_core_kernel
// itself, which reads every layout through element strides, so no permute is
// made; one launch.  And the round-1 whole layer, "v3"
// (cuboid_layer_v3_forward): replaces pallas_attention.py::
// fused_cuboid_attention_layer (body _fused_layer_kernel), LN + QKV + per-head
// core (no mask) + out-proj on reordered cuboids (B, cuboids, vol, C), all f32
// as the TPU kernel computes it, in four launches:
//   ln_stats_kernel          each row's mean and 1/sqrt(var + eps)      (tokens, 2)
//   tf32_gemm_kernel<true>   qkv = LN(x) . Wqkv^T, LN in the A tiles    (tokens, 3C)
//   grouped_core_kernel      per (cuboid, head), q k v read in place    (tokens, C)
//   tf32_gemm_kernel<false>  out = o . Wproj^T + b_proj                  (tokens, C)
// The two products carry 8 C^2 of the 8 C^2 + 4 vol C operations per token:
// in f32 on the CUDA cores (67 TFLOP/s) they would bound the layer, so they
// run on the tensor cores in 3xTF32 as the core does (three TF32 products at
// 495 TFLOP/s: ~2.5x the f32 rate's bound), double-buffered cp.async tiles
// of 64 x 64 outputs a block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "grad_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// One block per (cuboid, head).  qkv (tokens, 3C) with q | k | v blocks of C;
// bias (heads, vol, vol); attn (tokens, C) gets this head's hc columns.
constexpr int kCoreThreads = 128;

// Token of row i of cuboid `cub` along `axis`: base + i * stride.
__device__ __forceinline__ void cuboid_rows(int cub, int T, int H, int W, int axis, size_t& base,
                                            int& stride) {
  if (axis == 0) {
    const int b = cub / (H * W);
    base = (size_t)b * T * H * W + cub % (H * W);
    stride = H * W;
  } else if (axis == 1) {
    const int b = cub / (T * W), r = cub % (T * W);
    base = ((size_t)b * T + r / W) * H * W + r % W;
    stride = W;
  } else {
    base = (size_t)cub * W;
    stride = 1;
  }
}

// s = q . k^T + bias[h] into s[vol][vol], then softmax by rows in place (f32).
__device__ __forceinline__ void scores_softmax(const float* q, const float* k,
                                               const float* __restrict__ bh, float* s, int vol,
                                               int hc, int ld) {
  const int tid = threadIdx.x;
  for (int i = tid; i < vol * vol; i += kCoreThreads) {
    const int r = i / vol, j = i % vol;
    float acc = 0.f;
    for (int c = 0; c < hc; ++c) acc += q[r * ld + c] * k[j * ld + c];
    s[i] = acc + bh[i];
  }
  __syncthreads();
  for (int r = tid; r < vol; r += kCoreThreads) {
    float* sr = s + r * vol;
    float m = -INFINITY;
    for (int j = 0; j < vol; ++j) m = fmaxf(m, sr[j]);
    float sum = 0.f;
    for (int j = 0; j < vol; ++j) {
      sr[j] = expf(sr[j] - m);
      sum += sr[j];
    }
    for (int j = 0; j < vol; ++j) sr[j] /= sum;
  }
  __syncthreads();
}

// The forward's core: q . scale, k, v from qkv (tokens, 3C) bf16, the head
// outputs into attn (tokens, C) bf16.  Drop: p goes through the dropout d of
// element (cuboid, head, i, j) before p . v.
template <bool Drop>
__global__ void __launch_bounds__(kCoreThreads)
axial_core_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ attn, int T, int H, int W, int C, int axis,
                  int heads, philox::Drop d) {
  philox::load_key(d);
  extern __shared__ float sm[];
  const int hc = C / heads;
  const int ld = hc + 1;  // odd stride: rows fall in different banks
  const int vol = axis == 0 ? T : (axis == 1 ? H : W);
  float* q = sm;
  float* k = q + vol * ld;
  float* v = k + vol * ld;
  float* s = v + vol * ld;  // [vol][vol]
  const int cub = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  size_t base;
  int stride;
  cuboid_rows(cub, T, H, W, axis, base, stride);

  // 8 channels (16 bytes) of q, k and v a thread at a time, all in flight together
  const int g8 = hc % 8 == 0 ? hc / 8 : 0;
  for (int i = tid; i < vol * g8; i += kCoreThreads) {
    const int r = i / g8, c = 8 * (i % g8);
    const __nv_bfloat16* row = qkv + (base + (size_t)r * stride) * 3 * C + h * hc + c;
    const uint4 raw[3] = {*reinterpret_cast<const uint4*>(row),
                          *reinterpret_cast<const uint4*>(row + C),
                          *reinterpret_cast<const uint4*>(row + 2 * C)};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw[t]);
      float* dst = (t == 0 ? q : t == 1 ? k : v) + r * ld + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pair[e]);
        dst[2 * e] = f.x;
        dst[2 * e + 1] = f.y;
      }
    }
  }
  for (int i = tid; g8 == 0 && i < vol * hc; i += kCoreThreads) {
    const int r = i / hc, c = i % hc;
    const __nv_bfloat16* row = qkv + (base + (size_t)r * stride) * 3 * C + h * hc + c;
    q[r * ld + c] = __bfloat162float(row[0]);
    k[r * ld + c] = __bfloat162float(row[C]);
    v[r * ld + c] = __bfloat162float(row[2 * C]);
  }
  __syncthreads();
  scores_softmax(q, k, bias + (size_t)h * vol * vol, s, vol, hc, ld);
  if (Drop) {
    const unsigned long long e0 = ((unsigned long long)cub * heads + h) * vol * vol;
    for (int i = tid; i < vol * vol; i += kCoreThreads) s[i] = philox::apply(d, e0 + i, s[i]);
    __syncthreads();
  }
  for (int i = tid; i < vol * hc; i += kCoreThreads) {
    const int r = i / hc, c = i % hc;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < vol; ++j) acc += bf16_round(s[r * vol + j]) * v[j * ld + c];
    attn[(base + (size_t)r * stride) * C + h * hc + c] = __float2bfloat16(acc);
  }
}

// Gradient of the core, one block per (cuboids_per_block cuboids, head).  qkv
// (tokens, 3C: q . scale | k | v) and dattn (tokens, C) in, bf16; dqkv
// (tokens, 3C) out, bf16: dq | dk | dv blocks of C.  Full: also attn (tokens, C) bf16, the forward's head outputs,
// and dbias_part[blockIdx.x, h] = the f32 ds summed over this block's cuboids.
// Drop: dp and the p that feeds dv and attn go through the dropout `drop` of element
// (cuboid, head, i, j); ds = p (dp - rowsum(dp p)) keeps the undropped p.
template <bool Full, bool Drop>
__global__ void __launch_bounds__(kCoreThreads)
axial_core_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                      const __nv_bfloat16* __restrict__ dattn, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ dqkv, __nv_bfloat16* __restrict__ attn,
                      float* __restrict__ dbias_part, int T,
                      int H, int W, int C, int axis, int heads, float scale, int n_cuboids,
                      int cuboids_per_block, philox::Drop drop) {
  philox::load_key(drop);
  extern __shared__ float sm[];
  const int hc = C / heads;
  const int ld = hc + 1;
  const int vol = axis == 0 ? T : (axis == 1 ? H : W);
  float* q = sm;             // bf16(q . scale)
  float* k = q + vol * ld;   // bf16(k)
  float* v = k + vol * ld;   // bf16(v)
  float* dO = v + vol * ld;  // bf16(dattn)
  float* p = dO + vol * ld;  // [vol][vol] softmax
  float* ds = p + vol * vol; // [vol][vol] dp, then bf16(ds)
  float* dbacc = ds + vol * vol;  // [vol][vol] Full: sum of the f32 ds
  const int h = blockIdx.y, tid = threadIdx.x;
  if (Full)
    for (int i = tid; i < vol * vol; i += kCoreThreads) dbacc[i] = 0.f;

  for (int ci = 0; ci < cuboids_per_block; ++ci) {
    const int cub = blockIdx.x * cuboids_per_block + ci;
    if (cub >= n_cuboids) break;
    __syncthreads();  // the previous cuboid's tiles are read no more
    size_t base;
    int stride;
    cuboid_rows(cub, T, H, W, axis, base, stride);

    for (int i = tid; i < vol * hc; i += kCoreThreads) {
      const int r = i / hc, c = i % hc;
      const size_t tok = base + (size_t)r * stride;
      const __nv_bfloat16* row = qkv + tok * 3 * C + h * hc + c;   // q . scale | k | v
      q[r * ld + c] = __bfloat162float(row[0]);
      k[r * ld + c] = __bfloat162float(row[C]);
      v[r * ld + c] = __bfloat162float(row[2 * C]);
      dO[r * ld + c] = __bfloat162float(dattn[tok * C + h * hc + c]);
    }
    __syncthreads();
    scores_softmax(q, k, bias + (size_t)h * vol * vol, p, vol, hc, ld);
    const unsigned long long e0 = ((unsigned long long)cub * heads + h) * vol * vol;
    for (int i = tid; i < vol * vol; i += kCoreThreads) {  // dp = dO . v^T
      const int r = i / vol, j = i % vol;
      float acc = 0.f;
      for (int c = 0; c < hc; ++c) acc += dO[r * ld + c] * v[j * ld + c];
      ds[i] = Drop ? philox::apply(drop, e0 + i, acc) : acc;
    }
    __syncthreads();
    for (int r = tid; r < vol; r += kCoreThreads) {  // ds = p (dp - rowsum(dp p))
      float dot = 0.f;
      for (int j = 0; j < vol; ++j) dot += ds[r * vol + j] * p[r * vol + j];
      for (int j = 0; j < vol; ++j) {
        const float d = p[r * vol + j] * (ds[r * vol + j] - dot);
        if (Full) dbacc[r * vol + j] += d;  // row r is this thread's alone
        ds[r * vol + j] = bf16_round(d);
      }
    }
    __syncthreads();
    for (int i = tid; i < vol * vol; i += kCoreThreads)
      p[i] = bf16_round(Drop ? philox::apply(drop, e0 + i, p[i]) : p[i]);
    __syncthreads();
    for (int i = tid; i < vol * hc; i += kCoreThreads) {
      const int r = i / hc, c = i % hc;  // r: query row for dq, key row for dk / dv
      float aq = 0.f, ak = 0.f, av = 0.f, ao = 0.f;
      for (int j = 0; j < vol; ++j) {
        aq += ds[r * vol + j] * k[j * ld + c];
        ak += ds[j * vol + r] * q[j * ld + c];
        av += p[j * vol + r] * dO[j * ld + c];
        if (Full) ao += p[r * vol + j] * v[j * ld + c];
      }
      const size_t tok = base + (size_t)r * stride;
      __nv_bfloat16* out = dqkv + tok * 3 * C + h * hc + c;   // the bf16 operands of dln and dWqkv
      out[0] = __float2bfloat16(aq * scale);
      out[C] = __float2bfloat16(ak);
      out[2 * C] = __float2bfloat16(av);
      if (Full) attn[tok * C + h * hc + c] = __float2bfloat16(ao);
    }
  }
  if (Full) {
    __syncthreads();
    float* dst = dbias_part + ((size_t)blockIdx.x * heads + h) * vol * vol;
    for (int i = tid; i < vol * vol; i += kCoreThreads) dst[i] = dbacc[i];
  }
}

// dx = LayerNorm backward of dln for the rows of x, one warp per row:
//   dnhat = dln * ln_w,  dx = rs * (dnhat - mean(dnhat) - nhat * mean(dnhat * nhat)).
// x and dx f32, or bf16 (the bf16 form: widened as read, rounded as written).
template <typename T>
__global__ void ln_backward_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
                                   const float* __restrict__ dln, T* __restrict__ dx, int M,
                                   int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  const float* dr = dln + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    float d = to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(warp_sum(v) / C + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dnhat = dr[c] * ln_w[c];
    s1 += dnhat;
    s2 += dnhat * (to_f(xr[c]) - mu) * rs;
  }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
  for (int c = lane; c < C; c += 32)
    store(dx + (size_t)row * C + c,
          rs * (dr[c] * ln_w[c] - m1 - (to_f(xr[c]) - mu) * rs * m2));
}

template <typename T>
cudaError_t ln_backward(const T* x, const float* ln_w, const float* dln, T* dx, int M, int C,
                        float eps, cudaStream_t stream) {
  constexpr int kRowsPerBlock = 8;  // one warp per row
  ln_backward_kernel<T><<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                          stream>>>(x, ln_w, dln, dx, M, C, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The forwards' two products on TMA + wgmma (the axial layer's and the
// general cuboid layer's): out[M, N] = A . W^T with
// W (N, K) the bf16 copy of a weight (ops/weights.py), read by TMA in 64-deep
// slices of BN rows through a ring of up to kMaxStages stages kept full by a
// producer warp; two consumer warpgroups of 64 rows run wgmma m64nBNk16, one
// slice's group in flight.  A block owns 128 rows x BN columns.
//   LnA (the QKV product): A = LN(x), computed once per row tile from the f32
//     x and kept whole (K / 64 swizzled tiles) in shared memory.
//   otherwise: A = a bf16 matrix read by TMA beside W (the head outputs for
//     the output projection; bf16 LN rows for a QKV product wider than the
//     LN tile).
//   QkvOut (by default with LnA): the epilogue writes bf16 (M, N): q . q_scale
//     for the first q_cols columns, k and v as they are (the core's operands,
//     rounded where the TPU kernel rounds).  Otherwise it adds the bias
//     (Drop: the dropout of element (row, column)) and writes f32.
// Rows past M read zeros (the LN tile, the TMA unit) and columns past N
// zeros (the TMA unit); the epilogue masks both.
namespace fwd {

using namespace hopper;

constexpr int kBM = 128, kMaxStages = 4, kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kATile = kBM * 128;        // a 64-deep slice of the 128 rows: 16 KB
constexpr int kSmemCap = 232448 - 128;   // dynamic shared memory a block may take

template <int BN, bool LnA>
__host__ __device__ constexpr int stage_bytes() {
  return (LnA ? 0 : kATile) + BN * 128;
}

// The ring's depth for K: as deep as kMaxStages allows beside the LN tile, at
// least 2 (0: does not fit).
template <int BN, bool LnA>
int stages_for(int K) {
  const int free_bytes = kSmemCap - 1024 - (LnA ? kBM * K * 2 : 0);
  const int s = free_bytes / stage_bytes<BN, LnA>();
  return s < 2 ? 0 : (s < kMaxStages ? s : kMaxStages);
}

// LnPer > 0: A = LN(x) (the QKV product), a lane's LN columns in groups of
// 256 (K <= 256 LnPer); 0: A by TMA.
// XT: x's type with LnA (f32, or bf16 in the bf16 form); OT: the output's
// type without QkvOut (f32, or bf16: the bf16 form's projection).
template <int BN, int LnPer, bool Drop, bool QkvOut, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
fwd_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap w_map, const XT* __restrict__ x,
                const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                const float* __restrict__ bias, void* __restrict__ out, int M, int N, int K,
                int stages, int q_cols, float q_scale, float eps, philox::Drop drop,
                __nv_bfloat16* __restrict__ ln_t, int ld) {
  philox::load_key(drop);
  constexpr bool LnA = LnPer > 0;
  constexpr int kStage = stage_bytes<BN, LnA>(), kAcc = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_s = (raw + 1023) & ~1023u;   // 1024-byte aligned for the 128-byte swizzle
  const uint32_t ring = a_s + (LnA ? kBM * K * 2 : 0);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int slices = K / 64;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {   // producer
      for (int ks = 0; ks < slices; ++ks) {
        const int s = ks % stages;
        mbar_wait(smem_u32(&empty[s]), ((ks / stages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]), dst = ring + s * kStage;
        mbar_expect_tx(bar, kStage);
        if (!LnA) tma_load_2d(dst, &a_map, bar, ks * 64, m0);
        tma_load_2d(dst + (LnA ? 0 : kATile), &w_map, bar, ks * 64, n0);
      }
    }
    return;
  }
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid & 31;
  if (LnA) {
    ln_rows_sw128<LnA ? LnPer : 1, LnA ? 8 / LnPer : 1>(
        x, ln_w, ln_b, smem_raw + (a_s - raw), kBM, m0, M, K, eps, tid / 32, kConsumers / 32);
    fence_async_smem();
    named_barrier(1, kConsumers);
    if (ln_t != nullptr && blockIdx.x == 0) {
      // LN(x)^T (K, ld) bf16 for a weight gradient: 8 rows of one channel a
      // thread, gathered from the swizzled tile (rows past M are zeros)
      const uint8_t* tile = smem_raw + (a_s - raw);
      for (int i = tid; i < K * (kBM / 8); i += kConsumers) {
        const int k = i / (kBM / 8), r8 = (i % (kBM / 8)) * 8;
        if (m0 + r8 >= ld) continue;
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 pr;
          pr.x = *reinterpret_cast<const __nv_bfloat16*>(
              tile + (k >> 6) * kATile + sw128_offset(r8 + 2 * e, k & 63));
          pr.y = *reinterpret_cast<const __nv_bfloat16*>(
              tile + (k >> 6) * kATile + sw128_offset(r8 + 2 * e + 1, k & 63));
          packed[e] = *reinterpret_cast<uint32_t*>(&pr);
        }
        *reinterpret_cast<uint4*>(ln_t + (size_t)k * ld + m0 + r8) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  // the projection's bias now: its loads are in flight while the product runs
  float bias_v[QkvOut ? 1 : BN / 8][2];
#pragma unroll
  for (int jb = 0; jb < (QkvOut ? 0 : BN / 8); ++jb) {
    const int n = n0 + 8 * jb + 2 * (lane & 3);
    const float2 b = bias != nullptr && n < N ? *reinterpret_cast<const float2*>(bias + n)
                                              : make_float2(0.f, 0.f);
    bias_v[jb][0] = b.x;
    bias_v[jb][1] = b.y;
  }
  for (int ks = 0; ks < slices; ++ks) {
    const int s = ks % stages;
    mbar_wait(smem_u32(&full[s]), (ks / stages) & 1);
    const uint32_t st = ring + s * kStage;
    const uint64_t da = sw128_desc((LnA ? a_s + ks * kATile : st) + wg * 64 * 128);
    const uint64_t db = sw128_desc(st + (LnA ? 0 : kATile));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_k16(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    if (ks > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(ks - 1) % stages]));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: rows r0 and r0 + 8 of the warpgroup's 64, columns 8 jb + 2 (lane % 4) (+1)
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int n = n0 + 8 * jb + 2 * (lane & 3);
    if (n >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= M) continue;
      const size_t o = (size_t)row * N + n;
      float v0 = acc[4 * jb + 2 * half], v1 = acc[4 * jb + 2 * half + 1];
      if (QkvOut) {
        if (n < q_cols) {
          v0 *= q_scale;
          v1 *= q_scale;
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        v0 += bias_v[QkvOut ? 0 : jb][0];
        v1 += bias_v[QkvOut ? 0 : jb][1];
        if (Drop) philox::apply2(drop, o, v0, v1);
        store2(static_cast<OT*>(out) + o, v0, v1);
      }
    }
  }
}

template <typename T>
struct Named {   // a parameter type that is not deduced: given, or defaulted
  using type = T;
};

template <int BN, int LnPer, bool Drop, bool QkvOut = (LnPer > 0), typename XT = float,
          typename OT = float>
cudaError_t gemm(const CUtensorMap& a, const CUtensorMap& w, const typename Named<XT>::type* x,
                 const float* ln_w, const float* ln_b, const float* bias, void* out, int M, int N, int K, int q_cols,
                 float q_scale, float eps, philox::Drop drop, cudaStream_t stream,
                 __nv_bfloat16* ln_t = nullptr, int ld = 0) {
  constexpr bool LnA = LnPer > 0;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(fwd_gemm_kernel<BN, LnPer, Drop, QkvOut, XT, OT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int stages = stages_for<BN, LnA>(K);
  if (stages == 0 || K % 64 || K < 64 || (LnA && K > 256 * LnPer) || M < 1 || N < 2 || N % 2)
    return cudaErrorInvalidValue;
  const int smem = 1024 + (LnA ? kBM * K * 2 : 0) + stages * stage_bytes<BN, LnA>();
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (ln_t != nullptr && (!LnA || ld % 8 || ld < M)) return cudaErrorInvalidValue;
  fwd_gemm_kernel<BN, LnPer, Drop, QkvOut, XT, OT><<<grid, kThreads, smem, stream>>>(
      a, w, x, ln_w, ln_b, bias, out, M, N, K, stages, q_cols, q_scale, eps, drop, ln_t, ld);
  return cudaGetLastError();
}

// The QKV product: the instance for its column tile and width (x f32 or bf16).
template <typename XT>
cudaError_t qkv_gemm(int bn, const CUtensorMap& w, const XT* x, const float* ln_w,
                     const float* ln_b, __nv_bfloat16* qkv, int M, int C, float scale, float eps,
                     cudaStream_t stream, __nv_bfloat16* ln_t = nullptr, int ld = 0) {
  const int per = (C + 255) / 256;
  const philox::Drop none{};
  if (bn == 256 && per == 1)
    return gemm<256, 1, false, true, XT>(w, w, x, ln_w, ln_b, nullptr, qkv, M, 3 * C, C, C, scale, eps, none,
                               stream, ln_t, ld);
  if (bn == 256 && per == 2)
    return gemm<256, 2, false, true, XT>(w, w, x, ln_w, ln_b, nullptr, qkv, M, 3 * C, C, C, scale, eps, none,
                               stream, ln_t, ld);
  if (bn == 128 && per == 1)
    return gemm<128, 1, false, true, XT>(w, w, x, ln_w, ln_b, nullptr, qkv, M, 3 * C, C, C, scale, eps, none,
                               stream, ln_t, ld);
  if (bn == 128 && per == 2)
    return gemm<128, 2, false, true, XT>(w, w, x, ln_w, ln_b, nullptr, qkv, M, 3 * C, C, C, scale, eps, none,
                               stream, ln_t, ld);
  if (bn == 128 && per == 3)   // C <= 768: the widest LN tile beside a 2-stage ring
    return gemm<128, 3, false, true, XT>(w, w, x, ln_w, ln_b, nullptr, qkv, M, 3 * C, C, C, scale, eps, none,
                               stream, ln_t, ld);
  return cudaErrorInvalidValue;
}

}  // namespace fwd

// The three launches of the forward; Drop adds the two dropouts.  qkv (tokens,
// 3C) and attn (tokens, C) bf16 scratch; bn_qkv the QKV product's column tile.
template <bool Drop, typename XT>
cudaError_t forward_launches(const XT* x, const float* ln_w, const float* ln_b,
                             const void* wqkv_map, const float* bias, const void* wproj_map,
                             const float* b_proj, __nv_bfloat16* qkv, __nv_bfloat16* attn,
                             XT* out, int B, int T, int H, int W, int C, int axis, int heads,
                             int bn_qkv, float scale, float eps, cudaStream_t stream,
                             philox::Drop d_attn = philox::Drop{},
                             philox::Drop d_proj = philox::Drop{}) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (C % 64 != 0 || C % heads != 0 || axis < 0 || axis > 2 || (bn_qkv != 128 && bn_qkv != 256) ||
      !aligned(x) || !aligned(ln_w) || !aligned(ln_b) || !aligned(qkv) || !aligned(attn) ||
      !aligned(b_proj) || (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(XT) - 1)))
    return cudaErrorInvalidValue;
  const int M = B * T * H * W;
  CUtensorMap wqkv, wproj, attn_map;
  memcpy(&wqkv, wqkv_map, sizeof(wqkv));
  memcpy(&wproj, wproj_map, sizeof(wproj));
  cudaError_t err = fwd::qkv_gemm(bn_qkv, wqkv, x, ln_w, ln_b, qkv, M, C, scale, eps, stream);
  if (err != cudaSuccess) return err;
  const int vol = axis == 0 ? T : (axis == 1 ? H : W);
  const int hc = C / heads;
  const size_t smem = sizeof(float) * (3 * vol * (hc + 1) + vol * vol);
  static bool configured = false;   // once, at the most a block may take: no host call per launch
  if (!configured) {
    err = cudaFuncSetAttribute(axial_core_kernel<Drop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fwd::kSmemCap);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (smem > (size_t)fwd::kSmemCap) return cudaErrorInvalidValue;
  axial_core_kernel<Drop><<<dim3(M / vol, heads), kCoreThreads, smem, stream>>>(
      qkv, bias, attn, T, H, W, C, axis, heads, d_attn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int enc = hopper::encode_bf16_matrix(&attn_map, attn, M, C, fwd::kBM);
  if (enc != 0) return (cudaError_t)enc;
  return fwd::gemm<128, 0, Drop, false, float, XT>(attn_map, wproj, nullptr, nullptr, nullptr,
                                                  b_proj, out, M, C, C, 0, 1.f, eps, d_proj,
                                                  stream);
}

// ---------------------------------------------------------------------------
// The general layer's forward core on the tensor cores: mma.sync m16n8k16,
// bf16 operands, f32 sums.  One block per (cuboid, head, 16 x warps query
// rows); k and v of the whole cuboid and the block's q . scale rows come from
// the bf16 (tokens, 3C) product by 16-byte cp.async into shared memory (k and
// q first, v while the scores run), rows of hcp (hc rounded up to 16)
// channels at a stride of hcp + 8 (an odd number of 16-byte groups: every
// ldmatrix below is free of bank conflicts), zeros past vol and past hc.  A
// warp owns 16 query rows:
//   scores  s = q . k^T over 64-key tiles, a warp's 16 x 64 tile in
//           registers (the accumulator layout: rows g and g + 8, keys
//           8 j + 2 c4 (+1)), + the f32 bias, keys past vol at -inf;
//   softmax the row max over every tile, then the sum of exp(s - max), then
//           per tile p = exp(s - max) / sum, through the dropout (Drop) and
//           rounded to bf16: the TPU kernel's rounding points, p normalised
//           before it is rounded and multiplied by v.  One tile holds a row
//           up to vol 64; past it the scores are recomputed in each pass;
//   p . v   p's accumulator pairs are the A fragments of m16n8k16 as they
//           stand (keys 2 c4, 2 c4 + 1 of each 8), so p never leaves the
//           registers; v's B fragments come by ldmatrix.trans; 64 output
//           channels at a time, written as bf16.
// KT: 64-key tiles held for p (vol <= 64 KT).
constexpr int kTcKeys = 64;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 into one register, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&t);
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8 i .. 8 i + 7 giving
// the row addresses of matrix i: with Trans each thread holds (rows
// 2 (lane % 4) and + 1, column lane / 4) of each, else (row lane / 4,
// columns 2 (lane % 4) and + 1): the fragments of mma.sync m16n8k16.
template <bool Trans>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if (Trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// Rows r0 .. r0 + rows - 1 of one head's hc columns of a bf16 matrix of row
// stride `stride` (src at the head's first column: of q, k or v in the
// (tokens, 3C) product, of dattn (tokens, C)) into dst (stride ld), hcp
// columns a row; zeros at rows >= valid and columns >= hc.
__device__ __forceinline__ void tc_load_rows(__nv_bfloat16* dst, int ld,
                                             const __nv_bfloat16* __restrict__ src, size_t r0,
                                             int valid, int rows, int stride, int hc, int hcp) {
  const int chunks = hcp / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = 8 * (i % chunks);
    __nv_bfloat16* d = dst + r * ld + c;
    const __nv_bfloat16* s = src + (r0 + r) * stride + c;
    if (r < valid && c + 8 <= hc && hc % 8 == 0) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(d))),
                   "l"(s)
                   : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = (r < valid && c + e < hc) ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// acc = A . B^T over `depth` channels (a multiple of 16): A the warp's 16
// rows, each 16-channel step's fragment from load_a(kc, a); B 64 rows of
// shared memory at b (stride ldb) by ldmatrix; 16-row pairs of B at or past
// nb are skipped (zeros there, and their sums are not read).
template <typename LoadA>
__device__ __forceinline__ void tc_nt(float (&acc)[8][4], LoadA load_a, const __nv_bfloat16* b,
                                      int ldb, int depth, int nb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const __nv_bfloat16* brow = b + ((lane & 7) + 8 * (lane >> 4)) * ldb + 8 * ((lane >> 3) & 1);
  for (int kc = 0; kc < depth; kc += 16) {
    unsigned a[4];
    load_a(kc, a);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (8 * j >= nb) continue;
      unsigned f[4];
      ldsm_x4<false>(f, brow + 8 * j * ldb + kc);
      mma_bf16_16816(acc[j], a, f[0], f[1]);
      mma_bf16_16816(acc[j + 1], a, f[2], f[3]);
    }
  }
}

// The A fragments of 16 rows of shared memory at a (stride ld), for tc_nt:
// matrices of rows 0-7 / 8-15 x channels kc, then kc + 8.
__device__ __forceinline__ auto smem_rows(const __nv_bfloat16* a, int ld) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = a + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 8 * (lane >> 4);
  return [row](int kc, unsigned (&f)[4]) { ldsm_x4<false>(f, row + kc); };
}

// s = q . k^T (+ bias) of the warp's 16 rows (their fragments from load_q)
// and keys k0 .. k0 + 63 of ks; keys past vol -inf, rows past vol without
// bias.  The bias loads are issued first, so they are in flight while the
// products run.
template <typename LoadA>
__device__ __forceinline__ void tc_scores(float (&s)[8][4], LoadA load_q, const __nv_bfloat16* ks,
                                          int ld, int hcp, const float* __restrict__ bh, int row0,
                                          int k0, int vol) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  float bv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), key = k0 + 8 * j + 2 * c4 + (e & 1);
      bv[j][e] = row < vol && key < vol ? __ldg(bh + (size_t)row * vol + key) : 0.f;
    }
  }
  // keys to 8 j + 15 past vol lie in the zero-padded vol16 rows: skipped
  tc_nt(s, load_q, ks + k0 * ld, ld, hcp, vol - k0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * c4 + (e & 1);
      s[j][e] = key >= vol ? -INFINITY : s[j][e] + bv[j][e];
    }
  }
}

// p of the warp's 16 rows as bf16 A fragments of m16n8k16, 16 keys a
// k-step: the softmax's max, then its sum of exp, for rows g and g + 8 (a
// quad shares a row), each over every key tile (past one tile the scores are
// recomputed, so the sum is taken at the final max, as the TPU kernel does);
// then p = exp(s - max) / sum, through the dropout of element
// (e0 + row) * vol + key (Drop), rounded to bf16.
template <int KT, bool Drop>
__device__ __forceinline__ void tc_softmax(unsigned (&pa)[4 * KT][4], const __nv_bfloat16* qw,
                                           const __nv_bfloat16* ks, int ld, int hcp,
                                           const float* __restrict__ bh, int row0, int vol,
                                           unsigned long long e0, const philox::Drop& d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const auto load_q = smem_rows(qw, ld);
  float s[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt * kTcKeys >= vol) continue;
    tc_scores(s, load_q, ks, ld, hcp, bh, row0, kt * kTcKeys, vol);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], fmaxf(s[j][2 * r], s[j][2 * r + 1]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt * kTcKeys >= vol) continue;
    if (KT > 1) tc_scores(s, load_q, ks, ld, hcp, bh, row0, kt * kTcKeys, vol);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += x;
        if (KT == 1) s[j][e] = x;   // one tile: exp(s - max) stays for p
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt * kTcKeys >= vol) continue;
    if (KT > 1) tc_scores(s, load_q, ks, ld, hcp, bh, row0, kt * kTcKeys, vol);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p0 = (KT == 1 ? s[j][2 * r] : expf(s[j][2 * r] - m[r])) / l[r];
        float p1 = (KT == 1 ? s[j][2 * r + 1] : expf(s[j][2 * r + 1] - m[r])) / l[r];
        const int row = row0 + g + 8 * r, key = kt * kTcKeys + 8 * j + 2 * c4;
        if (Drop && row < vol && key < vol) {
          const unsigned long long e = (e0 + row) * vol + key;
          if ((e & 1ull) == 0ull) {
            philox::apply2(d, e, p0, p1);
          } else {
            p0 = philox::apply(d, e, p0);
            if (key + 1 < vol) p1 = philox::apply(d, e + 1, p1);
          }
        }
        pa[4 * kt + j / 2][2 * (j & 1) + r] = pack_bf16(p0, p1);
      }
    }
  }
}

template <int KT, bool Drop>
__global__ void __launch_bounds__(128)
cuboid_tc_core_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ attn, int vol, int C, int heads, int hcp,
                      philox::Drop d) {
  philox::load_key(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hc = C / heads, ld = hcp + 8, vol16 = (vol + 15) & ~15, rows = blockDim.x / 2;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [vol16][ld]
  __nv_bfloat16* vs = ks + vol16 * ld;                               // [vol16][ld]
  __nv_bfloat16* qs = vs + vol16 * ld;                               // [rows][ld]
  const int cub = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const size_t tok0 = (size_t)cub * vol;
  const __nv_bfloat16* head = qkv + (size_t)h * hc;
  // k and q, then v, in two groups: v arrives while the scores are computed
  tc_load_rows(ks, ld, head + C, tok0, vol, vol16, 3 * C, hc, hcp);
  tc_load_rows(qs, ld, head, tok0 + q0, vol - q0, rows, 3 * C, hc, hcp);
  asm volatile("cp.async.commit_group;" ::: "memory");
  tc_load_rows(vs, ld, head + 2 * C, tok0, vol, vol16, 3 * C, hc, hcp);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::: "memory");
  __syncthreads();
  const int row0 = q0 + warp * 16;   // the warp's first query row
  const bool rows_here = row0 < vol;  // a ragged cuboid's last warp may have none
  const __nv_bfloat16* qw = qs + warp * 16 * ld;
  const float* bh = bias + (size_t)h * vol * vol;
  unsigned pa[4 * KT][4];
  if (rows_here)
    tc_softmax<KT, Drop>(pa, qw, ks, ld, hcp, bh, row0, vol,
                         ((unsigned long long)cub * heads + h) * vol, d);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (!rows_here) return;
  // o = p . v, 64 output channels at a time
  __nv_bfloat16* out = attn + (size_t)h * hc;
  for (int c0 = 0; c0 < hcp; c0 += 64) {
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    // matrices of v, transposed: keys 16 kk .. + 7 / + 8 .. + 15 x channels
    // 8 j .. 8 j + 7, then the same for j + 1
    const __nv_bfloat16* vrow = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + c0 + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < 4 * KT; ++kk) {
      if (16 * kk >= vol) continue;
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (c0 + 8 * j >= hcp) continue;   // hcp is a multiple of 16: j + 1 too
        unsigned b[4];
        ldsm_x4<true>(b, vrow + 16 * kk * ld + 8 * j);
        mma_bf16_16816(o[j], pa[kk], b[0], b[1]);
        mma_bf16_16816(o[j + 1], pa[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + 2 * c4;
      if (c >= hc) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row >= vol) continue;
        __nv_bfloat16* dst = out + (tok0 + row) * C + c;
        if (hc % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o[j][2 * r], o[j][2 * r + 1]);
        } else {
          dst[0] = __float2bfloat16(o[j][2 * r]);
          if (c + 1 < hc) dst[1] = __float2bfloat16(o[j][2 * r + 1]);
        }
      }
    }
  }
}

// LN(x) of every row into bf16 (M, K), one warp per row: the two-pass mean
// and variance of ln_rows_sw128, for a QKV product wider than its LN tile.
// x, w, b 16-byte aligned, K % 4 == 0.
constexpr int kLnRowsPerBlock = 8;

template <typename XT>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
ln_bf16_rows_kernel(const XT* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, __nv_bfloat16* __restrict__ out, int M, int K,
                    float eps) {
  const int row = blockIdx.x * kLnRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const XT* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int c = lane; c < K / 4; c += 32) {
    const float4 v = load4(xr + 4 * c);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / K;
  float var = 0.f;
  for (int c = lane; c < K / 4; c += 32) {
    const float4 v = load4(xr + 4 * c);
    var += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu) + (v.z - mu) * (v.z - mu) +
           (v.w - mu) * (v.w - mu);
  }
  const float rs = rsqrtf(warp_sum(var) / K + eps);
  for (int c = lane; c < K / 4; c += 32) {
    const float4 v = load4(xr + 4 * c), wv = reinterpret_cast<const float4*>(w)[c],
                 bv = reinterpret_cast<const float4*>(b)[c];
    const uint2 packed = make_uint2(pack_bf16((v.x - mu) * rs * wv.x + bv.x, (v.y - mu) * rs * wv.y + bv.y),
                                    pack_bf16((v.z - mu) * rs * wv.z + bv.z, (v.w - mu) * rs * wv.w + bv.w));
    reinterpret_cast<uint2*>(out + (size_t)row * K)[c] = packed;
  }
}

// ---------------------------------------------------------------------------
// The general layer's gradient core on the tensor cores, on cuboid_reorder's
// layout (cuboid c is the rows c * vol + r of the bf16 q . scale | k | v
// (tokens, 3C) and dattn (tokens, C)).  A warp's tile is 16 rows x 64
// columns in the accumulator layout of m16n8k16: rows g and g + 8, columns
// 8 j + 2 c4 (+1).

// o (+)= A . B for columns c0 .. c0 + 63: A the warp's 16 rows as KS k-step
// fragments pa (16 keys each), B the 16 KS rows at b (stride ldb, the k
// dimension along its rows) by ldmatrix.trans; k-steps at or past nk and
// columns at or past ncols (a multiple of 16) are skipped.
template <int KS>
__device__ __forceinline__ void tc_nn(float (&o)[8][4], const unsigned (&pa)[KS][4],
                                      const __nv_bfloat16* b, int ldb, int c0, int nk, int ncols) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* brow = b + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldb + c0 + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (16 * kk >= nk) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (c0 + 8 * j >= ncols) continue;
      unsigned f[4];
      ldsm_x4<true>(f, brow + 16 * kk * ldb + 8 * j);
      mma_bf16_16816(o[j], pa[kk], f[0], f[1]);
      mma_bf16_16816(o[j + 1], pa[kk], f[2], f[3]);
    }
  }
}

__device__ __forceinline__ void tc_zero(float (&o)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
}

// The A fragment of rows r0 .. r0 + 15 and channels kc .. kc + 15 of a bf16
// matrix in device memory (row stride ld, from its row 0 at the head's first
// channel); zeros at rows >= nrows and channels >= hc.
__device__ __forceinline__ void frag_a_global(unsigned (&a)[4], const __nv_bfloat16* __restrict__ m,
                                              size_t ld, int r0, int nrows, int kc, int hc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + g + 8 * (i & 1), col = kc + 2 * c4 + 8 * (i >> 1);
    __nv_bfloat162 pr;
    pr.x = row < nrows && col < hc ? m[(size_t)row * ld + col] : zero;
    pr.y = row < nrows && col + 1 < hc ? m[(size_t)row * ld + col + 1] : zero;
    a[i] = *reinterpret_cast<const unsigned*>(&pr);
  }
}

// Rows g and g + 8 of the tile summed (max) over the quad that shares them.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The dropout of element (e0 + row) * vol + key on a and b at once: v / keep
// where kept, else 0; rows or keys past vol untouched.  Rows row0 + g (+8),
// keys k0 + 8 j + 2 c4 (+1).  Where vol % 4 == 0 a lane pair's four keys are
// one Philox block in each of its two rows, so each lane draws one block and
// hands its partner half (philox::draw_rows2; the whole warp calls); else
// one block per key pair (or a draw per key at an odd element), as
// tc_softmax draws them.  The same masks either way.
__device__ __forceinline__ void tc_drop(const philox::Drop& d, unsigned long long e0, int row0,
                                        int k0, int vol, float (&a)[8][4], float (&b)[8][4]) {
  if (d.thr == 0u) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  if (vol % 4 == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + 8 * j + 2 * c4;
      unsigned w[2][2];
      philox::draw_rows2(d, (e0 + row0 + g) * vol + key, (e0 + row0 + g + 8) * vol + key, w[0],
                         w[1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row0 + g + 8 * r >= vol || key >= vol) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool kept = w[r][h] >= d.thr;
          a[j][2 * r + h] = kept ? a[j][2 * r + h] / d.keep : 0.f;
          b[j][2 * r + h] = kept ? b[j][2 * r + h] / d.keep : 0.f;
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r, key = k0 + 8 * j + 2 * c4;
      if (row >= vol || key >= vol) continue;
      const unsigned long long e = (e0 + row) * vol + key;
      unsigned u0, u1 = 0u;
      if ((e & 1ull) == 0ull) {
        const uint4 w = philox::block(d, e);
        const bool hi = (e & 2ull) != 0ull;
        u0 = hi ? w.z : w.x;
        u1 = hi ? w.w : w.y;
      } else {
        u0 = philox::draw(d, e);
        if (key + 1 < vol) u1 = philox::draw(d, e + 1);
      }
      a[j][2 * r] = u0 >= d.thr ? a[j][2 * r] / d.keep : 0.f;
      b[j][2 * r] = u0 >= d.thr ? b[j][2 * r] / d.keep : 0.f;
      if (key + 1 < vol) {
        a[j][2 * r + 1] = u1 >= d.thr ? a[j][2 * r + 1] / d.keep : 0.f;
        b[j][2 * r + 1] = u1 >= d.thr ? b[j][2 * r + 1] / d.keep : 0.f;
      }
    }
  }
}

// The same on a transposed tile: rows are keys key0 + g (+8), columns are
// queries q0 + 8 j + 2 c4 (+1), element (e0 + query) * vol + key.
__device__ __forceinline__ void tc_drop_t(const philox::Drop& d, unsigned long long e0, int key0,
                                          int q0, int vol, float (&a)[8][4], float (&b)[8][4]) {
  if (d.thr == 0u) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + g + 8 * (e >> 1), q = q0 + 8 * j + 2 * c4 + (e & 1);
      if (key >= vol || q >= vol) continue;
      const bool kept = philox::draw(d, (e0 + q) * vol + key) >= d.thr;
      a[j][e] = kept ? a[j][e] / d.keep : 0.f;
      b[j][e] = kept ? b[j][e] / d.keep : 0.f;
    }
  }
}

// The tile as the A fragments of its four 16-key k-steps, rounded to bf16.
__device__ __forceinline__ void tc_pack(unsigned (&pa)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) pa[j / 2][2 * (j & 1) + r] = pack_bf16(s[j][2 * r], s[j][2 * r + 1]);
}

// o . mul into bf16 dst (row stride ld, from the cuboid's row 0 at the
// head's first channel): rows r0 + g (+8) below nrows, channels c0 + 8 j +
// 2 c4 (+1) below hc.
__device__ __forceinline__ void tc_store(__nv_bfloat16* __restrict__ dst, size_t ld,
                                         const float (&o)[8][4], int r0, int nrows, int c0, int hc,
                                         float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + 8 * j + 2 * c4;
    if (c >= hc) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= nrows) continue;
      __nv_bfloat16* p = dst + (size_t)row * ld + c;
      if (hc % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(o[j][2 * r] * mul, o[j][2 * r + 1] * mul);
      } else {
        p[0] = __float2bfloat16(o[j][2 * r] * mul);
        if (c + 1 < hc) p[1] = __float2bfloat16(o[j][2 * r + 1] * mul);
      }
    }
  }
}

// The f32 ds of the tile added into the relative-bias partial dst (vol,
// vol) of its (block or cuboid, head): stored where `first`, else added to
// (each element always by the same thread: no race, a fixed order).
__device__ __forceinline__ void tc_bias_grad(float* __restrict__ dst, const float (&ds)[8][4],
                                             int row0, int k0, int vol, bool first) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), key = k0 + 8 * j + 2 * c4 + (e & 1);
      if (row >= vol || key >= vol) continue;
      float* p = dst + (size_t)row * vol + key;
      *p = first ? ds[j][e] : *p + ds[j][e];
    }
  }
}

// One block per (per_block cuboids, head) of vol <= 64 rows, vol16 / 16
// warps.  Shared memory, bf16 rows of hcp channels at a stride of hcp + 8:
// k, q . scale, v, dO of the whole cuboid, then ds and the dropped p
// (vol16, vol16 + 8).  Warp w: query rows 16 w .. 16 w + 15 for s, p, dp,
// D, ds, dq and (Full) the head outputs (p through the dropout) . v; then
// keys 16 w .. for dk = ds^T . q and dv = p_d^T . dO.  Full: the block's f32
// ds summed over its cuboids into dbias_part[blockIdx.x, h].
template <bool Full, bool Drop>
__global__ void __launch_bounds__(128)
cuboid_bwd_core_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const __nv_bfloat16* __restrict__ dattn, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ dqkv, __nv_bfloat16* __restrict__ attn,
                       float* __restrict__ dbias_part, int n_cuboids, int vol, int C, int heads,
                       int hcp, int per_block, float scale, philox::Drop d) {
  philox::load_key(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hc = C / heads, ld = hcp + 8, vol16 = (vol + 15) & ~15, ldp = vol16 + 8;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = ks + vol16 * ld;
  __nv_bfloat16* vs = qs + vol16 * ld;
  __nv_bfloat16* os = vs + vol16 * ld;    // dO
  __nv_bfloat16* dss = os + vol16 * ld;   // [vol16][ldp] bf16(ds)
  __nv_bfloat16* pds = dss + vol16 * ldp; // [vol16][ldp] bf16(p through the dropout)
  const int h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3, r0 = 16 * warp;
  const float* bh = bias + (size_t)h * vol * vol;
  const size_t ld3 = 3 * (size_t)C;
  for (int ci = 0; ci < per_block; ++ci) {
    const int cub = blockIdx.x * per_block + ci;
    if (cub >= n_cuboids) break;
    const size_t tok0 = (size_t)cub * vol;
    __syncthreads();   // the previous cuboid's tiles are read no more
    // k and q, then v and dO, in two groups: v and dO arrive during the scores
    tc_load_rows(ks, ld, qkv + h * hc + C, tok0, vol, vol16, 3 * C, hc, hcp);
    tc_load_rows(qs, ld, qkv + h * hc, tok0, vol, vol16, 3 * C, hc, hcp);
    asm volatile("cp.async.commit_group;" ::: "memory");
    tc_load_rows(vs, ld, qkv + h * hc + 2 * C, tok0, vol, vol16, 3 * C, hc, hcp);
    tc_load_rows(os, ld, dattn + h * hc, tok0, vol, vol16, C, hc, hcp);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    float p[8][4], m[2], l[2] = {0.f, 0.f};
    tc_scores(p, smem_rows(qs + r0 * ld, ld), ks, ld, hcp, bh, r0, 0, vol);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) m[r] = fmaxf(m[r], fmaxf(p[j][2 * r], p[j][2 * r + 1]));
      m[r] = quad_max(m[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = expf(p[j][e] - m[e >> 1]);
        l[e >> 1] += p[j][e];
      }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] /= l[e >> 1];
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    // dp = dO . v^T (through the dropout); D; ds = p (dp - D) in place of dp
    float dp[8][4], pd[8][4];
    tc_nt(dp, smem_rows(os + r0 * ld, ld), vs, ld, hcp, vol);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pd[j][e] = p[j][e];
    if (Drop) tc_drop(d, ((unsigned long long)cub * heads + h) * vol, r0, 0, vol, dp, pd);
    float D[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) D[e >> 1] += dp[j][e] * p[j][e];
    D[0] = quad_sum(D[0]);
    D[1] = quad_sum(D[1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - D[e >> 1]);
    if (Full)
      tc_bias_grad(dbias_part + ((size_t)blockIdx.x * heads + h) * vol * vol, dp, r0, 0, vol,
                   ci == 0);
    unsigned dsa[4][4], pda[4][4];
    tc_pack(dsa, dp);
    tc_pack(pda, pd);
    // dq = ds . k . scale and (Full) the head outputs p_d . v, 64 channels at a time
    for (int c0 = 0; c0 < hcp; c0 += 64) {
      float o[8][4];
      tc_zero(o);
      tc_nn<4>(o, dsa, ks, ld, c0, vol, hcp);
      tc_store(dqkv + tok0 * ld3 + h * hc, ld3, o, r0, vol, c0, hc, scale);
      if (Full) {
        tc_zero(o);
        tc_nn<4>(o, pda, vs, ld, c0, vol, hcp);
        tc_store(attn + tok0 * C + h * hc, C, o, r0, vol, c0, hc, 1.f);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= vol16) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (r0 + g + 8 * r) * ldp + 8 * j + 2 * c4;
        *reinterpret_cast<unsigned*>(dss + at) = pack_bf16(dp[j][2 * r], dp[j][2 * r + 1]);
        *reinterpret_cast<unsigned*>(pds + at) = pack_bf16(pd[j][2 * r], pd[j][2 * r + 1]);
      }
    }
    __syncthreads();
    // dk = ds^T . q and dv = p_d^T . dO for keys r0 .. r0 + 15: ds^T's and
    // p_d^T's fragments by ldmatrix.trans of the stored tiles
    unsigned dst[4][4], pdt[4][4];
    const int tr = ((lane & 7) + 8 * (lane >> 4)) * ldp + r0 + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (16 * kk >= vol16) continue;
      ldsm_x4<true>(dst[kk], dss + tr + 16 * kk * ldp);
      ldsm_x4<true>(pdt[kk], pds + tr + 16 * kk * ldp);
    }
    for (int c0 = 0; c0 < hcp; c0 += 64) {
      float dk[8][4], dv[8][4];
      tc_zero(dk);
      tc_zero(dv);
      tc_nn<4>(dk, dst, qs, ld, c0, vol, hcp);
      tc_nn<4>(dv, pdt, os, ld, c0, vol, hcp);
      tc_store(dqkv + tok0 * ld3 + C + h * hc, ld3, dk, r0, vol, c0, hc, 1.f);
      tc_store(dqkv + tok0 * ld3 + 2 * C + h * hc, ld3, dv, r0, vol, c0, hc, 1.f);
    }
  }
}

// The split for larger cuboids, first the query rows: one block per
// (cuboid, head, 16 x warps query rows), k and v of the whole cuboid in
// shared memory, q . scale and dO fragments from device memory.  Over KT
// 64-key tiles a warp takes its rows' max, sum and D (recomputing the
// scores in each pass), then ds tile by tile (Full: the f32 ds into the
// cuboid's relative-bias partial) as fragments for dq = ds . k . scale;
// Full: again p through the dropout for the head outputs.  stats (cuboids,
// heads, vol, 3): each row's max, sum and D for the key-row launch.
template <int KT, bool Full, bool Drop>
__global__ void __launch_bounds__(128)
cuboid_bwd_q_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dattn,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ dqkv,
                    __nv_bfloat16* __restrict__ attn, float* __restrict__ stats,
                    float* __restrict__ dbias_part, int vol, int C, int heads, int hcp, float scale,
                    philox::Drop d) {
  philox::load_key(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hc = C / heads, ld = hcp + 8, vol16 = (vol + 15) & ~15;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + vol16 * ld;
  const int cub = blockIdx.x, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.z * (blockDim.x / 2) + 16 * warp;
  const size_t tok0 = (size_t)cub * vol, ld3 = 3 * (size_t)C;
  tc_load_rows(ks, ld, qkv + h * hc + C, tok0, vol, vol16, 3 * C, hc, hcp);
  tc_load_rows(vs, ld, qkv + h * hc + 2 * C, tok0, vol, vol16, 3 * C, hc, hcp);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (row0 >= vol) return;
  const float* bh = bias + (size_t)h * vol * vol;
  const __nv_bfloat16* qg = qkv + tok0 * ld3 + h * hc;
  const __nv_bfloat16* og = dattn + tok0 * C + h * hc;
  const unsigned long long e0 = ((unsigned long long)cub * heads + h) * vol;
  const auto load_q = [&](int kc, unsigned (&f)[4]) { frag_a_global(f, qg, ld3, row0, vol, kc, hc); };
  const auto load_o = [&](int kc, unsigned (&f)[4]) { frag_a_global(f, og, C, row0, vol, kc, hc); };
  float s[8][4], dp[8][4], pd[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {   // the rows' max
    if (kt * kTcKeys >= vol) continue;
    tc_scores(s, load_q, ks, ld, hcp, bh, row0, kt * kTcKeys, vol);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], fmaxf(s[j][2 * r], s[j][2 * r + 1]));
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  // p of tile kt into s (and, Drop, through the dropout into pd with dp)
  const auto probs = [&](int kt) {
    tc_scores(s, load_q, ks, ld, hcp, bh, row0, kt * kTcKeys, vol);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) / l[e >> 1];
  };
  const auto dprobs = [&](int kt) {
    tc_nt(dp, load_o, vs + kt * kTcKeys * ld, ld, hcp, vol - kt * kTcKeys);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pd[j][e] = s[j][e];
    if (Drop) tc_drop(d, e0, row0, kt * kTcKeys, vol, dp, pd);
  };
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {   // the rows' sum of exp(s - max)
    if (kt * kTcKeys >= vol) continue;
    tc_scores(s, load_q, ks, ld, hcp, bh, row0, kt * kTcKeys, vol);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[j][e] - m[e >> 1]);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {   // D = rowsum(dp . p)
    if (kt * kTcKeys >= vol) continue;
    probs(kt);
    dprobs(kt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) D[e >> 1] += dp[j][e] * s[j][e];
  }
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);
  unsigned fa[4 * KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {   // ds, as the fragments of dq's product
    if (kt * kTcKeys >= vol) continue;
    probs(kt);
    dprobs(kt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - D[e >> 1]);
    if (Full)
      tc_bias_grad(dbias_part + ((size_t)cub * heads + h) * vol * vol, dp, row0, kt * kTcKeys,
                   vol, true);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        fa[4 * kt + j / 2][2 * (j & 1) + r] = pack_bf16(dp[j][2 * r], dp[j][2 * r + 1]);
  }
  for (int c0 = 0; c0 < hcp; c0 += 64) {
    float o[8][4];
    tc_zero(o);
    tc_nn<4 * KT>(o, fa, ks, ld, c0, vol, hcp);
    tc_store(dqkv + tok0 * ld3 + h * hc, ld3, o, row0, vol, c0, hc, scale);
  }
  if (Full) {   // the head outputs: p through the dropout, as fragments of p_d . v
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt * kTcKeys >= vol) continue;
      probs(kt);
      dprobs(kt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          fa[4 * kt + j / 2][2 * (j & 1) + r] = pack_bf16(pd[j][2 * r], pd[j][2 * r + 1]);
    }
    for (int c0 = 0; c0 < hcp; c0 += 64) {
      float o[8][4];
      tc_zero(o);
      tc_nn<4 * KT>(o, fa, vs, ld, c0, vol, hcp);
      tc_store(attn + tok0 * C + h * hc, C, o, row0, vol, c0, hc, 1.f);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + (lane >> 2) + 8 * r;
      if (row >= vol) continue;
      float* st = stats + (((size_t)cub * heads + h) * vol + row) * 3;
      st[0] = m[r];
      st[1] = l[r];
      st[2] = D[r];
    }
  }
}

// Then the key rows: one block per (cuboid, head, 16 x warps keys), q . scale
// and dO of the whole cuboid and the rows' statistics in shared memory, k
// and v fragments from device memory.  A warp recomputes, 64 queries at a
// time, s^T = k . q^T and dp^T = v . dO^T for its 16 keys, p^T from the
// statistics, the dropout, ds^T = p^T (dp^T - D), and adds dk = ds^T . q and
// dv = p_d^T . dO in registers, 64 channels at a time.
template <bool Drop>
__global__ void __launch_bounds__(128)
cuboid_bwd_kv_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dattn,
                     const float* __restrict__ bias, const float* __restrict__ stats,
                     __nv_bfloat16* __restrict__ dqkv, int vol, int C, int heads, int hcp,
                     philox::Drop d) {
  philox::load_key(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hc = C / heads, ld = hcp + 8, vol16 = (vol + 15) & ~15;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* os = qs + vol16 * ld;
  float* st = reinterpret_cast<float*>(os + vol16 * ld);   // [vol][3]: max, sum, D
  const int cub = blockIdx.x, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int key0 = blockIdx.z * (blockDim.x / 2) + 16 * warp;
  const size_t tok0 = (size_t)cub * vol, ld3 = 3 * (size_t)C;
  tc_load_rows(qs, ld, qkv + h * hc, tok0, vol, vol16, 3 * C, hc, hcp);
  tc_load_rows(os, ld, dattn + h * hc, tok0, vol, vol16, C, hc, hcp);
  asm volatile("cp.async.commit_group;" ::: "memory");
  const float* sg = stats + ((size_t)cub * heads + h) * vol * 3;
  for (int i = threadIdx.x; i < 3 * vol; i += blockDim.x) st[i] = sg[i];
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (key0 >= vol) return;
  const float* bh = bias + (size_t)h * vol * vol;
  const __nv_bfloat16* kg = qkv + tok0 * ld3 + C + h * hc;
  const unsigned long long e0 = ((unsigned long long)cub * heads + h) * vol;
  const auto load_k = [&](int kc, unsigned (&f)[4]) { frag_a_global(f, kg, ld3, key0, vol, kc, hc); };
  const auto load_v = [&](int kc, unsigned (&f)[4]) {
    frag_a_global(f, kg + C, ld3, key0, vol, kc, hc);
  };
  for (int c0 = 0; c0 < hcp; c0 += 64) {
    float dk[8][4], dv[8][4];
    tc_zero(dk);
    tc_zero(dv);
    for (int q0 = 0; q0 < vol; q0 += kTcKeys) {
      float p[8][4], dp[8][4], pd[8][4];
      tc_nt(p, load_k, qs + q0 * ld, ld, hcp, vol - q0);
      tc_nt(dp, load_v, os + q0 * ld, ld, hcp, vol - q0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + g + 8 * (e >> 1), q = q0 + 8 * j + 2 * c4 + (e & 1);
          const bool in = key < vol && q < vol;
          p[j][e] = in ? expf(p[j][e] + __ldg(bh + (size_t)q * vol + key) - st[3 * q]) /
                             st[3 * q + 1]
                       : 0.f;
          pd[j][e] = p[j][e];
        }
      if (Drop) tc_drop_t(d, e0, key0, q0, vol, dp, pd);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * c4 + (e & 1);
          dp[j][e] = q < vol ? p[j][e] * (dp[j][e] - st[3 * q + 2]) : 0.f;
        }
      unsigned dsa[4][4], pda[4][4];
      tc_pack(dsa, dp);
      tc_pack(pda, pd);
      tc_nn<4>(dk, dsa, qs + q0 * ld, ld, c0, vol - q0, hcp);
      tc_nn<4>(dv, pda, os + q0 * ld, ld, c0, vol - q0, hcp);
    }
    tc_store(dqkv + tok0 * ld3 + C + h * hc, ld3, dk, key0, vol, c0, hc, 1.f);
    tc_store(dqkv + tok0 * ld3 + 2 * C + h * hc, ld3, dv, key0, vol, c0, hc, 1.f);
  }
}

// ---------------------------------------------------------------------------
// Grouped masked core, f32 on the tensor cores in 3xTF32: one block per
// (cuboid, batch * heads + head, query tile x channel slice).
constexpr int kGq = 64, kGk = 64, kGc = 64;   // query rows, keys, channels a tile
constexpr int kGld = kGc + 4;                 // smem row stride: fragment loads conflict-free
constexpr float kNegInf = -1e18f;

size_t grouped_smem() { return sizeof(float) * (size_t)(kGq + 2 * kGk) * kGld; }

// Element strides of (sample, cuboid, head, row) in a layout of q, k, v or
// out; a row's hc channels are contiguous.
struct CoreLayout {
  long long b, n, h, r;
};

// x = big + small: big is x rounded to TF32 (to nearest, ties away: add half
// a TF32 ulp, clear the 13 low bits), small = x - big exactly in f32, which
// the tensor cores read truncated to TF32 (its error is 2^-11 of small).
__device__ __forceinline__ void tf32_split(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32 from the split operands, the small cross terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ab)[4],
                                           const unsigned (&as)[4], const unsigned (&bb)[2],
                                           const unsigned (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// rows x kGc channels [c0, c0 + kGc) of rows [r0, r0 + rows) of a
// (sample, cuboid, head) at `base` into dst (row stride kGld); zeros past
// `nrows` rows and `hc` channels.  f32 by cp.async; bf16 (the bf16 form)
// widened as read, 8 bytes a load, and stored as f32.
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long base,
                                          long long rstride, int r0, int nrows, int c0, int hc,
                                          int tid) {
  for (int i = tid; i < kGq * (kGc / 4); i += kCoreThreads) {
    const int r = i / (kGc / 4), c = c0 + (i % (kGc / 4)) * 4;
    const bool valid = r0 + r < nrows && c < hc;
    cp_async16(dst + r * kGld + (c - c0), valid ? src + base + (r0 + r) * rstride + c : src,
               valid);
  }
}

__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, long long base,
                                          long long rstride, int r0, int nrows, int c0, int hc,
                                          int tid) {
  for (int i = tid; i < kGq * (kGc / 4); i += kCoreThreads) {
    const int r = i / (kGc / 4), c = c0 + (i % (kGc / 4)) * 4;
    const bool valid = r0 + r < nrows && c < hc;
    *reinterpret_cast<float4*>(dst + r * kGld + (c - c0)) =
        valid ? load4(src + base + (r0 + r) * rstride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// NB: 8-channel blocks of the block's output slice (1, 2, 4 or 8).  T: the
// type of q, k, v and out (f32, or bf16: the bf16 form).  A bf16 k or v is
// exact in TF32, so its small part is 0 and the two passes that read it are
// left out: the bf16 form computes the f32 form's sums on the widened inputs,
// bit for bit, in two TF32 passes a product instead of three.
template <int NB, typename T>
__global__ void __launch_bounds__(kCoreThreads)
grouped_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const unsigned char* __restrict__ mask, T* __restrict__ out,
                    CoreLayout in, CoreLayout ol, int heads, int vol, int hc, float scale) {
  constexpr bool kExactB = sizeof(T) == 2;   // k and v exact in TF32: no small part
  extern __shared__ float sm[];
  float* qs = sm;                // [kGq][kGld] q, one channel chunk
  float* ks = qs + kGq * kGld;   // [kGk][kGld] k, one channel chunk
  float* vs = ks + kGk * kGld;   // [kGk][kGld] v, the block's output slice
  const int slices = (hc + 8 * NB - 1) / (8 * NB);
  const int n = blockIdx.x, h = blockIdx.y % heads, b = blockIdx.y / heads;
  const int q0 = (blockIdx.z / slices) * kGq, s0 = (blockIdx.z % slices) * (8 * NB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;            // fragment row group, column pair
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const long long base = b * in.b + n * in.n + h * in.h, obase = b * ol.b + n * ol.n + h * ol.h;
  const float* bh = bias + (size_t)h * vol * vol;
  const unsigned char* mk = mask == nullptr ? nullptr : mask + (size_t)n * vol * vol;
  const int chunks = (hc + kGc - 1) / kGc;

  float o[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  if (chunks == 1) load_tile(qs, q, base, in.r, q0, vol, 0, hc, tid);
  for (int k0 = 0; k0 < vol; k0 += kGk) {
    // scores of this warp's 16 rows x 64 keys: key 8 j + 2 c4 (+1), rows g (+8)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int c0 = 0; c0 < hc; c0 += kGc) {
      if (chunks > 1) load_tile(qs, q, base, in.r, q0, vol, c0, hc, tid);
      load_tile(ks, k, base, in.r, k0, vol, c0, hc, tid);
      if (c0 + kGc >= hc) load_tile(vs, v, base, in.r, k0, vol, s0, min(hc, s0 + 8 * NB), tid);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      const int steps = (min(kGc, hc - c0) + 7) / 8;
      for (int kc = 0; kc < steps; ++kc) {
        const float* qa = qs + (warp * 16 + g) * kGld + kc * 8 + c4;
        unsigned ab[4], as[4];
        tf32_split(qa[0] * scale, ab[0], as[0]);
        tf32_split(qa[8 * kGld] * scale, ab[1], as[1]);
        tf32_split(qa[4] * scale, ab[2], as[2]);
        tf32_split(qa[8 * kGld + 4] * scale, ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* kb = ks + (8 * j + g) * kGld + kc * 8 + c4;
          unsigned bb[2], bs[2];
          tf32_split(kb[0], bb[0], bs[0]);
          tf32_split(kb[4], bb[1], bs[1]);
          if (kExactB) {
            mma_tf32(s[j], as, bb);
            mma_tf32(s[j], ab, bb);
          } else {
            mma_3xtf32(s[j], ab, as, bb, bs);
          }
        }
      }
      if (c0 + kGc < hc) __syncthreads();   // the next chunk overwrites qs and ks
    }
    // bias, mask, and the online softmax of rows g and g + 8 (a quad shares a row)
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1, key = k0 + 8 * j + 2 * c4 + (e & 1);
        float sv = -INFINITY;   // past vol: no weight and no share of the sum
        if (row < vol && key < vol) {
          const size_t at = (size_t)row * vol + key;
          sv = (mk != nullptr && !mk[at]) ? kNegInf : s[j][e] + bh[at];
        }
        s[j][e] = sv;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], sv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = tile_max[r];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      // a query row past vol has no key: keep its state finite
      alpha[r] = m_new == -INFINITY ? 1.f : expf(m_run[r] - m_new);
      tile_max[r] = m_new;
      m_run[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = r ? row1 : row0, key = k0 + 8 * j + 2 * c4 + (e & 1);
        const float ev = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - tile_max[r]);
        tile_sum[r] += ev;
        const bool keep = mk == nullptr || (row < vol && key < vol && mk[(size_t)row * vol + key]);
        s[j][e] = keep ? ev : 0.f;   // p . mask at the running max
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = tile_sum[r];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      l_run[r] = l_run[r] * alpha[r] + t;
    }
    // o = o alpha + p . v: the A fragment of keys 8 kb + {2 c4, 2 c4 + 1} is
    // this thread's own score pair, so v's rows are read in that order
    float pv[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      unsigned ab[4], as[4];
      tf32_split(s[kb][0], ab[0], as[0]);
      tf32_split(s[kb][2], ab[1], as[1]);
      tf32_split(s[kb][1], ab[2], as[2]);
      tf32_split(s[kb][3], ab[3], as[3]);
      const float* vb = vs + (8 * kb + 2 * c4) * kGld + g;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        unsigned bb[2], bs[2];
        tf32_split(vb[8 * j], bb[0], bs[0]);
        tf32_split(vb[kGld + 8 * j], bb[1], bs[1]);
        if (kExactB) {
          mma_tf32(pv[j], as, bb);
          mma_tf32(pv[j], ab, bb);
        } else {
          mma_3xtf32(pv[j], ab, as, bb, bs);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = o[j][e] * alpha[e >> 1] + pv[j][e];
    __syncthreads();   // the next key tile overwrites ks and vs
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int c = s0 + 8 * j + 2 * c4;
    if (c >= hc) continue;
    if (row0 < vol) store2(out + obase + row0 * ol.r + c, o[j][0] / l_run[0], o[j][1] / l_run[0]);
    if (row1 < vol) store2(out + obase + row1 * ol.r + c, o[j][2] / l_run[1], o[j][3] / l_run[1]);
  }
}

// The three launches of the general layer's forward; Drop adds the two
// dropouts.  qkv (tokens, 3C) and attn (tokens, C) bf16 scratch; the QKV
// product with the LN tile (ln_tile, bn_qkv its column tile) or, wider than
// that tile, on bf16 LN rows written into attn first; the core in blocks of
// q_rows query rows (16, 32 or 64) over key_tiles 64-key tiles (1, 2 or 4).
template <int KT, bool Drop>
cudaError_t tc_core(const __nv_bfloat16* qkv, const float* bias, __nv_bfloat16* attn,
                    int n_cuboids, int vol, int C, int heads, int q_rows, philox::Drop d,
                    cudaStream_t stream) {
  static bool configured = false;   // once, at the most a block may take: no host call per launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cuboid_tc_core_kernel<KT, Drop>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::kSmemCap);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int hcp = (C / heads + 15) & ~15, vol16 = (vol + 15) & ~15;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(hcp + 8) * (2 * vol16 + q_rows);
  if (smem > (size_t)fwd::kSmemCap) return cudaErrorInvalidValue;
  cuboid_tc_core_kernel<KT, Drop><<<dim3(n_cuboids, heads, (vol + q_rows - 1) / q_rows),
                                    2 * q_rows, smem, stream>>>(qkv, bias, attn, vol, C, heads,
                                                                hcp, d);
  return cudaGetLastError();
}

template <bool Drop, typename XT = float>
cudaError_t cuboid_forward_launches(const XT* x, const float* ln_w, const float* ln_b,
                                    const void* wqkv_map, const float* bias,
                                    const void* wproj_map, const float* b_proj,
                                    __nv_bfloat16* qkv, __nv_bfloat16* attn, XT* out,
                                    int n_cuboids, int vol, int C, int heads, int bn_qkv,
                                    int ln_tile, int q_rows, int key_tiles, float scale,
                                    float eps, cudaStream_t stream,
                                    philox::Drop d_attn = philox::Drop{},
                                    philox::Drop d_proj = philox::Drop{}) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (C % 64 != 0 || C % heads != 0 || vol < 1 || vol > kTcKeys * key_tiles ||
      (q_rows != 16 && q_rows != 32 && q_rows != 64) ||
      (key_tiles != 1 && key_tiles != 2 && key_tiles != 4) || (bn_qkv != 128 && bn_qkv != 256) ||
      !aligned(x) || !aligned(ln_w) || !aligned(ln_b) || !aligned(qkv) || !aligned(attn) ||
      !aligned(b_proj) || (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(XT) - 1)))
    return cudaErrorInvalidValue;
  const int M = n_cuboids * vol;
  CUtensorMap wqkv, wproj, attn_map;
  memcpy(&wqkv, wqkv_map, sizeof(wqkv));
  memcpy(&wproj, wproj_map, sizeof(wproj));
  const int enc = hopper::encode_bf16_matrix(&attn_map, attn, M, C, fwd::kBM);
  if (enc != 0) return (cudaError_t)enc;
  const philox::Drop none{};
  cudaError_t err;
  if (ln_tile) {
    err = fwd::qkv_gemm(bn_qkv, wqkv, x, ln_w, ln_b, qkv, M, C, scale, eps, stream);
  } else {   // LN rows into attn (free until the core), then the product on them by TMA
    ln_bf16_rows_kernel<XT><<<(M + kLnRowsPerBlock - 1) / kLnRowsPerBlock,
                           32 * kLnRowsPerBlock, 0, stream>>>(x, ln_w, ln_b, attn, M, C, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = fwd::gemm<128, 0, false, true>(attn_map, wqkv, nullptr, nullptr, nullptr, nullptr, qkv, M,
                                         3 * C, C, C, scale, eps, none, stream);
  }
  if (err != cudaSuccess) return err;
  if (key_tiles == 1)
    err = tc_core<1, Drop>(qkv, bias, attn, n_cuboids, vol, C, heads, q_rows, d_attn, stream);
  else if (key_tiles == 2)
    err = tc_core<2, Drop>(qkv, bias, attn, n_cuboids, vol, C, heads, q_rows, d_attn, stream);
  else
    err = tc_core<4, Drop>(qkv, bias, attn, n_cuboids, vol, C, heads, q_rows, d_attn, stream);
  if (err != cudaSuccess) return err;
  return fwd::gemm<128, 0, Drop, false, float, XT>(attn_map, wproj, nullptr, nullptr, nullptr,
                                                  b_proj, out, M, C, C, 0, 1.f, eps, d_proj,
                                                  stream);
}

// The general layer's gradient core: dq, dk, dv into dqkv (bf16) and, Full,
// the head outputs into attn and the f32 ds into dbias_part.  fused: one
// launch of cuboid_bwd_core_kernel, per_block cuboids a block (vol <= 64),
// dbias_part (ceil(cuboids / per_block), heads, vol, vol); else the
// query-row and key-row launches on `rows` rows a block, stats (cuboids,
// heads, vol, 3) between them, dbias_part (cuboids, heads, vol, vol).
template <bool Full, bool Drop>
cudaError_t fused_core(const __nv_bfloat16* qkv, const __nv_bfloat16* dattn, const float* bias,
                       __nv_bfloat16* dqkv, __nv_bfloat16* attn, float* dbias_part, int n_cuboids,
                       int vol, int C, int heads, int hcp, int per_block, size_t smem, float scale,
                       philox::Drop d, cudaStream_t stream) {
  static bool configured = false;   // once, at the most a block may take: no host call per launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cuboid_bwd_core_kernel<Full, Drop>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::kSmemCap);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int vol16 = (vol + 15) & ~15;
  cuboid_bwd_core_kernel<Full, Drop><<<dim3((n_cuboids + per_block - 1) / per_block, heads),
                                       2 * vol16, smem, stream>>>(
      qkv, dattn, bias, dqkv, attn, dbias_part, n_cuboids, vol, C, heads, hcp, per_block, scale, d);
  return cudaGetLastError();
}

template <int KT, bool Full, bool Drop>
cudaError_t split_core(const __nv_bfloat16* qkv, const __nv_bfloat16* dattn, const float* bias,
                       __nv_bfloat16* dqkv, __nv_bfloat16* attn, float* stats, float* dbias_part,
                       int n_cuboids, int vol, int C, int heads, int hcp, int rows, size_t smem,
                       float scale, philox::Drop d, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(cuboid_bwd_q_kernel<KT, Full, Drop>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::kSmemCap);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cuboid_bwd_kv_kernel<Drop>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::kSmemCap);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n_cuboids, heads, (vol + rows - 1) / rows);
  cuboid_bwd_q_kernel<KT, Full, Drop><<<grid, 2 * rows, smem, stream>>>(
      qkv, dattn, bias, dqkv, attn, stats, dbias_part, vol, C, heads, hcp, scale, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vol16 = (vol + 15) & ~15;
  cuboid_bwd_kv_kernel<Drop><<<grid, 2 * rows, smem + sizeof(float) * 3 * vol16, stream>>>(
      qkv, dattn, bias, stats, dqkv, vol, C, heads, hcp, d);
  return cudaGetLastError();
}

template <bool Full, bool Drop>
cudaError_t cuboid_core_bwd(const __nv_bfloat16* qkv, const __nv_bfloat16* dattn,
                            const float* bias, __nv_bfloat16* dqkv, __nv_bfloat16* attn,
                            float* stats, float* dbias_part, int n_cuboids, int vol, int C,
                            int heads, int fused, int rows, int per_block, float scale,
                            philox::Drop d, cudaStream_t stream) {
  const int hcp = (C / heads + 15) & ~15, vol16 = (vol + 15) & ~15;
  const size_t operand = sizeof(__nv_bfloat16) * (size_t)(hcp + 8) * vol16;   // one (vol16, hcp + 8) tile
  if (fused) {
    const size_t smem = 4 * operand + sizeof(__nv_bfloat16) * 2 * (size_t)vol16 * (vol16 + 8);
    if (vol > kTcKeys || per_block < 1 || smem > (size_t)fwd::kSmemCap) return cudaErrorInvalidValue;
    return fused_core<Full, Drop>(qkv, dattn, bias, dqkv, attn, dbias_part, n_cuboids, vol, C,
                                  heads, hcp, per_block, smem, scale, d, stream);
  }
  if ((rows != 16 && rows != 32 && rows != 64) || vol > 4 * kTcKeys ||
      2 * operand + sizeof(float) * 3 * vol16 > (size_t)fwd::kSmemCap)
    return cudaErrorInvalidValue;
  if (vol <= kTcKeys)
    return split_core<1, Full, Drop>(qkv, dattn, bias, dqkv, attn, stats, dbias_part, n_cuboids,
                                     vol, C, heads, hcp, rows, 2 * operand, scale, d, stream);
  if (vol <= 2 * kTcKeys)
    return split_core<2, Full, Drop>(qkv, dattn, bias, dqkv, attn, stats, dbias_part, n_cuboids,
                                     vol, C, heads, hcp, rows, 2 * operand, scale, d, stream);
  return split_core<4, Full, Drop>(qkv, dattn, bias, dqkv, attn, stats, dbias_part, n_cuboids,
                                   vol, C, heads, hcp, rows, 2 * operand, scale, d, stream);
}

// ---------------------------------------------------------------------------
// The round-1 whole layer ("v3"), f32: its two products in 3xTF32 on the
// tensor cores around the grouped core.
//
// tf32_gemm_kernel: out[M, N] = A'[M, K] . W[N, K]^T (+ bias[N]), A' = LN(A)
// rows (Ln) or A.  A block computes 64 x 64 outputs with 4 warps of 32 x 32
// (2 x 4 m16n8k8 tiles); the A and W tiles of 32 K come in by 16-byte
// cp.async into two stages of shared memory (rows padded to 36 floats, so
// the fragment loads are free of bank conflicts), the next stage in flight
// while the tensor cores work on this one.  Each operand is split into a
// TF32 big part and the rest (tf32_split), and mma_3xtf32 adds
// small.big + big.small + big.big: ~f32 accuracy, as the TPU kernel computes
// the layer in f32.  Each 32-K stage sums into a fresh accumulator that is
// added to the running f32 sum on the CUDA cores (the tensor cores' own
// sums lose more than IEEE adds do, as row 10 found).  With Ln each thread
// normalises the A values it copied once they land, (x - mean) * rstd * w +
// b, from the rows' mean and 1/sqrt(var + eps) that ln_stats_kernel wrote
// first (a warp a row, two passes, as a LayerNorm), so LN(x) never reaches
// memory; taking the statistics inside the product instead would make every
// column block recompute its 64 rows', a warp's 16 rows one after another.
// The bias is added in the epilogue.
constexpr int kLnRows = 8;   // ln_stats_kernel: rows a block, a warp each

__global__ void __launch_bounds__(32 * kLnRows)
ln_stats_kernel(const float* __restrict__ x, float2* __restrict__ stats, int M, int K,
                float eps) {
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * K;
  float s = 0.f;
  for (int c = lane; c < K; c += 32) s += xr[c];
  const float mean = warp_sum(s) / K;
  float v = 0.f;
  for (int c = lane; c < K; c += 32) {
    const float d = xr[c] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / K + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

constexpr int kTm = 64, kTn = 64, kTk = 32, kTld = kTk + 4, kTThreads = 128;

template <bool Ln>
__global__ void __launch_bounds__(kTThreads)
tf32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ bias, const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b, const float2* __restrict__ stats,
                 float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kTm * kTld];
  __shared__ __align__(16) float Ws[2][kTn * kTld];
  __shared__ float2 row_stats[kTm];   // mean, rstd
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;            // fragment row group, column
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kTm, n0 = blockIdx.x * kTn;
  const int nk = (K + kTk - 1) / kTk;

  // the stage's tiles: 64 rows x 32 K of A and of W, 4 floats a copy, zeros
  // past M, N and K (K % 4 == 0)
  const auto load = [&](int stage, int k0) {
    for (int i = tid; i < kTm * (kTk / 4); i += kTThreads) {
      const int r = i / (kTk / 4), k = k0 + (i % (kTk / 4)) * 4;
      const bool va = m0 + r < M && k < K, vw = n0 + r < N && k < K;
      cp_async16(&As[stage][r * kTld + (k - k0)], va ? A + (size_t)(m0 + r) * K + k : A, va);
      cp_async16(&Ws[stage][r * kTld + (k - k0)], vw ? W + (size_t)(n0 + r) * K + k : W, vw);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  load(0, 0);
  if constexpr (Ln) {
    for (int r = tid; r < kTm; r += kTThreads)
      row_stats[r] = m0 + r < M ? stats[m0 + r] : make_float2(0.f, 0.f);
    __syncthreads();
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTk;
    if (kt + 1 < nk)
      load(st ^ 1, k0 + kTk);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");   // keep one group a stage
    asm volatile("cp.async.wait_group 1;" ::: "memory");       // this stage's copies landed
    if constexpr (Ln) {   // each thread normalises the A values it copied
      for (int i = tid; i < kTm * (kTk / 4); i += kTThreads) {
        const int r = i / (kTk / 4), kk = (i % (kTk / 4)) * 4, k = k0 + kk;
        if (m0 + r >= M || k >= K) continue;
        float* a = &As[st][r * kTld + kk];
        const float mean = row_stats[r].x, rstd = row_stats[r].y;
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = (a[e] - mean) * rstd * ln_w[k + e] + ln_b[k + e];
      }
    }
    __syncthreads();
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kTk / 8; ++kc) {
      unsigned ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* pa = &As[st][(wm + 16 * i + g) * kTld + kc * 8 + c4];
        tf32_split(pa[0], ab[i][0], as[i][0]);
        tf32_split(pa[8 * kTld], ab[i][1], as[i][1]);
        tf32_split(pa[4], ab[i][2], as[i][2]);
        tf32_split(pa[8 * kTld + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* pw = &Ws[st][(wn + 8 * j + g) * kTld + kc * 8 + c4];
        unsigned bb[2], bs[2];
        tf32_split(pw[0], bb[0], bs[0]);
        tf32_split(pw[4], bb[1], bs[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_3xtf32(part[i][j], ab[i], as[i], bb, bs);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    __syncthreads();   // the next iteration's copies overwrite this stage
  }
  // epilogue: rows g, g + 8 of each 16, columns 2 c4, 2 c4 + 1 of each 8 (N % 4 == 0)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * c4;
      if (n >= N) continue;
      const float b0 = bias != nullptr ? bias[n] : 0.f, b1 = bias != nullptr ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + g + 8 * h;
        if (m < M)
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
              make_float2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
      }
    }
  }
}

// out = LN(A) . W^T (Ln: stats (M) f32 pairs of workspace, ln_stats_kernel's)
// or A . W^T + bias, f32 in 3xTF32; A (M, K), W (N, K) row-major, K and N
// multiples of 4, A and W 16-byte aligned.
template <bool Ln>
cudaError_t tf32_gemm(const float* A, const float* W, const float* bias, const float* ln_w,
                      const float* ln_b, float2* stats, float* out, int M, int N, int K,
                      float eps, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (M < 1 || N < 4 || K < 4 || N % 4 || K % 4 || (M + kTm - 1) / kTm > 65535 || !aligned(A) ||
      !aligned(W) || (reinterpret_cast<uintptr_t>(out) & 7) ||
      (Ln && (reinterpret_cast<uintptr_t>(stats) & 7)))
    return cudaErrorInvalidValue;
  if (Ln) {
    ln_stats_kernel<<<(M + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, stream>>>(A, stats, M, K,
                                                                              eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  tf32_gemm_kernel<Ln><<<dim3((N + kTn - 1) / kTn, (M + kTm - 1) / kTm), kTThreads, 0, stream>>>(
      A, W, bias, ln_w, ln_b, stats, out, M, N, K);
  return cudaGetLastError();
}

template <int NB, typename T>
cudaError_t core_launch_nb(const T* q, const T* k, const T* v, const float* bias,
                           const unsigned char* mask, T* out, CoreLayout in, CoreLayout ol,
                           int B, int heads, int n_cuboids, int vol, int hc, float scale,
                           cudaStream_t stream) {
  const size_t smem = grouped_smem();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(grouped_core_kernel<NB, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long tiles = (long long)((vol + kGq - 1) / kGq) * ((hc + 8 * NB - 1) / (8 * NB));
  if (tiles > 65535) return cudaErrorInvalidValue;
  grouped_core_kernel<NB, T><<<dim3(n_cuboids, B * heads, (unsigned)tiles), kCoreThreads, smem,
                               stream>>>(q, k, v, bias, mask, out, in, ol, heads, vol, hc, scale);
  return cudaGetLastError();
}

// grouped_core_kernel over (B, n_cuboids, heads) with the given layouts: the
// output slice as wide as hc to a multiple of 8, at most 64 channels.  Rows
// are read 4 elements at a time: hc, every stride and the pointers are
// multiples of 4 elements (16 bytes in f32, 8 in bf16).
template <typename T>
cudaError_t core_launch(const T* q, const T* k, const T* v, const float* bias,
                        const unsigned char* mask, T* out, CoreLayout in, CoreLayout ol,
                        int B, int heads, int n_cuboids, int vol, int hc, float scale,
                        cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
  };
  if (B < 1 || heads < 1 || n_cuboids < 1 || vol < 1 || hc < 4 || hc % 4 || B * heads > 65535 ||
      (in.b | in.n | in.h | in.r) % 4 || (ol.b | ol.n | ol.h | ol.r) % 2 || !aligned(q) ||
      !aligned(k) || !aligned(v) || (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)))
    return cudaErrorInvalidValue;
  const int width = (hc + 7) / 8;
  if (width <= 1)
    return core_launch_nb<1>(q, k, v, bias, mask, out, in, ol, B, heads, n_cuboids, vol, hc,
                             scale, stream);
  if (width <= 2)
    return core_launch_nb<2>(q, k, v, bias, mask, out, in, ol, B, heads, n_cuboids, vol, hc,
                             scale, stream);
  if (width <= 4)
    return core_launch_nb<4>(q, k, v, bias, mask, out, in, ol, B, heads, n_cuboids, vol, hc,
                             scale, stream);
  return core_launch_nb<8>(q, k, v, bias, mask, out, in, ol, B, heads, n_cuboids, vol, hc, scale,
                           stream);
}

// A whole layer's backward, axial or general: the launches that give dx and,
// Full, every parameter gradient (the notes at the top of the file) around
// the layer's gradient core `core()`, which reads qkv and dattn and writes
// dqkv and, Full, the head outputs attn and `parts` partials of dbias
// (n_bias floats each).  Scratch, bf16: qkv (tokens, 3C), do_bf, dattn
// (tokens, C), dqkv (tokens, 3C); f32 dln (tokens, C).  Full adds attn
// (tokens, C) bf16, the width-major operands of the weight gradients ln_t,
// do_t, attn_t (C, ld) and dqkv_t (3C, ld), and the partials of dbias and of
// the vector gradients.  Past C = 768 (no LN tile) the LN rows go to do_bf
// first (free until the cotangent is staged) and the QKV product reads them
// by TMA.
template <bool Full, typename Core, typename XT>
cudaError_t layer_bwd_launches(
    const XT* x, const XT* g, const float* ln_w, const float* ln_b, const void* wqkv_map,
    const void* wprojt_map, const void* wqkvt_map, __nv_bfloat16* qkv, __nv_bfloat16* do_bf,
    __nv_bfloat16* dattn, __nv_bfloat16* dqkv, float* dln, XT* dx, __nv_bfloat16* attn,
    __nv_bfloat16* ln_t, __nv_bfloat16* do_t, __nv_bfloat16* attn_t, __nv_bfloat16* dqkv_t,
    float* dbias_part, int parts, size_t n_bias, float* vpart, float* dw_qkv, float* dbias,
    float* dw_proj, float* vec, int M, int C, int heads, int bn_qkv, int ld, int ws_qkv,
    int ws_proj, float scale, float eps, cudaStream_t stream, philox::Drop d_proj, Core core) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (C % 64 != 0 || C % heads != 0 || (bn_qkv != 128 && bn_qkv != 256) || !aligned(x) ||
      !aligned(ln_w) || !aligned(ln_b) || !aligned(qkv) || !aligned(do_bf) || !aligned(dattn) ||
      !aligned(dqkv) || !aligned(dln) || !aligned(dx) ||
      (Full && (ld % 64 || parts < 1 || !aligned(ln_t) || !aligned(do_t) || !aligned(attn_t) ||
                !aligned(dqkv_t))))
    return cudaErrorInvalidValue;
  // the bf16 form's dx takes the bf16 cotangent as the product's operand as
  // it is (no cast launch); the f32 forms and Full stage it in do_bf
  constexpr bool direct = sizeof(XT) == 2 && !Full;
  if (!aligned(g)) return cudaErrorInvalidValue;
  CUtensorMap wqkv, wprojt, wqkvt, do_map, g_map, dqkv_map;
  memcpy(&wqkv, wqkv_map, sizeof(wqkv));
  memcpy(&wprojt, wprojt_map, sizeof(wprojt));
  memcpy(&wqkvt, wqkvt_map, sizeof(wqkvt));
  int enc = hopper::encode_bf16_matrix(&do_map, do_bf, M, C, fwd::kBM);
  if (enc == 0) enc = hopper::encode_bf16_matrix(&dqkv_map, dqkv, M, 3 * C, fwd::kBM);
  if (enc == 0 && direct) enc = hopper::encode_bf16_matrix(&g_map, g, M, C, fwd::kBM);
  if (enc != 0) return (cudaError_t)enc;
  if (!direct) g_map = do_map;
  const philox::Drop none{};
  // q . scale, k, v (and LN(x)^T) recomputed in bf16 by the forward's product
  cudaError_t err;
  if (C <= 3 * 256) {
    err = fwd::qkv_gemm(bn_qkv, wqkv, x, ln_w, ln_b, qkv, M, C, scale, eps, stream,
                        Full ? ln_t : nullptr, ld);
  } else {
    ln_bf16_rows_kernel<XT><<<(M + kLnRowsPerBlock - 1) / kLnRowsPerBlock,
                              32 * kLnRowsPerBlock, 0, stream>>>(x, ln_w, ln_b, do_bf, M, C, eps);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = fwd::gemm<128, 0, false, true>(do_map, wqkv, nullptr, nullptr, nullptr, nullptr, qkv,
                                           M, 3 * C, C, C, scale, eps, none, stream);
    if (err == cudaSuccess && Full)
      err = gradk::cast_t<__nv_bfloat16>(do_bf, nullptr, ln_t, M, C, ld, stream);
  }
  if (err != cudaSuccess) return err;
  // do = g (. m_p / (1 - r_proj)) in bf16, as it is and (Full) width-major
  if (!direct) {
    err = gradk::cast_t<XT>(g, do_bf, Full ? do_t : nullptr, M, C, ld, stream, d_proj);
    if (err != cudaSuccess) return err;
  }
  // dattn = do . Wproj, bf16
  err = fwd::gemm<128, 0, false, true>(g_map, wprojt, nullptr, nullptr, nullptr, nullptr, dattn, M,
                                       C, C, 0, 1.f, eps, none, stream);
  if (err != cudaSuccess) return err;
  err = core();
  if (err != cudaSuccess) return err;
  // dln = dqkv . Wqkv, f32; dx its LayerNorm backward
  err = fwd::gemm<128, 0, false, false>(dqkv_map, wqkvt, nullptr, nullptr, nullptr, nullptr, dln, M,
                                        C, 3 * C, 0, 1.f, eps, none, stream);
  if (err != cudaSuccess) return err;
  err = ln_backward(x, ln_w, dln, dx, M, C, eps, stream);
  if constexpr (!Full) {
    return err;
  } else {
  if (err != cudaSuccess) return err;
  err = gradk::sum_partials(dbias_part, dbias, n_bias, parts, stream);
  if (err != cudaSuccess) return err;
  err = gradk::ln_vec_grads(x, g, dln, 1, vpart, vec, M, C, eps, stream, d_proj);  // dbproj = sum do
  if (err != cudaSuccess) return err;
  err = gradk::cast_t<__nv_bfloat16>(dqkv, nullptr, dqkv_t, M, 3 * C, ld, stream);
  if (err != cudaSuccess) return err;
  err = gradk::cast_t<__nv_bfloat16>(attn, nullptr, attn_t, M, C, ld, stream);
  if (err != cudaSuccess) return err;
  err = gradk::weight_grad(dqkv_t, ln_t, dw_qkv, 3 * C, C, M, ld, ws_qkv, stream);  // dqkv^T . LN
  if (err != cudaSuccess) return err;
  return gradk::weight_grad(do_t, attn_t, dw_proj, C, C, M, ld, ws_proj, stream);   // do^T . attn
  }
}

// The axial layer's backward: layer_bwd_launches around axial_core_bwd_kernel
// (blocks of cuboids_per_block cuboids, one dbias partial each).
template <bool Full, bool Drop, typename XT>
cudaError_t axial_bwd_launches(
    const XT* x, const XT* g, const float* ln_w, const float* ln_b, const void* wqkv_map,
    const float* bias, const void* wprojt_map, const void* wqkvt_map, __nv_bfloat16* qkv,
    __nv_bfloat16* do_bf, __nv_bfloat16* dattn, __nv_bfloat16* dqkv, float* dln, XT* dx,
    __nv_bfloat16* attn, __nv_bfloat16* ln_t, __nv_bfloat16* do_t, __nv_bfloat16* attn_t,
    __nv_bfloat16* dqkv_t, float* dbias_part, float* vpart, float* dw_qkv, float* dbias,
    float* dw_proj, float* vec, int B, int T, int H, int W, int C, int axis, int heads, int bn_qkv,
    int cuboids_per_block, int ld, int ws_qkv, int ws_proj, float scale, float eps,
    cudaStream_t stream, philox::Drop d_attn = philox::Drop{},
    philox::Drop d_proj = philox::Drop{0u, 0u, 0u, 1u, 0u, 1.f}) {
  static_assert(Full || !Drop, "dropout runs only on the all-gradients form");
  if (C % 64 != 0 || C % heads != 0 || axis < 0 || axis > 2 || cuboids_per_block < 1)
    return cudaErrorInvalidValue;
  const int M = B * T * H * W;
  const int vol = axis == 0 ? T : (axis == 1 ? H : W);
  const int hc = C / heads, n_cuboids = M / vol;
  const int blocks = (n_cuboids + cuboids_per_block - 1) / cuboids_per_block;
  const auto core = [&]() {
    const size_t smem = sizeof(float) * (4 * vol * (hc + 1) + (Full ? 3 : 2) * vol * vol);
    cudaError_t err = cudaFuncSetAttribute(axial_core_bwd_kernel<Full, Drop>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    axial_core_bwd_kernel<Full, Drop><<<dim3(blocks, heads), kCoreThreads, smem, stream>>>(
        qkv, dattn, bias, dqkv, attn, dbias_part, T, H, W, C, axis, heads, scale, n_cuboids,
        cuboids_per_block, d_attn);
    return cudaGetLastError();
  };
  return layer_bwd_launches<Full>(x, g, ln_w, ln_b, wqkv_map, wprojt_map, wqkvt_map, qkv, do_bf,
                                  dattn, dqkv, dln, dx, attn, ln_t, do_t, attn_t, dqkv_t,
                                  dbias_part, blocks, (size_t)heads * vol * vol, vpart, dw_qkv,
                                  dbias, dw_proj, vec, M, C, heads, bn_qkv, ld, ws_qkv, ws_proj,
                                  scale, eps, stream, d_proj, core);
}

// The general layer's backward: layer_bwd_launches around cuboid_core_bwd.
template <bool Full, bool Drop, typename XT = float>
cudaError_t cuboid_bwd_launches(
    const XT* x, const XT* g, const float* ln_w, const float* ln_b, const void* wqkv_map,
    const float* bias, const void* wprojt_map, const void* wqkvt_map, __nv_bfloat16* qkv,
    __nv_bfloat16* do_bf, __nv_bfloat16* dattn, __nv_bfloat16* dqkv, float* dln, XT* dx,
    __nv_bfloat16* attn, __nv_bfloat16* ln_t, __nv_bfloat16* do_t, __nv_bfloat16* attn_t,
    __nv_bfloat16* dqkv_t, float* stats, float* dbias_part, float* vpart, float* dw_qkv,
    float* dbias, float* dw_proj, float* vec, int n_cuboids, int vol, int C, int heads,
    int bn_qkv, int fused, int rows, int per_block, int ld, int ws_qkv, int ws_proj, float scale,
    float eps, cudaStream_t stream, philox::Drop d_attn = philox::Drop{},
    philox::Drop d_proj = philox::Drop{0u, 0u, 0u, 1u, 0u, 1.f}) {
  static_assert(Full || !Drop, "dropout runs only on the all-gradients form");
  if (C % 64 != 0 || C % heads != 0 || vol < 1 || n_cuboids < 1 || per_block < 1 ||
      (!fused && (reinterpret_cast<uintptr_t>(stats) & 15)))
    return cudaErrorInvalidValue;
  const int parts = fused ? (n_cuboids + per_block - 1) / per_block : n_cuboids;
  const auto core = [&]() {
    return cuboid_core_bwd<Full, Drop>(qkv, dattn, bias, dqkv, attn, stats, dbias_part, n_cuboids,
                                       vol, C, heads, fused, rows, per_block, scale, d_attn,
                                       stream);
  };
  return layer_bwd_launches<Full>(x, g, ln_w, ln_b, wqkv_map, wprojt_map, wqkvt_map, qkv, do_bf,
                                  dattn, dqkv, dln, dx, attn, ln_t, do_t, attn_t, dqkv_t,
                                  dbias_part, parts, (size_t)heads * vol * vol, vpart, dw_qkv,
                                  dbias, dw_proj, vec, n_cuboids * vol, C, heads, bn_qkv, ld,
                                  ws_qkv, ws_proj, scale, eps, stream, d_proj, core);
}

}  // namespace

// x, out (tokens, C) f32; wqkv_map / wproj_map the tensor maps of the bf16
// copies of w_qkv (3C, C) and w_proj (C, C) (bf16_matrix_map, boxes of
// bn_qkv and 128 rows); qkv (tokens, 3C) and attn (tokens, C) bf16 scratch.
extern "C" int axial_attention_forward(const float* x, const float* ln_w, const float* ln_b,
                                       const void* wqkv_map, const float* bias,
                                       const void* wproj_map, const float* b_proj, void* qkv,
                                       void* attn, float* out, int B, int T, int H, int W, int C,
                                       int axis, int heads, int bn_qkv, float scale, float eps,
                                       cudaStream_t stream) {
  return (int)forward_launches<false>(x, ln_w, ln_b, wqkv_map, bias, wproj_map, b_proj,
                                      static_cast<__nv_bfloat16*>(qkv),
                                      static_cast<__nv_bfloat16*>(attn), out, B, T, H, W, C, axis,
                                      heads, bn_qkv, scale, eps, stream);
}

// The bf16 form: x and out (tokens, C) bf16 (the LN rows widened as read, the
// projection + b_proj rounded once); the rest as axial_attention_forward.
extern "C" int axial_attention_forward_bf16(const __nv_bfloat16* x, const float* ln_w,
                                            const float* ln_b, const void* wqkv_map,
                                            const float* bias, const void* wproj_map,
                                            const float* b_proj, void* qkv, void* attn,
                                            __nv_bfloat16* out, int B, int T, int H, int W, int C,
                                            int axis, int heads, int bn_qkv, float scale,
                                            float eps, cudaStream_t stream) {
  return (int)forward_launches<false>(x, ln_w, ln_b, wqkv_map, bias, wproj_map, b_proj,
                                      static_cast<__nv_bfloat16*>(qkv),
                                      static_cast<__nv_bfloat16*>(attn), out, B, T, H, W, C, axis,
                                      heads, bn_qkv, scale, eps, stream);
}

// The layer with dropout on the attention weights (thr_attn, keep_attn =
// 1 - rate) and on the projected output (thr_proj, keep_proj); the masks are
// those of the stream (seed_lo, seed_hi, site), tensors 0 and 1, from the
// element bases base_attn and base_proj (multiples of 4, philox.cuh); a
// non-null seed_ptr is a device seed whose words the kernels read in place of
// seed_lo, seed_hi (philox.cuh).  Arguments as axial_attention_forward.
extern "C" int axial_attention_dropout_forward(
    const float* x, const float* ln_w, const float* ln_b, const void* wqkv_map, const float* bias,
    const void* wproj_map, const float* b_proj, void* qkv, void* attn, float* out, int B, int T,
    int H, int W, int C, int axis, int heads, int bn_qkv, float scale, float eps,
    const unsigned long long* seed_ptr, unsigned seed_lo, unsigned seed_hi, unsigned site,
    unsigned thr_attn, float keep_attn, unsigned thr_proj, float keep_proj,
    unsigned long long base_attn,
    unsigned long long base_proj, cudaStream_t stream) {
  const philox::Drop d_attn{seed_lo, seed_hi, site, 0u, thr_attn, keep_attn, base_attn >> 2,
                            seed_ptr};
  const philox::Drop d_proj{seed_lo, seed_hi, site, 1u, thr_proj, keep_proj, base_proj >> 2,
                            seed_ptr};
  return (int)forward_launches<true>(x, ln_w, ln_b, wqkv_map, bias, wproj_map, b_proj,
                                     static_cast<__nv_bfloat16*>(qkv),
                                     static_cast<__nv_bfloat16*>(attn), out, B, T, H, W, C, axis,
                                     heads, bn_qkv, scale, eps, stream, d_attn, d_proj);
}

// dx of the layer for the output cotangent g (tokens, C); wqkv_map the tensor
// map of the bf16 copy of w_qkv (boxes of bn_qkv rows), wprojt_map and
// wqkvt_map those of the bf16 transposes of w_proj (C, C) and w_qkv (C, 3C)
// (boxes of 128 rows); bf16 scratch qkv, dqkv (tokens, 3C), do_bf, dattn
// (tokens, C), f32 dln (tokens, C).  Six launches.
extern "C" int axial_attention_bwd_dx(const float* x, const float* g, const float* ln_w,
                                      const float* ln_b, const void* wqkv_map, const float* bias,
                                      const void* wprojt_map, const void* wqkvt_map, void* qkv,
                                      void* do_bf, void* dattn, void* dqkv, float* dln, float* dx,
                                      int B, int T, int H, int W, int C, int axis, int heads,
                                      int bn_qkv, float scale, float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return (int)axial_bwd_launches<false, false>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B,
      T, H, W, C, axis, heads, bn_qkv, 1, 0, 1, 1, scale, eps, stream);
}

// The bf16 form of axial_attention_bwd_dx: x, g and dx (tokens, C) bf16, g
// the dattn product's operand as it is (do_bf then unused but past C = 768,
// where it holds the LN rows); five launches.
extern "C" int axial_attention_bwd_dx_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                           const float* ln_w, const float* ln_b,
                                           const void* wqkv_map, const float* bias,
                                           const void* wprojt_map, const void* wqkvt_map,
                                           void* qkv, void* do_bf, void* dattn, void* dqkv,
                                           float* dln, __nv_bfloat16* dx, int B, int T, int H,
                                           int W, int C, int axis, int heads, int bn_qkv,
                                           float scale, float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return (int)axial_bwd_launches<false, false>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B,
      T, H, W, C, axis, heads, bn_qkv, 1, 0, 1, 1, scale, eps, stream);
}

// Every gradient of the layer for the output cotangent g.  Maps and scratch
// as axial_attention_bwd_dx, and attn (tokens, C) bf16; the weight
// gradients' width-major bf16 operands ln_t, do_t, attn_t (C, ld) and dqkv_t
// (3C, ld), ld >= tokens rounded up to 64; dbias_part (ceil(cuboids /
// cuboids_per_block), heads, vol, vol) and vpart (ceil(tokens / 8), 3, C)
// f32; ws_qkv, ws_proj the weight-gradient products' token splits.  Out: dx,
// dw_qkv (3C, C), dbias (heads, vol, vol), dw_proj (C, C), vec (3, C) =
// dgamma, dbeta, dbproj.
extern "C" int axial_attention_bwd_full(
    const float* x, const float* g, const float* ln_w, const float* ln_b, const void* wqkv_map,
    const float* bias, const void* wprojt_map, const void* wqkvt_map, void* qkv, void* do_bf,
    void* dattn, void* dqkv, float* dln, void* attn, void* ln_t, void* do_t, void* attn_t,
    void* dqkv_t, float* dbias_part, float* vpart, float* dx, float* dw_qkv, float* dbias,
    float* dw_proj, float* vec, int B, int T, int H, int W, int C, int axis, int heads,
    int bn_qkv, int cuboids_per_block, int ld, int ws_qkv, int ws_proj, float scale, float eps,
    cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return (int)axial_bwd_launches<true, false>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx,
      static_cast<bf*>(attn), static_cast<bf*>(ln_t), static_cast<bf*>(do_t),
      static_cast<bf*>(attn_t), static_cast<bf*>(dqkv_t), dbias_part, vpart, dw_qkv, dbias,
      dw_proj, vec, B, T, H, W, C, axis, heads, bn_qkv, cuboids_per_block, ld, ws_qkv, ws_proj,
      scale, eps, stream);
}

// Every gradient of axial_attention_dropout_forward for the output cotangent g,
// the masks regenerated from the same (seed, site).  Arguments as
// axial_attention_bwd_full; do_bf and do_t hold the dropped cotangent.
extern "C" int axial_attention_dropout_bwd_full(
    const float* x, const float* g, const float* ln_w, const float* ln_b, const void* wqkv_map,
    const float* bias, const void* wprojt_map, const void* wqkvt_map, void* qkv, void* do_bf,
    void* dattn, void* dqkv, float* dln, void* attn, void* ln_t, void* do_t, void* attn_t,
    void* dqkv_t, float* dbias_part, float* vpart, float* dx, float* dw_qkv, float* dbias,
    float* dw_proj, float* vec, int B, int T, int H, int W, int C, int axis, int heads,
    int bn_qkv, int cuboids_per_block, int ld, int ws_qkv, int ws_proj, float scale, float eps,
    const unsigned long long* seed_ptr, unsigned seed_lo, unsigned seed_hi, unsigned site,
    unsigned thr_attn, float keep_attn, unsigned thr_proj, float keep_proj,
    unsigned long long base_attn,
    unsigned long long base_proj, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const philox::Drop d_attn{seed_lo, seed_hi, site, 0u, thr_attn, keep_attn, base_attn >> 2,
                            seed_ptr};
  const philox::Drop d_proj{seed_lo, seed_hi, site, 1u, thr_proj, keep_proj, base_proj >> 2,
                            seed_ptr};
  return (int)axial_bwd_launches<true, true>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx,
      static_cast<bf*>(attn), static_cast<bf*>(ln_t), static_cast<bf*>(do_t),
      static_cast<bf*>(attn_t), static_cast<bf*>(dqkv_t), dbias_part, vpart, dw_qkv, dbias,
      dw_proj, vec, B, T, H, W, C, axis, heads, bn_qkv, cuboids_per_block, ld, ws_qkv, ws_proj,
      scale, eps, stream, d_attn, d_proj);
}

// The general cuboid layer on x in cuboid_reorder's layout (n_cuboids * vol
// tokens, C); wqkv_map / wproj_map the tensor maps of the bf16 copies of
// w_qkv (boxes of bn_qkv rows) and w_proj (128 rows); qkv (tokens, 3C) and
// attn (tokens, C) bf16 scratch; bias (heads, vol, vol); ln_tile, q_rows and
// key_tiles as ops/attention.cuboid_layer_plan gives them.
extern "C" int cuboid_attention_forward(const float* x, const float* ln_w, const float* ln_b,
                                        const void* wqkv_map, const float* bias,
                                        const void* wproj_map, const float* b_proj, void* qkv,
                                        void* attn, float* out, int n_cuboids, int vol, int C,
                                        int heads, int bn_qkv, int ln_tile, int q_rows,
                                        int key_tiles, float scale, float eps,
                                        cudaStream_t stream) {
  return (int)cuboid_forward_launches<false>(
      x, ln_w, ln_b, wqkv_map, bias, wproj_map, b_proj, static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), out, n_cuboids, vol, C, heads, bn_qkv, ln_tile, q_rows,
      key_tiles, scale, eps, stream);
}

// The bf16 form: x and out (tokens, C) bf16 (the LN rows widened as read, the
// projection + b_proj rounded once); the rest as cuboid_attention_forward.
extern "C" int cuboid_attention_forward_bf16(const __nv_bfloat16* x, const float* ln_w,
                                             const float* ln_b, const void* wqkv_map,
                                             const float* bias, const void* wproj_map,
                                             const float* b_proj, void* qkv, void* attn,
                                             __nv_bfloat16* out, int n_cuboids, int vol, int C,
                                             int heads, int bn_qkv, int ln_tile, int q_rows,
                                             int key_tiles, float scale, float eps,
                                             cudaStream_t stream) {
  return (int)cuboid_forward_launches<false>(
      x, ln_w, ln_b, wqkv_map, bias, wproj_map, b_proj, static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), out, n_cuboids, vol, C, heads, bn_qkv, ln_tile, q_rows,
      key_tiles, scale, eps, stream);
}

// The general cuboid layer with dropout on the attention weights and on the
// projected output (its (tokens, C) rows in cuboid_reorder's order): the masks
// of the stream (seed_lo, seed_hi, site), tensors 0 and 1, as
// axial_attention_dropout_forward.  Arguments as cuboid_attention_forward.
extern "C" int cuboid_attention_dropout_forward(
    const float* x, const float* ln_w, const float* ln_b, const void* wqkv_map, const float* bias,
    const void* wproj_map, const float* b_proj, void* qkv, void* attn, float* out, int n_cuboids,
    int vol, int C, int heads, int bn_qkv, int ln_tile, int q_rows, int key_tiles, float scale,
    float eps, const unsigned long long* seed_ptr, unsigned seed_lo, unsigned seed_hi,
    unsigned site, unsigned thr_attn, float keep_attn, unsigned thr_proj, float keep_proj,
    unsigned long long base_attn,
    unsigned long long base_proj, cudaStream_t stream) {
  const philox::Drop d_attn{seed_lo, seed_hi, site, 0u, thr_attn, keep_attn, base_attn >> 2,
                            seed_ptr};
  const philox::Drop d_proj{seed_lo, seed_hi, site, 1u, thr_proj, keep_proj, base_proj >> 2,
                            seed_ptr};
  return (int)cuboid_forward_launches<true>(
      x, ln_w, ln_b, wqkv_map, bias, wproj_map, b_proj, static_cast<__nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(attn), out, n_cuboids, vol, C, heads, bn_qkv, ln_tile, q_rows,
      key_tiles, scale, eps, stream, d_attn, d_proj);
}

// dx of the general cuboid layer for the output cotangent g (tokens, C), both
// in cuboid_reorder's layout; maps and bf16 scratch as axial_attention_bwd_dx,
// and stats (cuboids, heads, vol, 3) f32 for the split core; fused, rows as
// ops/attention.cuboid_bwd_plan gives them.  Six or seven launches.
extern "C" int cuboid_attention_bwd_dx(const float* x, const float* g, const float* ln_w,
                                       const float* ln_b, const void* wqkv_map, const float* bias,
                                       const void* wprojt_map, const void* wqkvt_map, void* qkv,
                                       void* do_bf, void* dattn, void* dqkv, float* dln,
                                       float* stats, float* dx, int n_cuboids, int vol, int C,
                                       int heads, int bn_qkv, int fused, int rows, float scale,
                                       float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return (int)cuboid_bwd_launches<false, false>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx, nullptr,
      nullptr, nullptr, nullptr, nullptr, stats, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, n_cuboids, vol, C, heads, bn_qkv, fused, rows, 1, 0, 1, 1, scale, eps, stream);
}

// The bf16 form of cuboid_attention_bwd_dx: x, g and dx (tokens, C) bf16, g
// the dattn product's operand as it is (do_bf then unused but past C = 768,
// where it holds the LN rows); one launch fewer.
extern "C" int cuboid_attention_bwd_dx_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                            const float* ln_w, const float* ln_b,
                                            const void* wqkv_map, const float* bias,
                                            const void* wprojt_map, const void* wqkvt_map,
                                            void* qkv, void* do_bf, void* dattn, void* dqkv,
                                            float* dln, float* stats, __nv_bfloat16* dx,
                                            int n_cuboids, int vol, int C, int heads, int bn_qkv,
                                            int fused, int rows, float scale, float eps,
                                            cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return (int)cuboid_bwd_launches<false, false>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx, nullptr,
      nullptr, nullptr, nullptr, nullptr, stats, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, n_cuboids, vol, C, heads, bn_qkv, fused, rows, 1, 0, 1, 1, scale, eps, stream);
}

// Every gradient of the general cuboid layer for the output cotangent g, both
// in cuboid_reorder's layout.  Maps, scratch and outputs as
// axial_attention_bwd_full, and stats (cuboids, heads, vol, 3); dbias_part
// (parts, heads, vol, vol) with parts = ceil(cuboids / per_block) where fused,
// else cuboids.
extern "C" int cuboid_attention_bwd_full(
    const float* x, const float* g, const float* ln_w, const float* ln_b, const void* wqkv_map,
    const float* bias, const void* wprojt_map, const void* wqkvt_map, void* qkv, void* do_bf,
    void* dattn, void* dqkv, float* dln, void* attn, void* ln_t, void* do_t, void* attn_t,
    void* dqkv_t, float* stats, float* dbias_part, float* vpart, float* dx, float* dw_qkv,
    float* dbias, float* dw_proj, float* vec, int n_cuboids, int vol, int C, int heads,
    int bn_qkv, int fused, int rows, int per_block, int ld, int ws_qkv, int ws_proj, float scale,
    float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  return (int)cuboid_bwd_launches<true, false>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx,
      static_cast<bf*>(attn), static_cast<bf*>(ln_t), static_cast<bf*>(do_t),
      static_cast<bf*>(attn_t), static_cast<bf*>(dqkv_t), stats, dbias_part, vpart, dw_qkv, dbias,
      dw_proj, vec, n_cuboids, vol, C, heads, bn_qkv, fused, rows, per_block, ld, ws_qkv, ws_proj,
      scale, eps, stream);
}

// Every gradient of cuboid_attention_dropout_forward for the output cotangent
// g, the masks regenerated from the same (seed, site).  Arguments as
// cuboid_attention_bwd_full; do_bf and do_t hold the dropped cotangent.
extern "C" int cuboid_attention_dropout_bwd_full(
    const float* x, const float* g, const float* ln_w, const float* ln_b, const void* wqkv_map,
    const float* bias, const void* wprojt_map, const void* wqkvt_map, void* qkv, void* do_bf,
    void* dattn, void* dqkv, float* dln, void* attn, void* ln_t, void* do_t, void* attn_t,
    void* dqkv_t, float* stats, float* dbias_part, float* vpart, float* dx, float* dw_qkv,
    float* dbias, float* dw_proj, float* vec, int n_cuboids, int vol, int C, int heads,
    int bn_qkv, int fused, int rows, int per_block, int ld, int ws_qkv, int ws_proj, float scale,
    float eps, const unsigned long long* seed_ptr, unsigned seed_lo, unsigned seed_hi,
    unsigned site, unsigned thr_attn, float keep_attn, unsigned thr_proj, float keep_proj,
    unsigned long long base_attn,
    unsigned long long base_proj, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const philox::Drop d_attn{seed_lo, seed_hi, site, 0u, thr_attn, keep_attn, base_attn >> 2,
                            seed_ptr};
  const philox::Drop d_proj{seed_lo, seed_hi, site, 1u, thr_proj, keep_proj, base_proj >> 2,
                            seed_ptr};
  return (int)cuboid_bwd_launches<true, true>(
      x, g, ln_w, ln_b, wqkv_map, bias, wprojt_map, wqkvt_map, static_cast<bf*>(qkv),
      static_cast<bf*>(do_bf), static_cast<bf*>(dattn), static_cast<bf*>(dqkv), dln, dx,
      static_cast<bf*>(attn), static_cast<bf*>(ln_t), static_cast<bf*>(do_t),
      static_cast<bf*>(attn_t), static_cast<bf*>(dqkv_t), stats, dbias_part, vpart, dw_qkv, dbias,
      dw_proj, vec, n_cuboids, vol, C, heads, bn_qkv, fused, rows, per_block, ld, ws_qkv, ws_proj,
      scale, eps, stream, d_attn, d_proj);
}

// The grouped core: q, k, v, out (B, heads, n_cuboids, vol, hc) f32, bias
// (heads, vol, vol), mask (n_cuboids, vol, vol) bytes or null.
extern "C" int cuboid_attention_grouped(const float* q, const float* k, const float* v,
                                        const float* bias, const unsigned char* mask,
                                        float* out, int B, int heads, int n_cuboids, int vol,
                                        int hc, float scale, cudaStream_t stream) {
  const long long row = hc, cub = (long long)vol * hc;
  const CoreLayout head_major{heads * n_cuboids * cub, cub, n_cuboids * cub, row};
  return (int)core_launch(q, k, v, bias, mask, out, head_major, head_major, B, heads, n_cuboids,
                          vol, hc, scale, stream);
}

// The bf16 form of the grouped core: q, k, v, out bf16 (widened as read, out
// rounded once), bias f32; the rest as cuboid_attention_grouped.
extern "C" int cuboid_attention_grouped_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                             const __nv_bfloat16* v, const float* bias,
                                             const unsigned char* mask, __nv_bfloat16* out,
                                             int B, int heads, int n_cuboids, int vol, int hc,
                                             float scale, cudaStream_t stream) {
  const long long row = hc, cub = (long long)vol * hc;
  const CoreLayout head_major{heads * n_cuboids * cub, cub, n_cuboids * cub, row};
  return (int)core_launch(q, k, v, bias, mask, out, head_major, head_major, B, heads, n_cuboids,
                          vol, hc, scale, stream);
}

// The round-1 core: q, k, v, out (B, n_cuboids, heads, vol, hc) f32, bias
// (heads, vol, vol), mask (n_cuboids, vol, vol) bytes or null.
extern "C" int cuboid_core_forward(const float* q, const float* k, const float* v,
                                   const float* bias, const unsigned char* mask, float* out, int B,
                                   int n_cuboids, int heads, int vol, int hc, float scale,
                                   cudaStream_t stream) {
  const long long row = hc, cub = (long long)vol * hc;
  const CoreLayout cuboid_major{n_cuboids * heads * cub, heads * cub, cub, row};
  return (int)core_launch(q, k, v, bias, mask, out, cuboid_major, cuboid_major, B, heads,
                          n_cuboids, vol, hc, scale, stream);
}

// The round-1 whole layer: x, out (B, n_cuboids, vol, C) f32; w_qkv (3C, C),
// w_proj (C, C) in PyTorch layout; bias (heads, vol, vol); stats (M, 2), qkv
// (M, 3C) and o (M, C) f32 workspaces, M = B * n_cuboids * vol.  Four
// launches: the LN statistics, LN + QKV, the core, the projection.
extern "C" int cuboid_layer_v3_forward(const float* x, const float* ln_w, const float* ln_b,
                                       const float* w_qkv, const float* bias,
                                       const float* w_proj, const float* b_proj, float* stats,
                                       float* qkv, float* o, float* out, int B, int n_cuboids,
                                       int vol, int C, int heads, float scale, float eps,
                                       cudaStream_t stream) {
  if (B < 1 || n_cuboids < 1 || vol < 1 || heads < 1 || C % heads != 0)
    return (int)cudaErrorInvalidValue;
  const int M = B * n_cuboids * vol, hc = C / heads;
  cudaError_t err = tf32_gemm<true>(x, w_qkv, nullptr, ln_w, ln_b,
                                    reinterpret_cast<float2*>(stats), qkv, M, 3 * C, C, eps,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const long long cub = (long long)vol;
  const CoreLayout in{n_cuboids * cub * 3 * C, cub * 3 * C, hc, 3LL * C};
  const CoreLayout ol{n_cuboids * cub * C, cub * C, hc, C};
  err = core_launch(qkv, qkv + C, qkv + 2 * C, bias, nullptr, o, in, ol, B, heads, n_cuboids, vol,
                    hc, scale, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)tf32_gemm<false>(o, w_proj, b_proj, nullptr, nullptr, nullptr, out, M, C, C, eps,
                               stream);
}
