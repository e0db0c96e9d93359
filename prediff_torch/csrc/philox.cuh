// Dropout masks from a counter-based generator: Philox4x32-10 (Salmon et al.,
// SC'11) written out by hand, the same function as
// prediff_torch/ops/dropout.py computes in integer tensor arithmetic.
//
// Replaces the TPU kernels' stateful per-core generator
// (prediff_tpu/ops/pallas_ffn.py::_keep_mask / seed_prng), which seeds once
// per grid cell and so ties a mask to the tiling.  Here a mask is a pure
// function of logical coordinates:
//   keep(element) = philox(key = seed words,
//                          counter = (q low, q high, tensor, site)
//                          )[element % 4] >= thr,   q = (base + element) / 4
// so a forward kernel and its backward regenerate the same mask whatever
// their grids, and nothing is stored.  `base` is the element base of the
// tensor a kernel is handed within the logical tensor of the whole batch (a
// rank's first batch row times the elements of a row; 0 on one process); it
// is a multiple of 4, so element % 4 picks the same word of a block as it
// would at base 0, and the kernels carry it as q0 = base / 4.  Kept values are divided by 1 - rate
// (`keep`), as the TPU kernels do.  thr == 0 keeps everything and draws nothing.
//
// The seed words come as kernel arguments (a host seed), or from device
// memory (a device seed: `key`, one int64 holding the two words, low first),
// which each kernel that takes a Drop reads once when it starts (`load_key`),
// before any draw: a captured CUDA graph then draws the masks of whatever seed
// the buffer holds at each replay.  The words are the same either way, so
// are the masks.
#pragma once
#include <cuda_runtime.h>

namespace philox {

struct Drop {
  unsigned k0, k1;   // the seed's low and high word
  unsigned site;     // the module call within the forward
  unsigned tensor;   // which mask of that call
  unsigned thr;      // keep when the draw >= thr
  float keep;        // 1 - rate
  unsigned long long q0 = 0ull;   // the element base / 4: the block of local element 0
  const unsigned long long* key = nullptr;   // a device seed, or null: k0, k1 as given
};

// k0, k1 from the device seed, where there is one: the first statement of
// every kernel that takes a Drop by value (one 8-byte load, L2-resident).
__device__ __forceinline__ void load_key(Drop& d) {
  if (d.key != nullptr) {
    const unsigned long long s = *d.key;
    d.k0 = (unsigned)s;
    d.k1 = (unsigned)(s >> 32);
  }
}

__device__ __forceinline__ uint4 philox4x32_10(unsigned k0, unsigned k1, uint4 c) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// The draw of logical element `e` of the stream (seed, site, tensor).
__device__ __forceinline__ unsigned draw(const Drop& d, unsigned long long e) {
  const unsigned long long q = (e >> 2) + d.q0;
  const uint4 w = philox4x32_10(d.k0, d.k1,
                                make_uint4((unsigned)q, (unsigned)(q >> 32), d.tensor, d.site));
  const unsigned lane = (unsigned)e & 3u;
  return lane == 0 ? w.x : (lane == 1 ? w.y : (lane == 2 ? w.z : w.w));
}

// v through the dropout of element e: v / keep when kept, else 0.
__device__ __forceinline__ float apply(const Drop& d, unsigned long long e, float v) {
  if (d.thr == 0u) return v;
  return draw(d, e) >= d.thr ? v / d.keep : 0.f;
}

// v0, v1 through the dropout of elements e and e + 1, e even: both draws
// come from one Philox block (elements 4q .. 4q + 3), computed once.
__device__ __forceinline__ void apply2(const Drop& d, unsigned long long e, float& v0, float& v1) {
  if (d.thr == 0u) return;
  const unsigned long long q = (e >> 2) + d.q0;
  const uint4 w = philox4x32_10(d.k0, d.k1,
                                make_uint4((unsigned)q, (unsigned)(q >> 32), d.tensor, d.site));
  const bool hi = (e & 2ull) != 0ull;
  v0 = (hi ? w.z : w.x) >= d.thr ? v0 / d.keep : 0.f;
  v1 = (hi ? w.w : w.y) >= d.thr ? v1 / d.keep : 0.f;
}

// The four draws of elements 4q .. 4q + 3 (q = e / 4): one whole Philox block.
__device__ __forceinline__ uint4 block(const Drop& d, unsigned long long e) {
  const unsigned long long q = (e >> 2) + d.q0;
  return philox4x32_10(d.k0, d.k1, make_uint4((unsigned)q, (unsigned)(q >> 32), d.tensor, d.site));
}

// v[0..7] through the dropout of elements e .. e + 7, e % 4 == 0: two blocks,
// each drawn once and all four of its words used.
__device__ __forceinline__ void apply8(const Drop& d, unsigned long long e, float (&v)[8]) {
  if (d.thr == 0u) return;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const uint4 w = block(d, e + 4 * b);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * b + k] = u[k] >= d.thr ? v[4 * b + k] / d.keep : 0.f;
  }
}

// The draws of an mma accumulator's element pairs: lanes L (L even) and
// L ^ 1 of a warp hold columns (2c, 2c + 1) and (2c + 2, 2c + 3) of one
// Philox block, 2c % 4 == 0, in two rows A and B (elements eA, eA + 1 and eB,
// eB + 1 of the lane itself).  Each lane of the pair draws one whole block (L
// row A's, L ^ 1 row B's) and hands the half its partner needs across the
// pair: every block is drawn once.  wa / wb: the lane's two draws in rows A
// and B.  The whole warp calls it.
__device__ __forceinline__ void draw_rows2(const Drop& d, unsigned long long eA,
                                           unsigned long long eB, unsigned (&wa)[2],
                                           unsigned (&wb)[2]) {
  const bool odd = (threadIdx.x & 1) != 0;
  const uint4 w = block(d, odd ? eB : eA);
  // the even lane keeps row A's (x, y) and sends (z, w); the odd lane keeps
  // row B's (z, w) and sends (x, y)
  const unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  wa[0] = odd ? r0 : w.x;
  wa[1] = odd ? r1 : w.y;
  wb[0] = odd ? w.z : r0;
  wb[1] = odd ? w.w : r1;
}

}  // namespace philox
