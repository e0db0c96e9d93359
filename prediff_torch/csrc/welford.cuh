// Welford's running (count, mean, M2) and Chan's merge of two of them, for
// the GroupNorm kernels (groupnorm.cu, resblock.cu): no E[x^2] - E[x]^2, so
// no cancellation when |mean| >> std.  Internal linkage, as every header here.
#pragma once
#include <cuda_runtime.h>

namespace {

struct Stat {
  float n, mean, m2;
};

__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  float n = a.n + b.n;
  if (b.n == 0.f) return a;
  float d = b.mean - a.mean;
  float wb = b.n / n;
  Stat r;
  r.n = n;
  r.mean = a.mean + d * wb;
  r.m2 = a.m2 + b.m2 + d * d * a.n * wb;
  return r;
}

__device__ __forceinline__ Stat shfl_down(Stat s, int o) {
  return Stat{__shfl_down_sync(0xffffffffu, s.n, o), __shfl_down_sync(0xffffffffu, s.mean, o),
              __shfl_down_sync(0xffffffffu, s.m2, o)};
}

// v added to s.
__device__ __forceinline__ void push(Stat& s, float v) {
  s.n += 1.f;
  const float d = v - s.mean;
  s.mean += d / s.n;
  s.m2 += d * (v - s.mean);
}

}  // namespace
