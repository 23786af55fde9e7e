// The T^Q step (paper Eq. 4) shared by csrc/quantile_map.cu and
// csrc/score_pipeline.cu, on one (N,) table pair staged in shared memory:
//
//     j   = clip(#{n : s >= qs[n]} - 1, 0, N-2)
//     out = clip(qr[j] + ((s - qs[j]) * (qr[j+1] - qr[j])) / d, qr[0], qr[N-1])
//     d   = qs[j+1] - qs[j] if that is > 0, else 1
//
// The bucket is the exact count over every knot, not a binary search: it
// gives the reference's index on ties, on unsorted tables and on NaN (no
// comparison holds -> count 0 -> index 0) with nothing to prove.  Every
// lane of a warp reads the same knot at once, a broadcast with no bank
// conflict, four knots to a 16-byte read.  The map multiplies before it
// divides, as the TPU kernels do; the plain version takes the slope first,
// which differs in the last bits and not at all on a knot (s - qs[j] = 0).
// The clip is written with comparisons: fminf/fmaxf would drop a NaN,
// which the reference (jnp.clip / torch.clamp) propagates.  Built with
// -fmad=false, so no multiply-add is contracted.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype_io.cuh"

namespace quantile_knots {

// The most knots a table may have: two tables of float32 in shared memory
// stay under the 48 KB a block gets without opting in.
constexpr int kMaxKnots = 4096;

// Stage ``n`` knots of each table into shared memory; the caller syncs.
// ``qs`` must be 16-byte aligned (it is read as float4).
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      const float* __restrict__ ref,
                                      float* qs, float* qr, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    qs[i] = src[i];
    qr[i] = ref[i];
  }
}

// #{i : s >= qs[i]} over the ``n`` knots in shared memory.
__device__ __forceinline__ int count_le(float s, const float* qs, int n) {
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  int count = 0;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    const float4 q = qs4[i >> 2];
    count += int(s >= q.x) + int(s >= q.y) + int(s >= q.z) + int(s >= q.w);
  }
  for (; i < n; ++i) count += int(s >= qs[i]);
  return count;
}

// T^Q of one float32 value against the staged tables.
__device__ __forceinline__ float map_score(float s, const float* qs,
                                           const float* qr, int n) {
  int j = count_le(s, qs, n) - 1;
  j = j < 0 ? 0 : j;
  j = j > n - 2 ? n - 2 : j;
  const float qs_i = qs[j];
  const float qs_n = qs[j + 1];
  const float qr_i = qr[j];
  const float qr_n = qr[j + 1];
  const float diff = qs_n - qs_i;
  const float denom = diff > 0.0f ? diff : 1.0f;
  float v = qr_i + ((s - qs_i) * (qr_n - qr_i)) / denom;
  const float lo = qr[0];
  const float hi = qr[n - 1];
  v = v < lo ? lo : v;  // a NaN v fails both tests and stays NaN
  v = v > hi ? hi : v;
  return v;
}

}  // namespace quantile_knots
