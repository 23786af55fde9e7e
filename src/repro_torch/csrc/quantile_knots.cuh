// The T^Q step (paper Eq. 4) shared by csrc/quantile_map.cu,
// csrc/score_pipeline.cu and csrc/score_pipeline_banked.cu, on one (N,)
// table pair:
//
//     c   = #{n : s >= qs[n]}
//     j   = clip(c - 1, 0, N-2)
//     out = clip(qr[j] + ((s - qs[j]) * (qr[j+1] - qr[j])) / d, qr[0], qr[N-1])
//     d   = qs[j+1] - qs[j] if that is > 0, else 1
//     out = qr[N-1] where c = N
//
// count_le is the exact count over every knot: it gives the reference's
// index on ties, on unsorted tables and on NaN (no comparison holds ->
// count 0 -> index 0) with nothing to prove.  Every lane of a warp reads
// the same knot at once, a broadcast with no bank conflict, four knots to
// a 16-byte read.  search_le gives the same count in ceil(log2 N) + 1
// reads, but only on a table that is non-decreasing and free of NaN; its
// callers prove that of the table first (see search_le).  The map
// multiplies before it divides, as the TPU kernels do; the plain version
// takes the slope first, which differs in the last bits and not at all on
// a knot (s - qs[j] = 0).  The clip is written with comparisons:
// fminf/fmaxf would drop a NaN, which the reference (jnp.clip /
// torch.clamp) propagates.  Built with -fmad=false, so no multiply-add is
// contracted.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dtype_io.cuh"

namespace quantile_knots {

// The most knots a table may have: two tables of float32 in shared memory
// stay under the 48 KB a block gets without opting in.
constexpr int kMaxKnots = 4096;

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

// #{i : s >= qs[i]} over a table of ``n`` knots that is non-decreasing and
// holds no NaN.  The knots at or below s are then a prefix, and the loop
// keeps its length c in [base, base + len]: probing knot base + half
// either moves base there (c > base + half) or cuts len (c <= base +
// half), until len is 1 and one more compare settles c.  The trip count
// depends on n alone, so a warp never diverges.  A NaN s fails every
// compare and gives 0, as count_le does.
__device__ __forceinline__ int search_le(float s, const float* qs, int n) {
  int base = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
    base = s >= qs[base + half] ? base + half : base;
    len -= half;
  }
  return base + int(s >= qs[base]);
}

// Whether knots [i, i + 1] of a table of ``n`` keep it non-decreasing and
// free of NaN (for i = n - 1, whether knot i is a number); a table is
// sorted for search_le when this holds for every i.
__device__ __forceinline__ bool sorted_at(const float* qs, int i, int n) {
  const float q = qs[i];
  return i + 1 < n ? q <= qs[i + 1] : q == q;
}

// T^Q of s given its count of knots at or below it (count_le or
// search_le), on tables in shared or global memory.  A score at or past
// every knot (count n, read before j is clamped) maps to exactly qr[n-1]:
// interpolating the last segment there can round one ulp below it, where
// an edge-padded table's flat segment gives it exactly, so padding changes
// no bit at the last knot either.  That is a select at the end, not an
// early return: the warp stays on one path, and qr[n-1] is loaded for the
// clip anyway.  A NaN s counts 0 and is interpolated to NaN.
__device__ __forceinline__ float interpolate(float s, int count,
                                             const float* qs,
                                             const float* qr, int n) {
  int j = count - 1;
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
  return count == n ? hi : v;
}

}  // namespace quantile_knots
