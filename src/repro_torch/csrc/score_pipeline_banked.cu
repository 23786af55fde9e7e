// Banked (tenant-indexed) Eq. 2 score pipeline for Hopper (sm_90a):
//
//     out[i] = T^Q_t( A_t( [T^C_tk(y_ik)]_k ) ),   t = tenant_idx[i]
//
// Replaces the Pallas TPU kernel of src/repro/kernels/score_pipeline.py,
// function _score_pipeline_banked_kernel (wrapper score_pipeline_banked).
//
// What bounds it on an H100: bytes.  Per row it reads K scores and one id
// and writes one float; the bank (T x (2K + 2N) floats, 8.65 MB at T=4096,
// K=8, N=256) is read from device memory about once and then served from
// the 50 MB L2.  The arithmetic is ~6K + N + 12 flops a row, far below the
// card's rate, so the least time is the bytes moved over 3.35 TB/s.
//
// Design.  The TPU kernel gathered each row's parameters with a one-hot
// (BLOCK, T) matmul and found the bucket with an N-wide compare-and-sum,
// because the TPU lacks cheap indexed loads.  Here one warp scores one row
// (grid-stride over rows): every lane loads the row's id, beta and w
// directly; the bucket is the exact count #{n : a >= qs[t, n]}, lane l
// comparing knots l, l+32, ... and the warp summing __popc(__ballot_sync).
// The count gives the reference's index on ties, on unsorted tables and on
// NaN (no comparison holds -> count 0 -> index 0) with no search to prove.
// Lane 0 then loads the four knots and interpolates.  The knot reads of a
// warp are one coalesced 128-byte line per 32 knots, from L2.
//
// Numerics follow the plain version op for op: c = beta*y / (1-(1-beta)*y),
// wn = w / sum(w) with the sum in k order, a = sum_k c_k*wn_k in k order,
// out = qr_j + (a - qs_j)*(qr_j+1 - qr_j)/d.  Build with -fmad=false so no
// multiply-add is contracted into an FMA.  The final clip is written with
// comparisons: fminf/fmaxf would drop a NaN aggregate, which the reference
// (jnp.clip / torch.clamp) propagates.
//
// Out-of-range ids: a row whose id lies outside [0, T) reads no bank memory
// and scores NaN.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
score_pipeline_banked_kernel(const float* __restrict__ scores,
                             const int32_t* __restrict__ tenant_idx,
                             const float* __restrict__ betas,
                             const float* __restrict__ weights,
                             const float* __restrict__ src,
                             const float* __restrict__ ref,
                             float* __restrict__ out,
                             int64_t m, int k, int t, int n) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int64_t stride = (int64_t(gridDim.x) * blockDim.x) / kWarp;
  for (int64_t row = first; row < m; row += stride) {
    const int tid = tenant_idx[row];  // same address on every lane: uniform
    if (tid < 0 || tid >= t) {
      if (lane == 0) out[row] = __int_as_float(0x7fc00000);  // quiet NaN
      continue;
    }
    // --- T^C and A: per-row correction and self-normalizing average
    const float* y = scores + row * k;
    const float* beta = betas + int64_t(tid) * k;
    const float* w = weights + int64_t(tid) * k;
    float wsum = 0.0f;
    for (int e = 0; e < k; ++e) wsum += w[e];
    float agg = 0.0f;
    for (int e = 0; e < k; ++e) {
      const float b = beta[e];
      const float ye = y[e];
      const float c = (b * ye) / (1.0f - (1.0f - b) * ye);
      agg += c * (w[e] / wsum);
    }
    // --- T^Q bucket: exact count of knots <= agg across the warp
    const float* qs = src + int64_t(tid) * n;
    int count = 0;
    for (int base = 0; base < n; base += kWarp) {
      const int i = base + lane;
      const bool ge = i < n && agg >= qs[i];
      count += __popc(__ballot_sync(kFullMask, ge));
    }
    if (lane == 0) {
      int j = count - 1;
      j = j < 0 ? 0 : j;
      j = j > n - 2 ? n - 2 : j;
      const float* qr = ref + int64_t(tid) * n;
      const float qs_i = qs[j];
      const float qs_n = qs[j + 1];
      const float qr_i = qr[j];
      const float qr_n = qr[j + 1];
      const float diff = qs_n - qs_i;
      const float denom = diff > 0.0f ? diff : 1.0f;
      float v = qr_i + ((agg - qs_i) * (qr_n - qr_i)) / denom;
      const float lo = qr[0];
      const float hi = qr[n - 1];
      v = v < lo ? lo : v;  // a NaN v fails both tests and stays NaN
      v = v > hi ? hi : v;
      out[row] = v;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream`` (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = success).  The caller has checked shapes, types,
// contiguity and 0 < m, 1 <= k, 1 <= t, 2 <= n.
extern "C" int score_pipeline_banked_launch(
    const void* scores, const void* tenant_idx, const void* betas,
    const void* weights, const void* src, const void* ref, void* out,
    long long m, int k, int t, int n, void* stream) {
  const int threads = kWarp * kWarpsPerBlock;
  const long long wanted = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = int(wanted < (1LL << 20) ? wanted : (1LL << 20));
  score_pipeline_banked_kernel<<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores),
      static_cast<const int32_t*>(tenant_idx),
      static_cast<const float*>(betas), static_cast<const float*>(weights),
      static_cast<const float*>(src), static_cast<const float*>(ref),
      static_cast<float*>(out), int64_t(m), k, t, n);
  return int(cudaGetLastError());
}

extern "C" const char* score_pipeline_banked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
