// Eq. 2 score pipeline for Hopper (sm_90a), one shared parameter set:
//
//     out[i] = T^Q( A( [T^C_k(y_ik)]_k ) )
//     T^C_k(y) = beta_k*y / (1 - (1-beta_k)*y),  A(c) = sum_k c_k * w_k / sum(w)
//
// Replaces the Pallas TPU kernel of src/repro/kernels/score_pipeline.py:57
// (function _score_pipeline_kernel, wrapper score_pipeline).  Its banked
// sibling, csrc/score_pipeline_banked.cu, takes a per-row parameter set.
//
// What bounds it on an H100: at the benchmark's 65,536 x 8 float32 scores
// and N = 256 it moves 2.4 MB (each score read once, each result written
// once, the parameters once), 0.70 us at 3.35 TB/s, and does
// M * (9K + N + 10) = 22.1 M float32 operations, 0.33 us at 67 TFLOP/s:
// bound by bytes.  Both are far below the cost of a launch, so at such
// sizes the launch sets its time.
//
// Design, the simple one.  The TPU kernel ran the correction on the VPU,
// the aggregate as a (BLOCK, K) x (K,) matvec and the bucket as a
// (BLOCK, N) compare-and-sum with one-hot matmul gathers.  Here one thread
// scores one row (grid-stride over rows; a warp's rows are one contiguous
// run of scores).  Each block stages beta, the normalised weights
// w / sum(w) (the sum in k order) and both tables in shared memory once.
// A row's correction and aggregate run in k order in float32 registers;
// T^Q is the exact count and interpolation of quantile_knots.cuh.  Scores
// are float32 or bfloat16, the math float32, the result in the scores'
// dtype.
//
// Order of operations, as the TPU kernel: c = (beta*y) / (1 - (1-beta)*y);
// a = sum_k c_k * (w_k / sum(w)); then the map, multiplying before it
// divides.  -fmad=false keeps every product and sum unfused.
//
// What the simple design leaves on the table: as quantile_map.cu, N
// compares a row for the bucket, and a thread's K loads are strided (the
// warp's loads still cover whole lines, served from L1 after the first).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantile_knots.cuh"

namespace {

using namespace quantile_knots;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs
constexpr int kMaxExperts = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_pipeline_kernel(const T* __restrict__ scores,
                      const float* __restrict__ betas,
                      const float* __restrict__ weights,
                      const float* __restrict__ src,
                      const float* __restrict__ ref, T* __restrict__ out,
                      int64_t m, int k, int n) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [n], 16-byte aligned
  float* qr = qs + n;                           // [n]
  float* beta = qr + n;                         // [k]
  float* wn = beta + k;                         // [k]  w / sum(w)
  stage(src, ref, qs, qr, n);
  for (int e = threadIdx.x; e < k; e += blockDim.x) beta[e] = betas[e];
  if (threadIdx.x == 0) {
    float wsum = 0.0f;
    for (int e = 0; e < k; ++e) wsum += weights[e];
    for (int e = 0; e < k; ++e) wn[e] = weights[e] / wsum;
  }
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; row < m;
       row += stride) {
    const T* y = scores + row * k;
    float agg = 0.0f;
    for (int e = 0; e < k; ++e) {
      const float b = beta[e];
      const float ye = to_f32(y[e]);
      const float c = (b * ye) / (1.0f - (1.0f - b) * ye);
      agg += c * wn[e];
    }
    store(out + row, map_score(agg, qs, qr, n));
  }
}

template <typename T>
cudaError_t launch(const void* scores, const void* betas, const void* weights,
                   const void* src, const void* ref, void* out, long long m,
                   int k, int n, cudaStream_t stream) {
  const long long wanted = (m + kThreads - 1) / kThreads;
  const int blocks = int(wanted < kMaxBlocks ? wanted : kMaxBlocks);
  const size_t smem = sizeof(float) * (2 * size_t(n) + 2 * size_t(k));
  score_pipeline_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(scores), static_cast<const float*>(betas),
      static_cast<const float*>(weights), static_cast<const float*>(src),
      static_cast<const float*>(ref), static_cast<T*>(out), int64_t(m), k,
      n);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream`` (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = success).  The caller has checked shapes, dtypes
// (scores float32 or bfloat16, parameters float32), contiguity, m >= 1,
// 1 <= k <= 256 and 2 <= n <= 4096.
extern "C" int score_pipeline_launch(const void* scores, const void* betas,
                                     const void* weights, const void* src,
                                     const void* ref, void* out, long long m,
                                     int k, int n, int is_bf16,
                                     void* stream) {
  if (m < 1 || k < 1 || k > kMaxExperts || n < 2 || n > kMaxKnots)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(scores, betas, weights, src, ref, out,
                                      m, k, n, s)
              : launch<float>(scores, betas, weights, src, ref, out, m, k, n,
                              s);
  return int(err);
}

extern "C" const char* score_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
