// Quantile map T^Q (paper Eq. 4) for Hopper (sm_90a), one shared table pair:
//
//     out[i] = T^Q(scores[i])   against (N,) knots qs (source), qr (reference)
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quantile_map.py:25
// (function _quantile_map_kernel, wrapper quantile_map).
//
// What bounds it on an H100: at the benchmark's 65,536 float32 scores and
// N = 256 it moves 0.53 MB (each score read once, each result written
// once, both tables once), 0.16 us at 3.35 TB/s, and does M * (N + 10) =
// 17.4 M float32 operations, 0.26 us at 67 TFLOP/s: the N-wide count of
// the bucket makes it, formally, bound by operations.  Both are far below
// the cost of a launch, so at such sizes the launch sets its time.
//
// Design, the simple one.  The TPU kernel found the bucket with a
// (BLOCK, N) compare-and-sum and gathered the four knots with a one-hot
// matmul, because the TPU lacks cheap indexed loads.  Here one thread maps
// one score (grid-stride over scores, coalesced loads and stores); each
// block stages both tables in shared memory once; the bucket is the exact
// count of quantile_knots.cuh (N broadcast compares a score), and the four
// knots are direct loads from shared memory.  Scores are float32 or
// bfloat16, the math float32, the result in the scores' dtype.
//
// What the simple design leaves on the table: the count costs N compares a
// score where a search over sorted knots costs log N; it is kept because it
// is the reference's index on ties, unsorted tables and NaN by
// construction.  Each block re-reads the tables from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantile_knots.cuh"

namespace {

using namespace quantile_knots;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident blocks on each of 132 SMs

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantile_map_kernel(const T* __restrict__ scores,
                    const float* __restrict__ src,
                    const float* __restrict__ ref, T* __restrict__ out,
                    int64_t m, int n) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [n], 16-byte aligned
  float* qr = qs + n;                           // [n]
  stage(src, ref, qs, qr, n);
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    store(out + i, map_score(to_f32(scores[i]), qs, qr, n));
  }
}

template <typename T>
cudaError_t launch(const void* scores, const void* src, const void* ref,
                   void* out, long long m, int n, cudaStream_t stream) {
  const long long wanted = (m + kThreads - 1) / kThreads;
  const int blocks = int(wanted < kMaxBlocks ? wanted : kMaxBlocks);
  const size_t smem = sizeof(float) * 2 * size_t(n);
  quantile_map_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(scores), static_cast<const float*>(src),
      static_cast<const float*>(ref), static_cast<T*>(out), int64_t(m), n);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream`` (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = success).  The caller has checked shapes, dtypes
// (scores float32 or bfloat16, tables float32), contiguity, m >= 1 and
// 2 <= n <= 4096.
extern "C" int quantile_map_launch(const void* scores, const void* src,
                                   const void* ref, void* out, long long m,
                                   int n, int is_bf16, void* stream) {
  if (m < 1 || n < 2 || n > kMaxKnots) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(scores, src, ref, out, m, n, s)
              : launch<float>(scores, src, ref, out, m, n, s);
  return int(err);
}

extern "C" const char* quantile_map_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
