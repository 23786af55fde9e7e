// Quantile map T^Q (paper Eq. 4) for Hopper (sm_90a), one shared table pair:
//
//     out[i] = T^Q(scores[i])   against (N,) knots qs (source), qr (reference)
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quantile_map.py:25
// (function _quantile_map_kernel, wrapper quantile_map).
//
// What bounds it on an H100: at the benchmark's 65,536 float32 scores and
// N = 256 it moves 0.53 MB (each score read once, each result written
// once, both tables once), 0.157 us at 3.35 TB/s.  The exact bucket needs
// a search over the sorted knots, about M * (ceil(log2 N) + 11) = 1.2 M
// float32 operations, 0.019 us at 67 TFLOP/s: bound by bytes.  Both are
// far below the cost of a launch, so at such sizes the launch and the
// block's prologue set its time.
//
// Design.  The TPU kernel found the bucket with a (BLOCK, N) compare-and-
// sum and gathered the four knots with a one-hot matmul, because the TPU
// lacks cheap indexed loads.  Here a thread maps one score per turn of a
// grid-stride loop over blocks of 256 threads.  The prologue is parallel
// and overlapped: every thread issues its share of the cp.async copies of
// both tables into shared memory, then loads its first score while they
// land.  The block then checks the staged source table once:
// __syncthreads_and over neighbour pairs (quantile_knots.cuh, sorted_at)
// says whether it is non-decreasing and free of NaN.  If it is, the bucket
// is search_le's ceil(log2 N) + 1 reads in shared memory, which on such a
// table equals the exact count; if not, each score keeps count_le, the
// count over every knot.  So the bucket is the reference's on every table,
// ties, flat runs, unsorted tables and NaN included.  The map is
// quantile_knots.cuh's interpolate: multiply before divide, clip by
// comparisons, NaN kept; -fmad=false keeps every product and sum unfused.
// Scores are float32 or bfloat16, the math float32, the result in the
// scores' dtype.
//
// Scores a thread.  At the benchmark's 65,536 scores a thread's chain of
// dependent shared-memory reads (the search, then the interpolation and
// its division) is the kernel's critical path after the launch and the
// prologue, and a 16-byte pack of 4 or 8 scores a thread makes that chain
// longer.  One score a thread gives 256 blocks, so each of the 132 SMs
// maps at most 512 scores, each thread one.  Packs were measured on an
// H100 (PERF.md) and were slower from 1,024 to 65,536 scores in
// both dtypes; they gained 3-5% only past 262,144 scores, a size no path
// of the port sends, so the kernel has one width.  The grid is capped at
// the blocks the card keeps resident (score_rows::resident_grid): a larger
// input loops.  The kernel is launched with programmatic dependent launch:
// it waits for the kernel before it before its first read of any input,
// and lets the next one launch once a block's scores are done.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantile_knots.cuh"
#include "score_rows.cuh"

namespace {

using namespace quantile_knots;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantile_map_kernel(const T* __restrict__ scores,
                    const float* __restrict__ src,
                    const float* __restrict__ ref, T* __restrict__ out,
                    int64_t m, int n) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [n], 16-byte aligned
  float* qr = qs + ((n + 3) & ~3);              // [n], 16-byte aligned
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  score_rows::wait_for_previous_kernel();
  score_rows::copy_async(qs, src, 1, n, n);
  score_rows::copy_async(qr, ref, 1, n, n);
  score_rows::async_commit();
  // the first score loads while the tables land
  float x = 0.0f;
  if (first < m) x = to_f32(scores[first]);
  score_rows::async_wait<0>();
  __syncthreads();
  bool ok = true;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ok &= sorted_at(qs, i, n);
  const bool sorted = __syncthreads_and(ok);
  for (int64_t i = first; i < m; i += stride) {
    if (i != first) x = to_f32(scores[i]);
    const int count = sorted ? search_le(x, qs, n) : count_le(x, qs, n);
    store(out + i, interpolate(x, count, qs, qr, n));
  }
  score_rows::let_next_kernel_launch();
}

template <typename T>
cudaError_t launch(const void* scores, const void* src, const void* ref,
                   void* out, long long m, int n, cudaStream_t stream) {
  const auto kernel = quantile_map_kernel<T>;
  const size_t smem = sizeof(float) * 2 * size_t((n + 3) & ~3);
  int blocks = 0;
  const cudaError_t err =
      score_rows::resident_grid(kernel, kThreads, smem, m, &blocks);
  if (err != cudaSuccess) return err;
  return score_rows::launch_pdl(kernel, blocks, kThreads, smem, stream,
                                static_cast<const T*>(scores),
                                static_cast<const float*>(src),
                                static_cast<const float*>(ref),
                                static_cast<T*>(out), int64_t(m), n);
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
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

extern "C" const char* quantile_map_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
