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
// M * (9K + ceil(log2 N) + 11) = 6.0 M float32 operations (the exact
// bucket by a search), 0.09 us at 67 TFLOP/s: bound by bytes.  Both are
// far below the cost of a launch, so at such sizes the launch and the
// block's prologue set its time.
//
// Design.  The TPU kernel ran the correction on the VPU, the aggregate as
// a (BLOCK, K) x (K,) matvec and the bucket as a (BLOCK, N) compare-and-
// sum with one-hot matmul gathers.  Here one thread scores one row
// (grid-stride over rows; a warp's rows are one contiguous run of scores,
// bf16 rows read 16 bytes at a time where K allows).  The prologue is
// parallel and overlapped: every thread of a block issues its share of
// the cp.async copies of both tables into shared memory, then sums the K
// weights in k order itself, through L1 (so every thread holds the bits
// of one sum in k order, with no thread waited on), and runs its first
// row's T^C and A while the tables land.  The block then checks the staged source table
// once: __syncthreads_and over neighbour pairs says whether it is
// non-decreasing and free of NaN.  If it is, a row's bucket is search_le's
// ceil(log2 N) + 1 reads in shared memory, which on such a table equals
// the exact count; if not, the row keeps count_le, the count over every
// knot (csrc/quantile_knots.cuh).  So the bucket is the reference's on
// every table.  Scores are float32 or bfloat16, the math float32, the
// result in the scores' dtype.  The kernel is launched with programmatic
// dependent launch: it waits for the kernel before it before its first
// read of any input, and lets the next one launch once a block's rows are
// done.
//
// Order of operations, as the TPU kernel: c = (beta*y) / (1 - (1-beta)*y);
// a = sum_k c_k * (w_k / sum(w)); then the map, multiplying before it
// divides.  -fmad=false keeps every product and sum unfused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantile_knots.cuh"
#include "score_rows.cuh"

namespace {

using namespace quantile_knots;

constexpr int kThreads = 256;
constexpr int kMaxExperts = 256;

struct Params {
  const void* scores;
  const float* betas;
  const float* weights;
  const float* src;
  const float* ref;
  void* out;
  int64_t m;
  int k, n;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
score_pipeline_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [n], 16-byte aligned
  float* qr = qs + ((p.n + 3) & ~3);            // [n], 16-byte aligned
  const T* scores = static_cast<const T*>(p.scores);
  T* out = static_cast<T*>(p.out);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  score_rows::wait_for_previous_kernel();
  score_rows::copy_async(qs, p.src, 1, p.n, p.n);
  score_rows::copy_async(qr, p.ref, 1, p.n, p.n);
  score_rows::async_commit();
  // every thread sums w in k order itself (one sum's bits, no wait on one
  // thread), and its first row's T^C and A run while the tables land
  const float wsum = score_rows::weight_sum<false>(p.weights, p.k);
  float agg = first < p.m ? score_rows::aggregate<T, kVec>(
                                scores + first * p.k, p.betas, p.weights,
                                wsum, p.k)
                          : 0.0f;
  score_rows::async_wait<0>();
  __syncthreads();
  bool ok = true;
  for (int i = threadIdx.x; i < p.n; i += blockDim.x)
    ok &= sorted_at(qs, i, p.n);
  const bool sorted = __syncthreads_and(ok);
  for (int64_t row = first; row < p.m; row += stride) {
    if (row != first)
      agg = score_rows::aggregate<T, kVec>(
          scores + row * p.k, p.betas, p.weights, wsum, p.k);
    const int count =
        sorted ? search_le(agg, qs, p.n) : count_le(agg, qs, p.n);
    store(out + row, interpolate(agg, count, qs, qr, p.n));
  }
  score_rows::let_next_kernel_launch();
}

template <typename T, bool kVec>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const auto kernel = score_pipeline_kernel<T, kVec>;
  const size_t smem = sizeof(float) * 2 * size_t((p.n + 3) & ~3);
  int blocks = 0;
  const cudaError_t err =
      score_rows::resident_grid(kernel, kThreads, smem, p.m, &blocks);
  if (err != cudaSuccess) return err;
  return score_rows::launch_pdl(kernel, blocks, kThreads, smem, stream, p);
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
  const Params p{scores, static_cast<const float*>(betas),
                 static_cast<const float*>(weights),
                 static_cast<const float*>(src),
                 static_cast<const float*>(ref), out, int64_t(m), k, n};
  // bf16 rows, beta and w 16 bytes at a time where the rows are whole
  // 16-byte packs; float32 rows a float at a time (the 16-byte form of the
  // float32 kernel cost ptxas a spill around the divisions and bought no
  // time)
  const bool vec = k % 8 == 0 && score_rows::aligned16(scores) &&
                   score_rows::aligned16(betas) &&
                   score_rows::aligned16(weights);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      !is_bf16 ? launch<float, false>(p, s)
               : vec ? launch<__nv_bfloat16, true>(p, s)
                     : launch<__nv_bfloat16, false>(p, s);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

extern "C" const char* score_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
