// Banked (tenant-indexed) Eq. 2 score pipeline for Hopper (sm_90a):
//
//     out[i] = T^Q_t( A_t( [T^C_tk(y_ik)]_k ) ),   t = tenant_idx[i]
//
// Replaces the Pallas TPU kernel of src/repro/kernels/score_pipeline.py,
// function _score_pipeline_banked_kernel (wrapper score_pipeline_banked).
//
// What bounds it on an H100: bytes.  Per row it reads K scores and one id
// and writes one float; the bank (T x (2K + 2N) floats: 137 KB at T=64,
// K=8, N=256; 8.65 MB at T=4,096) is read from device memory about once
// and then served from the 50 MB L2.  The arithmetic is ~9K + N + 10
// flops a row, far below the card's rate, so the least time is the bytes
// moved over 3.35 TB/s.
//
// Design.  The TPU kernel gathered each row's parameters with a one-hot
// (BLOCK, T) matmul and found the bucket with an N-wide compare-and-sum,
// because the TPU lacks cheap indexed loads.  Here one thread scores one
// row, in a persistent grid that strides over the rows; a warp's 32 rows
// are one contiguous run of scores.  A row's beta and w are read through
// L1 (a tenant's few floats serve every row of it on the SM) and its
// weights summed in k order; scores, beta and w are read 16 bytes at a
// time where K is a multiple of 4.  The host picks one of two kernels
// from T, N, the number of rows and the card
// (kernels/score_pipeline.py::banked_path), one launch either way:
//
// * banked_shared_kernel, when the bank's tables fit the card's opt-in
//   shared memory per block and the rows are enough (a few hundred an SM)
//   to pay for each block's copy: each block of 512 threads copies both in
//   once, one TMA bulk copy a table row (the blocks starting at different
//   rows), while its first rows run T^C and A.  A warp a table then
//   proves which tenants' source tables are non-decreasing and free of
//   NaN.  A row on such a table takes search_le's ceil(log2 N) + 1 reads
//   in shared memory; a row on any other table counts every knot
//   (count_le).  The table rows are padded to an odd number of 16-byte
//   quads, so the 8 lanes of one 16-byte read phase, on 8 consecutive
//   tenants as in an interleaved window, hit 8 different bank groups.
// * banked_global_kernel, for a larger bank or fewer rows: the tables
//   stay in L1/L2.  A warp takes up to 32 rows (fewer where the rows are
//   too few to fill the card, down to one) and each lane runs T^C and A
//   for its row; then the warp counts its rows' buckets together, 4 rows
//   at a time, lane l comparing knots 4l..4l+3, 4l+128.. of each
//   (coalesced 512-byte reads, two of each row in flight), and one
//   __reduce_add_sync a row.
//
// Why each bucket is the exact count #{n : a >= qs[t, n]}, the
// reference's own definition, on every table: count_le and the warp's
// count are that count, compare by compare (ties, unsorted tables, NaN
// knots; a NaN aggregate fails every compare and counts 0).  search_le
// runs only on a table the block has just proved non-decreasing and free
// of NaN; there the knots at or below a are a prefix, and the search
// returns its length, the same count (csrc/quantile_knots.cuh), NaN
// aggregate included.
//
// Numerics follow the plain version op for op: c = beta*y / (1-(1-beta)*y),
// wn = w / sum(w) with the sum in k order, a = sum_k c_k*wn_k in k order,
// out = qr_j + (a - qs_j)*(qr_j+1 - qr_j)/d (csrc/score_rows.cuh,
// csrc/quantile_knots.cuh).  Built with -fmad=false so no multiply-add is
// contracted.  The final clip is written with comparisons, so a NaN
// aggregate stays NaN as in the reference.
//
// Out-of-range ids: a row whose id lies outside [0, T) reads no bank
// memory and scores NaN.
//
// Both kernels are launched with programmatic dependent launch: each waits
// for the kernel before it before its first read of any input, and lets
// the next one launch once a block's rows are done.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quantile_knots.cuh"
#include "score_rows.cuh"

namespace {

using quantile_knots::count_le;
using quantile_knots::interpolate;
using quantile_knots::search_le;
using score_rows::aggregate;

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSharedThreads = 512;
constexpr int kGlobalThreads = 256;
constexpr int kRowsInFlight = 4;  // rows a warp counts at once (global path)

struct Bank {
  const float* scores;
  const int32_t* ids;
  const float* betas;
  const float* weights;
  const float* src;
  const float* ref;
  float* out;
  int64_t m;
  int k, t, n;
};

// Floats a table row takes in shared memory: N rounded up to whole 16-byte
// quads, plus one quad where that count is even.
__host__ __device__ inline int padded_knots(int n) {
  const int quads = (n + 3) / 4;
  return 4 * (quads % 2 ? quads : quads + 1);
}

// The shared-bank kernel's dynamic shared memory: both tables (padded
// rows) and one sorted flag a tenant.  K does not enter: beta and w are
// read through L1.
__host__ __device__ inline size_t shared_bytes(int t, int n) {
  return sizeof(float) * size_t(t) * (2 * size_t(padded_knots(n)) + 1);
}

__device__ __forceinline__ int count_chunk(float a, float q) {
  return int(a >= q);
}
__device__ __forceinline__ int count_chunk(float a, const float4& q) {
  return int(a >= q.x) + int(a >= q.y) + int(a >= q.z) + int(a >= q.w);
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fc00000);
}

// T^C and A of ``row`` under bank row ``id`` (in range): beta and w read
// through L1, the weights' sum in k order, each term taking w_k / sum.
template <bool kVec>
__device__ __forceinline__ float row_aggregate(const Bank& p, int64_t row,
                                               int id) {
  const float* w = p.weights + int64_t(id) * p.k;
  return aggregate<float, kVec>(p.scores + row * p.k,
                                p.betas + int64_t(id) * p.k, w,
                                score_rows::weight_sum<kVec>(w, p.k), p.k);
}

// Whether the table of ``n`` knots at ``knots`` (16-byte aligned, padded
// to whole quads) is non-decreasing and free of NaN, by one warp: lane l
// takes quads l, l + 32, ... and the knot after each.
__device__ __forceinline__ bool warp_proves_sorted(const float* knots, int n,
                                                   int lane) {
  bool ok = true;
  for (int i = 4 * lane; i < n; i += 4 * kWarp) {
    const float4 q = *reinterpret_cast<const float4*>(knots + i);
    if (i + 4 < n) {
      ok &= (q.x <= q.y) & (q.y <= q.z) & (q.z <= q.w) & (q.w <= knots[i + 4]);
    } else {  // the table's last quad: pairs inside it, then the last knot
      const float x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < n)
          ok &= i + e + 1 < n ? x[e] <= x[e + 1] : x[e] == x[e];
    }
  }
  return __all_sync(kFullMask, ok);
}

template <bool kVec>
__global__ void __launch_bounds__(kSharedThreads)
banked_shared_kernel(Bank p) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t tables_in;  // the tables' bulk copies complete on it
  const int np = padded_knots(p.n);
  float* qs = reinterpret_cast<float*>(smem4);          // [t][np]
  float* qr = qs + p.t * np;                            // [t][np]
  int* sorted = reinterpret_cast<int*>(qr + p.t * np);  // [t]
  // whole 16-byte rows go by TMA bulk copies, one a row, else by cp.async
  // (cp.async for every table made the kernel 4% slower at 65,536 x 8,
  // T = 64 on the H100: PERF.md)
  const bool bulk = p.n % 4 == 0 && score_rows::aligned16(p.src) &&
                    score_rows::aligned16(p.ref);
  if (threadIdx.x == 0) score_rows::mbar_init(&tables_in, 1);
  score_rows::wait_for_previous_kernel();
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  int64_t row = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int tid = row < p.m ? __ldg(p.ids + row) : -1;
  if (bulk) {
    const uint32_t row_bytes = sizeof(float) * p.n;
    if (threadIdx.x == 0)
      score_rows::mbar_expect_bytes(&tables_in, 2 * p.t * row_bytes);
    __syncthreads();  // the barrier is set before any copy completes on it
    // each block starts at its own row, so the blocks' first requests
    // spread over the L2 instead of all asking for row 0
    for (int i = threadIdx.x; i < 2 * p.t; i += blockDim.x) {
      const int r = (i + 2 * int(blockIdx.x)) % (2 * p.t);
      const int tenant = r >> 1;
      score_rows::bulk_copy((r & 1 ? qr : qs) + tenant * np,
                            (r & 1 ? p.ref : p.src) + int64_t(tenant) * p.n,
                            row_bytes, &tables_in);
    }
  } else {
    score_rows::copy_async(qs, p.src, p.t, p.n, np);
    score_rows::copy_async(qr, p.ref, p.t, p.n, np);
    score_rows::async_commit();
  }
  // the first row's T^C and A run while the tables land
  bool live = tid >= 0 && tid < p.t;
  float agg = live ? row_aggregate<kVec>(p, row, tid) : 0.0f;
  if (bulk) {
    score_rows::mbar_wait(&tables_in, 0);
  } else {
    score_rows::async_wait<0>();
    __syncthreads();
  }
  // which tenants' source tables are non-decreasing and free of NaN, a
  // warp a table
  const int lane = threadIdx.x % kWarp;
  for (int r = threadIdx.x / kWarp; r < p.t; r += blockDim.x / kWarp) {
    const bool ok = warp_proves_sorted(qs + r * np, p.n, lane);
    if (lane == 0) sorted[r] = ok;
  }
  __syncthreads();
  while (row < p.m) {
    float v = quiet_nan();
    if (live) {
      const float* s = qs + tid * np;
      const int count = sorted[tid] ? search_le(agg, s, p.n)
                                    : count_le(agg, s, p.n);
      v = interpolate(agg, count, s, qr + tid * np, p.n);
    }
    p.out[row] = v;
    row += stride;
    if (row < p.m) {
      tid = __ldg(p.ids + row);
      live = tid >= 0 && tid < p.t;
      agg = live ? row_aggregate<kVec>(p, row, tid) : 0.0f;
    }
  }
  score_rows::let_next_kernel_launch();
}

// The warp's count of knots at or below each live row's aggregate: lane r
// gets its own row's count.  ``todo`` (warp-uniform) marks the lanes whose
// rows have an id in range.  kRowsInFlight rows at a time, two reads of
// each in flight: 16 bytes a lane (kVecTables) or 4.
template <bool kVecTables>
__device__ __forceinline__ int warp_counts(unsigned todo, int tid, float agg,
                                           const float* __restrict__ src,
                                           int n, int lane) {
  using Chunk = typename std::conditional<kVecTables, float4, float>::type;
  constexpr int kPer = sizeof(Chunk) / sizeof(float);
  constexpr int kSpan = kPer * kWarp;  // knots a warp reads at once
  int mine = 0;
  while (todo) {
    int from[kRowsInFlight];
    const Chunk* qs[kRowsInFlight];
    float a[kRowsInFlight];
    int c[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      from[u] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      const int t_u = __shfl_sync(kFullMask, tid, from[u] & 31);
      a[u] = __shfl_sync(kFullMask, agg, from[u] & 31);
      qs[u] = reinterpret_cast<const Chunk*>(
                  src + int64_t(from[u] >= 0 ? t_u : 0) * n) + lane;
      c[u] = 0;
    }
    for (int i = kPer * lane; i < n; i += 2 * kSpan) {
      const bool second = i + kSpan < n;
      Chunk q[kRowsInFlight][2];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const bool live = from[u] >= 0;
        q[u][0] = live ? __ldg(qs[u]) : Chunk{};
        q[u][1] = live && second ? __ldg(qs[u] + kWarp) : Chunk{};
        qs[u] += 2 * kWarp;
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        c[u] += count_chunk(a[u], q[u][0]) +
                (second ? count_chunk(a[u], q[u][1]) : 0);
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int total = __reduce_add_sync(kFullMask, c[u]);
      if (lane == from[u]) mine = total;
    }
  }
  return mine;
}

template <bool kVec, bool kVecTables>
__global__ void __launch_bounds__(kGlobalThreads)
banked_global_kernel(Bank p, int rows_per_warp) {
  score_rows::wait_for_previous_kernel();
  const int lane = threadIdx.x % kWarp;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) /
                       kWarp;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x / kWarp *
                         rows_per_warp;
  // whole warps walk the rows, so every lane reaches every shuffle; lane l
  // takes the warp's row l, for l < rows_per_warp
  for (int64_t first = warp * rows_per_warp; first < p.m; first += stride) {
    const int64_t row = first + lane;
    const bool mine = lane < rows_per_warp && row < p.m;
    const int tid = mine ? __ldg(p.ids + row) : -1;
    const bool live = tid >= 0 && tid < p.t;
    const float agg = live ? row_aggregate<kVec>(p, row, tid) : 0.0f;
    const int count = warp_counts<kVecTables>(
        __ballot_sync(kFullMask, live), tid, agg, p.src, p.n, lane);
    if (mine) {
      float v = quiet_nan();
      if (live)
        v = interpolate(agg, count, p.src + int64_t(tid) * p.n,
                        p.ref + int64_t(tid) * p.n, p.n);
      p.out[row] = v;
    }
  }
  score_rows::let_next_kernel_launch();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of ``threads`` for ``m`` rows, at most as many as fit the card at
// once (a persistent grid).
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t smem, int64_t m,
                     int* grid) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t wanted = (m + threads - 1) / threads;
  const int64_t most = int64_t(per_sm) * sm_count();
  *grid = int(wanted < most ? wanted : most);
  return cudaSuccess;
}

cudaError_t launch_shared(const Bank& p, bool vec, cudaStream_t stream) {
  auto kernel = vec ? banked_shared_kernel<true> : banked_shared_kernel<false>;
  const size_t smem = shared_bytes(p.t, p.n);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = grid_for(kernel, kSharedThreads, smem, p.m, &grid);
  if (err != cudaSuccess) return err;
  return score_rows::launch_pdl(kernel, grid, kSharedThreads, smem, stream,
                                p);
}

cudaError_t launch_global(const Bank& p, bool vec, cudaStream_t stream) {
  const bool vec_tables = p.n % 4 == 0 && aligned16(p.src);
  auto kernel = vec ? (vec_tables ? banked_global_kernel<true, true>
                                  : banked_global_kernel<true, false>)
                    : (vec_tables ? banked_global_kernel<false, true>
                                  : banked_global_kernel<false, false>);
  // rows a warp takes: 32 once the rows fill about 16 warps an SM, fewer
  // below that, so a small window spreads over as many warps as it can
  const int64_t warps = 16LL * sm_count();
  const int64_t rows = (p.m + warps - 1) / warps;
  const int rows_per_warp = int(rows < kWarp ? rows : kWarp);
  const int threads = kGlobalThreads;
  int grid = 0;
  const cudaError_t err = grid_for(kernel, threads, 0,
                                   (p.m + rows_per_warp - 1) /
                                       rows_per_warp * kWarp,
                                   &grid);
  if (err != cudaSuccess) return err;
  return score_rows::launch_pdl(kernel, grid, threads, 0, stream, p,
                                rows_per_warp);
}

}  // namespace

// Bytes of shared memory the shared-bank kernel takes for a bank of T
// tables of N knots; kernels/score_pipeline.py::banked_shared_bytes
// computes the same.
extern "C" long long score_pipeline_banked_shared_bytes(int t, int n) {
  return static_cast<long long>(shared_bytes(t, n));
}

// Plain C entry point, loaded with ctypes.  Launches one kernel on
// ``stream`` (PyTorch's current stream): the shared-bank kernel for
// ``shared`` != 0, else the L1/L2 one.  Allocates nothing, does not
// synchronise, and returns the launch's cudaError_t (0 = success).  The
// caller has checked shapes, types, contiguity and 0 < m, 1 <= k, 1 <= t,
// 2 <= n, and for ``shared`` that the bank fits.
extern "C" int score_pipeline_banked_launch(
    const void* scores, const void* tenant_idx, const void* betas,
    const void* weights, const void* src, const void* ref, void* out,
    long long m, int k, int t, int n, int shared, void* stream) {
  const Bank p{static_cast<const float*>(scores),
               static_cast<const int32_t*>(tenant_idx),
               static_cast<const float*>(betas),
               static_cast<const float*>(weights),
               static_cast<const float*>(src),
               static_cast<const float*>(ref),
               static_cast<float*>(out),
               int64_t(m), k, t, n};
  // rows, beta and w 16 bytes at a time where K allows
  const bool vec = k % 4 == 0 && aligned16(scores) && aligned16(betas) &&
                   aligned16(weights);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      shared ? launch_shared(p, vec, s) : launch_global(p, vec, s);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

extern "C" const char* score_pipeline_banked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
