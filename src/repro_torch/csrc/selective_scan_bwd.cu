// Backward of the Mamba (S6) selective scan for Hopper (sm_90a), diagonal A.
// The forward (csrc/selective_scan.cu) is, with abar_t = exp(dt_t * A) and
// u_t = dt_t * x_t,
//
//     h_t[b,c,n] = abar_t[b,c,n] * h_{t-1}[b,c,n] + u_t[b,c] * Bm_t[b,n]
//     y_t[b,c]   = sum_n h_t[b,c,n] * Cm_t[b,n]
//
// With g_t the whole gradient into h_t, walking t from T-1 down to 0:
//
//     g_t    = dy_t * Cm_t + carry       (carry = dh_T at T-1, else
//                                          abar_{t+1} * g_{t+1})
//     dCm_t  = sum_c dy_t * h_t          dBm_t = sum_c g_t * u_t
//     du_t   = sum_n g_t * Bm_t          q_t   = (g_t * h_{t-1}) * abar_t
//     ddt_t  = du_t * x_t + sum_n q_t * A    dx_t = du_t * dt_t
//     dA    += q_t * dt_t (over b and t)     dh0  = the carry after t = 0
//
// The JAX package has no kernel for it: its scan is XLA (src/repro/models/
// mamba.py:148-165, chunk_step) and jax.value_and_grad differentiates it.
// This kernel is the port's counterpart of that autodiff, for the scan the
// port runs on the card.
//
// What bounds it on an H100 SXM (published rates, 700 W power limit): at
// jamba-1.5-large's training shape (B = 4, T = 2,048, C = 16,384, N = 16)
// it must read dt, x and dy and write ddt and dx, each (B, T, C) float32:
// 2.68 GB, 0.80 ms at 3.35 TB/s; Bm, Cm, A, the checkpoints (134 MB) and the
// small outputs add under 6%.  Its exponentials, one per (b, t, c, n),
// 2.15 G, take 0.51 ms on the special-function units.  So the bytes bound
// it (benchmarks/timing.py, selective_scan_bwd_bound).
//
// Design (a simple first form).  One thread owns one (b, c) lane, as in the
// forward, and walks the tiles of 64 steps in reverse.  For each tile it
// recomputes the tile's states from the checkpoint the forward wrote at the
// tile's start (h_chunks), op for op as the forward, into a per-thread
// array in local memory, then walks the tile backward with its N-entry
// carry, its row of A and its dA sums in registers.  Every sum is taken in
// a fixed order, with no atomics, so the result does not change from run
// to run and the plain version (kernels/ref.py::selective_scan_backward)
// repeats it op for op:
//
//   * du and sum_n q * A: n in order, per thread;
//   * dA: per thread over t from T-1 down to 0, into a (B, C, N) partial;
//   * dCm and dBm sum over the 16,384 channels: each step, the block's 128
//     lanes put their 2N terms in shared memory; thread (j, q) sums term j
//     over the 32 channels [32q, 32q + 32) in channel order, and the four
//     quarters are added in order into the block's partial, (B, blocks, T,
//     2N).
//
// A second launch, selective_scan_bwd_reduce_kernel, sums the partials:
// dCm and dBm over the blocks in block order, dA over b in order.
// The arithmetic is compiled with -fmad=false, as the forward's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kChunk = 64;      // steps between checkpoints (the forward's tile)
constexpr int kQuarter = 32;    // channels a thread sums for dBm and dCm
constexpr int kPad = kThreads + 1;   // shared row stride: no bank conflicts
constexpr int kMaxState = 16;
constexpr int kReduceThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ dt,
                          const float* __restrict__ x,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          const float* __restrict__ h_chunks,
                          const float* __restrict__ dy,
                          const float* __restrict__ dh_t,
                          float* __restrict__ ddt, float* __restrict__ dx,
                          float* __restrict__ dh0,
                          float* __restrict__ dbc_part,
                          float* __restrict__ da_part, int t_len,
                          int c_len) {
  __shared__ float sb[kChunk * N];
  __shared__ float sc[kChunk * N];
  __shared__ float terms[2][2 * N][kPad];   // [parity][j][lane]: j < N dCm
  __shared__ float quarters[2][4][2 * N];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < c_len;
  const int64_t lane = int64_t(b) * c_len + c;      // (b, c) of the states
  const int64_t rows = int64_t(b) * t_len;          // row (b, 0) of (B, T)
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  float av[N], carry[N], da[N], h_start[N];
  float hist[kChunk][N];                            // a tile's states
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[int64_t(c) * N + n] : 0.0f;
    carry[n] = (live && dh_t != nullptr) ? dh_t[lane * N + n] : 0.0f;
    da[n] = 0.0f;
  }
  int parity = 0;
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int steps = min(kChunk, t_len - t0);
    __syncthreads();   // every reader of the last tile's Bm and Cm is done
    for (int i = tid; i < steps * N; i += kThreads) {
      sb[i] = bm[(rows + t0) * N + i];
      sc[i] = cm[(rows + t0) * N + i];
    }
    __syncthreads();
    if (live) {   // the tile's states, recomputed as the forward computed them
      const float* hc = h_chunks + ((int64_t(b) * n_chunks + k) * c_len + c) * N;
      float h[N];
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = h_start[n] = hc[n];
      int64_t off = (rows + t0) * c_len + c;
      for (int s = 0; s < steps; ++s, off += c_len) {
        const float d = dt[off], u = d * x[off];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float abar = expf(d * av[n]);
          h[n] = abar * h[n] + u * sb[s * N + n];
          hist[s][n] = h[n];
        }
      }
    }
    for (int s = steps - 1; s >= 0; --s) {
      const int t = t0 + s;
      if (live) {
        const int64_t off = (rows + t) * c_len + c;
        const float d = dt[off], xv = x[off], gy = dy[off];
        const float u = d * xv;
        float du = 0.0f, sq = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float h_cur = hist[s][n];
          const float h_prev = s > 0 ? hist[s - 1][n] : h_start[n];
          const float abar = expf(d * av[n]);
          const float g = gy * sc[s * N + n] + carry[n];
          terms[parity][n][tid] = gy * h_cur;
          terms[parity][N + n][tid] = g * u;
          const float gb = g * sb[s * N + n];
          du = n == 0 ? gb : du + gb;
          const float q = (g * h_prev) * abar;
          const float qa = q * av[n];
          sq = n == 0 ? qa : sq + qa;
          da[n] = da[n] + q * d;
          carry[n] = abar * g;
        }
        ddt[off] = du * xv + sq;
        dx[off] = du * d;
      } else {
#pragma unroll
        for (int j = 0; j < 2 * N; ++j) terms[parity][j][tid] = 0.0f;
      }
      __syncthreads();
      const int j = tid % kQuarter, quarter = tid / kQuarter;
      if (j < 2 * N) {
        const float* row = &terms[parity][j][quarter * kQuarter];
        float acc = row[0];
        for (int i = 1; i < kQuarter; ++i) acc = acc + row[i];
        quarters[parity][quarter][j] = acc;
      }
      __syncthreads();
      if (tid < 2 * N) {
        float v = quarters[parity][0][tid] + quarters[parity][1][tid];
        v = v + quarters[parity][2][tid];
        v = v + quarters[parity][3][tid];
        dbc_part[((int64_t(b) * gridDim.x + blockIdx.x) * t_len + t) * 2 * N +
                 tid] = v;
      }
      parity ^= 1;   // the next step writes the other buffers
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      da_part[lane * N + n] = da[n];
      if (dh0 != nullptr) dh0[lane * N + n] = carry[n];
    }
  }
}

// dCm and dBm: (b, t, j) sums its blocks' partials in block order; dA: (c, n)
// sums its batch rows' partials in row order.
__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce_kernel(const float* __restrict__ dbc_part,
                                 const float* __restrict__ da_part,
                                 float* __restrict__ dbm,
                                 float* __restrict__ dcm,
                                 float* __restrict__ da, int batch, int t_len,
                                 int c_len, int n, int blocks) {
  const int64_t i = int64_t(blockIdx.x) * kReduceThreads + threadIdx.x;
  const int64_t per_row = int64_t(t_len) * 2 * n;   // (t, j) of one b
  const int64_t bc_items = batch * per_row;
  if (i < bc_items) {
    const int64_t b = i / per_row, r = i % per_row;
    const float* p = dbc_part + b * blocks * per_row + r;
    float acc = p[0];
    for (int k = 1; k < blocks; ++k) acc = acc + p[k * per_row];
    const int64_t t = r / (2 * n);
    const int j = int(r % (2 * n));
    if (j < n) {
      dcm[(b * t_len + t) * n + j] = acc;
    } else {
      dbm[(b * t_len + t) * n + j - n] = acc;
    }
    return;
  }
  const int64_t e = i - bc_items;   // (c, n) of dA
  const int64_t lanes = int64_t(c_len) * n;
  if (e >= lanes) return;
  float acc = da_part[e];
  for (int b = 1; b < batch; ++b) acc = acc + da_part[b * lanes + e];
  da[e] = acc;
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bm,
                   const float* cm, const float* a, const float* h_chunks,
                   const float* dy, const float* dh_t, float* ddt, float* dx,
                   float* dh0, float* dbc_part, float* da_part, int batch,
                   int t_len, int c_len, cudaStream_t stream) {
  const dim3 grid((c_len + kThreads - 1) / kThreads, batch);
  selective_scan_bwd_kernel<N><<<grid, kThreads, 0, stream>>>(
      dt, x, bm, cm, a, h_chunks, dy, dh_t, ddt, dx, dh0, dbc_part, da_part,
      t_len, c_len);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, const float*, const float*,
                                 const float*, const float*, const float*,
                                 const float*, const float*, float*, float*,
                                 float*, float*, float*, int, int, int,
                                 cudaStream_t);

constexpr Launcher kLaunchers[kMaxState] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

extern "C" int selective_scan_bwd_blocks(int c_len) {
  return (c_len + kThreads - 1) / kThreads;
}

// Plain C entry points, loaded with ctypes.  Each launches on ``stream``
// (PyTorch's current stream), allocates nothing, does not synchronise, and
// returns the launch's cudaError_t (0 = success).  The caller has checked
// that every array is float32, contiguous and on one card: dt, x, dy, ddt,
// dx (B, T, C); bm, cm (B, T, N); a (C, N); h_chunks (B, ceil(T/64), C, N),
// as the forward wrote it; dh_t (B, C, N) or null for zeros; dh0 (B, C, N)
// or null when no one needs it; dbc_part (B, blocks, T, 2N) and da_part
// (B, C, N) scratch, blocks = selective_scan_bwd_blocks(C).
// 1 <= n <= 16, every size >= 1, B within a grid.
extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* x, const void* bm, const void* cm,
    const void* a, const void* h_chunks, const void* dy, const void* dh_t,
    void* ddt, void* dx, void* dh0, void* dbc_part, void* da_part, int batch,
    int t_len, int c_len, int n, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || c_len < 1 || n < 1 ||
      n > kMaxState)
    return int(cudaErrorInvalidValue);
  return int(kLaunchers[n - 1](
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h_chunks),
      static_cast<const float*>(dy), static_cast<const float*>(dh_t),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(dh0), static_cast<float*>(dbc_part),
      static_cast<float*>(da_part), batch, t_len, c_len,
      static_cast<cudaStream_t>(stream)));
}

// The second launch: dbm, dcm (B, T, N) and da (C, N) from the partials of
// selective_scan_bwd_launch on the same stream.
extern "C" int selective_scan_bwd_reduce_launch(
    const void* dbc_part, const void* da_part, void* dbm, void* dcm, void* da,
    int batch, int t_len, int c_len, int n, void* stream) {
  if (batch < 1 || t_len < 1 || c_len < 1 || n < 1 || n > kMaxState)
    return int(cudaErrorInvalidValue);
  const int64_t items =
      int64_t(batch) * t_len * 2 * n + int64_t(c_len) * n;
  const int64_t grid = (items + kReduceThreads - 1) / kReduceThreads;
  if (grid > 0x7fffffff) return int(cudaErrorInvalidValue);
  selective_scan_bwd_reduce_kernel<<<unsigned(grid), kReduceThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dbc_part), static_cast<const float*>(da_part),
      static_cast<float*>(dbm), static_cast<float*>(dcm),
      static_cast<float*>(da), batch, t_len, c_len, n,
      selective_scan_bwd_blocks(c_len));
  return int(cudaGetLastError());
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
