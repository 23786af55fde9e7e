// Selective scan of the Mamba (S6) mixer for Hopper (sm_90a), diagonal A:
//
//     h_t[b,c,n] = exp(dt[b,t,c] * A[c,n]) * h_{t-1}[b,c,n]
//                  + (dt[b,t,c] * x[b,t,c]) * Bm[b,t,n]
//     y[b,t,c]   = sum_n h_t[b,c,n] * Cm[b,t,n]        (n in order)
//
// from h_0 = h0 (or zeros), returning y and the last state h_T.  The JAX
// package has no Pallas kernel for it: its scan is XLA, a lax.scan over
// chunks with a lax.associative_scan inside each (src/repro/models/
// mamba.py:83-98, chunk_step :148-154, the decode step :210-215), which
// materialises the (B, Q, d_inner, N) states of a chunk to bound VMEM.  The
// CUDA form of the mixer fuses the scan so that no state reaches device
// memory, and so does this kernel.
//
// What bounds it on an H100 SXM (published rates, 700 W power limit): at
// jamba-1.5-large's prefill (B = 4, T = 2,048, C = d_inner = 16,384,
// N = 16) it must read dt and x and write y, each (B, T, C) float32,
// 1.61 GB (Bm, Cm, A and h_T add 6.3 MB): 0.483 ms at 3.35 TB/s.  It takes
// one exponential per (b, t, c, n), 2.15 G, on the special-function units
// (16 a clock an SM): 0.514 ms at 1.98 GHz.  So the exponentials bound it,
// just above the bytes (benchmarks/timing.py, selective_scan_bound).  Every
// element also costs about 14 float32 instructions (expf's range reduction
// around the SFU's exp2, the products and sums kept apart by -fmad=false),
// so the instruction slots put its floor near 0.9 ms.
//
// Design.  One thread owns one (b, c) lane and keeps its N states and its
// row of A in registers for the whole sequence, so no state is written
// until h_T; a block is 128 consecutive channels of one batch row, four
// blocks an SM, so jamba's shape (65,536 lanes) runs in one wave.  The
// sequence goes in chunks of kChunk = 16 steps.  Each chunk's dt and x
// (16 steps x 128 channels) and its Bm and Cm (shared by every channel of a
// (b, t)) are copied into shared memory by cp.async while the block
// computes on the chunk before (two buffers), so no step waits on device
// memory; a thread reads its dt and x there and a step's Bm and Cm 16 bytes
// a load (every thread the same address: a broadcast).  The 16 steps of a
// chunk run two at a time, so one step's exponentials overlap the last
// one's y chain.  The lanes' A, h0, checkpoints and h_T pass through
// shared memory, so device memory sees whole rows of N states; a decode
// step (T = 1) skips the staging, which measured slower there.
// (Splitting a lane's states over 2 or 4 threads, with y's sum passed
// between them by shuffles, measured slower on the card: the per-step
// work of loads, addresses and the chain is paid per 8 or 4 states
// instead of 16, and at 4 threads a lane the 32 registers that keep
// 2,048 threads an SM spill; PERF.md §6.)
//
// The arithmetic is the plain version's, op for op: expf (not __expf),
// dt * x once a step, then the product with Bm, h = abar * h + bx as a
// product and a sum (-fmad=false keeps every product and sum unfused), and
// y summed over n in n order.  So h_T is bitwise the plain version
// (kernels/ref.py::selective_scan).  N is a template parameter (1..16), so
// the state arrays stay in registers.  A decode step is T = 1; h0 and h_T
// may be the same array, since each block reads its lanes' states before
// it writes them.
//
// For training, the launch may also write the state at the start of every
// chunk (h0, or zeros, for the first) into h_chunks, a (B, ceil(T/16), C,
// N) array: the checkpoints from which csrc/selective_scan_bwd.cu
// recomputes a chunk's states in registers.  The serve path passes null
// and writes nothing more.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_staging.cuh"

namespace {

using scan::kChunk;
constexpr int kThreads = 128;   // channels a block, one a thread
constexpr int kMaxState = 16;

// One step of a lane: its states advanced by dt = d, u = dt * x and the
// step's Bm (bv) and Cm (cv); returns y.
template <int N>
__device__ __forceinline__ float step(float (&h)[N], const float (&av)[N],
                                      float d, float u, const float (&bv)[N],
                                      const float (&cv)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float abar = expf(d * av[n]);
    h[n] = abar * h[n] + u * bv[n];
  }
  float acc = h[0] * cv[0];
#pragma unroll
  for (int n = 1; n < N; ++n) acc = acc + h[n] * cv[n];
  return acc;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a, const float* h0,
                      float* __restrict__ y, float* h_out,
                      float* __restrict__ h_chunks, int t_len, int c_len) {
  // two chunks' dt and x, [buffer][dt, x][step][channel], and Bm then Cm
  // of each of their steps, [buffer][step][2N]; the block's states at a
  // checkpoint, [channel][n] (the states go through shared memory so that
  // device memory sees whole rows of N)
  __shared__ __align__(16) float s_in[2][2][kChunk][kThreads];
  __shared__ __align__(16) float s_bc[2][kChunk][2 * N];
  __shared__ __align__(16) float s_hc[kThreads * N];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kThreads, c = c0 + tid;
  const bool live = c < c_len;
  const int64_t lane = int64_t(b) * c_len + c;      // (b, c) of the states
  const int64_t rows = int64_t(b) * t_len;          // row (b, 0) of (B, T)
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  // 16-byte copies where C, N and the arrays allow them
  const bool vec_in = scan::vec_ok(dt, c_len) && scan::vec_ok(x, c_len);
  const bool vec_bc = N % 4 == 0 && scan::vec_ok(bm, N) && scan::vec_ok(cm, N);
  auto stage = [&](int k) {   // chunk k's inputs into buffer k & 1
    const int t0 = k * kChunk, steps = min(kChunk, t_len - t0);
    const int64_t first = (rows + t0) * c_len + c0;
    scan::copy_tile<kChunk, kThreads, kThreads, kThreads>(
        &s_in[k & 1][0][0][0], dt + first, c_len, steps, c_len - c0, 0,
        vec_in, tid);
    scan::copy_tile<kChunk, kThreads, kThreads, kThreads>(
        &s_in[k & 1][1][0][0], x + first, c_len, steps, c_len - c0, 0,
        vec_in, tid);
    const int64_t step0 = (rows + t0) * N;   // Bm and Cm of step t0
    scan::copy_tile<kChunk, N, 2 * N, kThreads>(
        &s_bc[k & 1][0][0], bm + step0, N, steps, N, 0, vec_bc, tid);
    scan::copy_tile<kChunk, N, 2 * N, kThreads>(
        &s_bc[k & 1][0][0], cm + step0, N, steps, N, N, vec_bc, tid);
    scan::commit();
  };
  // the block's rows of A and h0, read whole into s_in
  const int here = min(kThreads, c_len - c0);       // live lanes
  const int64_t state0 = (int64_t(b) * c_len + c0) * N;   // (b, c0, 0)
  float* const tile = &s_in[0][0][0][0];   // two [kThreads][N] tiles
  scan::copy_tile<kThreads, N, N, kThreads>(
      tile, a + int64_t(c0) * N, N, here, N, 0,
      N % 4 == 0 && scan::vec_ok(a, N), tid);
  if (h0 != nullptr) {
    scan::copy_tile<kThreads, N, N, kThreads>(
        tile + kThreads * N, h0 + state0, N, here, N, 0,
        N % 4 == 0 && scan::vec_ok(h0, N), tid);
  }
  scan::commit();
  scan::wait<0>();
  __syncthreads();
  float av[N], h[N];
  scan::load_row<N>(tile + tid * N, av);
  if (h0 != nullptr) {
    scan::load_row<N>(tile + (kThreads + tid) * N, h);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.0f;
  }
  __syncthreads();   // every row is read before s_in is staged over
  // h into s_hc, then (after a barrier) s_hc to `dst` in whole rows
  const bool vec_chunks = N % 4 == 0 && scan::vec_ok(h_chunks, N);
  auto put_states = [&]() {
#pragma unroll
    for (int n = 0; n < N; ++n) s_hc[tid * N + n] = h[n];
  };
  auto write_states = [&](float* dst, bool vec) {
    scan::store_tile<kThreads, N, kThreads>(dst, s_hc, N, here, N, vec, tid);
  };
  if (t_len == 1) {   // a decode step: one step, nothing worth staging
    if (h_chunks != nullptr) put_states();
    if (live) {
      float bv[N], cv[N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        bv[n] = bm[int64_t(b) * N + n];
        cv[n] = cm[int64_t(b) * N + n];
      }
      const float d = dt[lane];
      y[lane] = step<N>(h, av, d, d * x[lane], bv, cv);
    }
    __syncthreads();
    if (h_chunks != nullptr) {
      write_states(h_chunks + state0, vec_chunks);
      __syncthreads();
    }
    put_states();
    __syncthreads();
    write_states(h_out + state0, N % 4 == 0 && scan::vec_ok(h_out, N));
    return;
  }
  stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      stage(k + 1);   // into the buffer chunk k - 1 used
      scan::wait<1>();
    } else {
      scan::wait<0>();
    }
    __syncthreads();   // chunk k's copies, every thread's, have landed
    const int t0 = k * kChunk, steps = min(kChunk, t_len - t0);
    if (h_chunks != nullptr) put_states();   // written after the barrier below
    const float* in_d = &s_in[k & 1][0][0][tid];
    const float* in_x = &s_in[k & 1][1][0][tid];
    const float* bc = &s_bc[k & 1][0][0];
    float* out = y + (rows + t0) * c_len + c;
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const float d = in_d[s * kThreads];
      float bv[N], cv[N];
      scan::load_row<N>(bc + s * 2 * N, bv);
      scan::load_row<N>(bc + s * 2 * N + N, cv);
      const float acc = step<N>(h, av, d, d * in_x[s * kThreads], bv, cv);
      if (live) out[int64_t(s) * c_len] = acc;
    }
    __syncthreads();   // every reader of chunk k's buffer is done
    if (h_chunks != nullptr) {
      write_states(h_chunks + ((int64_t(b) * n_chunks + k) * c_len + c0) * N,
                   vec_chunks);
    }
  }
  __syncthreads();   // s_hc's last reader is done
  put_states();
  __syncthreads();
  write_states(h_out + state0, N % 4 == 0 && scan::vec_ok(h_out, N));
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bm,
                   const float* cm, const float* a, const float* h0,
                   float* y, float* h_out, float* h_chunks, int batch,
                   int t_len, int c_len, cudaStream_t stream) {
  const dim3 grid((c_len + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      dt, x, bm, cm, a, h0, y, h_out, h_chunks, t_len, c_len);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const float*, const float*, const float*,
                                 const float*, const float*, const float*,
                                 float*, float*, float*, int, int, int,
                                 cudaStream_t);

constexpr Launcher kLaunchers[kMaxState] = {
    launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,  launch<6>,
    launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>, launch<12>,
    launch<13>, launch<14>, launch<15>, launch<16>};

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream``
// (PyTorch's current stream), allocates nothing, does not synchronise, and
// returns the launch's cudaError_t (0 = success).  The caller has checked
// that every array is float32, contiguous and on one card: dt, x, y
// (B, T, C); bm, cm (B, T, N); a (C, N); h0 (B, C, N) or null for zeros;
// h_out (B, C, N), which may be h0; h_chunks (B, ceil(T/16), C, N) or null.
// 1 <= n <= 16, every size >= 1, C and B within a grid.
extern "C" int selective_scan_launch(const void* dt, const void* x,
                                     const void* bm, const void* cm,
                                     const void* a, const void* h0, void* y,
                                     void* h_out, void* h_chunks, int batch,
                                     int t_len, int c_len, int n,
                                     void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || c_len < 1 || n < 1 ||
      n > kMaxState)
    return int(cudaErrorInvalidValue);
  return int(kLaunchers[n - 1](
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out),
      static_cast<float*>(h_chunks), batch, t_len, c_len,
      static_cast<cudaStream_t>(stream)));
}

// Steps between the checkpoints the launch writes (the backward's chunk).
extern "C" int selective_scan_chunk() { return kChunk; }

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
