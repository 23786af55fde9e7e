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
// just above the bytes (benchmarks/timing.py, selective_scan_bound).
//
// Design (a simple first form).  One thread owns one (b, c) lane and keeps
// its N states and its row of A in registers for the whole sequence, so no
// state is written until h_T.  A block is 128 consecutive channels of one
// batch row: dt and x are read and y written coalesced, one float a thread
// a step, and the next step's dt and x are loaded before the current step's
// arithmetic.  Bm and Cm, shared by every channel of a (b, t), are staged
// in shared memory a tile of 64 steps at a time.  The arithmetic is the
// plain version's, op for op: expf (not __expf), dt * x once a step, then
// the product with Bm, h = abar * h + bx as a product and a sum
// (-fmad=false keeps every product and sum unfused), and y summed over n
// in n order.  N is a template parameter (1..16), so the state arrays stay
// in registers.  A decode step is T = 1; h0 and h_T may be the same array,
// since each thread reads its own states before it writes them.
//
// For training, the launch may also write the state at the start of each
// tile of 64 steps (h0, or zeros, for the first) into h_chunks, a
// (B, ceil(T/64), C, N) array: the checkpoints from which
// csrc/selective_scan_bwd.cu recomputes a tile's states.  The serve path
// passes null and writes nothing more.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kTile = 64;       // time steps of Bm and Cm staged a turn
constexpr int kMaxState = 16;

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ dt,
                      const float* __restrict__ x,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a, const float* h0,
                      float* __restrict__ y, float* h_out,
                      float* __restrict__ h_chunks, int t_len, int c_len) {
  __shared__ float sb[kTile * N];
  __shared__ float sc[kTile * N];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < c_len;
  const int64_t lane = int64_t(b) * c_len + c;      // (b, c) of the states
  const int64_t rows = int64_t(b) * t_len;          // row (b, 0) of (B, T)
  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[int64_t(c) * N + n] : 0.0f;
    h[n] = (live && h0 != nullptr) ? h0[lane * N + n] : 0.0f;
  }
  const int n_tiles = (t_len + kTile - 1) / kTile;
  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    const int steps = min(kTile, t_len - t0);
    if (h_chunks != nullptr && live) {
      float* hc =
          h_chunks + ((int64_t(b) * n_tiles + t0 / kTile) * c_len + c) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) hc[n] = h[n];
    }
    __syncthreads();   // every reader of the last tile is done
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      sb[i] = bm[(rows + t0) * N + i];
      sc[i] = cm[(rows + t0) * N + i];
    }
    __syncthreads();
    if (!live) continue;
    int64_t off = (rows + t0) * c_len + c;
    float d_next = dt[off], x_next = x[off];
    for (int s = 0; s < steps; ++s, off += c_len) {
      const float d = d_next, u = d * x_next;
      if (s + 1 < steps) {
        d_next = dt[off + c_len];
        x_next = x[off + c_len];
      }
      const float* bs = sb + s * N;
      const float* cs = sc + s * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float abar = expf(d * av[n]);
        h[n] = abar * h[n] + u * bs[n];
      }
      float acc = h[0] * cs[0];
#pragma unroll
      for (int n = 1; n < N; ++n) acc = acc + h[n] * cs[n];
      y[off] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[lane * N + n] = h[n];
  }
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
// h_out (B, C, N), which may be h0; h_chunks (B, ceil(T/64), C, N) or null.
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

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
