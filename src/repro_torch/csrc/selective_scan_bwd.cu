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
// 2.68 GB, 0.80 ms at 3.35 TB/s.  Its float32 operations, 16 an element
// and 4 a (b, t, c), 34.9 G, each its own instruction under -fmad=false
// (128 a clock an SM), take 1.04 ms; its exponentials 0.51 ms on the
// special-function units.  So the operations bound it
// (benchmarks/timing.py, selective_scan_bwd_bound).
//
// Design.  A (b, c) lane's states are split over a group of kGroup = 4
// adjacent threads, P = ceil(N / 4) states each (the states past N masked:
// they run as zeros and add exact zeros), and a block is 128 channels of
// one batch row (512 threads, one block an SM at 128 registers).  The lane
// walks its chunks of kChunk = 16 steps in reverse.  For each chunk it
// recomputes the chunk's states from the checkpoint the forward wrote at
// the chunk's start (h_chunks, every 16 steps), op for op as the forward,
// into registers (16 steps x P states: no local memory; ptxas reports no
// stack and no spill for any N), then walks the chunk backward with its
// carry, its row of A and its dA sums in registers.  That is two
// exponentials an element (recompute and walk) and the checkpoints read
// once (537 MB at jamba's shape).  The chunk's dt, x and dy (16 steps x 128
// channels), its Bm and Cm and its checkpoints are copied into shared
// memory by cp.async while the block works on the chunk after it (two
// buffers), so no step waits on device memory; ddt and dx go out through
// shared memory in whole rows.  A step past T (the last chunk may be
// short) runs on the zeros staged for it: it moves no state, adds exact
// zeros and writes nothing.  Every sum is taken in a fixed order, with no
// atomics, so the result does not change from run to run and the plain
// version (kernels/ref.py::selective_scan_backward) repeats it op for op:
//
//   * du and sum_n q * A: each thread over its P states in order, then the
//     group's four partials as (p0 + p1) + (p2 + p3) (__shfl_xor_sync 1,
//     then 2);
//   * dA: per thread over t from T-1 down to 0, into a (B, C, N) partial;
//   * dCm and dBm over the 16,384 channels: a thread's 2P terms (padded to
//     8) are summed over the 8 channels of its warp by a reduce-scatter of
//     __shfl_xor_sync 16, 8, 4 (channel pairs 4, then 2, then 1 apart: a
//     halving tree), which leaves each thread one of the warp's 32 sums;
//     the warps' sums of a chunk go to shared memory, and after the chunk a
//     thread a (step, sum) adds the 16 warps' in warp order into the
//     block's partial, (B, blocks, T, 2N).  (Exchanging the terms through
//     shared memory instead measured 7% slower on the card: the shared
//     memory pipe, not the instruction slots, ran out first; PERF.md §6.)
//
// Two barriers a chunk order it all.  A second launch, selective_scan_bwd_
// reduce_kernel, sums the partials: dCm and dBm over the blocks in block
// order, dA over b in order.  The arithmetic is compiled with -fmad=false,
// as the forward's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_staging.cuh"

namespace {

using scan::kChunk;
constexpr int kGroup = 4;                   // threads a (b, c) lane
constexpr int kLanes = 128;                 // channels a block
constexpr int kThreads = kLanes * kGroup;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 512 / kThreads;
constexpr int kSlots = 8;                   // channel-sum terms a thread
constexpr int kMaxState = 16;
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(32 / kGroup == kSlots, "a warp's channels = a thread's terms");

template <int N>
__host__ __device__ constexpr int padded() {
  return (N + kGroup - 1) / kGroup * kGroup;
}

// Shared memory of one block, in floats: two chunks' dt, x and dy
// ([2][3][kChunk][kLanes]), Bm then Cm of each of their steps
// ([2][kChunk][2 NP], zero past N) and their checkpoints ([2][kLanes][NP]);
// the warps' sums of a chunk ([kWarps][kChunk][32]); the chunk's ddt and
// dx ([2][kChunk][kLanes]).
template <int N>
struct Smem {
  static constexpr int kIn = 0;
  static constexpr int kBc = kIn + 2 * 3 * kChunk * kLanes;
  static constexpr int kH = kBc + 2 * kChunk * 2 * padded<N>();
  static constexpr int kSums = kH + 2 * kLanes * padded<N>();
  static constexpr int kOut = kSums + kWarps * kChunk * 32;
  static constexpr int kBytes = 4 * (kOut + 2 * kChunk * kLanes);
};

// v[j] summed over the 8 channels of the warp (lanes 4, 8 and 16 apart), a
// halving tree: channels 4 apart, then 2, then 1.  Each round a thread
// keeps the half of its slots its lane bit picks and adds its partner's
// copy of them; it ends with the sum of slot (lane / 4) % 8.
__device__ __forceinline__ float channel_sum(float (&v)[kSlots], int lane) {
#pragma unroll
  for (int half = kSlots / 2, m = 16; half >= 1; half /= 2, m /= 2) {
    const bool up = lane & m;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = up ? v[i + half] : v[i];
      const float send = up ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(kFull, send, m);
    }
  }
  return v[0];
}

template <int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
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
  constexpr int P = (N + kGroup - 1) / kGroup;   // states a thread
  constexpr int NP = padded<N>();
  using L = Smem<N>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane_id = tid % 32, warp = tid / 32;
  const int g = tid % kGroup, n0 = g * P, cl = tid / kGroup;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kLanes, c = c0 + cl;
  const bool live = c < c_len;
  const int64_t lane = int64_t(b) * c_len + c;      // (b, c) of the states
  const int64_t rows = int64_t(b) * t_len;          // row (b, 0) of (B, T)
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  float av[P], carry[P], da[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool has = live && n0 + p < N;
    av[p] = has ? a[int64_t(c) * N + n0 + p] : 0.0f;
    carry[p] = (has && dh_t != nullptr) ? dh_t[lane * N + n0 + p] : 0.0f;
    da[p] = 0.0f;
  }
  // 16-byte copies where C, N and the arrays allow them
  const bool vec_in = scan::vec_ok(dt, c_len) && scan::vec_ok(x, c_len) &&
                      scan::vec_ok(dy, c_len);
  const bool vec_n = N % 4 == 0 && scan::vec_ok(bm, N) &&
                     scan::vec_ok(cm, N) && scan::vec_ok(h_chunks, N);
  auto stage = [&](int k) {   // chunk k's inputs into buffer k & 1
    const int t0 = k * kChunk, steps = min(kChunk, t_len - t0);
    float* in = smem + L::kIn + (k & 1) * 3 * kChunk * kLanes;
    const int64_t first = (rows + t0) * c_len + c0;
    const float* arrays[3] = {dt, x, dy};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      scan::copy_tile<kChunk, kLanes, kLanes, kThreads>(
          in + i * kChunk * kLanes, arrays[i] + first, c_len, steps,
          c_len - c0, 0, vec_in, tid);
    }
    float* bc = smem + L::kBc + (k & 1) * kChunk * 2 * NP;
    const int64_t step0 = (rows + t0) * N;   // Bm and Cm of step t0
    scan::copy_tile<kChunk, NP, 2 * NP, kThreads>(bc, bm + step0, N, steps,
                                                  N, 0, vec_n, tid);
    scan::copy_tile<kChunk, NP, 2 * NP, kThreads>(bc, cm + step0, N, steps,
                                                  N, NP, vec_n, tid);
    // the checkpoints: kLanes rows of NP (zero past N and C)
    scan::copy_tile<kLanes, NP, NP, kThreads>(
        smem + L::kH + (k & 1) * kLanes * NP,
        h_chunks + ((int64_t(b) * n_chunks + k) * c_len + c0) * N, N,
        c_len - c0, N, 0, vec_n, tid);
    scan::commit();
  };
  float* const sums = smem + L::kSums;
  float* const out = smem + L::kOut;
  const bool vec_out = scan::vec_ok(ddt, c_len) && scan::vec_ok(dx, c_len);
  stage(n_chunks - 1);
  for (int k = n_chunks - 1; k >= 0; --k) {
    // chunk k - 1's inputs go to the buffer chunk k + 1 read, which every
    // thread finished before the last barrier
    if (k > 0) {
      stage(k - 1);
      scan::wait<1>();
    } else {
      scan::wait<0>();
    }
    __syncthreads();   // chunk k's copies, every thread's, have landed
    const int t0 = k * kChunk, steps = min(kChunk, t_len - t0);
    const float* in = smem + L::kIn + (k & 1) * 3 * kChunk * kLanes + cl;
    const float* bc = smem + L::kBc + (k & 1) * kChunk * 2 * NP + n0;
    // the chunk's states, recomputed as the forward computed them from
    // the checkpoint (read again from shared memory for the walk's step 0)
    const float* h_chunk = smem + L::kH + (k & 1) * kLanes * NP + cl * NP + n0;
    float h_start[P], hist[kChunk][P];
    scan::load_row<P>(h_chunk, h_start);
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const float d = in[s * kLanes];
      const float u = d * in[(kChunk + s) * kLanes];
      float bv[P];
      scan::load_row<P>(bc + s * 2 * NP, bv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float abar = expf(d * av[p]);
        const float h = s > 0 ? hist[s - 1][p] : h_start[p];
        hist[s][p] = abar * h + u * bv[p];
      }
    }
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      // a step from `steps` on (past T) runs on the zeros staged for it:
      // it moves no state, adds exact zeros, and writes nothing
      const float d = in[s * kLanes];
      const float xv = in[(kChunk + s) * kLanes];
      const float gy = in[(2 * kChunk + s) * kLanes];
      const float u = d * xv;
      float bv[P], cv[P];
      scan::load_row<P>(bc + s * 2 * NP, bv);
      scan::load_row<P>(bc + s * 2 * NP + NP, cv);
      float v[kSlots], du = 0.0f, sq = 0.0f;
      if (s == 0) scan::load_row<P>(h_chunk, h_start);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float h_cur = hist[s][p];
        const float h_prev = s > 0 ? hist[s - 1][p] : h_start[p];
        const float abar = expf(d * av[p]);
        const float gg = gy * cv[p] + carry[p];
        v[p] = gy * h_cur;
        v[P + p] = gg * u;
        const float gb = gg * bv[p];
        du = p == 0 ? gb : du + gb;
        const float q = (gg * h_prev) * abar;
        const float qa = q * av[p];
        sq = p == 0 ? qa : sq + qa;
        da[p] = da[p] + q * d;
        carry[p] = abar * gg;
      }
#pragma unroll
      for (int j = 2 * P; j < kSlots; ++j) v[j] = 0.0f;
      du = du + __shfl_xor_sync(kFull, du, 1);
      sq = sq + __shfl_xor_sync(kFull, sq, 1);
      du = du + __shfl_xor_sync(kFull, du, 2);
      sq = sq + __shfl_xor_sync(kFull, sq, 2);
      if (g == 0) {
        out[s * kLanes + cl] = du * xv + sq;
        out[(kChunk + s) * kLanes + cl] = du * d;
      }
      sums[(warp * kChunk + s) * 32 + lane_id] = channel_sum(v, lane_id);
    }
    __syncthreads();
    const int64_t first = (rows + t0) * c_len + c0;
    scan::store_tile<kChunk, kLanes, kThreads>(ddt + first, out, c_len, steps,
                                               c_len - c0, vec_out, tid);
    scan::store_tile<kChunk, kLanes, kThreads>(dx + first,
                                               out + kChunk * kLanes, c_len,
                                               steps, c_len - c0, vec_out,
                                               tid);
    // the block's sums: thread (s, i) adds the warps' sums in order
    for (int e = tid; e < kChunk * 32; e += kThreads) {
      const int s = e / 32, i = e % 32;
      if (s < steps) {
        float acc = sums[s * 32 + i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          acc = acc + sums[(w * kChunk + s) * 32 + i];
        }
        // lane i = 4 * slot + group position: slot < P is dCm of state
        // grp * P + slot, P <= slot < 2P dBm of state grp * P + slot - P
        const int slot = i / kGroup, grp = i % kGroup;
        const int n = grp * P + (slot < P ? slot : slot - P);
        if (slot < 2 * P && n < N) {
          dbc_part[((int64_t(b) * gridDim.x + blockIdx.x) * t_len + t0 + s) *
                       2 * N + (slot < P ? n : N + n)] = acc;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (n0 + p < N) {
        da_part[lane * N + n0 + p] = da[p];
        if (dh0 != nullptr) dh0[lane * N + n0 + p] = carry[p];
      }
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
  constexpr int bytes = Smem<N>::kBytes;
  const cudaError_t set = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  const dim3 grid((c_len + kLanes - 1) / kLanes, batch);
  selective_scan_bwd_kernel<N><<<grid, kThreads, bytes, stream>>>(
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
  return (c_len + kLanes - 1) / kLanes;
}

// Steps between the checkpoints it reads (the forward's chunk).
extern "C" int selective_scan_bwd_chunk() { return kChunk; }

// Plain C entry points, loaded with ctypes.  Each launches on ``stream``
// (PyTorch's current stream), allocates nothing, does not synchronise, and
// returns the launch's cudaError_t (0 = success).  The caller has checked
// that every array is float32, contiguous and on one card: dt, x, dy, ddt,
// dx (B, T, C); bm, cm (B, T, N); a (C, N); h_chunks (B, ceil(T/16), C, N),
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
