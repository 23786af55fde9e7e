// Flash attention (GQA, causal and/or sliding window) for Hopper (sm_90a):
//
//     o[b, i, h, :] = sum_j softmax_j( (q[b,i,h,:] . k[b,j,g,:]) * scale ) v[b,j,g,:]
//     g = h / (Hq / Hkv),  scale = 1 / sqrt(D),  over the visible keys j
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:25
// (function _flash_kernel, wrapper flash_attention).
//
// What bounds it on an H100: operations.  At the model's prefill shape
// (B=4, T=2,048, 32 query / 8 KV heads, D=128, causal) it does 4*D flops
// per visible (query, key) pair per query head, 137.5 GFLOP, against
// 168 MB of q, k, v and o: about 820 flops a byte, far above the ~295
// operations-per-byte line where the bf16 tensor cores stop waiting for
// memory.  So the least time is the flops over 989 TFLOP/s.
//
// Design, the simple one.  One thread block per (64-row query tile, query
// head, batch row); the TPU's sequential K grid axis is a loop over 64-row
// K tiles inside the block.  Q is staged once in shared memory, each K and
// V tile in turn, all converted to float32 (Q and K transposed, with a
// padded leading dimension, so the inner products read float4s).  The 256
// threads form a 16 x 16 grid: thread (ty, tx) owns query rows 4ty..4ty+3,
// key columns 4tx..4tx+3 of the 64 x 64 score tile, and output columns
// 4tx + 64j..+3.  The running max m, denominator l and the accumulator are
// per row in float32 registers; a row's 16 threads are one half-warp, so
// its max and sum are warp shuffles.  q, k and v are read in place from the
// model's (B, T, H, D) layout by their strides; nothing is transposed in
// device memory.  Tiles are scheduled heaviest first (last query tile
// first), since under a causal mask the last tile sees the most keys.
//
// What the simple design leaves on the table: no wgmma and no TMA, and the
// products run in float32 on the CUDA cores (67 TFLOP/s, not 989), with
// scalar global loads.  A faster kernel is later work.
//
// Numerics follow _flash_kernel.  Masks are built as there: kpos < Tk, then
// qpos >= kpos if causal, then kpos > qpos - window if window > 0, with qpos
// and kpos counted from 0 on both sides.  Masked logits are -inf; the
// running max is guarded (m_safe = 0 where m is -inf, alpha = 0 where the
// previous max is -inf), so a fully masked tile adds exactly 0 and a row
// that sees no key at all comes out 0 (acc / max(l, 1e-30)).  The logit is
// (q . k) * scale, the product formed first.  The two products use explicit
// fmaf; the build's -fmad=false keeps every other multiply and add (the
// softmax, the rescaling) unfused, and the exponential is expf, not __expf.
//
// Skipped tiles.  A K tile that lies wholly above the causal diagonal, or
// wholly before every row's window, is not visited.  Visiting it would
// change nothing: every logit in it is -inf, so its p is exactly 0, and its
// alpha is exactly 1 (exp(m - m) with m finite) or exactly 0 with a zero
// accumulator and denominator (m still -inf), so the state is unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLd = 68;         // leading dim of the transposed tiles
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t tq, tk;
  int hq, hkv;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int causal, window;
  float scale;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

template <int D>
constexpr int smem_floats() {
  return D * kLd + (D > kBK ? D : kBK) * kLd + kBK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int kNJ = (D + 63) / 64;  // 64-wide output column groups
  extern __shared__ float4 smem4[];
  float* qt_s = reinterpret_cast<float*>(smem4);  // Q^T: [D][kLd]
  float* kp_s = qt_s + D * kLd;  // K^T [D][kLd], then P^T [kBK][kLd]
  float* v_s = kp_s + (D > kBK ? D : kBK) * kLd;  // V: [kBK][D]

  const int qtile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t q0 = int64_t(qtile) * kBQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int dd = e % D;
    const int64_t qpos = q0 + r;
    qt_s[dd * kLd + r] = qpos < p.tq ? to_f32(qg[qpos * p.q_st + dd]) : 0.0f;
  }

  float m[4], l[4], acc[4][4 * kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] = 0.0f;
  }

  // the K tiles some row of this query tile can see
  const int64_t q_last = lmin(q0 + kBQ, p.tq) - 1;
  const int64_t k_lo = p.window > 0 ? lmax(0, q0 - p.window + 1) : 0;
  const int64_t k_hi = p.causal ? lmin(p.tk, q_last + 1) : p.tk;
  __syncthreads();

  for (int64_t k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int dd = e % D;
      const int64_t kpos = k0 + r;
      const bool in = kpos < p.tk;  // rows past Tk are 0, never NaN
      kp_s[dd * kLd + r] = in ? to_f32(kg[kpos * p.k_st + dd]) : 0.0f;
      v_s[r * D + dd] = in ? to_f32(vg[kpos * p.v_st + dd]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 cells
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&qt_s[dd * kLd + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&kp_s[dd * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
      }
    }
    __syncthreads();  // K^T is read by all before P^T overwrites it

    // online softmax, one row at a time; a row's 16 threads are a half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx * 4 + j;
        bool ok = kpos < p.tk;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_safe);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);  // masked: expf(-inf) = 0
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFullMask, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kNJ; ++c) acc[i][c] = alpha * acc[i][c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&kp_s[(tx * 4 + j) * kLd + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(&kp_s[kk * kLd + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int col = tx * 4 + 64 * jj;
        if (col < D) {
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[kk * D + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj * 4 + 0] = fmaf(pv[i], vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pv[i], vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pv[i], vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pv[i], vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
    __syncthreads();  // before the next tile overwrites K^T/P^T and V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qpos = q0 + ty * 4 + i;
    if (qpos >= p.tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* og = static_cast<T*>(p.o) + b * p.o_sb + qpos * p.o_st + h * p.o_sh;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int col = tx * 4 + 64 * jj;
      if (col < D) {
#pragma unroll
        for (int c = 0; c < 4; ++c) store(&og[col + c], acc[i][jj * 4 + c] / denom);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int64_t n_qt = (p.tq + kBQ - 1) / kBQ;
  const dim3 grid(unsigned(n_qt), unsigned(p.hq), unsigned(b));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, b, stream);
    case 32: return launch<T, 32>(p, b, stream);
    case 48: return launch<T, 48>(p, b, stream);
    case 64: return launch<T, 64>(p, b, stream);
    case 80: return launch<T, 80>(p, b, stream);
    case 96: return launch<T, 96>(p, b, stream);
    case 112: return launch<T, 112>(p, b, stream);
    case 128: return launch<T, 128>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream`` (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = success).  Strides are in elements; the head
// dim is contiguous.  The caller has checked shapes, dtypes (float32 or
// bfloat16, all alike), D in {16, 32, ..., 128}, Hq % Hkv == 0 and
// B, Tq, Tk >= 1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long b, long long tq, long long tk, int hq, int hkv, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int window, int is_bf16, void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hkv < 1 ||
      hq % hkv != 0 || tq < 1 || tk < 1 || window < 0 ||
      (tq + kBQ - 1) / kBQ > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.tq = tq;
  p.tk = tk;
  p.hq = hq;
  p.hkv = hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.causal = causal != 0;
  p.window = window;
  p.scale = 1.0f / sqrtf(float(d));  // as the oracle: 1 / sqrt(f32(D))
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(p, int(b), d, s)
      : dispatch<float>(p, int(b), d, s);
  return int(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
