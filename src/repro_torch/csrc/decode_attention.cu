// Decode attention (one query position against a KV cache, GQA) for Hopper
// (sm_90a):
//
//     o[b, h, :] = sum_{j < L_b} softmax_j( (q[b,h,:] . k[b,j,g,:]) * scale ) v[b,j,g,:]
//     g = h / (Hq / Hkv),  scale = 1 / sqrt(D),  L_b = clamp(valid_len[b], 0, S)
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py:24
// (function _decode_kernel, wrapper decode_attention).
//
// What bounds it on an H100: bytes.  It must stream the valid rows of the
// K and V caches once: at the benchmark's shape (B=4, S=16,384, 8 query /
// 2 KV heads, D=64, bf16) that is 33.6 MB, 10.0 us at 3.35 TB/s, against
// 4*D*Hq*S*B = 134 M operations, 0.14 us at 989 TFLOP/s.
//
// Design: split-KV with a second pass.  The TPU kernel carries the running
// max m, denominator l and accumulator over a sequential grid axis of
// cache blocks in VMEM.  Blocks on Hopper run in parallel and in no order,
// so kernel 1 runs one block per (split, KV head, batch row): it holds the
// KV head's qpk query rows in float32 in shared memory and streams its
// chunk of positions in 64-key tiles.  Each tile is staged in shared memory
// as float32 (K rows padded to D + 1 floats, so the lanes of a warp, one
// key each, read distinct banks); a thread forms each logit as the
// float32 dot product (fmaf, in d order), times the oracle's float32 scale
// after the product; one warp per query head runs the online softmax over
// the tile (max and sum by shuffles) with -inf masks and the guard of the
// TPU kernel (m_safe = 0 where m is -inf, alpha = 0 where the previous m
// is -inf); then acc = alpha * acc + P V.  It writes (m, l, acc) to a
// float32 workspace.  Kernel 2 combines the splits of each (row, query
// head): M = max m, o = sum exp(m - M) acc / max(sum exp(m - M) l, 1e-30),
// in q's dtype.  The caches are read in place from their (B, S, Hkv, D)
// layout by strides: a key row of one head is D contiguous values, loaded
// by neighbouring threads.  The wrapper picks the number of splits so that
// B * Hkv * splits fills the 132 SMs several times over.
//
// Positions at or past L_b.  A split that starts at or past L_b reads no
// cache and writes m = -inf, l = 0; kernel 2 skips it.  That is exact: in
// the TPU kernel every logit of such a block is -inf, so its p is 0 and its
// alpha is exactly 1 (exp(m - m) with m finite), or 0 on a zero state.  A
// row with L_b = 0 has no split with a key, so M = -inf, and its output is
// 0 / 1e-30 = exactly 0, as the TPU kernel gives.  Inside a split, rows of
// a tile at or past L_b are staged as 0 (never NaN) and masked to -inf.
//
// What the simple design leaves on the table: the logits and P V run on
// the CUDA cores in float32 with scalar loads and four block barriers a
// tile; no TMA ring overlaps the next tile's loads with this tile's math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // keys per tile: two per lane in the softmax
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* valid_len;
  void* o;
  float* ws_m;    // [B][Hq][splits]
  float* ws_l;    // [B][Hq][splits]
  float* ws_acc;  // [B][Hq][splits][D]
  int64_t s, chunk;
  int hq, hkv, qpk, splits;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

template <int D>
constexpr size_t smem_floats(int qpk) {
  // q, K (padded), V, P, m / l / alpha, acc
  return size_t(qpk) * D + size_t(kTile) * (D + 1) + size_t(kTile) * D +
         size_t(qpk) * kTile + 3 * size_t(qpk) + size_t(qpk) * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const Params p) {
  constexpr int kLd = D + 1;
  extern __shared__ float smem[];
  const int qpk = p.qpk;
  float* q_s = smem;                       // [qpk][D]
  float* k_s = q_s + qpk * D;              // [kTile][kLd]
  float* v_s = k_s + kTile * kLd;          // [kTile][D]
  float* p_s = v_s + kTile * D;            // [qpk][kTile]
  float* m_s = p_s + qpk * kTile;          // [qpk]
  float* l_s = m_s + qpk;                  // [qpk]
  float* a_s = l_s + qpk;                  // [qpk]
  float* acc_s = a_s + qpk;                // [qpk][D]

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int h0 = g * qpk;  // first query head of KV head g

  int64_t len = p.valid_len[b];
  len = len < 0 ? 0 : (len > p.s ? p.s : len);
  const int64_t start = int64_t(split) * p.chunk;
  const int64_t stop = start + p.chunk < len ? start + p.chunk : len;
  const int64_t part = (int64_t(b) * p.hq + h0) * p.splits + split;

  if (start >= stop) {  // wholly past valid_len: no cache read
    for (int hh = tid; hh < qpk; hh += kThreads) {
      p.ws_m[part + int64_t(hh) * p.splits] = -INFINITY;
      p.ws_l[part + int64_t(hh) * p.splits] = 0.0f;
    }
    return;
  }

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  for (int e = tid; e < qpk * D; e += kThreads) {
    const int hh = e / D;
    q_s[e] = to_f32(qg[(h0 + hh) * p.q_sh + e % D]);
    acc_s[e] = 0.0f;
  }
  for (int hh = tid; hh < qpk; hh += kThreads) {
    m_s[hh] = -INFINITY;
    l_s[hh] = 0.0f;
  }
  __syncthreads();

  for (int64_t k0 = start; k0 < stop; k0 += kTile) {
    // stage the tile; rows at or past ``stop`` are 0 (and masked below)
#pragma unroll 4
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int64_t pos = k0 + r;
      const bool in = pos < stop;
      k_s[r * kLd + c] = in ? to_f32(kg[pos * p.k_ss + c]) : 0.0f;
      v_s[r * D + c] = in ? to_f32(vg[pos * p.v_ss + c]) : 0.0f;
    }
    __syncthreads();

    // logits: a warp takes 32 keys of one query head
    for (int e = tid; e < qpk * kTile; e += kThreads) {
      const int hh = e / kTile;
      const int j = e % kTile;
      const float* qh = q_s + hh * D;
      const float* kj = k_s + j * kLd;
      float dot = 0.0f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot = fmaf(qh[c], kj[c], dot);
      p_s[e] = k0 + j < stop ? dot * p.scale : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp per query head, lane owns keys lane, lane+32
    for (int hh = warp; hh < qpk; hh += kWarps) {
      float* ph = p_s + hh * kTile;
      const float s0 = ph[lane];
      const float s1 = ph[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_prev = m_s[hh];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = m_prev == -INFINITY ? 0.0f : expf(m_prev - m_safe);
      const float e0 = expf(s0 - m_safe);  // masked: expf(-inf) = 0
      const float e1 = expf(s1 - m_safe);
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      ph[lane] = e0;
      ph[lane + 32] = e1;
      if (lane == 0) {
        l_s[hh] = alpha * l_s[hh] + sum;
        m_s[hh] = m_new;
        a_s[hh] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
    for (int e = tid; e < qpk * D; e += kThreads) {
      const int hh = e / D;
      const int c = e % D;
      const float* ph = p_s + hh * kTile;
      float a = a_s[hh] * acc_s[e];
#pragma unroll 16
      for (int j = 0; j < kTile; ++j) a = fmaf(ph[j], v_s[j * D + c], a);
      acc_s[e] = a;
    }
    __syncthreads();  // before the next tile overwrites K, V and P
  }

  for (int e = tid; e < qpk * D; e += kThreads) {
    const int hh = e / D;
    p.ws_acc[(part + int64_t(hh) * p.splits) * D + e % D] = acc_s[e];
  }
  for (int hh = tid; hh < qpk; hh += kThreads) {
    p.ws_m[part + int64_t(hh) * p.splits] = m_s[hh];
    p.ws_l[part + int64_t(hh) * p.splits] = l_s[hh];
  }
}

// One block per (query head, batch row), one thread per output column.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const int64_t base = (int64_t(b) * p.hq + h) * p.splits;
  float m_max = -INFINITY;
  for (int sp = 0; sp < p.splits; ++sp) m_max = fmaxf(m_max, p.ws_m[base + sp]);
  float l = 0.0f;
  float acc = 0.0f;
  if (m_max != -INFINITY) {
    for (int sp = 0; sp < p.splits; ++sp) {
      const float m = p.ws_m[base + sp];
      if (m == -INFINITY) continue;  // a split with no valid position
      const float w = expf(m - m_max);
      l += w * p.ws_l[base + sp];
      if (c < D) acc += w * p.ws_acc[(base + sp) * D + c];
    }
  }
  if (c < D) {
    T* o = static_cast<T*>(p.o) + (int64_t(b) * p.hq + h) * D;
    store(o + c, acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>(p.qpk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  decode_partial_kernel<T, D>
      <<<dim3(unsigned(p.splits), unsigned(p.hkv), unsigned(b)), kThreads,
         smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D>
      <<<dim3(unsigned(p.hq), unsigned(b)), kThreads, 0, stream>>>(p);
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

// Plain C entry point, loaded with ctypes.  Launches both kernels on
// ``stream`` (PyTorch's current stream), allocates nothing, does not
// synchronise, and returns the first failing launch's cudaError_t (0 =
// success).  ``ws`` holds B * Hq * splits * (D + 2) floats; splits * chunk
// covers S.  Strides are in elements; the head dim is contiguous, and the
// output is a contiguous (B, Hq, D).  The caller has checked shapes, dtypes
// (float32 or bfloat16, all alike; valid_len int32), D in {16, 32, ...,
// 128}, Hq % Hkv == 0, Hq / Hkv <= 64 and B, S >= 1.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid_len,
    void* o, void* ws, long long b, long long s, int hq, int hkv, int d,
    int splits, long long chunk, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int is_bf16, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || hq < 1 || hq > 65535 || hkv < 1 ||
      hkv > 65535 || hq % hkv != 0 || hq / hkv > 64 || splits < 1 ||
      chunk < 1 || chunk % kTile != 0 || (splits - 1) * chunk >= s ||
      splits * chunk < s)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid_len = static_cast<const int32_t*>(valid_len);
  p.o = o;
  const int64_t parts = int64_t(b) * hq * splits;
  p.ws_m = static_cast<float*>(ws);
  p.ws_l = p.ws_m + parts;
  p.ws_acc = p.ws_l + parts;
  p.s = s;
  p.chunk = chunk;
  p.hq = hq;
  p.hkv = hkv;
  p.qpk = hq / hkv;
  p.splits = splits;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = 1.0f / sqrtf(float(d));  // as the oracle: 1 / sqrt(f32(D))
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(p, int(b), d, st)
      : dispatch<float>(p, int(b), d, st);
  return int(err);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
