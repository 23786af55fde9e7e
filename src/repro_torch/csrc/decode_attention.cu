// Decode attention (one query position against a KV cache, GQA) for Hopper
// (sm_90a):
//
//     o[b, h, :] = sum_{j < L_b} softmax_j( (q[b,h,:] . k[b,j,g,:]) * scale ) v[b,j,g,:]
//     g = h / (Hq / Hkv),  scale = 1 / sqrt(D),  L_b = clamp(valid_len[b], 0, S)
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py:24
// (function _decode_kernel, wrapper decode_attention, pallas_call at :81).
//
// What bounds it on an H100: bytes.  It must stream the valid rows of the
// K and V caches once.  At the benchmark's shape (B=4, S=16,384, 8 query /
// 2 KV heads, D=64, bf16) that is 33.6 MB, 10.02 us at 3.35 TB/s; at
// qwen3-8b's decode (B=4, S=2,064, 32 / 8 heads, D=128, bf16) 33.9 MB,
// 10.11 us.  By Little's law 3.35 TB/s over ~0.7 us of latency needs
// ~2.3 MB in flight across the card, ~18 KB an SM.
//
// Split-KV in two launches: a split pass, then a combine (none where the
// plan has one split).  The plan (kernels/decode_attention.py,
// plan_splits) gives one wave of resident split-pass blocks (the tensor-
// core form: 8 warps, 2 an SM at D <= 64 and 1 above, for its registers;
// the CUDA-core form: 4 warps, 3 an SM), each a chunk of positions that
// it streams in many rounds, with no block barrier in the key loop.
// Every block keeps an online softmax (m, l, acc) with the TPU kernel's
// guards (m_safe = 0 where m is -inf, alpha = 0 where the previous m is
// -inf), with q pre-scaled so that logits are in base 2 and every
// exponential is one exp2f.  Positions at or past the split's end
// are neither loaded nor counted (logit -inf).  At the end the block's
// warps merge through shared memory and the block writes its float32
// (m, l, acc) to a workspace, or o itself where there is one split.
//
// Tensor-core form (bf16, D a multiple of 32; decode_split_mma_kernel):
// a warp takes 16 keys a round as two 8-key tiles, S = Q K^T and O += P V
// as m16n8k16 bf16 mma with float32 accumulators, up to 16 query heads as
// the rows (qpk 4 fills 4 of them: the tensor cores have the rate to
// spare).  Each lane copies the 16-byte pieces of K and V it will use with
// cp.async into its own slots of a 2-round ring in shared memory, so the
// next round is in flight while this one's math runs: 4 KB a warp and
// round at D = 64, 8 KB at D = 128, so 64-128 KB an SM at either (16 warps
// at D = 64, 8 at D = 128), well over the ~18 KB above.  The
// copies ask L2 for the 256-byte block around them.  The layouts are in
// the note at the kernel.  P goes in as two bf16 terms (hi, lo), so P V
// keeps ~16 bits of p.  Why tensor cores for an operation so far below the
// bf16 ridge: on the CUDA cores the work is ~2 D FMAs a (query head, key)
// pair plus the shuffles that sum a dot product over the lanes of a key,
// the widening of bf16 and the softmax, some 10 warp instructions a pair,
// ~5 us of issue at either timed shape.  On an H100, built first, that
// form's split pass stayed well short of the bytes bound while the same
// loads without the math came near it: bound by issue, not bytes.  The
// tensor-core form issues some 170 warp instructions for a round of 16
// keys at D = 64 (24 of them mma), where the CUDA cores take some 640 for
// 16 keys x 4 heads.
//
// CUDA-core form (float32, and bf16 with D = 16, 48, 80 or 112;
// decode_split_simt_kernel): a group of L lanes takes one key, each lane
// 16 bytes of it (8 bf16 or 4 float32 values), L the power of two at or
// above D * itemsize / 16 (lanes past the row idle).  Each lane loads K
// and V of U = 4 keys (2 with 8 heads a pass) of its group with 16-byte
// __ldg before any math: 128 B a lane, 4 KB a warp, 48 KB an SM at 3
// blocks.  q lives in registers, widened once; a logit is the lane's
// partial dot (fmaf) summed over the group by log2(L) __shfl_xor_sync
// steps; each group keeps its own state over its slice of D, updated once
// a round of U keys; at the end a warp's groups merge by shuffles.  It is
// templated on the query heads a pass carries (1, 2, 4 or 8; qpk rounds
// up, extra heads read q = 0 and are never written), since acc and q are
// heads x values-a-lane registers.
//
// Many query heads.  A KV head with more query heads than a pass carries
// (8 on the CUDA cores, 16 on the tensor cores; up to 64) takes several
// passes, one block each, and each pass re-reads the cache: correct, and
// slower by that factor.  ptxas reports no spills in any instantiation.
//
// Combine (decode_combine_kernel): one block per (batch row, query head).
// Warp 0 folds the splits' (m, l) into M and L while every thread loads
// its float4 columns of several splits; then o = sum 2^(m - M) acc /
// max(L, 1e-30) in q's dtype, the partial sums of a column added in shared
// memory.  Both kernels are launched with programmatic dependent launch:
// each lets the next kernel in the stream launch at once and waits for the
// one before it to finish before it reads global memory, so a launch's
// latency hides under the previous kernel.
//
// Positions at or past L_b.  A split that starts at or past L_b reads no
// cache and writes m = -inf, l = 0, acc = 0; the combine gives it weight 0.
// That is exact: in the TPU kernel every logit of such a block is -inf, so
// its p is 0 and its alpha exactly 1 (or 0 on a zero state).  A row with
// L_b = 0 has m = -inf in every split, so the guarded M gives weights 0
// and o = 0 / 1e-30 = exactly 0, as the TPU kernel gives.
//
// Pointers and row strides must be 16-byte aligned; the wrapper checks
// them and raises on a view that is not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* valid_len;
  void* o;
  float* ws_acc;  // [B][Hq][splits][D]
  float* ws_m;    // [B][Hq][splits]
  float* ws_l;    // [B][Hq][splits]
  int64_t s, chunk;
  int b, hq, hkv, qpk, d, splits, passes;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;  // log2(e) / sqrt(D): logits in base 2
};

// Programmatic dependent launch: the kernels are launched with
// programmatic stream serialisation, so a kernel may start while the one
// before it in the stream drains.  Each lets the next one launch at once
// and, before its first read of global memory, waits until the one before
// it has finished and its writes are visible.
__device__ __forceinline__ void follow_previous_kernel() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// 16 bytes of T, widened to float32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kValues = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kValues = 8;
  // the lower address is the low half of each 32-bit word
  static __device__ __forceinline__ void widen(const uint4& r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int QH>
struct Shape {
  static constexpr int kValues = Vec<T>::kValues;  // values a lane
  static constexpr int kUnroll = QH <= 4 ? 4 : 2;  // keys a group loads
  static constexpr int kMinBlocks = QH * kValues <= 32 ? 3 : 2;
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// The end of a split-pass block: merge the warps' states (m, l, acc of R
// query heads, acc rows LD floats apart) from shared memory and write the
// block's state for rows row0 .. row0 + nh - 1 (b * Hq + h), or o itself
// where there is one split.
template <typename T, int NW, int R, int LD>
__device__ __forceinline__ void finish_block(
    const Params& p, const float (&sm_m)[NW][R], const float (&sm_l)[NW][R],
    const float (&sm_acc)[NW][R][LD], int nh, int64_t row0, int split) {
  for (int i = threadIdx.x; i < nh * p.d; i += NW * 32) {
    const int h = i / p.d;
    const int c = i % p.d;
    float m_max = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) m_max = fmaxf(m_max, sm_m[w][h]);
    const float m_safe = m_max == -INFINITY ? 0.0f : m_max;
    float l_sum = 0.0f;
    float a_sum = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float a = exp2f(sm_m[w][h] - m_safe);
      l_sum = fmaf(a, sm_l[w][h], l_sum);
      a_sum = fmaf(a, sm_acc[w][h][c], a_sum);
    }
    const int64_t row = row0 + h;
    if (p.splits == 1) {
      store(static_cast<T*>(p.o) + row * p.d + c,
            a_sum / fmaxf(l_sum, 1e-30f));
    } else {
      const int64_t part = row * p.splits + split;
      p.ws_acc[part * p.d + c] = a_sum;
      if (c == 0) {
        p.ws_m[part] = m_max;
        p.ws_l[part] = l_sum;
      }
    }
  }
}

template <typename T, int L, int QH>
__global__ void __launch_bounds__(kThreads, (Shape<T, QH>::kMinBlocks))
decode_split_simt_kernel(const Params p) {
  follow_previous_kernel();
  constexpr int E = Shape<T, QH>::kValues;
  constexpr int U = Shape<T, QH>::kUnroll;
  constexpr int G = 32 / L;        // key groups a warp
  constexpr int NG = kWarps * G;   // key groups a block
  __shared__ float sm_m[kWarps][QH];
  __shared__ float sm_l[kWarps][QH];
  __shared__ float sm_acc[kWarps][QH][kMaxHeadDim];

  const int split = blockIdx.x;
  const int g = blockIdx.y / p.passes;
  const int pass = blockIdx.y % p.passes;
  const int b = blockIdx.z;
  const int h0 = g * p.qpk + pass * QH;  // first query head of this block
  const int nh = min(QH, p.qpk - pass * QH);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col = (lane % L) * E;        // the lane's first value of D
  const bool active = col < p.d;
  const int gid = warp * G + lane / L;   // the lane's key group

  int64_t len = p.valid_len[b];
  len = len < 0 ? 0 : (len > p.s ? p.s : len);
  const int64_t start = int64_t(split) * p.chunk;
  const int64_t stop = start + p.chunk < len ? start + p.chunk : len;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh + col;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh + col;
  // round r: group gid takes the keys start + r*NG*U + u*NG + gid
  uint4 kr[U], vr[U];
  auto load_round = [&](int64_t base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t pos = base + u * NG + gid;
      if (active && pos < stop) {
        kr[u] = load16(kg + pos * p.k_ss);
        vr[u] = load16(vg + pos * p.v_ss);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load_round(start);

  float qf[QH][E];
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + col;
#pragma unroll
  for (int h = 0; h < QH; ++h) {
    if (active && h < nh) {
      Vec<T>::widen(load16(qg + (h0 + h) * p.q_sh), qf[h]);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[h][e] *= p.scale;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[h][e] = 0.0f;
    }
  }

  float m[QH], l[QH], acc[QH][E];
#pragma unroll
  for (int h = 0; h < QH; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.0f;
  }

  for (int64_t base = start; base < stop; base += NG * U) {
    float s[U][QH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[E];
      Vec<T>::widen(kr[u], x);
#pragma unroll
      for (int h = 0; h < QH; ++h) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[h][e], x[e], dot);
        s[u][h] = dot;
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int h = 0; h < QH; ++h)
          s[u][h] += __shfl_xor_sync(kFullMask, s[u][h], off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * NG + gid >= stop) {
#pragma unroll
        for (int h = 0; h < QH; ++h) s[u][h] = -INFINITY;
      }
    }
    // online softmax over the round's U keys, then acc += P V
#pragma unroll
    for (int h = 0; h < QH; ++h) {
      float mx = s[0][h];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][h]);
      const float m_new = fmaxf(m[h], mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = m[h] == -INFINITY ? 0.0f : exp2f(m[h] - m_safe);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][h] = exp2f(s[u][h] - m_safe);  // masked: exp2f(-inf) = 0
        sum += s[u][h];
      }
      m[h] = m_new;
      l[h] = fmaf(alpha, l[h], sum);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[E];
      Vec<T>::widen(vr[u], x);
#pragma unroll
      for (int h = 0; h < QH; ++h) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(s[u][h], x[e], acc[h][e]);
      }
    }
    if (base + NG * U < stop) load_round(base + NG * U);
  }

  // merge the warp's groups (lanes L apart hold the same slice of D)
#pragma unroll
  for (int off = L; off < 32; off *= 2) {
#pragma unroll
    for (int h = 0; h < QH; ++h) {
      const float m_o = __shfl_xor_sync(kFullMask, m[h], off);
      const float l_o = __shfl_xor_sync(kFullMask, l[h], off);
      const float m_new = fmaxf(m[h], m_o);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float a = exp2f(m[h] - m_safe);
      const float a_o = exp2f(m_o - m_safe);
      l[h] = fmaf(a, l[h], a_o * l_o);
      m[h] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[h][e] = fmaf(a, acc[h][e],
                         a_o * __shfl_xor_sync(kFullMask, acc[h][e], off));
    }
  }
  if (lane < L) {
#pragma unroll
    for (int h = 0; h < QH; ++h) {
      if (lane == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
      if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) sm_acc[warp][h][col + e] = acc[h][e];
      }
    }
  }
  __syncthreads();

  finish_block<T, kWarps, QH, kMaxHeadDim>(p, sm_m, sm_l, sm_acc, nh,
                                           int64_t(b) * p.hq + h0, split);
}

// ---- Tensor-core form: bf16 with D a multiple of 32 --------------------

constexpr int kRows = 16;  // query heads a pass: the rows of an m16n8k16 tile
constexpr int kStep = 16;  // keys a warp takes a round: two n8 tiles
constexpr int kStages = 2;  // rounds of K and V in flight in shared memory
constexpr int kMmaWarps = 8;  // warps a block
constexpr int kMmaThreads = 32 * kMmaWarps;

// The ring: kStages slots of a round's 16-byte pieces, piece-major, so a
// thread's piece i of a slot is ring[(slot * pieces + i) * kMmaThreads +
// tid].
template <int D>
constexpr int ring_bytes() {
  return kStages * (4 * D / 32) * kMmaThreads * 16;
}

// 16 bytes from global to shared memory, asynchronously; bytes = 0 reads
// nothing and writes zeros.  L2 fetches the 256-byte block around them
// (the rest of a key row, or the next KV head's row beside it).
__device__ __forceinline__ void copy16(uint4* dst, const void* src,
                                       int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b for one m16n8k16 tile, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of the 8x8 bf16 matrix whose row i / 4 holds the words of
// lanes i (columns 2 (i % 4) and 2 (i % 4) + 1), in the same layout.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t word(const uint4& x, int w) {
  return w == 0 ? x.x : w == 1 ? x.y : w == 2 ? x.z : x.w;
}

// bf16(lo), bf16(hi) packed low, high (round to nearest even)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One block of 8 warps per (split, KV head, pass of 16 query heads, batch
// row).  A warp takes 16 keys a round, key n of round r at
// start + r * 128 + n * 8 + warp, as two 8-key tiles.  Lane (gr, t) =
// (lane / 4, lane % 4) loads the 16-byte chunks t, t + 4, ... of key gr of
// each tile, of K and of V, and of q for heads gr and gr + 8.  A chunk is
// 4 words of 2 bf16; word w of the lane's chunks is, in the mma layout,
// k = 2t, 2t + 1 of k-step w / 2 when w is even and k = 2t + 8, 2t + 9
// when odd, so S = Q K^T reads K and q as loaded (the dot product does
// not care in which order D is summed).  S comes out as the C fragment
// (rows gr, gr + 8; keys 2t, 2t + 1 of each tile), which is the A fragment
// of P V as it stands.  V is loaded like K; word r of the lanes' chunks,
// over the 8 keys of a tile, is an 8x8 matrix with the keys as rows, and
// its transpose (movmatrix) is the B fragment of the n8 block of D that
// word r covers: lane (gr, t) then holds o for the same chunks it loaded.
// P goes in as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so P V
// keeps about 16 bits of p; S and the products accumulate in float32.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, (D <= 64 ? 2 : 1))
decode_split_mma_kernel(const Params p) {
  follow_previous_kernel();
  using T = __nv_bfloat16;
  constexpr int C = D / 32;  // chunks a lane loads of a row
  constexpr int W = D / 8;   // words a lane holds of a row: n8 blocks of D
  constexpr int P = 4 * C;   // pieces a thread copies a round: K, V x 2 tiles
  __shared__ float sm_m[kMmaWarps][kRows];
  __shared__ float sm_l[kMmaWarps][kRows];
  extern __shared__ uint4 ring[];

  const int split = blockIdx.x;
  const int g = blockIdx.y / p.passes;
  const int pass = blockIdx.y % p.passes;
  const int b = blockIdx.z;
  const int h0 = g * p.qpk + pass * kRows;
  const int nh = min(kRows, p.qpk - pass * kRows);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gr = lane / 4;
  const int t = lane % 4;

  int64_t len = p.valid_len[b];
  len = len < 0 ? 0 : (len > p.s ? p.s : len);
  const int64_t start = int64_t(split) * p.chunk;
  const int64_t stop = start + p.chunk < len ? start + p.chunk : len;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh + 8 * t;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh + 8 * t;
  // round r goes to slot r % kStages, kStages rounds ahead of its math;
  // each thread reads back only the pieces it copied
  auto issue = [&](int64_t base, int slot) {
    uint4* dst = ring + slot * P * kMmaThreads + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t pos = base + (8 * j + gr) * kMmaWarps + warp;
      const bool ok = pos < stop;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        copy16(dst + (2 * (j * C + i)) * kMmaThreads,
               ok ? kg + pos * p.k_ss + 32 * i : p.k, ok ? 16 : 0);
        copy16(dst + (2 * (j * C + i) + 1) * kMmaThreads,
               ok ? vg + pos * p.v_ss + 32 * i : p.v, ok ? 16 : 0);
      }
    }
    copy_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st)
    issue(start + st * kMmaWarps * kStep, st);

  uint4 qr[2][C];  // heads gr and gr + 8; zero past the pass's heads
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + 8 * t;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int i = 0; i < C; ++i)
      qr[hf][i] = gr + 8 * hf < nh
                      ? load16(qg + (h0 + gr + 8 * hf) * p.q_sh + 32 * i)
                      : make_uint4(0u, 0u, 0u, 0u);
  }

  float o[W][4];  // n8 block r: rows gr (0, 1) and gr + 8 (2, 3)
#pragma unroll
  for (int r = 0; r < W; ++r) o[r][0] = o[r][1] = o[r][2] = o[r][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this lane's part of the row sums

  int slot = 0;
  for (int64_t base = start; base < stop; base += kMmaWarps * kStep) {
    copy_wait<kStages - 1>();  // this thread's pieces of this round landed
    uint4 kr[2][C], vr[2][C];
    const uint4* src = ring + slot * P * kMmaThreads + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < C; ++i) {
        kr[j][i] = src[(2 * (j * C + i)) * kMmaThreads];
        vr[j][i] = src[(2 * (j * C + i) + 1) * kMmaThreads];
      }
    }
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int w = 2 * (ks % 2);  // words w, w + 1 of chunk ks / 2
        const uint32_t a[4] = {
            word(qr[0][ks / 2], w), word(qr[1][ks / 2], w),
            word(qr[0][ks / 2], w + 1), word(qr[1][ks / 2], w + 1)};
        mma16816(s[j], a, word(kr[j][ks / 2], w),
                 word(kr[j][ks / 2], w + 1));
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = base + (8 * j + 2 * t + e) * kMmaWarps + warp < stop;
        s[j][e] = in ? s[j][e] * p.scale : -INFINITY;
        s[j][2 + e] = in ? s[j][2 + e] * p.scale : -INFINITY;
      }
    }
    // online softmax of rows gr (hf = 0) and gr + 8 (hf = 1): the row's
    // max over the group's four lanes, each lane's part of its sum
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = fmaxf(fmaxf(s[0][2 * hf], s[0][2 * hf + 1]),
                       fmaxf(s[1][2 * hf], s[1][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      alpha[hf] = m[hf] == -INFINITY ? 0.0f : exp2f(m[hf] - m_safe);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][2 * hf + e] = exp2f(s[j][2 * hf + e] - m_safe);
          sum += s[j][2 * hf + e];
        }
      }
      m[hf] = m_new;
      l[hf] = fmaf(alpha[hf], l[hf], sum);
    }
    if (__any_sync(kFullMask, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int r = 0; r < W; ++r) {
        o[r][0] *= alpha[0];
        o[r][1] *= alpha[0];
        o[r][2] *= alpha[1];
        o[r][3] *= alpha[1];
      }
    }
    // P as the A fragment (k = the 16 keys), in two bf16 terms
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float p0 = s[j][2 * hf], p1 = s[j][2 * hf + 1];
        const uint32_t h = pack2(p0, p1);
        hi[2 * j + hf] = h;
        lo[2 * j + hf] = pack2(p0 - __uint_as_float(h << 16),
                               p1 - __uint_as_float(h & 0xffff0000u));
      }
    }
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const uint32_t b0 = transpose8x8(word(vr[0][r / 4], r % 4));
      const uint32_t b1 = transpose8x8(word(vr[1][r / 4], r % 4));
      mma16816(o[r], hi, b0, b1);
      mma16816(o[r], lo, b0, b1);
    }
    issue(base + kStages * kMmaWarps * kStep, slot);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  copy_wait<0>();
  __syncthreads();  // the ring becomes the warps' merge area
  auto& sm_acc = *reinterpret_cast<float(*)[kMmaWarps][kRows][D]>(ring);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(kFullMask, l[hf], 1);
    l[hf] += __shfl_xor_sync(kFullMask, l[hf], 2);
  }
  if (t == 0) {
    sm_m[warp][gr] = m[0];
    sm_m[warp][gr + 8] = m[1];
    sm_l[warp][gr] = l[0];
    sm_l[warp][gr + 8] = l[1];
  }
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const int c = 8 * (t + 4 * (r / 4)) + 2 * (r % 4);
    sm_acc[warp][gr][c] = o[r][0];
    sm_acc[warp][gr][c + 1] = o[r][1];
    sm_acc[warp][gr + 8][c] = o[r][2];
    sm_acc[warp][gr + 8][c + 1] = o[r][3];
  }
  __syncthreads();
  finish_block<T, kMmaWarps, kRows, D>(p, sm_m, sm_l, sm_acc, nh,
                                       int64_t(b) * p.hq + h0, split);
}

// One block per (batch row, query head).  Warp 0 folds the splits' (m, l)
// into M = max m and L = sum 2^(m - M) l (lanes online, then shuffles),
// while every thread loads the float4 column t % (D/4) of up to 8 of the
// splits t / (D/4), t / (D/4) + 128 / (D/4), ... (independent loads); then
// each weighs its columns by 2^(m - M), the threads of a column add
// theirs in shared memory, and o = sum / max(L, 1e-30) in q's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const Params p) {
  follow_previous_kernel();
  constexpr int kAhead = 8;  // splits a thread loads before M is known
  __shared__ float sm_ml[2];
  __shared__ float4 sm_a[kThreads];
  const int64_t row = blockIdx.x;  // b * Hq + h
  const float* wm = p.ws_m + row * p.splits;
  const float* wl = p.ws_l + row * p.splits;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = -INFINITY;
    float l = 0.0f;
    for (int sp = lane; sp < p.splits; sp += 32) {
      const float m_s = wm[sp];
      const float m_new = fmaxf(m, m_s);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      l = fmaf(exp2f(m - m_safe), l, exp2f(m_s - m_safe) * wl[sp]);
      m = m_new;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float m_o = __shfl_xor_sync(kFullMask, m, off);
      const float l_o = __shfl_xor_sync(kFullMask, l, off);
      const float m_new = fmaxf(m, m_o);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      l = fmaf(exp2f(m - m_safe), l, exp2f(m_o - m_safe) * l_o);
      m = m_new;
    }
    if (lane == 0) {
      sm_ml[0] = m == -INFINITY ? 0.0f : m;  // a row of no key: weights 0
      sm_ml[1] = l;
    }
  }
  const int cols = p.d / 4;
  const int lanes = kThreads / cols;
  const int c = threadIdx.x % cols;
  const int sl = threadIdx.x / cols;
  const float4* wa =
      reinterpret_cast<const float4*>(p.ws_acc + row * p.splits * p.d) + c;
  float4 x[kAhead];
  float mx[kAhead];
  int n = 0;
  if (sl < lanes) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int sp = sl + i * lanes;
      if (sp < p.splits) {
        x[i] = wa[int64_t(sp) * cols];
        mx[i] = wm[sp];
        n = i + 1;
      }
    }
  }
  __syncthreads();
  const float m_max = sm_ml[0];
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (sl < lanes) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < n) {
        const float w = exp2f(mx[i] - m_max);
        a.x = fmaf(w, x[i].x, a.x);
        a.y = fmaf(w, x[i].y, a.y);
        a.z = fmaf(w, x[i].z, a.z);
        a.w = fmaf(w, x[i].w, a.w);
      }
    }
    for (int sp = sl + kAhead * lanes; sp < p.splits; sp += lanes) {
      const float w = exp2f(wm[sp] - m_max);
      const float4 y = wa[int64_t(sp) * cols];
      a.x = fmaf(w, y.x, a.x);
      a.y = fmaf(w, y.y, a.y);
      a.z = fmaf(w, y.z, a.z);
      a.w = fmaf(w, y.w, a.w);
    }
  }
  sm_a[threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.x >= cols) return;
  for (int j = 1; j < lanes; ++j) {
    const float4 y = sm_a[j * cols + c];
    a.x += y.x;
    a.y += y.y;
    a.z += y.z;
    a.w += y.w;
  }
  T* out = static_cast<T*>(p.o) + row * p.d + 4 * c;
  const float den = fmaxf(sm_ml[1], 1e-30f);
  store(out + 0, a.x / den);
  store(out + 1, a.y / den);
  store(out + 2, a.z / den);
  store(out + 3, a.w / den);
}

// Launches kernel<<<grid, threads, smem, stream>>>(p) with programmatic
// stream serialisation (see follow_previous_kernel).
cudaError_t launch(void (*kernel)(Params), dim3 grid, int threads, int smem,
                   const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// The split pass, then, where the plan has more than one split, the
// combine.
template <typename T>
cudaError_t split_then_combine(void (*split)(Params), int threads, int smem,
                               const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(unsigned(p.splits), unsigned(p.hkv * p.passes),
                  unsigned(p.b));
  const cudaError_t err = launch(split, grid, threads, smem, p, stream);
  if (err != cudaSuccess || p.splits == 1) return err;
  return launch(decode_combine_kernel<T>, dim3(unsigned(int64_t(p.b) * p.hq)),
                kThreads, 0, p, stream);
}

template <typename T, int L, int QH>
cudaError_t launch_simt(const Params& p, cudaStream_t stream) {
  return split_then_combine<T>(decode_split_simt_kernel<T, L, QH>, kThreads,
                               0, p, stream);
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  return split_then_combine<__nv_bfloat16>(
      decode_split_mma_kernel<D>, kMmaThreads, ring_bytes<D>(), p, stream);
}

template <typename T, int L>
cudaError_t by_heads(const Params& p, int qh, cudaStream_t stream) {
  switch (qh) {
    case 1: return launch_simt<T, L, 1>(p, stream);
    case 2: return launch_simt<T, L, 2>(p, stream);
    case 4: return launch_simt<T, L, 4>(p, stream);
    default: return launch_simt<T, L, 8>(p, stream);
  }
}

// The CUDA-core form, by L, the lanes a key: D * itemsize / 16 rounded up
// to a power of two.  float32 takes 4 (D = 16) to 32 (D > 64); bf16 comes
// here only with D = 16 (L = 2), 48 (8), 80 or 112 (16).
cudaError_t dispatch_simt(const Params& p, int is_bf16, int lanes, int qh,
                          cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (is_bf16) {
    switch (lanes) {
      case 2: return by_heads<bf16, 2>(p, qh, stream);
      case 8: return by_heads<bf16, 8>(p, qh, stream);
      case 16: return by_heads<bf16, 16>(p, qh, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (lanes) {
    case 4: return by_heads<float, 4>(p, qh, stream);
    case 8: return by_heads<float, 8>(p, qh, stream);
    case 16: return by_heads<float, 16>(p, qh, stream);
    case 32: return by_heads<float, 32>(p, qh, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_mma(const Params& p, cudaStream_t stream) {
  switch (p.d) {
    case 32: return launch_mma<32>(p, stream);
    case 64: return launch_mma<64>(p, stream);
    case 96: return launch_mma<96>(p, stream);
    case 128: return launch_mma<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches the split pass and,
// where splits > 1, the combine on ``stream`` (PyTorch's current stream),
// allocates nothing, does not synchronise, and returns the first failing
// launch's cudaError_t (0 = success).  ``ws`` holds B * Hq * splits *
// (D + 2) floats where splits > 1 (it may be null otherwise);
// splits * chunk covers S.  Strides are in elements; the head dim is
// contiguous, and the output is a contiguous (B, Hq, D).  The caller has
// checked shapes, dtypes (float32 or bfloat16, all alike; valid_len
// int32), D in {16, 32, ..., 128}, Hq % Hkv == 0, Hq / Hkv <= 64, B, S >= 1,
// and that every pointer and stride is 16-byte aligned.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* valid_len,
    void* o, void* ws, long long b, long long s, int hq, int hkv, int d,
    int splits, long long chunk, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int is_bf16, void* stream) {
  const int itemsize = is_bf16 ? 2 : 4;
  if (b < 1 || b > 65535 || s < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 ||
      hq / hkv > 64 || d < 16 || d > kMaxHeadDim || d % 16 != 0 ||
      splits < 1 || chunk < 1 || (splits - 1) * chunk >= s ||
      splits * chunk < s || (splits > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int qpk = hq / hkv;
  // bf16 with D a multiple of 32 takes the tensor cores, 16 heads a pass;
  // the rest the CUDA cores, 1, 2, 4 or 8 heads a pass
  const bool mma = is_bf16 && d % 32 == 0;
  const int qh = mma ? kRows : qpk <= 1 ? 1 : qpk <= 2 ? 2 : qpk <= 4 ? 4 : 8;
  const int passes = (qpk + qh - 1) / qh;
  if (int64_t(hkv) * passes > 65535) return int(cudaErrorInvalidValue);
  int lanes = itemsize;
  while (lanes * 16 < d * itemsize) lanes *= 2;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid_len = static_cast<const int32_t*>(valid_len);
  p.o = o;
  const int64_t parts = int64_t(b) * hq * splits;
  p.ws_acc = static_cast<float*>(ws);
  p.ws_m = splits > 1 ? p.ws_acc + parts * d : nullptr;
  p.ws_l = splits > 1 ? p.ws_m + parts : nullptr;
  p.s = s;
  p.chunk = chunk;
  p.b = int(b);
  p.hq = hq;
  p.hkv = hkv;
  p.qpk = qpk;
  p.d = d;
  p.splits = splits;
  p.passes = passes;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  // the oracle's float32 scale 1 / sqrt(f32(D)), times log2(e) for exp2f
  p.scale = (1.0f / sqrtf(float(d))) * kLog2e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(mma ? dispatch_mma(p, st)
                 : dispatch_simt(p, is_bf16, lanes, qh, st));
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
