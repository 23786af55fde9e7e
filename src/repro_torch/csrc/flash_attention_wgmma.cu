// Flash attention on Hopper's tensor cores (sm_90a), bf16, head dim 64 or 128:
//
//     o[b, i, h, :] = sum_j softmax_j( (q[b,i,h,:] . k[b,j,g,:]) * scale ) v[b,j,g,:]
//     g = h / (Hq / Hkv),  scale = 1 / sqrt(D),  over the visible keys j
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:25
// (function _flash_kernel, wrapper flash_attention) for bf16 q, k, v with
// D in {64, 128}; csrc/flash_attention.cu keeps float32 and the other D.
//
// What bounds it on an H100: operations.  A visible (query, key) pair costs
// 4*D flops (two products); with P split in two bf16 terms (below) the
// tensor cores are issued 6*D.  At the qwen3-8b prefill shape (B=4,
// T=2,048, 32/8 heads, D=128, causal) that is 137.5 GFLOP needed, 206
// issued, against 168 MB of q, k, v and o: far above the ~295 flops a byte
// where the bf16 tensor cores (989 TFLOP/s) stop waiting for memory.
//
// Design (FlashAttention-3's shape, without its intra-warpgroup overlap):
// * One CTA per (128-row query tile, query head, batch row), heaviest tile
//   first.  Three warpgroups: a producer and two consumers of 64 query rows
//   each.  The producer gives back registers (setmaxnreg 24), the consumers
//   take them (240): S, O and the two P terms live in registers.
// * TMA loads the Q tile once, then K and V tiles of 128 keys into a ring
//   of two stages, each with a full barrier per operand and one empty
//   barrier, in 128-byte-swizzled shared memory (a 128-byte row holds 64
//   bf16; at D=128 a tile is two such boxes).  q, k and v are read in
//   place: each tensor map spans (D, T, H, B) with the tensor's strides.
//   Rows past Tq or Tk arrive zero-filled.
// * S = Q K^T: wgmma with both operands in shared memory, float32
//   accumulators.  bf16 products are exact in float32, so S differs from
//   the reference only in the order of summation.
// * Online softmax on the accumulator fragment: each thread holds two rows'
//   values, a row's max and sum span the thread's quad.  Masks are applied
//   only to tiles that cross Tk, the causal diagonal or the window edge;
//   tiles that no row can see are never loaded.
// * O += P V with P in two bf16 terms, P_hi = bf16(P) and P_lo = bf16(P -
//   P_hi), both re-laid from the accumulator fragment into wgmma's register
//   A operand; V is the B operand read MN-major (the descriptor's transpose
//   bit).  One bf16 term would round P to 8 bits, an error the model's
//   check (attention within bf16 rounding of float32) does not allow; two
//   terms carry 16 bits, as good as float32 P there.  l sums float32 P.
// * Epilogue: O / max(l, 1e-30) in bf16, staged through the consumer's
//   rows of the Q tile, written with 16-byte stores; rows past Tq are not
//   written.
//
// Numerics follow _flash_kernel: masks kpos < Tk, qpos >= kpos if causal,
// kpos > qpos - window if window > 0, positions from 0; masked logits are
// -inf; the running max is guarded (m_safe = 0 where m is -inf, alpha = 0
// where the previous max is -inf), so a fully masked tile adds exactly 0
// and a row that sees no key comes out exactly 0.  The logit is
// (q . k) * scale; exp(x) is exp2f(x * log2(e)).
#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // query rows per CTA, 64 per consumer
constexpr int kBK = 128;       // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kRowBytes = 128; // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  long long o_sb, o_st, o_sh;
  int tq, tk, hq, hkv;
  int causal, window;
  float scale;
};

// Byte offsets into the 1024-byte-aligned dynamic shared memory.  Each
// operand tile is D/64 boxes of (rows x 128 bytes), box after box.
template <int D>
struct Layout {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (unused K-major; the stride between 64-column boxes
// MN-major), stride byte offset 1024 (eight 128-byte rows)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving a register across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// d(64x128) = a(64x16) * b(16x128) (+ d if accumulate); a and b K-major in
// shared memory, read through their descriptors
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d(64x64) += a(64x16) * b(16x64); a in registers (the accumulator-shaped
// fragment), b MN-major in shared memory (the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d(64x128) += a(64x16) * b(16x128); a in registers (the accumulator-shaped
// fragment), b MN-major in shared memory (the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, b);
  } else {
    wgmma_rs_n128(o, a, b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const Params p) {
  using L = Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128B swizzle: 1 KB atoms
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;                  // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_e = bar_v + 8 * kStages;

  const int qtile = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q0 = qtile * kBQ;
  // the K tiles some row of this query tile can see
  const int q_last = min(q0 + kBQ, p.tq) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.tk, q_last + 1) : p.tk;
  const int t_first = k_lo / kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi + kBK - 1) / kBK - t_first : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < kBoxes; ++c)
        tma_load(base + L::kQ + c * kBQ * kRowBytes, &q_map, bar_q, 64 * c,
                 q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages)  // the consumers have released this stage
          mbar_wait(bar_e + 8 * s, ((it / kStages) - 1) & 1);
        const int k0 = (t_first + it) * kBK;
        mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + L::kK + s * L::kKVBytes + c * kBK * kRowBytes,
                   &k_map, bar_k + 8 * s, 64 * c, k0, kvh, b);
        mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
        for (int c = 0; c < kBoxes; ++c)
          tma_load(base + L::kV + s * L::kKVBytes + c * kBK * kRowBytes,
                   &v_map, bar_v + 8 * s, 64 * c, k0, kvh, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = tid / 128 - 1;  // consumer 0 or 1: rows 64 cw .. 64 cw + 63
    const int t = tid % 128;
    const int lane = t % 32;
    const int quad = lane % 4;
    // this thread's two rows of the accumulator fragment: r and r + 8
    const int row0 = 16 * (t / 32) + lane / 4;
    const int q_lo = q0 + 64 * cw;
    const int qpos[2] = {q_lo + row0, q_lo + row0 + 8};
    const uint32_t q_base = base + L::kQ + 64 * cw * kRowBytes;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};  // this thread's share of each row's sum

    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const int k0 = (t_first + it) * kBK;
      const uint32_t k_base = base + L::kK + s * L::kKVBytes;
      const uint32_t v_base = base + L::kV + s * L::kKVBytes;

      // S = Q K^T over D in steps of 16 (32 bytes inside a swizzled row);
      // the first step overwrites S, zeroed only so that nothing stays
      // live from the previous tile
      float sacc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.0f;
      mbar_wait(bar_k + 8 * s, phase);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_ss_n128(sacc,
                      desc(q_base + (ks / 4) * kBQ * kRowBytes + off, 16),
                      desc(k_base + (ks / 4) * kBK * kRowBytes + off, 16),
                      ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // logits, masked only where the tile crosses Tk, the diagonal or
      // the window edge for some row of this consumer
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sacc[i] = sacc[i] * p.scale;
      const bool edge = k0 + kBK > p.tk ||
                        (p.causal && k0 + kBK - 1 > q_lo) ||
                        (p.window > 0 && k0 <= q_lo + 63 - p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int qp = qpos[(i >> 1) & 1];
          const int kp = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
          bool ok = kp < p.tk;
          if (p.causal) ok = ok && qp >= kp;
          if (p.window > 0) ok = ok && kp > qp - p.window;
          if (!ok) sacc[i] = -INFINITY;
        }
      }

      // online softmax: element i is row (i >> 1) & 1, column
      // 8 (i / 4) + 2 quad + (i & 1); a row's values span the quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      float m_safe[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_safe[r] = m_new == -INFINITY ? 0.0f : m_new;
        alpha[r] = m[r] == -INFINITY ? 0.0f
                                     : exp2f((m[r] - m_safe[r]) * kLog2e);
        m[r] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sacc[i] = exp2f((sacc[i] - m_safe[r]) * kLog2e);  // -inf -> 0
        rs[r] += sacc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = o[i] * alpha[(i >> 1) & 1];

      // P in two bf16 terms, as wgmma's A fragment: register q of k-step
      // ks is accumulator block 2 ks + (q >> 1), row (q & 1)
      uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = (2 * ks + (q >> 1)) * 4 + (q & 1) * 2;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(sacc[i], sacc[i + 1]);
          const float2 back = __bfloat1622float2(hi);
          p_hi[ks][q] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[ks][q] = pack_bf16(sacc[i] - back.x, sacc[i + 1] - back.y);
        }
      }

      // O += P_hi V + P_lo V over the tile's keys in steps of 16 rows
      mbar_wait(bar_v + 8 * s, phase);
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_pv<D>(o, p_hi[ks],
                    desc(v_base + ks * 16 * kRowBytes, kBK * kRowBytes));
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_pv<D>(o, p_lo[ks],
                    desc(v_base + ks * 16 * kRowBytes, kBK * kRowBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);  // stage s is free
    }

    // ---------------------------------------------------------- epilogue
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      denom[r] = fmaxf(l[r], 1e-30f);
    }
    // bf16 O into this consumer's rows of the Q tile, in the same swizzled
    // layout, once all four warps are past their last read of Q; then
    // 16-byte stores
    uint8_t* const ob = base_ptr + L::kQ + 64 * cw * kRowBytes;
    asm volatile("bar.sync %0, 128;" :: "r"(1 + cw) : "memory");
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const int col = (8 * j) % 64 + 2 * quad;
        const int off = (j / 8) * kBQ * kRowBytes + row * kRowBytes +
                        (((col / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
        *reinterpret_cast<uint32_t*>(ob + off) =
            pack_bf16(o[4 * j + 2 * r] / denom[r],
                      o[4 * j + 2 * r + 1] / denom[r]);
      }
    }
    asm volatile("bar.sync %0, 128;" :: "r"(1 + cw) : "memory");
    __nv_bfloat16* const og = static_cast<__nv_bfloat16*>(p.o) +
                              b * p.o_sb + h * p.o_sh;
    for (int e = t; e < 64 * D / 8; e += 128) {
      const int row = e / (D / 8);
      const int g = e % (D / 8);  // 16-byte group of the row
      const int qp = q_lo + row;
      if (qp >= p.tq) continue;
      const int off = (g / 8) * kBQ * kRowBytes + row * kRowBytes +
                      (((g % 8) ^ (row % 8)) * 16);
      *reinterpret_cast<uint4*>(og + qp * p.o_st + 8 * g) =
          *reinterpret_cast<const uint4*>(ob + off);
    }
  }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, T, H, D) bf16 tensor as a 4-d map (D, T, H, B), boxes of 64
// columns x ``rows`` rows, 128-byte swizzle, zero fill past the edges.
// Strides are in elements; a dimension of size 1 takes a placeholder.
CUresult encode(CUtensorMap* map, const void* ptr, long long b, long long t,
                long long heads, int d, long long sb, long long st,
                long long sh, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(t),
                              cuuint64_t(heads), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(2 * (t > 1 ? st : d)),
                                 cuuint64_t(2 * (heads > 1 ? sh : d)),
                                 cuuint64_t(2 * (b > 1 ? sb : d))};
  const cuuint32_t box[4] = {64, cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const Params& p, int b,
                   cudaStream_t stream) {
  const int smem = Layout<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned((p.tq + kBQ - 1) / kBQ), unsigned(p.hq),
                  unsigned(b));
  flash_attention_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, p);
  return cudaGetLastError();
}

constexpr int kEncodeFailed = 100000;  // + the CUresult

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream``
// (PyTorch's current stream), allocates nothing, does not synchronise, and
// returns the launch's cudaError_t (0 = success), or kEncodeFailed + the
// CUresult when a tensor map cannot be encoded.  q, k and v are bf16 with
// the head dim contiguous; strides are in elements.  The caller has checked
// shapes, D in {64, 128}, Hq % Hkv == 0, B, Tq, Tk >= 1, and that every
// data pointer and every B, T and H stride is a multiple of 16 bytes.  The
// output is (B, Tq, Hq, D) with 16-byte-aligned rows.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o,
    long long b, long long tq, long long tk, int hq, int hkv, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int window, void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hkv < 1 ||
      hq % hkv != 0 || tq < 1 || tk < 1 || tq > 0x7fffff00LL ||
      tk > 0x7fffff00LL || window < 0 || (d != 64 && d != 128))
    return int(cudaErrorInvalidValue);
  if (encoder() == nullptr) return int(cudaErrorSymbolNotFound);
  CUtensorMap qm, km, vm;
  CUresult r = encode(&qm, q, b, tq, hq, d, q_sb, q_st, q_sh, kBQ);
  if (r == CUDA_SUCCESS)
    r = encode(&km, k, b, tk, hkv, d, k_sb, k_st, k_sh, kBK);
  if (r == CUDA_SUCCESS)
    r = encode(&vm, v, b, tk, hkv, d, v_sb, v_st, v_sh, kBK);
  if (r != CUDA_SUCCESS) return kEncodeFailed + int(r);
  Params p;
  p.o = o;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.tq = int(tq);
  p.tk = int(tk);
  p.hq = hq;
  p.hkv = hkv;
  p.causal = causal != 0;
  p.window = window;
  p.scale = 1.0f / sqrtf(float(d));  // as the oracle: 1 / sqrt(f32(D))
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = d == 64 ? launch<64>(qm, km, vm, p, int(b), s)
                                  : launch<128>(qm, km, vm, p, int(b), s);
  return int(err);
}

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
