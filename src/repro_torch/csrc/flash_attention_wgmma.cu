// Flash attention on Hopper's tensor cores (sm_90a), bf16, head dim 64, 80
// or 128:
//
//     o[b, i, h, :] = sum_j softmax_j( (q[b,i,h,:] . k[b,j,g,:]) * scale ) v[b,j,g,:]
//     g = h / (Hq / Hkv),  scale = 1 / sqrt(D),  over the visible keys j
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:25
// (function _flash_kernel, wrapper flash_attention) for bf16 q, k, v with
// D in {64, 80, 128}; csrc/flash_attention.cu keeps float32 and the other D.
//
// What bounds it on an H100: operations.  A visible (query, key) pair costs
// 4*D flops (two products); with P split in two bf16 terms (below) the
// tensor cores are issued 6*D.  At the qwen3-8b prefill shape (B=4,
// T=2,048, 32/8 heads, D=128, causal) that is 137.5 GFLOP needed, 206
// issued, against 168 MB of q, k, v and o: far above the ~295 flops a byte
// where the bf16 tensor cores (989 TFLOP/s) stop waiting for memory.  At
// hubert-xlarge's (B=4, T=2,048, 16/16 heads, D=80, bidirectional) 85.9
// GFLOP needed, 128.8 issued; its 268 M exponentials weigh more against
// the products at D=80 than at D=128.
//
// Design (FlashAttention-3's shape, without its intra-warpgroup overlap):
// * One CTA per (128-row query tile, query head, batch row), heaviest tile
//   first.  Three warpgroups: a producer and two consumers of 64 query rows
//   each.  The producer gives back registers (setmaxnreg 24), the consumers
//   take them (240): S, O and the two P terms live in registers.
// * TMA loads the Q tile once, then K and V tiles of 128 keys into a ring
//   of stages, each with a full barrier per operand and one empty barrier,
//   in swizzled shared memory.  An operand tile is D / C boxes of rows x C
//   columns, box after box (struct Tile): for D = 64 and 128, C = 64 (a
//   128-byte row, 128-byte swizzle, 1 KB atoms); for D = 80, whose 160-byte
//   row is no whole number of 128-byte atoms, C = 16 (a 32-byte row,
//   32-byte swizzle, 256-byte atoms: CUTLASS's choice for a K extent that
//   is a multiple of 16 but not of 32), five boxes an operand.  q, k and v
//   are read in place: each tensor map spans (D, T, H, B) with the
//   tensor's strides.  Rows past Tq or Tk arrive zero-filled.
// * S = Q K^T: wgmma m64n128k16, one k-step per 16 columns, with both
//   operands K-major in shared memory, float32 accumulators.  bf16
//   products are exact in float32, so S differs from the reference only in
//   the order of summation.
// * Online softmax on the accumulator fragment: each thread holds two rows'
//   values, a row's max and sum span the thread's quad.  Masks are applied
//   only to tiles that cross Tk, the causal diagonal or the window edge;
//   tiles that no row can see are never loaded.
// * O += P V (m64nDk16, one a 16-key step) with P in two bf16 terms, P_hi =
//   bf16(P) and P_lo = bf16(P - P_hi), both re-laid from the accumulator
//   fragment into wgmma's register A operand; V is the B operand read
//   MN-major (the descriptor's transpose bit, its leading byte offset the
//   stride between boxes).  One bf16 term would round P to 8 bits, an
//   error the model's check (attention within bf16 rounding of float32)
//   does not allow; two terms carry 16 bits, as good as float32 P there.
//   l sums float32 P.  O is D/2 floats a thread (40 at D = 80).
// * Epilogue: O / max(l, 1e-30) in bf16, staged through the consumer's
//   rows of the Q tile in the same swizzled layout, written with 16-byte
//   stores, exactly D columns a row (the next head of a packed projection
//   starts at column D); rows past Tq are not written.
//
// Numerics follow _flash_kernel at every D: masks kpos < Tk, qpos >= kpos
// if causal, kpos > qpos - window if window > 0, positions from 0; masked
// logits are -inf; the running max is guarded (m_safe = 0 where m is -inf,
// alpha = 0 where the previous max is -inf), so a fully masked tile adds
// exactly 0 and a row that sees no key comes out exactly 0.  The logit is
// (q . k) * scale; exp(x) is exp2f(x * log2(e)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::tma_load;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait_all;

constexpr int kBQ = 128;       // query rows per CTA, 64 per consumer
constexpr int kBK = 128;       // keys per K/V tile
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kStagesD80 = 2;  // K/V ring depth at D = 80
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one swizzled shared-memory row of a D-column operand: 64 bf16
// under the 128-byte swizzle where D is a multiple of 64, else 16 bf16
// under the 32-byte swizzle
__host__ __device__ constexpr int row_bytes(int d) {
  return d % 64 == 0 ? 128 : 32;
}

// The shared-memory form of a D-column operand tile: D / kBoxCols boxes of
// (rows x kRowBytes), each row swizzled in 16-byte chunks within atoms of
// eight rows (CUTLASS's Swizzle<log2(kRowBytes / 16), 4, 3>).
template <int D>
struct Tile {
  static_assert(D == 64 || D == 80 || D == 128, "head dim 64, 80 or 128");
  static constexpr int kRowBytes = row_bytes(D);
  static constexpr int kBoxCols = kRowBytes / 2;    // bf16 columns a box
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kChunks = kRowBytes / 16;    // 16-byte chunks a row
  static constexpr int kAtomBytes = 8 * kRowBytes;  // the swizzle's repeat
  static constexpr int kStages = D == 80 ? kStagesD80 : 2;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 3 = 32-byte
  static constexpr uint64_t kLayoutType = kRowBytes == 128 ? 1 : 3;

  // byte offset of 16-byte chunk ``chunk`` of row ``row`` inside a box
  // whose rows start at an atom boundary
  __device__ static constexpr int at(int row, int chunk) {
    return row * kRowBytes +
           ((chunk ^ ((row * kRowBytes >> 7) & (kChunks - 1))) * 16);
  }
};

struct Params {
  void* o;
  long long o_sb, o_st, o_sh;
  int tq, tk, hq, hkv;
  int causal, window;
  float scale;
};

// Byte offsets into the 1024-byte-aligned dynamic shared memory (every
// box starts at an atom boundary).  Each operand tile is Tile<D>::kBoxes
// boxes, box after box.
template <int D>
struct Layout {
  static constexpr int kStages = Tile<D>::kStages;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block gets");
};

// wgmma shared-memory descriptor of a Tile<D> operand: start address,
// leading byte offset (unused K-major; the stride between boxes MN-major),
// stride byte offset one atom (eight rows), the swizzle's layout type
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  using T = Tile<D>;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(T::kAtomBytes >> 4) << 32) | (T::kLayoutType << 62);
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

// d(64x80) += a(64x16) * b(16x80); a in registers (the accumulator-shaped
// fragment), b MN-major in shared memory (the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
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
  } else if constexpr (D == 80) {
    wgmma_rs_n80(o, a, b);
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
  using T = Tile<D>;
  constexpr int kStages = L::kStages;
  constexpr int kRowBytes = T::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // whole atoms at any D
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
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(base + L::kQ + c * kBQ * kRowBytes, &q_map, bar_q,
                 T::kBoxCols * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages)  // the consumers have released this stage
          mbar_wait(bar_e + 8 * s, ((it / kStages) - 1) & 1);
        const int k0 = (t_first + it) * kBK;
        mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(base + L::kK + s * L::kKVBytes + c * kBK * kRowBytes,
                   &k_map, bar_k + 8 * s, T::kBoxCols * c, k0, kvh, b);
        mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(base + L::kV + s * L::kKVBytes + c * kBK * kRowBytes,
                   &v_map, bar_v + 8 * s, T::kBoxCols * c, k0, kvh, b);
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

      // S = Q K^T over D in steps of 16 (32 bytes of a swizzled row: a
      // quarter of a 128-byte row, a whole 32-byte one); the first step
      // overwrites S, zeroed only so that nothing stays live from the
      // previous tile
      float sacc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.0f;
      mbar_wait(bar_k + 8 * s, phase);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        constexpr int kSteps = T::kBoxCols / 16;  // k-steps a box
        const uint32_t off = (ks % kSteps) * 32;
        wgmma_ss_n128(
            sacc, desc<D>(q_base + (ks / kSteps) * kBQ * kRowBytes + off, 16),
            desc<D>(k_base + (ks / kSteps) * kBK * kRowBytes + off, 16),
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
                    desc<D>(v_base + ks * 16 * kRowBytes, kBK * kRowBytes));
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_pv<D>(o, p_lo[ks],
                    desc<D>(v_base + ks * 16 * kRowBytes, kBK * kRowBytes));
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
    for (int j = 0; j < D / 8; ++j) {  // columns 8 j .. 8 j + 7
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const int off = (j / T::kChunks) * kBQ * kRowBytes +
                        T::at(row, j % T::kChunks) + 4 * quad;
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
      const int off = (g / T::kChunks) * kBQ * kRowBytes +
                      T::at(row, g % T::kChunks);
      *reinterpret_cast<uint4*>(og + qp * p.o_st + 8 * g) =
          *reinterpret_cast<const uint4*>(ob + off);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const Params& p, long long b,
                   cudaStream_t stream) {
  return hopper::launch(flash_attention_wgmma_kernel<D>, Layout<D>::kBytes,
                        kBQ, kThreads, qm, km, vm, p, p.tq, p.hq, b,
                        stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream`` (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = success), or hopper::kEncodeFailed + the CUresult
// when a tensor map cannot be encoded.  q, k and v are bf16 with the head dim
// contiguous; strides are in elements.  The caller has checked shapes, D in
// {64, 80, 128} (any other D returns cudaErrorInvalidValue), Hq % Hkv == 0,
// B, Tq, Tk >= 1, and that every data pointer and every B, T and H stride is
// a multiple of 16 bytes.  The output is (B, Tq, Hq, D) with 16-byte-aligned
// rows.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o,
    long long b, long long tq, long long tk, int hq, int hkv, int d,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    int causal, int window, void* stream) {
  const int bad = hopper::check_shapes(b, tq, tk, hq, hkv, d, window);
  if (bad != 0) return bad;
  const auto encode = [&](CUtensorMap* map, const void* ptr, long long t,
                          int heads, long long sb, long long st,
                          long long sh, int rows) {
    return hopper::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          row_bytes(d), ptr, b, t, heads, d, sb, st, sh,
                          rows);
  };
  CUtensorMap qm, km, vm;
  CUresult r = encode(&qm, q, tq, hq, q_sb, q_st, q_sh, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&km, k, tk, hkv, k_sb, k_st, k_sh, kBK);
  if (r == CUDA_SUCCESS) r = encode(&vm, v, tk, hkv, v_sb, v_st, v_sh, kBK);
  if (r != CUDA_SUCCESS) return hopper::kEncodeFailed + int(r);
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
  const cudaError_t err =
      d == 64   ? launch<64>(qm, km, vm, p, b, s)
      : d == 80 ? launch<80>(qm, km, vm, p, b, s)
                : launch<128>(qm, km, vm, p, b, s);
  return int(err);
}

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  return hopper::error_string(code);
}
