// Flash attention on Hopper's tensor cores (sm_90a) for float32 q, k and v,
// head dim 64, 80 or 128, each product in three TF32 terms:
//
//     o[b, i, h, :] = sum_j softmax_j( (q[b,i,h,:] . k[b,j,g,:]) * scale ) v[b,j,g,:]
//     g = h / (Hq / Hkv),  scale = 1 / sqrt(D),  over the visible keys j
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:25
// (function _flash_kernel, wrapper flash_attention) for float32 inputs with
// D in {64, 80, 128}; csrc/flash_attention_wgmma.cu takes bf16 at those D,
// csrc/flash_attention.cu (float32 on the CUDA cores) every other D.
//
// What bounds it on an H100: operations.  The tensor cores take float32
// only as TF32 (10 mantissa bits): one TF32 term a product leaves the
// output ~1e-3 from float32, far outside the float32 tolerance of 5e-5.
// Three terms a product are as good as float32 there (x_hi = tf32(x),
// x_lo = tf32(x - x_hi); a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, lo*lo
// dropped), so float32 attention to float32's accuracy needs 12*D flops a
// visible (query, key) pair on the tensor cores: at the qwen3-8b prefill
// shape (B=4, T=2,048, 32/8 heads, D=128, causal) 412.5 GFLOP, 0.833 ms at
// the dense TF32 rate (495 TFLOP/s), against 201 MB of q, k, v and o
// (0.060 ms).  The 4*D flops of one float32 term a product would take
// 2.052 ms on the CUDA cores (67 TFLOP/s).  The largest part of this
// design's time besides the products is the split of each K / V tile into
// its terms, redone by every CTA that reads it (bench_flash_tf32's
// ablations, PERF.md).
//
// Precision plan (held to the JAX oracle on the CPU by
// tests/test_torch_flash_tf32.py): every operand of S = Q K^T and O += P V
// is split as above with cvt.rna (round to nearest, ties away from zero);
// the three products accumulate in float32, the small terms first; the
// online softmax runs in float32 on the accumulator and l sums float32 P;
// the output is float32.
//
// Design (FlashAttention-3's shape, as csrc/flash_attention_wgmma.cu):
// * One CTA per (128-row query tile, query head, batch row), heaviest tile
//   first.  Three warpgroups: a producer and two consumers of 64 query rows
//   each.  The producer keeps 40 registers a thread (setmaxnreg), the
//   consumers take 232: S, O, Q_hi and the P terms live in registers.
// * TMA loads the Q tile once, and each 32-key tile of K and V into one raw
//   buffer, swizzled as in the bf16 kernel (struct Tile: D = 64 and 128 as
//   32-column boxes under the 128-byte swizzle; D = 80, whose 320-byte row
//   is no whole number of 128-byte atoms, as ten 8-column boxes under the
//   32-byte swizzle: one 32-byte row is one k-step of 8 tf32).  Rows past
//   Tq or Tk arrive zero-filled.
// * The producer's 128 threads split each raw tile into a ring of stages
//   (kStages: 2 at D = 128, 3 below), each holding K_hi and K_lo in K's own
//   layout and V^T_hi and V^T_lo key-contiguous: tf32 wgmma reads both
//   operands K-major only (it has no transpose bit), and for P V the
//   reduction runs over keys.  V^T is one 128-byte-swizzled box of D rows
//   of 32 keys.  The raw buffer is reloaded as soon as the split of its
//   tile is done, so a tile's load overlaps the consumers' work on the two
//   before it.  Shared memory at D = 128: Q 64 KB (its lo term in place) +
//   raw K and V 32 KB + two stages of 64 KB = 224 KB of the 227 KB.
// * Each consumer splits its Q rows once: Q_hi into registers as wgmma's A
//   fragment (D/2 a thread), Q_lo in place in shared memory.  S (m64n32k8,
//   D/8 k-steps a term): Q_lo K_hi from shared memory, then Q_hi K_lo and
//   Q_hi K_hi with A from registers.
// * Online softmax on the accumulator fragment: each thread holds two rows'
//   values, a row's max and sum span the thread's quad.  Masks are applied
//   only to tiles that cross Tk, the causal diagonal or the window edge;
//   tiles that no row can see are never loaded.
// * O += P_lo V_hi + P_hi V_lo + P_hi V_hi (m64nDk8, one a k-step of 8
//   keys), P split in registers straight from the accumulator fragment.
//   A thread holds keys 2c and 2c + 1 of a k-step's 8 where the tf32 A
//   fragment wants k-indices c and c + 4, so the producer writes V^T's keys
//   of each 8 in the order 0 2 4 6 1 3 5 7: the sum over keys is the same.
// * Epilogue: O / max(l, 1e-30) in float32, stored from registers (two
//   floats a store, 32 bytes a row a quad), exactly D columns a row; rows
//   past Tq are not written.
//
// Numerics follow _flash_kernel at every D: masks kpos < Tk, qpos >= kpos
// if causal, kpos > qpos - window if window > 0, positions from 0; masked
// logits are -inf; the running max is guarded (m_safe = 0 where m is -inf,
// alpha = 0 where the previous max is -inf), so a fully masked tile adds
// exactly 0 and a row that sees no key comes out exactly 0.  The logit is
// (q . k) * scale with scale = 1 / sqrtf(float(D)); exp(x) is
// exp2f(x * log2(e)).
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
constexpr int kBK = 32;        // keys per K/V tile
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// bytes of one swizzled shared-memory row of a D-column float32 operand:
// 32 floats under the 128-byte swizzle where 4 D is a multiple of 128, else
// 8 floats under the 32-byte swizzle
__host__ __device__ constexpr int row_bytes(int d) {
  return (4 * d) % 128 == 0 ? 128 : 32;
}

// A swizzled shared-memory operand of float32 rows: boxes of (rows x
// kRowBytes), each row swizzled in 16-byte chunks within atoms of eight
// rows (CUTLASS's Swizzle<log2(kRowBytes / 16), 4, 3>).
template <int kRowBytes_>
struct Swizzled {
  static constexpr int kRowBytes = kRowBytes_;
  static constexpr int kBoxCols = kRowBytes / 4;    // floats a box row
  static constexpr int kChunks = kRowBytes / 16;    // 16-byte chunks a row
  static constexpr int kAtomBytes = 8 * kRowBytes;  // the swizzle's repeat
  static constexpr int kSteps = kBoxCols / 8;       // tf32 k-steps a row
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 3 = 32-byte
  static constexpr uint64_t kLayoutType = kRowBytes == 128 ? 1 : 3;

  // byte offset of 16-byte chunk ``chunk`` of row ``row`` inside a box
  // whose rows start at an atom boundary
  __device__ static constexpr int at(int row, int chunk) {
    return row * kRowBytes +
           ((chunk ^ ((row * kRowBytes >> 7) & (kChunks - 1))) * 16);
  }
  // byte offset of column ``col`` of row ``row`` of a tile of ``rows``
  // rows, box after box
  __device__ static constexpr int elem(int rows, int row, int col) {
    return (col / kBoxCols) * rows * kRowBytes +
           at(row, (col % kBoxCols) / 4) + 4 * (col % 4);
  }
};

// Q and K tiles (D columns, D contiguous as they arrive) and V^T tiles
// (D rows of kBK = 32 keys: one 128-byte row)
template <int D>
using QK = Swizzled<row_bytes(D)>;
using VT = Swizzled<4 * kBK>;

struct Params {
  float* o;
  long long o_sb, o_st, o_sh;
  int tq, tk, hq, hkv;
  int causal, window;
  float scale;
};

// Byte offsets into the 1024-byte-aligned dynamic shared memory (every
// tile starts at an atom boundary).
template <int D>
struct Layout {
  static_assert(D == 64 || D == 80 || D == 128, "head dim 64, 80 or 128");
  static constexpr int kStages = D == 128 ? 2 : 3;  // split K/V ring depth
  static constexpr int kQBytes = kBQ * D * 4;
  static constexpr int kTileBytes = kBK * D * 4;    // one term of K or V^T
  static constexpr int kQ = 0;
  static constexpr int kRawK = kQ + kQBytes;
  static constexpr int kRawV = kRawK + kTileBytes;
  // a stage: K_hi, K_lo, V^T_hi, V^T_lo
  static constexpr int kStage = kRawV + kTileBytes;
  static constexpr int kStageBytes = 4 * kTileBytes;
  static constexpr int kBar = kStage + kStages * kStageBytes;
  // q_full, raw_full, split_full[kStages], split_empty[kStages]
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kTileBytes % 1024 == 0, "tiles start at atom boundaries");
  static_assert(kBytes <= 232448, "more shared memory than a block gets");
};

// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major swizzled operand: start
// address, leading byte offset (unused K-major), stride byte offset one
// atom (eight rows), the swizzle's layout type
template <typename S>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(S::kAtomBytes >> 4) << 32) | (S::kLayoutType << 62);
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
// as a float whose low 13 bits are 0
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// x as hi + lo, both TF32; x - hi - lo is at most 2^-22 |x|
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = tf32(x - hi);
}

// d(64x32) = a(64x8) * b(8x32) (+ d if accumulate); a and b K-major tf32
// in shared memory, read through their descriptors
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d(64x32) (+)= a(64x8) * b(8x32); a in registers (wgmma's tf32 A
// fragment), b K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d(64x64) (+)= a(64x8) * b(8x64); a in registers (wgmma's tf32 A
// fragment), b K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d(64x80) (+)= a(64x8) * b(8x80); a in registers (wgmma's tf32 A
// fragment), b K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d(64x128) (+)= a(64x8) * b(8x128); a in registers (wgmma's tf32 A
// fragment), b K-major tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, b, 1);
  } else if constexpr (D == 80) {
    wgmma_rs_n80(o, a, b, 1);
  } else {
    wgmma_rs_n128(o, a, b, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const Params p) {
  using L = Layout<D>;
  using T = QK<D>;
  constexpr int kStages = L::kStages;
  constexpr int kRowBytes = T::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // whole atoms at any D
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_raw = bar_q + 8;
  const uint32_t bar_full = bar_raw + 8;             // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

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
    mbar_init(bar_raw, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 128);  // every producer thread
      mbar_init(bar_empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (n_tiles > 0) {
      if (tid == 0) {
        mbar_expect_tx(bar_q, L::kQBytes);
        for (int c = 0; c < D / T::kBoxCols; ++c)
          tma_load(base + L::kQ + c * kBQ * kRowBytes, &q_map, bar_q,
                   T::kBoxCols * c, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        if (tid == 0) {  // the raw buffer is free: load tile it
          const int k0 = (t_first + it) * kBK;
          mbar_expect_tx(bar_raw, 2 * L::kTileBytes);
          for (int c = 0; c < D / T::kBoxCols; ++c) {
            tma_load(base + L::kRawK + c * kBK * kRowBytes, &k_map, bar_raw,
                     T::kBoxCols * c, k0, kvh, b);
            tma_load(base + L::kRawV + c * kBK * kRowBytes, &v_map, bar_raw,
                     T::kBoxCols * c, k0, kvh, b);
          }
        }
        const int s = it % kStages;
        if (it >= kStages)  // the consumers have released this stage
          mbar_wait(bar_empty + 8 * s, ((it / kStages) - 1) & 1);
        mbar_wait(bar_raw, it & 1);
        uint8_t* const stage = base_ptr + L::kStage + s * L::kStageBytes;
        // K: hi and lo at the raw tile's own offsets
        const float4* const rk =
            reinterpret_cast<const float4*>(base_ptr + L::kRawK);
        float4* const k_hi4 = reinterpret_cast<float4*>(stage);
        float4* const k_lo4 =
            reinterpret_cast<float4*>(stage + L::kTileBytes);
#pragma unroll 2
        for (int e = tid; e < L::kTileBytes / 16; e += 128) {
          const float4 x = rk[e];
          float4 hi, lo;
          split(x.x, hi.x, lo.x);
          split(x.y, hi.y, lo.y);
          split(x.z, hi.z, lo.z);
          split(x.w, hi.w, lo.w);
          k_hi4[e] = hi;
          k_lo4[e] = lo;
        }
        // V^T: 16-byte chunk c of row d holds keys 8 (c / 2) + 2 i + c % 2
        // (i = 0..3), the order P's A fragment asks for
        const uint8_t* const rv = base_ptr + L::kRawV;
        uint8_t* const vt_hi = stage + 2 * L::kTileBytes;
        uint8_t* const vt_lo = stage + 3 * L::kTileBytes;
#pragma unroll 1
        for (int e = tid; e < D * VT::kChunks; e += 128) {
          const int d = e % D;
          const int c = e / D;
          const int key0 = 8 * (c >> 1) + (c & 1);
          float x[4], hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] = *reinterpret_cast<const float*>(
                rv + T::elem(kBK, key0 + 2 * i, d));
            split(x[i], hi[i], lo[i]);
          }
          const int off = VT::at(d, c);
          *reinterpret_cast<float4*>(vt_hi + off) =
              make_float4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<float4*>(vt_lo + off) =
              make_float4(lo[0], lo[1], lo[2], lo[3]);
        }
        fence_async_smem();
        mbar_arrive(bar_full + 8 * s);
        // every producer thread is past its reads of the raw tile
        asm volatile("bar.sync 3, 128;" ::: "memory");
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
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

    // Q_hi as the tf32 A fragment of k-step ks: register j holds row
    // row0 + 8 (j & 1), column 8 ks + quad + 4 (j >> 1); Q_lo replaces Q in
    // place
    uint32_t qh[D / 8][4];
    if (n_tiles > 0) {
      mbar_wait(bar_q, 0);
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* const x = reinterpret_cast<float*>(
              base_ptr + L::kQ +
              T::elem(kBQ, 64 * cw + row0 + 8 * (j & 1),
                      8 * ks + quad + 4 * (j >> 1)));
          float hi, lo;
          split(*x, hi, lo);
          qh[ks][j] = __float_as_uint(hi);
          *x = lo;
        }
      }
      fence_async_smem();
      asm volatile("bar.sync %0, 128;" :: "r"(1 + cw) : "memory");
    }

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const int k0 = (t_first + it) * kBK;
      const uint32_t khi = base + L::kStage + s * L::kStageBytes;
      const uint32_t klo = khi + L::kTileBytes;
      const uint32_t vhi = khi + 2 * L::kTileBytes;
      const uint32_t vlo = khi + 3 * L::kTileBytes;

      // S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi over D in k-steps of 8 (32
      // bytes of a swizzled row); the first step overwrites S, zeroed only
      // so that nothing stays live from the previous tile
      float sacc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.0f;
      mbar_wait(bar_full + 8 * s, phase);
      fence_regs(sacc);
      fence_regs(qh);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const uint32_t off = (ks % T::kSteps) * 32;
        const int box = ks / T::kSteps;
        wgmma_ss_n32(sacc, desc<T>(q_base + box * kBQ * kRowBytes + off),
                     desc<T>(khi + box * kBK * kRowBytes + off), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const uint32_t off = (ks / T::kSteps) * kBK * kRowBytes +
                             (ks % T::kSteps) * 32;
        wgmma_rs_n32(sacc, qh[ks], desc<T>(klo + off), 1);
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const uint32_t off = (ks / T::kSteps) * kBK * kRowBytes +
                             (ks % T::kSteps) * 32;
        wgmma_rs_n32(sacc, qh[ks], desc<T>(khi + off), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);
      fence_regs(qh);

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

      // P in two tf32 terms, as the A fragment of k-step j (keys 8 j ..
      // 8 j + 7): registers 0 and 1 are rows row0 and row0 + 8 at key
      // 8 j + 2 quad (k-index quad), registers 2 and 3 the same rows at key
      // 8 j + 2 quad + 1 (k-index quad + 4)
      uint32_t p_hi[kBK / 8][4], p_lo[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float hi, lo;
          split(sacc[4 * j + 2 * (q & 1) + (q >> 1)], hi, lo);
          p_hi[j][q] = __float_as_uint(hi);
          p_lo[j][q] = __float_as_uint(lo);
        }
      }

      // O += P_lo V_hi + P_hi V_lo + P_hi V_hi over the tile's keys in
      // k-steps of 8 (32 bytes of V^T's 128-byte rows)
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        wgmma_pv<D>(o, p_lo[j], desc<VT>(vhi + 32 * j));
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        wgmma_pv<D>(o, p_hi[j], desc<VT>(vlo + 32 * j));
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        wgmma_pv<D>(o, p_hi[j], desc<VT>(vhi + 32 * j));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    }

    // ---------------------------------------------------------- epilogue
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      denom[r] = fmaxf(l[r], 1e-30f);
    }
    float* const og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qpos[r];
      if (qp >= p.tq) continue;
      float* const row = og + qp * p.o_st + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)  // columns 8 j + 2 quad, + 1
        *reinterpret_cast<float2*>(row + 8 * j) =
            make_float2(o[4 * j + 2 * r] / denom[r],
                        o[4 * j + 2 * r + 1] / denom[r]);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const Params& p, long long b,
                   cudaStream_t stream) {
  return hopper::launch(flash_attention_tf32_kernel<D>, Layout<D>::kBytes,
                        kBQ, kThreads, qm, km, vm, p, p.tq, p.hq, b,
                        stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on ``stream`` (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns the
// launch's cudaError_t (0 = success), or hopper::kEncodeFailed + the CUresult
// when a tensor map cannot be encoded.  q, k and v are float32 with the head
// dim contiguous; strides are in elements.  The caller has checked shapes, D
// in {64, 80, 128} (any other D returns cudaErrorInvalidValue), Hq % Hkv ==
// 0, B, Tq, Tk >= 1, and that every data pointer and every B, T and H stride
// is a multiple of 16 bytes.  The output is (B, Tq, Hq, D) float32 with
// 8-byte-aligned rows.
extern "C" int flash_attention_tf32_launch(
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
    return hopper::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                          row_bytes(d), ptr, b, t, heads, d, sb, st, sh,
                          rows);
  };
  CUtensorMap qm, km, vm;
  CUresult r = encode(&qm, q, tq, hq, q_sb, q_st, q_sh, kBQ);
  if (r == CUDA_SUCCESS) r = encode(&km, k, tk, hkv, k_sb, k_st, k_sh, kBK);
  if (r == CUDA_SUCCESS) r = encode(&vm, v, tk, hkv, v_sb, v_st, v_sh, kBK);
  if (r != CUDA_SUCCESS) return hopper::kEncodeFailed + int(r);
  Params p;
  p.o = static_cast<float*>(o);
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

extern "C" const char* flash_attention_tf32_error_string(int code) {
  return hopper::error_string(code);
}
