// Hopper's asynchronous-copy layer of the tensor-core flash forms
// (csrc/flash_attention_wgmma.cu, bf16; csrc/flash_attention_tf32.cu,
// float32): mbarriers, TMA tile loads and the wgmma fences on the device;
// on the host, a (B, T, H, D) tensor encoded as a swizzled 4-d tensor map
// and a launch over (query tile, query head, batch row) blocks.  What
// differs between the forms (the operand tiles, their descriptors, the
// wgmma shapes) stays in each source.
#pragma once
#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

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

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda
inline EncodeTiled encoder() {
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

constexpr int kEncodeFailed = 100000;  // + the CUresult

// A (B, T, H, D) tensor of ``item``-byte elements of ``type`` as a 4-d map
// (D, T, H, B), boxes of one swizzled row (``row_bytes``, 128 or 32) x
// ``rows`` rows under the swizzle of that width, zero fill past the edges.
// Strides are in elements; a dimension of size 1 takes a placeholder.
inline CUresult encode(CUtensorMap* map, CUtensorMapDataType type, int item,
                       int row_bytes, const void* ptr, long long b,
                       long long t, long long heads, int d, long long sb,
                       long long st, long long sh, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(t),
                              cuuint64_t(heads), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(item * (t > 1 ? st : d)),
                                 cuuint64_t(item * (heads > 1 ? sh : d)),
                                 cuuint64_t(item * (b > 1 ? sb : d))};
  const cuuint32_t box[4] = {cuuint32_t(row_bytes / item), cuuint32_t(rows),
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                   unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_32B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The shapes a flash form's entry point takes: cudaErrorInvalidValue
// unless 1 <= B, Hq <= 65535, Hkv divides Hq, 1 <= Tq, Tk <= 0x7fffff00,
// window >= 0 and D is 64, 80 or 128; cudaErrorSymbolNotFound when the
// driver has no tensor-map encoder; else 0
inline int check_shapes(long long b, long long tq, long long tk, int hq,
                        int hkv, int d, int window) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hkv < 1 ||
      hq % hkv != 0 || tq < 1 || tk < 1 || tq > 0x7fffff00LL ||
      tk > 0x7fffff00LL || window < 0 || (d != 64 && d != 80 && d != 128))
    return int(cudaErrorInvalidValue);
  if (encoder() == nullptr) return int(cudaErrorSymbolNotFound);
  return 0;
}

// ``kernel`` over (ceil(Tq / bq), Hq, B) blocks of ``threads`` threads with
// ``smem`` bytes of dynamic shared memory, on ``stream``
template <typename P>
cudaError_t launch(void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, P),
                   int smem, int bq, int threads, const CUtensorMap& qm,
                   const CUtensorMap& km, const CUtensorMap& vm, const P& p,
                   long long tq, int hq, long long b, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned((tq + bq - 1) / bq), unsigned(hq), unsigned(b));
  kernel<<<grid, threads, smem, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

inline const char* error_string(int code) {
  if (code >= kEncodeFailed) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
