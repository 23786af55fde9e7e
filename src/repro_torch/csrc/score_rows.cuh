// What the two Eq. 2 kernels (csrc/score_pipeline.cu and
// csrc/score_pipeline_banked.cu) share: the T^C -> A step of one row.
// What they share with the T^Q kernel (csrc/quantile_map.cu): the
// asynchronous staging of tables into shared memory (cp.async, and TMA
// bulk copies on an mbarrier), programmatic dependent launch, and the
// host's sizing of a resident grid.
//
//     A(T^C(y)) = sum_k c_k * wn_k   in k order,
//     c_k = (beta_k * y_k) / (1 - (1 - beta_k) * y_k),   wn_k = w_k / sum(w)
//
// with sum(w) in k order too, as the TPU kernels order it; built with
// -fmad=false, so no product or sum is contracted into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype_io.cuh"

namespace score_rows {

// Programmatic dependent launch.  A kernel launched by launch_pdl may
// start while the kernel before it in the stream drains; before its first
// read of global memory it waits until that kernel has finished and its
// writes are visible.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Once every block has called this (or exited), the next kernel of the
// stream may launch.  Called when a block's rows are done: a dependent
// block that launched earlier would sit on the SM, waiting, beside the
// blocks still at work.
__device__ __forceinline__ void let_next_kernel_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// kernel<<<grid, threads, smem, stream>>>(args...) with programmatic
// stream serialisation; returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), int grid, int threads,
                       size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, Params(args)...);
}

// The SMs of the current device.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of ``threads`` for ``items`` work items, one a thread, at most as
// many as the card keeps resident at once (a persistent grid that loops
// over a larger input).
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, size_t smem,
                          int64_t items, int* grid) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t wanted = (items + threads - 1) / threads;
  const int64_t most = int64_t(per_sm) * sm_count();
  *grid = int(wanted < most ? wanted : most);
  return cudaSuccess;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One 16-byte cp.async from global to shared memory (both ends 16-byte
// aligned); it lands after async_wait.
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// Every thread of the block issues its share of the copy of a (rows, cols)
// float32 array, rows packed in global memory, into shared memory rows
// ``stride`` floats apart, with cp.async: 16 bytes a copy where the
// alignment allows, else 4.  The copies land after async_wait.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int rows, int cols, int stride) {
  if (cols % 4 == 0 && stride % 4 == 0 && aligned16(dst) && aligned16(src)) {
    const int quads = cols / 4;
    for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
      const int r = i / quads;
      const int c = 4 * (i - r * quads);
      copy16_async(dst + r * stride + c, src + int64_t(r) * cols + c);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols;
    const int c = i - r * cols;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r * stride + c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src + int64_t(r) * cols + c)
                 : "memory");
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that completes once its ``count`` arrivals
// and the bytes announced by mbar_expect_bytes have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on ``bar`` and announce ``bytes`` of bulk copies that complete on it.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed; what the
// bulk copies wrote is then visible to the waiting thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on ``bar``: a single
// instruction of one thread, whatever its size.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Close the group of copies issued so far.
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most ``kPending`` closed groups are still in flight (the
// caller then syncs the block before reading what landed).
template <int kPending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// 16 bytes of scores, widened to float32.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int kValues = 4;
  static __device__ __forceinline__ void widen(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kValues = 8;
  static __device__ __forceinline__ void widen(const uint4& r, float* x) {
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(words[i] << 16);
      x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};

// One term of the aggregate: agg + T^C(y) * wn.
__device__ __forceinline__ float add_term(float agg, float beta, float wn,
                                          float y) {
  const float c = (beta * y) / (1.0f - (1.0f - beta) * y);
  return agg + c * wn;
}

// 16 bytes of float32 parameters, read through L1 (16-byte aligned).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A(T^C(y)) of one row of ``k`` scores against ``beta`` and the raw
// weights ``w`` whose sum in k order is ``wsum``: each term takes
// w_k / wsum, the bits of w / sum(w).  kVec reads the row, beta and w 16
// bytes at a time (k a multiple of Pack<T>::kValues, all three 16-byte
// aligned), so that the lanes of a warp on as many tenants read as few
// lines as they can.
template <typename T, bool kVec>
__device__ __forceinline__ float aggregate(const T* __restrict__ y,
                                           const float* __restrict__ beta,
                                           const float* __restrict__ w,
                                           float wsum, int k) {
  float agg = 0.0f;
  if (kVec) {
    constexpr int kPer = Pack<T>::kValues;
    for (int e = 0; e < k; e += kPer) {
      float x[kPer], b[kPer], v[kPer];
      Pack<T>::widen(__ldg(reinterpret_cast<const uint4*>(y + e)), x);
#pragma unroll
      for (int u = 0; u < kPer; u += 4) {
        const float4 b4 = ldg4(beta + e + u);
        const float4 w4 = ldg4(w + e + u);
        b[u] = b4.x, b[u + 1] = b4.y, b[u + 2] = b4.z, b[u + 3] = b4.w;
        v[u] = w4.x, v[u + 1] = w4.y, v[u + 2] = w4.z, v[u + 3] = w4.w;
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        agg = add_term(agg, b[u], v[u] / wsum, x[u]);
    }
  } else {
    for (int e = 0; e < k; ++e)
      agg = add_term(agg, __ldg(beta + e), __ldg(w + e) / wsum,
                     to_f32(y[e]));
  }
  return agg;
}

// sum(w) of ``k`` weights in k order, 16 bytes at a time with kVec (k a
// multiple of 4, w 16-byte aligned).
template <bool kVec>
__device__ __forceinline__ float weight_sum(const float* __restrict__ w,
                                            int k) {
  float sum = 0.0f;
  if (kVec) {
    for (int e = 0; e < k; e += 4) {
      const float4 v = ldg4(w + e);
      sum += v.x;
      sum += v.y;
      sum += v.z;
      sum += v.w;
    }
  } else {
    for (int e = 0; e < k; ++e) sum += __ldg(w + e);
  }
  return sum;
}

}  // namespace score_rows
