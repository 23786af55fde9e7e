// Asynchronous staging of the selective scan's inputs into shared memory
// (cp.async: global to shared without registers, completion by group), for
// csrc/selective_scan.cu and csrc/selective_scan_bwd.cu.  A chunk of steps
// of each (B, T, C) input is copied while the block computes on the chunk
// before it, so no step of the recurrence waits on device memory.
#pragma once
#include <stdint.h>

namespace scan {

constexpr int kChunk = 16;   // steps a chunk (and between checkpoints)

// Copies 16 (or, with cp4, 4) bytes from src to dst in shared memory;
// only the first src_bytes are read, the rest is zero-filled (src_bytes 0
// reads nothing, so src need only be a valid address).
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `pending` committed groups of this thread are in
// flight (the block still needs a barrier to see the others' copies).
template <int pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// A rows x width tile of floats from global memory (row r at src + r * ld)
// into dst[rows][pitch] at column `col`, by a block of `threads`: rows from
// `valid_rows` on and columns from `valid_width` on are zero.  With `vec`
// (width, ld, valid_width and col multiples of 4, src 16-byte aligned) it
// copies 16 bytes at a time, else 4.
template <int rows, int width, int pitch, int threads>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t ld, int valid_rows,
                                          int valid_width, int col, bool vec,
                                          int tid) {
  if constexpr (width % 4 == 0) {
    if (vec) {
      constexpr int kRow = width / 4, kCopies = rows * kRow;
#pragma unroll
      for (int j = 0; j < (kCopies + threads - 1) / threads; ++j) {
        const int i = tid + j * threads;
        if (kCopies % threads == 0 || i < kCopies) {
          const int r = i / kRow, c = 4 * (i % kRow);
          const bool ok = r < valid_rows && c < valid_width;
          cp16(dst + r * pitch + col + c, ok ? src + r * ld + c : src,
               ok ? 16 : 0);
        }
      }
      return;
    }
  }
  for (int i = tid; i < rows * width; i += threads) {
    const int r = i / width, c = i % width;
    const bool ok = r < valid_rows && c < valid_width;
    cp4(dst + r * pitch + col + c, ok ? src + r * ld + c : src, ok ? 4 : 0);
  }
}

// The reverse of copy_tile, synchronously: rows [0, valid_rows) and columns
// [0, valid_width) of src[rows][width] in shared memory to global memory
// (row r at dst + r * ld), 16 bytes at a time with `vec`.
template <int rows, int width, int threads>
__device__ __forceinline__ void store_tile(float* dst, const float* src,
                                           int64_t ld, int valid_rows,
                                           int valid_width, bool vec,
                                           int tid) {
  if constexpr (width % 4 == 0) {
    if (vec) {
      constexpr int kRow = width / 4, kCopies = rows * kRow;
#pragma unroll
      for (int j = 0; j < (kCopies + threads - 1) / threads; ++j) {
        const int i = tid + j * threads;
        const int r = i / kRow, c = 4 * (i % kRow);
        if ((kCopies % threads == 0 || i < kCopies) && r < valid_rows &&
            c < valid_width) {
          *reinterpret_cast<float4*>(dst + r * ld + c) =
              *reinterpret_cast<const float4*>(src + r * width + c);
        }
      }
      return;
    }
  }
  for (int i = tid; i < rows * width; i += threads) {
    const int r = i / width, c = i % width;
    if (r < valid_rows && c < valid_width) dst[r * ld + c] = src[i];
  }
}

// Whether 16-byte copies serve a (…, ld) array at `src`.
__device__ __forceinline__ bool vec_ok(const float* src, int64_t ld) {
  return (ld & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}

// P consecutive floats of shared memory into registers, 16 bytes a load
// where P allows (the caller's rows are 16-byte aligned then).
template <int P>
__device__ __forceinline__ void load_row(const float* s, float (&v)[P]) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int p = 0; p < P; p += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + p);
      v[p] = q.x;
      v[p + 1] = q.y;
      v[p + 2] = q.z;
      v[p + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = s[p];
  }
}

}  // namespace scan
