// Loads and stores of the kernels' two element types, float32 and bfloat16,
// through float32: to_f32 widens a loaded element, store rounds a float32
// result into the output's type.  Shared by every kernel of csrc/ that
// takes either type.
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}
