// bfloat16 helpers of the kernels' bfloat16 variants (K1, K2, K3, K3b and
// the mix GEMM's bfloat16 products): rounding a float32 value to bfloat16
// (round to nearest even, as XLA and the TPU round), and the loads and
// stores that widen a bfloat16 operand as it is read or round a float32
// result as it is written.
//
// The bfloat16 K1 and K2 read their bfloat16 operands (x, sh, the MLP
// weights, the mix matrices, gout) straight from the bfloat16 tensors,
// widened as they are loaded or staged (exact), and write their bfloat16
// outputs rounded as they are stored; every rounding of the TPU kernels'
// contract happens in the kernels, at the TPU kernel's points.  A product
// of two bfloat16 values is exact in float32, so float32 arithmetic on the
// widened operands sums the same products as the TPU's bfloat16 dots with
// float32 accumulation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bf16 {

using T = __nv_bfloat16;
using T2 = __nv_bfloat162;

// the element type of an operand that the bfloat16 variant stores as
// bfloat16
template <bool kBf16>
using Op = std::conditional_t<kBf16, T, float>;

template <class E>
constexpr bool is_bf16 = std::is_same_v<std::remove_cv_t<E>, T>;

// v rounded to bfloat16, as a float
__device__ __forceinline__ float rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an element as a float (a bfloat16 widened; a float as it is)
__device__ __forceinline__ float f(float v) { return v; }
__device__ __forceinline__ float f(T v) { return __bfloat162float(v); }

// the 32 bits of a bfloat16 pair (an MMA operand register)
__device__ __forceinline__ uint32_t bits(T2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// *p = v (a bfloat16 output: v rounded)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(T* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace bf16
