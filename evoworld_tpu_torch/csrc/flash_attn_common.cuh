// Device helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): constants, shared-memory addresses, the two element
// types (bf16, fp16) with their packing, and quad reductions over the four
// lanes that hold one accumulator row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The kernels' element types: q, k, v, o, dO and the gradients are all bf16
// or all fp16 (2 bytes each, so tiles, swizzle and descriptors are the same);
// accumulation, the log-sum-exp and the scratch are fp32 in both.
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;
template <typename T>
constexpr bool kIsElem = kIsHalf<T> || std::is_same<T, __nv_bfloat16>::value;

// The C entry points' code for the element type (ops/flash_attention.py).
enum ElemCode : int { kElemBf16 = 0, kElemF16 = 1 };

// Two floats as one register of two T, each rounded to nearest even.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  static_assert(kIsElem<T>, "bf16 or fp16");
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// One register of two T as two floats (exact).
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  static_assert(kIsElem<T>, "bf16 or fp16");
  if constexpr (kIsHalf<T>) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace flash
