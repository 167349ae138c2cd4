// The scheduled GEMM's epilogue, shared by both designs of its float form
// (gemm.cu's mma.sync kernel and gemm_wgmma.cu's wgmma kernel), so that
// the two round the same way: once per output element on the full sum, in
// the order of repro/kernels/gemm.py:_apply_epilogue: bias in the
// accumulator type, then requantize (rintf(float(acc) * scale), half to
// even like jnp.round, with scale a float32) and clip, or relu / gelu (tanh
// form, as jax.nn.gelu), then the cast to the output type.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2, kRequant = 3 };
enum InType { kInInt8 = 0, kInF32 = 1, kInBF16 = 2 };
enum OutType { kOutInt8 = 0, kOutInt32 = 1, kOutF32 = 2, kOutBF16 = 3 };

template <typename TOut>
__device__ __forceinline__ TOut from_int(int32_t v) {
  if constexpr (std::is_same<TOut, float>::value) {
    return __int2float_rn(v);
  } else {
    return static_cast<TOut>(v);  // int8: two's-complement wrap, as astype
  }
}

template <typename TOut>
__device__ __forceinline__ TOut from_float(float v) {
  if constexpr (std::is_same<TOut, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same<TOut, float>::value) {
    return v;
  } else {
    // requantized values are integral and clipped: the conversion is exact
    return static_cast<TOut>(static_cast<int32_t>(v));
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.0f + tanhf(inner)));
}

template <typename TOut, int kEpi>
__device__ __forceinline__ TOut finish(uint32_t acc, const int32_t* bias, int col,
                                       float scale, float clip_lo, float clip_hi) {
  if (bias != nullptr) acc += static_cast<uint32_t>(bias[col]);
  const int32_t v = static_cast<int32_t>(acc);
  if constexpr (kEpi == kRequant) {
    float q = rintf(static_cast<float>(v) * scale);
    q = fminf(fmaxf(q, clip_lo), clip_hi);
    return from_float<TOut>(q);
  } else if constexpr (kEpi == kRelu) {
    return from_int<TOut>(v < 0 ? 0 : v);
  } else {
    return from_int<TOut>(v);
  }
}

template <typename TOut, int kEpi>
__device__ __forceinline__ TOut finish(float acc, const float* bias, int col,
                                       float, float, float) {
  if (bias != nullptr) acc += bias[col];
  if constexpr (kEpi == kRelu) {
    acc = acc < 0.0f ? 0.0f : acc;  // NaN passes through, as jnp.maximum
  } else if constexpr (kEpi == kGelu) {
    acc = gelu_tanh(acc);
  }
  return from_float<TOut>(acc);
}

// Cluster barrier halves: arrive (release, or relaxed where nothing is
// published) and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

}  // namespace
