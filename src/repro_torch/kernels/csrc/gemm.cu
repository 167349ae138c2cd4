// Scheduled GEMM for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the one TPU kernel of the reference package,
// repro/kernels/gemm.py:_gemm_kernel (launched by scheduled_gemm, with the
// epilogue of _apply_epilogue), in all three of its instantiations:
//
//   int8 x int8 -> int32 accumulator -> requantize + clip -> int8  (qgemm)
//   int8 x int8 -> int32 accumulator (mod 2^32)            -> int32
//   f32/bf16    -> f32 accumulator -> none | relu | gelu   -> f32/bf16
//
// out[m, n] = epilogue(x[m, k] @ w[k, n] (+ bias[n])), row-major, contiguous.
//
// What bounds it on this card: the serving GEMMs of the main path are tiny
// (ToyCar at batch 16: M = 16, K and N of 8..640), so the bytes the call must
// move take tens of nanoseconds and the operations a few; the time is the
// launch and one pass of a few CTAs over the K loop.  The design does not
// chase the tensor cores (wgmma needs 64-row tiles, M is 16).  It keeps the
// schedule's tiling and is right for any block shape the scheduler emits:
//
//   * grid: one CTA per (block_m x block_n) output block of the config; the
//     dataflow only sets the raster order of the blocks (WS: n outer, as in
//     GemmKernelConfig.grid_for).  Blocks run in any order, so nothing
//     carries between CTAs: the TPU's sequential k grid axis becomes a loop.
//   * K loop: an outer loop over the config's block_k steps; inside it,
//     operand chunks of kTileM x kTileK and kTileK x kTileN are staged
//     through a fixed 18 KB of static shared memory.  A CTA walks its output
//     block in kTileM x kTileN sub-tiles, so a (16, 640, 128) or a
//     (16, 128, 640) block launches as readily as (16, 128, 128).  At M = 16
//     a block is one CTA walking K alone, so each stage's global-load
//     latency is the cost: every thread loads a fixed share of the NEXT
//     stage into registers before the current stage's multiply-adds, so the
//     loads are all in flight together and overlap the arithmetic.
//   * ragged edges: loads past the block or the matrix read zero and stores
//     are masked, so callers never pad.
//   * accumulation: int8 products sum in uint32, which makes the reference's
//     int32 wrap (mod 2^32) defined behaviour; floats sum in f32.
//   * epilogue, in the order of gemm.py:_apply_epilogue: bias in the
//     accumulator type, then requantize (rintf(float(acc) * scale), half to
//     even like jnp.round, with scale a float32) and clip, or relu / gelu
//     (tanh form, as jax.nn.gelu), then the cast to the output type.
//
// Build (no --use_fast_math):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgemm.so gemm.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 16;                            // rows of a sub-tile
constexpr int kTileN = 128;                           // columns of a sub-tile
constexpr int kTileK = 32;                            // depth of one stage
constexpr int kThreadsPerRow = kThreads / kTileM;     // 16
constexpr int kColsPerThread = kTileN / kThreadsPerRow;  // 8
constexpr int kXPerThread = kTileM * kTileK / kThreads;   // 2
constexpr int kWPerThread = kTileK * kTileN / kThreads;   // 16

enum Epilogue { kNone = 0, kRelu = 1, kGelu = 2, kRequant = 3 };
enum InType { kInInt8 = 0, kInF32 = 1, kInBF16 = 2 };
enum OutType { kOutInt8 = 0, kOutInt32 = 1, kOutF32 = 2, kOutBF16 = 3 };

template <typename T>
struct Acc;
template <>
struct Acc<int8_t> {
  using type = uint32_t;
  using bias_type = int32_t;
};
template <>
struct Acc<float> {
  using type = float;
  using bias_type = float;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
  using bias_type = float;
};

__device__ __forceinline__ uint32_t widen(int8_t v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// One K stage of a sub-tile: each thread's share of the x chunk
// (kTileM x kTileK) and of the w chunk (kTileK x kTileN), widened to the
// accumulator type, zero past the block or the matrix.  The loop counts are
// fixed, so the loads unroll and are all in flight at once.
template <typename TIn, typename AccT>
__device__ __forceinline__ void load_stage(AccT (&xr)[kXPerThread], AccT (&wr)[kWPerThread],
                                           const TIn* __restrict__ x,
                                           const TIn* __restrict__ w, int r0, int row_end,
                                           int c0, int col_end, int k0, int kb_end, int k,
                                           int n) {
#pragma unroll
  for (int j = 0; j < kXPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int gr = r0 + i / kTileK, gk = k0 + i % kTileK;
    xr[j] = (gr < row_end && gk < kb_end) ? widen(x[static_cast<size_t>(gr) * k + gk])
                                          : AccT(0);
  }
#pragma unroll
  for (int j = 0; j < kWPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int gk = k0 + i / kTileN, gc = c0 + i % kTileN;
    wr[j] = (gk < kb_end && gc < col_end) ? widen(w[static_cast<size_t>(gk) * n + gc])
                                          : AccT(0);
  }
}

template <typename TIn, typename TOut, int kEpi>
__global__ void __launch_bounds__(kThreads)
    scheduled_gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                          const typename Acc<TIn>::bias_type* __restrict__ bias,
                          TOut* __restrict__ out, int m, int k, int n, int block_m,
                          int block_k, int block_n, int grid_m, int grid_n,
                          int weight_stationary, float scale, float clip_lo,
                          float clip_hi) {
  using AccT = typename Acc<TIn>::type;
  __shared__ AccT xs[kTileM][kTileK];
  __shared__ AccT ws[kTileK][kTileN];

  const int bid = blockIdx.x;
  int bm_idx, bn_idx;
  if (weight_stationary) {
    bn_idx = bid / grid_m;
    bm_idx = bid % grid_m;
  } else {
    bm_idx = bid / grid_n;
    bn_idx = bid % grid_n;
  }
  const int row_begin = bm_idx * block_m;
  const int col_begin = bn_idx * block_n;
  const int row_end = min(row_begin + block_m, m);
  const int col_end = min(col_begin + block_n, n);
  const int tr = threadIdx.x / kThreadsPerRow;
  const int tc = threadIdx.x % kThreadsPerRow;

  for (int r0 = row_begin; r0 < row_end; r0 += kTileM) {
    for (int c0 = col_begin; c0 < col_end; c0 += kTileN) {
      AccT acc[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[j] = AccT(0);

      // Stages walk the config's block_k steps in kTileK chunks.  The next
      // stage's operands load into registers before this stage's
      // multiply-adds, so their latency hides behind the arithmetic.
      AccT xr[kXPerThread], wr[kWPerThread];
      int kb = 0, k0 = 0;
      if (k > 0) load_stage<TIn>(xr, wr, x, w, r0, row_end, c0, col_end, 0, min(block_k, k), k, n);
      while (kb < k) {
#pragma unroll
        for (int j = 0; j < kXPerThread; ++j) {
          const int i = threadIdx.x + j * kThreads;
          xs[i / kTileK][i % kTileK] = xr[j];
        }
#pragma unroll
        for (int j = 0; j < kWPerThread; ++j) {
          const int i = threadIdx.x + j * kThreads;
          ws[i / kTileN][i % kTileN] = wr[j];
        }
        __syncthreads();
        int next_kb = kb, next_k0 = k0 + kTileK;
        if (next_k0 >= min(kb + block_k, k)) next_kb = next_k0 = kb + block_k;
        if (next_kb < k) {
          load_stage<TIn>(xr, wr, x, w, r0, row_end, c0, col_end, next_k0,
                          min(next_kb + block_k, k), k, n);
        }
#pragma unroll 8
        for (int kk = 0; kk < kTileK; ++kk) {
          const AccT a = xs[tr][kk];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            acc[j] += a * ws[kk][tc + j * kThreadsPerRow];
          }
        }
        __syncthreads();
        kb = next_kb;
        k0 = next_k0;
      }

      const int gr = r0 + tr;
      if (gr < row_end) {
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int gc = c0 + tc + j * kThreadsPerRow;
          if (gc < col_end) {
            out[static_cast<size_t>(gr) * n + gc] =
                finish<TOut, kEpi>(acc[j], bias, gc, scale, clip_lo, clip_hi);
          }
        }
      }
    }
  }
}

struct GemmArgs {
  const void* x;
  const void* w;
  const void* bias;
  void* out;
  int m, k, n, block_m, block_k, block_n, weight_stationary;
  float scale, clip_lo, clip_hi;
  cudaStream_t stream;
};

template <typename TIn, typename TOut, int kEpi>
cudaError_t launch(const GemmArgs& a) {
  const long long grid_m = (static_cast<long long>(a.m) + a.block_m - 1) / a.block_m;
  const long long grid_n = (static_cast<long long>(a.n) + a.block_n - 1) / a.block_n;
  if (grid_m * grid_n > INT_MAX) return cudaErrorInvalidConfiguration;
  using Bias = typename Acc<TIn>::bias_type;
  scheduled_gemm_kernel<TIn, TOut, kEpi>
      <<<static_cast<unsigned>(grid_m * grid_n), kThreads, 0, a.stream>>>(
          static_cast<const TIn*>(a.x), static_cast<const TIn*>(a.w),
          static_cast<const Bias*>(a.bias), static_cast<TOut*>(a.out), a.m, a.k,
          a.n, a.block_m, a.block_k, a.block_n, static_cast<int>(grid_m),
          static_cast<int>(grid_n), a.weight_stationary, a.scale, a.clip_lo,
          a.clip_hi);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t by_epilogue(int epilogue, const GemmArgs& a) {
  constexpr bool kInt = std::is_same<TIn, int8_t>::value;
  switch (epilogue) {
    case kNone:
      return launch<TIn, TOut, kNone>(a);
    case kRelu:
      return launch<TIn, TOut, kRelu>(a);
    case kGelu:
      if constexpr (!kInt) return launch<TIn, TOut, kGelu>(a);
      break;
    case kRequant:
      if constexpr (kInt) return launch<TIn, TOut, kRequant>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename TIn>
cudaError_t by_float_out(int out_type, int epilogue, const GemmArgs& a) {
  switch (out_type) {
    case kOutF32:
      return by_epilogue<TIn, float>(epilogue, a);
    case kOutBF16:
      return by_epilogue<TIn, __nv_bfloat16>(epilogue, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_scheduled_gemm(const void* x, const void* w, const void* bias,
                                    void* out, int m, int k, int n, int block_m,
                                    int block_k, int block_n, int weight_stationary,
                                    int in_type, int out_type, int epilogue,
                                    float scale, float clip_lo, float clip_hi,
                                    void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || block_m <= 0 || block_k <= 0 || block_n <= 0) {
    return cudaErrorInvalidValue;
  }
  const GemmArgs a{x, w, bias, out, m, k, n, block_m, block_k, block_n,
                   weight_stationary, scale, clip_lo, clip_hi,
                   static_cast<cudaStream_t>(stream)};
  switch (in_type) {
    case kInInt8:
      switch (out_type) {
        case kOutInt8:
          return by_epilogue<int8_t, int8_t>(epilogue, a);
        case kOutInt32:
          return by_epilogue<int8_t, int32_t>(epilogue, a);
        case kOutF32:
          return by_epilogue<int8_t, float>(epilogue, a);
      }
      return cudaErrorInvalidValue;
    case kInF32:
      return by_float_out<float>(out_type, epilogue, a);
    case kInBF16:
      return by_float_out<__nv_bfloat16>(out_type, epilogue, a);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
