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
// What bounds it on this card.  The serving GEMMs of the main path are tiny
// (ToyCar at batch 16: M = 16, K and N of 8..640): the bytes a call must
// move take tens of nanoseconds and the operations a few, so the time is
// the launch plus the latency chain of one pass over K.  The TPU kernel
// walks K as a sequential grid axis on one core; one CTA doing the same on
// one of 132 SMs pays a serial K walk, so the design spreads each block's K
// over several SMs and makes each 32-deep stage a handful of tensor-core
// instructions:
//
//   * cluster per block: the scheduler's (block_m x block_n) output block
//     stays the unit of the raster order (WS: n outer, as in
//     GemmKernelConfig.grid_for), and launches as one thread-block cluster
//     of up to 8 CTAs.  The CTAs split the block's columns into col_split
//     tiles of at most 128 and its K range into k_split slices of whole
//     32-deep stages.  The split is computed by kernels/gemm.py
//     (launch_geometry) and passed in.  Each CTA walks its tile in 16-row
//     sub-tiles.
//   * staging: each CTA copies its slice into a ring of kRing stages of
//     shared memory with 16-byte cp.async when the operand's rows and base
//     are 16-byte aligned (the wrapper decides, from strides and
//     data_ptr()), else with plain element loads issued together into
//     registers.  Slices longer than the ring stream through it, a stage's
//     copy in flight while earlier stages compute.  Loads past the slice,
//     the block or the matrix read zero; stores are masked.
//   * main loops, one warp per 8-column n-tile group (4 warps, up to 4
//     n-tiles each), M = 16 being exactly the mma tile (M = 1 masks 15 rows):
//       int8: mma.sync m16n8k32 s8.s8.s32, one per n-tile per stage, A as
//             the row-major x directly.  B must be K-contiguous per column
//             and w[k, n] is row-major (ldmatrix.trans moves only 16-bit
//             elements), so each B register is gathered from four rows with
//             byte loads packed by the compiler's prmt.  That keeps the
//             staging a raw cp.async copy; the transposing alternative
//             (__byte_perm on 4x4 blocks) needs a register pass between
//             global and shared memory, and at M = 16 the 8 gathers per
//             mma are not the bound.
//       bf16: mma.sync m16n8k16 bf16.bf16.f32, B through ldmatrix.x2.trans
//             from row-major shared memory.
//       f32:  3xTF32 on mma.sync m16n8k8: each operand splits into a TF32
//             high part and the TF32 rounding of its remainder, and
//             a_hi*b_lo + a_lo*b_hi + a_hi*b_hi keeps the sum within float32
//             rounding (single-pass TF32 has a 10-bit mantissa: ~1e-2 error
//             at K = 640).  f32 FMA with register tiling was not written.
//   * reduction: with k_split > 1, each 8-column n-tile of a column tile
//     belongs to one CTA of its column group (tile % k_split).  Every CTA
//     pushes its partial sums of each n-tile into its own slot of the
//     owner's shared memory (map_shared_rank, distributed shared memory),
//     then one cluster barrier (arrive.release / wait.acquire) publishes
//     them, and each owner sums its slots in rank order 0, 1, ..., so the
//     sum is the same for every launch: no atomics, no workspace, identical
//     bits across launches.  The barrier that lets a CTA write into a peer
//     (every CTA started, or done reading the previous round's slots) is
//     arrived at before the main loop and waited on after it, so only one
//     barrier is exposed per tile.  With k_split = 1 nothing crosses CTAs.
//     The main loops compute every n-tile of a warp without a branch, so
//     the fragment loads of all tiles issue together and independent mma
//     overlap (a branch per tile, or volatile mma, serialised them).
//   * numerics: the int32 mma accumulator is used without .satfinite, so it
//     wraps mod 2^32 like the reference's int32 accumulator, and the
//     partials are summed in uint32, which wraps the same way.  Floats sum
//     in f32 (3xTF32 terms for f32 inputs).
//   * epilogue, once per output element on the full sum, in the order of
//     gemm.py:_apply_epilogue: bias in the accumulator type, then requantize
//     (rintf(float(acc) * scale), half to even like jnp.round, with scale a
//     float32) and clip, or relu / gelu (tanh form, as jax.nn.gelu), then the
//     cast to the output type.
//
// wgmma and TMA are not used: their 64-row tiles would waste three quarters
// of the work at M = 16.
//
// Build (no --use_fast_math):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgemm.so gemm.cu

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;                           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 16;                              // rows of a sub-tile: the mma's M
constexpr int kTileN = 128;                             // widest column tile of a CTA
constexpr int kStageK = 32;                             // depth of one stage
constexpr int kRing = 4;                                // stages resident in shared memory
constexpr int kMaxCluster = 8;                          // the portable cluster size
constexpr int kTilesPerWarp = kTileN / 8 / kWarps;      // 4 n-tiles of 8 columns
constexpr int kRedStride = kTileN + 8;                  // words per partial-sum row
constexpr int kSlot = kTileM * kRedStride;              // words per partial tile

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

template <typename T>
struct Vec4 {
  using type = uint4;
};
template <>
struct Vec4<float> {
  using type = float4;
};

template <int kBytes>
struct Raw;
template <>
struct Raw<1> {
  using type = uint8_t;
};
template <>
struct Raw<2> {
  using type = uint16_t;
};
template <>
struct Raw<4> {
  using type = uint32_t;
};

// Shared-memory layout: kRing stages of [A: 16 x 32][B: 32 x 128], then one
// 16 x 128 slot of partial sums per CTA of a K split.  Row strides are 16-byte multiples (cp.async and
// ldmatrix targets), padded so the fragment loads of one warp fall in
// distinct banks (int8 B's byte gathers excepted: two-way).
template <typename TIn>
struct Smem {
  static constexpr int kElem = sizeof(TIn);
  static constexpr int kA = kStageK * kElem + 16;
  static constexpr int kB = kTileN * kElem + (kElem == 4 ? 32 : 16);
  static constexpr int kStage = kTileM * kA + kStageK * kB;
  static constexpr int kRingBytes = kRing * kStage;
  static constexpr int kBytes = kRingBytes + kMaxCluster * kSlot * 4;
};

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

// -- PTX wrappers --------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
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

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(uint32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32; lo carries the bits TF32 drops from v
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// -- staging -------------------------------------------------------------------

struct Stage {
  int r0, row_end;  // rows of x: [r0, min(r0 + 16, row_end))
  int k0, k_end;    // depth: [k0, min(k0 + 32, k_end))
  int c0, cols;     // columns of w: [c0, c0 + cols)
};

// Copy one stage of x (16 x 32) and w (32 x cols) into shared memory, zero
// past the sub-tile, the slice or the matrix.  The 16-byte path issues
// cp.async (completion through the caller's commit/wait); under its
// alignment every 16-byte chunk is all inside or all outside.  The element
// path loads a fixed count per thread into registers, all in flight
// together, then stores them.
template <typename TIn>
__device__ __forceinline__ void load_stage(uint8_t* stage, const TIn* __restrict__ x,
                                           const TIn* __restrict__ w, int k, int n,
                                           const Stage& s, bool vec_x, bool vec_w) {
  using L = Smem<TIn>;
  using R = typename Raw<sizeof(TIn)>::type;
  constexpr int kPerChunk = 16 / sizeof(TIn);
  uint8_t* as = stage;
  uint8_t* bs = stage + kTileM * L::kA;
  const int tid = threadIdx.x;
  const int k_stop = min(s.k0 + kStageK, s.k_end);

  if (vec_x) {
    constexpr int kRowChunks = kStageK / kPerChunk;
    for (int c = tid; c < kTileM * kRowChunks; c += kThreads) {
      const int r = c / kRowChunks, kk = (c % kRowChunks) * kPerChunk;
      const int gr = s.r0 + r, gk = s.k0 + kk;
      const bool ok = gr < s.row_end && gk < k_stop;
      cp_async16(as + r * L::kA + kk * sizeof(TIn),
                 ok ? static_cast<const void*>(x + static_cast<size_t>(gr) * k + gk) : x,
                 ok ? 16 : 0);
    }
  } else {
    constexpr int kPer = kTileM * kStageK / kThreads;
    R v[kPer];
    const R* xr = reinterpret_cast<const R*>(x);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      const int gr = s.r0 + e / kStageK, gk = s.k0 + e % kStageK;
      v[j] = (gr < s.row_end && gk < k_stop) ? xr[static_cast<size_t>(gr) * k + gk] : R(0);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      *reinterpret_cast<R*>(as + (e / kStageK) * L::kA + (e % kStageK) * sizeof(TIn)) = v[j];
    }
  }

  if (vec_w) {
    // a fixed count per thread over the widest tile, chunks past cols skipped
    constexpr int kRowChunks = kTileN / kPerChunk;
    constexpr int kPer = kStageK * kRowChunks / kThreads;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tid + j * kThreads;
      const int r = c / kRowChunks, cc = (c % kRowChunks) * kPerChunk;
      if (cc < s.cols) {
        const int gk = s.k0 + r;
        const bool ok = gk < k_stop;
        cp_async16(bs + r * L::kB + cc * sizeof(TIn),
                   ok ? static_cast<const void*>(w + static_cast<size_t>(gk) * n + s.c0 + cc) : w,
                   ok ? 16 : 0);
      }
    }
  } else {
    constexpr int kPer = kStageK * kTileN / kThreads;
    R v[kPer];
    const R* wr = reinterpret_cast<const R*>(w);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      const int gk = s.k0 + e / kTileN, cc = e % kTileN;
      v[j] = (gk < k_stop && cc < s.cols) ? wr[static_cast<size_t>(gk) * n + s.c0 + cc] : R(0);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      *reinterpret_cast<R*>(bs + (e / kTileN) * L::kB + (e % kTileN) * sizeof(TIn)) = v[j];
    }
  }
}

// -- main loops: one 32-deep stage into the warp's n-tiles ---------------------
//
// Fragment layouts are those of the PTX ISA for each mma shape: g = lane / 4
// picks the row (A, C) or the column (B), t = lane % 4 the depth.

template <typename TIn, typename AccT>
__device__ __forceinline__ void mma_stage(const uint8_t* stage, AccT (&acc)[kTilesPerWarp][4]) {
  using L = Smem<TIn>;
  const uint8_t* as = stage;
  const uint8_t* bs = stage + kTileM * L::kA;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // Every n-tile of the warp is computed, those past the tile's columns
  // included (their sums are never stored): straight-line code lets the
  // fragment loads of all tiles issue together and the independent mma of
  // different tiles overlap, where a branch per tile serialised them.
  if constexpr (std::is_same<TIn, int8_t>::value) {
    // m16n8k32: a0/a1 rows g/g+8 at depth 4t..4t+3, a2/a3 the same at +16;
    // b0 depth 4t..4t+3 of column g, b1 at +16
    const uint32_t a[4] = {ld32(as + g * L::kA + 4 * t), ld32(as + (g + 8) * L::kA + 4 * t),
                           ld32(as + g * L::kA + 16 + 4 * t),
                           ld32(as + (g + 8) * L::kA + 16 + 4 * t)};
    uint32_t b[kTilesPerWarp][2];
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j) {
      const uint8_t* col = bs + (warp + j * kWarps) * 8 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* p = col + (16 * h + 4 * t) * L::kB;
        b[j][h] = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[L::kB]) << 8) |
                  (static_cast<uint32_t>(p[2 * L::kB]) << 16) |
                  (static_cast<uint32_t>(p[3 * L::kB]) << 24);
      }
    }
#pragma unroll
    for (int j = 0; j < kTilesPerWarp; ++j) mma_s8(acc[j], a, b[j][0], b[j][1]);
  } else if constexpr (std::is_same<TIn, __nv_bfloat16>::value) {
    // m16n8k16: a0/a1 rows g/g+8 at depth 2t, 2t+1, a2/a3 at +8; B from
    // ldmatrix.x2.trans over depth rows ks..ks+15 (lanes 0-15 give the rows)
#pragma unroll
    for (int ks = 0; ks < kStageK; ks += 16) {
      const uint32_t a[4] = {ld32(as + g * L::kA + (ks + 2 * t) * 2),
                             ld32(as + (g + 8) * L::kA + (ks + 2 * t) * 2),
                             ld32(as + g * L::kA + (ks + 8 + 2 * t) * 2),
                             ld32(as + (g + 8) * L::kA + (ks + 8 + 2 * t) * 2)};
      uint32_t b[kTilesPerWarp][2];
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b[j][0]), "=r"(b[j][1])
                     : "r"(smem_addr(bs + (ks + (lane & 15)) * L::kB + (warp + j * kWarps) * 16)));
      }
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
    }
  } else {
    // m16n8k8 tf32, three products per step (3xTF32): a0/a1 rows g/g+8 at
    // depth t, a2/a3 at t+4; b0 depth t of column g, b1 depth t+4.  Each
    // product runs over all tiles before the next, so no mma waits on the
    // one just issued.
#pragma unroll
    for (int ks = 0; ks < kStageK; ks += 8) {
      const float* a_row = reinterpret_cast<const float*>(as + g * L::kA) + ks + t;
      const float* a_row8 = reinterpret_cast<const float*>(as + (g + 8) * L::kA) + ks + t;
      const float av[4] = {a_row[0], a_row8[0], a_row[4], a_row8[4]};
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(av[i], a_hi[i], a_lo[i]);
      uint32_t b_hi[kTilesPerWarp][2], b_lo[kTilesPerWarp][2];
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const float* col =
            reinterpret_cast<const float*>(bs + (ks + t) * L::kB) + (warp + j * kWarps) * 8 + g;
        split_tf32(col[0], b_hi[j][0], b_lo[j][0]);
        split_tf32(col[L::kB], b_hi[j][1], b_lo[j][1]);  // four rows of kB bytes down
      }
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) mma_tf32(acc[j], a_hi, b_lo[j][0], b_lo[j][1]);
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) mma_tf32(acc[j], a_lo, b_hi[j][0], b_hi[j][1]);
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) mma_tf32(acc[j], a_hi, b_hi[j][0], b_hi[j][1]);
    }
  }
}

template <typename TIn, typename TOut, int kEpi>
__global__ void __launch_bounds__(kThreads)
    scheduled_gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                          const typename Acc<TIn>::bias_type* __restrict__ bias,
                          TOut* __restrict__ out, int m, int k, int n, int block_m,
                          int block_n, int grid_m, int grid_n, int weight_stationary,
                          int col_split, int k_split, int col_tile, int vec_x, int vec_w,
                          float scale, float clip_lo, float clip_hi) {
  using AccT = typename Acc<TIn>::type;
  using V = typename Vec4<AccT>::type;
  using L = Smem<TIn>;
  extern __shared__ __align__(128) uint8_t smem[];
  AccT* slots = reinterpret_cast<AccT*>(smem + L::kRingBytes);  // k_split partial tiles
  cg::cluster_group cluster = cg::this_cluster();
  const bool split_k = k_split > 1;
  // every CTA of the cluster must have started before a peer writes to its
  // shared memory; the wait comes after the main loop, so this costs nothing
  if (split_k) cluster_arrive_relaxed();

  const int rank = static_cast<int>(cluster.block_rank());
  const int bid = blockIdx.x / (col_split * k_split);
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
  const int rank_col = rank / k_split, rank_k = rank % k_split;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // this CTA's K slice, in whole stages
  const int stages = (k + kStageK - 1) / kStageK;
  const int s_begin = rank_k * stages / k_split;
  const int n_stages = (rank_k + 1) * stages / k_split - s_begin;

  const int n_chunks = (col_end - col_begin + col_tile - 1) / col_tile;
  const int chunk_rounds = (n_chunks + col_split - 1) / col_split;  // same on every CTA

  for (int r0 = row_begin; r0 < row_end; r0 += kTileM) {
    for (int round = 0; round < chunk_rounds; ++round) {
      const int chunk = rank_col + round * col_split;
      const bool active = chunk < n_chunks;  // the same for a column tile's CTAs
      const int c0 = col_begin + chunk * col_tile;
      const int cols = min(col_tile, col_end - c0);
      const int ntiles = (cols + 7) / 8;
      AccT acc[kTilesPerWarp][4];
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = AccT(0);
      if (active) {
        Stage st{r0, row_end, 0, k, c0, cols};
        // ring: stages 0..kRing-1 in flight, then one refill per stage done;
        // one commit group per step keeps the wait count a constant
#pragma unroll
        for (int i = 0; i < kRing; ++i) {
          if (i < n_stages) {
            st.k0 = (s_begin + i) * kStageK;
            load_stage<TIn>(smem + i * L::kStage, x, w, k, n, st, vec_x, vec_w);
          }
          cp_async_commit();
        }
        for (int s = 0; s < n_stages; ++s) {
          uint8_t* slot = smem + (s % kRing) * L::kStage;
          cp_async_wait<kRing - 1>();
          __syncthreads();
          mma_stage<TIn>(slot, acc);
          __syncthreads();
          if (s + kRing < n_stages) {
            st.k0 = (s_begin + s + kRing) * kStageK;
            load_stage<TIn>(slot, x, w, k, n, st, vec_x, vec_w);
          }
          cp_async_commit();
        }
      }

      // Reduction.  n-tile T of the column tile belongs to rank T % k_split
      // of the column group; each CTA pushes its partial of T, in the C
      // fragment layout (rows g / g+8, columns 2t, 2t+1), into slot rank_k of
      // the owner's shared memory, and after one cluster barrier each owner
      // sums its tiles' slots 0, 1, ... in that order.
      if (split_k) cluster_wait();  // peers started, or done with the last round's slots
      if (active) {
#pragma unroll
        for (int j = 0; j < kTilesPerWarp; ++j) {
          const int tile = warp + j * kWarps;
          if (tile < ntiles) {
            AccT* owner = split_k ? cluster.map_shared_rank(slots, rank_col * k_split + tile % k_split)
                                  : slots;
            AccT* p = owner + rank_k * kSlot + g * kRedStride + tile * 8 + 2 * t;
            p[0] = acc[j][0];
            p[1] = acc[j][1];
            p[8 * kRedStride] = acc[j][2];
            p[8 * kRedStride + 1] = acc[j][3];
          }
        }
      }
      if (split_k) {
        cluster_arrive();  // release: the pushes above
        cluster_wait();    // acquire: every push to this CTA
      } else {
        __syncthreads();
      }
      if (active) {
        // this CTA's tiles rank_k, rank_k + k_split, ... as groups of 4
        // columns: row-major over (row, owned tile, half tile), so a row's
        // groups are adjacent threads; all partials load before any store
        constexpr int kPer = kTileM * kTileN / 4 / kThreads;
        const int shift = 6 - __ffs(k_split);  // log2(groups per row) = log2(32 / k_split)
        const int rows = min(kTileM, row_end - r0);
        V sums[kPer];
        bool live[kPer];
        int offs[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int e = threadIdx.x + j * kThreads;
          const int r = e >> shift, h = e & ((1 << shift) - 1);
          const int c = (rank_k + (h >> 1) * k_split) * 8 + (h & 1) * 4;
          live[j] = r < rows && c < cols;  // r < rows implies e < 16 groups-per-row
          offs[j] = r * kRedStride + c;
          if (live[j]) {
            sums[j] = *reinterpret_cast<const V*>(slots + offs[j]);
#pragma unroll
            for (int q = 1; q < kMaxCluster; ++q) {
              if (q < k_split) {
                const V p = *reinterpret_cast<const V*>(slots + q * kSlot + offs[j]);
                sums[j].x += p.x;
                sums[j].y += p.y;
                sums[j].z += p.z;
                sums[j].w += p.w;
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (live[j]) {
            const int r = offs[j] / kRedStride, c = offs[j] % kRedStride;
            const AccT v[4] = {sums[j].x, sums[j].y, sums[j].z, sums[j].w};
            TOut* o = out + static_cast<size_t>(r0 + r) * n + c0 + c;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (c + i < cols) {
                o[i] = finish<TOut, kEpi>(v[i], bias, c0 + c + i, scale, clip_lo, clip_hi);
              }
            }
          }
        }
      }
      const bool last = r0 + kTileM >= row_end && round + 1 == chunk_rounds;
      if (!last) {
        // the slots are read before the next round writes them
        if (split_k) {
          cluster_arrive();
        } else {
          __syncthreads();
        }
      }
    }
  }
}

__global__ void noop_kernel() {}

struct GemmArgs {
  const void* x;
  const void* w;
  const void* bias;
  void* out;
  int m, k, n, block_m, block_n, weight_stationary;
  int col_split, k_split, col_tile, vec_x, vec_w;
  float scale, clip_lo, clip_hi;
  cudaStream_t stream;
};

template <typename TIn, typename TOut, int kEpi>
cudaError_t launch(const GemmArgs& a) {
  const long long grid_m = (static_cast<long long>(a.m) + a.block_m - 1) / a.block_m;
  const long long grid_n = (static_cast<long long>(a.n) + a.block_n - 1) / a.block_n;
  const int cluster = a.col_split * a.k_split;
  if (grid_m * grid_n * cluster > INT_MAX) return cudaErrorInvalidConfiguration;
  using Bias = typename Acc<TIn>::bias_type;
  auto kernel = scheduled_gemm_kernel<TIn, TOut, kEpi>;
  // the f32 ring needs more than the default 48 KB of dynamic shared memory
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        Smem<TIn>::kBytes);
  if (rc != cudaSuccess) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(grid_m * grid_n * cluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = Smem<TIn>::kBytes;
  config.stream = a.stream;
  config.attrs = attr;
  config.numAttrs = 1;
  rc = cudaLaunchKernelEx(&config, kernel, static_cast<const TIn*>(a.x),
                          static_cast<const TIn*>(a.w), static_cast<const Bias*>(a.bias),
                          static_cast<TOut*>(a.out), a.m, a.k, a.n, a.block_m, a.block_n,
                          static_cast<int>(grid_m), static_cast<int>(grid_n),
                          a.weight_stationary, a.col_split, a.k_split, a.col_tile, a.vec_x,
                          a.vec_w, a.scale, a.clip_lo, a.clip_hi);
  if (rc != cudaSuccess) return rc;
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
                                    int block_n, int weight_stationary, int col_split,
                                    int k_split, int col_tile, int vec_x, int vec_w,
                                    int in_type, int out_type, int epilogue, float scale,
                                    float clip_lo, float clip_hi, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || block_m <= 0 || block_n <= 0 || col_split <= 0 ||
      k_split <= 0 || (k_split & (k_split - 1)) != 0 || col_split * k_split > kMaxCluster ||
      col_tile <= 0 ||
      col_tile > kTileN || col_tile % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const GemmArgs a{x, w, bias, out, m, k, n, block_m, block_n, weight_stationary,
                   col_split, k_split, col_tile, vec_x, vec_w, scale, clip_lo, clip_hi,
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

// An empty launch of one cluster of `cluster` CTAs (1: a plain one-CTA
// launch) on the caller's stream: the floor under any kernel's time.
extern "C" int repro_noop(int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(32);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(&config, noop_kernel);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
