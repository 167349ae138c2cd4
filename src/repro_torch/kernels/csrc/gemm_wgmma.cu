// Scheduled GEMM, float form, second design: warp-specialised wgmma + TMA
// for bf16 products of at least 64 rows on Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces, for those products, the TPU kernel repro/kernels/gemm.py:
// _gemm_kernel (reached through pl.pallas_call at gemm.py:145, launched by
// scheduled_gemm at gemm.py:97, epilogue _apply_epilogue at gemm.py:57) in
// its float instantiation:
//
//   out[m, n] = epilogue(x[m, k] @ w[k, n] (+ bias[n])),  x, w row-major bf16,
//   the sum in f32, the f32 bias added to it, then none | relu | gelu, then
//   the cast to bf16 or f32 (epilogue.cuh, the same code as gemm.cu's).
//
// What bounds it on this card.  The LM prefill at batch 8 x 128 gives
// m = 1024: at 4096 x 4096 the product is 34.4 GFLOP, 34.7 us at the bf16
// tensor-core peak of 989 TFLOP/s, against 42 MB of operands and result,
// 12.5 us at 3.35 TB/s; every m = 1024 LM product is bound by operations.
// gemm.cu's design walks each block 16 rows at a time and streams the
// block's whole K slice of w once per 16-row sub-tile, so w is read m / 16
// times; it ran at 3-4 % of the bound.  This design keeps the tensor cores
// fed instead:
//
//   * tiles follow the schedule: the CTA's output tile is the scheduler's
//     block_m x block_n (GemmKernelConfig), cut where wgmma cannot take it
//     whole (kernels/gemm.py: wgmma_geometry, the stated rule): 64, 128 or
//     256 rows (one consumer warpgroup of one m64 tile, two of one, two of
//     two), at most 256 columns, computed by an m64nNk16 instruction with N
//     the tile's width rounded up to 64, 128 or 256 (the 128-byte swizzle
//     atom of an N-major w is 64 columns wide; columns past the tile are
//     computed and not stored).  A block's tiles are adjacent in the launch
//     and the blocks keep GemmKernelConfig.grid_for's raster order (WS: n
//     outer), so the schedule still decides the tiling and the order;
//   * loads: one producer warp issues TMA loads (cp.async.bulk.tensor, 128-
//     byte swizzle) of the x tile (K-major, 64 deep) and of the w tile (N-
//     major, 64 x 64 boxes) into a ring of stages, each with a full and an
//     empty mbarrier; the descriptors are encoded on the host
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion) and
//     passed as __grid_constant__ parameters.  TMA fills zeros past m, k and
//     n, so ragged edges need no code in the main loop;
//   * consumers: each warpgroup issues four m64nNk16 bf16 -> f32 wgmma per
//     stage and m64 tile (x from shared memory K-major, w through the
//     transpose bit), keeps one stage's group in flight while it waits for
//     the next, and releases a stage after wgmma.wait_group;
//   * split K only where the tiles leave most of the 132 SMs idle (fewer
//     than 66 tiles): the tile's CTAs form a cluster of k_split, each takes
//     the slice of whole stages the caller gives it (kernels/gemm.py:
//     WgmmaGeometry.k_slices), writes its partial sums into its own shared
//     memory, and after a cluster barrier each CTA sums a share of the rows
//     from every rank in the fixed order 0, 1, ... (distributed shared
//     memory), so two launches give the same bits: no atomics, no workspace;
//   * epilogue: bias, activation and cast from registers into a tile staged
//     in shared memory over the spent ring, then whole rows out with 16-byte
//     stores (the split-K path finishes its rank-ordered sums through
//     finish<> too, element by element).
//
// Register budget: a consumer thread holds N / 2 f32 sums per m64 tile, so
// two m64 tiles per warpgroup (256-row tiles) take N <= 128.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kStageK = 64;                  // depth of a stage: one 128-byte row of bf16
constexpr int kAtomN = 64;                   // columns of one 128-byte-swizzled w box
constexpr int kAtomBytes = kStageK * 128;    // one w box: 64 rows of 128 bytes
constexpr int kMaxStages = 8;                // the deepest ring the mbarrier header holds
constexpr int kMaxCluster = 8;
constexpr int kHeader = 1024;                // the mbarriers, before the 1024-aligned ring
constexpr int kProducer = 32;                // one producer warp after the consumers

// Where each rank's K slice starts, in stages; begin[k_split] is the end.
struct KSlices {
  int begin[kMaxCluster + 1];
};

template <int kConsumers, int kMTiles, int kN>
struct Tile {
  static constexpr int kThreads = kConsumers * 128 + kProducer;
  static constexpr int kM = 64 * kConsumers * kMTiles;       // rows of the tile
  static constexpr int kABytes = kM * 128;                   // x: kM rows of 64 bf16
  static constexpr int kBBytes = kN / kAtomN * kAtomBytes;   // w: kN / 64 boxes
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kAcc = kN / 2;                        // f32 sums per thread per m64 tile
  static constexpr int kRedStride = kN + 8;                  // floats per partial-sum row
  static_assert(kN % kAtomN == 0 && kN <= 256, "wgmma width");
  static_assert(kMTiles * kAcc <= 128, "accumulators beyond the register budget");
};

// -- PTX wrappers (the rest in hopper.cuh) ------------------------------------

// 2-D TMA load of the box at (c0 inner, c1 outer) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The operands' shared-memory descriptors (hopper.cuh: smem_desc):
//   x (K-major): rows of 128 bytes, 8-row groups 1024 bytes apart (stride);
//     the leading offset is unused within one 128-byte swizzle row.
//   w (N-major): k rows of 128 bytes (64 columns), 8-row groups 1024 bytes
//     apart (stride), 64-column boxes kAtomBytes apart (leading).
template <int kN>
struct Mma;

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B from shared memory
// (A K-major, B N-major: imm-trans-b = 1), scale-d on.
template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Finishes one m64 tile's sums into the shared-memory staging tile (row
// stride kN + 8 elements): thread (warp w of the warpgroup, lane l) holds
// rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1).  The bias is loaded
// once per column pair and added as finish<> would add it.
template <typename TOut, int kEpi, int kN>
__device__ __forceinline__ void stage_tile(const float (&acc)[kN / 2], TOut* stage,
                                           const float* __restrict__ bias, int r0, int col0,
                                           int col_end) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      if (col0 + c < col_end) b0 = bias[col0 + c];
      if (col0 + c + 1 < col_end) b1 = bias[col0 + c + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      const TOut v0 = finish<TOut, kEpi>(bias != nullptr ? a0 + b0 : a0, nullptr, 0, 0.f, 0.f, 0.f);
      const TOut v1 = finish<TOut, kEpi>(bias != nullptr ? a1 + b1 : a1, nullptr, 0, 0.f, 0.f, 0.f);
      TOut* p = stage + (r0 + 16 * warp + lane / 4 + 8 * h) * (kN + 8) + c;
      if constexpr (sizeof(TOut) == 2) {
        __nv_bfloat162 pair;
        pair.x = v0;
        pair.y = v1;
        *reinterpret_cast<__nv_bfloat162*>(p) = pair;
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      }
    }
  }
}

// Writes the staged tile's rows [row0, row_end) x [col0, col_end) out with
// 16-byte stores (col0 is a multiple of 8 and n of 8, so every chunk is
// aligned; element stores at a ragged edge), the consumer threads
// together, a row's chunks on adjacent threads.
template <typename TOut, int kN>
__device__ __forceinline__ void store_rows(const TOut* stage, TOut* __restrict__ out, int n,
                                           int row0, int row_end, int col0, int col_end,
                                           int threads) {
  constexpr int kV = 16 / sizeof(TOut);
  constexpr int kChunks = kN / kV;
  const int rows = row_end - row0, cols = col_end - col0;
  for (int e = threadIdx.x; e < rows * kChunks; e += threads) {
    const int r = e / kChunks, c = (e % kChunks) * kV;
    if (c >= cols) continue;
    const TOut* src = stage + r * (kN + 8) + c;
    TOut* dst = out + static_cast<size_t>(row0 + r) * n + col0 + c;
    if (c + kV <= cols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < kV && c + i < cols; ++i) dst[i] = src[i];
    }
  }
}

template <typename TOut, int kEpi>
__device__ __forceinline__ void finish4(TOut* __restrict__ o, const float4& s,
                                        const float* __restrict__ bias, int col, int col_end) {
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col + i < col_end) o[i] = finish<TOut, kEpi>(v[i], bias, col + i, 0.f, 0.f, 0.f);
  }
}

// Three CTAs of one consumer warpgroup share an SM up to N = 128 (their
// 3-stage rings fit, and the registers are capped for it): more warpgroups
// issuing wgmma on an SM beat a deeper ring.  At N = 256 a thread's 128
// sums need more than a third of the registers.
template <int kConsumers, int kMTiles, int kN, typename TOut>
__global__ void __launch_bounds__(Tile<kConsumers, kMTiles, kN>::kThreads,
                                  kConsumers == 2 ? 1 : (kN <= 128 ? 3 : 2))
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                      TOut* __restrict__ out, int m, int k, int n, int block_m, int block_n,
                      int grid_inner, int weight_stationary, int tile_n, int sub_m, int sub_n,
                      int k_split, KSlices slices, int stages, int epilogue) {
  using T = Tile<kConsumers, kMTiles, kN>;
  extern __shared__ uint8_t smem_raw[];
  // the ring's boxes must start on 1024-byte boundaries (the swizzle's period)
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kMaxStages;
  uint8_t* ring = base + kHeader;

  // The tile: cluster c is sub-tile c % (sub_m * sub_n) of block c / (...),
  // the blocks in GemmKernelConfig.grid_for order (WS: n outer).
  const int cluster_id = blockIdx.x / k_split, rank = blockIdx.x % k_split;
  const int per_block = sub_m * sub_n;
  const int blk = cluster_id / per_block, sub = cluster_id % per_block;
  const int outer = blk / grid_inner, inner = blk % grid_inner;
  const int bm = weight_stationary ? inner : outer, bn = weight_stationary ? outer : inner;
  const int row0 = bm * block_m + (sub / sub_n) * T::kM;
  const int col0 = bn * block_n + (sub % sub_n) * tile_n;
  const int row_end = min(min(row0 + T::kM, (bm + 1) * block_m), m);
  const int col_end = min(min(col0 + tile_n, (bn + 1) * block_n), n);
  if (row0 >= row_end || col0 >= col_end) return;  // the same for every CTA of a cluster

  // this CTA's K slice, in whole stages
  const int s_begin = slices.begin[rank];
  const int n_stages = slices.begin[rank + 1] - s_begin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kMTiles][T::kAcc];
  if (warp == kConsumers * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_w)) : "memory");
      for (int s = 0; s < n_stages; ++s) {
        const int slot = s % stages;
        if (s >= stages) mbar_wait(&empty[slot], ((s / stages) & 1) ^ 1);
        uint8_t* a = ring + slot * T::kStageBytes;
        const int kk = (s_begin + s) * kStageK;
        mbar_expect_tx(&full[slot], T::kStageBytes);  // whole boxes, zeros past the edges included
        tma_load(a, &map_x, kk, row0, &full[slot]);
#pragma unroll
        for (int j = 0; j < kN / kAtomN; ++j) {
          tma_load(a + T::kABytes + j * kAtomBytes, &map_w, col0 + j * kAtomN, kk, &full[slot]);
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup g takes m64 tiles g * kMTiles ...
    const int g = warp / 4;
#pragma unroll
    for (int t = 0; t < kMTiles; ++t)
#pragma unroll
      for (int i = 0; i < T::kAcc; ++i) acc[t][i] = 0.0f;
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % stages;
      mbar_wait(&full[slot], (s / stages) & 1);
      const uint32_t a = smem_addr(ring + slot * T::kStageBytes) + g * kMTiles * 64 * 128;
      const uint32_t b = smem_addr(ring + slot * T::kStageBytes + T::kABytes);
#pragma unroll
      for (int t = 0; t < kMTiles; ++t) fence_regs(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 16; ++kk) {
#pragma unroll
        for (int t = 0; t < kMTiles; ++t) {
          Mma<kN>::run(acc[t], smem_desc(a + t * 64 * 128 + kk * 32, 16, 1024),
                       smem_desc(b + kk * 16 * 128, kAtomBytes, 1024));
        }
      }
      wgmma_commit();
#pragma unroll
      for (int t = 0; t < kMTiles; ++t) fence_regs(acc[t]);
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % stages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kMTiles; ++t) fence_regs(acc[t]);
  }

  if (k_split == 1) {
    if (warp < kConsumers * 4) {
      // every consumer is done with the ring (its last wgmma waited on, every
      // TMA load consumed) before the finished tile is staged over it
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
      TOut* stage = reinterpret_cast<TOut*>(ring);
      const int g = warp / 4;
#pragma unroll
      for (int t = 0; t < kMTiles; ++t) {
        const int r0 = (g * kMTiles + t) * 64;
        switch (epilogue) {
          case kRelu:
            stage_tile<TOut, kRelu, kN>(acc[t], stage, bias, r0, col0, col_end);
            break;
          case kGelu:
            stage_tile<TOut, kGelu, kN>(acc[t], stage, bias, r0, col0, col_end);
            break;
          default:
            stage_tile<TOut, kNone, kN>(acc[t], stage, bias, r0, col0, col_end);
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
      store_rows<TOut, kN>(stage, out, n, row0, row_end, col0, col_end, kConsumers * 128);
    }
    return;
  }

  // Split K.  Every consumer is done with the ring (its last wgmma waited
  // on, every TMA load consumed) before any writes partial sums over it.
  float* part = reinterpret_cast<float*>(ring);
  if (warp < kConsumers * 4) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
    const int g = warp / 4, w4 = warp % 4;
#pragma unroll
    for (int t = 0; t < kMTiles; ++t) {
#pragma unroll
      for (int i = 0; i < T::kAcc; i += 2) {
        const int r = (g * kMTiles + t) * 64 + 16 * w4 + lane / 4 + 8 * ((i % 4) / 2);
        const int c = 8 * (i / 4) + 2 * (lane % 4);
        *reinterpret_cast<float2*>(part + r * T::kRedStride + c) = make_float2(acc[t][i], acc[t][i + 1]);
      }
    }
  }
  cluster_arrive();  // release: this CTA's partial sums
  cluster_wait();    // acquire: every rank's
  {
    // this CTA's share of the rows, summed over the ranks in order 0, 1, ...
    cg::cluster_group cluster = cg::this_cluster();
    const int rows = T::kM / k_split;
    constexpr int kGroups = kN / 4;
    for (int e = threadIdx.x; e < rows * kGroups; e += T::kThreads) {
      const int r = rank * rows + e / kGroups, c = (e % kGroups) * 4;
      const int grow = row0 + r, gcol = col0 + c;
      if (grow < row_end && gcol < col_end) {
        const int off = r * T::kRedStride + c;
        float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + off);
        for (int q = 1; q < k_split; ++q) {
          const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, q) + off);
          s.x += p.x;
          s.y += p.y;
          s.z += p.z;
          s.w += p.w;
        }
        TOut* o = out + static_cast<size_t>(grow) * n + gcol;
        switch (epilogue) {
          case kRelu:
            finish4<TOut, kRelu>(o, s, bias, gcol, col_end);
            break;
          case kGelu:
            finish4<TOut, kGelu>(o, s, bias, gcol, col_end);
            break;
          default:
            finish4<TOut, kNone>(o, s, bias, gcol, col_end);
        }
      }
    }
  }
  cluster_arrive();  // no CTA leaves while a peer still reads its shared memory
  cluster_wait();
}

// -- host side -----------------------------------------------------------------

// A row-major bf16 [rows, cols] matrix, boxes of box_cols x box_rows, 128-
// byte swizzle, zeros past the edges.
int encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(rc);
}

struct WgArgs {
  const void* x;
  const void* w;
  const float* bias;
  void* out;
  int m, k, n, block_m, block_n, weight_stationary;
  int tile_n, sub_m, sub_n, k_split;
  KSlices slices;
  int stages, epilogue;
  cudaStream_t stream;
};

template <int kConsumers, int kMTiles, int kN, typename TOut>
int launch_wgmma(const WgArgs& a) {
  using T = Tile<kConsumers, kMTiles, kN>;
  const long long grid_m = (static_cast<long long>(a.m) + a.block_m - 1) / a.block_m;
  const long long grid_n = (static_cast<long long>(a.n) + a.block_n - 1) / a.block_n;
  const long long ctas = grid_m * grid_n * a.sub_m * a.sub_n * a.k_split;
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  // the ring, or the f32 partial sums / finished tile staged over it if larger
  const int staged = T::kM * T::kRedStride * 4;
  const int ring = a.stages * T::kStageBytes;
  const int smem = 1024 + kHeader + (staged > ring ? staged : ring);
  CUtensorMap map_x, map_w;
  int rc = encode(&map_x, a.x, a.m, a.k, kStageK, T::kM);
  if (rc != 0) return rc;
  rc = encode(&map_w, a.w, a.k, a.n, kAtomN, kStageK);
  if (rc != 0) return rc;
  auto kernel = wgmma_gemm_kernel<kConsumers, kMTiles, kN, TOut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.k_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(ctas));
  config.blockDim = dim3(T::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = a.stream;
  config.attrs = attr;
  config.numAttrs = a.k_split > 1 ? 1 : 0;
  const int grid_inner = static_cast<int>(a.weight_stationary ? grid_m : grid_n);
  err = cudaLaunchKernelEx(&config, kernel, map_x, map_w, a.bias, static_cast<TOut*>(a.out), a.m,
                           a.k, a.n, a.block_m, a.block_n, grid_inner, a.weight_stationary,
                           a.tile_n, a.sub_m, a.sub_n, a.k_split, a.slices, a.stages,
                           a.epilogue);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kConsumers, int kMTiles, typename TOut>
int by_width(int inst_n, const WgArgs& a) {
  switch (inst_n) {
    case 64:
      return launch_wgmma<kConsumers, kMTiles, 64, TOut>(a);
    case 128:
      return launch_wgmma<kConsumers, kMTiles, 128, TOut>(a);
    case 256:
      if constexpr (kMTiles == 1) return launch_wgmma<kConsumers, kMTiles, 256, TOut>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename TOut>
int by_tile(int tile_m, int inst_n, const WgArgs& a) {
  switch (tile_m) {
    case 64:
      return by_width<1, 1, TOut>(inst_n, a);
    case 128:
      return by_width<2, 1, TOut>(inst_n, a);
    case 256:
      return by_width<2, 2, TOut>(inst_n, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// out = epilogue(x @ w (+ bias)) for bf16 x[m, k], w[k, n] (row-major,
// contiguous, 16-byte aligned bases, k and n multiples of 8), m >= 64.
// Every tile starts on a column that is a multiple of 8 (block_n and
// tile_n multiples of 8): a TMA box starting elsewhere never completes.  The
// geometry (tile_m, tile_n, inst_n, sub_m, sub_n, k_split, k_begin, stages)
// comes from kernels/gemm.py:wgmma_geometry; k_begin[r] is the stage at which
// rank r's K slice starts (0 for rank 0, rising, each slice at least one stage).
extern "C" int repro_wgmma_gemm(const void* x, const void* w, const void* bias, void* out, int m,
                                int k, int n, int block_m, int block_n, int weight_stationary,
                                int tile_m, int tile_n, int inst_n, int sub_m, int sub_n,
                                int k_split, const int* k_begin, int stages, int out_type,
                                int epilogue, void* stream) {
  const int total = (k + kStageK - 1) / kStageK;
  if (m < 64 || k <= 0 || n <= 0 || k % 8 != 0 || n % 8 != 0 || block_m <= 0 || block_n <= 0 ||
      block_n % 8 != 0 || tile_n % 8 != 0 ||
      tile_n <= 0 || tile_n > inst_n || sub_m <= 0 || sub_n <= 0 ||
      tile_m * sub_m < std::min(block_m, m) || tile_n * sub_n < std::min(block_n, n) || k_split <= 0 || k_split > kMaxCluster ||
      (k_split & (k_split - 1)) != 0 || k_begin == nullptr || stages < 2 || stages > kMaxStages ||
      tile_m % k_split != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || epilogue < kNone || epilogue > kGelu) {
    return cudaErrorInvalidValue;
  }
  KSlices slices{};
  for (int r = 0; r < k_split; ++r) slices.begin[r] = k_begin[r];
  slices.begin[k_split] = total;
  for (int r = 0; r < k_split; ++r) {
    if (slices.begin[r] >= slices.begin[r + 1]) return cudaErrorInvalidValue;
  }
  if (slices.begin[0] != 0) return cudaErrorInvalidValue;
  const WgArgs a{x, w, static_cast<const float*>(bias), out, m, k, n, block_m, block_n,
                 weight_stationary, tile_n, sub_m, sub_n, k_split, slices, stages, epilogue,
                 static_cast<cudaStream_t>(stream)};
  switch (out_type) {
    case kOutF32:
      return by_tile<float>(tile_m, inst_n, a);
    case kOutBF16:
      return by_tile<__nv_bfloat16>(tile_m, inst_n, a);
  }
  return cudaErrorInvalidValue;
}
