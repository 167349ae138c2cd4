// MLA's absorbed decode attention over the bf16 latent cache on Hopper
// (sm_90a): one split kernel and its combine, warp-specialised wgmma + TMA,
// with a plain C interface for ctypes.
//
//   out[b, h, :] = sum_{s < len} softmax_s(scale (q_lat[b, h] . c[b, s] + q_rope[b, h] . k_rope[b, s])) c[b, s]
//
// for q_lat [B, H, 512] and q_rope [B, H, 64], and the cache's latent c
// [B, S_max, 512] and k_rope [B, S_max, 64], bf16, read in place; len is
// read from a device int64, so a CUDA graph captured once serves every
// step of a cache.  The logits are bf16 products summed in f32, the
// softmax f32 (an online max and sum), the weights rounded to bf16 for the
// value product, the sum f32; out [B, H, 512] f32.  Positions at or past
// len are never weighed, whatever the cache holds there.
//
// It replaces no TPU kernel.  The reference's absorbed decode,
// repro/models/attention.py:mla_decode_attention, is plain jnp and reaches
// no pl.pallas_call; the port's plain version (kernels/mla.py:
// mla_decode_plain) copies the whole latent cache to f32, runs f32 products
// over all S_max positions under a mask and reduces a [B, H, S_max] f32
// logit tensor in separate passes: 12.7 ms of deepseek-longdoc's 24.35 ms
// decode step over its 12 layers.
//
// What bounds it on this card.  This is MQA with H query rows over one
// latent head that is both K (576 deep with k_rope) and V (512 wide).  At
// deepseek-longdoc's layer (B 4, H 128, len 16,448) the latent and k_rope
// are 75.8 MB, 22.6 us at 3.35 TB/s, and the products 2 B H len (576 + 512)
// = 18.3 GFLOP, 18.5 us at 989 TFLOP/s: the two bounds lie close, so the
// design keeps the tensor cores fed while it streams.  The
// design, after DeepSeek's FlashMLA:
//
//   * grid: one CTA per (64-head block, split of positions, batch row), the
//     head blocks of one split adjacent in the launch, so both read each
//     latent tile from L2 at about the same time; a fixed number of splits,
//     sized by the caller from S_max and the SM count (one shape to
//     capture), each taking an equal share of the tiles below len (read on
//     the device), and splits past the last tile exiting at once;
//   * loads: one thread issues TMA loads (3-D tensor maps over the
//     tensors' own strides, 128-byte swizzle, zeros past the edges) of the
//     64 x 576 q tile once and of 64 x 576 latent tiles (512 latent + 64
//     rope dims) into a two-stage ring;
//   * math: warpgroup 0 runs S = Q K^T (m64n64k16, 36 steps), the online
//     softmax in f32 registers, and writes P (bf16, 128-byte swizzle) and
//     each row's rescale to shared memory; then both warpgroups run O +=
//     P V over their own 256 of the 512 output dims (m64n256k16, 64 x 256
//     f32 accumulators each), V being the latent part of the same tile;
//     warpgroup 0 computes the next tile's logits while warpgroup 1 still
//     runs its half of this tile's;
//   * the last tile: logits at or past len set to -inf, and the tile's
//     latent rows there zeroed in shared memory before P V reads them;
//   * epilogue: each split writes its normalised 64 x 512 partial and each
//     row's log2-sum-exp; the combine (one CTA per head and batch row)
//     weighs the active splits' partials by their sums.
//
// Shared memory: the q tile (72 KB), two latent tiles (144 KB), P (8 KB)
// and 1 KB of mbarriers and row scales, 225 KB of the 227 KB a CTA may take.
// Measured slower at deepseek-longdoc's layer, and left out: asking the
// next four tiles into L2 ahead of the ring (56 against 50 us at 16,448),
// and the two head blocks of a split as one cluster sharing each tile by
// TMA multicast (64 us).  Without either, the latent streams at about half
// the card's 3.35 TB/s, through L2 twice (once for each head block).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

constexpr int kLatent = 512;                 // r: the latent's width, V's and K's first part
constexpr int kRope = 64;                    // dr: K's rope part, one box
constexpr int kBoxes = (kLatent + kRope) / 64;  // a 576-deep row in boxes of 64 dims (128 bytes)
constexpr int kHeads = 64;                   // query heads of a CTA: one wgmma M tile
constexpr int kBN = 64;                      // positions of a latent tile
constexpr int kStages = 2;                   // latent ring depth
constexpr int kThreads = 2 * 128;            // two warpgroups; warpgroup 1's first thread issues the loads
constexpr int kBox = 64 * 128;               // one box: 64 rows of 128 bytes
constexpr int kTileBytes = kBoxes * kBox;    // the q tile, and each latent tile
constexpr int kPBytes = kHeads * kBN * 2;
constexpr int kHeader = 1024;                // mbarriers and the row scales, before the tiles
constexpr int kSmem = 1024 + kHeader + (1 + kStages) * kTileBytes + kPBytes;
static_assert(kSmem <= 232448, "a CTA takes at most 227 KB of shared memory");
static_assert(kLatent == 2 * 256, "each consumer warpgroup accumulates 256 of the output dims");
// named barriers of the two consumer warpgroups (0 is __syncthreads):
// P and the row scales of a tile are in shared memory; warpgroup 1 is done
// with them; the row sums are in shared memory
constexpr int kBarPFull = 1, kBarPFree = 2, kBarDone = 3;
constexpr int kCombineThreads = kLatent / 4;  // a float4 each

// 3-D TMA load of the box at (c0 inner, c1, c2) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The two warpgroups' named barriers (256 threads): sync waits, arrive
// does not.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}
// Shared-memory writes of this thread made visible to wgmma's (async proxy) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The positions a step attends: the device length, clamped to [0, s_max].
__device__ __forceinline__ int valid_positions(const long long* length, int s_max) {
  const long long n = *length;
  return n <= 0 ? 0 : (n >= s_max ? s_max : static_cast<int>(n));
}
// Tiles a split takes at n positions: an equal share, the last split's less.
__device__ __forceinline__ int tiles_per_split(int n, int n_split) {
  const int tiles = (n + kBN - 1) / kBN;
  return (tiles + n_split - 1) / n_split;
}

// S (64 heads x 64 positions) = Q K^T, 16 dims a step: m64n64k16, A and B
// K-major in shared memory; scale-d off on the first step.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 heads x 256 dims) += P V, 16 positions a step: m64n256k16, A (P)
// K-major and B (V) N-major through the transpose bit, both in shared memory.
__device__ __forceinline__ void wgmma_pv(float (&d)[128], uint64_t a, uint64_t b) {
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



// A descriptor the compiler sees change here: each step's descriptor is
// then this one plus its offset (in 16-byte units, the address field's),
// computed where it is used, and the steps' descriptors are not all held in
// registers across the loop over tiles, which the accumulators need.
__device__ __forceinline__ uint64_t opaque(uint64_t desc) {
  asm volatile("" : "+l"(desc));
  return desc;
}

// O (this warpgroup's 64 x 256) += P (64 x 64, shared memory at p) times the
// 64 x 256 of V in the four boxes at v.
__device__ __forceinline__ void pv_product(float (&o)[128], uint32_t p, uint32_t v) {
  const uint64_t p_desc = opaque(smem_desc(p, 16, 1024)), v_desc = opaque(smem_desc(v, kBox, 1024));
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    // P: 16 positions (32 bytes) a step along its 128-byte rows; V: 16 rows,
    // its 64-dim boxes kBox apart
    wgmma_pv(o, p_desc + kk * 32 / 16, v_desc + kk * 16 * 128 / 16);
  }
  wgmma_commit();
  fence_regs(o);
  wgmma_wait<0>();
  fence_regs(o);
}

// This warpgroup's rows of a split's partial, times each row's 1 / sum:
// element 4 j + 2 hh + c is (row row0 + 8 hh, dim col0 + 8 j + 2 (lane % 4) + c).
__device__ __forceinline__ void store_partial(const float (&o)[128], const float (&inv)[2], float* part,
                                              int b, int h0, int heads, int n_split, int split, int row0,
                                              int col0, int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = h0 + row0 + 8 * hh;
    if (h >= heads) continue;
    float* dst = part + ((static_cast<size_t>(b) * heads + h) * n_split + split) * kLatent + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
    }
  }
}

// Latent tile `it` of the split (from position k0) into its ring slot,
// completing on the slot's full barrier: 8 boxes of the latent, 1 of k_rope.
__device__ __forceinline__ void load_tile(uint8_t* ring, uint64_t* kv_full, const CUtensorMap* map_c,
                                          const CUtensorMap* map_cr, int it, int k0, int b) {
  const int slot = it % kStages;
  uint8_t* tile = ring + slot * kTileBytes;
  mbar_expect_tx(&kv_full[slot], kTileBytes);  // whole boxes, zeros past S_max included
#pragma unroll
  for (int x = 0; x < kBoxes - 1; ++x) tma_load(tile + x * kBox, map_c, x * 64, k0, b, &kv_full[slot]);
  tma_load(tile + (kBoxes - 1) * kBox, map_cr, 0, k0, b, &kv_full[slot]);
}

// One CTA: heads 64 hb ... 64 hb + 63 of batch row b over split `split` of
// the positions.  No warp is kept for the loads (it would cap the
// registers, which the two 64 x 256 accumulators need): thread 128, the
// first of warpgroup 1, issues them, refilling a slot once both warpgroups
// are done with it, while warpgroup 0 computes the next tile's logits.
__global__ void __launch_bounds__(kThreads, 1)
    mla_decode_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_qr,
                      const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_cr,
                      const long long* __restrict__ length, int s_max, int heads, int n_split,
                      float scale_log2, float* __restrict__ part, float* __restrict__ lse) {
  const int head_blocks = (heads + kHeads - 1) / kHeads;
  const int hb = blockIdx.x % head_blocks;
  const int split = (blockIdx.x / head_blocks) % n_split;
  const int b = blockIdx.x / (head_blocks * n_split);
  const int n = valid_positions(length, s_max);
  const int per = tiles_per_split(n, n_split);
  const int first = split * per;
  const int count = min(per, (n + kBN - 1) / kBN - first);  // tiles of this split
  if (count <= 0) return;  // past the length: the combine reads no partial of it

  extern __shared__ uint8_t smem_raw[];
  // the tiles must start on 1024-byte boundaries (the swizzle's period)
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;
  float* rescale = reinterpret_cast<float*>(base + 256);  // each row's alpha of the tile in P
  float* inv_sum = reinterpret_cast<float*>(base + 512);  // each row's 1 / sum, at the end
  uint8_t* q_tile = base + kHeader;
  uint8_t* ring = q_tile + kTileBytes;
  uint8_t* p_tile = ring + kStages * kTileBytes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], 8);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr int kLoader = 128;
  if (threadIdx.x == kLoader) {
    prefetch_map(&map_q);
    prefetch_map(&map_qr);
    prefetch_map(&map_c);
    prefetch_map(&map_cr);
    mbar_expect_tx(q_full, kTileBytes);  // whole boxes, zeros past H included
#pragma unroll
    for (int x = 0; x < kBoxes - 1; ++x) tma_load(q_tile + x * kBox, &map_q, x * 64, hb * kHeads, b, q_full);
    tma_load(q_tile + (kBoxes - 1) * kBox, &map_qr, 0, hb * kHeads, b, q_full);
    for (int it = 0; it < min(kStages, count); ++it) load_tile(ring, kv_full, &map_c, &map_cr, it, (first + it) * kBN, b);
  }
  __syncwarp();

  // warpgroup g accumulates output dims 256 g ... 256 g + 255; this thread
  // holds rows row0 and row0 + 8 of the 64 heads and, in each 8-column
  // group j of a product, columns 8 j + 2 (lane % 4) and + 1
  const int g = warp / 4;
  const int row0 = 16 * (warp % 4) + lane / 4;
  const uint32_t p_addr = smem_addr(p_tile), ring_addr = smem_addr(ring);
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.0f;

  if (g == 0) {
    float s[32];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    const uint32_t q_addr = smem_addr(q_tile);
    mbar_wait(q_full, 0);
    for (int it = 0; it < count; ++it) {
      const int slot = it % kStages, k0 = (first + it) * kBN;
      const uint32_t tile = ring_addr + slot * kTileBytes;
      mbar_wait(&kv_full[slot], (it / kStages) & 1);
      // S = Q K^T over the 576 dims: box kk / 4, 32 bytes a step within it
      const uint64_t q_desc = opaque(smem_desc(q_addr, 16, 1024)), k_desc = opaque(smem_desc(tile, 16, 1024));
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBoxes * 4; ++kk) {
        const uint32_t off = ((kk / 4) * kBox + (kk % 4) * 32) / 16;
        wgmma_qk(s, q_desc + off, k_desc + off, kk > 0);
      }
      wgmma_commit();
      fence_regs(s);
      wgmma_wait<0>();
      fence_regs(s);

      if (k0 + kBN > n) {
        // the last tile: its logits at or past the length out, and its
        // latent rows there zeroed, so that whatever the cache holds past
        // the length (NaN included) adds nothing to P V
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (k0 + 8 * j + 2 * (lane % 4) + (i % 2) >= n) s[4 * j + i] = -INFINITY;
          }
        }
        uint8_t* rows = ring + slot * kTileBytes;
        constexpr int kChunks = (kBoxes - 1) * 8;  // 16-byte chunks of a row's latent part
        for (int e = threadIdx.x; e < (k0 + kBN - n) * kChunks; e += 128) {
          const int row = n - k0 + e / kChunks, c = e % kChunks;
          *reinterpret_cast<uint4*>(rows + (c / 8) * kBox + row * 128 + (c % 8) * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_async_smem();
      }

      // online softmax, in units of log2: m is the row max of the scaled logits
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        const float m_new = fmaxf(m[hh], mx * scale_log2);
        const float shift = m_new == -INFINITY ? 0.0f : m_new;  // a row masked so far stays at 0
        alpha[hh] = ex2(m[hh] - shift);
        m[hh] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& e = s[4 * j + 2 * hh + c];
            e = ex2(fmaf(e, scale_log2, -shift));
            sum += e;
          }
        }
        l[hh] = l[hh] * alpha[hh] + sum;  // this thread's share of the row sum
      }

      // P and the rescale to shared memory, once warpgroup 1 is done with
      // the last tile's: row R's 16-byte chunk c at chunk c ^ (R % 8)
      if (it > 0) bar_sync(kBarPFree);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          *reinterpret_cast<uint32_t*>(p_tile + row * 128 + ((j ^ (row % 8)) * 16) + (lane % 4) * 4) =
              pack_bf16(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
        }
        if (lane % 4 == 0) rescale[row] = alpha[hh];
      }
      fence_async_smem();
      bar_sync(kBarPFull);
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= alpha[(i % 4) / 2];
      pv_product(o, p_addr, tile);
      if (lane == 0) mbar_arrive(&kv_empty[slot]);
    }

    // the row sums over the 4 lanes of a row; each row's log2-sum-exp
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = l[hh];
      sum += __shfl_xor_sync(0xffffffff, sum, 1);
      sum += __shfl_xor_sync(0xffffffff, sum, 2);
      inv[hh] = 1.0f / sum;  // every row has a position below the length
      const int row = row0 + 8 * hh, h = hb * kHeads + row;
      if (lane % 4 == 0) {
        inv_sum[row] = inv[hh];
        if (h < heads) lse[(static_cast<size_t>(b) * heads + h) * n_split + split] = m[hh] + log2f(sum);
      }
    }
    bar_arrive(kBarDone);
    store_partial(o, inv, part, b, hb * kHeads, heads, n_split, split, row0, 0, lane);
  } else {
    for (int it = 0; it < count; ++it) {
      const int slot = it % kStages;
      mbar_wait(&kv_full[slot], (it / kStages) & 1);
      bar_sync(kBarPFull);
      const float alpha[2] = {rescale[row0], rescale[row0 + 8]};
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= alpha[(i % 4) / 2];
      pv_product(o, p_addr, ring_addr + slot * kTileBytes + 4 * kBox);
      if (it + 1 < count) bar_arrive(kBarPFree);
      if (lane == 0) mbar_arrive(&kv_empty[slot]);
      if (threadIdx.x == kLoader && it + kStages < count) {
        // the slot is free once warpgroup 0 is done with it too
        mbar_wait(&kv_empty[slot], (it / kStages) & 1);
        load_tile(ring, kv_full, &map_c, &map_cr, it + kStages, (first + it + kStages) * kBN, b);
      }
      __syncwarp();
    }
    bar_sync(kBarDone);
    const float inv[2] = {inv_sum[row0], inv_sum[row0 + 8]};
    store_partial(o, inv, part, b, hb * kHeads, heads, n_split, split, row0, 256, lane);
  }
}

// One CTA per (batch row, head): the active splits' partials weighed by
// 2^(lse - max lse), over their weights' sum.  A length of 0 gives zeros.
__global__ void __launch_bounds__(kCombineThreads)
    mla_decode_combine_kernel(const float* __restrict__ part, const float* __restrict__ lse,
                              const long long* __restrict__ length, int s_max, int n_split,
                              float* __restrict__ out) {
  const int n = valid_positions(length, s_max);
  const int per = tiles_per_split(n, n_split);
  const int active = per > 0 ? ((n + kBN - 1) / kBN + per - 1) / per : 0;
  const float* row_lse = lse + static_cast<size_t>(blockIdx.x) * n_split;
  float top = -INFINITY;
  for (int s = 0; s < active; ++s) top = fmaxf(top, row_lse[s]);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float total = 0.0f;
  for (int s = 0; s < active; ++s) {
    const float w = exp2f(row_lse[s] - top);
    const float4 v = reinterpret_cast<const float4*>(part + (static_cast<size_t>(blockIdx.x) * n_split + s) * kLatent)[threadIdx.x];
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
    total += w;
  }
  const float inv = total > 0.0f ? 1.0f / total : 0.0f;
  reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.x) * kLatent)[threadIdx.x] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// -- host side -----------------------------------------------------------------

// A bf16 [batch, rows, dim] tensor with element strides st = (batch, row)
// and a unit dim stride; boxes of 64 x 64 x 1, 128-byte swizzle, zeros past
// the edges.
int encode(CUtensorMap* map, const void* ptr, int batch, int rows, int dim, const long long* st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st[1]) * 2, static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(rc);
}

bool aligned(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 && st[0] > 0 &&
         st[1] > 0;
}

}  // namespace

// out [batch, heads, 512] f32 = the absorbed MLA decode attention of bf16
// q_lat [batch, heads, 512] and q_rope [batch, heads, 64] over the first
// *length positions (clamped to [0, s_max]) of the bf16 latent [batch,
// s_max, 512] and k_rope [batch, s_max, 64], the logits times scale; part
// [batch, heads, n_split, 512] and lse [batch, heads, n_split] f32 are the
// splits' scratch.  Each bf16 tensor is given by its base and its element
// strides (batch, row), the dim stride 1; bases 16-byte aligned and strides
// multiples of 8 elements (TMA's rules; kernels/mla.py: tma_strides).
// Launches the split kernel and the combine on `stream`, returns a CUDA
// error code (0 on success) or one of the encoder's codes.
extern "C" int repro_mla_decode(const void* q_lat, const void* q_rope, const void* latent, const void* k_rope,
                                const long long* length, float* part, float* lse, float* out, int batch,
                                int heads, int s_max, int n_split, const long long* q_st,
                                const long long* qr_st, const long long* c_st, const long long* cr_st,
                                float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || s_max <= 0 || n_split <= 0 || !(scale > 0.0f) || length == nullptr ||
      !aligned(q_lat, q_st) || !aligned(q_rope, qr_st) || !aligned(latent, c_st) || !aligned(k_rope, cr_st)) {
    return cudaErrorInvalidValue;
  }
  const long long ctas = static_cast<long long>(batch) * n_split * ((heads + kHeads - 1) / kHeads);
  if (ctas > INT_MAX || static_cast<long long>(batch) * heads > INT_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_qr, map_c, map_cr;
  int rc = encode(&map_q, q_lat, batch, heads, kLatent, q_st);
  if (rc == 0) rc = encode(&map_qr, q_rope, batch, heads, kRope, qr_st);
  if (rc == 0) rc = encode(&map_c, latent, batch, s_max, kLatent, c_st);
  if (rc == 0) rc = encode(&map_cr, k_rope, batch, s_max, kRope, cr_st);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  mla_decode_kernel<<<static_cast<unsigned>(ctas), kThreads, kSmem, s>>>(
      map_q, map_qr, map_c, map_cr, length, s_max, heads, n_split, scale_log2, part, lse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_decode_combine_kernel<<<static_cast<unsigned>(batch * heads), kCombineThreads, 0, s>>>(
      part, lse, length, s_max, n_split, out);
  return cudaGetLastError();
}
