// Causal (optionally windowed) GQA attention for the LM prefill on Hopper
// (sm_90a): one fused forward kernel, warp-specialised wgmma + TMA, with a
// plain C interface for ctypes.
//
//   out[b, h, i, :] = sum_j softmax_j(scale q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
//
// over j <= i (and j > i - window when a window is set), for q [B, H, S, D],
// k [B, H / g, S, D] and v [B, H / g, S, Dv], bf16, (D, Dv) (64, 64),
// (128, 128) or (192, 128), the scale given (1 / sqrt(D) for GQA; MLA under
// YaRN multiplies it by mscale^2); the logits, the softmax and the sums in
// f32, the weights cast to bf16 for the value product, the result bf16.
// Each KV head serves its g consecutive query heads, as
// repro/models/attention.py's jnp.repeat does, read in place: no copy.
// (192, 128) is MLA's expanded prefill at DeepSeek-V2's sizes: q and k carry
// the 128 nope dims and the 64 rope dims, v the 128 value dims.
//
// It replaces no TPU kernel.  The reference's prefill attention,
// repro/models/attention.py:blockwise_attention, is plain jnp and reaches no
// pl.pallas_call; the port's plain version (kernels/attention.py:
// blockwise_attention) runs every (q-chunk, kv-chunk) pair as an einsum and
// about eight elementwise passes over a [B, H, 512, 512] f32 block, and
// took 54 % of a served codeqwen1.5-7b wave at S 4096.
//
// What bounds it on this card.  A causal layer at B 8, H 32, S 4096, D 128
// is 4 B H S^2 D / 2 = 1.10 TFLOP, 1.11 ms at the bf16 tensor-core peak of
// 989 TFLOP/s, against 603 MB of q, k, v and out, 0.18 ms at 3.35 TB/s: it
// is bound by operations, once the [S, S] logits stay on chip.  Beside the
// two products, every logit takes an exp on the multi-function unit (16 a
// clock per SM, against 4,096 tensor-core operations a clock: a 128 x 128
// tile's exps take half its products' time).  The design, after
// FlashAttention-3:
//
//   * grid: one CTA per (128-row q tile, query head, batch row), the CTAs
//     of one KV head adjacent in the launch (its K and V, 2 MB at S 4096,
//     stay in L2 while they run; a layer's 67 MB would not), the longest q
//     tiles of a head first, so short ones fill the tail;
//   * loads: one producer warp issues TMA loads (4-D tensor maps over the
//     tensors' own strides, 128-byte swizzle, zeros past S) of the q tile
//     once and of K and V tiles of 128 keys into a two-stage ring, K and V
//     each behind its own full and empty mbarrier, so the logits of a tile
//     start while its V is still on its way;
//   * math: two consumer warpgroups, 64 q rows each, run S = Q K^T as
//     m64n128k16 wgmma from shared memory (f32), the online softmax in f32
//     registers (row max and sum over the 4 lanes that share a row, exp2 of
//     the logit scaled by log2(e) x scale), and O += P V with P cast to
//     bf16 in registers as wgmma's A operand (the accumulator's layout is
//     the A fragment's, so P never goes through shared memory);
//   * masking: KV tiles wholly above the diagonal or wholly outside the
//     window are not visited; only tiles that cross the diagonal or the
//     window's edge are masked, element by element;
//   * epilogue: divide by the row sum, round to bf16, stage the tile over
//     the spent q tile (16-byte chunks XOR-swizzled by row) and write whole
//     rows with 16-byte stores through the output's strides, rows past S
//     dropped: any S, no divisor chunking.
//
// Shared memory at (192, 128): the 128 x 192 q tile (48 KB), two stages of a
// 128 x 192 K tile and a 128 x 128 V tile (160 KB) and 2 KB of alignment and
// mbarriers, 210 KB of the 227 KB a CTA may take; the registers are those of
// (128, 128), since S and O are 128 wide in both.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "epilogue.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                   // q rows of a CTA: two consumer warpgroups of 64
constexpr int kBN = 128;                   // keys of a K / V tile
constexpr int kStages = 2;                 // K / V ring depth
constexpr int kConsumers = 2;
constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp
constexpr int kHeader = 1024;              // the mbarriers, before the 1024-aligned tiles

template <int kD, int kDv>
struct Smem {
  static constexpr int kQBytes = kBM * kD * 2;   // kD / 64 boxes of kBM rows x 128 bytes
  static constexpr int kKBytes = kBN * kD * 2;   // one K tile: kD / 64 boxes of kBN rows
  static constexpr int kVBytes = kBN * kDv * 2;  // one V tile: kDv / 64 boxes of kBN rows
  static constexpr int kBytes = 1024 + kHeader + kQBytes + kStages * (kKBytes + kVBytes);
  static_assert((kD == 64 && kDv == 64) || (kD == 128 && kDv == 128) || (kD == 192 && kDv == 128),
                "head dims (64, 64), (128, 128) and (192, 128)");
  static_assert(kBytes <= 227 * 1024, "a CTA takes at most 227 KB of shared memory");
};

// -- PTX wrappers (the rest in hopper.cuh) ------------------------------------

// 4-D TMA load of the box at (c0 inner, c1, c2, c3) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The operands' shared-memory descriptors (hopper.cuh: smem_desc):
//   q, k (K-major: head dim contiguous): rows of 128 bytes, 8-row groups
//     1024 bytes apart (stride); the leading offset is unused within one
//     128-byte swizzle row, and a 16-deep step starts 32 bytes further;
//   v (N-major: the product's N is the head dim): key rows of 128 bytes
//     (64 columns), 8-row groups 1024 bytes apart (stride), 64-column boxes
//     kBN * 128 bytes apart (leading).
//
// wgmma.mma_async m64nNk16, f32 += bf16 x bf16.  MmaSS: A and B from shared
// memory, both K-major (S = Q K^T); scale-d off on the first step.  MmaRS: A
// from registers, B N-major through the transpose bit (O += P V).
template <int kN>
struct MmaSS;
template <int kN>
struct MmaRS;

template <>
struct MmaSS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaRS<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// One CTA: q tile qt of head h, batch row b.  Threads 0-255 are the two
// consumer warpgroups, 256-287 the producer warp.
template <int kD, int kDv>
__global__ void __launch_bounds__(kThreads, 1)
    prefill_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             __nv_bfloat16* __restrict__ out, long long o_sb, long long o_sh,
                             long long o_ss, int s_len, int heads, int kv_heads, int window,
                             float scale_log2) {
  using L = Smem<kD, kDv>;
  constexpr int kBoxes = kD / 64, kVBoxes = kDv / 64;
  extern __shared__ uint8_t smem_raw[];
  // the tiles must start on 1024-byte boundaries (the swizzle's period)
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;
  uint8_t* q_tile = base + kHeader;
  uint8_t* k_ring = q_tile + L::kQBytes;
  uint8_t* v_ring = k_ring + kStages * L::kKBytes;

  // the tile: CTAs of one (batch row, KV head) adjacent, longest q tiles first
  const int nq = (s_len + kBM - 1) / kBM;
  const int group = heads / kv_heads;
  const int per_kv = nq * group;
  const int kv = blockIdx.x / per_kv, rem = blockIdx.x % per_kv;
  const int b = kv / kv_heads, hkv = kv % kv_heads;
  const int h = hkv * group + rem % group;
  const int q0 = (nq - 1 - rem / group) * kBM;
  // the KV tiles it visits, highest first: the diagonal's, down to the
  // window's lower edge (or key 0)
  const int q_last = min(q0 + kBM, s_len) - 1;
  const int hi = q_last / kBN;
  const int lo = window > 0 ? max(0, q0 - window + 1) / kBN : 0;
  const int n_tiles = hi - lo + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], kConsumers * 4);  // lane 0 of each consumer warp
      mbar_init(&v_empty[i], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_q)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_k)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_v)) : "memory");
      mbar_expect_tx(q_full, L::kQBytes);  // whole boxes, zeros past S included
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) tma_load(q_tile + x * kBM * 128, &map_q, x * 64, q0, h, b, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int slot = it % kStages, k0 = (hi - it) * kBN;
        const int parity = ((it / kStages) & 1) ^ 1;
        if (it >= kStages) mbar_wait(&k_empty[slot], parity);
        mbar_expect_tx(&k_full[slot], L::kKBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(k_ring + slot * L::kKBytes + x * kBN * 128, &map_k, x * 64, k0, hkv, b, &k_full[slot]);
        }
        if (it >= kStages) mbar_wait(&v_empty[slot], parity);
        mbar_expect_tx(&v_full[slot], L::kVBytes);
#pragma unroll
        for (int x = 0; x < kVBoxes; ++x) {
          tma_load(v_ring + slot * L::kVBytes + x * kBN * 128, &map_v, x * 64, k0, hkv, b, &v_full[slot]);
        }
      }
    }
    __syncwarp();
    return;
  }

  // consumers: warpgroup g takes q rows 64 g ... 64 g + 63 of the tile; this
  // thread holds rows r[0] and r[1] = r[0] + 8 (global positions) and, in
  // each 8-column group j of a product, columns 8 j + 2 (lane % 4) and + 1:
  // element 4 j + 2 hh + c is (row r[hh], column 8 j + 2 (lane % 4) + c)
  const int g = warp / 4;
  int r[2];
  r[0] = q0 + 64 * g + 16 * (warp % 4) + lane / 4;
  r[1] = r[0] + 8;
  float o[kDv / 2], s[kBN / 2];
  uint32_t p[kBN / 4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kDv / 2; ++i) o[i] = 0.0f;
  const uint32_t q_addr = smem_addr(q_tile) + g * 64 * 128;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it % kStages, parity = (it / kStages) & 1;
    const int k0 = (hi - it) * kBN;
    // S = Q K^T
    mbar_wait(&k_full[slot], parity);
    const uint32_t k_addr = smem_addr(k_ring + slot * L::kKBytes);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      // box kk / 4 (64 columns of the head dim), 32 bytes a step within it
      const uint32_t step = (kk % 4) * 32;
      MmaSS<kBN>::run(s, smem_desc(q_addr + (kk / 4) * kBM * 128 + step, 16, 1024),
                      smem_desc(k_addr + (kk / 4) * kBN * 128 + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
    fence_regs(s);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&k_empty[slot]);

    // mask the tiles that cross the diagonal or the window's lower edge
    if (k0 + kBN - 1 > q0 || (window > 0 && k0 <= q_last - window)) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + 8 * j + 2 * (lane % 4) + (i % 2), row = r[i / 2];
          if (col > row || (window > 0 && col <= row - window)) s[4 * j + i] = -INFINITY;
        }
      }
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
#pragma unroll
    for (int i = 0; i < kDv / 2; ++i) o[i] *= alpha[(i % 4) / 2];
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V, P as the A operand: 16 keys a step, 4 registers of P each
    mbar_wait(&v_full[slot], parity);
    const uint32_t v_addr = smem_addr(v_ring + slot * L::kVBytes);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      MmaRS<kDv>::run(o, &p[4 * kk], smem_desc(v_addr + kk * 16 * 128, kBN * 128, 1024));
    }
    wgmma_commit();
    fence_regs(o);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&v_empty[slot]);
  }

  // epilogue: the row sums over the 4 lanes of a row, then out = O / l
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffff, sum, 1);
    sum += __shfl_xor_sync(0xffffffff, sum, 2);
    inv[hh] = sum > 0.0f ? 1.0f / sum : 0.0f;
  }
  // both warpgroups are done with the q tile before it holds the result:
  // row R's 16-byte chunk c at chunk c ^ (R % 8) of its row
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  uint8_t* stage = q_tile;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r[hh] - q0;
#pragma unroll
    for (int j = 0; j < kDv / 8; ++j) {
      const uint32_t v = pack_bf16(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
      *reinterpret_cast<uint32_t*>(stage + row * kDv * 2 + ((j ^ (row % 8)) * 16) + (lane % 4) * 4) = v;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  constexpr int kChunks = kDv / 8;
  __nv_bfloat16* dst = out + b * o_sb + h * o_sh;
  for (int e = threadIdx.x; e < kBM * kChunks; e += kConsumers * 128) {
    const int row = e / kChunks, c = e % kChunks;
    if (q0 + row < s_len) {
      *reinterpret_cast<uint4*>(dst + (q0 + row) * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(stage + row * kDv * 2 + ((c ^ (row % 8)) * 16));
    }
  }
}

// -- host side -----------------------------------------------------------------

// A bf16 [batch, heads, seq, dim] tensor with element strides st = (batch,
// heads, seq) and a unit dim stride; boxes of 64 x rows x 1 x 1, 128-byte
// swizzle, zeros past the edges.
int encode(CUtensorMap* map, const void* ptr, int batch, int heads, int seq, int dim,
           const long long* st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2, static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(rc);
}

template <int kD, int kDv>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int heads,
           int kv_heads, int s_len, const long long* q_st, const long long* k_st,
           const long long* v_st, const long long* o_st, int window, float scale_log2,
           cudaStream_t stream) {
  const long long ctas = static_cast<long long>(batch) * heads * ((s_len + kBM - 1) / kBM);
  if (ctas > INT_MAX) return cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_k, map_v;
  int rc = encode(&map_q, q, batch, heads, s_len, kD, q_st, kBM);
  if (rc != 0) return rc;
  rc = encode(&map_k, k, batch, kv_heads, s_len, kD, k_st, kBN);
  if (rc != 0) return rc;
  rc = encode(&map_v, v, batch, kv_heads, s_len, kDv, v_st, kBN);
  if (rc != 0) return rc;
  auto kernel = prefill_attention_kernel<kD, kDv>;
  constexpr int kBytes = Smem<kD, kDv>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(ctas), kThreads, kBytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), o_st[0], o_st[1], o_st[2], s_len, heads,
      kv_heads, window, scale_log2);
  return cudaGetLastError();
}

bool aligned(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 &&
         st[2] % 8 == 0 && st[0] > 0 && st[1] > 0 && st[2] > 0;
}

}  // namespace

// out = causal (window > 0: sliding-window) GQA attention of bf16 q [batch,
// heads, s_len, dim] over k [batch, kv_heads, s_len, dim] and v [batch,
// kv_heads, s_len, v_dim], (dim, v_dim) (64, 64), (128, 128) or (192, 128),
// heads a multiple of kv_heads, the logits times scale; out [batch, heads,
// s_len, v_dim].  Each tensor is given by
// its base and its element strides (batch, head, position), the dim stride
// 1; bases 16-byte aligned and strides multiples of 8 elements (TMA's rules;
// kernels/attention.py: tma_strides).  Launches on `stream`, returns a CUDA
// error code (0 on success) or one of the encoder's codes above.
extern "C" int repro_prefill_attention(const void* q, const void* k, const void* v, void* out,
                                       int batch, int heads, int kv_heads, int s_len, int dim,
                                       int v_dim, const long long* q_st, const long long* k_st,
                                       const long long* v_st, const long long* o_st, int window,
                                       float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_len <= 0 ||
      window < 0 || !(scale > 0.0f) || !aligned(q, q_st) || !aligned(k, k_st) ||
      !aligned(v, v_st) || !aligned(out, o_st)) {
    return cudaErrorInvalidValue;
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
  const auto s = static_cast<cudaStream_t>(stream);
  if (dim == 64 && v_dim == 64) {
    return launch<64, 64>(q, k, v, out, batch, heads, kv_heads, s_len, q_st, k_st, v_st, o_st, window,
                          scale_log2, s);
  }
  if (dim == 128 && v_dim == 128) {
    return launch<128, 128>(q, k, v, out, batch, heads, kv_heads, s_len, q_st, k_st, v_st, o_st, window,
                            scale_log2, s);
  }
  if (dim == 192 && v_dim == 128) {
    return launch<192, 128>(q, k, v, out, batch, heads, kv_heads, s_len, q_st, k_st, v_st, o_st, window,
                            scale_log2, s);
  }
  return cudaErrorInvalidValue;
}
