// What the Hopper (sm_90a) designs share, gemm_wgmma.cu's scheduled GEMM,
// attention_wgmma.cu's prefill attention and mla_decode.cu's MLA decode: the
// PTX wrappers of mbarriers and wgmma, the shared-memory matrix descriptor,
// the online softmax's exp2 and bf16 packing, and on the host the lookup of
// cuTensorMapEncodeTiled and the error codes beyond CUDA's own.  Each source
// keeps its own TMA loads (2-D, 3-D, 4-D) and wgmma shapes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

#if CUDART_VERSION < 12050
#error "the wgmma + TMA designs need CUDA 12.5 or newer (cudaGetDriverEntryPointByVersion)"
#endif

namespace {

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that never
// ends (a fault in the pipeline) traps after about 2^26 polls, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// -- wgmma ---------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accesses of registers that a wgmma reads or
// writes asynchronously (accumulators, A fragments) across its issue and
// wait points.
template <int kCount>
__device__ __forceinline__ void fence_regs(float (&d)[kCount]) {
#pragma unroll
  for (int i = 0; i < kCount; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kCount>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[kCount]) {
#pragma unroll
  for (int i = 0; i < kCount; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32) |
         (1ull << 62);
}

// -- the online softmax's arithmetic ----------------------------------------------

// 2^x on the multi-function unit (the softmax's exps, in units of log2).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to a bf16 pair, lo in the lower 16 bits: a wgmma A
// fragment's register, or two adjacent bf16 elements in shared memory.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&pair);
}

// -- host side -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Codes beyond CUDA's own: the CUDA driver refused a descriptor (kEncodeError +
// its CUresult), or has no cuTensorMapEncodeTiled.
constexpr int kEncodeError = 100000;
constexpr int kNoEncoder = 200000;

}  // namespace
