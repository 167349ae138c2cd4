// Mamba's selective scan over a whole sequence on Hopper (sm_90a): one fused
// kernel a layer call, with a plain C interface for ctypes.
//
//   delta[b, s, d] = softplus(dt[b, s, d])
//   h[b, d, n]     = exp(delta A[d, n]) h[b, d, n] + delta u[b, s, d] B[b, s, n]
//   y[b, s, d]     = sum_n h[b, d, n] C[b, s, n] + D[d] u[b, s, d]
//
// for s = 0 .. S - 1 in order, A = -exp(A_log), h starting from h0 (or
// zeros), for u, dt [B, S, d_in], B, C [B, S, n] (bf16 or f32, one type),
// A_log [d_in, n], D [d_in] and h0 [B, d_in, n] f32, all contiguous;
// y [B, S, d_in] in the inputs' type (rounded once from f32), the final h
// [B, d_in, n] f32.  Everything between the loads and y's rounding is f32:
// softplus (threshold 20, as torch's), the state, exp(delta A), delta u B
// and the C contraction.  n is 8 or 16.
//
// It replaces no TPU kernel.  The reference's scan, repro/models/ssm.py:
// _scan_chunk, is jax.lax.associative_scan and reaches no pl.pallas_call;
// the port's plain version (kernels/scan.py: selective_scan_plain) runs it
// chunk by chunk as a log-step scan whose seven rounds at chunk 128 each
// multiply and concatenate [B, 128, d_in, n] f32 tensors (537 MB at
// jamba's layer, B 8, d_in 8192, n 16): about 30 GB of traffic a chunk.
//
// What bounds it on this card.  The work is one f32 recurrence step per
// (b, d, n) and position, each with one exp: at jamba's layer (B 8, S 1024,
// d_in 8192, n 16) 1.07 G exps, plus softplus's exp and log per (b, s, d).
// The multi-function unit does 16 a clock per SM: 0.28 ms at 132 SMs and
// ~1.8 GHz.  The bytes (u, dt, y in bf16, B, C, the states) are 0.41 GB,
// 0.12 ms at 3.35 TB/s.  So it is bound by the exps, and a design that
// never writes a [B, S, d_in, n] tensor has no other cost that comes near.
// The design:
//
//   * one thread per (batch row, channel), its n states and n values of
//     A log2(e) in registers; a CTA holds 128 adjacent channels of one
//     batch row, so each position's u, dt and y are one coalesced row
//     segment for a warp;
//   * the recurrence is serial only through one FMA per state and
//     position: the n exps of a position depend on dt alone, so each
//     thread has n independent exps in flight per position and the
//     multi-function unit stays fed at ~16 warps an SM;
//   * u and dt are loaded kGroup positions ahead into registers, so their
//     loads overlap the exps of the positions before them;
//   * B and C of kTile positions are staged as f32 in shared memory (the
//     whole CTA reads each as a broadcast), the next tile's values held in
//     registers while the current one is consumed.
//
// No split of S: at B 8 and d_in 8192 the 65,536 threads are 512 CTAs,
// under four an SM, all resident at once: bf16 fits the 128 registers a
// thread that four CTAs of 128 leave; f32 at n 16 needs more, and takes
// three CTAs an SM rather than spill (no served model runs it: jamba
// serves bf16, the f32 smoke configurations n 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // channels of one batch row per CTA
constexpr int kTile = 32;      // positions whose B and C one shared-memory tile holds
constexpr int kGroup = 8;      // positions whose u and dt are loaded ahead
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSoftplusThreshold = 20.0f;  // torch.nn.functional.softplus's default
static_assert(kTile % kGroup == 0, "a tile holds whole groups");

// CTAs an SM the register allocation must allow (the note above)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 4 : 3;

// the wrapper's dtype codes (kernels/scan.py)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 2^x on the multi-function unit (2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// u and dt of positions s0 .. s0 + kGroup - 1 of this thread's channel
// (0 past the end)
template <typename T>
__device__ __forceinline__ void fetch_group(const T* __restrict__ u, const T* __restrict__ dt, int s0,
                                            int s_len, int64_t d_in, float (&uo)[kGroup],
                                            float (&dto)[kGroup]) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int s = s0 + k;
    uo[k] = s < s_len ? to_f32(u[s * d_in]) : 0.0f;
    dto[k] = s < s_len ? to_f32(dt[s * d_in]) : 0.0f;
  }
}

// this thread's share of the B and C rows of positions s0 .. s0 + kTile - 1,
// in the shared tile's order [position][B's n, then C's n]
template <typename T, int N, int kPer>
__device__ __forceinline__ void fetch_tile(const T* __restrict__ bm, const T* __restrict__ cm, int s0,
                                           int s_len, float (&out)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int t = i / (2 * N), j = i % (2 * N);
    const int s = s0 + t;
    const int64_t at = static_cast<int64_t>(s) * N + (j < N ? j : j - N);
    out[k] = s < s_len ? to_f32(j < N ? bm[at] : cm[at]) : 0.0f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                          const float* __restrict__ a_log, const float* __restrict__ d_skip,
                          const T* __restrict__ bmat, const T* __restrict__ cmat,
                          const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
                          int s_len, int d_in) {
  constexpr int kRow = 2 * N;                    // B then C of one position
  constexpr int kPer = kTile * kRow / kThreads;  // tile values each thread stages
  static_assert(kTile * kRow % kThreads == 0, "the tile splits evenly over the CTA");
  __shared__ __align__(16) float tile[kTile * kRow];

  const int64_t batch = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < d_in;
  const int c = live ? ch : d_in - 1;  // past the last channel: load a real one, store nothing

  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = -expf(a_log[static_cast<int64_t>(c) * N + n]) * kLog2e;
    h[n] = h0 != nullptr ? h0[(batch * d_in + c) * N + n] : 0.0f;
  }
  const float skip = d_skip[c];
  const int64_t row0 = batch * s_len;  // this batch row's first position
  const int64_t stride = d_in;
  const T* up = u + row0 * stride + c;
  const T* dtp = dt + row0 * stride + c;
  T* yp = y + row0 * stride + c;
  const T* bp = bmat + row0 * N;
  const T* cp = cmat + row0 * N;

  float staged[kPer];
  float uu[kGroup], dd[kGroup];
  fetch_tile<T, N, kPer>(bp, cp, 0, s_len, staged);
  fetch_group(up, dtp, 0, s_len, stride, uu, dd);
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    __syncthreads();  // the last tile is consumed
#pragma unroll
    for (int k = 0; k < kPer; ++k) tile[threadIdx.x + k * kThreads] = staged[k];
    __syncthreads();
    fetch_tile<T, N, kPer>(bp, cp, s0 + kTile, s_len, staged);
    for (int g = 0; g < kTile; g += kGroup) {
      const int base = s0 + g;
      if (base >= s_len) break;
      float un[kGroup], dn[kGroup];
      fetch_group(up, dtp, base + kGroup, s_len, stride, un, dn);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (base + k < s_len) {
          const float x = dd[k];
          const float delta = x > kSoftplusThreshold ? x : log1pf(__expf(x));
          const float du = delta * uu[k];
          const float4* bc = reinterpret_cast<const float4*>(tile + (g + k) * kRow);
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < N / 4; ++q) {
            const float4 bq = bc[q], cq = bc[N / 4 + q];
            const float bv[4] = {bq.x, bq.y, bq.z, bq.w}, cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int n = 4 * q + r;
              h[n] = fmaf(exp2_approx(delta * a2[n]), h[n], du * bv[r]);
              acc = fmaf(h[n], cv[r], acc);
            }
          }
          if (live) store(yp + (base + k) * stride, fmaf(skip, uu[k], acc));
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        uu[k] = un[k];
        dd[k] = dn[k];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[(batch * d_in + ch) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const void* a_log, const void* d_skip, const void* bmat,
           const void* cmat, const void* h0, void* y, void* h_out, int batch, int s_len, int d_in,
           cudaStream_t stream) {
  const dim3 grid((d_in + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const float*>(a_log),
      static_cast<const float*>(d_skip), static_cast<const T*>(bmat), static_cast<const T*>(cmat),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_out), s_len, d_in);
  return cudaGetLastError();
}

template <typename T>
int by_state(int d_state, const void* u, const void* dt, const void* a_log, const void* d_skip,
             const void* bmat, const void* cmat, const void* h0, void* y, void* h_out, int batch,
             int s_len, int d_in, cudaStream_t stream) {
  if (d_state == 16) {
    return launch<T, 16>(u, dt, a_log, d_skip, bmat, cmat, h0, y, h_out, batch, s_len, d_in, stream);
  }
  if (d_state == 8) {
    return launch<T, 8>(u, dt, a_log, d_skip, bmat, cmat, h0, y, h_out, batch, s_len, d_in, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// y, h_out = the selective scan above of u, dt [batch, s_len, d_in], b, c
// [batch, s_len, d_state] (dtype kF32 or kBF16), a_log [d_in, d_state], d
// [d_in] and h0 [batch, d_in, d_state] f32 (null: zeros); y in the inputs'
// dtype, h_out f32.  Every tensor contiguous, none overlapping y or h_out;
// d_state 8 or 16.  Launches on `stream`, returns a CUDA error code (0 on
// success).
extern "C" int repro_selective_scan(const void* u, const void* dt, const void* a_log, const void* d,
                                    const void* b, const void* c, const void* h0, void* y, void* h_out,
                                    int batch, int s_len, int d_in, int d_state, int dtype,
                                    void* stream) {
  if (batch <= 0 || batch > 65535 || s_len < 0 || d_in <= 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return by_state<float>(d_state, u, dt, a_log, d, b, c, h0, y, h_out, batch, s_len, d_in, s);
    case kBF16:
      return by_state<__nv_bfloat16>(d_state, u, dt, a_log, d, b, c, h0, y, h_out, batch, s_len,
                                     d_in, s);
  }
  return cudaErrorInvalidValue;
}
