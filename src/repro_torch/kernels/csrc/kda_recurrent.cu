// KDA's gated delta-rule recurrence on Hopper (sm_90a): one kernel a layer
// call, prefill and decode step alike, with a plain C interface for ctypes.
//
//   S[b, h]  <- Diag(exp g[b, t, h]) S[b, h]
//   u        =  v[b, t, h] - S[b, h]^T k[b, t, h]
//   S[b, h]  <- S[b, h] + beta[b, t, h] k[b, t, h] u^T
//   o[b, t, h] = S[b, h]^T q[b, t, h]
//
// for t = 0 .. T - 1 in order, S a [K, V] = [128, 128] f32 state per batch
// row and head starting from h0 (or zeros), for q, k [B, T, H, 128] and v
// [B, T, H, 128] bf16, g [B, T, H, 128] f32 (the log-decay of each key
// channel), beta [B, T, H] f32 and h0 [B, H, 128, 128] f32, all
// contiguous; o [B, T, H, 128] bf16 (rounded once from f32) and the final
// S written into `state`, which may be h0 itself (each thread reads its
// own elements of the state before the walk and writes the same ones
// after it).  Everything between the loads and o's rounding is f32.
//
// It replaces no TPU kernel: the reference has no linear-attention block.
// The port's plain version (kernels/kda.py: kda_recurrent_plain) runs the
// recurrence one position at a time as whole-tensor PyTorch operations:
// about six launches a position, 300k a layer at T 49,152.
//
// What bounds it on this card.  Each position and head does, for each of
// the 128 x 128 state elements, a decay, a product into S^T k, a rank-one
// update and a product into S^T q: four f32 FMA-unit instructions (7
// operations counted), with no tensor-core form in the recurrent order.
// At B 4, H 32, T 32,768 that is 2.7e14 instructions: 8.2 ms at 132 SMs
// x 128 lanes x 1.98 GHz.  The bytes (q, k, v, o in bf16, g and beta in
// f32, the state read and written once) are 6.4 GB, 1.9 ms at 3.35 TB/s.
// So it is bound by the FMA units, and a design that never leaves the
// state or writes a [T, K, V] tensor has no other cost near that; what
// stands in the way is feeding them: a thread's rows of q, k and exp g
// come from shared memory, at 32 lane-floats a clock an SM, so each
// float loaded has to serve several value columns.  The design:
//
//   * one CTA of 128 threads per (slice of 32 value columns, head, batch
//     row): the value columns of S evolve independently given k, g and
//     beta, so four CTAs share a head and none talks to another;
//   * a thread holds four adjacent value columns x 8 key rows of S in
//     registers (32 floats), so each row of q, k and exp g it loads
//     serves four columns: 3 floats a row and position against 16 FMAs;
//   * the sixteen threads that share a column quad are a half-warp; S^T k
//     and S^T q reduce over the 128 rows by a transposing butterfly (five
//     shuffles leave each lane one column's sum, and four more hand every
//     lane the four beta u it updates with);
//   * a thread's rows are 2 x 4 rows 64 apart (64 j + 4 r + e), so the
//     sixteen lanes of a half-warp read one 256-byte row segment per
//     16-byte load, with no bank conflict;
//   * q, k, exp g, beta and the value slice of kChunk positions are staged
//     as f32 in shared memory, the next chunk held in registers while the
//     current one is walked; the outputs of a chunk are staged and written
//     as whole 64-byte row segments.
//
// At B 4 and H 32 the grid is 512 CTAs, under four an SM: one wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDim = 128;                  // K = V
constexpr int kSlice = 32;                 // value columns of a CTA
constexpr int kThreads = 128;
constexpr int kChunk = 16;                 // positions staged at once
constexpr int kMinBlocks = 4;              // CTAs an SM the registers must allow
constexpr int kRowVecs = kDim / 8;         // 16-byte vectors of bf16 in a row of q or k
constexpr int kRowF4 = kDim / 4;           // float4s in a row of g
constexpr int kSliceVecs = kSlice / 8;     // 16-byte vectors of bf16 in a value slice
constexpr int kQkPer = kChunk * kRowVecs / kThreads;  // q (and k) vectors a thread stages
constexpr int kGPer = kChunk * kRowF4 / kThreads;     // g float4s a thread stages
static_assert(kQkPer * kThreads == kChunk * kRowVecs && kGPer * kThreads == kChunk * kRowF4, "even staging");
static_assert(kChunk * kSliceVecs <= kThreads, "one value vector a thread at most");

struct Staged {
  uint4 q[kQkPer], k[kQkPer];
  float4 g[kGPer];
  uint4 v;
  float beta;
};

struct Tiles {
  float q[kChunk][kDim];
  float k[kChunk][kDim];
  float e[kChunk][kDim];  // exp g
  float v[kChunk][kSlice];
  float o[kChunk][kSlice];
  float beta[kChunk];
};

__device__ __forceinline__ void unpack(uint4 raw, float (&out)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// this thread's share of positions c0 .. c0 + kChunk - 1 (zeros past the end)
__device__ __forceinline__ void fetch(Staged& st, const __nv_bfloat16* __restrict__ q,
                                      const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                                      const float* __restrict__ g, const float* __restrict__ beta, int64_t b,
                                      int h, int slice, int heads, int t_len, int c0) {
#pragma unroll
  for (int i = 0; i < kQkPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = c0 + idx / kRowVecs;
    const int64_t row = (b * t_len + t) * heads + h;
    const bool in = t < t_len;
    st.q[i] = in ? *reinterpret_cast<const uint4*>(q + row * kDim + (idx % kRowVecs) * 8) : make_uint4(0, 0, 0, 0);
    st.k[i] = in ? *reinterpret_cast<const uint4*>(k + row * kDim + (idx % kRowVecs) * 8) : make_uint4(0, 0, 0, 0);
  }
  const int bt = c0 + threadIdx.x;
  st.beta = threadIdx.x < kChunk && bt < t_len ? beta[(b * t_len + bt) * heads + h] : 0.0f;
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = c0 + idx / kRowF4;
    const int64_t row = (b * t_len + t) * heads + h;
    st.g[i] = t < t_len ? *reinterpret_cast<const float4*>(g + row * kDim + (idx % kRowF4) * 4)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int vt = c0 + threadIdx.x / kSliceVecs;
  if (threadIdx.x < kChunk * kSliceVecs && vt < t_len) {
    const int64_t row = (b * t_len + vt) * heads + h;
    st.v = *reinterpret_cast<const uint4*>(v + row * kDim + slice * kSlice + (threadIdx.x % kSliceVecs) * 8);
  } else {
    st.v = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void stage(const Staged& st, Tiles& tl) {
#pragma unroll
  for (int i = 0; i < kQkPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / kRowVecs, col = (idx % kRowVecs) * 8;
    float qf[8], kf[8];
    unpack(st.q[i], qf);
    unpack(st.k[i], kf);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      tl.q[t][col + x] = qf[x];
      tl.k[t][col + x] = kf[x];
    }
  }
  if (threadIdx.x < kChunk) tl.beta[threadIdx.x] = st.beta;
#pragma unroll
  for (int i = 0; i < kGPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / kRowF4, col = (idx % kRowF4) * 4;
    tl.e[t][col] = expf(st.g[i].x);
    tl.e[t][col + 1] = expf(st.g[i].y);
    tl.e[t][col + 2] = expf(st.g[i].z);
    tl.e[t][col + 3] = expf(st.g[i].w);
  }
  if (threadIdx.x < kChunk * kSliceVecs) {
    float vf[8];
    unpack(st.v, vf);
    const int t = threadIdx.x / kSliceVecs, col = (threadIdx.x % kSliceVecs) * 8;
#pragma unroll
    for (int x = 0; x < 8; ++x) tl.v[t][col + x] = vf[x];
  }
}

// the staged outputs of positions c0 .. c0 + kChunk - 1, as bf16
__device__ __forceinline__ void write_out(const Tiles& tl, __nv_bfloat16* __restrict__ o, int64_t b, int h,
                                          int slice, int heads, int t_len, int c0) {
  if (threadIdx.x >= kChunk * kSliceVecs) return;
  const int t = threadIdx.x / kSliceVecs, col = (threadIdx.x % kSliceVecs) * 8;
  if (c0 + t >= t_len) return;
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(tl.o[t][col + 2 * i], tl.o[t][col + 2 * i + 1]);
  const int64_t row = (b * t_len + c0 + t) * heads + h;
  *reinterpret_cast<uint4*>(o + row * kDim + slice * kSlice + col) = raw;
}

// p[c] is this lane's partial sum of column c of its quad; returns the sum
// over the half-warp of column 2 (rg & 8 ? 1 : 0) + (rg & 4 ? 1 : 0): two
// columns swapped across lanes 8 apart, one across lanes 4 apart, then the
// last two stages as plain sums
__device__ __forceinline__ float reduce4(const float (&p)[4], int rg) {
  const bool hi = rg & 8, mid = rg & 4;
  float x0 = hi ? p[2] : p[0], x1 = hi ? p[3] : p[1];
  const float y0 = hi ? p[0] : p[2], y1 = hi ? p[1] : p[3];
  x0 += __shfl_xor_sync(0xffffffffu, y0, 8);
  x1 += __shfl_xor_sync(0xffffffffu, y1, 8);
  float z = mid ? x1 : x0;
  const float w = mid ? x0 : x1;
  z += __shfl_xor_sync(0xffffffffu, w, 4);
  z += __shfl_xor_sync(0xffffffffu, z, 2);
  z += __shfl_xor_sync(0xffffffffu, z, 1);
  return z;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    kda_recurrent_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ beta, const float* h0, __nv_bfloat16* __restrict__ o,
                         float* state, int t_len, int heads) {
  __shared__ __align__(16) Tiles tl;
  const int slice = blockIdx.x, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int rg = lane % 16;                                  // rows 64 j + 4 rg + e
  const int quad = 4 * (2 * (threadIdx.x / 32) + lane / 16);  // this thread's four value columns in the slice
  const int mine = 2 * ((rg >> 3) & 1) + ((rg >> 2) & 1);     // the column whose sums reduce4 leaves here
  float* const s_head = state + (b * heads + h) * kDim * kDim + slice * kSlice + quad;
  const float* const h_head = h0 != nullptr ? h0 + (b * heads + h) * kDim * kDim + slice * kSlice + quad : nullptr;

  float s[4][8];  // s[c][4 j + e]: column quad + c, row 64 j + 4 rg + e
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 64 * (i / 4) + 4 * rg + i % 4;
    const float4 x = h_head != nullptr ? *reinterpret_cast<const float4*>(h_head + r * kDim)
                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s[0][i] = x.x;
    s[1][i] = x.y;
    s[2][i] = x.z;
    s[3][i] = x.w;
  }

  Staged st;
  fetch(st, q, k, v, g, beta, b, h, slice, heads, t_len, 0);
  for (int c0 = 0; c0 < t_len; c0 += kChunk) {
    __syncthreads();  // the last chunk's walk is done with the tiles
    if (c0 > 0) write_out(tl, o, b, h, slice, heads, t_len, c0 - kChunk);
    stage(st, tl);
    __syncthreads();
    fetch(st, q, k, v, g, beta, b, h, slice, heads, t_len, c0 + kChunk);
    const int n = min(kChunk, t_len - c0);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      float ev[8], kv[8], part[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 e4 = *reinterpret_cast<const float4*>(&tl.e[t][64 * j + 4 * rg]);
        const float4 k4 = *reinterpret_cast<const float4*>(&tl.k[t][64 * j + 4 * rg]);
        ev[4 * j] = e4.x, ev[4 * j + 1] = e4.y, ev[4 * j + 2] = e4.z, ev[4 * j + 3] = e4.w;
        kv[4 * j] = k4.x, kv[4 * j + 1] = k4.y, kv[4 * j + 2] = k4.z, kv[4 * j + 3] = k4.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = 0.0f, z = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[c][i] *= ev[i];
          if (i % 2 == 0) {
            a = fmaf(s[c][i], kv[i], a);
          } else {
            z = fmaf(s[c][i], kv[i], z);
          }
        }
        part[c] = a + z;
      }
      // beta (v - S^T k) of this lane's column, then of each of the quad's
      const float bu = tl.beta[t] * (tl.v[t][quad + mine] - reduce4(part, rg));
      float bus[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bus[c] = __shfl_sync(0xffffffffu, bu, (lane & 16) | ((c >> 1) << 3) | ((c & 1) << 2));
      float qv[8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 q4 = *reinterpret_cast<const float4*>(&tl.q[t][64 * j + 4 * rg]);
        qv[4 * j] = q4.x, qv[4 * j + 1] = q4.y, qv[4 * j + 2] = q4.z, qv[4 * j + 3] = q4.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = 0.0f, z = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[c][i] = fmaf(kv[i], bus[c], s[c][i]);
          if (i % 2 == 0) {
            a = fmaf(s[c][i], qv[i], a);
          } else {
            z = fmaf(s[c][i], qv[i], z);
          }
        }
        part[c] = a + z;
      }
      const float out = reduce4(part, rg);
      if ((rg & 3) == 0) tl.o[t][quad + mine] = out;
    }
  }
  __syncthreads();
  if (t_len > 0) write_out(tl, o, b, h, slice, heads, t_len, (t_len - 1) / kChunk * kChunk);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 64 * (i / 4) + 4 * rg + i % 4;
    *reinterpret_cast<float4*>(s_head + r * kDim) = make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
  }
}

}  // namespace

// o, state = the recurrence above of q, k, v [batch, t_len, heads, 128]
// bf16, g [batch, t_len, heads, 128] and beta [batch, t_len, heads] f32
// from h0 [batch, heads, 128, 128] f32 (null: zeros); o bf16, state f32
// (may be h0).  Every tensor contiguous with a 16-byte aligned base, none
// but h0 and state overlapping; head_dim 128.  Launches on `stream`,
// returns a CUDA error code (0 on success).
extern "C" int repro_kda_recurrent(const void* q, const void* k, const void* v, const void* g, const void* beta,
                                   const void* h0, void* o, void* state, int batch, int t_len, int heads,
                                   int head_dim, void* stream) {
  if (head_dim != kDim || batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || t_len < 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(kDim / kSlice, heads, batch);
  kda_recurrent_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<const float*>(h0), static_cast<__nv_bfloat16*>(o), static_cast<float*>(state), t_len, heads);
  return cudaGetLastError();
}
