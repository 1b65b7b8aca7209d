// flash_decode: GQA one-token attention over a KV cache with an online
// softmax.
//
// Replaces repro/kernels/flash_decode.py::_flash_decode_kernel.  Semantics
// kept: q (B, H, dh) attends to k/v (B, S, KV, dh) with G = H / KV query
// heads per KV head; keys at index >= pos are masked to -1e30; scale dh^-1/2;
// f32 running max, sum and accumulator; output acc / max(l, 1e-30) in q's
// dtype.  One scalar pos for the whole batch, as in the reference.
//
// Bound on the H100: bytes.  Every valid key and value row is read once
// (at qwen3-14b, B = 4, pos ~ 2056: ~34 MB, ~10 us at 3.35 TB/s), against
// ~0.17 GFLOP.  Design: one block per (batch, KV head) that walks the first
// pos keys in tiles of TS; keys past pos are never loaded (their masked
// weight is exactly 0 in the reference, so skipping them changes nothing),
// and the ragged last tile is masked here, so S needs no block multiple.
// Lanes load 16-byte vectors: a group of LG lanes covers one key row (C
// chunks), NT / LG groups fetch different keys at once, and each lane holds
// KPT loads in flight before it computes.  Per tile: (1) q.k for all G rows
// of the group, reduced over the group's lanes with shuffles; (2) one warp
// per query row updates the running max and sum; (3) every group rescales
// its private accumulator by the row's correction and adds p.v for its keys.
// The groups' accumulators are summed in a fixed order at the end, so the
// result is deterministic.  G need not be a power of two (qwen3-14b: 5).
// With B * KV = 32 blocks at the main-path shape, only 32 SMs stream; a
// split over S across blocks is the next step for speed.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;  // query heads per KV head (<= kWarps)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;  // elements per 16-byte chunk
  __device__ static void unpack(const int4& raw, float* out) {
    out[0] = __int_as_float(raw.x);
    out[1] = __int_as_float(raw.y);
    out[2] = __int_as_float(raw.z);
    out[3] = __int_as_float(raw.w);
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const int4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
};

// C = 16-byte chunks per head row, so dh = C * E.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int n_heads,
                    int n_kv, int seq, int pos, float scale) {
  constexpr int E = Vec<T>::E;
  constexpr int DH = C * E;
  constexpr int LG = C < 32 ? C : 32;   // lanes per key row
  constexpr int CPT = C / LG;           // chunks per lane
  constexpr int NG = kThreads / LG;     // key groups per block
  constexpr int TS = NG * (8 / CPT) < 128 ? NG * (8 / CPT) : 128;  // keys per tile
  constexpr int KPT = TS / NG;          // keys per group per tile
  static_assert(KPT >= 1 && TS % 32 == 0 && TS <= 128, "tile shape");

  __shared__ float q_s[kMaxG][DH];
  __shared__ float p_s[kMaxG][TS];
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ float a_s[kMaxG];
  __shared__ float red_s[kWarps][DH];

  const int g_heads = n_heads / n_kv;
  const int b = blockIdx.x / n_kv;
  const int kh = blockIdx.x % n_kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = tid / LG;
  const int gl = tid % LG;

  const T* qb = q + (static_cast<long long>(b) * n_heads + kh * g_heads) * DH;
  for (int i = tid; i < g_heads * DH; i += kThreads) {
    q_s[i / DH][i % DH] = Vec<T>::to_float(qb[i]);
  }
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxG][CPT][E];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][c][e] = 0.0f;
  __syncthreads();

  const long long row = static_cast<long long>(n_kv) * DH;  // elements between keys
  const T* kb = k + static_cast<long long>(b) * seq * row + kh * DH;
  const T* vb = v + static_cast<long long>(b) * seq * row + kh * DH;
  const int4 zero = make_int4(0, 0, 0, 0);

  for (int t0 = 0; t0 < pos; t0 += TS) {
    // (1) scores s[g][j] = q_g . k_j * scale, masked past pos.
    int4 raw[KPT][CPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = t0 + grp + i * NG;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        raw[i][c] = j < pos
            ? *reinterpret_cast<const int4*>(kb + j * row + (gl + c * LG) * E)
            : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float x[E];
        Vec<T>::unpack(raw[i][c], x);
        const int d0 = (gl + c * LG) * E;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < g_heads) {
#pragma unroll
            for (int e = 0; e < E; ++e) part[g] += q_s[g][d0 + e] * x[e];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < g_heads) {  // g_heads is uniform: no lane diverges
#pragma unroll
          for (int off = LG / 2; off > 0; off >>= 1) {
            part[g] += __shfl_xor_sync(kFull, part[g], off);
          }
        }
      }
      const int jt = grp + i * NG;
      if (gl == 0) {
        const bool valid = t0 + jt < pos;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < g_heads) p_s[g][jt] = valid ? part[g] * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // (2) online softmax statistics: warp g owns query row g.
    if (warp < g_heads) {
      const int g = warp;
      float sv[TS / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < TS / 32; ++u) {
        sv[u] = p_s[g][lane + 32 * u];
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < TS / 32; ++u) {
        const float p = expf(sv[u] - m_new);
        p_s[g][lane + 32 * u] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(kFull, sum, off);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = acc * alpha + p . v over this group's keys.
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = t0 + grp + i * NG;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        raw[i][c] = j < pos
            ? *reinterpret_cast<const int4*>(vb + j * row + (gl + c * LG) * E)
            : zero;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < g_heads) {
        const float alpha = a_s[g];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][c][e] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int jt = grp + i * NG;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float x[E];
        Vec<T>::unpack(raw[i][c], x);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < g_heads) {
            const float p = p_s[g][jt];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][c][e] += p * x[e];
          }
        }
      }
    }
    __syncthreads();  // p_s is rewritten by the next tile
  }

  // Sum the groups' partial accumulators: within a warp by shuffles, then
  // across warps through shared memory, in a fixed order.
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= g_heads) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x = acc[g][c][e];
#pragma unroll
        for (int off = LG; off < 32; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
        if (lane < LG) red_s[warp][(lane + c * LG) * E + e] = x;
      }
    }
    __syncthreads();
    const float l = fmaxf(l_s[g], 1e-30f);
    T* ob = out + (static_cast<long long>(b) * n_heads + kh * g_heads + g) * DH;
    for (int d = tid; d < DH; d += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red_s[w][d];
      ob[d] = Vec<T>::from_float(s / l);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_for_dtype(const void* q, const void* k, const void* v, void* out,
                     int batch, int n_heads, int n_kv, int seq, int d_head,
                     int pos, float scale, cudaStream_t stream) {
  const int chunks = d_head / Vec<T>::E;
  const dim3 grid(batch * n_kv);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
#define REPRO_FD_CASE(CC)                                                      \
  case CC:                                                                     \
    flash_decode_kernel<T, CC><<<grid, kThreads, 0, stream>>>(                 \
        qp, kp, vp, op, n_heads, n_kv, seq, pos, scale);                       \
    break;
  switch (chunks) {
    REPRO_FD_CASE(2)
    REPRO_FD_CASE(4)
    REPRO_FD_CASE(8)
    REPRO_FD_CASE(16)
    REPRO_FD_CASE(32)
    REPRO_FD_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FD_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, H, dh); k, v (B, S, KV, dh);
// out (B, H, dh).  The wrapper checks shapes, G <= 8, 1 <= pos <= S, and that
// dh is 2..64 16-byte chunks, a power of two.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   void* out, int batch, int n_heads, int n_kv,
                                   int seq, int d_head, int pos, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_for_dtype<float>(q, k, v, out, batch, n_heads, n_kv, seq,
                                   d_head, pos, scale, s);
  }
  if (dtype == 1) {
    return launch_for_dtype<__nv_bfloat16>(q, k, v, out, batch, n_heads, n_kv,
                                           seq, d_head, pos, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
