// rwkv_scan: the WKV-6 recurrence of the RWKV-6 (Finch) time mix, from a
// zero state:  y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]),
//              S[i][j] <- S[i][j] w_t[i] + k_t[i] v_t[j].
//
// Replaces repro/kernels/rwkv_scan.py::_rwkv_kernel.  That kernel walks T in
// chunks on a sequential grid axis only to keep the dh x dh state in VMEM
// scratch between grid steps.  Here one block owns one (b, h) and loops over
// the whole of T itself, so the state never leaves the SM and T may take any
// length (the TPU kernel needs T % chunk == 0).
//
// Bound on the H100: at the serving shape (B 1, T 2048, H 40, dh 64, f32)
// the bytes (r, k, v, w read once, y written once: ~105 MB) bound it at
// ~0.03 ms; the f32 operations the function needs (5 a state element a step,
// the u term factored out: ~1.7 GFLOP) at a little less.  This kernel is far
// from either: a step depends on the last, so each thread walks a chain of
// T steps of dh fused multiply-adds, and only B*H blocks (40 at the serving
// shape) of dh threads run.
//
// Design: thread j keeps column j of the state, S[:, j], in registers (the
// columns evolve independently).  Every CH steps the block stages r, k, v
// and w of those steps in shared memory as f32 (thread j loads lane j of
// each step, so a warp reads one contiguous row segment), then walks the
// CH steps with no barrier: r_i, k_i, w_i and u_i are broadcast reads of
// one shared address, four lanes at a time.  dh is padded to DH (64 or
// 128) with zero r, k and w, which leave the padded rows of S at zero and
// add nothing to y.  y is written in the input dtype (one rounding of the
// f32 sum); the final state is written [k_idx][v_idx] in f32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kStageBytes = 32 * 1024;  // shared bytes for the staged r, k, v, w

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DH, typename T>
__global__ void __launch_bounds__(DH)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, T* __restrict__ y,
                 float* __restrict__ state, int n_steps, int n_heads, int dh) {
  constexpr int CH = kStageBytes / (4 * DH * static_cast<int>(sizeof(float)));
  __shared__ __align__(16) float r_s[CH][DH];
  __shared__ __align__(16) float k_s[CH][DH];
  __shared__ __align__(16) float v_s[CH][DH];
  __shared__ __align__(16) float w_s[CH][DH];
  __shared__ __align__(16) float u_s[DH];

  const int j = threadIdx.x;
  const bool lane = j < dh;
  const int bh = blockIdx.x;                 // b * n_heads + h
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const long long row = static_cast<long long>(n_heads) * dh;  // one step apart
  const long long base = (static_cast<long long>(b) * n_steps * n_heads + h) * dh + j;
  u_s[j] = lane ? u[h * dh + j] : 0.0f;

  float s[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) s[i] = 0.0f;

  for (int t0 = 0; t0 < n_steps; t0 += CH) {
    const int n = min(CH, n_steps - t0);
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 0.0f;
      if (lane && c < n) {
        const long long off = base + static_cast<long long>(t0 + c) * row;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        wv = to_f32(w[off]);
      }
      r_s[c][j] = rv;
      k_s[c][j] = kv;
      v_s[c][j] = vv;
      w_s[c][j] = wv;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = v_s[c][j];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < DH; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[c][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&u_s[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = kk[q] * vj;
          acc[q] = fmaf(rr[q], fmaf(uu[q], kv, s[i + q]), acc[q]);
          s[i + q] = fmaf(s[i + q], ww[q], kv);
        }
      }
      if (lane) {
        store(y + base + static_cast<long long>(t0 + c) * row,
              (acc[0] + acc[1]) + (acc[2] + acc[3]));
      }
    }
  }
  if (lane) {
    float* out = state + static_cast<long long>(bh) * dh * dh + j;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      if (i < dh) out[static_cast<long long>(i) * dh] = s[i];
    }
  }
}

template <int DH, typename T>
void launch(const void* r, const void* k, const void* v, const void* w,
            const float* u, void* y, float* state, int batch, int n_steps,
            int n_heads, int dh, cudaStream_t stream) {
  rwkv_scan_kernel<DH, T><<<batch * n_heads, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, static_cast<T*>(y), state, n_steps, n_heads, dh);
}

template <typename T>
void launch_dh(const void* r, const void* k, const void* v, const void* w,
               const float* u, void* y, float* state, int batch, int n_steps,
               int n_heads, int dh, cudaStream_t stream) {
  if (dh <= 64) {
    launch<64, T>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, stream);
  } else {
    launch<128, T>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, stream);
  }
}

}  // namespace

// r, k, v, w, y: (batch, n_steps, n_heads, dh) in f32 (dtype 0) or bf16
// (dtype 1); u: (n_heads, dh) f32; state: (batch, n_heads, dh, dh) f32.
// 1 <= dh <= 128 (the wrapper checks).  Returns cudaGetLastError().
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const void* w, const float* u, void* y, float* state,
                                int batch, int n_steps, int n_heads, int dh, int dtype,
                                void* stream) {
  if (batch > 0 && n_heads > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
      launch_dh<__nv_bfloat16>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, st);
    } else {
      launch_dh<float>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
