// moe_decode (K8): the MoE FFN of a decode step over the experts its tokens
// route to, and no other.
//
// Replaces no TPU kernel: the JAX package's MoE is XLA einsums over the
// whole (E, cap, d) expert buffer (repro/models/moe.py::_moe_ffn_once), and
// the port's plain path is torch.bmm over the same buffer.  At decode that
// bmm reads every expert's weights, while T tokens (the decode lanes) route
// to at most T * k of the E experts: at Jamba2-Mini's decode (T 4, k 2, E 16
// of 3 x 4096 x 14,336 bf16, 352 MB an expert), 16 experts a MoE layer where
// the step needs 2-4.  This kernel computes the same function,
//   out[t] = sum over kk < k, in kk order, in x's dtype, of
//            gate[t, kk] * down_e(silu(x[t] gate_e) * (x[t] up_e)),
//   e = experts[t, kk],
// and reads only the routed experts' weights: it is bound by their bytes
// (3 d f elements an expert routed to), with ~2 T operations a weight byte.
//
// Design.  Three kernels on the caller's stream, with grids that depend only
// on (E, d, f, T), so a CUDA graph captures them as they are:
//   (1) gate and up, a block a (column tile of f, expert e).  Warp 0 reads the
//       T * k routing indices and ranks the slots routed to e by ballot, in
//       flat (token-major) order; a block with none exits before reading a
//       weight, so an unrouted expert costs a block launch, not 2 d f reads.
//       Otherwise the block stages its <= RB rows of x in shared memory and
//       streams w_gate[e] and w_up[e] over its 64 columns: each thread takes
//       one 16-byte vector of a weight row (neighbouring threads on
//       neighbouring addresses, each row's tile one 128-byte line) and
//       keeps kUnroll rows of both matrices in flight in registers before
//       their FMAs.  Each weight byte is used once per routed row, so there
//       is nothing to reuse and no staging ring: the loads go straight to
//       registers.  The rows' partial sums in f32 are reduced across the
//       block's row groups by shuffles within a warp, then across warps in
//       warp order in shared memory.  The epilogue rounds as the bmm path
//       rounds (g and u to x's dtype, silu(g) computed in f32 and rounded,
//       the product rounded) and writes silu(g) * u to a (T k, f) scratch.
//   (2) down, a block a (column tile of d, split of f, expert): the same
//       loop over w_down[e]'s rows of its split, f32 partials to an
//       (n_split, T k, d) scratch.
//   (3) combine, a thread a (token, column of d): each of the token's k slots
//       sums its splits in split order, is rounded to x's dtype (the bmm's
//       output), weighed by its gate rounded to x's dtype and rounded; the k
//       terms are added in k order, each sum rounded: the combine of
//       models/moe.py.  Products and sums of the rounded steps use __fmul_rn
//       and __fadd_rn, so no FMA contraction changes a rounding.
// No atomics; every sum runs in a fixed order, so two calls are bitwise
// equal.  RB, the rows a block holds, is the wrapper's power of two >= T
// (<= 8): rows past a block's routed ones are zeros in shared memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // output columns a block
constexpr int kUnroll = 4;    // weight rows in flight a thread
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;  // elements per 16-byte vector
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

// x rounded to T and back: the rounding of a PyTorch op whose output is T.
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return Vec<T>::to_float(Vec<T>::from_float(x));
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// The flat slots j = token * k + kk routed to expert e, ascending, into
// list[0, RB).  A token routes to an expert at most once, so there are at
// most n_tokens <= RB of them.  Warp 0 reads the indices 32 at a time and
// ranks its hits by ballot; every thread of the block gets the count.
template <int RB>
__device__ int routed_slots(const int64_t* __restrict__ experts, int ld, int n_tokens, int k,
                            int e, int* list, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int n_slots = n_tokens * k;
    int found = 0;
    for (int j0 = 0; j0 < n_slots; j0 += 32) {
      const int j = j0 + lane;
      const bool hit = j < n_slots && experts[static_cast<long long>(j / k) * ld + j % k] == e;
      const unsigned mask = __ballot_sync(kFull, hit);
      const int at = found + __popc(mask & ((1u << lane) - 1u));
      if (hit && at < RB) list[at] = j;
      found += __popc(mask);
    }
    if (lane == 0) *count = min(found, RB);
  }
  __syncthreads();
  return *count;
}

// Row r < n of dst (RB rows of len elements): row list[r] / div of src
// (rows of ld elements), its elements [k0, k0 + len); rows n..RB-1 zeros.
// len, ld and k0 are multiples of 8, so every vector is 16-byte aligned.
template <typename T, int RB>
__device__ void stage_rows(T* dst, const T* __restrict__ src, const int* list, int n, int div,
                           long long ld, int k0, int len) {
  constexpr int V = Vec<T>::E;
  const int vecs = len / V;
  for (int idx = threadIdx.x; idx < RB * vecs; idx += kThreads) {
    const int r = idx / vecs, c = idx - r * vecs;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < n) {
      v = *reinterpret_cast<const int4*>(src + static_cast<long long>(list[r] / div) * ld + k0 +
                                         c * V);
    }
    *reinterpret_cast<int4*>(dst + static_cast<long long>(r) * len + c * V) = v;
  }
}

// acc[m][r][c] += sum over this thread's rows i of [k0, k1) of
// xs[r][i - k0] * w[m][i][col + c].  A thread takes the vector of columns
// col (its lane within kTile / V lanes a row) of the rows i = k0 + its group,
// + kGroups, ...; kUnroll rows of every matrix are loaded before their FMAs.
template <typename T, int NMAT, int RB>
__device__ __forceinline__ void accumulate(const T* const (&w)[NMAT], long long ld, int col,
                                           bool live, int k0, int k1, const T* xs, int xs_ld,
                                           float (&acc)[NMAT][RB][Vec<T>::E]) {
  constexpr int V = Vec<T>::E;
  constexpr int kLanes = kTile / V;
  constexpr int kGroups = kThreads / kLanes;
  if (!live) return;
  for (int i0 = k0 + static_cast<int>(threadIdx.x) / kLanes; i0 < k1; i0 += kGroups * kUnroll) {
    int4 raw[kUnroll][NMAT];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kGroups;
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        raw[u][m] = i < k1 ? __ldg(reinterpret_cast<const int4*>(w[m] + i * ld + col))
                           : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kGroups;
      if (i < k1) {
        float wf[NMAT][V];
#pragma unroll
        for (int m = 0; m < NMAT; ++m) Vec<T>::unpack(raw[u][m], wf[m]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xv = Vec<T>::to_float(xs[r * xs_ld + (i - k0)]);
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
#pragma unroll
            for (int c = 0; c < V; ++c) acc[m][r][c] = fmaf(xv, wf[m][c], acc[m][r][c]);
          }
        }
      }
    }
  }
}

// The block's sums over its row groups: lanes of one column vector are
// combined within each warp by shuffles, then each warp's sums go to
// red[warp][m][r][kTile]; tile_sum adds the warps in warp order.
template <int NMAT, int RB, int V>
__device__ __forceinline__ void reduce_to_smem(float (&acc)[NMAT][RB][V], float* red) {
  constexpr int kLanes = kTile / V;
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < V; ++c) acc[m][r][c] += __shfl_xor_sync(kFull, acc[m][r][c], off);
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < kLanes) {
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          red[((warp * NMAT + m) * RB + r) * kTile + lane * V + c] = acc[m][r][c];
        }
      }
    }
  }
  __syncthreads();
}

template <int NMAT, int RB>
__device__ __forceinline__ float tile_sum(const float* red, int m, int r, int c) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[((w * NMAT + m) * RB + r) * kTile + c]);
  return s;
}

// (1) h[j] = silu(x[j / k] w_gate[e]) * (x[j / k] w_up[e]) over the block's
// column tile, for the slots j routed to e = blockIdx.y.
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
moe_gate_up_kernel(const T* __restrict__ x, const int64_t* __restrict__ experts, int ld_experts,
                   const T* __restrict__ w_gate, const T* __restrict__ w_up, T* __restrict__ h,
                   int n_tokens, int k, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list[RB];
  __shared__ int count;
  constexpr int V = Vec<T>::E;
  const int e = blockIdx.y;
  const int n = routed_slots<RB>(experts, ld_experts, n_tokens, k, e, list, &count);
  if (n == 0) return;
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(sizeof(T) * RB * d));
  stage_rows<T, RB>(xs, x, list, n, k, d, 0, d);
  __syncthreads();
  const int col = blockIdx.x * kTile + (threadIdx.x % (kTile / V)) * V;
  const long long base = static_cast<long long>(e) * d * f;
  const T* const w[2] = {w_gate + base, w_up + base};
  float acc[2][RB][V] = {};
  accumulate<T, 2, RB>(w, f, col, col < f, 0, d, xs, d, acc);
  reduce_to_smem<2, RB, V>(acc, red);
  for (int idx = threadIdx.x; idx < n * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx - r * kTile, cc = blockIdx.x * kTile + c;
    if (cc >= f) continue;
    const float g = rounded<T>(tile_sum<2, RB>(red, 0, r, c));
    const float u = rounded<T>(tile_sum<2, RB>(red, 1, r, c));
    const float s = rounded<T>(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
    h[static_cast<long long>(list[r]) * f + cc] = Vec<T>::from_float(__fmul_rn(s, u));
  }
}

// (2) part[split][j] = h[j][k0:k1] w_down[e][k0:k1] over the block's column
// tile of d, for the slots j routed to e = blockIdx.z, in f32.
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const int64_t* __restrict__ experts, int ld_experts, const T* __restrict__ h,
                const T* __restrict__ w_down, float* __restrict__ part, int n_tokens, int k,
                int d, int f, int range) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list[RB];
  __shared__ int count;
  constexpr int V = Vec<T>::E;
  const int e = blockIdx.z, split = blockIdx.y;
  const int k0 = split * range, k1 = min(f, k0 + range);
  const int n = routed_slots<RB>(experts, ld_experts, n_tokens, k, e, list, &count);
  if (n == 0) return;
  T* hs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(sizeof(T) * RB * range));
  stage_rows<T, RB>(hs, h, list, n, 1, f, k0, k1 - k0);
  __syncthreads();
  const int col = blockIdx.x * kTile + (threadIdx.x % (kTile / V)) * V;
  const T* const w[1] = {w_down + static_cast<long long>(e) * f * d};
  float acc[1][RB][V] = {};
  accumulate<T, 1, RB>(w, d, col, col < d, k0, k1, hs, k1 - k0, acc);
  reduce_to_smem<1, RB, V>(acc, red);
  const long long n_slots = static_cast<long long>(n_tokens) * k;
  for (int idx = threadIdx.x; idx < n * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx - r * kTile, cc = blockIdx.x * kTile + c;
    if (cc >= d) continue;
    part[(split * n_slots + list[r]) * d + cc] = tile_sum<1, RB>(red, 0, r, c);
  }
}

// (3) out[t] = the gated sum of token t's k slots, in k order, in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const float* __restrict__ part, const float* __restrict__ gates, int ld_gates,
                   T* __restrict__ out, int n_tokens, int k, int d, int n_split) {
  const int t = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  const long long n_slots = static_cast<long long>(n_tokens) * k;
  float acc = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    const long long j = static_cast<long long>(t) * k + kk;
    float y = 0.0f;
    for (int s = 0; s < n_split; ++s) y = __fadd_rn(y, part[(s * n_slots + j) * d + col]);
    const float gate = rounded<T>(gates[static_cast<long long>(t) * ld_gates + kk]);
    const float term = rounded<T>(__fmul_rn(rounded<T>(y), gate));
    acc = kk == 0 ? term : rounded<T>(__fadd_rn(acc, term));
  }
  out[static_cast<long long>(t) * d + col] = Vec<T>::from_float(acc);
}

// Set on every launch: a block's dynamic bytes at exactly 48 KB, with its
// static list and count on top, already need it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int RB>
int launch(const void* x, const int64_t* experts, int ld_experts, const float* gates,
           int ld_gates, const void* w_gate, const void* w_up, const void* w_down, void* h,
           float* part, void* out, int n_tokens, int k, int n_experts, int d, int f, int n_split,
           int range, cudaStream_t stream) {
  const size_t smem1 = align16(sizeof(T) * RB * d) + sizeof(float) * kWarps * 2 * RB * kTile;
  const size_t smem2 = align16(sizeof(T) * RB * range) + sizeof(float) * kWarps * RB * kTile;
  if (smem1 > static_cast<size_t>(kMaxSmem) || smem2 > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(moe_gate_up_kernel<T, RB>, smem1);
  if (err == cudaSuccess) err = allow_smem(moe_down_kernel<T, RB>, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g1((f + kTile - 1) / kTile, n_experts);
  moe_gate_up_kernel<T, RB><<<g1, kThreads, smem1, stream>>>(
      static_cast<const T*>(x), experts, ld_experts, static_cast<const T*>(w_gate),
      static_cast<const T*>(w_up), static_cast<T*>(h), n_tokens, k, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2((d + kTile - 1) / kTile, n_split, n_experts);
  moe_down_kernel<T, RB><<<g2, kThreads, smem2, stream>>>(
      experts, ld_experts, static_cast<const T*>(h), static_cast<const T*>(w_down), part,
      n_tokens, k, d, f, range);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g3((d + kThreads - 1) / kThreads, n_tokens);
  moe_combine_kernel<T><<<g3, kThreads, 0, stream>>>(part, gates, ld_gates, static_cast<T*>(out),
                                                     n_tokens, k, d, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(int rows, const void* x, const int64_t* experts, int ld_experts,
                const float* gates, int ld_gates, const void* w_gate, const void* w_up,
                const void* w_down, void* h, float* part, void* out, int n_tokens, int k,
                int n_experts, int d, int f, int n_split, int range, cudaStream_t stream) {
#define REPRO_MOE_CASE(RR)                                                                   \
  case RR:                                                                                   \
    return launch<T, RR>(x, experts, ld_experts, gates, ld_gates, w_gate, w_up, w_down, h,   \
                         part, out, n_tokens, k, n_experts, d, f, n_split, range, stream);
  switch (rows) {
    REPRO_MOE_CASE(1)
    REPRO_MOE_CASE(2)
    REPRO_MOE_CASE(4)
    REPRO_MOE_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MOE_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (T, d); experts (T, k) int64 and
// gates (T, k) f32 with rows ld_experts / ld_gates elements apart; w_gate,
// w_up (E, d, f) and w_down (E, f, d), contiguous; h: (T k, f) scratch of x's
// dtype; part: (n_split, T k, d) f32 scratch; out (T, d).  rows: the rows a
// block holds, a power of two in [T, 8].  f is cut into n_split ranges of
// `range` rows (the last one shorter, none empty).  d, f and range are
// multiples of 8.  Every index must lie in [0, E) (the wrapper cannot read
// them back); a token's k experts are distinct.  Returns the first CUDA error.
extern "C" int moe_decode_launch(const void* x, const int64_t* experts, int ld_experts,
                                 const float* gates, int ld_gates, const void* w_gate,
                                 const void* w_up, const void* w_down, void* h, void* part,
                                 void* out, int n_tokens, int k, int n_experts, int d, int f,
                                 int rows, int n_split, int range, int dtype, void* stream) {
  const bool ok = n_tokens >= 1 && n_tokens <= rows && k >= 1 && k <= n_experts &&
                  n_experts >= 1 && n_experts <= 65535 && d >= 8 && f >= 8 && d % 8 == 0 &&
                  f % 8 == 0 && range >= 8 && range % 8 == 0 && n_split >= 1 &&
                  n_split <= 65535 && static_cast<long long>(n_split - 1) * range < f &&
                  static_cast<long long>(n_split) * range >= f && ld_experts >= k &&
                  ld_gates >= k;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0) {
    return launch_rows<float>(rows, x, experts, ld_experts, gates, ld_gates, w_gate, w_up,
                              w_down, h, p, out, n_tokens, k, n_experts, d, f, n_split, range, s);
  }
  if (dtype == 1) {
    return launch_rows<__nv_bfloat16>(rows, x, experts, ld_experts, gates, ld_gates, w_gate,
                                      w_up, w_down, h, p, out, n_tokens, k, n_experts, d, f,
                                      n_split, range, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
