// moe_route (K9): the routing of a decode step's MoE layer, and its capacity
// rule, in one launch.
//
// Replaces no TPU kernel: the JAX package routes with XLA ops
// (repro/models/moe.py::_moe_ffn_once: the router product, softmax, top_k,
// the one-hot cumsum of slot positions, the aux loss), and so did the port's
// plain path, ~25 launches of near-zero work a decode MoE layer.  At decode
// the routing is bound by launch latency, not by bytes: granite's router is
// 1024 x 32 bf16, 64 KB, Jamba2-Mini's 4096 x 16, 128 KB.  This kernel
// computes, for T <= 8 tokens of a dispatch group, what the plain path does:
//   probs  = softmax(x router) in f32, from the up-cast operands;
//   experts, the top k in descending probability, the lower index first on a
//     tie (a stable sort's order);
//   gates, renormalised over their k or kept as they are;
//   pos[t, kk], the count of earlier slots of the token-major order with the
//     same expert: a token's k experts are distinct, so that is the count of
//     earlier tokens routed to it;
//   gates_kept = gates where pos < cap, else 0 (the slot is dropped);
//   aux = sum_e count_e / (T k) * mean_t probs[t, e] * E, in f32.
// K8 (csrc/moe_decode.cu) takes experts and gates_kept: a dropped slot's term
// is then 0, as on the dispatch path.
//
// Design.  One cluster of kCluster blocks, a grid fixed by nothing but the
// launch, so a CUDA graph captures it.  One block on one SM would read the
// router, take its products and reduce them alone (7.3 us at granite's
// width); the cluster spreads that over kCluster SMs.
//   (1) The router, as one flat array of 16-byte vectors, is cut into
//       kCluster contiguous ranges of whole rows, one a block.  A block
//       issues its first vectors, then stages the x values of its rows in
//       shared memory (rows past T zeros).  E is a power of two <= 64 and a
//       range starts on a row, so a thread's vectors always hold the same
//       columns; each thread keeps f32 partial logits of its columns for its
//       RB rows.
//   (2) The partials are summed across the lanes that share columns by
//       shuffles, then across warps in warp order: the block's partial
//       logits, which it stores into block 0's shared memory (distributed
//       shared memory) before the cluster barrier, and exits.
//   (3) Block 0 sums the blocks' partials in rank order, then a warp a
//       token, in registers: softmax over E (E <= 64: two values a lane),
//       each expert's rank (the count of experts whose order_key is above its
//       own: a higher probability, or an equal one at a lower index), the
//       slots of rank < k, a bit mask of them, and the sum that renormalises
//       their gates.
//   (4) Lane kk of token r's warp: slot (r, kk)'s position, the earlier
//       tokens' mask bits of its expert, and its kept gate; the last warp the
//       aux loss.
// No atomics, and every sum in a fixed order: two calls are bitwise equal.
// A NaN logit leaves the order undefined, but every expert index written lies
// in [0, E), so K8 never reads outside the weights.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // blocks, the portable cluster size
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;        // router vectors in flight a thread
constexpr int kMaxExperts = 64;
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
  __device__ static float zero() { return 0.0f; }
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
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.0f); }
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Expert e's place in the order of the top k: a non-negative probability's
// bits order as the probability, and the inverted index puts the lower index
// first among equal probabilities.
__device__ __forceinline__ unsigned long long order_key(float p, int e) {
  return static_cast<unsigned long long>(__float_as_uint(p)) << 32 | ~static_cast<unsigned>(e);
}

// Block rank q takes the router vectors [q chunk, min((q + 1) chunk, n_vecs)),
// chunk a multiple of E / V vectors: whole rows.  Dynamic shared memory: xs
// (RB rows of `span` x values, the block's router rows), then red (kWarps x RB
// x width f32), width = max(E, V): the columns the lanes < E / V of a warp
// hold between them.
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
moe_route_kernel(const T* __restrict__ x, const T* __restrict__ router,
                 int64_t* __restrict__ experts, float* __restrict__ gates_kept,
                 float* __restrict__ aux, int n_tokens, int d, int log_e, int k, int cap,
                 int renormalize, int chunk, int span) {
  constexpr int V = Vec<T>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[kCluster][RB][kMaxExperts];   // block 0's: each block's partials
  __shared__ float prob[RB][kMaxExperts];
  __shared__ float sel_p[RB][kMaxExperts];
  __shared__ int sel_e[RB][kMaxExperts];
  __shared__ unsigned long long key[RB][kMaxExperts];   // the experts' order, see (3)
  __shared__ unsigned long long mask[RB];   // bit e: token r routes to expert e
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_e = 1 << log_e;
  const int lanes = n_e >= V ? n_e / V : 1;
  const int width = lanes * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_vecs = (d << log_e) / V;
  const int v_begin = min(rank * chunk, n_vecs), v_end = min(v_begin + chunk, n_vecs);
  const int i0 = (v_begin * V) >> log_e;          // the block's first router row
  const int rows = ((v_end * V) >> log_e) - i0;
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(sizeof(T) * RB * span));

  // (1) The first router vectors in flight, x's values of the block's rows
  // into shared memory, then the products.
  const int4* w = reinterpret_cast<const int4*>(router);
  int4 raw[kUnroll];
  const int v_first = v_begin + static_cast<int>(threadIdx.x);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int v = v_first + u * kThreads;
    raw[u] = v < v_end ? __ldg(w + v) : make_int4(0, 0, 0, 0);
  }
  if ((i0 | span) % V == 0) {              // 16-byte vectors of x's rows
    const int vecs = span / V;
    for (int idx = threadIdx.x; idx < RB * vecs; idx += kThreads) {
      const int r = idx / vecs, j = (idx - r * vecs) * V;
      int4 v = make_int4(0, 0, 0, 0);
      if (r < n_tokens && j < rows) {
        v = *reinterpret_cast<const int4*>(x + static_cast<long long>(r) * d + i0 + j);
      }
      reinterpret_cast<int4*>(xs)[idx] = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < RB * span; idx += kThreads) {
      const int r = idx / span, j = idx - r * span;
      xs[idx] = r < n_tokens && j < rows ? x[static_cast<long long>(r) * d + i0 + j]
                                         : Vec<T>::zero();
    }
  }
  __syncthreads();
  float acc[RB][V] = {};
  for (int v0 = v_first; v0 < v_end; v0 += kThreads * kUnroll) {
    if (v0 != v_first) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads;
        raw[u] = v < v_end ? __ldg(w + v) : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < v_end) {
        float wf[V];
        Vec<T>::unpack(raw[u], wf);
        if (n_e >= V) {
          const int i = ((v * V) >> log_e) - i0;   // the vector lies in one router row
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float xv = Vec<T>::to_float(xs[r * span + i]);
#pragma unroll
            for (int c = 0; c < V; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) {
            const int i = ((v * V + c) >> log_e) - i0;   // the vector spans V / E rows
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              acc[r][c] = fmaf(Vec<T>::to_float(xs[r * span + i]), wf[c], acc[r][c]);
            }
          }
        }
      }
    }
  }

  // (2) Lanes l and l' hold the same columns where l = l' mod lanes.
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int c = 0; c < V; ++c) acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], off);
    }
  }
  if (lane < lanes) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int c = 0; c < V; ++c) red[(warp * RB + r) * width + lane * V + c] = acc[r][c];
    }
  }
  __syncthreads();
  const int reps = width >> log_e;             // where E < V, V / E columns a logit
  for (int idx = threadIdx.x; idx < n_tokens * n_e; idx += kThreads) {
    const int r = idx >> log_e, e = idx & (n_e - 1);
    float v[kWarps];
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) v[ww] = red[(ww * RB + r) * width + e];
    for (int j = 1; j < reps; ++j) {
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        v[ww] = __fadd_rn(v[ww], red[(ww * RB + r) * width + e + j * n_e]);
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) s = __fadd_rn(s, v[ww]);
    *cluster.map_shared_rank(&part[rank][r][e], 0) = s;   // into block 0's shared memory
  }

  // (3) Block 0 sums the partials in rank order, once the cluster barrier
  // has made every block's stores to it visible; the other blocks are done.
  cluster.sync();
  if (rank != 0) return;
  for (int idx = threadIdx.x; idx < n_tokens * n_e; idx += kThreads) {
    const int r = idx >> log_e, e = idx & (n_e - 1);
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s = __fadd_rn(s, part[q][r][e]);
    prob[r][e] = s;                          // the logit, until the softmax
  }
  __syncthreads();
  float denom = 1.0f;
  if (warp < n_tokens) {
    const int r = warp;
    const bool has0 = lane < n_e, has1 = lane + 32 < n_e;
    const float l0 = has0 ? prob[r][lane] : -CUDART_INF_F;
    const float l1 = has1 ? prob[r][lane + 32] : -CUDART_INF_F;
    const float m = warp_max(fmaxf(l0, l1));
    const float x0 = has0 ? expf(l0 - m) : 0.0f, x1 = has1 ? expf(l1 - m) : 0.0f;
    const float s = warp_sum(x0 + x1);
    const float inv = __frcp_rn(s);
    const float p0 = __fmul_rn(x0, inv), p1 = __fmul_rn(x1, inv);
    if (has0) prob[r][lane] = p0;
    if (has1) prob[r][lane + 32] = p1;
    // Each expert's rank: the count of keys above its key, the probability's
    // bits (a non-negative float orders as its bits) over the inverted index,
    // so that of equal probabilities the lower index ranks first.  Keys past
    // E are 0, below every expert's; eight at a time, so the reads overlap.
    const unsigned long long key0 = has0 ? order_key(p0, lane) : 0ull;
    const unsigned long long key1 = has1 ? order_key(p1, lane + 32) : 0ull;
    key[r][lane] = key0;
    key[r][lane + 32] = key1;
    __syncwarp();
    int rank0 = 0, rank1 = 0;
    for (int o0 = 0; o0 < n_e; o0 += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) rank0 += key[r][o0 + j] > key0;
    }
    if (n_e > 32) {
      for (int o0 = 0; o0 < n_e; o0 += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) rank1 += key[r][o0 + j] > key1;
      }
    }
    const bool in0 = has0 && rank0 < k, in1 = has1 && rank1 < k;
    const unsigned lo = __ballot_sync(kFull, in0), hi = __ballot_sync(kFull, in1);
    if (lane == 0) mask[r] = lo | static_cast<unsigned long long>(hi) << 32;
    for (int kk = lane; kk < k; kk += 32) sel_e[r][kk] = kk;   // in range whatever the ranks
    __syncwarp();
    if (in0) {
      sel_e[r][rank0] = lane;
      sel_p[r][rank0] = p0;
    }
    if (in1) {
      sel_e[r][rank1] = lane + 32;
      sel_p[r][rank1] = p1;
    }
    if (renormalize) denom = fmaxf(warp_sum((in0 ? p0 : 0.0f) + (in1 ? p1 : 0.0f)), 1e-9f);
  }
  __syncthreads();

  // (4) Lane kk of token r's warp: slot (r, kk), its position among its
  // expert's slots (the earlier tokens routed to it) and its kept gate; the
  // last warp the aux loss.
  if (warp < n_tokens) {
    const int r = warp;
    for (int kk = lane; kk < k; kk += 32) {
      const int e = sel_e[r][kk];
      const float p = sel_p[r][kk];
      int pos = 0;
#pragma unroll
      for (int t = 0; t < RB; ++t) pos += t < r ? static_cast<int>(mask[t] >> e & 1) : 0;
      experts[r * k + kk] = e;
      gates_kept[r * k + kk] = pos < cap ? (renormalize ? __fdiv_rn(p, denom) : p) : 0.0f;
    }
  }
  if (warp == kWarps - 1) {
    float term = 0.0f;
    for (int e = lane; e < n_e; e += 32) {
      int count = 0;
      float p = 0.0f;
#pragma unroll
      for (int t = 0; t < RB; ++t) {
        if (t < n_tokens) {
          count += static_cast<int>(mask[t] >> e & 1);
          p = __fadd_rn(p, prob[t][e]);
        }
      }
      const float frac = __fdiv_rn(static_cast<float>(count), static_cast<float>(n_tokens * k));
      term = __fadd_rn(term, __fmul_rn(frac, __fdiv_rn(p, static_cast<float>(n_tokens))));
    }
    const float total = warp_sum(term);
    if (lane == 0) *aux = __fmul_rn(total, static_cast<float>(n_e));
  }
}

template <typename T, int RB>
int launch(const void* x, const void* router, int64_t* experts, float* gates_kept, float* aux,
           int n_tokens, int d, int log_e, int k, int cap, int renormalize,
           cudaStream_t stream) {
  constexpr int V = Vec<T>::E;
  const int n_e = 1 << log_e;
  const int lanes = n_e >= V ? n_e / V : 1;
  if (d % V) return static_cast<int>(cudaErrorInvalidValue);
  const int n_vecs = (d << log_e) / V;
  // Vectors a block, a multiple of `lanes`: a whole number of rows (where E
  // < V, a vector holds V / E whole rows).
  const int chunk = ((n_vecs + kCluster - 1) / kCluster + lanes - 1) / lanes * lanes;
  const int span = (chunk * V) >> log_e;
  const size_t width = n_e >= V ? n_e : V;
  const size_t smem = align16(sizeof(T) * RB * span) + sizeof(float) * kWarps * RB * width;
  if (smem > static_cast<size_t>(kMaxSmem) - (kCluster + 5) * RB * kMaxExperts * 4 - 8 * RB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(moe_route_kernel<T, RB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, moe_route_kernel<T, RB>, static_cast<const T*>(x),
                           static_cast<const T*>(router), experts, gates_kept, aux, n_tokens,
                           d, log_e, k, cap, renormalize, chunk, span);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(int rows, const void* x, const void* router, int64_t* experts,
                float* gates_kept, float* aux, int n_tokens, int d, int log_e, int k, int cap,
                int renormalize, cudaStream_t stream) {
#define REPRO_ROUTE_CASE(RR)                                                                \
  case RR:                                                                                  \
    return launch<T, RR>(x, router, experts, gates_kept, aux, n_tokens, d, log_e, k, cap,   \
                         renormalize, stream);
  switch (rows) {
    REPRO_ROUTE_CASE(1)
    REPRO_ROUTE_CASE(2)
    REPRO_ROUTE_CASE(4)
    REPRO_ROUTE_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ROUTE_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of both x (T, d) and router (d, E), each
// contiguous and 16-byte aligned.  experts (T, k) int64 and gates_kept (T, k)
// f32, contiguous; aux one f32.  rows: the rows the block holds, a power of
// two in [T, 8].  E a power of two in [1, 64], 1 <= k <= E, cap >= 0; d a
// multiple of the elements a 16-byte vector holds.  Returns the first CUDA
// error.
extern "C" int moe_route_launch(const void* x, const void* router, int64_t* experts,
                                float* gates_kept, float* aux, int n_tokens, int d,
                                int n_experts, int k, int cap, int renormalize, int rows,
                                int dtype, void* stream) {
  const bool ok = n_tokens >= 1 && n_tokens <= rows && rows <= 8 && n_experts >= 1 &&
                  n_experts <= kMaxExperts && (n_experts & (n_experts - 1)) == 0 && k >= 1 &&
                  k <= n_experts && d >= 1 && d <= (1 << 24) / n_experts && cap >= 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int log_e = __builtin_ctz(static_cast<unsigned>(n_experts));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_rows<float>(rows, x, router, experts, gates_kept, aux, n_tokens, d, log_e, k,
                              cap, renormalize, s);
  }
  if (dtype == 1) {
    return launch_rows<__nv_bfloat16>(rows, x, router, experts, gates_kept, aux, n_tokens, d,
                                      log_e, k, cap, renormalize, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
