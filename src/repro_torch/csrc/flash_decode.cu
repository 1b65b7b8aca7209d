// flash_decode: GQA one-token attention over a KV cache, split over the
// cache across the card's SMs (flash-decoding).
//
// Replaces repro/kernels/flash_decode.py::_flash_decode_kernel.  Semantics
// kept: q (B, H, dh) attends to the first pos rows of k/v (B, S, KV, dh) with
// G = H / KV query heads per KV head; scale dh^-1/2; f32 softmax statistics
// and accumulator; output acc / max(l, 1e-30) in q's dtype.  Either one
// scalar pos for the whole batch, as in the reference, or a (B,) int32 device
// vector of per-row lengths (lens, each in [1, pos], pos their maximum), the
// per-slot decode of repro/models/model.py::_period_decode: row b attends to
// its first lens[b] keys.  Keys at or past a row's length are never loaded
// (their masked weight is exactly 0 in the reference).
//
// Bound on the H100: bytes.  Every valid key and value row is read once (at
// qwen3-14b, B 4, KV 8, dh 128, bf16, pos 2056: 33.7 MB, 0.0101 ms at
// 3.35 TB/s), against ~0.17 GFLOP.  The first design ran one block per
// (batch, KV head): 32 blocks on 32 of 132 SMs, 0.1648 ms at that shape.
//
// Design.  The wrapper (kernels/flash_decode.py::split_plan) cuts [0, pos)
// into n_split contiguous ranges of range_len keys (the last one shorter),
// so that B * KV * n_split blocks fill the card (544 blocks of 121 keys at
// the shape above).  One block of flash_decode_split_kernel takes one
// (batch, KV head, range):
//   (0) every thread starts cp.async 16-byte copies of the range's key rows
//       and then of its value rows into shared memory (two commit groups),
//       so the block's whole share of the cache is in flight at once;
//   (1) when the keys land: the scores of the G query rows;
//   (2) one warp a query row: the range's max m and sum l of exp(s - m);
//   (3) when the values land: p.v.
// With one range the block writes the output itself.  Otherwise it writes
// its partial (m, l, acc) in f32 to a scratch tensor the wrapper allocates,
// and flash_decode_combine_kernel, one block a (batch, query head), merges
// the ranges in range order.  With per-row lengths the ranges cut [0, pos),
// pos the longest row; a block whose range starts at or past its row's
// length has no keys and writes an empty partial (m = -1e30, l = 0, acc = 0),
// which the combine weighs by exp(-1e30 - m) = 0.  The split is the
// scalar launch's at pos, so a vector of equal lengths gives its sums bit
// for bit.  Every sum runs in a
// fixed order: two calls on the same inputs are bitwise equal.  (A merge by the last block of each
// (batch, KV head) to finish, found with an atomic arrival counter, was
// slower: one block's merge of all the pair's ranges is a chain of L2
// reads at the tail of the kernel.)
// Products: in bf16 (the serving dtype), (1) and (3) run on the tensor
// cores with mma.sync m16n8k16 and f32 accumulation: q rows g < G of a
// 16-row tile against 8-key tiles, and p (split into bf16 hi + lo halves,
// ~16 bits of it) against 16-key steps of v read by ldmatrix.trans.  The
// tiles are XOR-swizzled so those fragment reads are free of bank
// conflicts.  mma.sync, not wgmma: a tile of G <= 8 rows fills a sliver of
// either, and the kernel is bound by bytes once the products leave the
// CUDA cores.  On the CUDA cores, a first split version spent its time in
// shared-memory reads of q (ten for each 16-byte chunk of a key) and in
// shuffles: 0.040 ms at the shape above.  In f32 the products stay on the
// CUDA cores (the tensor cores' f32 inputs are TF32, which would not hold
// atol 2e-5): LG lanes a key row with shuffles for (1), one thread a (row,
// 16-byte chunk) and KS key subsets for (3).
// Two more modes serve the read-only (paged) decode of
// repro/models/attention.py::decode_attention(k_new=, v_new=) and
// ::seq_sharded_decode_attention.  A self term (k_new, v_new: the current
// token's key and value, (B, KV, dh)) is one more key row, staged by range 0
// of each (batch, KV head) after its cache rows, in the same softmax; with
// it pos = 0 (an empty cache) is legal and gives v_new.  Partials mode
// returns the merged (acc, m, l) of the launch unnormalised, in f32, for a
// merge across sequence shards; `start` is the shard's first row, taken off
// the per-row lengths.
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W) at the qwen3-14b shape
// above: 0.0207 ms a call, both kernels, against 0.1648 ms with one block
// per (batch, KV head) and 0.0416 ms for SDPA.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;  // query heads per KV head (<= kWarps)
constexpr int kCombineThreads = 128;
constexpr int kMaxSmem = 227 * 1024;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bf16 kernel takes q.k^T and p.v on the tensor cores (mma.sync
// m16n8k16, f32 accumulate); the f32 kernel on the CUDA cores, since the
// tensor cores' f32 inputs are TF32 and would not hold atol 2e-5.
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

// Key subsets of the f32 p.v phase: G * C (row, chunk) items over kThreads.
__host__ __device__ inline int pv_subsets(int g_heads, int chunks) {
  const int items = g_heads * chunks;
  return items >= kThreads ? 1 : kThreads / items;
}

// Byte offsets in the split kernel's dynamic shared memory:
// [keys | values | q | scores (f32) | m, l].  The bf16 tiles hold the range's
// rows rounded up to 16 (the depth of an mma over keys); its q is 8 rows of
// bf16, each 16 bytes longer than dh (no bank conflict across rows), and its
// score rows are 8 mod 32 floats apart (no conflict for the float2 reads of
// p).  The f32 kernel holds q in f32, and its p.v partial sums reuse the key
// region once the scores are taken.
struct Layout {
  int p_stride;  // floats between score rows
  size_t v, q, p, ml, total;
  __host__ __device__ Layout(int range, int chunks, int elems, int g_heads, bool mma) {
    const int rows = mma ? (range + 15) / 16 * 16 : range;
    const size_t tile = static_cast<size_t>(rows) * chunks * 16;
    const size_t red = mma ? 0
                           : static_cast<size_t>(pv_subsets(g_heads, chunks)) * g_heads *
                                 chunks * elems * sizeof(float);
    const size_t q_bytes = mma ? static_cast<size_t>(kMaxG) * (chunks * elems + 8) * 2
                               : static_cast<size_t>(g_heads) * chunks * elems * sizeof(float);
    p_stride = mma ? (rows + 23) / 32 * 32 + 8 : (range | 1);
    v = tile > red ? tile : red;
    q = v + tile;
    p = q + (q_bytes + 15) / 16 * 16;
    ml = p + (static_cast<size_t>(g_heads) * p_stride * sizeof(float) + 15) / 16 * 16;
    total = ml + 2 * kMaxG * sizeof(float);
  }
};

// The 16-byte chunk of a staged tile that holds chunk c of key row j.  The
// bf16 tiles XOR the chunk's place in its 128-byte line with the line (with
// the row, where a row fills whole lines), so that the 8 rows of an mma
// fragment, read at one chunk, fall in 8 distinct bank groups.  The f32
// tiles are plain.
template <typename T, int C>
__device__ __forceinline__ int tile_chunk(int j, int c) {
  if constexpr (!kMma<T>) {
    return j * C + c;
  } else if constexpr (C >= 8) {
    return j * C + (c ^ (j & 7));
  } else {
    const int p = j * C + c;
    return (p & ~7) | ((p ^ (p >> 3)) & 7);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// p (f32) as hi + lo, both bf16: hi + lo keeps ~16 of p's 24 bits, so p.v on
// bf16 tensor cores errs by ~2^-17 of the output, far inside one bf16
// rounding step (p in bf16 alone would not be).
__device__ __forceinline__ void split_bf16(float2 p, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p.x - hf.x, p.y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// C = 16-byte chunks per head row, so dh = C * E.  Grid (B * KV, n_split).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          float* __restrict__ part, const int* __restrict__ lens,
                          const T* __restrict__ k_new, const T* __restrict__ v_new,
                          int n_heads, int n_kv, int seq, int pos, int start, int range,
                          bool partial, float scale) {
  constexpr int E = Vec<T>::E;
  constexpr int DH = C * E;

  extern __shared__ __align__(16) unsigned char smem[];
  const int g_heads = n_heads / n_kv;
  const Layout lay(range + (k_new != nullptr), C, E, g_heads, kMma<T>);
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + lay.v;
  unsigned char* q_s = smem + lay.q;
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.ml);
  float* l_s = m_s + kMaxG;

  const int b = blockIdx.x / n_kv;
  const int kh = blockIdx.x % n_kv;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int t0 = split * range;
  // Cache keys of this range: >= 1 for a scalar pos; with per-row lengths,
  // <= 0 where the row ends before the range starts (a length, less the
  // shard's first row `start`, is clamped to pos).  Range 0 of a launch with
  // a self term stages the current token's key and value as one more row.
  const int self_here = (k_new != nullptr && split == 0) ? 1 : 0;
  const int len = lens == nullptr ? pos : min(lens[b] - start, pos);
  const int n_cache = self_here ? max(0, min(range, len - t0)) : min(range, len - t0);
  const int n = n_cache + self_here;
  // Partials go to `part`: always in partials mode, else when ranges merge.
  const bool to_part = partial || n_split > 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long bh0 = static_cast<long long>(b) * n_heads + kh * g_heads;
  const long long bh_total = static_cast<long long>(gridDim.x) * g_heads;
  if (n <= 0) {  // uniform over the block: every thread leaves here
    if (!to_part) {  // a row of length 0 without a self term (outside the contract): zeros
      for (int o = tid; o < g_heads * DH; o += kThreads) {
        out[bh0 * DH + o] = Vec<T>::from_float(0.0f);
      }
      return;
    }
    for (int o = tid; o < g_heads * DH; o += kThreads) {
      part[(split * bh_total + bh0) * DH + o] = 0.0f;
    }
    if (tid < g_heads) {
      float* ml = part + n_split * bh_total * DH + (split * bh_total + bh0 + tid) * 2;
      ml[0] = kNegInf;
      ml[1] = 0.0f;
    }
    return;
  }
  const int n_pad = (n + 15) / 16 * 16;

  // (0) the range's key rows, then its value rows, all in flight.
  const long long row = static_cast<long long>(n_kv) * DH;  // elements between keys
  const long long head0 = (static_cast<long long>(b) * seq + t0) * row + kh * DH;
  const long long self0 = (static_cast<long long>(b) * n_kv + kh) * DH;
  for (int i = tid; i < n_cache * C; i += kThreads) {
    cp_async16(k_s + tile_chunk<T, C>(i / C, i % C) * 16, k + head0 + (i / C) * row + (i % C) * E);
  }
  if (self_here) {
    for (int c = tid; c < C; c += kThreads) {
      cp_async16(k_s + tile_chunk<T, C>(n_cache, c) * 16, k_new + self0 + c * E);
    }
  }
  cp_async_commit();
  for (int i = tid; i < n_cache * C; i += kThreads) {
    cp_async16(v_s + tile_chunk<T, C>(i / C, i % C) * 16, v + head0 + (i / C) * row + (i % C) * E);
  }
  if (self_here) {
    for (int c = tid; c < C; c += kThreads) {
      cp_async16(v_s + tile_chunk<T, C>(n_cache, c) * 16, v_new + self0 + c * E);
    }
  }
  cp_async_commit();

  const T* qb = q + bh0 * DH;
  if constexpr (kMma<T>) {
    for (int i = tid; i < g_heads * C; i += kThreads) {
      *reinterpret_cast<int4*>(q_s + ((i / C) * (DH + 8) + (i % C) * E) * 2) =
          *reinterpret_cast<const int4*>(qb + i * E);
    }
    // Value rows [n, n_pad) are zero: p.v reads them with p = 0.
    for (int i = tid; i < (n_pad - n) * C; i += kThreads) {
      *reinterpret_cast<int4*>(v_s + tile_chunk<T, C>(n + i / C, i % C) * 16) =
          make_int4(0, 0, 0, 0);
    }
  } else {
    float* qf = reinterpret_cast<float*>(q_s);
    for (int i = tid; i < g_heads * DH; i += kThreads) qf[i] = Vec<T>::to_float(qb[i]);
  }
  cp_async_wait<1>();
  __syncthreads();

  // (1) scores s[g][j] = q_g . k_j * scale.
  if constexpr (kMma<T>) {
    // Warp w takes the 8-key tiles w, w + 8, ...: rows g < G of an m16n8k16
    // product over dh in 16-wide steps (rows 8..15 and g >= G are zero).
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const unsigned* qw = reinterpret_cast<const unsigned*>(q_s) + gid * (DH + 8) / 2;
    for (int t = warp; t < (n + 7) / 8; t += kWarps) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int j = t * 8 + gid;
#pragma unroll
      for (int st = 0; st < C / 2; ++st) {
        unsigned a[4] = {0u, 0u, 0u, 0u};
        if (gid < g_heads) {
          a[0] = qw[8 * st + tig];
          a[2] = qw[8 * st + 4 + tig];
        }
        const unsigned b0 =
            *reinterpret_cast<const unsigned*>(k_s + tile_chunk<T, C>(j, 2 * st) * 16 + tig * 4);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(
            k_s + tile_chunk<T, C>(j, 2 * st + 1) * 16 + tig * 4);
        mma_bf16(acc, a, b0, b1);
      }
      const int j0 = t * 8 + 2 * tig;
      if (gid < g_heads) {
        if (j0 < n) p_s[gid * lay.p_stride + j0] = acc[0] * scale;
        if (j0 + 1 < n) p_s[gid * lay.p_stride + j0 + 1] = acc[1] * scale;
      }
    }
  } else {
    // LG lanes a key row, each lane CPT chunks of it, reduced by shuffles.
    constexpr int LG = C < 8 ? C : 8;
    constexpr int CPT = C / LG;
    constexpr int NG = kThreads / LG;  // key rows scored at once
    const float* qf = reinterpret_cast<const float*>(q_s);
    const int grp = tid / LG;
    const int gl = tid % LG;
    const int iters = (n + NG - 1) / NG;  // uniform: every lane reaches the shuffles
    for (int it = 0; it < iters; ++it) {
      const int j = grp + it * NG;
      const bool valid = j < n;
      float part_s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part_s[g] = 0.0f;
      if (valid) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int chunk = gl + c * LG;
          float x[E];
          Vec<T>::unpack(*reinterpret_cast<const int4*>(k_s + (j * C + chunk) * 16), x);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < g_heads) {
              const float4* qv = reinterpret_cast<const float4*>(qf + g * DH + chunk * E);
#pragma unroll
              for (int e4 = 0; e4 < E / 4; ++e4) {
                const float4 qq = qv[e4];
                part_s[g] += qq.x * x[4 * e4] + qq.y * x[4 * e4 + 1] +
                             qq.z * x[4 * e4 + 2] + qq.w * x[4 * e4 + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < g_heads) {  // g_heads is uniform: no lane diverges
#pragma unroll
          for (int off = LG / 2; off > 0; off >>= 1) {
            part_s[g] += __shfl_xor_sync(kFull, part_s[g], off);
          }
        }
      }
      if (gl == 0 && valid) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < g_heads) p_s[g * lay.p_stride + j] = part_s[g] * scale;
        }
      }
    }
  }
  __syncthreads();

  // (2) the range's softmax statistics: warp g owns query row g.
  if (warp < g_heads) {
    float* pg = p_s + warp * lay.p_stride;
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pg[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(pg[j] - mx);
      pg[j] = p;
      sum += p;
    }
    if constexpr (kMma<T>) {
      for (int j = n + lane; j < n_pad; j += 32) pg[j] = 0.0f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      m_s[warp] = mx;
      l_s[warp] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // (3) acc[g][d] = sum_j p[g][j] v[j][d].
  if constexpr (kMma<T>) {
    // Warp w takes the 16-column pairs of 8-column tiles w, w + 8, ... over
    // all keys in 16-deep steps; p enters as hi and lo bf16 halves.
    constexpr int PAIRS = C / 2;
    constexpr int PPW = (PAIRS + kWarps - 1) / kWarps;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    float acc[PPW][2][4];
#pragma unroll
    for (int pp = 0; pp < PPW; ++pp)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pp][h][e] = 0.0f;
    const float* pg = p_s + gid * lay.p_stride;
    for (int kk = 0; kk < n_pad; kk += 16) {
      unsigned hi[4] = {0u, 0u, 0u, 0u};
      unsigned lo[4] = {0u, 0u, 0u, 0u};
      if (gid < g_heads) {
        split_bf16(*reinterpret_cast<const float2*>(pg + kk + 2 * tig), hi[0], lo[0]);
        split_bf16(*reinterpret_cast<const float2*>(pg + kk + 8 + 2 * tig), hi[2], lo[2]);
      }
#pragma unroll
      for (int pp = 0; pp < PPW; ++pp) {
        const int pair = warp + pp * kWarps;
        if (pair < PAIRS) {  // uniform over the warp
          const int mtx = lane >> 3;
          unsigned bv[4];
          ldmatrix_x4_trans(bv, v_s + tile_chunk<T, C>(kk + (lane & 7) + 8 * (mtx & 1),
                                                       2 * pair + (mtx >> 1)) * 16);
          mma_bf16(acc[pp][0], hi, bv[0], bv[1]);
          mma_bf16(acc[pp][0], lo, bv[0], bv[1]);
          mma_bf16(acc[pp][1], hi, bv[2], bv[3]);
          mma_bf16(acc[pp][1], lo, bv[2], bv[3]);
        }
      }
    }
    if (gid < g_heads) {
      const float l = fmaxf(l_s[gid], 1e-30f);
#pragma unroll
      for (int pp = 0; pp < PPW; ++pp) {
        const int pair = warp + pp * kWarps;
        if (pair >= PAIRS) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = (2 * pair + h) * 8 + 2 * tig;
          if (!to_part) {
            *reinterpret_cast<__nv_bfloat162*>(out + (bh0 + gid) * DH + d) =
                __floats2bfloat162_rn(acc[pp][h][0] / l, acc[pp][h][1] / l);
          } else {
            *reinterpret_cast<float2*>(part + (split * bh_total + bh0 + gid) * DH + d) =
                make_float2(acc[pp][h][0], acc[pp][h][1]);
          }
        }
      }
    }
  } else {
    // Thread (subset ks, row g, chunk c) sums the keys j = ks, ks + KS, ...
    // of its chunk; the subsets are then summed in order.
    float* red_s = reinterpret_cast<float*>(smem);  // the key tile is done with
    const int items = g_heads * C;
    const int n_sub = pv_subsets(g_heads, C);
    for (int idx = tid; idx < items * n_sub; idx += kThreads) {
      const int ks = idx / items;
      const int w = idx - ks * items;
      const int g = w / C;
      const int c = w % C;
      const float* pg = p_s + g * lay.p_stride;
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.0f;
      for (int j = ks; j < n; j += n_sub) {
        const float p = pg[j];
        float x[E];
        Vec<T>::unpack(*reinterpret_cast<const int4*>(v_s + (j * C + c) * 16), x);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += p * x[e];
      }
      float4* dst = reinterpret_cast<float4*>(red_s + (ks * g_heads + g) * DH + c * E);
#pragma unroll
      for (int e4 = 0; e4 < E / 4; ++e4) {
        dst[e4] = make_float4(acc[4 * e4], acc[4 * e4 + 1], acc[4 * e4 + 2], acc[4 * e4 + 3]);
      }
    }
    __syncthreads();
    for (int o = tid; o < g_heads * DH; o += kThreads) {
      float a = 0.0f;
      for (int ks = 0; ks < n_sub; ++ks) a += red_s[ks * g_heads * DH + o];
      if (!to_part) {
        out[bh0 * DH + o] = Vec<T>::from_float(a / fmaxf(l_s[o / DH], 1e-30f));
      } else {
        part[(split * bh_total + bh0) * DH + o] = a;
      }
    }
  }
  if (to_part && tid < g_heads) {
    float* ml = part + n_split * bh_total * DH + (split * bh_total + bh0 + tid) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// One block per (batch, query head): merge the n_split partials in range
// order.  In partials mode (out_part set) the merged partial is written
// instead, unnormalised: acc, then the (m, l) pairs, the layout of `part`.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                            float* __restrict__ out_part, int n_split, int bh_total,
                            int d_head) {
  const int bh = blockIdx.x;
  const float* ml = part + static_cast<long long>(n_split) * bh_total * d_head;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) {
    mx = fmaxf(mx, ml[(static_cast<long long>(s) * bh_total + bh) * 2]);
  }
  float l = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float* x = ml + (static_cast<long long>(s) * bh_total + bh) * 2;
    l += expf(x[0] - mx) * x[1];
  }
  if (out_part != nullptr && threadIdx.x == 0) {
    out_part[static_cast<long long>(bh_total) * d_head + bh * 2] = mx;
    out_part[static_cast<long long>(bh_total) * d_head + bh * 2 + 1] = l;
  }
  l = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < d_head; d += kCombineThreads) {
    float a = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const long long r = static_cast<long long>(s) * bh_total + bh;
      a += expf(ml[r * 2] - mx) * part[r * d_head + d];
    }
    if (out_part != nullptr) {
      out_part[static_cast<long long>(bh) * d_head + d] = a;
    } else {
      out[static_cast<long long>(bh) * d_head + d] = Vec<T>::from_float(a / l);
    }
  }
}

template <typename T, int C>
int launch(const void* q, const void* k, const void* v, void* out, void* part, const int* lens,
           const void* k_new, const void* v_new, int batch, int n_heads, int n_kv, int seq,
           int d_head, int pos, int start, int n_split, int range, bool partial, float scale,
           cudaStream_t stream) {
  const Layout lay(range + (k_new != nullptr), C, Vec<T>::E, n_heads / n_kv, kMma<T>);
  if (lay.total > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (lay.total > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(lay.total));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid(batch * n_kv, n_split);
  // In partials mode `out` is the f32 partial; one range writes it directly.
  float* split_part = static_cast<float*>(partial && n_split == 1 ? out : part);
  flash_decode_split_kernel<T, C><<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), split_part, lens, static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), n_heads, n_kv, seq, pos, start, range, partial, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  flash_decode_combine_kernel<T><<<batch * n_heads, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out),
      partial ? static_cast<float*>(out) : nullptr, n_split, batch * n_heads, d_head);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dtype(const void* q, const void* k, const void* v, void* out, void* part,
                     const int* lens, const void* k_new, const void* v_new, int batch,
                     int n_heads, int n_kv, int seq, int d_head, int pos, int start, int n_split,
                     int range, bool partial, float scale, cudaStream_t stream) {
#define REPRO_FD_CASE(CC)                                                                 \
  case CC:                                                                                \
    return launch<T, CC>(q, k, v, out, part, lens, k_new, v_new, batch, n_heads, n_kv, seq, \
                         d_head, pos, start, n_split, range, partial, scale, stream);
  switch (d_head / Vec<T>::E) {
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
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (B, H, dh); k, v (B, S, KV, dh) with
// `seq` rows between batch rows (S, or a larger cache's S where k and v are
// a slice of its rows, a sequence shard); out (B, H, dh); part: n_split * B * H * (dh + 2) f32 of scratch when
// n_split > 1 (partial accumulators, then (m, l) pairs); lens: nullptr, or
// (B,) int32 per-row lengths on the device, row b's keys [0, lens[b] -
// start) clamped to [0, pos] (pos their maximum); k_new, v_new: nullptr, or
// the current token's key and value (B, KV, dh), a self term folded into the
// softmax of range 0.  partial = 1: out is the f32 partial (B * H * dh
// unnormalised accumulators, then B * H (m, l) pairs; an empty row gives
// m = -1e30, l = 0), for a merge across sequence shards.
// The keys [0, pos) are cut into n_split ranges of `range` keys, the last one
// shorter and none empty (a row shorter than pos leaves its later ranges
// empty); pos = 0 (one range) is taken with a self term or in partials
// mode.  The wrapper checks shapes, G <= 8, 0 <= pos <= S, and that dh is
// 2..64 16-byte chunks, a power of two.  Launches the split kernel, and the
// combine kernel when n_split > 1; returns the first CUDA error.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   void* out, void* part, const int* lens, const void* k_new,
                                   const void* v_new, int batch, int n_heads, int n_kv, int seq,
                                   int d_head, int pos, int start, int n_split, int range,
                                   int partial, float scale, int dtype, void* stream) {
  const bool empty_ok = k_new != nullptr || partial != 0;
  const bool split_ok =
      pos == 0 ? (empty_ok && n_split == 1)
               : (static_cast<long long>(n_split - 1) * range < pos &&
                  static_cast<long long>(n_split) * range >= pos);
  if (n_split < 1 || n_split > 65535 || range < 1 || pos < 0 || !split_ok ||
      (n_split > 1 && part == nullptr) || ((k_new == nullptr) != (v_new == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_for_dtype<float>(q, k, v, out, part, lens, k_new, v_new, batch, n_heads, n_kv,
                                   seq, d_head, pos, start, n_split, range, partial != 0, scale,
                                   s);
  }
  if (dtype == 1) {
    return launch_for_dtype<__nv_bfloat16>(q, k, v, out, part, lens, k_new, v_new, batch,
                                           n_heads, n_kv, seq, d_head, pos, start, n_split,
                                           range, partial != 0, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
