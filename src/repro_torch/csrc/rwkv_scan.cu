// rwkv_scan: the WKV-6 recurrence of the RWKV-6 (Finch) time mix, from a
// zero state:  y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]),
//              S[i][j] <- S[i][j] w_t[i] + k_t[i] v_t[j].
//
// Replaces repro/kernels/rwkv_scan.py::_rwkv_kernel.  That kernel walks T in
// chunks on a sequential grid axis only to keep the dh x dh state in VMEM
// scratch between grid steps.  Here a block loops over the whole of T
// itself, so its part of the state never leaves the SM and T may take any
// length (the TPU kernel needs T % chunk == 0).
//
// Bound on the H100: at the serving shape (B 1, T 2048, H 40, dh 64, f32)
// the bytes (r, k, v, w read once, y written once: ~105 MB) bound it at
// 0.0315 ms; the f32 operations the function needs (5 a state element a
// step: ~1.7 GFLOP) at a little less.  A step depends on the last, so what
// holds a kernel back is the length of each thread's chain of dependent
// steps and how few warps there are to hide it.  The first design (one
// block of dh threads per (b, h), thread j walking all dh rows of column j,
// four operations an element) took 1.625 ms there, 40 blocks on 40 SMs.
//
// Design.  It rests on three properties of the recurrence:
// - State columns are independent: S[:, j] needs only v_j and the shared
//   r, k, w.  A block takes one (b, h, group of KC columns): the wrapper
//   (kernels/rwkv_scan.py::column_plan) takes KC = 16, 24 or 32, whichever
//   puts the fewest blocks on the busiest SM, the narrowest on a tie: 24
//   at the serving shape, 120 blocks, one an SM, each of 3 walking warps
//   and a producer, one warp a scheduler.  (With 16, 160 blocks put two on
//   28 SMs, which then set the pace; with 32, the producer shares a
//   scheduler with a walking warp and holds each barrier back.)  The blocks
//   of a head each read the same r, k, w: L2 traffic, not HBM traffic.
// - Rows and columns both split: a thread holds a 4-row x 4-column tile of
//   the state in registers, so each step it reads r, k, w for 4 rows and v
//   for 4 columns from shared memory, 4 bytes an element updated.  (One
//   column of 8 or 16 rows a thread read 12.5 bytes an element; shared
//   memory delivers 128 bytes a clock to an SM, and that bound the walk.)
//   The RS = DH / 4 threads of a column group split the rows; a block has
//   KC / 4 * RS column threads (96 at dh 64 and KC 24).
// - The u term factors out: y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i.
//   The block computes the scalar ruk_t = sum_i r_i u_i k_i once per step
//   into shared memory.  A state element then costs k v, one FMA into y and
//   one FMA for S w + k v.
// y is summed over the RS threads of a column group once per group of 8
// steps: each holds its rows' part of y for 8 steps x 4 columns, and a
// reduce-scatter over the RS lanes (4 or 5 levels of shuffles for the 32
// values) leaves each lane with whole y to store (2 at dh 64).
// A producer warp beside the column threads copies chunks of CH steps of
// r, k, w (all rows) and v (the block's columns) with cp.async into three
// shared stages, in the input dtype, two chunks ahead of the walk; once a
// chunk has landed it computes the chunk's ruk, so neither the copies nor
// ruk hold up the walk (when the column threads did them between chunks,
// each held it up).  One barrier a chunk hands the stages round.
// dh is padded to DH (64 or 128) with zero r, k and w, which leave the
// padded rows of S at zero and add nothing to y; the columns past dh are
// never written.  y is written in the input dtype (one rounding of the f32
// sum); the final state is written [k_idx][v_idx] in f32.  The wrapper
// passes 16-byte aligned tensors whose rows are a whole number of 16-byte
// pieces (it pads dh where they are not).
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W) at the serving shape:
// 0.1488 ms a launch, against 1.625 ms for the first design.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTile = 4;           // a thread's state tile: kTile rows x kTile columns
constexpr int kGroup = 8;          // steps whose y one reduce-scatter sums
constexpr int kStages = 3;         // chunks staged at once: walked, landed, in flight
constexpr int kChunkElems = 2048;  // CH * DH: steps a stage holds times the padded width
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements per 16-byte copy
  __device__ static void load4(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
  __device__ static float to_f32(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
  __device__ static float zero() { return 0.0f; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load4(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  }
  __device__ static float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16(0.0f); }
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

// Reduce-scatter of N values a lane over the lanes that differ in bits
// BIT, BIT / 2, ..., 1 of rs: at each level a lane keeps the half of its
// values its lane bit selects (HALF of them) and adds its partner's; once
// one value is left, the remaining levels add it across lanes.  Value
// number rs / (lanes / N) ends in yv[0].
template <int BIT, int HALF, int N>
__device__ __forceinline__ void reduce_scatter(float (&yv)[N], int rs) {
  if constexpr (HALF >= 1) {
    const bool up = rs & BIT;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float keep = up ? yv[i + HALF] : yv[i];
      const float send = up ? yv[i] : yv[i + HALF];
      yv[i] = keep + __shfl_xor_sync(kFull, send, BIT);
    }
  } else {
    yv[0] += __shfl_xor_sync(kFull, yv[0], BIT);
  }
  if constexpr (BIT > 1) reduce_scatter<BIT / 2, HALF / 2>(yv, rs);
}

// KC = state columns a block owns (16, 24 or 32, chosen by the wrapper).
template <int DH, int KC, typename T>
struct Shape {
  static constexpr int RS = DH / kTile;                 // threads a column group's rows split over
  static constexpr int NC = KC / kTile * RS;            // column threads (the walk)
  static constexpr int kThreads = NC + 32;              // and one producer warp
  static constexpr int CH = kChunkElems / DH;           // steps a stage holds
  static constexpr int NVAL = kGroup * kTile;           // y parts a thread holds per group
  // After a group's reduce-scatter each thread holds VPL whole y, the same
  // as LPS - 1 other threads of its column group.
  static constexpr int VPL = NVAL >= RS ? NVAL / RS : 1;
  static constexpr int LPS = RS >= NVAL ? RS / NVAL : 1;
  static constexpr int kStage = 3 * CH * DH + CH * KC;  // r, k, w [CH][DH]; v [CH][KC]
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(T)) +
                               (DH + kStages * CH) * static_cast<int>(sizeof(float));
  static_assert(NC % 32 == 0 && KC % kTile == 0 && CH <= 32 && 32 % CH == 0, "block shape");
  static_assert(CH % kGroup == 0 && RS <= 32 && (NVAL % RS == 0 || RS % NVAL == 0),
                "groups and lanes");
};

template <int DH, int KC, typename T>
__global__ void __launch_bounds__(Shape<DH, KC, T>::kThreads)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, T* __restrict__ y,
                 float* __restrict__ state, int n_steps, int n_heads, int dh) {
  using S = Shape<DH, KC, T>;
  constexpr int RS = S::RS, NC = S::NC, NT = S::kThreads, CH = S::CH;
  constexpr int NVAL = S::NVAL, VPL = S::VPL, LPS = S::LPS;
  constexpr int VW = Vec<T>::N;     // elements a 16-byte copy
  constexpr int TPS = 32 / CH;      // producer lanes a step's ruk
  constexpr int RPS = DH / TPS;     // rows each of them sums

  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  float* u_s = reinterpret_cast<float*>(smem + kStages * S::kStage * sizeof(T));
  float* ruk_s = u_s + DH;  // [kStages][CH]

  const int n_groups = (dh + KC - 1) / KC;
  const int bh = blockIdx.x / n_groups;  // b * n_heads + h
  const int c0 = (blockIdx.x - bh * n_groups) * KC;
  const int ncols = min(KC, dh - c0);
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(n_heads) * dh;  // elements between steps
  const long long base = (static_cast<long long>(b) * n_steps * n_heads + h) * dh;

  // Zero what no copy writes: rows [dh, DH) of r, k, w, columns [ncols,
  // KC) of v, in every stage.
  if (dh < DH || ncols < KC) {
    for (int i = tid; i < kStages * S::kStage; i += NT) {
      const int e = i % S::kStage;
      const bool pad = e < 3 * CH * DH ? e % DH >= dh : (e - 3 * CH * DH) % KC >= ncols;
      if (pad) stage[i] = Vec<T>::zero();
    }
  }
  for (int i = tid; i < DH; i += NT) u_s[i] = i < dh ? u[h * dh + i] : 0.0f;
  __syncthreads();

  const int n_chunks = (n_steps + CH - 1) / CH;
  if (tid >= NC) {
    // The producer warp: copies chunk ci + 2 while the column threads walk
    // chunk ci, then computes chunk ci + 1's ruk from its landed copy.
    const int lane = tid - NC;
    const int row_pieces = dh * static_cast<int>(sizeof(T)) / 16;
    const int col_pieces = ncols * static_cast<int>(sizeof(T)) / 16;
    auto copy_chunk = [&](int ci) {  // one commit group, empty past the last chunk
      if (ci < n_chunks) {
        const int t0 = ci * CH;
        const int n = min(CH, n_steps - t0);
        T* st = stage + (ci % kStages) * S::kStage;
        // Lane takes pieces lane, lane + 32, ...: step c, piece p.
        for (int c = lane / row_pieces, p = lane % row_pieces; c < n;) {
          const long long off = base + (t0 + c) * row + p * VW;
          cp_async16(st + c * DH + p * VW, r + off);
          cp_async16(st + (CH + c) * DH + p * VW, k + off);
          cp_async16(st + (2 * CH + c) * DH + p * VW, w + off);
          c += 32 / row_pieces;
          p += 32 % row_pieces;
          if (p >= row_pieces) {
            p -= row_pieces;
            ++c;
          }
        }
        for (int c = lane / col_pieces, p = lane % col_pieces; c < n;) {
          cp_async16(st + 3 * CH * DH + c * KC + p * VW, v + base + (t0 + c) * row + c0 + p * VW);
          c += 32 / col_pieces;
          p += 32 % col_pieces;
          if (p >= col_pieces) {
            p -= col_pieces;
            ++c;
          }
        }
      }
      cp_async_commit();
    };
    // ruk of chunk ci, step c = sum_i r_i u_i k_i: TPS lanes a step, RPS
    // rows each, four at a time in a rotated order (no bank conflict).
    auto ruk = [&](int ci) {
      if (ci >= n_chunks) return;
      const T* cur = stage + (ci % kStages) * S::kStage;
      const int c = lane / TPS;
      const int seg = (lane % TPS) * RPS;
      const T* rr = cur + c * DH + seg;
      const T* kk = cur + (CH + c) * DH + seg;
      float a = 0.0f;
#pragma unroll 4
      for (int q = 0; q < RPS / 4; ++q) {
        const int i = (q + lane) % (RPS / 4) * 4;
        float rv[4], kv[4];
        Vec<T>::load4(rr + i, rv);
        Vec<T>::load4(kk + i, kv);
        const float4 uv = *reinterpret_cast<const float4*>(u_s + seg + i);
        a = fmaf(rv[0], uv.x * kv[0], a);
        a = fmaf(rv[1], uv.y * kv[1], a);
        a = fmaf(rv[2], uv.z * kv[2], a);
        a = fmaf(rv[3], uv.w * kv[3], a);
      }
#pragma unroll
      for (int off = 1; off < TPS; off <<= 1) a += __shfl_xor_sync(kFull, a, off);
      if (lane % TPS == 0) ruk_s[(ci % kStages) * CH + c] = a;
    };
    copy_chunk(0);
    copy_chunk(1);
    cp_async_wait<1>();
    __syncwarp();
    ruk(0);
    __syncthreads();
    for (int ci = 0; ci < n_chunks; ++ci) {
      copy_chunk(ci + 2);  // into the stage chunk ci - 1 left
      cp_async_wait<1>();
      __syncwarp();
      ruk(ci + 1);
      __syncthreads();
    }
    return;
  }

  // The column threads: thread (cg, rs) holds S[rs * 4 + e][c0 + cg * 4 + cc].
  const int cg = tid / RS;
  const int rs = tid % RS;
  float s[kTile][kTile];
#pragma unroll
  for (int e = 0; e < kTile; ++e)
#pragma unroll
    for (int cc = 0; cc < kTile; ++cc) s[e][cc] = 0.0f;

  // A group's reduce-scatter leaves thread rs the whole y of (step, column)
  // numbers mine .. mine + VPL - 1 of the group; one of the LPS threads
  // that hold the same ones stores them.
  const int mine = rs / LPS * VPL;
  const bool storer = rs % LPS == 0;
  T* yb = y + base + c0;
  __syncthreads();  // chunk 0 and its ruk are in
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * CH;
    const int n = min(CH, n_steps - t0);
    const T* cur = stage + (ci % kStages) * S::kStage;
    const float* ruk = ruk_s + (ci % kStages) * CH;

    // Walk kGroup steps from step c; `ragged` (the chunk's last, short
    // group) skips the steps past n.
    auto walk = [&](int c, auto ragged) {
      float yv[NVAL];
#pragma unroll
      for (int st = 0; st < kGroup; ++st) {
        const int cs = c + st;
        bool live = true;
        if constexpr (decltype(ragged)::value) live = cs < n;  // uniform over the block
        if (live) {
          float rv[kTile], kv[kTile], wv[kTile], vv[kTile];
          Vec<T>::load4(cur + cs * DH + rs * kTile, rv);
          Vec<T>::load4(cur + (CH + cs) * DH + rs * kTile, kv);
          Vec<T>::load4(cur + (2 * CH + cs) * DH + rs * kTile, wv);
          Vec<T>::load4(cur + 3 * CH * DH + cs * KC + cg * kTile, vv);
#pragma unroll
          for (int cc = 0; cc < kTile; ++cc) {
            float a = rv[0] * s[0][cc];
#pragma unroll
            for (int e = 1; e < kTile; ++e) a = fmaf(rv[e], s[e][cc], a);
            yv[st * kTile + cc] = a;
#pragma unroll
            for (int e = 0; e < kTile; ++e) s[e][cc] = fmaf(s[e][cc], wv[e], kv[e] * vv[cc]);
          }
        } else {
#pragma unroll
          for (int cc = 0; cc < kTile; ++cc) yv[st * kTile + cc] = 0.0f;
        }
      }
      reduce_scatter<RS / 2, NVAL / 2>(yv, rs);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int cs = c + (mine + j) / kTile;
        const int jl = cg * kTile + (mine + j) % kTile;
        bool live = storer && jl < ncols;
        if constexpr (decltype(ragged)::value) live = live && cs < n;
        if (live) {
          Vec<T>::store(yb + (t0 + cs) * row + jl,
                        fmaf(Vec<T>::to_f32(cur[3 * CH * DH + cs * KC + jl]), ruk[cs], yv[j]));
        }
      }
    };
    int c = 0;
    for (; c + kGroup <= n; c += kGroup) walk(c, std::false_type{});
    if (c < n) walk(c, std::true_type{});
    __syncthreads();  // chunk ci is done with; chunk ci + 1 and its ruk are in
  }

  float* out = state + static_cast<long long>(bh) * dh * dh + c0 + cg * kTile;
#pragma unroll
  for (int e = 0; e < kTile; ++e) {
#pragma unroll
    for (int cc = 0; cc < kTile; ++cc) {
      const int i = rs * kTile + e;
      if (i < dh && cg * kTile + cc < ncols) out[static_cast<long long>(i) * dh + cc] = s[e][cc];
    }
  }
}

template <int DH, int KC, typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           void* y, float* state, int batch, int n_steps, int n_heads, int dh,
           cudaStream_t stream) {
  using S = Shape<DH, KC, T>;
  if (S::kSmem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        rwkv_scan_kernel<DH, KC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const int blocks = batch * n_heads * ((dh + KC - 1) / KC);
  rwkv_scan_kernel<DH, KC, T><<<blocks, S::kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, static_cast<T*>(y), state, n_steps, n_heads, dh);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename T>
int launch_cols(const void* r, const void* k, const void* v, const void* w, const float* u,
                void* y, float* state, int batch, int n_steps, int n_heads, int dh, int cols,
                cudaStream_t stream) {
  switch (cols) {
    case 16:
      return launch<DH, 16, T>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, stream);
    case 24:
      return launch<DH, 24, T>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, stream);
    case 32:
      return launch<DH, 32, T>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_shape(const void* r, const void* k, const void* v, const void* w, const float* u,
                 void* y, float* state, int batch, int n_steps, int n_heads, int dh,
                 int cols, cudaStream_t stream) {
  if (dh <= 64) {
    return launch_cols<64, T>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, cols,
                              stream);
  }
  return launch_cols<128, T>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, cols,
                             stream);
}

}  // namespace

// r, k, v, w, y: (batch, n_steps, n_heads, dh) in f32 (dtype 0) or bf16
// (dtype 1), 16-byte aligned, dh * element size a multiple of 16; u:
// (n_heads, dh) f32; state: (batch, n_heads, dh, dh) f32.  1 <= dh <= 128
// (the wrapper checks); cols, the state columns a block owns, is 16, 24 or
// 32.
// Returns cudaGetLastError().
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const void* w, const float* u, void* y, float* state,
                                int batch, int n_steps, int n_heads, int dh, int cols,
                                int dtype, void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  if (dh < 1 || dh > 128 || dh * es % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || n_heads <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_shape<__nv_bfloat16>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh,
                                       cols, st);
  }
  return launch_shape<float>(r, k, v, w, u, y, state, batch, n_steps, n_heads, dh, cols, st);
}
