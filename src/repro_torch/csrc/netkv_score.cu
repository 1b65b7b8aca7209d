// netkv_score_cohort: Algorithm 1's scoring pass, Eq. (2)-(7), plus the
// first and second (cost, index) minimum, for R cohort rows against one
// D-wide pool snapshot.
//
// Replaces repro/kernels/netkv_score.py::_score_cohort_kernel.
//
// Bound on the H100: bytes, and in practice the launch.  At R = 1, D = 2048
// (one decision) the kernel reads ~41 KB and writes 8 KB of costs, 19.6 ns
// at 3.35 TB/s; some 25 f32 operations a lane.  No launch gets near that, so
// the design spends as few serial steps as it can after the launch:
//   * one thread block cluster per row (the host's ``score_plan``, in
//     kernels/netkv_score.py, picks C in {1, 2, 4, 8} blocks and the block
//     width), so at D 2048 each of
//     8 x 256 threads scores one lane instead of one SM walking all 2048;
//   * each thread keeps the lexicographic top-2 of its (cost, index) pairs,
//     a warp merges them with shuffles, the block's warps through shared
//     memory, and the cluster's blocks through distributed shared memory:
//     rank 0's first warp reads every rank's partial (lane k reads rank k)
//     and merges them with shuffles;
//   * rank 0 writes one packed result row, (best, best cost, second, second
//     cost), so the host copies 16 bytes back a row and not the cost row.
// The top-2 of a set under a strict order is one set whatever the order of
// the merges, so two calls are bitwise equal and the lower index wins a tie
// (np.argmin's first minimum).  ``second`` is the first minimum with ``best``
// left out, -1 when D is 1 or its cost is not below BIG / 2: the runner-up a
// decision's forensics row records.
//
// Bitwise parity.  The host re-derives feasibility from these costs, so they
// must equal the f32 NumPy twin (netkv_score.py::_netkv_score_cohort_np) bit
// for bit.  Every expression below keeps the twin's operation order; the
// file is compiled with --fmad=false so no a*b+c is contracted into an FMA,
// and without fast math so division stays IEEE.  The twin's one-hot tier sum
// equals the gather bt[tier] here exactly (adding products with 0 is exact),
// and bt is (bw * (1 - c)) / (1 + infl), in that order.  Each row is computed
// the same way whatever R and the plan are, so row i equals a single-row call.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  float bw[4];
  float lat[4];
  float cong[4];
  float iter_a, iter_b, m_min, beta_max;
};

// The two least (cost, index) pairs seen, first < second; (+inf, d_pool)
// stands for none.
struct Top2 {
  float c1;
  int i1;
  float c2;
  int i2;
};

__device__ __forceinline__ bool before(float ca, int ia, float cb, int ib) {
  return ca < cb || (ca == cb && ia < ib);
}

__device__ __forceinline__ void push(Top2& t, float c, int i) {
  if (before(c, i, t.c1, t.i1)) {
    t.c2 = t.c1;
    t.i2 = t.i1;
    t.c1 = c;
    t.i1 = i;
  } else if (before(c, i, t.c2, t.i2)) {
    t.c2 = c;
    t.i2 = i;
  }
}

// t := the top-2 of t and o together.
__device__ __forceinline__ void merge(Top2& t, const Top2& o) {
  if (before(o.c1, o.i1, t.c1, t.i1)) {
    const bool keep = before(t.c1, t.i1, o.c2, o.i2);
    t.c2 = keep ? t.c1 : o.c2;
    t.i2 = keep ? t.i1 : o.i2;
    t.c1 = o.c1;
    t.i1 = o.i1;
  } else if (before(o.c1, o.i1, t.c2, t.i2)) {
    t.c2 = o.c1;
    t.i2 = o.i1;
  }
}

// Every lane of the warp ends with the warp's top-2.
__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.c1 = __shfl_xor_sync(kFull, t.c1, off);
    o.i1 = __shfl_xor_sync(kFull, t.i1, off);
    o.c2 = __shfl_xor_sync(kFull, t.c2, off);
    o.i2 = __shfl_xor_sync(kFull, t.i2, off);
    merge(t, o);
  }
  return t;
}

__device__ __forceinline__ float pick4(int t, float a, float b, float c, float d) {
  return t == 0 ? a : t == 1 ? b : t == 2 ? c : t == 3 ? d : 0.0f;
}

// Grid: R clusters of C blocks, cluster r scores row r; block rank k of it
// takes lanes [k * span, min(D, (k + 1) * span)).
__global__ void __launch_bounds__(kMaxThreads)
netkv_score_cohort_kernel(const float* __restrict__ free_mem,
                          const float* __restrict__ queued,
                          const float* __restrict__ batch,
                          const float* __restrict__ hit_rows,
                          const int32_t* __restrict__ tier_rows,
                          const float* __restrict__ healthy,
                          const float* __restrict__ iter_scale,
                          const float* __restrict__ s_r,
                          const float* __restrict__ input_len,
                          const float* __restrict__ infl_rows, Params p,
                          int d_pool, int span, float* __restrict__ cost_rows,
                          int32_t* __restrict__ result) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.x / n_rank;
  const float sr = s_r[r];
  const float lr = input_len[r];
  const float lden = fmaxf(lr, 1.0f);
  // Eq. (4) per tier, for this row's self-contention counts.
  float bt[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    bt[t] = (p.bw[t] * (1.0f - p.cong[t])) / (1.0f + infl_rows[r * 4 + t]);
  }
  const float* hit = hit_rows + static_cast<long long>(r) * d_pool;
  const int32_t* tier = tier_rows + static_cast<long long>(r) * d_pool;
  float* cost = cost_rows + static_cast<long long>(r) * d_pool;

  const float inf = __int_as_float(0x7f800000);
  const Top2 none = {inf, d_pool, inf, d_pool};
  Top2 top = none;
  const int lo = rank * span;
  const int hi = min(d_pool, lo + span);
  for (int d = lo + threadIdx.x; d < hi; d += blockDim.x) {
    const float h = fminf(hit[d], lr);
    const float s_eff = sr * (1.0f - h / lden);                        // Eq. (2)
    const int t = tier[d];
    const float beff = pick4(t, bt[0], bt[1], bt[2], bt[3]);
    const float lat = pick4(t, p.lat[0], p.lat[1], p.lat[2], p.lat[3]);
    const float t_xfer = s_eff / fmaxf(beff, 1e-9f) + lat;             // Eq. (3)
    const float bat = batch[d];
    const float scl = iter_scale[d];
    const float t_iter = (p.iter_a + p.iter_b * bat) * scl;
    const float blocked = fmaxf(0.0f, queued[d] - (p.beta_max - bat));
    const float t_queue = blocked * t_iter;                            // Eq. (6)
    const float t_dec = (p.iter_a + p.iter_b * (bat + 1.0f)) * scl;    // Eq. (7)
    float c = t_xfer + t_queue + t_dec;                                // Eq. (5)
    const bool feasible = (healthy[d] > 0.5f) && (free_mem[d] >= s_eff + p.m_min);
    c = feasible ? c : kBig;
    cost[d] = c;
    push(top, c, d);
  }

  __shared__ Top2 warp_part[kMaxThreads / 32];
  __shared__ Top2 block_part;  // read by rank 0 through distributed shared memory
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  top = warp_top2(top);
  if (lane == 0) warp_part[warp] = top;
  __syncthreads();
  if (warp == 0) {
    top = warp_top2(lane < static_cast<int>(blockDim.x / 32) ? warp_part[lane] : none);
    if (lane == 0) block_part = top;
  }
  cluster.sync();  // every block's partial is written and visible to rank 0
  if (rank == 0 && warp == 0) {
    top = warp_top2(lane < n_rank ? *cluster.map_shared_rank(&block_part, lane) : none);
    if (lane == 0) {
      // A second lane exists when i2 < d_pool; like the forensics row, keep
      // it only when it is feasible (BIG / 2 compared in double, as there).
      const bool second = top.i2 < d_pool && static_cast<double>(top.c2) < 1.5e38;
      int4 row;
      row.x = top.i1;
      row.y = __float_as_int(top.c1);
      row.z = second ? top.i2 : -1;
      row.w = __float_as_int(top.c2);
      reinterpret_cast<int4*>(result)[r] = row;
    }
  }
  cluster.sync();  // no block leaves while rank 0 may still read its partial
}

}  // namespace

// Pool columns are (D,); hit/tier rows (R, D); s_r and input_len (R,);
// infl_rows (R, 4); ``params`` a host array of 16 floats: tier bandwidths,
// latencies and congestion (4 each), iter_a, iter_b, m_min, beta_max.  The
// plan: ``cluster`` blocks a row of ``threads`` threads, ``span`` lanes a
// block.  Writes cost_rows (R, D) and result (R, 4), 16-byte aligned.
extern "C" int netkv_score_cohort_launch(
    const float* free_mem, const float* queued, const float* batch,
    const float* hit_rows, const int32_t* tier_rows, const float* healthy,
    const float* iter_scale, const float* s_r, const float* input_len,
    const float* infl_rows, const float* params, int r_rows, int d_pool,
    int cluster, int threads, int span, float* cost_rows, int32_t* result,
    void* stream) {
  const bool pow2 = cluster > 0 && (cluster & (cluster - 1)) == 0;
  if (r_rows < 1 || d_pool < 1 || !pow2 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || span < 1 ||
      static_cast<long long>(cluster) * span < d_pool ||
      static_cast<long long>(r_rows) * cluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  for (int t = 0; t < 4; ++t) {
    p.bw[t] = params[t];
    p.lat[t] = params[4 + t];
    p.cong[t] = params[8 + t];
  }
  p.iter_a = params[12];
  p.iter_b = params[13];
  p.m_min = params[14];
  p.beta_max = params[15];

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(r_rows * cluster), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, netkv_score_cohort_kernel, free_mem, queued, batch, hit_rows,
      tier_rows, healthy, iter_scale, s_r, input_len, infl_rows, p, d_pool, span,
      cost_rows, result);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
