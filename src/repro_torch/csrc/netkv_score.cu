// netkv_score_cohort: Algorithm 1's scoring pass, Eq. (2)-(7), plus the
// masked argmin, for R cohort rows against one D-wide pool snapshot.
//
// Replaces repro/kernels/netkv_score.py::_score_cohort_kernel.
//
// Bound on the H100: bytes, and in practice the launch.  At R = 64, D = 2048
// the kernel reads ~1.6 MB and writes the (R, D) cost rows; the arithmetic is
// some 25 f32 operations a lane.  Design: one block per cohort row, threads
// striding over D, and a block argmin over (cost, index) pairs that keeps the
// lower index on ties (np.argmin's first minimum).
//
// Bitwise parity.  The host re-derives feasibility from these costs, so they
// must equal the f32 NumPy twin (netkv_score.py::_netkv_score_cohort_np) bit
// for bit.  Every expression below keeps the twin's operation order; the
// file is compiled with --fmad=false so no a*b+c is contracted into an FMA,
// and without fast math so division stays IEEE.  The twin's one-hot tier sum
// equals the gather bt[tier] here exactly (adding products with 0 is exact),
// and bt is (bw * (1 - c)) / (1 + infl), in that order.  Each row is computed
// the same way whatever R is, so row i equals a single-row call.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

struct TierTable {
  float bw[4];
  float lat[4];
  float cong[4];
};

__device__ __forceinline__ float pick4(int t, float a, float b, float c, float d) {
  return t == 0 ? a : t == 1 ? b : t == 2 ? c : t == 3 ? d : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
netkv_score_cohort_kernel(const float* __restrict__ free_mem,
                          const float* __restrict__ queued,
                          const float* __restrict__ batch,
                          const float* __restrict__ hit_rows,
                          const int32_t* __restrict__ tier_rows,
                          const float* __restrict__ healthy,
                          const float* __restrict__ iter_scale,
                          const float* __restrict__ s_r,
                          const float* __restrict__ input_len,
                          const float* __restrict__ infl_rows, TierTable tt,
                          float iter_a, float iter_b, float m_min, float beta_max,
                          int d_pool, float* __restrict__ cost_rows,
                          int32_t* __restrict__ best) {
  const int r = blockIdx.x;
  const float sr = s_r[r];
  const float lr = input_len[r];
  const float lden = fmaxf(lr, 1.0f);
  // Eq. (4) per tier, for this row's self-contention counts.
  float bt[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    bt[t] = (tt.bw[t] * (1.0f - tt.cong[t])) / (1.0f + infl_rows[r * 4 + t]);
  }
  const float* hit = hit_rows + static_cast<long long>(r) * d_pool;
  const int32_t* tier = tier_rows + static_cast<long long>(r) * d_pool;
  float* cost = cost_rows + static_cast<long long>(r) * d_pool;

  float best_c = __int_as_float(0x7f800000);  // +inf: any lane beats it
  int best_i = d_pool;
  for (int d = threadIdx.x; d < d_pool; d += kThreads) {
    const float h = fminf(hit[d], lr);
    const float s_eff = sr * (1.0f - h / lden);                        // Eq. (2)
    const int t = tier[d];
    const float beff = pick4(t, bt[0], bt[1], bt[2], bt[3]);
    const float lat = pick4(t, tt.lat[0], tt.lat[1], tt.lat[2], tt.lat[3]);
    const float t_xfer = s_eff / fmaxf(beff, 1e-9f) + lat;             // Eq. (3)
    const float bat = batch[d];
    const float scl = iter_scale[d];
    const float t_iter = (iter_a + iter_b * bat) * scl;
    const float blocked = fmaxf(0.0f, queued[d] - (beta_max - bat));
    const float t_queue = blocked * t_iter;                            // Eq. (6)
    const float t_dec = (iter_a + iter_b * (bat + 1.0f)) * scl;        // Eq. (7)
    float c = t_xfer + t_queue + t_dec;                                // Eq. (5)
    const bool feasible = (healthy[d] > 0.5f) && (free_mem[d] >= s_eff + m_min);
    c = feasible ? c : kBig;
    cost[d] = c;
    if (c < best_c) {  // d rises within a thread, so the first minimum stays
      best_c = c;
      best_i = d;
    }
  }

  // Block argmin over (cost, index): the lower index wins a tie.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, best_c, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (oc < best_c || (oc == best_c && oi < best_i)) {
      best_c = oc;
      best_i = oi;
    }
  }
  __shared__ float warp_c[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_c[warp] = best_c;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = warp_c[0];
    int i = warp_i[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      if (warp_c[w] < c || (warp_c[w] == c && warp_i[w] < i)) {
        c = warp_c[w];
        i = warp_i[w];
      }
    }
    best[r] = i;
  }
}

}  // namespace

// Pool columns are (D,); hit/tier rows (R, D); s_r and input_len (R,);
// infl_rows (R, 4); tier tables by value.  Writes cost_rows (R, D), best (R,).
extern "C" int netkv_score_cohort_launch(
    const float* free_mem, const float* queued, const float* batch,
    const float* hit_rows, const int32_t* tier_rows, const float* healthy,
    const float* iter_scale, const float* s_r, const float* input_len,
    const float* infl_rows, float bw0, float bw1, float bw2, float bw3,
    float lat0, float lat1, float lat2, float lat3, float cong0, float cong1,
    float cong2, float cong3, float iter_a, float iter_b, float m_min,
    float beta_max, int r_rows, int d_pool, float* cost_rows, int32_t* best,
    void* stream) {
  TierTable tt = {{bw0, bw1, bw2, bw3}, {lat0, lat1, lat2, lat3},
                  {cong0, cong1, cong2, cong3}};
  if (r_rows > 0) {
    netkv_score_cohort_kernel<<<r_rows, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        free_mem, queued, batch, hit_rows, tier_rows, healthy, iter_scale, s_r,
        input_len, infl_rows, tt, iter_a, iter_b, m_min, beta_max, d_pool,
        cost_rows, best);
  }
  return static_cast<int>(cudaGetLastError());
}
