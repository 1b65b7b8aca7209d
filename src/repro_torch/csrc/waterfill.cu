// Max-min fair water-filling, FlowPlane's fixed point, as two kernels that
// each run the whole round loop on the device.
//
//   waterfill_progressive  replaces repro/kernels/waterfill.py::
//                          _share_argmin_kernel (K5): one bottleneck link a
//                          round, with the round's (link, share) trace.
//   waterfill_fast         replaces repro/kernels/waterfill.py::
//                          _shares_kernel (K6): every level bottleneck a
//                          round, one block per scenario of a sweep step.
//
// The TPU kernels compute one round's shares (and K5's first minimum) inside
// a lax.while_loop that XLA keeps on the device.  Eager PyTorch has no such
// loop: a host loop around an elementwise kernel would read the unfixed
// count back every round.  So each kernel here is the whole loop, with the
// TPU kernel's computation as its inner step, and one launch per problem
// (K5) or per sweep step (K6).
//
// Bound on the H100: neither bytes nor operations.  At the sweep's shape
// (54 scenarios x 119 flows x 58 links) one K6 launch reads ~1.5 MB of hop
// tables and does a few rounds of block reductions; K5 runs one block over
// a few dozen flows.  Both are latency-bound: each round is a chain of
// __syncthreads-separated block reductions.  Design: one block per problem,
// the residual capacities, counts and per-flow state in shared memory, the
// hop tables read from device memory (L2-resident at these sizes).
//
// Numerics: f32, as the Pallas route (repro/kernels/waterfill.py:112, :238).
// K5's shares are single IEEE divisions and its capacity updates subtract
// the same share from every target, so the order of the atomic subtractions
// cannot change the result: K5 equals its plain version bit for bit.  K6
// sums rates over flows in flow order; the plain version's matrix product
// sums in another order, so the two agree to a tolerance.  Built with
// --fmad=false: no a*b+c is contracted.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool lower(float v, int i, float ov, int oi) {
  return ov < v || (ov == v && oi < i);
}

// Block-wide first minimum over (value, index) pairs: the lower index wins
// a tie, as jnp.argmin / np.argmin.  Every thread returns the winner.
__device__ void block_argmin(float& v, int& i, float* sv, int* si) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (lower(v, i, ov, oi)) {
      v = ov;
      i = oi;
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (lower(v, i, sv[w], si[w])) {
        v = sv[w];
        i = si[w];
      }
    }
    sv[kWarps] = v;
    si[kWarps] = i;
  }
  __syncthreads();
  v = sv[kWarps];
  i = si[kWarps];
}

// ------------------------------------------------------------------- K5
// paths (F, H): permuted link ids, inactive rows on the pad link.  caps0
// (L+1) residual capacities and counts0 (L+1) unfixed-flow hop counts, both
// in permuted order (the pad's count is 0).  perm maps a permuted id back.
// Writes rates (F), the trace (link, share) of each finite round and the
// round count (-1 if the loop overran its bound, which cannot happen for a
// well-formed table).
__global__ void __launch_bounds__(kThreads)
waterfill_progressive_kernel(const int32_t* __restrict__ paths,
                             const float* __restrict__ caps0,
                             const int32_t* __restrict__ counts0,
                             const uint8_t* __restrict__ active,
                             const int64_t* __restrict__ perm, int n_flows,
                             int n_hops, int n_links1, float* __restrict__ rates,
                             int32_t* __restrict__ trace_links,
                             float* __restrict__ trace_shares,
                             int32_t* __restrict__ n_rounds) {
  extern __shared__ float smem[];
  float* caps = smem;
  int* counts = reinterpret_cast<int*>(caps + n_links1);
  uint8_t* unfixed = reinterpret_cast<uint8_t*>(counts + n_links1);
  __shared__ float red_v[kWarps + 1];
  __shared__ int red_i[kWarps + 1];
  __shared__ int s_unfixed;

  if (threadIdx.x == 0) s_unfixed = 0;
  for (int l = threadIdx.x; l < n_links1; l += kThreads) {
    caps[l] = caps0[l];
    counts[l] = counts0[l];
  }
  int mine = 0;
  for (int f = threadIdx.x; f < n_flows; f += kThreads) {
    unfixed[f] = active[f];
    rates[f] = 0.0f;
    mine += active[f] ? 1 : 0;
  }
  __syncthreads();
  atomicAdd(&s_unfixed, mine);
  __syncthreads();

  int r = 0;
  while (s_unfixed > 0) {
    if (r > n_flows) {  // each finite round fixes a flow: never taken
      if (threadIdx.x == 0) *n_rounds = -1;
      return;
    }
    // K5's step: shares caps/counts (BIG where no unfixed flow crosses the
    // link) and their first minimum.
    float share = f32_inf();
    int lid = n_links1;
    for (int l = threadIdx.x; l < n_links1; l += kThreads) {
      const int c = counts[l];
      const float s = c > 0 ? caps[l] / static_cast<float>(c) : kBig;
      if (s < share) {  // l rises within a thread: the first minimum stays
        share = s;
        lid = l;
      }
    }
    block_argmin(share, lid, red_v, red_i);
    if (share >= kBig * 0.5f) {
      // No finite share left: strand the rest at inf, as the plane does.
      for (int f = threadIdx.x; f < n_flows; f += kThreads) {
        if (unfixed[f]) rates[f] = f32_inf();
      }
      break;
    }
    // Fix every unfixed flow with a hop on the bottleneck and subtract the
    // share along its whole padded path.  Every target gets the same share,
    // so the order of the subtractions does not change the result.
    int fixed = 0;
    for (int f = threadIdx.x; f < n_flows; f += kThreads) {
      if (!unfixed[f]) continue;
      const int32_t* row = paths + static_cast<long long>(f) * n_hops;
      bool on = false;
      for (int h = 0; h < n_hops; ++h) on |= row[h] == lid;
      if (!on) continue;
      unfixed[f] = 0;
      rates[f] = share;
      ++fixed;
      for (int h = 0; h < n_hops; ++h) {
        atomicAdd(&caps[row[h]], -share);
        atomicSub(&counts[row[h]], 1);
      }
    }
    if (fixed) atomicSub(&s_unfixed, fixed);
    __syncthreads();
    for (int l = threadIdx.x; l < n_links1; l += kThreads) caps[l] = fmaxf(caps[l], 0.0f);
    if (threadIdx.x == 0) {
      trace_links[r] = static_cast<int32_t>(perm[lid]);
      trace_shares[r] = share;
    }
    ++r;
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_rounds = r;
}

// ------------------------------------------------------------------- K6
// One block per scenario.  caps0 (S, L+1); active (S, F); nhops (S, F, L+1)
// with inactive rows and the pad column zeroed by the wrapper.  Writes
// rates (S, F); NaN rates if the loop overran its bound (never taken).
__global__ void __launch_bounds__(kThreads)
waterfill_fast_kernel(const float* __restrict__ caps0_all,
                      const uint8_t* __restrict__ active_all,
                      const float* __restrict__ nhops_all, int n_flows,
                      int n_links1, float* __restrict__ rates_all) {
  extern __shared__ float smem[];
  float* shares = smem;                      // (L+1)
  float* counts = shares + n_links1;         // (L+1)
  float* s_f = counts + n_links1;            // (F) per-flow bottleneck share
  float* rate = s_f + n_flows;               // (F)
  uint8_t* fixable = reinterpret_cast<uint8_t*>(rate + n_flows);  // (L+1)
  uint8_t* unfixed = fixable + n_links1;     // (F)
  uint8_t* fix = unfixed + n_flows;          // (F)
  __shared__ int s_unfixed, s_fixed;

  const int s = blockIdx.x;
  const float* caps0 = caps0_all + static_cast<long long>(s) * n_links1;
  const uint8_t* active = active_all + static_cast<long long>(s) * n_flows;
  const float* nh = nhops_all + static_cast<long long>(s) * n_flows * n_links1;
  float* rates = rates_all + static_cast<long long>(s) * n_flows;
  const float inf = f32_inf();

  if (threadIdx.x == 0) s_unfixed = 0;
  int mine = 0;
  for (int f = threadIdx.x; f < n_flows; f += kThreads) {
    unfixed[f] = active[f];
    rate[f] = 0.0f;
    mine += active[f] ? 1 : 0;
  }
  __syncthreads();
  atomicAdd(&s_unfixed, mine);
  __syncthreads();

  int r = 0;
  while (s_unfixed > 0) {
    if (r > n_flows) {  // each round fixes a flow or strands the rest
      for (int f = threadIdx.x; f < n_flows; f += kThreads) rates[f] = __int_as_float(0x7fc00000);
      return;
    }
    if (threadIdx.x == 0) s_fixed = 0;
    // counts = unfixed @ nhops; used = finite(rates) @ nhops, summed in
    // flow order; K6's shares of the residual capacities.
    for (int l = threadIdx.x; l < n_links1; l += kThreads) {
      float cnt = 0.0f;
      float used = 0.0f;
      for (int f = 0; f < n_flows; ++f) {
        const float h = nh[static_cast<long long>(f) * n_links1 + l];
        if (h == 0.0f) continue;
        if (unfixed[f]) cnt += h;
        const float x = rate[f];
        if (x != inf) used += x * h;
      }
      const float cap = fmaxf(caps0[l] - used, 0.0f);
      float sh = cnt > 0.0f ? cap / cnt : kBig;
      counts[l] = cnt;
      shares[l] = sh >= kBig * 0.5f ? inf : sh;
    }
    __syncthreads();
    // Each unfixed flow's bottleneck share: the least share on its path.
    for (int f = threadIdx.x; f < n_flows; f += kThreads) {
      float m = inf;
      if (unfixed[f]) {
        const float* row = nh + static_cast<long long>(f) * n_links1;
        for (int l = 0; l < n_links1; ++l) {
          if (row[l] > 0.5f) m = fminf(m, shares[l]);
        }
      }
      s_f[f] = m;
    }
    __syncthreads();
    // Link l is a level bottleneck iff its share is <= the least
    // bottleneck share of its unfixed flows.
    for (int l = threadIdx.x; l < n_links1; l += kThreads) {
      float m = inf;
      for (int f = 0; f < n_flows; ++f) {
        if (unfixed[f] && nh[static_cast<long long>(f) * n_links1 + l] > 0.5f) {
          m = fminf(m, s_f[f]);
        }
      }
      fixable[l] = counts[l] > 0.5f && shares[l] <= m;
    }
    __syncthreads();
    int fixed = 0;
    for (int f = threadIdx.x; f < n_flows; f += kThreads) {
      bool on = false;
      const float sf = s_f[f];
      if (unfixed[f] && sf != inf) {
        const float* row = nh + static_cast<long long>(f) * n_links1;
        for (int l = 0; l < n_links1 && !on; ++l) {
          on = row[l] > 0.5f && fixable[l] && shares[l] <= sf;
        }
      }
      fix[f] = on;
      fixed += on ? 1 : 0;
    }
    if (fixed) atomicAdd(&s_fixed, fixed);
    __syncthreads();
    const int n_fixed = s_fixed;
    for (int f = threadIdx.x; f < n_flows; f += kThreads) {
      if (!unfixed[f]) continue;
      if (n_fixed == 0) {  // stall: no finite share left, strand the rest
        rate[f] = inf;
        unfixed[f] = 0;
      } else if (fix[f]) {
        rate[f] = s_f[f];
        unfixed[f] = 0;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) s_unfixed = n_fixed == 0 ? 0 : s_unfixed - n_fixed;
    ++r;
    __syncthreads();
  }
  for (int f = threadIdx.x; f < n_flows; f += kThreads) rates[f] = rate[f];
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" int waterfill_progressive_launch(
    const int32_t* paths, const float* caps0, const int32_t* counts0,
    const uint8_t* active, const int64_t* perm, int n_flows, int n_hops,
    int n_links1, float* rates, int32_t* trace_links, float* trace_shares,
    int32_t* n_rounds, void* stream) {
  const size_t smem = static_cast<size_t>(n_links1) * 8 + n_flows;
  const int rc = set_smem(reinterpret_cast<const void*>(waterfill_progressive_kernel), smem);
  if (rc != 0) return rc;
  waterfill_progressive_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      paths, caps0, counts0, active, perm, n_flows, n_hops, n_links1, rates,
      trace_links, trace_shares, n_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int waterfill_fast_launch(const float* caps0, const uint8_t* active,
                                     const float* nhops, int n_scen, int n_flows,
                                     int n_links1, float* rates, void* stream) {
  const size_t smem = static_cast<size_t>(n_links1) * 9 + static_cast<size_t>(n_flows) * 10;
  const int rc = set_smem(reinterpret_cast<const void*>(waterfill_fast_kernel), smem);
  if (rc != 0) return rc;
  if (n_scen > 0) {
    waterfill_fast_kernel<<<n_scen, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        caps0, active, nhops, n_flows, n_links1, rates);
  }
  return static_cast<int>(cudaGetLastError());
}
