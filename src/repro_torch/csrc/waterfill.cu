// Max-min fair water-filling, FlowPlane's fixed point, as two kernels that
// each run the whole round loop on the device, one launch a call.
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
// TPU kernel's computation as its inner step.
//
// Bound on the H100: neither bytes nor operations.  Each round is a chain of
// block-wide passes separated by barriers, so both kernels are bound by the
// latency of a round times the rounds the data needs.  The designs cut the
// passes a round and the length of each thread's chain in a pass.
//
// K5, one block a flow table.  The whole call is one launch: the block
// builds FlowPlane's first-encounter link order itself (the wrapper runs no
// op).  Each link's first encounter is a shared-memory atomicMin over the
// F x H positions; the encountered links are ranked by an exclusive scan of
// the first-encounter positions in position order, the others after them in
// id order, which is torch.argsort(enc, stable=True) exactly.  The permuted
// paths stay in shared memory for the rounds; each round is one pass over
// the links (the clamp of the last round's capacities, the shares and their
// first minimum) and one over the owned flows (fix and subtract).
//
// K6, one block a scenario.  The block stages its (F, L+1) hop slab in
// shared memory with cp.async (4-byte copies up to the source's 16-byte
// boundary, 16-byte copies after it: a slab of odd F x (L+1) starts on no
// 16-byte boundary, which rules out a 1-D TMA bulk copy), then builds
// bitmasks once a launch: a warp ballot over each flow's row gives the
// words of its links (hop > 0.5, and hop != 0), and ballots over 32 x 32
// bit blocks of those rows transpose them into the words of each link's
// flows.  Inactive rows and the pad column are left out.  A round walks set
// bits only: at the sweep's shape a flow has at most 6 links and a link at
// most ~42 flows, against 58 and 119 for a dense walk.  A link's count of
// unfixed hops and its used capacity are summed over its active flows in
// round 0 and then updated by the flows the last round fixed.  The link
// passes give each link a group of 1-32 adjacent lanes, each lane a
// contiguous range of the link's flow words, combined by a butterfly of
// shuffles; the flow passes give each flow a thread.  Every sum runs in one
// fixed order, so two calls are bitwise equal.  (One block a scenario, not
// a cluster of blocks: a round is five barrier-separated, latency-bound
// passes, and a cluster would add its own barrier to each pass while 54
// scenarios already leave most of the 132 SMs free.)  Measured
// (chip_smoke.py, H100 80GB HBM3, 700 W): K6 0.0249 ms a call at the
// sweep's shape (0.0906 ms for the first design, four dense passes a
// round); K5 0.0185 ms a call at the largest FlowPlane table of run_sim
// (0.440 ms with the prep as eager ops).
//
// Layouts.  The host plans (kernels/waterfill.py) place the regions of each
// kernel in shared memory in order of use while they fit; what does not fit
// is read from device memory (K5's paths, K6's slab) or lives in a device
// scratch buffer the wrapper allocates (K5's link state, K6's state and
// masks together), so no shape that the first kernels took is refused.  Each kernel
// is a template on its layout, so the compiler sees which pointers are
// shared.  The launchers recompute each plan's shared bytes and refuse a
// plan that disagrees.
//
// Numerics: f32, as the Pallas route (repro/kernels/waterfill.py:112, :238).
// K5's shares are single IEEE divisions and its capacity updates subtract
// the same share from every target, so the order of the atomic subtractions
// cannot change the result: K5 equals its plain version bit for bit.  K6
// sums a link's used capacity round by round, each round's flows over its
// lanes' flow ranges in flow order and the ranges by a fixed tree; the plain
// version's matrix product sums in another order, so the two agree to a
// tolerance.  Built with --fmad=false: no a*b+c is contracted.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
// Reduction scratch at the head of K5's shared memory: kMaxWarps + 1 floats
// and as many ints, rounded up to 16 bytes.
constexpr long long kRedBytes = 272;

__host__ __device__ inline long long align16(long long n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool lower(float v, int i, float ov, int oi) {
  return ov < v || (ov == v && oi < i);
}

// Block-wide first minimum over (value, index) pairs: the lower index wins
// a tie, as jnp.argmin / np.argmin.  Every thread returns the winner.
__device__ void block_argmin(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (lower(v, i, ov, oi)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? sv[lane] : f32_inf();
    int wi = lane < n_warps ? si[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, w, off);
      const int oi = __shfl_xor_sync(kFull, wi, off);
      if (lower(w, wi, ov, oi)) {
        w = ov;
        wi = oi;
      }
    }
    if (lane == 0) {
      sv[kMaxWarps] = w;
      si[kMaxWarps] = wi;
    }
  }
  __syncthreads();
  v = sv[kMaxWarps];
  i = si[kMaxWarps];
}

// Block-wide exclusive prefix sum of one int a thread, in thread order;
// `total` gets the sum.  sw holds kMaxWarps ints.  Ends in a barrier, so it
// may be called again at once.
__device__ int block_exclusive_scan(int x, int* sw, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) sw[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? sw[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    sw[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp > 0 ? sw[warp - 1] : 0;
  total = sw[n_warps - 1];
  __syncthreads();
  return before + inc - x;
}

// ------------------------------------------------------------------- K5
// Bytes of K5's link state: caps, first-encounter keys (then counts), inv
// and perm over L+1 links, then the unfixed flags of F flows.
__host__ __device__ inline long long progressive_link_bytes(int n_flows, int n_links1) {
  return 4 * align16(4LL * n_links1) + align16(n_flows);
}
__host__ __device__ inline long long progressive_smem(int n_flows, int n_hops, int n_links1,
                                                      int links_in_smem, int paths_in_smem) {
  return kRedBytes + (links_in_smem ? progressive_link_bytes(n_flows, n_links1) : 0) +
         (paths_in_smem ? align16(4LL * n_flows * n_hops) : 0);
}

// paths (F, H) original link ids, short paths padded with the pad link L;
// caps_in (L+1) in original order; active (F).  Writes rates (F), the trace
// (link, share) of each finite round, -1 / inf past the last one, and the
// round count (-1 if the loop overran its bound, which a well-formed table
// cannot make it do).
// kLinks / kPaths: the link state / the permuted paths in shared memory
// (template arguments, so that the compiler sees which pointers are shared).
template <bool kLinks, bool kPaths>
__global__ void __launch_bounds__(kMaxThreads)
waterfill_progressive_kernel(const int32_t* __restrict__ paths,
                             const float* __restrict__ caps_in,
                             const uint8_t* __restrict__ active, int n_flows,
                             int n_hops, int n_links1, unsigned char* __restrict__ scratch,
                             float* __restrict__ rates, int32_t* __restrict__ trace_links,
                             float* __restrict__ trace_shares, int32_t* __restrict__ n_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red_v = reinterpret_cast<float*>(smem);
  int* red_i = reinterpret_cast<int*>(red_v + kMaxWarps + 1);
  unsigned char* links = kLinks ? smem + kRedBytes : scratch;
  const long long lb = align16(4LL * n_links1);
  float* caps = reinterpret_cast<float*>(links);
  int* counts = reinterpret_cast<int*>(links + lb);
  int* inv = reinterpret_cast<int*>(links + 2 * lb);
  int* perm = reinterpret_cast<int*>(links + 3 * lb);
  uint8_t* unfixed = links + 4 * lb;
  int32_t* pp = reinterpret_cast<int32_t*>(
      smem + kRedBytes + (kLinks ? progressive_link_bytes(n_flows, n_links1) : 0));

  const int tid = threadIdx.x, nt = blockDim.x;
  const int pad = n_links1 - 1;
  const int npos = n_flows * n_hops;
  // The original link of position i = f * H + h: inactive rows ride the pad.
  auto link_at = [&](int i) -> int {
    return active[i / n_hops] ? paths[i] : pad;
  };

  for (int l = tid; l < n_links1; l += nt) counts[l] = INT_MAX;
  int mine_unfixed = 0;
  for (int f = tid; f < n_flows; f += nt) {
    const uint8_t a = active[f] ? 1 : 0;
    unfixed[f] = a;
    rates[f] = 0.0f;
    mine_unfixed += a;
  }
  __syncthreads();
  // Each link's first encounter over the positions in (flow, hop) order.
  for (int i = tid; i < npos; i += nt) atomicMin(&counts[link_at(i)], i);
  __syncthreads();
  // Encountered links in first-encounter order: a contiguous range of
  // positions a thread, its first encounters ranked by a block scan.
  const int chunk = (npos + nt - 1) / nt;
  const int p_lo = min(tid * chunk, npos), p_hi = min(p_lo + chunk, npos);
  int mine = 0;
  for (int i = p_lo; i < p_hi; ++i) mine += counts[link_at(i)] == i ? 1 : 0;
  int n_enc;
  int at = block_exclusive_scan(mine, red_i, n_enc);
  for (int i = p_lo; i < p_hi; ++i) {
    const int l = link_at(i);
    if (counts[l] == i) inv[l] = at++;
  }
  // The links no flow crosses follow, in id order (argsort's stable ties).
  const int lchunk = (n_links1 + nt - 1) / nt;
  const int l_lo = min(tid * lchunk, n_links1), l_hi = min(l_lo + lchunk, n_links1);
  mine = 0;
  for (int l = l_lo; l < l_hi; ++l) mine += counts[l] == INT_MAX ? 1 : 0;
  int n_rest;
  at = n_enc + block_exclusive_scan(mine, red_i, n_rest);
  for (int l = l_lo; l < l_hi; ++l) {
    if (counts[l] == INT_MAX) inv[l] = at++;
  }
  __syncthreads();
  for (int l = tid; l < n_links1; l += nt) {
    perm[inv[l]] = l;
    caps[inv[l]] = caps_in[l];
    counts[l] = 0;
  }
  __syncthreads();
  // Permuted paths and the unfixed-flow hop counts; the pad's stays 0.
  for (int i = tid; i < npos; i += nt) {
    const int l = link_at(i);
    const int p = inv[l];
    if (kPaths) pp[i] = p;
    if (l != pad) atomicAdd(&counts[p], 1);
  }
  auto hop = [&](int f, int h) -> int {
    return kPaths ? pp[f * n_hops + h] : inv[link_at(f * n_hops + h)];
  };

  int r = 0;
  bool overran = false;
  while (__syncthreads_or(mine_unfixed > 0)) {
    if (r > n_flows) {  // each finite round fixes a flow: never taken
      overran = true;
      break;
    }
    // K5's step: shares caps/counts (BIG where no unfixed flow crosses the
    // link) and their first minimum, after the last round's clamp.
    float share = f32_inf();
    int lid = n_links1;
    for (int l = tid; l < n_links1; l += nt) {
      float c = caps[l];
      if (r > 0) {
        c = fmaxf(c, 0.0f);
        caps[l] = c;
      }
      const int n = counts[l];
      const float s = n > 0 ? c / static_cast<float>(n) : kBig;
      if (s < share) {  // l rises within a thread: the first minimum stays
        share = s;
        lid = l;
      }
    }
    block_argmin(share, lid, red_v, red_i);
    if (share >= kBig * 0.5f) {
      // No finite share left: strand the rest at inf, as the plane does.
      for (int f = tid; f < n_flows; f += nt) {
        if (unfixed[f]) rates[f] = f32_inf();
      }
      break;
    }
    // Fix every unfixed flow with a hop on the bottleneck and subtract the
    // share along its whole padded path.  Every target gets the same share,
    // so the order of the subtractions does not change the result.
    for (int f = tid; f < n_flows; f += nt) {
      if (!unfixed[f]) continue;
      bool on = false;
      for (int h = 0; h < n_hops; ++h) on |= hop(f, h) == lid;
      if (!on) continue;
      unfixed[f] = 0;
      rates[f] = share;
      --mine_unfixed;
      for (int h = 0; h < n_hops; ++h) {
        const int p = hop(f, h);
        atomicAdd(&caps[p], -share);
        atomicSub(&counts[p], 1);
      }
    }
    if (tid == 0) {
      trace_links[r] = perm[lid];
      trace_shares[r] = share;
    }
    ++r;
  }
  const int n_trace = max(n_flows, 1);
  for (int j = r + tid; j < n_trace; j += nt) {
    trace_links[j] = -1;
    trace_shares[j] = f32_inf();
  }
  if (tid == 0) *n_rounds = overran ? -1 : r;
}

// ------------------------------------------------------------------- K6
// Regions of one scenario, each array 16-byte aligned:
//   state  caps0, shares, counts, used (L+1 f32), fixable (L+1 u8),
//          bottleneck shares s_f and rates (F f32), fix (F u8), the unfixed
//          flows and those the last round fixed (WF words each);
//   masks  the links of each flow with a hop > 0.5 and with a hop != 0
//          (F x WL words each), the flows of each link with a hop != 0 and
//          with a hop > 0.5 (L+1 x WF words each);
//   slab   the (F, L+1) hops, 16 bytes longer, so that the staged copy
//          keeps the source's offset within 16 bytes.
struct FastSizes {
  long long l4, l1, f4, f1, wf, fm, lm, state, masks, slab;
  __host__ __device__ FastSizes(int n_flows, int n_links1) {
    const long long n_wf = (n_flows + 31) / 32, n_wl = (n_links1 + 31) / 32;
    l4 = align16(4LL * n_links1);
    l1 = align16(n_links1);
    f4 = align16(4LL * n_flows);
    f1 = align16(n_flows);
    wf = align16(4 * n_wf);
    fm = align16(4LL * n_flows * n_wl);
    lm = align16(4LL * n_links1 * n_wf);
    state = 4 * l4 + l1 + 2 * f4 + f1 + 2 * wf;
    masks = 2 * fm + 2 * lm;
    slab = align16(4LL * n_flows * n_links1) + 16;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}
__device__ __forceinline__ float group_min(float v, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// caps0 (S, L+1); active (S, F); nhops (S, F, L+1).  Inactive rows and the
// pad column L are left out here.  Writes rates (S, F); NaN rates if the
// loop overran its bound (never taken).  `lanes` adjacent lanes share a
// link in the link passes.  kShared puts the state and the masks in shared
// memory (in that order), else in scratch, scratch_stride bytes a scenario;
// kSlab stages the slab in shared memory after them.  A template, so that
// the compiler sees which pointers are shared.
template <bool kShared, bool kSlab>
__global__ void __launch_bounds__(kMaxThreads)
waterfill_fast_kernel(const float* __restrict__ caps0_all,
                      const uint8_t* __restrict__ active_all,
                      const float* __restrict__ nhops_all, int n_flows, int n_links1,
                      int lanes, unsigned char* __restrict__ scratch_all,
                      long long scratch_stride, float* __restrict__ rates_all) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FastSizes z(n_flows, n_links1);
  const int s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, n_warps = nt / 32;
  const int n_wf = (n_flows + 31) / 32, n_wl = (n_links1 + 31) / 32;
  const int pad = n_links1 - 1;
  const float* caps0 = caps0_all + static_cast<long long>(s) * n_links1;
  const uint8_t* active = active_all + static_cast<long long>(s) * n_flows;
  const float* nh = nhops_all + static_cast<long long>(s) * n_flows * n_links1;
  float* rates = rates_all + static_cast<long long>(s) * n_flows;
  const float inf = f32_inf();

  unsigned char* scratch = scratch_all + static_cast<long long>(s) * scratch_stride;
  unsigned char* st = kShared ? smem : scratch;
  unsigned char* mk = st + z.state;
  const float* slab = nh;
  if (kSlab) {
    // Stage the slab: the copy keeps the source's offset within 16 bytes,
    // 4-byte pieces up to its first 16-byte boundary and past its last,
    // 16-byte pieces between.
    const int n = n_flows * n_links1;  // it fits shared memory
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(nh) % 16) / 4;
    float* dst = reinterpret_cast<float*>(smem + z.state + z.masks) + mis;
    const int head = min((4 - mis) % 4, n);
    const int n16 = (n - head) / 4;
    for (int i = tid; i < head; i += nt) cp_async4(dst + i, nh + i);
    for (int i = tid; i < n16; i += nt) cp_async16(dst + head + 4 * i, nh + head + 4 * i);
    for (int i = head + 4 * n16 + tid; i < n; i += nt) cp_async4(dst + i, nh + i);
    slab = dst;
  }
  float* cap0 = reinterpret_cast<float*>(st);
  float* shares = reinterpret_cast<float*>(st + z.l4);
  float* counts = reinterpret_cast<float*>(st + 2 * z.l4);
  float* used = reinterpret_cast<float*>(st + 3 * z.l4);
  uint8_t* fixable = st + 4 * z.l4;
  float* s_f = reinterpret_cast<float*>(st + 4 * z.l4 + z.l1);
  float* rate = reinterpret_cast<float*>(st + 4 * z.l4 + z.l1 + z.f4);
  uint8_t* fix = st + 4 * z.l4 + z.l1 + 2 * z.f4;
  uint32_t* unfixed = reinterpret_cast<uint32_t*>(st + 4 * z.l4 + z.l1 + 2 * z.f4 + z.f1);
  uint32_t* newly = reinterpret_cast<uint32_t*>(st + 4 * z.l4 + z.l1 + 2 * z.f4 + z.f1 + z.wf);
  uint32_t* fmask = reinterpret_cast<uint32_t*>(mk);
  uint32_t* fmask_nz = reinterpret_cast<uint32_t*>(mk + z.fm);
  uint32_t* lmask = reinterpret_cast<uint32_t*>(mk + 2 * z.fm);
  uint32_t* lmask_on = reinterpret_cast<uint32_t*>(mk + 2 * z.fm + z.lm);

  // While the slab lands: capacities, rates and the unfixed words (one warp
  // a word of 32 flows: flow f is lane f % 32 of warp (f / 32) % n_warps,
  // the thread that owns f in every flow pass below).
  for (int l = tid; l < n_links1; l += nt) cap0[l] = caps0[l];
  bool any_unfixed = false;
  for (int w = warp; w < n_wf; w += n_warps) {
    const int f = w * 32 + lane;
    const bool a = f < n_flows && active[f];
    if (f < n_flows) rate[f] = 0.0f;
    const uint32_t bits = __ballot_sync(kFull, a);
    if (lane == 0) unfixed[w] = bits;
    any_unfixed |= bits != 0;
  }
  if (kSlab) cp_async_wait_all();
  __syncthreads();
  auto hops = [&](int f, int l) -> float {
    return kSlab ? slab[f * n_links1 + l] : slab[static_cast<long long>(f) * n_links1 + l];
  };
  auto is_unfixed = [&](int f) -> bool { return (unfixed[f >> 5] >> (f & 31)) & 1u; };
  // The masks.  First the rows, one warp a flow: the words of its links
  // with a hop != 0 and with a hop > 0.5, from coalesced reads of its row
  // (the unfixed words are the active mask yet).
  for (int f = warp; f < n_flows; f += n_warps) {
    const bool act = is_unfixed(f);
    for (int w = 0; w < n_wl; ++w) {
      const int l = w * 32 + lane;
      const float h = act && l < pad ? hops(f, l) : 0.0f;
      const uint32_t nz = __ballot_sync(kFull, h != 0.0f);
      const uint32_t on = __ballot_sync(kFull, h > 0.5f);
      if (lane == 0) {
        fmask_nz[static_cast<long long>(f) * n_wl + w] = nz;
        fmask[static_cast<long long>(f) * n_wl + w] = on;
      }
    }
  }
  __syncthreads();
  // Then the flows of each link: the rows' 32 x 32 bit blocks transposed by
  // ballots, one warp a block; lane k keeps the word of the block's link k.
  for (int b = warp; b < n_wf * n_wl; b += n_warps) {
    const int w = b / n_wl, c = b % n_wl;
    const int f = w * 32 + lane;
    const uint32_t row_nz = f < n_flows ? fmask_nz[static_cast<long long>(f) * n_wl + c] : 0u;
    const uint32_t row_on = f < n_flows ? fmask[static_cast<long long>(f) * n_wl + c] : 0u;
    uint32_t col_nz = 0u, col_on = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t nz = __ballot_sync(kFull, (row_nz >> k) & 1u);
      const uint32_t on = __ballot_sync(kFull, (row_on >> k) & 1u);
      if (lane == k) {
        col_nz = nz;
        col_on = on;
      }
    }
    const int l = c * 32 + lane;
    if (l < n_links1) {
      lmask[static_cast<long long>(l) * n_wf + w] = col_nz;
      lmask_on[static_cast<long long>(l) * n_wf + w] = col_on;
    }
  }

  // Link passes: group g of `lanes` adjacent lanes takes links g, g + groups,
  // ...; lane `sub` of it the flow words [w_lo, w_hi).
  const int groups = nt / lanes, sub = tid % lanes, group = tid / lanes;
  const int wpl = (n_wf + lanes - 1) / lanes;
  const int w_lo = min(sub * wpl, n_wf), w_hi = min(w_lo + wpl, n_wf);
  const int link_iters = (n_links1 + groups - 1) / groups;

  int r = 0;
  while (__syncthreads_or(any_unfixed)) {
    if (r > n_flows) {  // each round fixes a flow or strands the rest
      for (int f = tid; f < n_flows; f += nt) rates[f] = __int_as_float(0x7fc00000);
      return;
    }
    // counts = unfixed @ nhops and used = finite(rates) @ nhops: in round 0
    // over each link's active flows, then less and plus the flows the last
    // round fixed; each lane over its flow words in flow order, the lanes
    // by a fixed tree.  K6's shares of the residual capacities.
    for (int it = 0; it < link_iters; ++it) {
      const int l = group + it * groups;
      float dc = 0.0f;
      float du = 0.0f;
      if (l < n_links1) {
        for (int w = w_lo; w < w_hi; ++w) {
          uint32_t bits = lmask[static_cast<long long>(l) * n_wf + w] & (r == 0 ? unfixed[w] : newly[w]);
          while (bits) {
            const int f = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            const float h = hops(f, l);
            dc += h;
            du += rate[f] * h;
          }
        }
      }
      dc = group_sum(dc, lanes);
      du = group_sum(du, lanes);
      if (l < n_links1 && sub == 0) {
        const float cnt = r == 0 ? dc : counts[l] - dc;
        const float use = r == 0 ? 0.0f : used[l] + du;
        counts[l] = cnt;
        used[l] = use;
        const float cap = fmaxf(cap0[l] - use, 0.0f);
        const float sh = cnt > 0.0f ? cap / cnt : kBig;
        shares[l] = sh >= kBig * 0.5f ? inf : sh;
      }
    }
    __syncthreads();
    // Each unfixed flow's bottleneck share: the least share on its path.
    for (int f = tid; f < n_flows; f += nt) {
      float m = inf;
      if (is_unfixed(f)) {
        for (int w = 0; w < n_wl; ++w) {
          uint32_t bits = fmask[static_cast<long long>(f) * n_wl + w];
          while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1;
            m = fminf(m, shares[w * 32 + b]);
          }
        }
      }
      s_f[f] = m;
    }
    __syncthreads();
    // Link l is a level bottleneck iff its share is <= the least
    // bottleneck share of its unfixed flows.
    for (int it = 0; it < link_iters; ++it) {
      const int l = group + it * groups;
      float m = inf;
      if (l < n_links1) {
        for (int w = w_lo; w < w_hi; ++w) {
          uint32_t bits = lmask_on[static_cast<long long>(l) * n_wf + w] & unfixed[w];
          while (bits) {
            const int f = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            m = fminf(m, s_f[f]);
          }
        }
      }
      m = group_min(m, lanes);
      if (l < n_links1 && sub == 0) fixable[l] = counts[l] > 0.5f && shares[l] <= m;
    }
    __syncthreads();
    // The fix mask: an unfixed flow with a finite share that crosses a
    // fixable link at or below it.
    bool any_fix = false;
    for (int f = tid; f < n_flows; f += nt) {
      bool on = false;
      const float sf = s_f[f];
      if (is_unfixed(f) && sf != inf) {
        for (int w = 0; w < n_wl && !on; ++w) {
          uint32_t bits = fmask[static_cast<long long>(f) * n_wl + w];
          while (bits && !on) {
            const int l = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            on = fixable[l] && shares[l] <= sf;
          }
        }
      }
      fix[f] = on;
      any_fix |= on;
    }
    const bool fixed_any = __syncthreads_or(any_fix);
    // Rates and unfixed words, one warp a word: with no flow fixed, no
    // finite share is left, and the rest are stranded at inf.
    any_unfixed = false;
    for (int w = warp; w < n_wf; w += n_warps) {
      const int f = w * 32 + lane;
      const uint32_t old = unfixed[w];
      const bool fx = f < n_flows && fix[f];
      if ((old >> lane) & 1u) {
        if (!fixed_any) {
          rate[f] = inf;
        } else if (fx) {
          rate[f] = s_f[f];
        }
      }
      const uint32_t fixed = __ballot_sync(kFull, fx);
      const uint32_t now = fixed_any ? old & ~fixed : 0u;
      if (lane == 0) {
        unfixed[w] = now;
        newly[w] = fixed;
      }
      any_unfixed |= now != 0;
    }
    ++r;
  }
  for (int f = tid; f < n_flows; f += nt) rates[f] = rate[f];
}

int set_smem(const void* fn, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool bad_block(int threads, long long smem) {
  return threads < 32 || threads > kMaxThreads || threads % 32 || smem < 0 || smem > kMaxSmem;
}

template <bool kLinks, bool kPaths>
int launch_progressive(const int32_t* paths, const float* caps, const uint8_t* active,
                       int n_flows, int n_hops, int n_links1, int threads, long long smem_bytes,
                       void* scratch, float* rates, int32_t* trace_links, float* trace_shares,
                       int32_t* n_rounds, void* stream) {
  const int rc = set_smem(
      reinterpret_cast<const void*>(waterfill_progressive_kernel<kLinks, kPaths>), smem_bytes);
  if (rc != 0) return rc;
  waterfill_progressive_kernel<kLinks, kPaths>
      <<<1, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
          paths, caps, active, n_flows, n_hops, n_links1, static_cast<unsigned char*>(scratch),
          rates, trace_links, trace_shares, n_rounds);
  return static_cast<int>(cudaGetLastError());
}

template <bool kShared, bool kSlab>
int launch_fast(const float* caps0, const uint8_t* active, const float* nhops, int n_scen,
                int n_flows, int n_links1, int threads, int lanes, long long smem_bytes,
                void* scratch, long long scratch_stride, float* rates, void* stream) {
  const int rc = set_smem(
      reinterpret_cast<const void*>(waterfill_fast_kernel<kShared, kSlab>), smem_bytes);
  if (rc != 0) return rc;
  if (n_scen > 0) {
    waterfill_fast_kernel<kShared, kSlab>
        <<<n_scen, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        caps0, active, nhops, n_flows, n_links1, lanes, static_cast<unsigned char*>(scratch),
        scratch_stride, rates);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int waterfill_progressive_launch(
    const int32_t* paths, const float* caps, const uint8_t* active, int n_flows, int n_hops,
    int n_links1, int threads, int links_in_smem, int paths_in_smem, long long smem_bytes,
    void* scratch, float* rates, int32_t* trace_links, float* trace_shares, int32_t* n_rounds,
    void* stream) {
  const long long want = progressive_smem(n_flows, n_hops, n_links1, links_in_smem,
                                          paths_in_smem);
  if (want != smem_bytes || bad_block(threads, smem_bytes) ||
      (!links_in_smem && (paths_in_smem || scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (links_in_smem && paths_in_smem) {
    return launch_progressive<true, true>(paths, caps, active, n_flows, n_hops, n_links1,
                                          threads, smem_bytes, scratch, rates, trace_links,
                                          trace_shares, n_rounds, stream);
  }
  if (links_in_smem) {
    return launch_progressive<true, false>(paths, caps, active, n_flows, n_hops, n_links1,
                                           threads, smem_bytes, scratch, rates, trace_links,
                                           trace_shares, n_rounds, stream);
  }
  return launch_progressive<false, false>(paths, caps, active, n_flows, n_hops, n_links1,
                                          threads, smem_bytes, scratch, rates, trace_links,
                                          trace_shares, n_rounds, stream);
}

extern "C" int waterfill_fast_launch(const float* caps0, const uint8_t* active,
                                     const float* nhops, int n_scen, int n_flows,
                                     int n_links1, int threads, int lanes, int state_in_smem,
                                     int slab_in_smem, long long smem_bytes, void* scratch,
                                     long long scratch_stride, float* rates, void* stream) {
  const FastSizes z(n_flows, n_links1);
  const long long want =
      (state_in_smem ? z.state + z.masks : 0) + (slab_in_smem ? z.slab : 0);
  const long long stride = state_in_smem ? 0 : z.state + z.masks;
  if (want != smem_bytes || stride != scratch_stride || bad_block(threads, smem_bytes) ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || threads % lanes ||
      (slab_in_smem && !state_in_smem) || (stride > 0 && scratch == nullptr && n_scen > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (state_in_smem && slab_in_smem) {
    return launch_fast<true, true>(caps0, active, nhops, n_scen, n_flows, n_links1, threads,
                                   lanes, smem_bytes, scratch, scratch_stride, rates, stream);
  }
  if (state_in_smem) {
    return launch_fast<true, false>(caps0, active, nhops, n_scen, n_flows, n_links1, threads,
                                    lanes, smem_bytes, scratch, scratch_stride, rates, stream);
  }
  return launch_fast<false, false>(caps0, active, nhops, n_scen, n_flows, n_links1, threads,
                                   lanes, smem_bytes, scratch, scratch_stride, rates, stream);
}
