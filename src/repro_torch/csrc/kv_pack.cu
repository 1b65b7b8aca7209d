// kv_pack / kv_unpack: paged-KV gather into a contiguous transfer buffer and
// its inverse scatter.
//
// Replaces repro/kernels/kv_pack.py::_pack_kernel (out[i] = pool[table[i]])
// and ::_unpack_kernel (pool[table[i]] = buf[i], in place).
//
// Bound on the H100: bytes.  Each selected page is read once and written
// once (a qwen3-14b page is 16 tokens x 8 KV heads x 128 x bf16 = 32 KB), and
// there is no arithmetic.  Design: one block per selected page; every thread
// moves 16-byte vectors, neighbouring threads on neighbouring addresses, with
// UNROLL loads in flight before their stores so each SM keeps enough bytes
// moving.  The page index is read once per block from the table (the Pallas
// scalar prefetch).  The kernels are dtype-agnostic: a page is bytes, and the
// wrapper checks that its size and every base address are multiples of 16.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ void copy_page(const int4* __restrict__ src,
                                          int4* __restrict__ dst,
                                          long long vecs) {
  const long long step = static_cast<long long>(kThreads) * kUnroll;
  for (long long base = threadIdx.x; base < vecs; base += step) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < vecs) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * kThreads;
      if (i < vecs) dst[i] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kv_pack_kernel(const int4* __restrict__ pool, int4* __restrict__ out,
               const int32_t* __restrict__ table, long long vecs_per_page) {
  const long long src = static_cast<long long>(table[blockIdx.x]) * vecs_per_page;
  const long long dst = static_cast<long long>(blockIdx.x) * vecs_per_page;
  copy_page(pool + src, out + dst, vecs_per_page);
}

__global__ void __launch_bounds__(kThreads)
kv_unpack_kernel(int4* __restrict__ pool, const int4* __restrict__ buf,
                 const int32_t* __restrict__ table, long long vecs_per_page) {
  const long long dst = static_cast<long long>(table[blockIdx.x]) * vecs_per_page;
  const long long src = static_cast<long long>(blockIdx.x) * vecs_per_page;
  copy_page(buf + src, pool + dst, vecs_per_page);
}

}  // namespace

// pool: (n_pages, page_bytes) bytes; out: (n_sel, page_bytes); table: (n_sel,).
extern "C" int kv_pack_launch(const void* pool, void* out, const int32_t* table,
                              int n_sel, long long page_bytes, void* stream) {
  if (n_sel > 0) {
    kv_pack_kernel<<<n_sel, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(pool), static_cast<int4*>(out), table,
        page_bytes / 16);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scatters buf's n_sel pages into pool at the table's page ids, in place.
extern "C" int kv_unpack_launch(void* pool, const void* buf, const int32_t* table,
                                int n_sel, long long page_bytes, void* stream) {
  if (n_sel > 0) {
    kv_unpack_kernel<<<n_sel, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int4*>(pool), static_cast<const int4*>(buf), table,
        page_bytes / 16);
  }
  return static_cast<int>(cudaGetLastError());
}
