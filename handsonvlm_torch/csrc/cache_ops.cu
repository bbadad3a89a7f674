// In-place, left-moving block gather of a KV-cache plane, for Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/cache_ops.py::gather_cache_blocks (kernel B8,
// Pallas `_copy_kernel` over the grid (L, B, S / block_k)): serving
// compaction moves each row's cache blocks toward the front by a per-row
// table, out[:, b, j*bk:(j+1)*bk] = c[:, b, table[b,j]*bk : +bk], in place,
// over k/v planes (L, B, S, K, D) of any element type and int8-cache scale
// planes (L, B, K, S) f32.
//
// In-place safety. The Pallas kernel is safe because the TPU grid runs in
// ascending (l, b, j) order and every table is left-moving (table[b, j] >=
// j). CUDA blocks run concurrently, so the port keeps that order inside each
// independent stream of bytes instead: the plane is cut into rows (one
// (l, b) slab of S*K*D elements, or one (l, b, k) run of S scales), a
// block j of a row is a contiguous run of block_k * inner elements, and
// each row's blocks are cut into byte chunks at the same offsets. One
// thread block owns one (row, chunk) and walks j in ascending order,
// skipping identity entries (no bytes move) and copying chunk `c` of block
// table[b, j] onto chunk `c` of block j, with a barrier between blocks.
// Distinct (row, chunk) pairs never share a byte; within one, a source
// block (>= j) is never overwritten before it is read, because a write to
// block j only lands after every step j' < j that could read it. No second
// cache is allocated: an out-of-place copy of an 8 GiB serving cache is
// what this kernel exists to avoid.
//
// Bound: memory. It reads and writes each non-identity block once:
// 2 * moved blocks * block bytes (a 7B bf16 plane (32, 8, 4096, 32, 128)
// has 2 MiB blocks). Each thread moves four 16-byte words per iteration
// (loads first, then stores) when the plane, its rows and its blocks are
// 16-byte aligned, else bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kUnroll = 4;

template <typename V>
__global__ void gather_blocks_kernel(uint8_t* c, const int* __restrict__ table, int B,
                                     int per_b, int nk, long long row_bytes,
                                     long long block_bytes, long long chunk_bytes) {
  const long long r = blockIdx.x;
  const int b = (int)((r / per_b) % B);
  const int* trow = table + (size_t)b * nk;
  uint8_t* base = c + r * row_bytes;
  const long long lo = (long long)blockIdx.y * chunk_bytes;
  const long long n = (min(block_bytes, lo + chunk_bytes) - lo) / (long long)sizeof(V);
  const long long stride = (long long)blockDim.x * kUnroll;
  for (int j = 0; j < nk; ++j) {
    const int src = trow[j];
    if (src == j) continue;  // identity: no bytes move (uniform over the block)
    const V* from = reinterpret_cast<const V*>(base + (long long)src * block_bytes + lo);
    V* to = reinterpret_cast<V*>(base + (long long)j * block_bytes + lo);
    for (long long i0 = threadIdx.x; i0 < n; i0 += stride) {
      V w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + (long long)u * blockDim.x;
        if (i < n) w[u] = from[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + (long long)u * blockDim.x;
        if (i < n) to[i] = w[u];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// c: the plane, `rows` contiguous rows of row_bytes each; row r uses table
// row (r / per_b) % B (per_b = 1 for a (L, B, S, K, D) plane, K for a
// (L, B, K, S) one). table: (B, nk) int32, left-moving, entries < nk.
// Block j of a row is bytes [j, j+1) * block_bytes; each is moved in
// n_chunks chunks of chunk_bytes (the last may be shorter). vec16: all of
// c, row_bytes, block_bytes and chunk_bytes are multiples of 16. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int hv_gather_cache_blocks(void* c, const void* table, int rows, int B, int per_b,
                                      int nk, long long row_bytes, long long block_bytes,
                                      long long chunk_bytes, int n_chunks, int vec16,
                                      void* stream) {
  if (rows <= 0 || B <= 0 || per_b <= 0 || nk <= 0 || n_chunks <= 0 || n_chunks > 65535 ||
      chunk_bytes <= 0 || block_bytes <= 0 || (long long)nk * block_bytes > row_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long words = (chunk_bytes + (vec16 ? 15 : 0)) / (vec16 ? 16 : 1);
  const long long lanes = (words + kUnroll - 1) / kUnroll;  // threads with work
  const int threads = (int)std::min(256LL, (std::max(1LL, lanes) + 31) / 32 * 32);
  const dim3 grid(rows, n_chunks);
  uint8_t* p = static_cast<uint8_t*>(c);
  const int* t = static_cast<const int*>(table);
  if (vec16)
    gather_blocks_kernel<uint4><<<grid, threads, 0, st>>>(p, t, B, per_b, nk, row_bytes,
                                                          block_bytes, chunk_bytes);
  else
    gather_blocks_kernel<uint8_t><<<grid, threads, 0, st>>>(p, t, B, per_b, nk, row_bytes,
                                                            block_bytes, chunk_bytes);
  return (int)cudaGetLastError();
}
