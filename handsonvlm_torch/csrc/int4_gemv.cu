// Int4 weight-only GEMV over the tiled and the flat layout, for Hopper
// (sm_90a).
//
// Replaces three pallas_calls of handsonvlm_tpu/ops/int8_matmul.py that run
// the _gemv4_kernel body: _int4_gemv_tiled (B4b, the tiled stack that
// int4_matmul_stacked reaches for fewer than 128 rows),
// _int4_matmul_stacked_impl's flat branch (B4c, the flat stack (L, G, g/2,
// n), fewer than 128 rows) and int4_matmul (B4a, one flat (G, g/2, n)
// matrix at any row count, the per-projection leaves of
// maybe_int8_matmul): y = x @ dequant(w4[layer]) for decode (m = 1), small
// windows and, for B4a, any m.
//
// What it computes: y[m, n] = sum_g s[g, n] * sum_r x[m, g*g_size + r] *
// q[g, r, n] with f32 accumulation and the f32 group scale applied to each
// group's partial sum. The byte at (g, r, column) holds the value of row r
// (low nibble, biased by +8) and of row g/2 + r (high nibble, two's
// complement) of group g. Two address maps reach it, one body serves both:
// the tiled layout of tile_int4_stacked puts tile j's (G, g/2, BN) bytes in
// one contiguous block, byte (g, r, c) of tile j at ((j*G + g)*g/2 + r)*BN
// + c and its scale at (j*G + g)*BN + c; the flat layout puts it at
// (g*g/2 + r)*n + j*BN + c, rows of n bytes, and its scale at g*n + j*BN +
// c. Given the flat layout, the caller takes BN from the same weight's tiled
// layout (pick_block_n), so the blocks, the splits and every sum are those
// of the tiled call: the two give the same bits.
// The Pallas kernel's biased-nibble bf16 algebra (x_hi - 16 x_lo rounded to
// bf16) exists because Mosaic cannot shift i8; here both nibbles are
// unpacked in registers and the product is exact up to f32 summation.
//
// Bound: memory. At 7B decode the four projections of a layer read 107.4
// MB of weights and scales (3.44 GB per step, 1.03 ms at 3.35 TB/s); x and
// y are a few KB. The flat layout's tile rows are BN-byte runs n bytes
// apart, each a 16-byte load per thread, as coalesced as the tiled one's. One block per BN tile would give only 8-43 blocks for
// 132 SMs, so the grid is (tile, split of the G groups, row): the caller
// picks the splits so that one row's blocks cover every SM about twice,
// whatever the row count, so that a row's sum is cut the same way alone
// and inside a window. Each thread owns 16 columns and reads them with one
// 16-byte load per tile row (a warp reads 512 contiguous bytes), so the
// stream is coalesced.
// Nibbles become floats by a byte permute into the mantissa of 2^23 and
// one subtraction (no int-to-float conversions, which run at a quarter of
// the FMA rate). Each split writes its f32 partial sums; a second kernel
// adds the splits in order (deterministic) and casts to x's dtype. Rows
// of x are separate blocks that read the same tiles (from L2 after the
// first): fine for decode; a multi-row tile is later work for m > 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;  // columns per thread: one 16-byte load per tile row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Byte i of w holds a biased nibble u in its low 4 bits (the high 4 bits
// are 0): place u in the low mantissa bits of 2^23 and subtract 2^23 + 8,
// which gives u - 8 exactly.
__device__ __forceinline__ float nibble(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | i)) - 8388616.0f;
}

// Element strides of the weight (bytes) and of the scales (floats) between
// tiles, groups and rows of a group: the address map of one layout.
struct Strides {
  size_t tile_w, group_w, row_w, tile_s, group_s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int4_gemv_kernel(const T* __restrict__ x,        // (m, d)
                     const int8_t* __restrict__ w4,  // one layer, tiled or flat
                     const float* __restrict__ gs,   // its scales
                     float* __restrict__ part,       // (n_split, m, n)
                     Strides st, int m, int G, int half, int BN, int groups_per_split) {
  __shared__ float red[kThreads * kCols];
  const int j = blockIdx.x;
  const int split = blockIdx.y;
  const int row = blockIdx.z;
  const int slabs = BN / kCols;       // threads across one tile row
  const int lanes = kThreads / slabs;  // threads down the rows of a group
  const int tid = threadIdx.x;
  const int slab = tid % slabs;
  const int lane = tid / slabs;
  const int group = 2 * half;
  const int d = G * group;
  const int n = gridDim.x * BN;
  const int g0 = split * groups_per_split;
  const int g1 = min(G, g0 + groups_per_split);

  float tot[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) tot[c] = 0.f;

  if (lane < lanes) {
    const T* xr = x + (size_t)row * d;
    for (int g = g0; g < g1; ++g) {
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
      const int8_t* wg = w4 + j * st.tile_w + g * st.group_w + slab * kCols;
      const T* xg = xr + (size_t)g * group;
#pragma unroll 4
      for (int r = lane; r < half; r += lanes) {
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wg + r * st.row_w));
        const float xl = to_f32(xg[r]);
        const float xh = to_f32(xg[half + r]);
        const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t lo = words[k] & 0x0F0F0F0Fu;
          // high nibble: two's complement -> biased by +8 is u ^ 8
          const uint32_t hi = ((words[k] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[4 * k + i] = fmaf(xl, nibble(lo, i), acc[4 * k + i]);
            acc[4 * k + i] = fmaf(xh, nibble(hi, i), acc[4 * k + i]);
          }
        }
      }
      const float4* sp =
          reinterpret_cast<const float4*>(gs + j * st.tile_s + g * st.group_s + slab * kCols);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 s = __ldg(sp + k);
        tot[4 * k + 0] = fmaf(s.x, acc[4 * k + 0], tot[4 * k + 0]);
        tot[4 * k + 1] = fmaf(s.y, acc[4 * k + 1], tot[4 * k + 1]);
        tot[4 * k + 2] = fmaf(s.z, acc[4 * k + 2], tot[4 * k + 2]);
        tot[4 * k + 3] = fmaf(s.w, acc[4 * k + 3], tot[4 * k + 3]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[lane * BN + slab * kCols + c] = tot[c];
  }
  __syncthreads();
  // add the row lanes of each column in order
  for (int c = tid; c < BN; c += kThreads) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[l * BN + c];
    part[((size_t)split * m + row) * n + (size_t)j * BN + c] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int4_gemv_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                           int n_split, int mn) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < n_split; ++p) s += part[(size_t)p * mn + i];
  out[i] = from_f32<T>(s);
}

template <typename T>
cudaError_t launch(const void* x, const void* w4, const void* gs, void* part, void* out,
                   Strides st, int m, int NB, int G, int half, int BN, int n_split,
                   int groups_per_split, cudaStream_t stream) {
  int4_gemv_kernel<T><<<dim3(NB, n_split, m), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w4),
      static_cast<const float*>(gs), static_cast<float*>(part), st, m, G, half, BN,
      groups_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int mn = m * NB * BN;
  int4_gemv_merge_kernel<T><<<(mn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), n_split, mn);
  return cudaGetLastError();
}

}  // namespace

// x (m, d) and out (m, NB*BN) of one dtype (bf16 or f32), contiguous;
// w4_layer and gs_layer: views of one layer of the stacked weights (16-byte
// aligned), tiled (flat = 0: (NB, G, half, BN) int8 and (NB, G, BN) f32) or
// flat (flat = 1: (G, half, NB*BN) int8 and (G, NB*BN) f32, BN the column
// tile). part is f32 scratch (n_split, m, NB*BN); split s covers groups
// [s*groups_per_split, (s+1)*groups_per_split). BN is a multiple of 16, at
// most 4096. Returns cudaGetLastError().
extern "C" int hv_int4_gemv(const void* x, const void* w4_layer, const void* gs_layer,
                            void* part, void* out, int is_bf16, int flat, int m, int NB,
                            int G, int half, int BN, int n_split, int groups_per_split,
                            void* stream) {
  if (BN % kCols || BN / kCols > kThreads || m < 1 || m > 65535 || n_split < 1 ||
      (n_split - 1) * groups_per_split >= G || n_split * groups_per_split < G)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w4_layer) | reinterpret_cast<uintptr_t>(gs_layer)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const size_t n = (size_t)NB * BN, h = half, bn = BN;
  const Strides map = flat ? Strides{bn, h * n, n, bn, n}
                           : Strides{G * h * bn, h * bn, bn, G * bn, bn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, w4_layer, gs_layer, part, out, map, m, NB, G, half,
                                      BN, n_split, groups_per_split, st);
  return (int)launch<float>(x, w4_layer, gs_layer, part, out, map, m, NB, G, half, BN,
                            n_split, groups_per_split, st);
}
