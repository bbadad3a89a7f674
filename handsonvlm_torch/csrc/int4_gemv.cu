// Int4 weight-only GEMV over the tiled layout, for Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/int8_matmul.py::_int4_gemv_tiled (the
// _gemv4_kernel pallas_call that int4_matmul_stacked reaches for fewer than
// 128 rows over the tiled layout): y = x @ dequant(w4t[layer]) for decode
// (m = 1) and small windows (m < 128).
//
// What it computes: y[m, n] = sum_g s[g, n] * sum_r x[m, g*g_size + r] *
// q[g, r, n] with f32 accumulation and the f32 group scale applied to each
// group's partial sum. The weight is the tiled layout of
// tile_int4_stacked: for tile j, (G, g/2, BN) bytes, contiguous; the byte
// at (g, r, c) holds the value of row r (low nibble, biased by +8) and of
// row g/2 + r (high nibble, two's complement) of group g, column j*BN + c.
// The Pallas kernel's biased-nibble bf16 algebra (x_hi - 16 x_lo rounded to
// bf16) exists because Mosaic cannot shift i8; here both nibbles are
// unpacked in registers and the product is exact up to f32 summation.
//
// Bound: memory. At 7B decode the four projections of a layer read 107.4
// MB of weights and scales (3.44 GB per step, 1.03 ms at 3.35 TB/s); x and
// y are a few KB. One block per BN tile would give only 8-43 blocks for
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int4_gemv_kernel(const T* __restrict__ x,         // (m, d)
                     const int8_t* __restrict__ w4t,  // (NB, G, half, BN): one layer
                     const float* __restrict__ gst,   // (NB, G, BN)
                     float* __restrict__ part,        // (n_split, m, n)
                     int m, int G, int half, int BN, int groups_per_split) {
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
      const int8_t* wg = w4t + ((size_t)j * G + g) * half * BN + slab * kCols;
      const T* xg = xr + (size_t)g * group;
#pragma unroll 4
      for (int r = lane; r < half; r += lanes) {
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wg + (size_t)r * BN));
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
          reinterpret_cast<const float4*>(gst + ((size_t)j * G + g) * BN + slab * kCols);
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
cudaError_t launch(const void* x, const void* w4t, const void* gst, void* part, void* out,
                   int m, int NB, int G, int half, int BN, int n_split,
                   int groups_per_split, cudaStream_t stream) {
  int4_gemv_kernel<T><<<dim3(NB, n_split, m), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w4t),
      static_cast<const float*>(gst), static_cast<float*>(part), m, G, half, BN,
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
// w4t_layer (NB, G, half, BN) int8 and gst_layer (NB, G, BN) f32: views of
// one layer of the stacked tiles (16-byte aligned). part is f32 scratch
// (n_split, m, NB*BN); split s covers groups [s*groups_per_split,
// (s+1)*groups_per_split). BN is a multiple of 16, at most 4096.
// Returns cudaGetLastError().
extern "C" int hv_int4_gemv(const void* x, const void* w4t_layer, const void* gst_layer,
                            void* part, void* out, int is_bf16, int m, int NB, int G,
                            int half, int BN, int n_split, int groups_per_split,
                            void* stream) {
  if (BN % kCols || BN / kCols > kThreads || m < 1 || m > 65535 || n_split < 1 ||
      (n_split - 1) * groups_per_split >= G || n_split * groups_per_split < G)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w4t_layer) | reinterpret_cast<uintptr_t>(gst_layer)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, w4t_layer, gst_layer, part, out, m, NB, G, half,
                                      BN, n_split, groups_per_split, st);
  return (int)launch<float>(x, w4t_layer, gst_layer, part, out, m, NB, G, half, BN,
                            n_split, groups_per_split, st);
}
