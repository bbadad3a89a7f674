// Int4 weight-only matmul for prefill-sized inputs over the tiled and the
// flat layout, for Hopper (sm_90a), on the tensor cores.
//
// Replaces two pallas_calls of handsonvlm_tpu/ops/int8_matmul.py:
// int4_matmul_prefill_tiled (B5b, the _prefill4_tiled_kernel call that
// int4_matmul_stacked reaches for 128 rows or more over the tiled layout)
// and int4_matmul_prefill (B5a, the _prefill4_kernel call over the flat
// stack (L, G, g/2, n)). The flat layout is the tiled one with a single
// tile (NB = 1, BN = n): byte (g, r, c) sits at (g*g/2 + r)*n + c either
// way, its scale at g*n + c, so the wrapper passes it as such and one
// kernel serves both; with the same 64-column output tiles and the same
// group order, B5a gives B5b's bits on the same weight. y = x @
// dequant(w4[layer]) with the Pallas kernels' numerics: x rounded to bf16, each weight
// dequantized as bf16(bf16(nibble) * bf16(scale)), f32 accumulation, the
// f32 result cast to x's dtype. Rows within a group are ordered [low-nibble
// half, high-nibble half], the order of x's features.
//
// Bound: operations. At 7B with a 391-row prompt the four projections of
// the 32 layers are 5.06 TFLOP per prefill, 5.1 ms at 989 TFLOP/s bf16
// (per layer: wqkv 40 us, wo 13 us, wgu 71 us, w_down 36 us); the weights
// are 3.44 GB, 1.03 ms at 3.35 TB/s. On f32 CUDA cores the same work takes
// ~100 ms, so the product runs on the tensor cores: a block computes a
// 64 x 64 output tile with four warps (32 x 32 each, WMMA bf16 16x16x16
// fragments, f32 accumulators) and walks the contraction one quantization
// group (up to 128 rows) at a time. Per group it stages the 64 x g slice
// of x in shared memory as bf16 (16-byte loads) and dequantizes the g/2 x
// 64 packed bytes of the tile (16-byte loads) into a g x 64 bf16 slice
// with the group's 64 scales folded in, then runs the fragments over it.
// Ragged row counts are masked (rows past m load as 0 and are not stored);
// G needs no power of two (w_down has G = 86). Not yet done, and the
// later work toward the bound: double-buffered staging (cp.async/TMA) so
// loads overlap the products, wgmma instead of WMMA, and larger tiles so
// that each weight tile is dequantized fewer times (once per 64 rows here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // four warps in a 2 x 2 arrangement
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kMaxGroup = 128;
constexpr int kLdA = kMaxGroup + 8;  // bf16 elements per staged x row
constexpr int kLdB = kBN + 8;        // bf16 elements per staged weight row
constexpr int kLdC = kBN + 4;        // f32 elements per staged output row
constexpr int kSmemA = kBM * kLdA * 2;
constexpr int kSmemB = kMaxGroup * kLdB * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmemBytes = (kSmemA + kSmemB) > kSmemC ? (kSmemA + kSmemB) : kSmemC;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int4_prefill_kernel(const T* __restrict__ x,         // (m, d)
                        const int8_t* __restrict__ w4t,  // (NB, G, half, BN): one layer
                        const float* __restrict__ gst,   // (NB, G, BN)
                        T* __restrict__ out,             // (m, n)
                        int m, int G, int half, int BN) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);            // [kBM][kLdA]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + kSmemA);   // [group][kLdB]
  float* sc = reinterpret_cast<float*>(smem);                            // [kBM][kLdC]
  __shared__ float sscale[kBN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n = gridDim.x * kBN;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int j = n0 / BN, c0 = n0 % BN;  // BN is a multiple of kBN
  const int group = 2 * half;
  const int d = G * group;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int g = 0; g < G; ++g) {
    // x[m0:m0+64, g*group : (g+1)*group] -> sa as bf16, rows past m as 0
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const int vecs = group / 8;
      for (int i = tid; i < kBM * vecs; i += kThreads) {
        const int r = i / vecs, v = i % vecs;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < m)
          val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * d +
                                                (size_t)g * group + v * 8);
        *reinterpret_cast<uint4*>(sa + r * kLdA + v * 8) = val;
      }
    } else {
      for (int i = tid; i < kBM * group; i += kThreads) {
        const int r = i / group, c = i % group;
        const float val = m0 + r < m ? x[(size_t)(m0 + r) * d + (size_t)g * group + c]
                                     : 0.f;
        sa[r * kLdA + c] = __float2bfloat16(val);
      }
    }
    // the group's scales for these 64 columns, rounded to bf16
    const size_t tile_g = (size_t)j * G + g;
    for (int c = tid; c < kBN; c += kThreads)
      sscale[c] = __bfloat162float(__float2bfloat16(gst[tile_g * BN + c0 + c]));
    __syncthreads();

    // packed bytes (half, 64) -> dequantized bf16 rows [0, half) (low
    // nibbles) and [half, group) (high nibbles)
    const int8_t* wg = w4t + tile_g * half * BN + c0;
    for (int i = tid; i < half * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), v = i % (kBN / 16);
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wg + (size_t)r * BN + v * 16));
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int c = v * 16 + 4 * k + e;
          const int b0 = (int)(int8_t)((words[k] >> (8 * e)) & 0xFF);
          const int b1 = (int)(int8_t)((words[k] >> (8 * (e + 1))) & 0xFF);
          // bf16(nibble) is exact; the product of two bf16 values is exact in
          // f32, so one rounding to bf16 gives bf16(bf16(nibble)*bf16(scale))
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              (float)((b0 & 15) - 8) * sscale[c], (float)((b1 & 15) - 8) * sscale[c + 1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(
              (float)(b0 >> 4) * sscale[c], (float)(b1 >> 4) * sscale[c + 1]);
          *reinterpret_cast<__nv_bfloat162*>(sb + r * kLdB + c) = lo;
          *reinterpret_cast<__nv_bfloat162*>(sb + (half + r) * kLdB + c) = hi;
        }
      }
    }
    __syncthreads();

    for (int kk = 0; kk < group; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], sa + (wm * 32 + a * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(fb[b], sb + kk * kLdB + wn * 32 + b * 16, kLdB);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    __syncthreads();
  }

  // stage the f32 tile (the staging buffers are free after the last sync)
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(sc + (wm * 32 + a * 16) * kLdC + wn * 32 + b * 16, acc[a][b],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    if (m0 + r < m) out[(size_t)(m0 + r) * n + n0 + c] = from_f32<T>(sc[r * kLdC + c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w4t, const void* gst, void* out, int m,
                   int NB, int G, int half, int BN, cudaStream_t stream) {
  const dim3 grid(NB * BN / kBN, (m + kBM - 1) / kBM);
  int4_prefill_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w4t),
      static_cast<const float*>(gst), static_cast<T*>(out), m, G, half, BN);
  return cudaGetLastError();
}

}  // namespace

// x (m, d) and out (m, NB*BN) of one dtype (bf16 or f32), contiguous and
// 16-byte aligned; w4t_layer (NB, G, half, BN) int8 and gst_layer
// (NB, G, BN) f32: views of one layer of the stacked tiles. BN is a
// multiple of 64; the group 2*half is a multiple of 16 up to 128.
// Returns cudaGetLastError().
extern "C" int hv_int4_prefill(const void* x, const void* w4t_layer, const void* gst_layer,
                               void* out, int is_bf16, int m, int NB, int G, int half,
                               int BN, void* stream) {
  if (BN % kBN || half % 8 || 2 * half > kMaxGroup || m < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w4t_layer)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, w4t_layer, gst_layer, out, m, NB, G, half, BN, st);
  return (int)launch<float>(x, w4t_layer, gst_layer, out, m, NB, G, half, BN, st);
}
