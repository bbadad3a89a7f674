// The int4 transpose matmul dx = dy @ dequant(W[layer])^T over the tiled and
// the flat layout, for Hopper (sm_90a), on the tensor cores: the input
// gradient through a frozen int4 projection (QLoRA).
//
// Replaces two pallas_calls of handsonvlm_tpu/ops/int8_matmul.py:
// _int4_stacked_T_tiled (B7b, kernel _prefill4t_tiled_kernel, the VJP of
// int4_matmul_stacked over the tiled layout) and int4_matmul_stacked_T's
// flat branch (B7a, kernel _prefill4t_kernel over the flat stack
// (L, G, g/2, n)). As with B5a / B5b, the flat layout is the tiled one with
// a single tile (NB = 1, BN = n), so one kernel serves both. The numerics
// are the Pallas kernels': dy rounded to bf16 whatever its dtype, each
// weight dequantized as bf16(bf16(nibble) * bf16(scale)), f32 sums, the
// result cast to dy's dtype (the caller then casts to x's).
//
// The tile body is B5b's dequantizing staging, transposed: a block computes
// a 64 x 64 tile of dx (rows of m, columns of d) with four warps (32 x 32
// each, WMMA bf16 16x16x16 fragments, f32 accumulators) and walks the
// contraction over n in chunks of up to 64 columns, in ascending order (a
// fixed order: remat recomputation and repeated steps give the same bits).
// Per chunk it stages dy's 64 x chunk slice as bf16 and dequantizes the
// 64 d-rows x chunk columns of W into bf16 with each row's group scale
// folded in (16-byte loads of dy, of the packed bytes and of the scales;
// each row's group, byte row and nibble worked out once per block); the
// fragments read that slice as the column-major B operand,
// which is W^T. Columns of d past its end (w_down's d = 11008 is no
// multiple of 512, JAX's widest block; it is of 64) and rows past m are
// masked.
//
// Bound: operations at training sizes. At m = 2048 a 7B layer's four fused
// projections (202.4 M weights) are 829 GFLOP, 0.84 ms at 989 TFLOP/s
// bf16; at m = 16 the 101 MB of packed weights bound it, 0.030 ms at 3.35
// TB/s. A weight tile is dequantized once per 64 rows of m and each byte
// yields one of its two nibbles (the other belongs to the other half of the
// group, another block); staged cp.async / TMA loads, wgmma and tiles that
// cover a whole group are the later work toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // four warps in a 2 x 2 arrangement
constexpr int kBM = 64;        // rows of m per block
constexpr int kBD = 64;        // columns of d per block
constexpr int kMaxChunk = 64;  // columns of n per contraction step
constexpr int kLdA = kMaxChunk + 8;  // bf16 per staged dy row
constexpr int kLdB = kMaxChunk + 8;  // bf16 per staged W row (one d)
constexpr int kLdC = kBD + 4;        // f32 per staged output row
constexpr int kSmemA = kBM * kLdA * 2;
constexpr int kSmemB = kBD * kLdB * 2;
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
    int4_transpose_kernel(const T* __restrict__ dy,        // (m, n)
                          const int8_t* __restrict__ w4t,  // (NB, G, half, BN): one layer
                          const float* __restrict__ gst,   // (NB, G, BN)
                          T* __restrict__ out,             // (m, d)
                          int m, int NB, int G, int half, int BN, int chunk) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);           // [kBM][kLdA]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + kSmemA);  // [kBD][kLdB]
  float* sc = reinterpret_cast<float*>(smem);                           // [kBM][kLdC]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int group = 2 * half;
  const int d = G * group;
  const int n = NB * BN;
  const int d0 = blockIdx.x * kBD;
  const int m0 = blockIdx.y * kBM;

  // each of the tile's d rows: its group, its byte row and its nibble
  // (row r of a group: the low nibble of byte row r below half, else the
  // high nibble of byte row r - half)
  __shared__ int row_group[kBD], row_byte[kBD], row_high[kBD];
  const int valid_rows = min(kBD, d - d0);
  for (int rr = tid; rr < kBD; rr += kThreads) {
    const int dd = d0 + rr, r = dd % group;
    row_group[rr] = dd / group;
    row_byte[rr] = r % half;
    row_high[rr] = r >= half;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int c0 = 0; c0 < n; c0 += chunk) {
    // dy[m0:m0+64, c0:c0+chunk] -> sa as bf16, rows past m as 0, 8 columns
    // a thread at a time
    const int segs8 = chunk / 8;
    for (int i = tid; i < kBM * segs8; i += kThreads) {
      const int r = i / segs8, c = (i % segs8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) {
        const T* src = dy + (size_t)(m0 + r) * n + c0 + c;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          const float4 a = *reinterpret_cast<const float4*>(src);
          const float4 b = *reinterpret_cast<const float4*>(src + 4);
          const __nv_bfloat162 p0 = __floats2bfloat162_rn(a.x, a.y);
          const __nv_bfloat162 p1 = __floats2bfloat162_rn(a.z, a.w);
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(b.x, b.y);
          const __nv_bfloat162 p3 = __floats2bfloat162_rn(b.z, b.w);
          val = make_uint4(*reinterpret_cast<const uint32_t*>(&p0),
                           *reinterpret_cast<const uint32_t*>(&p1),
                           *reinterpret_cast<const uint32_t*>(&p2),
                           *reinterpret_cast<const uint32_t*>(&p3));
        }
      }
      *reinterpret_cast<uint4*>(sa + r * kLdA + c) = val;
    }
    // W[d0:d0+64, c0:c0+chunk] dequantized -> sb[d row][column], rows past d
    // as 0, 16 columns a thread at a time: one 16-byte load of packed bytes
    // and four of scales. The chunk lies inside one tile of BN.
    const int j = c0 / BN, cc0 = c0 % BN;
    const int segs = chunk / 16;
    for (int i = tid; i < kBD * segs; i += kThreads) {
      const int rr = i / segs, c = (i % segs) * 16;
      __nv_bfloat16* dst = sb + rr * kLdB + c;
      if (rr >= valid_rows) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const size_t tile_g = (size_t)j * G + row_group[rr];
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(
          w4t + (tile_g * half + row_byte[rr]) * BN + cc0 + c));
      const float4* sp = reinterpret_cast<const float4*>(gst + tile_g * BN + cc0 + c);
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
      const int high = row_high[rr];
      uint32_t packed[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 sc = __ldg(sp + k);
        const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int byte = (int)(int8_t)((words[k] >> (8 * e)) & 0xFF);
          const int q = high ? byte >> 4 : (byte & 15) - 8;
          // bf16(nibble) is exact and so is the product of two bf16 values
          // in f32: one rounding gives bf16(bf16(nibble) * bf16(scale))
          w[e] = (float)q * __bfloat162float(__float2bfloat16(sv[e]));
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(w[0], w[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(w[2], w[3]);
        packed[2 * k] = *reinterpret_cast<const uint32_t*>(&lo);
        packed[2 * k + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      *reinterpret_cast<uint4*>(dst + 8) =
          make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
    for (int kk = 0; kk < chunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], sa + (wm * 32 + a * 16) * kLdA + kk, kLdA);
      // B[k][col] = W^T[c0 + kk + k][d0 + col] = sb[col][kk + k]: column-major
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(fb[b], sb + (wn * 32 + b * 16) * kLdB + kk, kLdB);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(sc + (wm * 32 + a * 16) * kLdC + wn * 32 + b * 16, acc[a][b],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBD; i += kThreads) {
    const int r = i / kBD, c = i % kBD;
    if (m0 + r < m && d0 + c < d) out[(size_t)(m0 + r) * d + d0 + c] = from_f32<T>(sc[r * kLdC + c]);
  }
}

template <typename T>
cudaError_t launch(const void* dy, const void* w4t, const void* gst, void* out, int m, int NB,
                   int G, int half, int BN, int chunk, cudaStream_t stream) {
  const int d = G * 2 * half;
  const dim3 grid((d + kBD - 1) / kBD, (m + kBM - 1) / kBM);
  int4_transpose_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const int8_t*>(w4t),
      static_cast<const float*>(gst), static_cast<T*>(out), m, NB, G, half, BN, chunk);
  return cudaGetLastError();
}

}  // namespace

// dy (m, NB*BN) and out (m, d = G*2*half) of one dtype (bf16 or f32),
// contiguous; w4t_layer (NB, G, half, BN) int8 and gst_layer (NB, G, BN)
// f32: views of one layer of the stacked tiles (the flat layout passes
// NB = 1, BN = n), all three 16-byte aligned. BN is a multiple of 16; the
// contraction runs in chunks of gcd(BN, 64) columns. Returns
// cudaGetLastError().
extern "C" int hv_int4_transpose(const void* dy, const void* w4t_layer, const void* gst_layer,
                                 void* out, int is_bf16, int m, int NB, int G, int half,
                                 int BN, void* stream) {
  if (BN % 16 || half < 1 || m < 1 || G < 1 || NB < 1 || m >= 65535 * kBM)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(w4t_layer) |
       reinterpret_cast<uintptr_t>(gst_layer)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int chunk = BN % 64 == 0 ? 64 : (BN % 32 == 0 ? 32 : 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(dy, w4t_layer, gst_layer, out, m, NB, G, half, BN,
                                      chunk, st);
  return (int)launch<float>(dy, w4t_layer, gst_layer, out, m, NB, G, half, BN, chunk, st);
}
