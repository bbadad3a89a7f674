// Int8 weight-only matmul with per-column scales, for Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/int8_matmul.py::int8_matmul (the
// _gemv8_kernel pallas_call): y = (x @ bf16(w8)) * scale with f32
// accumulation, x (m, d) bf16 or f32, w8 (d, n) int8, scale (n,) f32. Every
// projection of the int8 decoder (--int8) runs it: decode steps (m = 1),
// verify windows (m = k + 1), slot batches (m <= 8) and prefills (a few
// hundred to a few thousand rows). bf16(int8) is exact, and so is a bf16 x
// int8 product in f32: the result is the exact product up to f32
// summation, written as f32 (the Pallas output) or in x's dtype (what the
// decoder keeps after the JAX package's cast), one rounding of the same f32
// value either way.
//
// Bound. At 7B the seven projections of a layer hold 202.4 MB of int8 and
// 0.17 MB of scales: below ~295 rows a call is bound by those bytes (0.0605
// ms a layer at 3.35 TB/s for any m up to 8, 1.93 ms a decode step); a
// prefill of 391 rows is 158 GFLOP a layer, 0.160 ms at 989 TFLOP/s bf16.
//
// Below INT8_TC_MIN_M rows (the wrapper's choice): a GEMV shaped like the
// int4 one (csrc/int4_gemv.cu). Grid (256-column tile, split of d, row);
// each thread owns 16 contiguous columns and reads them with one 16-byte
// load per weight row (a warp reads two 256-byte row runs), so the stream is
// coalesced. A byte b becomes a float by the byte permute of int4_gemv.cu:
// b ^ 0x80 = b + 128 lands in the mantissa of 2^23, and one subtraction of
// 2^23 + 128 gives b exactly. The wrapper sizes the splits of d for one row
// whatever m, so row i of a window or a slot batch sums in the same order
// as the same row alone (the speculative loop's greedy identity rests on
// it). Each split writes its f32 partial sums; a second kernel adds the
// splits in order, applies the column scale and casts.
//
// A bf16 x from INT8_TC_MIN_M rows: the tensor cores, as the int4 prefill
// kernel (csrc/int4_prefill.cu). A block computes a 64 x 64 output tile with
// four warps (32 x 32 each, WMMA bf16 16x16x16, f32 accumulators) and walks
// d in 64-row steps: per step it stages x's 64 x 64 slice and the weight
// tile's 64 x 64 bytes as bf16 (exact, no scale folded in), then runs the
// fragments. The epilogue multiplies the f32 sums by the column scale (the
// Pallas kernel's y * s) and casts. Ragged edges are masked (rows past m
// or d load as 0, columns past n are not stored); w_down's d = 11008 is 172
// steps, no padding copy. Not yet done, the later work toward the bound:
// staged cp.async/TMA loads that overlap the products, wgmma, wider tiles
// that reuse each weight tile for more rows, and fusing q|k|v and gate|up.
//
// An f32 x takes the GEMV at any row count: its products are exact f32
// FMAs. On the tensor cores it would have to be split into three bf16 parts
// (hi + mid + lo), whose sums the tensor cores' f32 accumulation rounds
// more coarsely than FMAs do: that version put the 7B decoder's fp32 output
// 7.5e-5 (relative L2, on an H100) from the plain path, against the 1e-4 it
// is held to. f32 inputs serve the references, not the decoder.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

// the GEMV
constexpr int kGemvThreads = 256;
constexpr int kCols = 16;                              // columns per thread
constexpr int kGemvCols = 256;                         // columns per block
constexpr int kSlabs = kGemvCols / kCols;              // threads across a row: 16
constexpr int kLanes = kGemvThreads / kSlabs;          // threads down the rows: 16

// the tensor-core tile
constexpr int kThreads = 128;  // four warps in a 2 x 2 arrangement
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kLdA = kBK + 8;  // bf16 elements per staged x row
constexpr int kLdB = kBN + 8;  // bf16 elements per staged weight row
constexpr int kLdC = kBN + 4;  // f32 elements per staged output row
constexpr int kSmemA = kBM * kLdA * 2;
constexpr int kSmemB = kBK * kLdB * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmemBytes = (kSmemA + kSmemB) > kSmemC ? (kSmemA + kSmemB) : kSmemC;

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

// Byte i of w (an int8 b) as a float: w ^ 0x80808080 holds b + 128 in byte
// i; placed in the low mantissa bits of 2^23, minus 2^23 + 128, gives b.
__device__ __forceinline__ float byte_f32(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | i)) - 8388736.0f;
}

template <typename T>
__global__ void __launch_bounds__(kGemvThreads)
    int8_gemv_kernel(const T* __restrict__ x,       // (m, d)
                     const int8_t* __restrict__ w,  // (d, n)
                     float* __restrict__ part,      // (n_split, m, n)
                     int m, int d, int n, int rows_per_split) {
  __shared__ float red[kLanes * kGemvCols];
  const int j = blockIdx.x;
  const int split = blockIdx.y;
  const int row = blockIdx.z;
  const int slab = threadIdx.x % kSlabs;
  const int lane = threadIdx.x / kSlabs;
  const int c0 = j * kGemvCols + slab * kCols;
  const int r0 = split * rows_per_split;
  const int r1 = min(d, r0 + rows_per_split);

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  if (c0 < n) {
    const T* xr = x + (size_t)row * d;
    const int8_t* wc = w + c0;
#pragma unroll 4
    for (int r = r0 + lane; r < r1; r += kLanes) {
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wc + (size_t)r * n));
      const float xv = to_f32(xr[r]);
      const uint32_t words[4] = {wv.x ^ 0x80808080u, wv.y ^ 0x80808080u,
                                 wv.z ^ 0x80808080u, wv.w ^ 0x80808080u};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[4 * k + i] = fmaf(xv, byte_f32(words[k], i), acc[4 * k + i]);
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) red[lane * kGemvCols + slab * kCols + c] = acc[c];
  __syncthreads();
  // add the row lanes of each column in order
  for (int c = threadIdx.x; c < kGemvCols; c += kGemvThreads) {
    const int col = j * kGemvCols + c;
    if (col >= n) continue;
    float s = 0.f;
    for (int l = 0; l < kLanes; ++l) s += red[l * kGemvCols + c];
    part[((size_t)split * m + row) * n + col] = s;
  }
}

template <typename To>
__global__ void __launch_bounds__(kGemvThreads)
    int8_gemv_merge_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                           To* __restrict__ out, int n_split, int n, size_t mn) {
  const size_t i = (size_t)blockIdx.x * kGemvThreads + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < n_split; ++p) s += part[(size_t)p * mn + i];
  out[i] = from_f32<To>(s * scale[i % n]);
}

template <typename To>
__global__ void __launch_bounds__(kThreads)
    int8_tc_kernel(const __nv_bfloat16* __restrict__ x,  // (m, d)
                   const int8_t* __restrict__ w,         // (d, n)
                   const float* __restrict__ scale,      // (n,)
                   To* __restrict__ out,                 // (m, n)
                   int m, int d, int n) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);           // [kBM][kLdA]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + kSmemA);  // [kBK][kLdB]
  float* sc = reinterpret_cast<float*>(smem);                           // [kBM][kLdC]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // w[k0:k0+64, n0:n0+64] -> sb as bf16 (exact), rows past d as 0
    for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), v = i % (kBN / 16);
      const int col = n0 + v * 16;
      uint4 wv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < d && col < n)
        wv = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * n + col));
      const uint32_t words[4] = {wv.x ^ 0x80808080u, wv.y ^ 0x80808080u,
                                 wv.z ^ 0x80808080u, wv.w ^ 0x80808080u};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<__nv_bfloat162*>(sb + r * kLdB + v * 16 + 4 * k + e) =
              __floats2bfloat162_rn(byte_f32(words[k], e), byte_f32(words[k], e + 1));
    }
    // x[m0:m0+64, k0:k0+64] -> sa, rows past m and columns past d as 0
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), v = i % (kBK / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m && k0 + v * 8 < d)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * d + k0 + v * 8);
      *reinterpret_cast<uint4*>(sa + r * kLdA + v * 8) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
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
    if (m0 + r < m && n0 + c < n)
      out[(size_t)(m0 + r) * n + n0 + c] = from_f32<To>(sc[r * kLdC + c] * scale[n0 + c]);
  }
}

template <typename T, typename To>
cudaError_t launch(const void* x, const void* w8, const void* scale, void* part, void* out,
                   int tensor_cores, int m, int d, int n, int n_split, int rows_per_split,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w8);
  const float* st = static_cast<const float*>(scale);
  To* ot = static_cast<To*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tensor_cores) {
      const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
      int8_tc_kernel<To><<<grid, kThreads, 0, stream>>>(xt, wt, st, ot, m, d, n);
      return cudaGetLastError();
    }
  }
  const dim3 grid((n + kGemvCols - 1) / kGemvCols, n_split, m);
  int8_gemv_kernel<T><<<grid, kGemvThreads, 0, stream>>>(xt, wt, static_cast<float*>(part), m,
                                                         d, n, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)m * n;
  int8_gemv_merge_kernel<To><<<(unsigned)((mn + kGemvThreads - 1) / kGemvThreads),
                               kGemvThreads, 0, stream>>>(static_cast<const float*>(part), st,
                                                          ot, n_split, n, mn);
  return cudaGetLastError();
}

}  // namespace

// x (m, d) bf16 (x_bf16 = 1) or f32, contiguous and 16-byte aligned; w8
// (d, n) int8 and scale (n,) f32: views of one layer (16-byte aligned);
// out (m, n) in f32 (out_f32 = 1) or x's dtype. d is a multiple of 8, n of
// 16. tensor_cores = 0: the GEMV, with f32 scratch part (n_split, m, n),
// split s covering rows [s*rows_per_split, (s+1)*rows_per_split) of d in
// 256-column blocks; 1 (bf16 x only): the tensor cores (part unused).
// Returns cudaGetLastError().
extern "C" int hv_int8_matmul(const void* x, const void* w8, const void* scale, void* part,
                              void* out, int x_bf16, int out_f32, int tensor_cores, int m,
                              int d, int n, int n_split, int rows_per_split, void* stream) {
  if (m < 1 || d < 8 || d % 8 || n < 16 || n % 16 || (!x_bf16 && (!out_f32 || tensor_cores)))
    return (int)cudaErrorInvalidValue;
  if (!tensor_cores && (m > 65535 || n_split < 1 || n_split > 65535 || rows_per_split < 1 ||
                        (long long)(n_split - 1) * rows_per_split >= d ||
                        (long long)n_split * rows_per_split < d || part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (tensor_cores && (m + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w8)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16)
    return (int)launch<float, float>(x, w8, scale, part, out, tensor_cores, m, d, n, n_split,
                                     rows_per_split, st);
  if (out_f32)
    return (int)launch<__nv_bfloat16, float>(x, w8, scale, part, out, tensor_cores, m, d, n,
                                             n_split, rows_per_split, st);
  return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w8, scale, part, out, tensor_cores, m,
                                                   d, n, n_split, rows_per_split, st);
}
