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
// A bf16 x from INT8_TC_MIN_M rows: wgmma, the int4 prefill kernel's
// transposed form (csrc/int4_prefill.cu) fed by TMA; the kernel body is in
// csrc/int8_tc.cuh, which B10a (csrc/qlora_fused.cu) instantiates with a
// low-rank term. Bound: operations from
// ~295 rows (above); the weight bytes a FLOP are twice the int4 kernel's,
// so the load path matters more. The design:
// - y^T = W^T x^T: wgmma's A operand (64 weight columns x 16 rows of d, in
//   registers) is the weight, made bf16 in registers; the B operand (16
//   rows of d x N rows of m, wgmma's N: 16, 32, 64, 104 or 128, the
//   wrapper's choice) is x, K-major with the 128-byte swizzle, read by
//   wgmma where TMA put it. A byte b becomes an exact bf16 in three
//   instructions a pair: b & 127 OR-ed into the mantissa of 128.0, less
//   128.0, or 256.0 where b's sign bit is set (int8_pair).
// - A block: two consumer warpgroups of 128 weight columns each (two
//   64-column sub-tiles a warpgroup; 256 columns a block) and a producer
//   warpgroup, one thread of which issues the loads; setmaxnreg moves its
//   registers to the consumers (40 against 232 a thread: at the 168 a
//   thread of the launch ptxas serialised the 128-row tile's wgmmas, warning
//   C7512). Thread (g, t) of warp q holds columns 32q + 4g .. + 3 of its
//   warpgroup's 128: one 4-byte read a weight row gives all four, the A
//   rows g and g + 8 of sub-tile 0 (columns +0, +1) and of sub-tile 1 (+2,
//   +3). Two register sets alternate over the k16 steps.
// - The producer keeps a six-stage ring full by TMA (an mbarrier a stage
//   for the bytes, one for the consumer warps' release): a stage is 64 rows
//   of d, x's [N][64] box and the weight's two [64][128] byte boxes, both
//   with the 128-byte swizzle (so a warp's 4-byte reads of four rows fall on
//   distinct banks). Rows of m and of d past their ends arrive as zeros: d
//   a multiple of 8 but not of 64 needs no other mask; weight columns past
//   n are never stored.
// - The epilogue multiplies the f32 sums by the column scale (the Pallas
//   kernel's y * s) and casts, straight from the accumulator registers:
//   four adjacent columns a thread, one 16-byte (f32) or 8-byte (bf16)
//   store a row.
// - Split-K over d where the blocks would not fill the card: the wrapper
//   picks (row tile, splits, rows of d a split) from (m, d, n) and the SM
//   count alone; each split writes its f32 sums and the GEMV's merge kernel
//   adds them in split order, scales and casts.
// What holds it back (on an H100, a 7B layer's seven projections: 0.45 ms at
// 391 rows, 1.3x torch.mm over the upcast weight, 1.49 ms at 2048, 1.06x;
// PERF.md): as in the int4 transpose kernel, a stage takes a fixed ~0.55 us
// a wave that the products do not hide, and at a few hundred rows the
// blocks fill the card only with split-K, whose f32 partials cost 8 bytes
// an output element a split.
//
// An f32 x takes the GEMV at any row count: its products are exact f32
// FMAs. On the tensor cores it would have to be split into three bf16 parts
// (hi + mid + lo), whose sums the tensor cores' f32 accumulation rounds
// more coarsely than FMAs do: that version put the 7B decoder's fp32 output
// 7.5e-5 (relative L2, on an H100) from the plain path, against the 1e-4 it
// is held to. f32 inputs serve the references, not the decoder.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_tc.cuh"
#include "mma.cuh"
#include "weight_gemm.cuh"

namespace {

// the GEMV
constexpr int kGemvThreads = 256;
constexpr int kCols = 16;                              // columns per thread
constexpr int kGemvCols = 256;                         // columns per block
constexpr int kSlabs = kGemvCols / kCols;              // threads across a row: 16
constexpr int kLanes = kGemvThreads / kSlabs;          // threads down the rows: 16

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

template <typename To, int N>
cudaError_t launch_tc(const void* x, const void* w8, const float* scale, float* part, To* out,
                      int m, int d, int n, int splits, int per, cudaStream_t stream) {
  using L = hv::TcTile<N>;
  CUtensorMap tm_x, tm_w;
  if (!hv::tc_maps<N>(&tm_x, &tm_w, x, w8, m, d, n)) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = hv::allow_smem(hv::int8_tc_kernel<N, To, false>, L::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int kt = (d + hv::kTcKS - 1) / hv::kTcKS;
  const dim3 grid((m + N - 1) / N, (n + hv::kTcCols - 1) / hv::kTcCols, splits);
  // no low-rank term: tm_x stands in for its unread map
  hv::int8_tc_kernel<N, To, false><<<grid, hv::kTcThreads, L::kSmem, stream>>>(
      tm_x, tm_w, tm_x, scale, nullptr, out, splits > 1 ? part : nullptr, m, n, kt,
      per / hv::kTcKS, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)m * n;
  int8_gemv_merge_kernel<To><<<(unsigned)((mn + kGemvThreads - 1) / kGemvThreads), kGemvThreads,
                               0, stream>>>(part, scale, out, splits, n, mn);
  return cudaGetLastError();
}

template <typename T, typename To>
cudaError_t launch(const void* x, const void* w8, const void* scale, void* part, void* out,
                   int tensor_cores, int m, int d, int n, int n_split, int rows_per_split,
                   int rows_tile, cudaStream_t stream) {
  const float* st = static_cast<const float*>(scale);
  float* pf = static_cast<float*>(part);
  To* ot = static_cast<To*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tensor_cores)
      return hv::with_rows_tile(rows_tile, [&](auto rows) {
        return launch_tc<To, decltype(rows)::value>(x, w8, st, pf, ot, m, d, n, n_split,
                                                    rows_per_split, stream);
      });
  }
  const dim3 grid((n + kGemvCols - 1) / kGemvCols, n_split, m);
  int8_gemv_kernel<T><<<grid, kGemvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w8), pf, m, d, n, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)m * n;
  int8_gemv_merge_kernel<To><<<(unsigned)((mn + kGemvThreads - 1) / kGemvThreads),
                               kGemvThreads, 0, stream>>>(pf, st, ot, n_split, n, mn);
  return cudaGetLastError();
}

}  // namespace

// x (m, d) bf16 (x_bf16 = 1) or f32, contiguous and 16-byte aligned; w8
// (d, n) int8 and scale (n,) f32: views of one layer (16-byte aligned);
// out (m, n) in f32 (out_f32 = 1) or x's dtype. d is a multiple of 8, n of
// 16. Split s covers rows [s*rows_per_split, (s+1)*rows_per_split) of d,
// writing f32 sums to the scratch part (n_split, m, n) that a second kernel
// adds in split order. tensor_cores = 0: the GEMV, 256-column blocks;
// 1 (bf16 x only): wgmma, 256 columns x rows_tile rows a block (16, 32, 64,
// 104 or 128), rows_per_split a multiple of 64, part unused for one split.
// Returns cudaGetLastError().
extern "C" int hv_int8_matmul(const void* x, const void* w8, const void* scale, void* part,
                              void* out, int x_bf16, int out_f32, int tensor_cores, int m,
                              int d, int n, int n_split, int rows_per_split, int rows_tile,
                              void* stream) {
  if (m < 1 || d < 8 || d % 8 || n < 16 || n % 16 || (!x_bf16 && (!out_f32 || tensor_cores)) ||
      n_split < 1 || n_split > 65535 || rows_per_split < 1 ||
      (long long)(n_split - 1) * rows_per_split >= d || (long long)n_split * rows_per_split < d ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!tensor_cores && (m > 65535 || part == nullptr)) return (int)cudaErrorInvalidValue;
  if (tensor_cores &&
      (rows_per_split % hv::kTcKS || (n + hv::kTcCols - 1) / hv::kTcCols > 65535))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w8) |
       reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16)
    return (int)launch<float, float>(x, w8, scale, part, out, tensor_cores, m, d, n, n_split,
                                     rows_per_split, rows_tile, st);
  if (out_f32)
    return (int)launch<__nv_bfloat16, float>(x, w8, scale, part, out, tensor_cores, m, d, n,
                                             n_split, rows_per_split, rows_tile, st);
  return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w8, scale, part, out, tensor_cores, m,
                                                   d, n, n_split, rows_per_split, rows_tile,
                                                   st);
}
