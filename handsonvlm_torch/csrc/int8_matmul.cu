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
// Below INT8_TC_MIN_M rows (the wrapper's choice): the GEMV of
// csrc/gemv.cuh with the int8 decoder (Int8Dec), one launch a call: 128
// columns, up to 8 rows of x and one split of d (64-row stages, up to 8
// splits merged in a thread block cluster) a block; a bf16 x on mma.sync
// (a register: the bf16 pair of one column's bytes of rows 2t, 2t + 1),
// an f32 x on FMAs. The wrapper sizes the splits of d from the weight and
// the SM count alone, so row i of a window or a slot batch sums in the same
// order as the same row alone (the speculative loop's greedy identity rests
// on it); the column scale applies to the merged f32 sum before the cast.
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
//   count alone; each split writes its f32 sums and a merge kernel adds
//   them in split order, scales and casts.
// What holds it back (on an H100, a 7B layer's seven projections: 0.45 ms at
// 391 rows, 1.3x torch.mm over the upcast weight, 1.49 ms at 2048, 1.06x;
// PERF.md): as in the int4 transpose kernel, a stage takes a fixed ~0.55 us
// a wave that the products do not hide, and at a few hundred rows the
// blocks fill the card only with split-K, whose f32 partials cost 8 bytes
// an output element a split.
//
// An f32 x takes the GEMV at any row count (row tiles of 8): its products
// are exact f32 FMAs. On the tensor cores it would have to be split into
// three bf16 parts (hi + mid + lo), whose sums the tensor cores' f32
// accumulation rounds more coarsely than FMAs do: that version put the 7B
// decoder's fp32 output 7.5e-5 (relative L2, on an H100) from the plain
// path, against the 1e-4 it is held to. f32 inputs serve the references,
// not the decoder.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemv.cuh"
#include "int8_tc.cuh"
#include "mma.cuh"
#include "weight_gemm.cuh"

namespace {

constexpr int kMergeThreads = 256;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the tensor cores' split-K: out = (sum over splits in order) * scale, cast
template <typename To>
__global__ void __launch_bounds__(kMergeThreads)
    int8_split_merge_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                            To* __restrict__ out, int n_split, int n, size_t mn) {
  const size_t i = (size_t)blockIdx.x * kMergeThreads + threadIdx.x;
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
  int8_split_merge_kernel<To><<<(unsigned)((mn + kMergeThreads - 1) / kMergeThreads),
                                kMergeThreads, 0, stream>>>(part, scale, out, splits, n, mn);
  return cudaGetLastError();
}

template <typename T, typename To>
cudaError_t launch(const void* x, const void* w8, const void* scale, void* part, void* out,
                   int tensor_cores, int m, int d, int n, int n_split, int rows_per_split,
                   int rows_tile, cudaStream_t stream) {
  const float* st = static_cast<const float*>(scale);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tensor_cores)
      return hv::with_rows_tile(rows_tile, [&](auto rows) {
        return launch_tc<To, decltype(rows)::value>(x, w8, st, static_cast<float*>(part),
                                                    static_cast<To*>(out), m, d, n, n_split,
                                                    rows_per_split, stream);
      });
  }
  // the GEMV: rows_per_split is a multiple of the 64-row stage
  CUtensorMap tm_w, tm_x;
  if (!hv::gemv_w_map(&tm_w, w8, d, n, 64)) return cudaErrorInvalidValue;
  hv::GemvArgs a = {};
  a.x = x;
  a.scale = st;
  a.out = out;
  a.m = m;
  a.d = d;
  a.n_out = n;
  a.units = (d + 63) / 64;
  a.per = rows_per_split / 64;
  a.bn = n;
  a.cpt = (n + hv::kGvCols - 1) / hv::kGvCols;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!hv::gemv_x_map(&tm_x, x, m, d)) return cudaErrorInvalidValue;
  } else {
    tm_x = tm_w;  // an f32 x is read directly: the map goes unread
  }
  return hv::launch_gemv<hv::Int8Dec, T, To>(tm_w, tm_w, tm_x, a, n_split, a.cpt, stream);
}

}  // namespace

// x (m, d) bf16 (x_bf16 = 1) or f32, contiguous and 16-byte aligned; w8
// (d, n) int8 and scale (n,) f32: views of one layer (16-byte aligned);
// out (m, n) in f32 (out_f32 = 1) or x's dtype. d is a multiple of 8, n of
// 16. Split s covers rows [s*rows_per_split, (s+1)*rows_per_split) of d,
// rows_per_split a multiple of 64. tensor_cores = 0: the GEMV (csrc/gemv.cuh),
// 128 columns x 8 rows a block, at most 8 splits merged in the launch, part
// unused; 1 (bf16 x only): wgmma, 256 columns x rows_tile rows a block (16,
// 32, 64, 104 or 128), the splits' f32 sums written to the scratch part
// (n_split, m, n) that a second kernel adds in split order (part unused for
// one split). Returns cudaGetLastError().
extern "C" int hv_int8_matmul(const void* x, const void* w8, const void* scale, void* part,
                              void* out, int x_bf16, int out_f32, int tensor_cores, int m,
                              int d, int n, int n_split, int rows_per_split, int rows_tile,
                              void* stream) {
  if (m < 1 || d < 8 || d % 8 || n < 16 || n % 16 || (!x_bf16 && (!out_f32 || tensor_cores)) ||
      n_split < 1 || n_split > 65535 || rows_per_split < 1 || rows_per_split % 64 ||
      (long long)(n_split - 1) * rows_per_split >= d || (long long)n_split * rows_per_split < d)
    return (int)cudaErrorInvalidValue;
  if (!tensor_cores &&
      (n_split > hv::kGvMaxSplits || (m + hv::kGvRows - 1) / hv::kGvRows > 65535 ||
       (n + hv::kGvCols - 1) / hv::kGvCols > 65535))
    return (int)cudaErrorInvalidValue;
  if (tensor_cores && ((n_split > 1 && part == nullptr) ||
                       (n + hv::kTcCols - 1) / hv::kTcCols > 65535))
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
