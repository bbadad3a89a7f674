// The int4 transpose matmul dx = dy @ dequant(W[layer])^T over the tiled and
// the flat layout, for Hopper (sm_90a), on the tensor cores through wgmma:
// the input gradient through a frozen int4 projection (QLoRA). The kernel
// body is in csrc/transpose_tc.cuh, which B10b (csrc/qlora_fused.cu)
// instantiates over int8 weights with a low-rank term.
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
// Bound: operations at training sizes. At m = 2048 a 7B layer's four fused
// projections (202.4 M weights) are 829 GFLOP, 0.84 ms at 989 TFLOP/s
// bf16; at m = 16 the 101 MB of packed weights bound it, 0.033 ms at 3.35
// TB/s. The design is the int4 prefill kernel's (csrc/int4_prefill.cu)
// turned around the packed bytes, fed by TMA:
// - The product is computed transposed, dx^T = W dy^T: wgmma's A operand
//   (64 rows of d x 16 columns of n, in registers) is the weight,
//   dequantized in registers; the B operand (16 columns of n x N rows of m,
//   wgmma's N) is dy from shared memory. The contraction runs over n, which
//   is contiguous in the packed bytes. m is wgmma's N (16, 32, 64, 104 or
//   128, the wrapper's choice), so 16 rows no longer pad to 64.
// - A warp's A rows g and g + 8 are the low and the high nibble of one
//   packed byte row: every byte feeds both of its weights and each (group,
//   column) scale serves both. Thread (g, t) reads bytes 2t, 2t+1, 2t+8 and
//   2t+9 of its k16 step of one staged byte row (two 2-byte reads), makes
//   each nibble an exact bf16 by OR-ing it into the mantissa of 128.0 and
//   subtracting 136.0, and multiplies by the bf16 scale pair (one rounding
//   of an exact product, as the Pallas kernel's bf16 multiply).
// - A block: two consumer warpgroups, each two 64-row sub-tiles (128 packed
//   rows, 256 rows of d: two whole groups at 7B) x N rows of m, and a
//   producer warpgroup whose registers setmaxnreg moves to the consumers
//   (as in B9). Two register sets alternate, so a k16 step's
//   dequantization runs while the last step's products are in flight.
// - One producer thread keeps a ring of stages (six, eight for N <= 32)
//   full by TMA, one mbarrier a stage for the bytes and one for the
//   consumer warps' release: a stage is 64 columns of n: dy's [N][64] box
//   (bf16, 128-byte swizzle, K-major: wgmma reads it in place), the packed
//   bytes' [128 rows][64] box (64-byte swizzle, so the four byte rows a warp
//   reads at once fall on distinct banks) and the groups' 64 scales.
//   Rows of m past its end and packed rows past d arrive as zeros.
// - The tile leaves through shared memory: its d rows are [low half, high
//   half] of each group, so the f32 tile is staged as [N][low 128 | high
//   128] and each row of dx leaves as 16-byte stores of runs of 8 (bf16) or
//   4 (f32) consecutive features.
// - Split-K over n where the blocks would not fill the card (m = 16): the
//   wrapper picks (row tile, splits, stages per split) from (m, n, d) and
//   the SM count alone; each split writes f32 partials and a second kernel
//   sums them in split order, so the bits do not depend on the schedule.
// What holds it back (on an H100: 1.48 ms for a 7B layer's four
// projections at m = 2048, 1.4x torch.mm over the dequantized weight, 57% of
// the tensor rate; PERF.md has the measurements): a stage takes ~0.9 us a
// wave at 128-row tiles, so a fixed ~0.55 us a stage is not hidden. Four
// register sets with three product groups in flight were no faster;
// sharing the dy and weight boxes between neighbouring blocks (TMA
// multicast over a cluster) is untried.
// Every output element is the same sequence of k16 products whatever the
// layout, so B7a gives B7b's bits on the same weight. An f32 dy is first
// rounded to bf16 by a small conversion kernel into the wrapper's scratch
// buffer; the output keeps dy's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "transpose_tc.cuh"
#include "weight_gemm.cuh"

namespace {

template <int N>
cudaError_t launch(const void* dyb, const void* w4t, const void* gst, void* out, float* part,
                   int out_bf16, int m, int NB, int G, int half, int BN, int splits, int per,
                   cudaStream_t stream) {
  using L = hv::TrTile<N, false>;
  const int n = NB * BN, prows = G * half;
  const uint32_t sg = half <= hv::kTrRows ? hv::kTrRows / half : 1;
  CUtensorMap tm_dy, tm_w, tm_s;
  const uint64_t dy_dims[2] = {(uint64_t)n, (uint64_t)m}, dy_strides[1] = {(uint64_t)n * 2};
  const uint32_t dy_box[2] = {hv::kTrKS, N};
  const uint64_t w_dims[3] = {(uint64_t)BN, (uint64_t)prows, (uint64_t)NB};
  const uint64_t w_strides[2] = {(uint64_t)BN, (uint64_t)prows * BN};
  const uint32_t w_box[3] = {hv::kTrKS, hv::kTrRows, 1};
  const uint64_t s_dims[3] = {(uint64_t)BN, (uint64_t)G, (uint64_t)NB};
  const uint64_t s_strides[2] = {(uint64_t)BN * 4, (uint64_t)G * BN * 4};
  const uint32_t s_box[3] = {hv::kTrKS, sg, 1};
  if (!hv::tensor_map(&tm_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dyb, dy_dims, dy_strides,
                      dy_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hv::tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w4t, w_dims, w_strides, w_box,
                      CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hv::tensor_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, gst, s_dims, s_strides, s_box,
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static bool configured = false;
  const cudaError_t err = hv::allow_smem(hv::transpose_kernel<N, false>, L::kSmem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + N - 1) / N, (prows + hv::kTrRows - 1) / hv::kTrRows, splits);
  // no low-rank term: tm_dy stands in for its unread map
  hv::transpose_kernel<N, false><<<grid, hv::kTrThreads, L::kSmem, stream>>>(
      tm_dy, tm_w, tm_s, tm_dy, nullptr, out, splits > 1 ? part : nullptr, out_bf16, m,
      2 * prows, G, half, BN, n / hv::kTrKS, per, 0);
  return cudaGetLastError();
}

}  // namespace

// dy (m, NB*BN) and out (m, d = G*2*half) of one dtype (bf16 or f32),
// contiguous; dyb a bf16 (m, NB*BN) scratch buffer (used when dy is f32);
// part an f32 (splits, m, d) scratch buffer (used when splits > 1);
// w4t_layer (NB, G, half, BN) int8 and gst_layer (NB, G, BN) f32: views of
// one layer of the stacked tiles (the flat layout passes NB = 1, BN = n);
// all 16-byte aligned. BN is a multiple of 64, half of 32 and either
// divides 128 or is a multiple of it (groups of 64, 128 or 256k rows);
// rows_tile (wgmma's N) is 16, 32, 64, 104 or 128; split s takes the
// 64-column stages [s*per, min(n/64, (s+1)*per)) of n. Returns
// cudaGetLastError().
extern "C" int hv_int4_transpose(const void* dy, void* dyb, const void* w4t_layer,
                                 const void* gst_layer, void* part, void* out, int is_bf16,
                                 int m, int NB, int G, int half, int BN, int rows_tile,
                                 int splits, int per, void* stream) {
  const int64_t kt = (int64_t)NB * BN / hv::kTrKS;
  if (BN % hv::kTrKS || half % 32 ||
      (half <= hv::kTrRows ? hv::kTrRows % half : half % hv::kTrRows) || m < 1 || G < 1 ||
      NB < 1 || splits < 1 || per < 1 || (int64_t)(splits - 1) * per >= kt ||
      (int64_t)splits * per < kt || splits > 65535 || (int64_t)G * half / hv::kTrRows >= 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dyb) |
       reinterpret_cast<uintptr_t>(w4t_layer) | reinterpret_cast<uintptr_t>(gst_layer) |
       reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)NB * BN, d = (int64_t)G * 2 * half;
  const void* dyh = dy;
  if (!is_bf16) {
    const int64_t vecs = m * n / 8;
    hv::to_bf16_kernel<<<hv::grid_for(vecs), 256, 0, st>>>(static_cast<const float4*>(dy),
                                                          static_cast<uint4*>(dyb), vecs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dyh = dyb;
  }
  float* pf = static_cast<float*>(part);
  const cudaError_t err = hv::with_rows_tile(rows_tile, [&](auto rows) {
    return launch<decltype(rows)::value>(dyh, w4t_layer, gst_layer, out, pf, is_bf16, m, NB, G,
                                         half, BN, splits, per, st);
  });
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t vecs = m * d / 4;
  hv::merge_splits_kernel<<<hv::grid_for(vecs), 256, 0, st>>>(static_cast<const float4*>(part),
                                                             out, is_bf16, vecs, splits);
  return (int)cudaGetLastError();
}
