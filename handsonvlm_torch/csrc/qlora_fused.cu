// The fused QLoRA matmuls over an int8 base with a LoRA epilogue, for
// Hopper (sm_90a), on wgmma fed by TMA: the forward and the input gradient
// of every projection of the int8_fused train step.
//
// Replaces two pallas_calls of handsonvlm_tpu/ops/qlora_fused.py:
// _fwd_call (B10a, kernels _fwd_kernel and _fwd_lora_kernel) and _bwd_call
// (B10b, kernels _bwd_kernel and _bwd_lora_kernel). The numerics are the
// Pallas kernels':
// - forward: o = bf16(x) @ bf16(W8[l]) with f32 sums, times the column
//   scale s[l] in f32 once, plus (with an adapter) u_s @ b in f32, where
//   u_s = (bf16(x) @ bf16(a)) * ls is computed outside; one cast to bf16.
//   bf16(int8) is exact, so the base product is exact up to f32 summation;
// - backward: dx = bf16(g) @ (bf16(W8[l]) * bf16(s[l]))^T, the scale folded
//   into the bf16 dequantization (n is the contraction here), f32 sums,
//   plus (with an adapter) v_s @ a^T in f32, v_s = (bf16(g) @ bf16(b)^T) *
//   ls computed outside; one cast to bf16.
// The adapter term enters the f32 accumulator before the single rounding,
// so the full-width delta never exists in device memory.
//
// The kernel bodies are shared with the int8 and int4 weight-only matmuls:
// - B10a is B9's tensor-core route (csrc/int8_tc.cuh) with the term:
//   y^T = W8^T x^T, the weight made bf16 in registers as wgmma's A operand,
//   x the K-major B operand brought by TMA (one thread of a producer
//   warpgroup, whose registers setmaxnreg hands to the consumers) through
//   a six-stage mbarrier ring, two consumer warpgroups of 128 weight columns;
//   after the last stage of d the f32 sums are scaled by s in registers,
//   then the rank is walked in stages of 64: b^T the A operand (read from
//   global memory as packed fragments, below), u_s^T the B operand
//   (through the same ring).
// - B10b is B7's transpose route (csrc/transpose_tc.cuh) over int8 rows:
//   dx^T = (W8 diag(s)) g^T, rows of d the A operand, each weight made
//   bf16(bf16(byte) * bf16(s[col])) in registers (one rounding of an exact
//   product, as the Pallas kernel's), g the K-major B operand; a stage is
//   g's [N][64] box, W8's [256][64] byte box and its 64 scales; then the
//   rank in stages of 64, a's rows the A operand, v_s^T the B operand.
// The term runs on the tensor cores in f32 precision: each f32 operand is a
// bf16 high part plus a bf16 rest, and hi hi + hi lo + lo hi (each product
// exact in f32) drops only lo lo, about 2^-16 of the term. Two small kernels
// here prepare the operands: u_s / v_s split into a (2, m, rp) bf16 scratch
// buffer (rp the rank rounded up to 64, zeros past r) that TMA reads, and b
// / a split and packed in the order of wgmma's A registers, so a thread
// loads a sub-tile's fragments of a step in one 16-byte load a part (the
// term's steps then need 16 registers, as the base steps do: splitting in
// the kernel made ptxas serialise the wgmmas for want of registers). Any
// rank (r = 0: no term) and any row count: the wrapper picks the row tile
// (wgmma's N: 16, 32, 64, 104 or 128) and the split-K plan from the shapes
// and the SM count (B9's and B7's time model).
// Under split-K the term is one more split, the last, which holds the term
// alone; the merge adds the base splits in split order, scales (B10a) and
// adds the term's split once, so the bits do not depend on the schedule.
// Ragged edges: rows past m, rows of d and columns of n past their ends
// arrive as zeros by TMA and are not stored.
//
// Bound: operations at training sizes. At m = 2048 a 7B layer's seven
// projections are 829 GFLOP of base products (0.84 ms at 989 TFLOP/s bf16);
// at r = 128 the term's three bf16 products add 67 GFLOP forward and 56
// backward on the tensor cores. The bytes (202 MB of int8 weights and the
// activations) bound it below 0.16 ms. An f32 FMA epilogue instead would
// be bound below by 0.33 / 0.28 ms a layer at 67 TFLOP/s unless another
// tile's products hid it (a persistent schedule, untried).
// What holds them back (on an H100, a layer's seven projections at m =
// 2048, r = 128; PERF.md): B10a 1.65 ms (0.70x torch.mm over the upcast
// weight plus the delta), B10b 1.80 ms (0.94x). The base products stop
// where B9's and B7's do (a fixed ~0.55 us a stage a wave not hidden); the
// term adds 0.17 / 0.14 ms against its 0.07 of tensor time, its fragments
// read from L2 one k16 step ahead (latency partly exposed) and its
// operands prepared by two small kernels a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tc.cuh"
#include "mma.cuh"
#include "transpose_tc.cuh"
#include "weight_gemm.cuh"

namespace {

constexpr int kRankStep = 64;  // the rank of one adapter stage

// x (m, r) f32 -> out (2, m, rp) bf16: out[0] = bf16(x), out[1] = bf16(x -
// out[0]), zeros at ranks r .. rp - 1: the term's B operand for TMA
__global__ void split_rows_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
                                  int64_t m, int r, int rp) {
  const int64_t total = m * rp;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / rp;
    const int k = (int)(i % rp);
    const float v = k < r ? x[row * r + k] : 0.f;
    const __nv_bfloat16 h = __float2bfloat16(v);
    out[i] = h;
    out[total + i] = __float2bfloat16(v - __bfloat162float(h));
  }
}

// The term's A operand as wgmma fragments in registers' order: frag[h][ks][p]
// [t], a uint4 holding the four A registers of thread t (lane % 4) for the
// pair p of A rows (A rows g and g + 8 of a warp) at k16 step ks; h = 0 the
// bf16 high parts, 1 the rests (x - hi, rounded). Register j holds ranks
// (k, k + 1), k = 16 ks + 2t + 8 (j >> 1), of the pair's row j & 1.
// Forward (B10a, A = b^T, x = b (r, rows = n)): pair p is columns 2p, 2p +
// 1, element (row, k) at x[k * rows + row]. Backward (B10b, x = a (rows =
// d, r)): pair 128 j + i is rows 256 j + i and 256 j + 128 + i, element at
// x[row * r + k]. Rows past `rows` and ranks past r are zeros.
__global__ void pack_frags_kernel(const float* __restrict__ x, uint4* __restrict__ frag,
                                  int rows, int r, int64_t steps, int64_t pairs, int backward) {
  const int64_t total = steps * pairs * 4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int t = (int)(i % 4);
    const int64_t p = i / 4 % pairs;
    const int k0 = (int)(i / 4 / pairs) * 16 + 2 * t;
    const int64_t r0 = backward ? p / 128 * 256 + p % 128 : 2 * p;
    const int64_t r1 = backward ? r0 + 128 : r0 + 1;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t row = j & 1 ? r1 : r0;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + 8 * (j >> 1) + e;
        v[e] = row < rows && k < r ? x[backward ? row * r + k : (int64_t)k * rows + row] : 0.f;
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
      hi[j] = hv::as_u32(h);
      lo[j] = hv::pack_bf16(v[0] - __low2float(h), v[1] - __high2float(h));
    }
    frag[i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    frag[total + i] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// B10a's split-K merge: out = bf16((sum over s < splits of part[s], s
// ascending) * scale + part[splits] where the term has its split)
__global__ void fwd_merge_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                 __nv_bfloat16* __restrict__ out, int splits, int lora, int n,
                                 int64_t mn) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += part[(int64_t)p * mn + i];
    float v = s * scale[i % n];
    if (lora) v += part[(int64_t)splits * mn + i];
    out[i] = __float2bfloat16(v);
  }
}

// the adapter operand's (2, m, rp) bf16 parts -> [N][64] boxes (128-byte
// swizzle), the B operand of the term's products
template <int N>
bool parts_map(CUtensorMap* map, const void* parts, int m, int rp) {
  const uint64_t dims[3] = {(uint64_t)rp, (uint64_t)m, 2};
  const uint64_t strides[2] = {(uint64_t)rp * 2, (uint64_t)m * rp * 2};
  const uint32_t box[3] = {kRankStep, N, 1};
  return hv::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, parts, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int N>
cudaError_t launch_fwd(const void* x, const void* w8, const float* scale, const void* us2,
                       const uint4* frag, float* part, __nv_bfloat16* out, int m, int d, int n,
                       int r, int rp, int splits, int per, cudaStream_t stream) {
  using L = hv::TcTile<N>;
  CUtensorMap tm_x, tm_w, tm_u;
  if (!hv::tc_maps<N>(&tm_x, &tm_w, x, w8, m, d, n)) return cudaErrorInvalidValue;
  if (r > 0 && !parts_map<N>(&tm_u, us2, m, rp)) return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err =
      hv::allow_smem(hv::int8_tc_kernel<N, __nv_bfloat16, true>, L::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int kt = (d + hv::kTcKS - 1) / hv::kTcKS;
  const int lora_split = splits > 1 && r > 0;
  const dim3 grid((m + N - 1) / N, (n + hv::kTcCols - 1) / hv::kTcCols, splits + lora_split);
  // without a term tm_x stands in for its unread map
  hv::int8_tc_kernel<N, __nv_bfloat16, true><<<grid, hv::kTcThreads, L::kSmem, stream>>>(
      tm_x, tm_w, r > 0 ? tm_u : tm_x, scale, frag, out, splits > 1 ? part : nullptr, m, n, kt,
      per / hv::kTcKS, r);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t mn = (int64_t)m * n;
  fwd_merge_kernel<<<hv::grid_for(mn), 256, 0, stream>>>(part, scale, out, splits, lora_split,
                                                          n, mn);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_bwd(const void* g, const void* w8, const void* scale, const void* vs2,
                       const uint4* frag, float* part, void* out, int m, int d, int n, int r,
                       int rp, int splits, int per, cudaStream_t stream) {
  using L = hv::TrTile<N, true>;
  CUtensorMap tm_g, tm_w, tm_s, tm_v;
  const uint64_t g_dims[2] = {(uint64_t)n, (uint64_t)m}, g_strides[1] = {(uint64_t)n * 2};
  const uint32_t g_box[2] = {hv::kTrKS, N};
  const uint64_t w_dims[2] = {(uint64_t)n, (uint64_t)d}, w_strides[1] = {(uint64_t)n};
  const uint32_t w_box[2] = {hv::kTrKS, 2 * hv::kTrRows};
  const uint64_t s_dims[2] = {(uint64_t)n, 1}, s_strides[1] = {(uint64_t)n * 4};
  const uint32_t s_box[2] = {hv::kTrKS, 1};
  if (!hv::tensor_map(&tm_g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g, g_dims, g_strides, g_box,
                      CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hv::tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w8, w_dims, w_strides, w_box,
                      CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hv::tensor_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scale, s_dims, s_strides, s_box,
                      CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (r > 0 && !parts_map<N>(&tm_v, vs2, m, rp)))
    return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t err = hv::allow_smem(hv::transpose_kernel<N, true>, L::kSmem, configured);
  if (err != cudaSuccess) return err;
  const int blocks_d = (d + 2 * hv::kTrRows - 1) / (2 * hv::kTrRows);
  const int lora_split = splits > 1 && r > 0;
  const dim3 grid((m + N - 1) / N, blocks_d, splits + lora_split);
  // a block takes 256 rows of d: the int4 form's geometry with groups of
  // 256 rows (half = 128, G = the blocks); without a term tm_g stands in
  // for its unread map
  hv::transpose_kernel<N, true><<<grid, hv::kTrThreads, L::kSmem, stream>>>(
      tm_g, tm_w, tm_s, r > 0 ? tm_v : tm_g, frag, out, splits > 1 ? part : nullptr, 1, m, d,
      blocks_d, hv::kTrRows, n, (n + hv::kTrKS - 1) / hv::kTrKS, per, r);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t vecs = (int64_t)m * d / 4;
  hv::merge_splits_kernel<<<hv::grid_for(vecs), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), out, 1, vecs, splits + lora_split);
  return cudaGetLastError();
}

// the term's operands: lhs (m, r) f32 split into lhs2 (2, m, rp) bf16 (the
// B operand), rhs packed into rhs2 as A fragments over `pairs` row pairs
cudaError_t prepare_term(const void* lhs, void* lhs2, const void* rhs, void* rhs2, int m,
                         int rows, int r, int rp, int64_t pairs, int backward,
                         cudaStream_t stream) {
  split_rows_kernel<<<hv::grid_for((int64_t)m * rp), 256, 0, stream>>>(
      static_cast<const float*>(lhs), static_cast<__nv_bfloat16*>(lhs2), m, r, rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t steps = rp / 16;
  pack_frags_kernel<<<hv::grid_for(steps * pairs * 4), 256, 0, stream>>>(
      static_cast<const float*>(rhs), static_cast<uint4*>(rhs2), rows, r, steps, pairs,
      backward);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// the shared checks of both entry points: shapes, the adapter's operands,
// the split plan over `stages` stages, alignment
int check_call(const void* in, const void* w8, const void* scale, const void* lhs,
               const void* rhs, const void* lhs2, const void* rhs2, const void* part,
               const void* out, int m, int d, int n, int r, int splits, int per, int stages,
               int blocks) {
  if (m < 1 || d < 8 || d % 8 || n < 16 || n % 16 || r < 0 ||
      (r > 0 && (!lhs || !rhs || !lhs2 || !rhs2)) || splits < 1 || splits > 65534 || per < 1 ||
      (int64_t)(splits - 1) * per >= stages || (int64_t)splits * per < stages ||
      (splits > 1 && !part) || blocks > 65535)
    return (int)cudaErrorInvalidValue;
  if (misaligned(in) || misaligned(w8) || misaligned(scale) || misaligned(out) ||
      misaligned(lhs2) || misaligned(rhs2) || misaligned(part))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// Forward (B10a). x (m, d) bf16, contiguous; w8 (d, n) int8 and scale (n,)
// f32: views of one layer; us (m, r) and b (r, n) f32, contiguous, or null
// with r = 0 (no adapter); with r > 0 the scratch buffers us2 (2, m, rp)
// bf16 and b2 (2, rp, n) bf16, rp = ceil(r / 64) * 64; part an f32 (splits +
// (r > 0), m, n) scratch buffer (splits > 1); out (m, n) bf16. d is a
// multiple of 8, n of 16; x, w8, scale, the scratch buffers and out 16-byte
// aligned. rows_tile (wgmma's N) is 16, 32, 64, 104 or 128; split s takes
// the rows [s * rows_per_split, (s + 1) * rows_per_split) of d,
// rows_per_split a multiple of 64. Returns cudaGetLastError().
extern "C" int hv_qlora_fwd(const void* x, const void* w8, const void* scale, const void* us,
                            const void* b, void* us2, void* b2, void* part, void* out, int m,
                            int d, int n, int r, int rows_tile, int splits, int rows_per_split,
                            void* stream) {
  if (rows_per_split % hv::kTcKS) return (int)cudaErrorInvalidValue;
  const int status =
      check_call(x, w8, scale, us, b, us2, b2, part, out, m, d, n, r, splits,
                 rows_per_split / hv::kTcKS, (d + hv::kTcKS - 1) / hv::kTcKS,
                 (n + hv::kTcCols - 1) / hv::kTcCols);
  if (status) return status;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rp = (r + kRankStep - 1) / kRankStep * kRankStep;
  if (r > 0) {
    const cudaError_t err = prepare_term(us, us2, b, b2, m, n, r, rp, n / 2, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)hv::with_rows_tile(rows_tile, [&](auto rows) {
    return launch_fwd<decltype(rows)::value>(
        x, w8, static_cast<const float*>(scale), us2, static_cast<const uint4*>(b2),
        static_cast<float*>(part), static_cast<__nv_bfloat16*>(out), m, d, n, r, rp, splits,
        rows_per_split, st);
  });
}

// Input gradient (B10b). g (m, n) bf16, contiguous; w8 (d, n) int8 and
// scale (n,) f32: views of one layer; vs (m, r) and a (d, r) f32,
// contiguous, or null with r = 0; with r > 0 the scratch buffers vs2 (2, m,
// rp) bf16 and a2 (2, rp, ceil(d / 256) * 256) bf16; part an f32 (splits +
// (r > 0), m, d) scratch buffer (splits > 1); out (m, d) bf16. d is a
// multiple of 8, n of 16; g, w8, scale, the scratch buffers and out 16-byte
// aligned. rows_tile as B10a's; split s takes the 64-column stages [s * per,
// (s + 1) * per) of n, ascending. Returns cudaGetLastError().
extern "C" int hv_qlora_bwd(const void* g, const void* w8, const void* scale, const void* vs,
                            const void* a, void* vs2, void* a2, void* part, void* out, int m,
                            int d, int n, int r, int rows_tile, int splits, int per,
                            void* stream) {
  const int blocks_d = (d + 2 * hv::kTrRows - 1) / (2 * hv::kTrRows);
  const int status = check_call(g, w8, scale, vs, a, vs2, a2, part, out, m, d, n, r, splits,
                                per, (n + hv::kTrKS - 1) / hv::kTrKS, blocks_d);
  if (status) return status;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rp = (r + kRankStep - 1) / kRankStep * kRankStep;
  if (r > 0) {
    const cudaError_t err =
        prepare_term(vs, vs2, a, a2, m, d, r, rp, (int64_t)blocks_d * hv::kTrRows, 1, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)hv::with_rows_tile(rows_tile, [&](auto rows) {
    return launch_bwd<decltype(rows)::value>(g, w8, scale, vs2, static_cast<const uint4*>(a2),
                                             static_cast<float*>(part), out, m, d, n, r, rp,
                                             splits, per, st);
  });
}
