// The int4 transpose matmul dx = dy @ dequant(W[layer])^T over the tiled and
// the flat layout, for Hopper (sm_90a), on the tensor cores through wgmma:
// the input gradient through a frozen int4 projection (QLoRA).
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
//   rows, 256 rows of d: two whole groups at 7B) x N rows of m, and one
//   producer warp. Two register sets alternate, so a k16 step's
//   dequantization runs while the last step's products are in flight.
// - The producer warp keeps a ring of stages (six, eight for N <= 32)
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
// What holds it back (on an H100: 1.65 ms for a 7B layer's four
// projections at m = 2048, 1.6x torch.mm over the dequantized weight, 51% of
// the tensor rate; PERF.md has the measurements): a stage takes ~1 us a
// wave at 128-row tiles and ~0.8 us at 64, so a fixed ~0.55 us a stage is
// not hidden. Four register sets with three product groups in flight were
// no faster; sharing the dy and weight boxes between neighbouring blocks
// (TMA multicast over a cluster) is untried.
// Every output element is the same sequence of k16 products whatever the
// layout, so B7a gives B7b's bits on the same weight. An f32 dy is first
// rounded to bf16 by a small conversion kernel into the wrapper's scratch
// buffer; the output keeps dy's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "weight_gemm.cuh"

namespace {

constexpr int kWG = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * kWG + 32;    // and one producer warp
constexpr int kRows = 64 * kWG;             // packed rows a block: 2 x kRows rows of d
constexpr int kKS = 64;                     // columns of n a stage: four k16 steps
constexpr int kWBytes = kRows * kKS;        // a stage's packed bytes
constexpr int kSBytes = 1024;               // a stage's scales: up to four groups' 64
constexpr int kEpiPitch = 2 * kRows + 4;    // f32 a staged output row (no bank conflicts)

// N rows of m a block (wgmma's N)
template <int N>
struct Tile {
  static constexpr int kDyBytes = N * 128;  // [N][64] bf16
  static constexpr int kStage = kDyBytes + kWBytes + kSBytes;
  static constexpr int kStages = N <= 32 ? 8 : 6;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;  // + slack to align to 1024
  static_assert(kStage % 1024 == 0, "stages keep the 128-byte swizzle's alignment");
  static_assert(N * kEpiPitch * 4 <= kBarOff, "the epilogue reuses the ring");
};

// A for one k16 step (columns 16s..16s+15 of the stage) from packed row r
// of the stage: rows g and g + 8 are the row's low and high nibbles; sc the
// stage's 64 scales of r's group. The bytes were written by TMA with the
// 64-byte swizzle: 16-byte chunk c of row r at c ^ ((r >> 1) & 3).
__device__ __forceinline__ void dequant_step(uint32_t (&a)[4], const unsigned char* ws, int r,
                                             int s, int tq, const float* sc) {
  const unsigned char* chunk = ws + r * kKS + ((s ^ ((r >> 1) & 3)) << 4);
  const uint32_t w0 = *reinterpret_cast<const uint16_t*>(chunk + 2 * tq);      // k 2t, 2t+1
  const uint32_t w1 = *reinterpret_cast<const uint16_t*>(chunk + 8 + 2 * tq);  // k 2t+8, 2t+9
  const float2 s0 = *reinterpret_cast<const float2*>(sc + 16 * s + 2 * tq);
  const float2 s1 = *reinterpret_cast<const float2*>(sc + 16 * s + 8 + 2 * tq);
  const __nv_bfloat162 sc0 = __floats2bfloat162_rn(s0.x, s0.y);
  const __nv_bfloat162 sc1 = __floats2bfloat162_rn(s1.x, s1.y);
  const uint32_t p0 = __byte_perm(w0, 0, 0x4140);  // the two bytes at bytes 0 and 2
  const uint32_t p1 = __byte_perm(w1, 0, 0x4140);
  a[0] = hv::dequant2(hv::low_nibbles(p0), sc0);
  a[1] = hv::dequant2(hv::high_nibbles(p0), sc0);
  a[2] = hv::dequant2(hv::low_nibbles(p1), sc1);
  a[3] = hv::dequant2(hv::high_nibbles(p1), sc1);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    int4_transpose_kernel(const __grid_constant__ CUtensorMap tm_dy,  // (m, n) bf16
                          const __grid_constant__ CUtensorMap tm_w,   // (NB, G * half, BN) bytes
                          const __grid_constant__ CUtensorMap tm_s,   // (NB, G, BN) f32
                          void* __restrict__ out,                     // (m, d), dy's dtype
                          float* __restrict__ part,                   // (splits, m, d) or null
                          int out_bf16, int m, int G, int half, int BN, int kt, int per) {
  using L = Tile<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hv::smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + L::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * N;
  const int p0 = blockIdx.y * kRows;  // first packed row of G * half
  const int k_begin = blockIdx.z * per;
  const int total = min(kt, k_begin + per) - k_begin;
  const int sg = half <= kRows ? kRows / half : 1;  // groups a stage's scales cover

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      hv::mbar_init(&full[s], 1);           // the producer's arrival and the TMA bytes
      hv::mbar_init(&empty[s], 4 * kWG);    // one from each consumer warp
    }
    hv::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * kWG) {
    // ---- producer: dy, the packed bytes and the scales of each stage ----
    if (lane == 0) {
      hv::RingPos pos;
      for (int t = 0; t < total; ++t) {
        hv::mbar_wait(&empty[pos.stage], pos.phase ^ 1);
        unsigned char* st = smem + pos.stage * L::kStage;
        const int col = (k_begin + t) * kKS;  // column of n; a stage lies in one tile
        const int j = col / BN, c = col % BN;
        hv::mbar_arrive_expect_tx(&full[pos.stage], L::kDyBytes + kWBytes + sg * kKS * 4);
        hv::tma_load_2d(st, &tm_dy, col, m0, &full[pos.stage]);
        hv::tma_load_3d(st + L::kDyBytes, &tm_w, c, p0, j, &full[pos.stage]);
        hv::tma_load_3d(st + L::kDyBytes + kWBytes, &tm_s, c, p0 / half, j, &full[pos.stage]);
        pos.next(L::kStages);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns packed rows [64 wg, 64 wg + 64) of the block ----
  const int wg = warp >> 2, q = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  int prow[2], slot[2];  // sub-tile u: this thread's packed row, its group's scale row
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    prow[u] = 64 * wg + 32 * u + 8 * q + g;
    slot[u] = half <= kRows ? (64 * wg + 32 * u) / half : 0;
  }

  float acc[2][N / 2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[u][i] = 0.f;

  uint32_t a[2][2][4];  // [register set: even / odd k16 step][sub-tile][fragment]
  hv::RingPos pos;
  int prev = 0;
  for (int t = 0; t < total; ++t) {
    hv::mbar_wait(&full[pos.stage], pos.phase);
    const unsigned char* st = smem + pos.stage * L::kStage;
    const uint64_t desc = hv::desc_sw128(st);
    const unsigned char* ws = st + L::kDyBytes;
    const float* ss = reinterpret_cast<const float*>(ws + kWBytes);
#pragma unroll
    for (int s = 0; s < kKS / 16; ++s) {
      // the set written here was read by the products two steps back, which
      // the wait after the last step's commit has seen done (four sets and
      // three groups in flight were no faster)
      uint32_t(&as)[2][4] = a[s & 1];
#pragma unroll
      for (int u = 0; u < 2; ++u) dequant_step(as[u], ws, prow[u], s, tq, ss + slot[u] * kKS);
#pragma unroll
      for (int i = 0; i < 8; ++i) hv::fence_operand(as[i / 4][i % 4]);
      hv::wgmma_fence();
      hv::wgmma_rs<N>(acc[0], as[0], desc + 2 * s);
      hv::wgmma_rs<N>(acc[1], as[1], desc + 2 * s);
      hv::wgmma_commit();
      hv::wgmma_wait<1>();
    }
    // every product of the last stage is done: hand it back (here, not
    // between the k16 steps: a branch there makes ptxas serialise them)
    __syncwarp();
    if (lane == 0 && t > 0) hv::mbar_arrive(&empty[prev]);
    prev = pos.stage;
    pos.next(L::kStages);
  }
  hv::wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) hv::fence_operand(acc[u][i]);

  // ---- epilogue: the tile as [N rows of m][low 128 | high 128] f32 in the
  // ring (every consumer's last product has read its stage, and every TMA
  // copy has landed), then rows of dx in 16-byte runs ----
  hv::named_bar_sync(1, 128 * kWG);
  float* epi = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi[(8 * jj + 2 * tq + (e & 1)) * kEpiPitch + (e >> 1) * kRows + prow[u]] =
            acc[u][4 * jj + e];
  hv::named_bar_sync(1, 128 * kWG);

  const int d = 2 * G * half, prows = G * half;
  const bool f32 = part != nullptr || !out_bf16;
  const int vec = f32 ? 4 : 8;  // features a 16-byte store
  const int runs = 2 * kRows / vec;
  for (int i = threadIdx.x; i < N * runs; i += 128 * kWG) {
    const int r = i / runs, c = (i % runs) * vec;
    const int row = m0 + r, pr = p0 + (c % kRows);
    if (row >= m || pr >= prows) continue;
    // packed row pr's low (c < kRows) or high nibble: a run of `vec` features
    const int feat = (pr / half) * 2 * half + (c / kRows) * half + pr % half;
    const float* src = epi + r * kEpiPitch + c;
    const int64_t off = (int64_t)row * d + feat;
    const float4 v0 = *reinterpret_cast<const float4*>(src);
    if (part != nullptr) {
      *reinterpret_cast<float4*>(part + (int64_t)blockIdx.z * m * d + off) = v0;
    } else if (!out_bf16) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = v0;
    } else {
      const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) =
          make_uint4(hv::pack_bf16(v0.x, v0.y), hv::pack_bf16(v0.z, v0.w),
                     hv::pack_bf16(v1.x, v1.y), hv::pack_bf16(v1.z, v1.w));
    }
  }
}

template <int N>
cudaError_t launch(const void* dyb, const void* w4t, const void* gst, void* out, float* part,
                   int out_bf16, int m, int NB, int G, int half, int BN, int splits, int per,
                   cudaStream_t stream) {
  using L = Tile<N>;
  const int n = NB * BN, prows = G * half;
  const uint32_t sg = half <= kRows ? kRows / half : 1;
  CUtensorMap tm_dy, tm_w, tm_s;
  const uint64_t dy_dims[2] = {(uint64_t)n, (uint64_t)m}, dy_strides[1] = {(uint64_t)n * 2};
  const uint32_t dy_box[2] = {kKS, N};
  const uint64_t w_dims[3] = {(uint64_t)BN, (uint64_t)prows, (uint64_t)NB};
  const uint64_t w_strides[2] = {(uint64_t)BN, (uint64_t)prows * BN};
  const uint32_t w_box[3] = {kKS, kRows, 1};
  const uint64_t s_dims[3] = {(uint64_t)BN, (uint64_t)G, (uint64_t)NB};
  const uint64_t s_strides[2] = {(uint64_t)BN * 4, (uint64_t)G * BN * 4};
  const uint32_t s_box[3] = {kKS, sg, 1};
  if (!hv::tensor_map(&tm_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dyb, dy_dims, dy_strides,
                      dy_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hv::tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w4t, w_dims, w_strides, w_box,
                      CU_TENSOR_MAP_SWIZZLE_64B) ||
      !hv::tensor_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, gst, s_dims, s_strides, s_box,
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static bool configured = false;
  const cudaError_t err = hv::allow_smem(int4_transpose_kernel<N>, L::kSmem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + N - 1) / N, (prows + kRows - 1) / kRows, splits);
  int4_transpose_kernel<N><<<grid, kThreads, L::kSmem, stream>>>(
      tm_dy, tm_w, tm_s, out, splits > 1 ? part : nullptr, out_bf16, m, G, half, BN, n / kKS,
      per);
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
  const int64_t kt = (int64_t)NB * BN / kKS;
  if (BN % kKS || half % 32 || (half <= kRows ? kRows % half : half % kRows) || m < 1 ||
      G < 1 || NB < 1 || splits < 1 || per < 1 || (int64_t)(splits - 1) * per >= kt ||
      (int64_t)splits * per < kt || splits > 65535 || (int64_t)G * half / kRows >= 65535)
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
