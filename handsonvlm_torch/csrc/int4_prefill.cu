// Int4 weight-only matmul for prefill-sized inputs over the tiled and the
// flat layout, for Hopper (sm_90a), on the tensor cores through wgmma.
//
// Replaces two pallas_calls of handsonvlm_tpu/ops/int8_matmul.py:
// :704 int4_matmul_prefill_tiled (B5b, the _prefill4_tiled_kernel call that
// int4_matmul_stacked reaches for 128 rows or more over the tiled layout)
// and :637 int4_matmul_prefill (B5a, the _prefill4_kernel call over the
// flat stack (L, G, g/2, n)). The flat layout is the tiled one with a
// single tile (NB = 1, BN = n): byte (g, r, c) sits at (g*g/2 + r)*n + c
// either way, its scale at g*n + c, so the wrapper passes it as such and
// one kernel serves both. y = x @ dequant(w4[layer]) with the Pallas
// kernels' numerics: x rounded to bf16, each weight dequantized as
// bf16(bf16(nibble) * bf16(scale)), f32 accumulation, the f32 result cast
// to x's dtype. Rows within a group are ordered [low-nibble half,
// high-nibble half], the order of x's features.
//
// Bound: operations. At 7B with a 391-row prompt the four projections of
// a layer are 158 GFLOP, 0.16 ms at 989 TFLOP/s bf16, against 0.11 GB of
// weights and activations (0.03 ms at 3.35 TB/s). So the products must run
// at the tensor cores' rate, the dequantization must hide under them, and
// the loads must overlap both. mma.sync peaks well under wgmma on this
// card and needs one instruction per 16 x 8 x 16 product: a first mma.sync
// version of this design ran at 126 TFLOP/s at 391 rows, held by the
// fragment loads and the dequantization around each small product. wgmma
// takes one instruction per 64 x N x 16. The design:
// - The product is computed transposed, y^T = W^T x^T: the A operand of
//   wgmma (64 weight columns x 16 features, in registers) is the weight,
//   dequantized in registers straight from the packed bytes; the B operand
//   (16 features x N rows) is x from shared memory. A block has four
//   warpgroups (BNT = 256 weight columns; two or one where the tile width
//   is not a multiple of 256 or 128: the tiny presets) and N = 128 x rows,
//   or 104 where that pads m less (391 rows take 4 x 104 = 416, not 512).
//   Each weight element is dequantized once per block; x is read from L2
//   once per 256 columns (x's traffic is most of the load path's bytes).
// - A k16 step takes packed rows 8s..8s+7: k 0..7 are their low nibbles
//   (features 8s..), k 8..15 their high nibbles (features half + 8s..), so
//   both nibbles of a byte feed one thread. Thread (g, t) of warp q holds
//   weight columns 16q + 2g and 16q + 2g + 1 (A rows g and g + 8): two
//   2-byte reads (packed rows 8s + 2t and 8s + 2t + 1), one prmt per
//   column to pair them, each nibble made an exact bf16 by OR-ing it into
//   the mantissa of 128.0 and subtracting 136.0, then one multiply by the
//   bf16 scale (mul.bf16x2: one rounding of an exact product, as the
//   Pallas kernel's bf16 multiply). Two register sets alternate, so the
//   next step's dequantization runs while the last wgmma is in flight.
// - x is staged K-major with the 128-byte swizzle (a 128-byte row per x
//   row, the low-nibble chunk s of the stage at 16-byte chunk 2s and the
//   high-nibble one at 2s + 1, so the 32 bytes of k16 step s are adjacent
//   and the descriptor moves 32 bytes a step).
// - A four-stage ring of shared-memory stages filled by 16-byte cp.async
//   two stages ahead, one block-wide barrier per stage (five or six stages
//   time no better). A stage is 32 packed rows of
//   one group (every preset's groups are 64 or 128 rows): x's 64 features
//   for N rows, the packed bytes (32 x BNT, 16-byte chunks XOR-ed by row
//   so a warp's reads fall on distinct banks) and the group's BNT scales.
// - Thread (g, t) ends with y at rows 8j + 2t, +1 and its two columns:
//   4- or 8-byte stores, no shared-memory epilogue.
// - Split-K where the waves would run thin (wo and w_down at 391 rows, 128
//   rows): the wrapper picks (splits, groups per split) from (m, n, G)
//   alone; each split writes f32 partials and a second kernel sums them in
//   split order, so the bits do not depend on the schedule.
// What holds it back (2.8x torch.mm over the dequantized weight at 391
// rows, 2.4x at 2048): the load path. Without its copies the kernel ran
// more than twice as fast; four warpgroups (40% fewer bytes a FLOP than
// two) were the largest step. Sharing each x box between two column tiles
// by TMA multicast (a cluster of two, a cluster barrier a stage) was
// right but 7-9% slower. PERF.md has the measurements.
// Every output element is the same sequence of k16 products whatever the
// tile width or height, the tile's column position or the layout, so B5a
// gives B5b's bits on the same weight. Ragged row counts are masked (rows
// past m load as 0 and are not stored); G needs no power of two (w_down
// has G = 86). An f32 x is first rounded to bf16 by a small conversion
// kernel into the wrapper's scratch buffer; the output keeps x's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "weight_gemm.cuh"

namespace {

using hv::cp_async16;
using hv::cp_async_commit;
using hv::cp_async_wait;

constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;  // stages loaded ahead of the one multiplied
constexpr int kKS = 32;              // packed rows a stage: four k16 steps

// byte offset of column `col` in packed row r of a BNT-wide weight stage:
// 16-byte chunks XOR-ed so that the four rows a warp reads at once (rows
// 2t, t = 0..3) fall on distinct banks
template <int BNT>
__device__ __forceinline__ int wcol(int r, int col) {
  const int sw = BNT >= 128 ? ((r >> 1) & 3) << 1 : (r >> 1) & 3;
  return r * BNT + (((col >> 4) ^ sw) << 4) + (col & 15);
}

// WG warpgroups (64 weight columns each), N x rows (wgmma's N: 128, or 104)
template <int WG, int N>
struct Tile {
  static constexpr int kBNT = 64 * WG;     // weight columns of a block
  static constexpr int kThreads = 128 * WG;
  static constexpr int kXBytes = N * 128;  // 64 bf16 features a row
  static constexpr int kWBytes = kKS * kBNT;
  static constexpr int kSBytes = kBNT * 4;
  static constexpr int kStage = (kXBytes + kWBytes + kSBytes + 1023) / 1024 * 1024;
  static constexpr int kSmem = kStages * kStage + 1024;  // + slack to align to 1024
};

// A for one k16 step (packed rows 8s..8s+7 of the stage) from the weight
// stage: columns col (A row g) and col + 1 (A row g + 8)
template <int BNT>
__device__ __forceinline__ void dequant_step(uint32_t (&a)[4], const unsigned char* ws, int s,
                                             int tq, int col, __nv_bfloat162 sc0,
                                             __nv_bfloat162 sc1) {
  const int r0 = 8 * s + 2 * tq;
  const uint32_t wa = *reinterpret_cast<const uint16_t*>(ws + wcol<BNT>(r0, col));
  const uint32_t wb = *reinterpret_cast<const uint16_t*>(ws + wcol<BNT>(r0 + 1, col));
  const uint32_t p0 = __byte_perm(wa, wb, 0x4400);  // column col: rows r0, r0 + 1
  const uint32_t p1 = __byte_perm(wa, wb, 0x5511);  // column col + 1
  a[0] = hv::dequant2(hv::low_nibbles(p0), sc0);
  a[1] = hv::dequant2(hv::low_nibbles(p1), sc1);
  a[2] = hv::dequant2(hv::high_nibbles(p0), sc0);
  a[3] = hv::dequant2(hv::high_nibbles(p1), sc1);
}

template <int N>
__device__ __forceinline__ void wgmma_step(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  hv::wgmma_fence();
  hv::wgmma_rs<N>(d, a, desc);
  hv::wgmma_commit();
}

template <int WG, int N>
__global__ void __launch_bounds__(Tile<WG, N>::kThreads, WG == 4 ? 1 : 2)
    int4_prefill_kernel(const __nv_bfloat16* __restrict__ x,  // (m, d) bf16
                        const int8_t* __restrict__ w4t,       // (NB, G, half, BN): one layer
                        const float* __restrict__ gst,        // (NB, G, BN)
                        void* __restrict__ out,               // (m, n), x's dtype
                        float* __restrict__ part,             // (splits, m, n) or null
                        int out_bf16, int m, int G, int half, int BN, int per) {
  using L = Tile<WG, N>;
  constexpr int BNT = L::kBNT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hv::smem_1024(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const int n = gridDim.y * BNT;
  const int m0 = blockIdx.x * N;
  const int n0 = blockIdx.y * BNT;
  const int j = n0 / BN, c0 = n0 % BN;  // BN is a multiple of BNT
  const int g_begin = blockIdx.z * per;
  const int g_end = min(G, g_begin + per);
  const int group = 2 * half;
  const int d = G * group;
  const int spg = half / kKS;  // stages a group
  const int total = (g_end - g_begin) * spg;

  // stage t: packed rows [sub*32, sub*32 + 32) of group gg; x features
  // gg*group + sub*32 + [0, 32) (low nibbles, chunk c at 2c) and
  // gg*group + half + sub*32 + [0, 32) (high nibbles, chunk c at 2c + 1)
  auto load_stage = [&](int t) {
    unsigned char* st = smem + (t % kStages) * L::kStage;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
    unsigned char* ws = st + L::kXBytes;
    float* ss = reinterpret_cast<float*>(st + L::kXBytes + L::kWBytes);
    const int gg = g_begin + t / spg, sub = t % spg;
    const int64_t tile_g = (int64_t)j * G + gg;
    for (int i = tid; i < N * 8; i += L::kThreads) {
      const int r = i >> 3, c = i & 7;
      const int hi = c & 1, cc = c >> 1;
      const int feat = gg * group + hi * half + sub * kKS + 8 * cc;
      const bool in = m0 + r < m;
      cp_async16(xs + r * 64 + ((c ^ (r & 7)) << 3), in ? x + (int64_t)(m0 + r) * d + feat : x,
                 in);
    }
    const int8_t* wg = w4t + (tile_g * half + sub * kKS) * BN + c0;
    for (int i = tid; i < kKS * (BNT / 16); i += L::kThreads) {
      const int r = i / (BNT / 16), c = i % (BNT / 16);
      cp_async16(ws + wcol<BNT>(r, 16 * c), wg + (int64_t)r * BN + 16 * c);
    }
    if (tid < BNT / 4) cp_async16(ss + 4 * tid, gst + tile_g * BN + c0 + 4 * tid);
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < total) load_stage(t);
    cp_async_commit();
  }

  // this thread's two weight columns in the tile (A rows g and g + 8 of its warp)
  const int col = (warp >> 2) * 64 + (warp & 3) * 16 + 2 * g;
  uint32_t a0[4], a1[4];  // two register sets: even and odd k16 steps
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kAhead - 1>();
    hv::fence_proxy_async();
    // stage t has landed; every warpgroup's wgmma of stage t - 2 is done
    __syncthreads();
    if (t + kAhead < total) load_stage(t + kAhead);
    cp_async_commit();

    const unsigned char* st = smem + (t % kStages) * L::kStage;
    const uint64_t desc = hv::desc_sw128(st);
    const unsigned char* ws = st + L::kXBytes;
    const float2 s2 = *reinterpret_cast<const float2*>(st + L::kXBytes + L::kWBytes + 4 * col);
    const __nv_bfloat162 sc0 = __bfloat162bfloat162(__float2bfloat16(s2.x));
    const __nv_bfloat162 sc1 = __bfloat162bfloat162(__float2bfloat16(s2.y));
#pragma unroll
    for (int s = 0; s < kKS / 8; s += 2) {
      // the set written here was read by the wgmma two steps back, which
      // the wait after the last step's commit has seen done
      dequant_step<BNT>(a0, ws, s, tq, col, sc0, sc1);
      wgmma_step<N>(acc, a0, desc + 2 * s);
      hv::wgmma_wait<1>();
      dequant_step<BNT>(a1, ws, s + 1, tq, col, sc0, sc1);
      wgmma_step<N>(acc, a1, desc + 2 * (s + 1));
      hv::wgmma_wait<1>();
    }
  }
  hv::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) hv::fence_operand(acc[i]);

  // acc[4jj + e]: x row 8jj + 2t + (e & 1), weight column col + (e >> 1)
  const int oc = n0 + col;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 8 * jj + 2 * tq + h;
      if (row >= m) continue;
      const float v0 = acc[4 * jj + h], v1 = acc[4 * jj + 2 + h];
      const int64_t off = (int64_t)row * n + oc;
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + (int64_t)blockIdx.z * m * n + off) =
            make_float2(v0, v1);
      else if (out_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + off) =
            hv::pack_bf16(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
    }
  }
}

template <int WG, int N>
cudaError_t launch(const __nv_bfloat16* x, const void* w4t, const void* gst, void* out,
                   float* part, int out_bf16, int m, int NB, int G, int half, int BN,
                   int splits, int per, cudaStream_t stream) {
  using L = Tile<WG, N>;
  static bool configured = false;
  const cudaError_t err = hv::allow_smem(int4_prefill_kernel<WG, N>, L::kSmem, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + N - 1) / N, NB * BN / L::kBNT, splits);
  int4_prefill_kernel<WG, N><<<grid, L::kThreads, L::kSmem, stream>>>(
      x, static_cast<const int8_t*>(w4t), static_cast<const float*>(gst), out,
      splits > 1 ? part : nullptr, out_bf16, m, G, half, BN, per);
  return cudaGetLastError();
}

template <int WG, typename... Args>
cudaError_t launch_wg(bool n104, Args... args) {
  return n104 ? launch<WG, 104>(args...) : launch<WG, 128>(args...);
}

}  // namespace

// x (m, d) and out (m, NB*BN) of one dtype (bf16 or f32), contiguous and
// 16-byte aligned; xb a bf16 (m, d) scratch buffer (used when x is f32);
// part an f32 (splits, m, NB*BN) scratch buffer (used when splits > 1);
// w4t_layer (NB, G, half, BN) int8 and gst_layer (NB, G, BN) f32: views of
// one layer of the stacked tiles. BN is a multiple of 64; half a multiple
// of 32 (groups of 64 or more: every preset's); split s takes groups
// [s*per, min(G, (s+1)*per)).
// Returns cudaGetLastError().
extern "C" int hv_int4_prefill(const void* x, void* xb, const void* w4t_layer,
                               const void* gst_layer, void* part, void* out, int is_bf16,
                               int m, int NB, int G, int half, int BN, int splits, int per,
                               void* stream) {
  if (BN % 64 || half % kKS || m < 1 || G < 1 || splits < 1 || per < 1 ||
      (int64_t)(splits - 1) * per >= G || (int64_t)splits * per < G)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xb) |
       reinterpret_cast<uintptr_t>(w4t_layer) | reinterpret_cast<uintptr_t>(gst_layer) |
       reinterpret_cast<uintptr_t>(part) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t d = (int64_t)G * 2 * half, n = (int64_t)NB * BN;
  const __nv_bfloat16* xbf = static_cast<const __nv_bfloat16*>(x);
  if (!is_bf16) {
    const int64_t vecs = m * d / 8;
    hv::to_bf16_kernel<<<hv::grid_for(vecs), 256, 0, st>>>(static_cast<const float4*>(x),
                                                  static_cast<uint4*>(xb), vecs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xbf = static_cast<const __nv_bfloat16*>(xb);
  }
  float* pf = static_cast<float*>(part);
  // 104-row tiles where they pad m less than 128-row ones (391 -> 416, not 512)
  const bool n104 = (m + 103) / 104 * 104 < (m + 127) / 128 * 128;
  cudaError_t err;
  if (BN % 256 == 0)
    err = launch_wg<4>(n104, xbf, w4t_layer, gst_layer, out, pf, is_bf16, m, NB, G, half,
                       BN, splits, per, st);
  else if (BN % 128 == 0)
    err = launch_wg<2>(n104, xbf, w4t_layer, gst_layer, out, pf, is_bf16, m, NB, G, half,
                       BN, splits, per, st);
  else
    err = launch_wg<1>(n104, xbf, w4t_layer, gst_layer, out, pf, is_bf16, m, NB, G, half,
                       BN, splits, per, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t vecs = m * n / 4;
  hv::merge_splits_kernel<<<hv::grid_for(vecs), 256, 0, st>>>(static_cast<const float4*>(part), out,
                                                     is_bf16, vecs, splits);
  return (int)cudaGetLastError();
}
