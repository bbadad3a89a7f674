// The int8 weight-only matmul on the tensor cores, for Hopper (sm_90a):
// y^T = W8^T x^T on wgmma fed by TMA, f32 sums times the column scale, and
// optionally a low-rank term accumulated on the tensor cores before the one
// cast. B9's tensor-core route (csrc/int8_matmul.cu, whose header gives the
// design) instantiates it without the term; B10a (csrc/qlora_fused.cu)
// with it.
//
// The low-rank term (kLora): o = (x W8) s + u_s b, u_s (m, r) and b (r, n)
// f32. Transposed, u_s b is b^T u_s^T: after the base product's stages the
// block walks the rank in stages of 64 more, with b^T as wgmma's A operand
// and u_s^T as the K-major B operand (brought by the producer warp through
// the same ring). Each f32 operand is split into a bf16 high part and the
// bf16 rest (x = hi + lo + O(2^-16 |x|)) by the caller, b's already in the
// order of the A registers (one 16-byte load a sub-tile a part), and three
// products a k16 step (hi hi, hi lo, lo hi), each exact in f32, keep the
// term's f32 contract up to the dropped lo lo (about 2^-16 relative). The
// term's steps alternate the two sub-tiles, so they hold one sub-tile's
// fragments in flight and one being loaded: 16 registers, as the base
// steps' two sets. A single pass scales the f32 sums by s in registers
// before the term enters, so the term is not scaled. Under split-K the base
// splits write their unscaled sums and one more split (the last
// blockIdx.z) computes the term alone; the caller's merge adds the splits
// in order, scales, adds the term and casts, so the bits do not depend on
// the schedule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "weight_gemm.cuh"

namespace hv {
namespace {  // each source that includes this keeps its own instantiations

constexpr int kTcWG = 2;                        // consumer warpgroups
constexpr int kTcThreads = 128 * (kTcWG + 1);  // and a producer warpgroup (one thread loads)
constexpr int kTcCols = 128 * kTcWG;          // weight columns a block
constexpr int kTcKS = 64;                     // rows of d (or of the rank) a stage
constexpr int kTcWBytes = kTcKS * kTcCols;    // a stage's weight bytes: [64][128] boxes

// N rows of m a block (wgmma's N)
template <int N>
struct TcTile {
  static constexpr int kXBytes = N * 128;  // [N][64] bf16
  static constexpr int kStage = kXBytes + kTcWBytes;
  static constexpr int kStages = 6;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;  // + slack to align to 1024
  static_assert(kStage % 1024 == 0, "stages keep the 128-byte swizzle's alignment");
  static_assert(kXBytes <= kTcWBytes, "an adapter stage's low part fits the weight slot");
};

// A for one k16 step of rows r0 = 16s + 2t (+1, +8, +9) of the stage's
// [64][128] weight box: this thread's four columns (byte `cb` of the box
// row, 16-byte chunk c of row r at c ^ (r % 8)); a[0] sub-tile 0 (columns
// +0 and +1 as A rows g and g + 8), a[1] sub-tile 1 (+2, +3)
__device__ __forceinline__ void int8_step(uint32_t (&a)[2][4], const unsigned char* wb, int s,
                                          int tq, int cb) {
  const int r0 = 16 * s + 2 * tq;
  uint32_t w[4];  // rows r0, r0 + 1, r0 + 8, r0 + 9
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + (i & 1) + 8 * (i >> 1);
    w[i] = *reinterpret_cast<const uint32_t*>(wb + r * 128 + (((cb >> 4) ^ (r & 7)) << 4) +
                                              (cb & 15));
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    // column 2u + c of the four, rows (r0, r0 + 1) and (r0 + 8, r0 + 9)
    const uint32_t lo = 0x4400u + 0x2222u * u, hi = lo + 0x1111u;
    a[u][0] = int8_pair(__byte_perm(w[0], w[1], lo));
    a[u][1] = int8_pair(__byte_perm(w[0], w[1], hi));
    a[u][2] = int8_pair(__byte_perm(w[2], w[3], lo));
    a[u][3] = int8_pair(__byte_perm(w[2], w[3], hi));
  }
}

// tm_x (m, d) bf16 -> [N][64] boxes and tm_w (d, n) bytes -> [64][128]
// boxes, both with the 128-byte swizzle
template <int N>
bool tc_maps(CUtensorMap* tm_x, CUtensorMap* tm_w, const void* x, const void* w8, int m, int d,
             int n) {
  const uint64_t x_dims[2] = {(uint64_t)d, (uint64_t)m}, x_strides[1] = {(uint64_t)d * 2};
  const uint32_t x_box[2] = {kTcKS, N};
  const uint64_t w_dims[2] = {(uint64_t)n, (uint64_t)d}, w_strides[1] = {(uint64_t)n};
  const uint32_t w_box[2] = {128, kTcKS};
  return tensor_map(tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_strides, x_box,
                    CU_TENSOR_MAP_SWIZZLE_128B) &&
         tensor_map(tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w8, w_dims, w_strides, w_box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// out (m, n) in To, or with split-K (part not null) the f32 sums of split
// blockIdx.z into part[blockIdx.z]. kLora: tm_u (2, m, rp) bf16 holds u_s's
// high and low parts (rp a multiple of 64, zeros past r); frag b^T's A
// fragments, [hi, lo][rp / 16 k16 steps][n / 2 column pairs][4 threads]
// (pair p: columns 2p, 2p + 1 as A rows g, g + 8); with r = 0 (or kLora
// false) there is no term and tm_u, frag go unread.
template <int N, typename To, bool kLora>
__global__ void __launch_bounds__(kTcThreads, 1)
    int8_tc_kernel(const __grid_constant__ CUtensorMap tm_x,  // (m, d) bf16
                   const __grid_constant__ CUtensorMap tm_w,  // (d, n) bytes
                   const __grid_constant__ CUtensorMap tm_u,  // (2, m, rp) bf16
                   const float* __restrict__ scale,           // (n,)
                   const uint4* __restrict__ frag,            // b^T's fragments
                   To* __restrict__ out,                      // (m, n)
                   float* __restrict__ part,                  // (splits [+ 1], m, n) or null
                   int m, int n, int kt, int per, int r) {
  using L = TcTile<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + L::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * N;
  const int n0 = blockIdx.y * kTcCols;
  const int k_begin = blockIdx.z * per;
  // the term's own split (the last of split-K) has no stage of d
  const int total = max(0, min(kt, k_begin + per) - k_begin);
  const bool lora = kLora && r > 0 && (part == nullptr || blockIdx.z == gridDim.z - 1);
  const int lora_total = lora ? (r + kTcKS - 1) / kTcKS : 0;
  // the second warpgroup's columns may lie wholly past n: its box is not
  // loaded and its columns not stored
  const int boxes = n0 + 128 < n ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);           // the producer's arrival and the TMA bytes
      mbar_init(&empty[s], 4 * kTcWG);  // one from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kTcWG) {
    // ---- producer: x and the weight rows of each stage, then u_s's parts;
    // its registers go to the consumers (168 a thread at launch would make
    // ptxas serialise the 128-row tile's wgmmas) ----
    reg_dealloc<40>();
    if (warp == 4 * kTcWG && lane == 0) {
      RingPos pos;
      for (int t = 0; t < total; ++t) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1);
        unsigned char* st = smem + pos.stage * L::kStage;
        const int k0 = (k_begin + t) * kTcKS;
        mbar_arrive_expect_tx(&full[pos.stage], L::kXBytes + boxes * kTcKS * 128);
        tma_load_2d(st, &tm_x, k0, m0, &full[pos.stage]);
        for (int bx = 0; bx < boxes; ++bx)
          tma_load_2d(st + L::kXBytes + bx * kTcKS * 128, &tm_w, n0 + 128 * bx, k0,
                      &full[pos.stage]);
        pos.next(L::kStages);
      }
      if constexpr (kLora) {
        for (int t = 0; t < lora_total; ++t) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1);
          unsigned char* st = smem + pos.stage * L::kStage;
          mbar_arrive_expect_tx(&full[pos.stage], 2 * L::kXBytes);
          tma_load_3d(st, &tm_u, t * kTcKS, m0, 0, &full[pos.stage]);
          tma_load_3d(st + L::kXBytes, &tm_u, t * kTcKS, m0, 1, &full[pos.stage]);
          pos.next(L::kStages);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns weight columns [128 wg, 128 wg + 128) ----
  reg_alloc<232>();
  const int wg = warp >> 2, q = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int cb = 32 * q + 4 * g;  // this thread's first column in the warpgroup's box
  const int c = n0 + 128 * wg + cb;

  float acc[2][N / 2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[u][i] = 0.f;

  uint32_t a[2][2][4];  // [register set: even / odd k16 step][sub-tile][fragment]
  RingPos pos;
  int prev = 0;
  for (int t = 0; t < total; ++t) {
    mbar_wait(&full[pos.stage], pos.phase);
    const unsigned char* st = smem + pos.stage * L::kStage;
    const uint64_t desc = desc_sw128(st);
    const unsigned char* wb = st + L::kXBytes + wg * kTcKS * 128;
#pragma unroll
    for (int s = 0; s < kTcKS / 16; ++s) {
      // the set written here was read by the products two steps back, which
      // the wait after the last step's commit has seen done (four sets and
      // three groups in flight were no faster)
      uint32_t(&as)[2][4] = a[s & 1];
      int8_step(as, wb, s, tq, cb);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_operand(as[i / 4][i % 4]);
      wgmma_fence();
      wgmma_rs<N>(acc[0], as[0], desc + 2 * s);
      wgmma_rs<N>(acc[1], as[1], desc + 2 * s);
      wgmma_commit();
      wgmma_wait<1>();
    }
    // every product of the last stage is done: hand it back (here, not
    // between the k16 steps: a branch there makes ptxas serialise them)
    __syncwarp();
    if (lane == 0 && t > 0) mbar_arrive(&empty[prev]);
    prev = pos.stage;
    pos.next(L::kStages);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[u][i]);

  // acc[u][4jj + e]: x row 8jj + 2t + (e & 1), column c + 2u + (e >> 1)
  const bool cvalid = c < n;  // n is a multiple of 16: the four columns are in or out together
  const float4 sc = cvalid ? *reinterpret_cast<const float4*>(scale + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kLora) {
    // the scale on the base sums once, in f32, before the term enters (under
    // split-K the merge scales; the term's own split writes the term alone)
    if (part == nullptr) {
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[0][4 * jj + h] *= sc.x;
          acc[0][4 * jj + 2 + h] *= sc.y;
          acc[1][4 * jj + h] *= sc.z;
          acc[1][4 * jj + 2 + h] *= sc.w;
        }
    }
    if (lora) {
      // sub-tile u's fragments of a step, hi and lo: the set of u in flight
      // while the other's is loaded
      uint32_t fh[2][4], fl[2][4];
      const int64_t pairs = n / 2, lo_at = (int64_t)(r + kTcKS - 1) / kTcKS * 4 * pairs * 4;
      const int pair = (cvalid ? c : 0) / 2;  // columns c, c + 1; c + 2, c + 3 the next
      for (int t = 0; t < lora_total; ++t) {
        mbar_wait(&full[pos.stage], pos.phase);
        const unsigned char* st = smem + pos.stage * L::kStage;
        const uint64_t dhi = desc_sw128(st), dlo = desc_sw128(st + L::kXBytes);
#pragma unroll
        for (int i = 0; i < 2 * kTcKS / 16; ++i) {
          const int s = i >> 1, u = i & 1;
          term_frags(fh[u], fl[u], frag, lo_at, ((int64_t)(4 * t + s) * pairs + pair + u) * 4 + tq);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            fence_operand(fh[u][j]);
            fence_operand(fl[u][j]);
          }
          wgmma_fence();
          wgmma_rs<N>(acc[u], fh[u], dhi + 2 * s);
          wgmma_rs<N>(acc[u], fh[u], dlo + 2 * s);
          wgmma_rs<N>(acc[u], fl[u], dhi + 2 * s);
          wgmma_commit();
          wgmma_wait<1>();
        }
        __syncwarp();
        if (lane == 0 && (t > 0 || total > 0)) mbar_arrive(&empty[prev]);
        prev = pos.stage;
        pos.next(L::kStages);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_operand(acc[u][i]);
    }
  }

  if (!cvalid) return;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 8 * jj + 2 * tq + h;
      if (row >= m) continue;
      const float4 v = make_float4(acc[0][4 * jj + h], acc[0][4 * jj + 2 + h],
                                   acc[1][4 * jj + h], acc[1][4 * jj + 2 + h]);
      const int64_t off = (int64_t)row * n + c;
      if (part != nullptr) {
        *reinterpret_cast<float4*>(part + (int64_t)blockIdx.z * m * n + off) = v;
      } else if constexpr (kLora) {  // scaled above
        *reinterpret_cast<uint2*>(out + off) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      } else if constexpr (std::is_same<To, float>::value) {
        *reinterpret_cast<float4*>(out + off) =
            make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
      } else {
        *reinterpret_cast<uint2*>(out + off) = make_uint2(
            pack_bf16(v.x * sc.x, v.y * sc.y), pack_bf16(v.z * sc.z, v.w * sc.w));
      }
    }
  }
}

}  // namespace
}  // namespace hv
