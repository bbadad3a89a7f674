// The transpose product through a frozen quantized weight on the tensor
// cores, for Hopper (sm_90a): dx^T = W dy^T on wgmma fed by TMA, the weight
// dequantized to bf16 in registers as the A operand (rows of d), dy the
// K-major B operand (the contraction over n, contiguous in W's rows). B7
// (csrc/int4_transpose.cu, whose header gives the design) instantiates it
// over packed int4 weights with group scales; B10b (csrc/qlora_fused.cu)
// over int8 weights with per-column scales and a low-rank term.
//
// The int8 form (kInt8): W8 (d, n) bytes, scale (n,) f32, each weight made
// bf16(bf16(byte) * bf16(s[col])) (one rounding of an exact product). A
// block takes 256 rows of d; a stage is dy's [N][64] box, W8's [256][64]
// byte box (64-byte swizzle) and the stage's 64 scales. A warp's A rows g
// and g + 8 are rows i and 128 + i of the block, as B7's are the low and
// high nibbles of packed row i, so the two forms share the epilogue: the
// tile leaves as [N][rows 0..127 | 128..255] f32 through shared memory.
// The low-rank term v_s a^T (v_s (m, r), a (d, r) f32) is a^T's transpose
// a v_s^T: after the base stages the block walks the rank in stages of 64
// more, a's rows as wgmma's A operand and v_s^T as the K-major B operand
// (brought by the producer through the same ring). The caller splits each
// f32 operand into bf16 high and low parts, a's packed in the order of the
// A registers (one 16-byte load a sub-tile a part), and three products a
// k16 step (hi hi, hi lo, lo hi), each exact in f32, keep the f32 contract
// up to the dropped lo lo; the term's steps alternate the two sub-tiles (16
// registers of fragments, as the base steps' two sets). Under split-K the
// term is one more split (the last blockIdx.z), summed after the others in
// split order by the merge.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "weight_gemm.cuh"

namespace hv {
namespace {  // each source that includes this keeps its own instantiations

constexpr int kTrWG = 2;                        // consumer warpgroups
constexpr int kTrThreads = 128 * (kTrWG + 1);  // and a producer warpgroup (one thread loads)
constexpr int kTrRows = 64 * kTrWG;         // A rows g of a block (int4: packed rows)
constexpr int kTrKS = 64;                   // columns of n (or of the rank) a stage
constexpr int kTrSBytes = 1024;             // a stage's scales: up to four groups' 64
constexpr int kEpiPitch = 2 * kTrRows + 4;  // f32 a staged output row (no bank conflicts)

// N rows of m a block (wgmma's N); a stage's weight box: int4 kTrRows packed
// rows, int8 2 x kTrRows rows, of 64 bytes
template <int N, bool kInt8>
struct TrTile {
  static constexpr int kDyBytes = N * 128;  // [N][64] bf16
  static constexpr int kWBytes = (kInt8 ? 2 : 1) * kTrRows * kTrKS;
  static constexpr int kStage = kDyBytes + kWBytes + kTrSBytes;
  static constexpr int kStages = N <= 32 ? 8 : 6;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;  // + slack to align to 1024
  static_assert(kStage % 1024 == 0, "stages keep the 128-byte swizzle's alignment");
  static_assert(N * kEpiPitch * 4 <= kBarOff, "the epilogue reuses the ring");
  static_assert(!kInt8 || kDyBytes <= kWBytes, "an adapter stage's low part fits the weight slot");
};

// A for one k16 step (columns 16s..16s+15 of the stage) from packed row r
// of the stage: rows g and g + 8 are the row's low and high nibbles; sc the
// stage's 64 scales of r's group. The bytes were written by TMA with the
// 64-byte swizzle: 16-byte chunk c of row r at c ^ ((r >> 1) & 3).
__device__ __forceinline__ void dequant_step(uint32_t (&a)[4], const unsigned char* ws, int r,
                                             int s, int tq, const float* sc) {
  const unsigned char* chunk = ws + r * kTrKS + ((s ^ ((r >> 1) & 3)) << 4);
  const uint32_t w0 = *reinterpret_cast<const uint16_t*>(chunk + 2 * tq);      // k 2t, 2t+1
  const uint32_t w1 = *reinterpret_cast<const uint16_t*>(chunk + 8 + 2 * tq);  // k 2t+8, 2t+9
  const float2 s0 = *reinterpret_cast<const float2*>(sc + 16 * s + 2 * tq);
  const float2 s1 = *reinterpret_cast<const float2*>(sc + 16 * s + 8 + 2 * tq);
  const __nv_bfloat162 sc0 = __floats2bfloat162_rn(s0.x, s0.y);
  const __nv_bfloat162 sc1 = __floats2bfloat162_rn(s1.x, s1.y);
  const uint32_t p0 = __byte_perm(w0, 0, 0x4140);  // the two bytes at bytes 0 and 2
  const uint32_t p1 = __byte_perm(w1, 0, 0x4140);
  a[0] = dequant2(low_nibbles(p0), sc0);
  a[1] = dequant2(high_nibbles(p0), sc0);
  a[2] = dequant2(low_nibbles(p1), sc1);
  a[3] = dequant2(high_nibbles(p1), sc1);
}

// the same over int8 rows r (A row g) and r + 128 (A row g + 8) of the
// stage's [256][64] byte box (the 64-byte swizzle as above; r and r + 128
// share their pattern); sc the stage's 64 column scales
__device__ __forceinline__ void int8_rows_step(uint32_t (&a)[4], const unsigned char* ws, int r,
                                               int s, int tq, const float* sc) {
  const unsigned char* c0 = ws + r * kTrKS + ((s ^ ((r >> 1) & 3)) << 4);
  const unsigned char* c1 = c0 + kTrRows * kTrKS;
  const float2 s0 = *reinterpret_cast<const float2*>(sc + 16 * s + 2 * tq);
  const float2 s1 = *reinterpret_cast<const float2*>(sc + 16 * s + 8 + 2 * tq);
  const __nv_bfloat162 sc0 = __floats2bfloat162_rn(s0.x, s0.y);
  const __nv_bfloat162 sc1 = __floats2bfloat162_rn(s1.x, s1.y);
  // bytes (k 2t, 2t+1) or (2t+8, 2t+9) at bytes 0 and 2, as bf16(byte) x bf16(s)
  const auto dq = [&](const unsigned char* row, int off, __nv_bfloat162 scl) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + off + 2 * tq);
    return as_u32(__hmul2(as_bf162(int8_pair(__byte_perm(w, 0, 0x4140))), scl));
  };
  a[0] = dq(c0, 0, sc0);
  a[1] = dq(c1, 0, sc0);
  a[2] = dq(c0, 8, sc1);
  a[3] = dq(c1, 8, sc1);
}

// dx (m, d) in dy's dtype (out_bf16) or f32, or with split-K (part not
// null) split blockIdx.z's f32 sums into part[blockIdx.z]. The weight's
// maps: int4 tm_w (NB, G * half, BN) bytes and tm_s (NB, G, BN) f32 (a
// block kTrRows packed rows, 2 kTrRows rows of d); int8 tm_w (d, n) bytes
// and tm_s (1, n) f32 with G = ceil(d / 256), half = 128 (a block 256 rows
// of d). kInt8 with r > 0: tm_v (2, m, rp) bf16 holds v_s's high and low
// parts (rp a multiple of 64, zeros past r), frag a's A fragments, [hi,
// lo][rp / 16 k16 steps][G * 128 row pairs][4 threads] (pair 128 j + i:
// rows 256 j + i, + 128 as A rows g, g + 8); otherwise tm_v and frag go
// unread.
template <int N, bool kInt8>
__global__ void __launch_bounds__(kTrThreads, 1)
    transpose_kernel(const __grid_constant__ CUtensorMap tm_dy,  // (m, n) bf16
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_s,
                     const __grid_constant__ CUtensorMap tm_v,
                     const uint4* __restrict__ frag,  // a's fragments
                     void* __restrict__ out,          // (m, d)
                     float* __restrict__ part,        // (splits [+ 1], m, d) or null
                     int out_bf16, int m, int d, int G, int half, int BN, int kt, int per,
                     int r) {
  using L = TrTile<N, kInt8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + L::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * N;
  const int p0 = blockIdx.y * kTrRows;  // first packed row (int4) or half its first row (int8)
  const int k_begin = blockIdx.z * per;
  // the term's own split (the last of split-K) has no stage of n
  const int total = max(0, min(kt, k_begin + per) - k_begin);
  const bool lora = kInt8 && r > 0 && (part == nullptr || blockIdx.z == gridDim.z - 1);
  const int lora_total = lora ? (r + kTrKS - 1) / kTrKS : 0;
  const int sg = half <= kTrRows ? kTrRows / half : 1;  // groups a stage's scales cover

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);           // the producer's arrival and the TMA bytes
      mbar_init(&empty[s], 4 * kTrWG);  // one from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kTrWG) {
    // ---- producer: dy, the weight bytes and the scales of each stage; its
    // registers go to the consumers (168 a thread at launch would make
    // ptxas serialise the 128-row tile's wgmmas) ----
    reg_dealloc<40>();
    if (warp == 4 * kTrWG && lane == 0) {
      RingPos pos;
      for (int t = 0; t < total; ++t) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1);
        unsigned char* st = smem + pos.stage * L::kStage;
        const int col = (k_begin + t) * kTrKS;  // column of n; a stage lies in one tile
        if constexpr (kInt8) {
          mbar_arrive_expect_tx(&full[pos.stage], L::kDyBytes + L::kWBytes + kTrKS * 4);
          tma_load_2d(st, &tm_dy, col, m0, &full[pos.stage]);
          tma_load_2d(st + L::kDyBytes, &tm_w, col, 2 * p0, &full[pos.stage]);
          tma_load_2d(st + L::kDyBytes + L::kWBytes, &tm_s, col, 0, &full[pos.stage]);
        } else {
          const int j = col / BN, c = col % BN;
          mbar_arrive_expect_tx(&full[pos.stage], L::kDyBytes + L::kWBytes + sg * kTrKS * 4);
          tma_load_2d(st, &tm_dy, col, m0, &full[pos.stage]);
          tma_load_3d(st + L::kDyBytes, &tm_w, c, p0, j, &full[pos.stage]);
          tma_load_3d(st + L::kDyBytes + L::kWBytes, &tm_s, c, p0 / half, j, &full[pos.stage]);
        }
        pos.next(L::kStages);
      }
      if constexpr (kInt8) {
        for (int t = 0; t < lora_total; ++t) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1);
          unsigned char* st = smem + pos.stage * L::kStage;
          mbar_arrive_expect_tx(&full[pos.stage], 2 * L::kDyBytes);
          tma_load_3d(st, &tm_v, t * kTrKS, m0, 0, &full[pos.stage]);
          tma_load_3d(st + L::kDyBytes, &tm_v, t * kTrKS, m0, 1, &full[pos.stage]);
          pos.next(L::kStages);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns A rows [64 wg, 64 wg + 64) of the block ----
  reg_alloc<232>();
  const int wg = warp >> 2, q = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  int prow[2], slot[2];  // sub-tile u: this thread's A row g, its group's scale row
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    prow[u] = 64 * wg + 32 * u + 8 * q + g;
    slot[u] = half <= kTrRows ? (64 * wg + 32 * u) / half : 0;
  }

  float acc[2][N / 2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[u][i] = 0.f;

  uint32_t a_[2][2][4];  // [register set: even / odd k16 step][sub-tile][fragment]
  RingPos pos;
  int prev = 0;
  for (int t = 0; t < total; ++t) {
    mbar_wait(&full[pos.stage], pos.phase);
    const unsigned char* st = smem + pos.stage * L::kStage;
    const uint64_t desc = desc_sw128(st);
    const unsigned char* ws = st + L::kDyBytes;
    const float* ss = reinterpret_cast<const float*>(ws + L::kWBytes);
#pragma unroll
    for (int s = 0; s < kTrKS / 16; ++s) {
      // the set written here was read by the products two steps back, which
      // the wait after the last step's commit has seen done (four sets and
      // three groups in flight were no faster)
      uint32_t(&as)[2][4] = a_[s & 1];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if constexpr (kInt8)
          int8_rows_step(as[u], ws, prow[u], s, tq, ss);
        else
          dequant_step(as[u], ws, prow[u], s, tq, ss + slot[u] * kTrKS);
      }
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
  if constexpr (kInt8) {
    // sub-tile u's fragments of a step, hi and lo: the set of u in flight
    // while the other's is loaded
    uint32_t fh[2][4], fl[2][4];
    const int64_t pairs = (int64_t)gridDim.y * kTrRows;
    const int64_t lo_at = (int64_t)(r + kTrKS - 1) / kTrKS * 4 * pairs * 4;
    for (int t = 0; t < lora_total; ++t) {
      mbar_wait(&full[pos.stage], pos.phase);
      const unsigned char* st = smem + pos.stage * L::kStage;
      const uint64_t dhi = desc_sw128(st), dlo = desc_sw128(st + L::kDyBytes);
#pragma unroll
      for (int i = 0; i < 2 * kTrKS / 16; ++i) {
        const int s = i >> 1, u = i & 1;
        term_frags(fh[u], fl[u], frag, lo_at,
                   ((int64_t)(4 * t + s) * pairs + p0 + prow[u]) * 4 + tq);
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
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[u][i]);

  // ---- epilogue: the tile as [N rows of m][low 128 | high 128] f32 in the
  // ring (every consumer's last product has read its stage, and every TMA
  // copy has landed), then rows of dx in 16-byte runs ----
  named_bar_sync(1, 128 * kTrWG);
  float* epi = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi[(8 * jj + 2 * tq + (e & 1)) * kEpiPitch + (e >> 1) * kTrRows + prow[u]] =
            acc[u][4 * jj + e];
  named_bar_sync(1, 128 * kTrWG);

  const bool f32 = part != nullptr || !out_bf16;
  const int vec = f32 ? 4 : 8;  // features a 16-byte store
  const int runs = 2 * kTrRows / vec;
  for (int i = threadIdx.x; i < N * runs; i += 128 * kTrWG) {
    const int rr = i / runs, c = (i % runs) * vec;
    const int row = m0 + rr, pr = p0 + (c % kTrRows);
    // packed row pr's low (c < kTrRows) or high nibble (int8: rows d0 + c):
    // a run of `vec` features, in or out of d together
    const int feat = (pr / half) * 2 * half + (c / kTrRows) * half + pr % half;
    if (row >= m || feat >= d) continue;
    const float* src = epi + rr * kEpiPitch + c;
    const int64_t off = (int64_t)row * d + feat;
    const float4 v0 = *reinterpret_cast<const float4*>(src);
    if (part != nullptr) {
      *reinterpret_cast<float4*>(part + (int64_t)blockIdx.z * m * d + off) = v0;
    } else if (!out_bf16) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = v0;
    } else {
      const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) =
          make_uint4(pack_bf16(v0.x, v0.y), pack_bf16(v0.z, v0.w), pack_bf16(v1.x, v1.y),
                     pack_bf16(v1.z, v1.w));
    }
  }
}

}  // namespace
}  // namespace hv
