// Full non-causal attention at CLIP ViT shapes, for Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/vit_attention.py:83 (_vit_attention, the
// pallas_call of _vit_attn_kernel, reached through vit_attention). It
// computes unmasked, non-causal softmax attention of q, k, v laid out
// (B, T, H, 64) and writes the output in the same packed (B, T, H*64)
// layout, so no transpose is made on either side.
//
// Bound: at the main path's (B = 10 frames, T = 257, H = 16, D = 64) the
// function moves 4 * B * T * H * 64 * 2 bytes = 5.3 MB (6.3 us at 3.35
// TB/s) for 2.7 GFLOP (2.7 us on the bf16 tensor cores), so it is bound by
// bytes, and by how often each (frame, head)'s keys and values are read.
//
// bf16 kernel (T up to kMaxKeys = 832; CLIP at 224 px has 257 tokens, at
// 336 px 577): one thread block per (frame, head, tile of query rows), one
// warp per 16 query rows, up to eight warps; the tile count is the fewest
// that keeps eight warps or fewer, so 257 rows take three blocks of six
// warps (the last slice holding one row, its warp idle but for the
// barriers) and each (frame, head)'s K and V are read three times, not
// once per 32 rows.
// - The block stages ALL of that head's keys and values once, in shared
//   memory, by 16-byte cp.async (rows of 128 bytes, the 16-byte chunk c of
//   row r at c ^ (r % 8), so ldmatrix reads hit distinct banks; keys past
//   T zero-filled up to a multiple of 16). 257 keys take 69.6 KB, 81.9 KB
//   with the warps' staging rows below: two blocks an SM, as the 128
//   registers a thread also allow. Each 64-key chunk is its own commit
//   group, so the first chunk's products start while the rest are in
//   flight.
// - Each warp stages its 16 query rows by cp.async too (their own commit
//   group, the first) and takes them into registers by ldmatrix (the A
//   operand); at the end the same rows stage its output, so the stores to
//   global memory are whole 16-byte chunks.
// - S = Q K^T and O = P V run on the tensor cores (mma.sync m16n8k16,
//   f32 accumulators; K through ldmatrix, V through ldmatrix.trans).
// - The softmax is online over the 64-key chunks, in f32 on the score
//   registers (base 2: the scale folded with log2 e into one FMA before
//   the SFU's ex2), so P never leaves registers: rounded to bf16 it is the
//   A operand of P V, as the Pallas kernel casts p to v's dtype before
//   that product. Unlike the Pallas kernel, which normalises p before the
//   cast, p is exp(s - running max) and the output is divided by the row
//   sum at the end; the two differ by bf16 rounding of p, inside the bf16
//   gate (1e-2 abs).
// - Keys past T get probability 0 (the tail chunk runs 16, 32 or 48 keys:
//   257 keys cost 272, not 320); query rows past T are not stored.
// At (10,257,16,64) it takes about sdpa's time (PERF.md). What holds
// it: each (frame, head)'s K and V read by three blocks, two blocks an SM,
// and a warp's chain of products, softmax and products per chunk.
//
// f32 kernel (f32 inputs, the 7B fp32 reference path): fp32 FMAs on the
// CUDA cores (TF32 would change an f32 caller's numbers), 32 query rows a
// block, K and V streamed in tiles of 64 with an online softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using hv::cp_async16;
using hv::ex2;
using hv::kLog2e;
using hv::cp_async_commit;
using hv::cp_async_wait_dyn;
using hv::ldmatrix_x4;
using hv::ldmatrix_x4_trans;
using hv::mma_bf16;
using hv::pack_bf16;

constexpr int kD = 64;           // the only head size (the JAX kernel's rule too)
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, all keys resident
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 8;
constexpr int kChunk = 64;       // keys per softmax step and per copy group
constexpr int kMaxKeys = 832;    // 2 x 832 x 128 B + 8 x 2 KB = 224 KB of shared memory

// element offset of (row r, 16-byte chunk c) in a swizzled [rows][64] tile
__device__ __forceinline__ int swz(int r, int c) { return r * kD + ((c ^ (r & 7)) << 3); }

// One softmax step over keys [k0, k0 + 16 * N16) for a warp's 16 query rows;
// MASK where some of those keys lie at or past T (the last chunk).
template <int N16, bool MASK>
__device__ __forceinline__ void attend(const __nv_bfloat16* sk, const __nv_bfloat16* sv,
                                       int k0, int Tn, float scale2, int lane,
                                       const uint32_t (&qa)[kD / 16][4], float (&o)[kD / 8][4],
                                       float& m_lo, float& m_hi, float& l_lo, float& l_hi) {
  constexpr int NT = 2 * N16;  // n8 tiles of scores
  const int tq = lane & 3;
  const int mi = lane >> 3;    // which of ldmatrix's four matrices this lane addresses

  float s[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
    for (int p = 0; p < N16; ++p) {
      // matrices: keys +0..7 / chunk 2kc, +0..7 / 2kc+1, +8..15 / 2kc, +8..15 / 2kc+1
      const int row = k0 + 16 * p + (lane & 7) + ((mi >> 1) << 3);
      uint32_t kb[4];
      ldmatrix_x4(kb, sk + swz(row, 2 * kc + (mi & 1)));
      mma_bf16(s[2 * p], qa[kc], kb[0], kb[1]);
      mma_bf16(s[2 * p + 1], qa[kc], kb[2], kb[3]);
    }
  }

  // raw scores masked and maxed; the scale (> 0) is applied inside exp2
  float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (MASK && k0 + nt * 8 + 2 * tq + e >= Tn) {
        s[nt][e] = kNegInf;
        s[nt][e + 2] = kNegInf;
      }
      mx_lo = fmaxf(mx_lo, s[nt][e]);
      mx_hi = fmaxf(mx_hi, s[nt][e + 2]);
    }
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  // every chunk holds at least one key below T, so the new maxima are
  // finite; m is kept scaled (base-2 exponent units)
  const float mn_lo = fmaxf(m_lo, mx_lo * scale2), mn_hi = fmaxf(m_hi, mx_hi * scale2);
  const float corr_lo = ex2(m_lo - mn_lo), corr_hi = ex2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;

  float sum_lo = 0.f, sum_hi = 0.f;
  uint32_t pa[NT][2];  // p rounded to bf16: [.][0] row g, [.][1] row g + 8
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    // a masked score is -1e30 against a finite max: exp2 gives exactly 0
    const float p0 = ex2(fmaf(s[nt][0], scale2, -mn_lo));
    const float p1 = ex2(fmaf(s[nt][1], scale2, -mn_lo));
    const float p2 = ex2(fmaf(s[nt][2], scale2, -mn_hi));
    const float p3 = ex2(fmaf(s[nt][3], scale2, -mn_hi));
    sum_lo += p0 + p1;
    sum_hi += p2 + p3;
    pa[nt][0] = pack_bf16(p0, p1);
    pa[nt][1] = pack_bf16(p2, p3);
  }
  l_lo = l_lo * corr_lo + sum_lo;
  l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    o[i][0] *= corr_lo;
    o[i][1] *= corr_lo;
    o[i][2] *= corr_hi;
    o[i][3] *= corr_hi;
  }

  // O += P V: score tiles 2kc and 2kc + 1 are the A fragment of keys
  // [16 kc, 16 kc + 16); V's B fragments through ldmatrix.trans (matrices:
  // keys +0..7 / chunk 2dn, +8..15 / 2dn, +0..7 / 2dn+1, +8..15 / 2dn+1)
#pragma unroll
  for (int kc = 0; kc < N16; ++kc) {
    const uint32_t fa[4] = {pa[2 * kc][0], pa[2 * kc][1], pa[2 * kc + 1][0],
                            pa[2 * kc + 1][1]};
    const int row = k0 + 16 * kc + (lane & 7) + ((mi & 1) << 3);
#pragma unroll
    for (int dn = 0; dn < kD / 16; ++dn) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, sv + swz(row, 2 * dn + (mi >> 1)));
      mma_bf16(o[2 * dn], fa, vb[0], vb[1]);
      mma_bf16(o[2 * dn + 1], fa, vb[2], vb[3]);
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    vit_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                        int Tn, int H, float scale2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Tpad = (Tn + 15) & ~15;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + Tpad * kD;

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t tok = (int64_t)H * kD;  // stride between tokens
  const int64_t base = (int64_t)b * Tn * tok + (int64_t)h * kD;
  const int n_chunks = (Tpad + kChunk - 1) / kChunk;
  // this warp's 16 query rows, staged [16][64] swizzled; later its output
  __nv_bfloat16* sw = sv + Tpad * kD + warp * 16 * kD;
  const int q0 = blockIdx.x * (nthreads / 32) * 16 + warp * 16;

  // the warp's query rows first (their own commit group), then every key
  // and value row of this (frame, head), one commit group per 64-key
  // chunk; rows past T zero-filled
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, ch = i & 7;
    const bool in = q0 + r < Tn;
    cp_async16(sw + swz(r, ch), q + base + (in ? (q0 + r) * tok + ch * 8 : 0), in);
  }
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int r0 = c * kChunk, rows = min(kChunk, Tpad - r0);
    for (int i = tid; i < 2 * rows * 8; i += nthreads) {
      const int which = i / (rows * 8), j = i % (rows * 8);
      const int r = r0 + (j >> 3), ch = j & 7;
      const bool in = r < Tn;
      const __nv_bfloat16* src = (which ? v : k) + base + (in ? r * tok + ch * 8 : 0);
      cp_async16((which ? sv : sk) + swz(r, ch), src, in);
    }
    cp_async_commit();
  }

  // the query rows as A fragments (matrices: rows +0..7 / chunk 2kc,
  // +8..15 / 2kc, +0..7 / 2kc+1, +8..15 / 2kc+1)
  cp_async_wait_dyn(n_chunks);
  __syncwarp();
  uint32_t qa[kD / 16][4];
  {
    const int mi = lane >> 3, r = (lane & 7) + ((mi & 1) << 3);
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) ldmatrix_x4(qa[kc], sw + swz(r, 2 * kc + (mi >> 1)));
  }

  float o[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  // a warp whose rows all lie past T (the last tile's spare slice) only
  // keeps the block's barriers
  const bool idle = q0 >= Tn;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_dyn(n_chunks - 1 - c);
    __syncthreads();  // every thread's copies of chunk c have landed
    const int k0 = c * kChunk;
    if (idle) continue;
    if (k0 + kChunk <= Tn) {
      attend<4, false>(sk, sv, k0, Tn, scale2, lane, qa, o, m_lo, m_hi, l_lo, l_hi);
      continue;
    }
    switch (min(kChunk, Tpad - k0) / 16) {
      case 4: attend<4, true>(sk, sv, k0, Tn, scale2, lane, qa, o, m_lo, m_hi, l_lo, l_hi); break;
      case 3: attend<3, true>(sk, sv, k0, Tn, scale2, lane, qa, o, m_lo, m_hi, l_lo, l_hi); break;
      case 2: attend<2, true>(sk, sv, k0, Tn, scale2, lane, qa, o, m_lo, m_hi, l_lo, l_hi); break;
      default: attend<1, true>(sk, sv, k0, Tn, scale2, lane, qa, o, m_lo, m_hi, l_lo, l_hi); break;
    }
  }
  if (idle) return;

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;  // T >= 1 valid keys
  // the output through the warp's staging rows (its q is in registers), so
  // the stores to global memory are whole 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    *reinterpret_cast<uint32_t*>(sw + swz(g, i) + 2 * tq) =
        pack_bf16(o[i][0] * inv_lo, o[i][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(sw + swz(g + 8, i) + 2 * tq) =
        pack_bf16(o[i][2] * inv_hi, o[i][3] * inv_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, ch = i & 7;
    if (q0 + r < Tn)
      *reinterpret_cast<uint4*>(out + base + (q0 + r) * tok + ch * 8) =
          *reinterpret_cast<const uint4*>(sw + swz(r, ch));
  }
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Tn,
                       int H, float scale, cudaStream_t stream) {
  const int slices = (Tn + 15) / 16;                      // 16 query rows each
  const int tiles = (slices + kMaxWarps - 1) / kMaxWarps;  // blocks per (frame, head)
  const int warps = (slices + tiles - 1) / tiles;
  // keys and values, then 16 staging rows per warp
  const size_t smem = (2 * (size_t)((Tn + 15) & ~15) + 16 * warps) * kD * sizeof(__nv_bfloat16);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        vit_attn_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (2 * kMaxKeys + 16 * kMaxWarps) * kD * (int)sizeof(__nv_bfloat16));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(tiles, H, B);
  vit_attn_mma_kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Tn, H,
      scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 FMA on the CUDA cores, K and V streamed
// ---------------------------------------------------------------------------

constexpr int kQT = 32;         // query rows per block
constexpr int kKT = 64;         // keys per tile: two per lane
constexpr int kThreads = 128;
constexpr int kRowsPerWarp = kQT / (kThreads / 32);  // 8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    vit_attn_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, int Tn,
                        int H, float scale) {
  __shared__ float sq[kQT][kD];
  __shared__ float sk[kKT][kD + 1];
  __shared__ float sv[kKT][kD + 1];
  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t tok = (size_t)H * kD;  // stride between tokens
  const size_t base = (size_t)b * Tn * tok + (size_t)h * kD;

  for (int i = tid; i < kQT * kD; i += kThreads) {
    const int r = i / kD, d = i % kD, t = q0 + r;
    sq[r][d] = t < Tn ? q[base + t * tok + d] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc0[kRowsPerWarp], acc1[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
    acc0[rr] = 0.f;
    acc1[rr] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kKT) {
    __syncthreads();  // the previous tile is consumed (and sq is written)
    for (int i = tid; i < kKT * kD; i += kThreads) {
      const int j = i / kD, d = i % kD, t = k0 + j;
      const bool in = t < Tn;
      sk[j][d] = in ? k[base + t * tok + d] : 0.f;
      sv[j][d] = in ? v[base + t * tok + d] : 0.f;
    }
    __syncthreads();
    const bool ok0 = k0 + lane < Tn;
    const bool ok1 = k0 + lane + 32 < Tn;

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) {
        const float qd = sq[r][d];
        s0 += qd * sk[lane][d];
        s1 += qd * sk[lane + 32][d];
      }
      s0 = ok0 ? s0 * scale : kNegInf;
      s1 = ok1 ? s1 * scale : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p0 + p1);
      m[rr] = m_new;
      float a0 = acc0[rr] * corr, a1 = acc1[rr] * corr;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p0, j);
        a0 += pj * sv[j][lane];
        a1 += pj * sv[j][lane + 32];
      }
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p1, j);
        a0 += pj * sv[j + 32][lane];
        a1 += pj * sv[j + 32][lane + 32];
      }
      acc0[rr] = a0;
      acc1[rr] = a1;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = q0 + warp * kRowsPerWarp + rr;
    if (t < Tn) {
      const float inv = 1.f / l[rr];  // every row has T >= 1 valid keys
      out[base + t * tok + lane] = acc0[rr] * inv;
      out[base + t * tok + lane + 32] = acc1[rr] * inv;
    }
  }
}

cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       int B, int Tn, int H, float scale, cudaStream_t stream) {
  const dim3 grid((Tn + kQT - 1) / kQT, H, B);
  vit_attn_fma_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Tn, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, T, H, 64) contiguous and 16-byte aligned, of one dtype
// (bf16, T up to kMaxKeys, or f32). Returns cudaGetLastError() after the
// launch.
extern "C" int hv_vit_attention(const void* q, const void* k, const void* v,
                                void* out, int is_bf16, int B, int Tn, int H,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Tn < 1 || H < 1 || B < 1 || (is_bf16 && Tn > kMaxKeys))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16) return (int)launch_fma(q, k, v, out, B, Tn, H, scale, st);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)launch_mma(q, k, v, out, B, Tn, H, scale, st);
}
