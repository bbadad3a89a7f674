// Blockwise (flash) attention for prefill-sized queries, for Hopper
// (sm_90a): the forward (B3) and the backward (B3b: a delta pass, then a
// dk/dv and a dq kernel, both wgmma fed by TMA). The backward is described
// after the forward's kernels.
//
// Replaces handsonvlm_tpu/ops/flash_attention.py::_fwd_kernel (the
// pallas_call of _fwd_call, reached through flash_attention). It computes
// the same function, not the same blocks: q (B, T, H, D) attends over k, v
// (B, S, K, D) with grouped-query heads (kv head h / (H / K)), a (B, S) key
// mask, causal masking against the scalar q_offset (the absolute position
// of q[:, 0]: the cache index of a prefill), the softmax in f32, the
// probabilities rounded to the inputs' type before the P.V product, and it
// returns the output and each row's logsumexp m + log(l) (f32, (B, H, T)).
// Masked probabilities are zeroed, so a query row with no valid key gives
// output 0 and logsumexp -1e30 (the Pallas kernel averages the keys of the
// tiles it ran there; such rows are left padding and are never read).
//
// What the TPU's layout needed and this kernel does not: q and the cache
// layer are read in place through their strides (no transpose to
// (B, H, T, D), no repeat of the kv heads, no padding to block multiples:
// ragged edges are masked), and the sequential key grid dimension with its
// m / l / acc scratch is a loop over key tiles inside one thread block per
// (query tile, head, batch row). Key tiles above the causal diagonal are
// never visited, and a tile whose keys are all masked or past S is skipped
// after reading its mask bytes, so the cost follows the valid keys, not
// the cache's capacity.
//
// Two kernels:
// - bf16, D in {64, 128, 256}: wgmma, warp-specialised. Bound: operations.
//   A causal prefill of T = S = 4096 rows at 32 heads of 128 is 4 * T * S /
//   2 * H * D = 137 GFLOP a layer, 0.139 ms at 989 TFLOP/s bf16, against
//   0.1 GB of q, k, v and the output (0.04 ms at 3.35 TB/s); only wgmma
//   reaches the tensor cores' full rate, and K and V must reach shared
//   memory without the threads that multiply stalling on them. The design:
//   - A block per (128 query rows, head, batch row), the heaviest query
//     tiles first: two consumer warpgroups of 64 rows each (232 registers
//     a thread after setmaxnreg) and one producer warpgroup (40).
//   - The producer reads each key tile's mask bytes (one key a thread, a
//     ballot a warp), skips a tile with no valid key, and hands the tile's
//     valid-key words and first key to the consumers with K and V: TMA
//     copies of [keys][64 features] boxes of the cache layer in place (a
//     4-d tensor map over its strides, keys past S zero-filled), 128-byte
//     swizzled, into a two-stage ring; a stage's full barrier counts the
//     producer warps' arrivals and the TMA bytes, its empty barrier the
//     consumer warps'. Key tiles of 128 (64 at D = 256, to fit the
//     registers: O alone is 128 a thread there).
//   - S = Q K^T by wgmma from shared memory (Q staged once by cp.async,
//     both operands K-major); the softmax in registers (base 2: the scale
//     times log2 e inside the exponent's FMA; masked scores -inf, so their
//     p is exactly 0; the causal compare only where the tile reaches past
//     the warpgroup's first row, the key mask only where a tile has a
//     masked key); O += P V by wgmma with P rounded to bf16 as the
//     register A operand and V as the MN-major B operand, one n64 wgmma per
//     64 output columns. m, l and O stay in registers for the sweep.
//   At T = S = 4096 it runs at about half of its bound, 1.2x sdpa's time
//   (PERF.md). What holds it is not pinned down (no profiler of the SMs on
//   the card's machine): each warpgroup waits on its own products (the two
//   warpgroups overlap each other, not a warpgroup's softmax with its own
//   products), yet a version that overlapped them (two P register
//   sets, the next tile's Q K^T issued with the last tile's P V, three
//   stages) was slower, and a three-stage ring or 64-key tiles alone
//   gained nothing. Staging K and V by cp.async from the producer's 128
//   threads instead of TMA was about half again as slow, and issuing the
//   two warpgroups' products in strict turns on named barriers (ping-pong)
//   slower still. Untried: three consumer warpgroups, a persistent schedule.
// - any other case (f32, or another head size up to 256): f32 FMA on the
//   CUDA cores (TF32 would change an f32 caller's numbers). A block of
//   four warps takes 32 query rows (8 per warp) and key tiles of 32, one
//   key per lane in the softmax, as the ViT kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;      // (B, T, H, D), head and feature axes contiguous
  const void* k;      // (B, S, K, D)
  const void* v;      // (B, S, K, D)
  const uint8_t* mask;  // (B, S) contiguous, or nullptr
  void* out;          // (B, T, H, D) contiguous
  float* lse;         // (B, H, T) contiguous
  int64_t q_sb, q_st, k_sb, k_st, v_sb, v_st;  // batch / token strides, elements
  int T, S, H, K, D;
  int causal, q_offset;
  float scale;
};

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

// p as the P.V product sees it: rounded to the inputs' type
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f32(from_f32<T>(x));
}

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

// The number of key tiles of `tile` keys a query tile [q0, q0 + rows) has to
// visit: all of S, or under causal masking those up to its last row's
// absolute position.
__device__ __forceinline__ int key_tiles(const Args& a, int q0, int rows, int tile) {
  int end = a.S;
  if (a.causal) {
    const int last_q = min(q0 + rows, a.T) - 1 + a.q_offset;
    end = min(end, last_q + 1);
  }
  return end <= 0 ? 0 : (end + tile - 1) / tile;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma, warp-specialised
// ---------------------------------------------------------------------------

using hv::ex2;
using hv::kLog2e;
using hv::pack_bf16;

constexpr float kLn2 = 0.6931471805599453f;

// The block of the wgmma forward for head size D: kWG consumer warpgroups
// of 64 query rows each and one producer warpgroup; key tiles of kBK keys
// in a ring of kStages stages.
template <int D>
struct Fwd {
  static constexpr int kWG = 2;
  static constexpr int kBM = 64 * kWG;            // query rows a block
  static constexpr int kBK = D == 256 ? 64 : 128;  // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kWords = kBK / 32;          // mask words a tile
  static constexpr int kQBytes = 64 * D * 2;       // one warpgroup's rows
  static constexpr int kKVBytes = kBK * D * 2;     // one K or V tile
  static constexpr int kStageOff = kWG * kQBytes;
  static constexpr int kBarOff = kStageOff + kStages * 2 * kKVBytes;
  // full[s], empty[s] (8 bytes each), k0[s], bits[s][4], the producer's
  // double-buffered tile words [2][4]
  static constexpr int kSmem = kBarOff + 16 * kStages + 4 * kStages + 16 * kStages + 32 +
                               1024;  // + slack to align the base to 1024
  static constexpr int kProducerBar = 1 + kWG;     // named barrier ids: 1..kWG consumers
};

// 16-byte chunk `ch` of row r in a [D / 64][rows][64] tile with the
// 128-byte swizzle (TMA's): bytes from the tile's base
__device__ __forceinline__ int swz_off(int rows, int r, int ch) {
  return (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

template <int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    flash_fwd_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v) {
  using F = Fwd<D>;
  constexpr int BK = F::kBK;
  constexpr int NT = BK / 8;   // n8 tiles of the scores
  constexpr int NC = D / 64;   // 64-wide column blocks of the output
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hv::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + F::kBarOff);
  uint64_t* empty = full + F::kStages;
  int* s_k0 = reinterpret_cast<int*>(empty + F::kStages);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_k0 + F::kStages);  // [stage][4]
  uint32_t* s_pwords = s_bits + 4 * F::kStages;                        // [2][4]

  // the last query tiles have the most keys under causal masking: first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F::kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int wg = threadIdx.x >> 7;
  const int n_tiles = key_tiles(a, q0, F::kBM, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::kStages; ++s) {
      // one from each producer warp (after its mask word); the TMA bytes
      hv::mbar_init(&full[s], 4);
      hv::mbar_init(&empty[s], 4 * F::kWG);  // one from each consumer warp
    }
    hv::mbar_init_fence();
  }
  __syncthreads();

  if (wg == F::kWG) {
    // ---- producer: K and V tiles by TMA, the mask read with them ----
    hv::reg_dealloc<40>();
    const int ptid = threadIdx.x - 128 * F::kWG;
    const int pwarp = ptid >> 5, lane = ptid & 31;
    const uint8_t* mrow = a.mask ? a.mask + (int64_t)b * a.S : nullptr;
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * BK;
      // one key a thread: valid below S and under the mask
      const int p = k0 + ptid;
      const bool ok = ptid < BK && p < a.S && (mrow == nullptr || mrow[p]);
      const uint32_t word = __ballot_sync(0xffffffffu, ok);
      uint32_t* pw = s_pwords + 4 * (kt & 1);
      if (lane == 0) pw[pwarp] = word;
      hv::named_bar_sync(F::kProducerBar, 128);
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < F::kWords; ++w) any |= pw[w];
      if (any == 0) continue;  // a tile with no valid key is never staged
      hv::mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0 && pwarp < F::kWords) s_bits[4 * stage + pwarp] = word;
      if (ptid == 0) s_k0[stage] = k0;
      if (ptid == 0) {
        // [BK keys][64 features] boxes with the 128-byte swizzle, one per 64
        // features of K and of V; keys past S arrive as zeros. This thread's
        // arrival (warp 0's) also expects their bytes.
        unsigned char* sk = smem + F::kStageOff + stage * 2 * F::kKVBytes;
        hv::mbar_arrive_expect_tx(&full[stage], 2 * F::kKVBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          hv::tma_load_4d(sk + cb * BK * 128, &tmap_k, 64 * cb, kh, k0, b, &full[stage]);
          hv::tma_load_4d(sk + F::kKVBytes + cb * BK * 128, &tmap_v, 64 * cb, kh, k0, b,
                          &full[stage]);
        }
      } else if (lane == 0) {
        hv::mbar_arrive(&full[stage]);  // after its mask word
      }
      if (++stage == F::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the end: a stage whose k0 is -1
    hv::mbar_wait(&empty[stage], phase ^ 1);
    if (ptid == 0) s_k0[stage] = -1;
    if (lane == 0) hv::mbar_arrive(&full[stage]);
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [q0w, q0w + 64) ----
  hv::reg_alloc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0w = q0 + 64 * wg;
  unsigned char* sq = smem + wg * F::kQBytes;
  {
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * D;
    for (int i = tid; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), ch = i % (D / 8);
      const bool in = q0w + r < a.T;
      hv::cp_async16(sq + swz_off(64, r, ch),
                     qb + (in ? (int64_t)(q0w + r) * a.q_st + ch * 8 : 0), in);
    }
    hv::cp_async_commit();
    hv::cp_async_wait<0>();
    hv::fence_proxy_async();
    hv::named_bar_sync(1 + wg, 128);
  }

  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // rows g and g + 8 of the warp's 16
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sums
  const int row_lo = q0w + 16 * warp + g;
  const int pos_lo = row_lo + a.q_offset, pos_hi = pos_lo + 8;
  const int first_pos = q0w + a.q_offset;  // the warpgroup's first row
  const float scale2 = a.scale * kLog2e;
  const uint64_t dq = hv::desc_sw128(sq);

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    hv::mbar_wait(&full[stage], phase);
    const int k0 = s_k0[stage];
    if (k0 < 0) break;
    // a tile wholly above the warpgroup's diagonal, or rows all past T
    const bool active = q0w < a.T && (!a.causal || k0 <= first_pos + 63);
    if (active) {
      const unsigned char* sk = smem + F::kStageOff + stage * 2 * F::kKVBytes;
      const unsigned char* sv = sk + F::kKVBytes;
      const uint64_t dk = hv::desc_sw128(sk);
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      hv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // 16 features: column block kk / 4, 32 bytes (2 descriptor units) each
        const uint64_t da = dq + (uint64_t)((kk >> 2) * 64 * 128 / 16 + 2 * (kk & 3));
        const uint64_t db = dk + (uint64_t)((kk >> 2) * BK * 128 / 16 + 2 * (kk & 3));
        if constexpr (BK == 128)
          hv::wgmma_ss_n128(s, da, db, kk > 0);
        else
          hv::wgmma_ss_n64(s, da, db, kk > 0);
      }
      hv::wgmma_commit();
      hv::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) hv::fence_operand(s[i]);

      // masks: the key mask where the tile has a masked key, the causal
      // compare where the tile reaches past the warpgroup's first row
      uint32_t bits[F::kWords];
      uint32_t all = 0xffffffffu;
#pragma unroll
      for (int w = 0; w < F::kWords; ++w) {
        bits[w] = s_bits[4 * stage + w];
        all &= bits[w];
      }
      const bool need_causal = a.causal && k0 + BK - 1 > first_pos;
      if (need_causal || all != 0xffffffffu) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * tq + e;
            const bool kv = (bits[col >> 5] >> (col & 31)) & 1u;
            const int kpos = k0 + col;
            if (!(kv && (!a.causal || kpos <= pos_lo))) s[4 * j + e] = -INFINITY;
            if (!(kv && (!a.causal || kpos <= pos_hi))) s[4 * j + 2 + e] = -INFINITY;
          }
        }
      }

      // online softmax in base 2, m kept scaled: p = 2^(s * scale2 - m)
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo * scale2), mn_hi = fmaxf(m_hi, mx_hi * scale2);
      // a row with no valid key so far keeps m = -inf: exponents against 0
      const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float corr_lo = ex2(m_lo - mu_lo), corr_hi = ex2(m_hi - mu_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
      uint32_t pa[NT][2];  // p rounded to bf16: [.][0] row g, [.][1] row g + 8
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // a masked score is -inf: exactly 0
        const float p0 = ex2(fmaf(s[4 * j], scale2, -mu_lo));
        const float p1 = ex2(fmaf(s[4 * j + 1], scale2, -mu_lo));
        const float p2 = ex2(fmaf(s[4 * j + 2], scale2, -mu_hi));
        const float p3 = ex2(fmaf(s[4 * j + 3], scale2, -mu_hi));
        sum_lo += p0 + p1;
        sum_hi += p2 + p3;
        pa[j][0] = pack_bf16(p0, p1);
        pa[j][1] = pack_bf16(p2, p3);
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j] *= corr_lo;
          o[c][4 * j + 1] *= corr_lo;
          o[c][4 * j + 2] *= corr_hi;
          o[c][4 * j + 3] *= corr_hi;
        }
      }

      // O += P V: score tiles 2kk and 2kk + 1 are the A fragment of keys
      // [16 kk, 16 kk + 16); V is the MN-major B operand, 16 keys a step
      // (2048 bytes), one wgmma per 64-wide column block
      hv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t fa[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                                pa[2 * kk + 1][1]};
#pragma unroll
        for (int c = 0; c < NC; ++c)
          hv::wgmma_rs_n64_tb(o[c], fa, hv::desc_sw128_mn(sv + c * BK * 128 + kk * 2048), 1);
      }
      hv::wgmma_commit();
      hv::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) hv::fence_operand(o[c][i]);
    }
    __syncwarp();
    if (lane == 0) hv::mbar_arrive(&empty[stage]);
    if (++stage == F::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + (int64_t)b * a.T * a.H * D +
                      (int64_t)h * D;
  const int64_t out_st = (int64_t)a.H * D;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * tq;
      if (row_lo < a.T)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * out_st + col) =
            __floats2bfloat162_rn(o[c][4 * j] * inv_lo, o[c][4 * j + 1] * inv_lo);
      if (row_hi < a.T)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * out_st + col) =
            __floats2bfloat162_rn(o[c][4 * j + 2] * inv_hi, o[c][4 * j + 3] * inv_hi);
    }
  }
  if (tq == 0) {
    // logsumexp in natural units: m is scaled by log2 e
    float* lrow = a.lse + ((int64_t)b * a.H + h) * a.T;
    if (row_lo < a.T) lrow[row_lo] = l_lo == 0.f ? kNegInf : m_lo * kLn2 + logf(l_lo);
    if (row_hi < a.T) lrow[row_hi] = l_hi == 0.f ? kNegInf : m_hi * kLn2 + logf(l_hi);
  }
}

// a (B, S, K, D) bf16 tensor read in place (token and batch strides in
// elements) as [rows][64 features] boxes of one head, 128-byte swizzled
bool kv_tensor_map(CUtensorMap* map, const void* base, int B, int S, int K, int D,
                   int64_t st, int64_t sb, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)K, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)st * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hv::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch_wgmma(const Args& a, int B, cudaStream_t stream) {
  using F = Fwd<D>;
  CUtensorMap tmap_k, tmap_v;
  if (!kv_tensor_map(&tmap_k, a.k, B, a.S, a.K, D, a.k_st, a.k_sb, F::kBK) ||
      !kv_tensor_map(&tmap_v, a.v, B, a.S, a.K, D, a.v_st, a.v_sb, F::kBK))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.T + F::kBM - 1) / F::kBM, a.H, B);
  flash_fwd_wgmma_kernel<D><<<grid, F::kThreads, F::kSmem, stream>>>(a, tmap_k, tmap_v);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 FMA (f32 inputs, and bf16 at other head sizes)
// ---------------------------------------------------------------------------

constexpr int kFmaQ = 32;                     // query rows per block
constexpr int kFmaK = 32;                     // keys per tile: one per lane
constexpr int kRowsPerWarp = kFmaQ / kWarps;  // 8
constexpr int kMaxDPerLane = 8;               // D <= 256

size_t fma_smem_bytes(int d) {
  return sizeof(float) * ((size_t)kFmaQ * d + 2 * (size_t)kFmaK * (d + 1)) + kFmaK;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_fma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D;
  const int ld = D + 1;  // per-lane key reads hit distinct banks
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kFmaQ][D]
  float* sk = sq + kFmaQ * D;                      // [kFmaK][ld]
  float* sv = sk + kFmaK * ld;                     // [kFmaK][ld]
  uint8_t* sok = reinterpret_cast<uint8_t*>(sv + kFmaK * ld);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFmaQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = static_cast<const T*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * D;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)kh * D;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)kh * D;
  const uint8_t* mrow = a.mask ? a.mask + (int64_t)b * a.S : nullptr;

  for (int i = tid; i < kFmaQ * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    sq[i] = t < a.T ? to_f32(qb[(int64_t)t * a.q_st + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) acc[rr][i] = 0.f;
  }

  const int n_tiles = key_tiles(a, q0, kFmaQ, kFmaK);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFmaK;
    bool key_ok = false;
    if (tid < kFmaK) {
      const int p = k0 + tid;
      key_ok = p < a.S && (mrow == nullptr || mrow[p]);
    }
    // also the barrier that ends the previous tile's reads (and sq's writes)
    if (!__syncthreads_or(key_ok)) continue;
    if (tid < kFmaK) sok[tid] = key_ok;
    for (int i = tid; i < kFmaK * D; i += kThreads) {
      const int j = i / D, d = i % D, p = k0 + j;
      const bool in = p < a.S;
      sk[j * ld + d] = in ? to_f32(kb[(int64_t)p * a.k_st + d]) : 0.f;
      sv[j * ld + d] = in ? to_f32(vb[(int64_t)p * a.v_st + d]) : 0.f;
    }
    __syncthreads();
    const bool lane_ok = sok[lane];
    const int kpos = k0 + lane;

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float* qr = sq + r * D;
      const float* kr = sk + lane * ld;
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) sc += qr[d] * kr[d];
      const bool ok = lane_ok && (!a.causal || kpos <= q0 + r + a.q_offset);
      sc = ok ? sc * a.scale : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
      const float pr = round_as<T>(p);
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) acc[rr][i] *= corr;
#pragma unroll 4
      for (int j = 0; j < kFmaK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        const float* vr = sv + j * ld;
#pragma unroll
        for (int i = 0; i < kMaxDPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] += pj * vr[d];
        }
      }
    }
  }

  T* ob = static_cast<T*>(a.out) + (int64_t)b * a.T * a.H * D + (int64_t)h * D;
  float* lrow = a.lse + ((int64_t)b * a.H + h) * a.T;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = q0 + warp * kRowsPerWarp + rr;
    if (t >= a.T) continue;
    const float ls = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ob[(int64_t)t * a.H * D + d] = from_f32<T>(acc[rr][i] / ls);
    }
    if (lane == 0) lrow[t] = l[rr] == 0.f ? kNegInf : m[rr] + logf(l[rr]);
  }
}

template <typename T>
cudaError_t launch_fma(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = fma_smem_bytes(a.D);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.T + kFmaQ - 1) / kFmaQ, a.H, B);
  flash_fwd_fma_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, T, H, D), k and v (B, S, K, D) of one dtype (bf16 or f32), the head
// and feature axes contiguous; q_sb / q_st (and k_, v_) are the batch and
// token strides in elements. mask (B, S) bytes, contiguous, or null. out
// (B, T, H, D) of the same dtype and lse (B, H, T) f32, both contiguous.
// bf16 with D in {64, 128, 256}, 16-byte aligned bases and strides that
// are multiples of 8 runs on the tensor cores; anything else with D <= 256
// on f32 FMA. Returns cudaGetLastError().
extern "C" int hv_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
    int is_bf16, int B, int T, int S, int H, int K, int D, int64_t q_sb, int64_t q_st,
    int64_t k_sb, int64_t k_st, int64_t v_sb, int64_t v_st, int causal, int q_offset,
    float scale, void* stream) {
  if (B < 1 || T < 1 || S < 1 || K < 1 || H % K || D < 1 || D > 32 * kMaxDPerLane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = {q, k, v, static_cast<const uint8_t*>(mask), out,
                  static_cast<float*>(lse), q_sb, q_st, k_sb, k_st, v_sb, v_st,
                  T, S, H, K, D, causal, q_offset, scale};
  if (!is_bf16) return (int)launch_fma<float>(a, B, st);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
      (q_sb | q_st | k_sb | k_st | v_sb | v_st) % 8 == 0;
  if (aligned && D == 64) return (int)launch_wgmma<64>(a, B, st);
  if (aligned && D == 128) return (int)launch_wgmma<128>(a, B, st);
  if (aligned && D == 256) return (int)launch_wgmma<256>(a, B, st);
  return (int)launch_fma<__nv_bfloat16>(a, B, st);
}

// ===========================================================================
// Backward (B3b)
// ===========================================================================
//
// Replaces handsonvlm_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the two pallas_calls of _flash_bwd, the VJP of
// flash_attention). The FlashAttention-2 backward: the probabilities are
// recomputed tile by tile from the forward's logsumexp, p = exp(s - lse)
// with the forward's key mask, causal rule and q_offset, never stored;
// dp = dO V^T, ds = p (dp - delta) * scale with delta = rowsum(dO * O) in
// f32; dq = ds K, dv = p^T dO, dk = ds^T Q. As in JAX, p is rounded to dO's
// type before p^T dO, ds to q's type before ds K and ds^T Q, and every sum
// is f32. A masked pair (key masked, above the causal diagonal, or a query
// row past T) gives p = 0, so a query row with no valid key (the forward's
// lse = NEG_INF) gets dq = 0 and adds nothing to dk / dv.
//
// Bound: operations. At B = 1, T = S = 2048, causal, H = 32, D = 128 the
// function needs five T x S x D products (S, dP, dq, dk, dv: 2 flops per
// multiply-add) over the causal half, 86 GFLOP a layer, 0.087 ms at 989
// TFLOP/s bf16; its bytes (q, k, v, O, dO, dq, dk, dv, lse) are ~0.13 GB,
// 0.04 ms at 3.35 TB/s. Only wgmma reaches the tensor cores' full rate,
// and the tiles must reach shared memory without the threads that multiply
// stalling on them.
//
// bf16 with D in {64, 128}: two launches on the stream, built from B3
// forward's parts (TMA boxes of [64 rows][64 features] of one head, read in
// place through the strides, 128-byte swizzled, rows past T or S
// zero-filled; three-stage mbarrier rings; a producer warpgroup whose
// registers setmaxnreg moves to two consumer warpgroups; wgmma in the SS
// form for S and dP, both operands K-major, and in the RS form for the
// three products that take p or ds from registers, the other operand
// MN-major, as B3's P V):
// - the delta pass: D / 8 threads a (batch, token, head) row, 16-byte
//   loads, written to the (B, H, T) scratch that the blocks after it read.
// - one grid of two kinds of block (flash_bwd_wgmma_kernel): the dk/dv
//   blocks, then the dq blocks, each kind the heaviest first, so the dq
//   blocks fill the SMs that the dk/dv blocks' tail leaves idle.
//   - dk/dv: a block per (kv head, 128 keys, batch row). K and V of its
//     keys are loaded once and stay; each consumer warpgroup owns 64 keys.
//     The producer warp brings Q, dO, lse and delta of 64-query tiles: for
//     each query head of the kv head's group in turn, the tiles that can
//     see the keys (none wholly before them under causal masking). Per
//     tile: S^T = K Q^T and dP^T = V dO^T (SS); P^T and dS^T in registers
//     (the key mask, causal compare and T edge only on tiles that need
//     them); dV += P^T dO and dK += dS^T Q (RS). dK and dV stay in f32
//     registers for the whole sweep, the group's heads added in a fixed
//     order with no atomics, so the result is deterministic. A block whose
//     keys are all masked, or that no query sees, writes zeros.
//   - dq: a block per (query head, 128 query rows, batch row); Q and dO
//     resident, each consumer warpgroup owning 64 rows. The producer brings
//     the 64-key tiles that B3 forward visited (none above the causal
//     diagonal, none whose keys are all masked: it reads the mask bytes and
//     hands their words over with the tile). Per tile: S = Q K^T and dP =
//     dO V^T (SS), dS in registers, dQ += dS K (RS, K MN-major). dQ stays
//     in f32 registers.
//   The two kinds compute S and dP once each: seven products for the
//   function's five, which the bound does not count.
// At T = S = 2048 the backward runs at about sdpa's backward, each kind of
// block at 50-60% of the tensor rate on its own products (chip_smoke, PERF.md).
// Tried and slower: the two kinds as two launches (the dk/dv tail idles
// SMs), a two-stage ring (four stages gain nothing over three), the dk/dv
// blocks issuing dV += P^T dO before computing dS (ptxas then serialises
// the wgmmas for want of registers, C7512), block orders with the tiles
// fastest instead of the heads, and a delta pass of one warp a row. Not
// tried: dq inside the dk/dv blocks with dS staged to shared memory
// (FlashAttention-3's; to stay deterministic its f32 dq parts would have to
// be added in a fixed key order across blocks), a persistent schedule.
//
// Anything else (f32, other head sizes up to 256, unaligned strides) runs
// on f32 FMA, one key (dq) or one query (dk/dv) per lane, as the forward's
// FMA kernel, dq first (its prologue writes delta), then dk/dv.

namespace {

struct BwdArgs {
  const void* q;       // (B, T, H, D), head and feature axes contiguous
  const void* k;       // (B, S, K, D)
  const void* v;       // (B, S, K, D)
  const uint8_t* mask;  // (B, S) or nullptr
  const void* out;     // (B, T, H, D) contiguous: the forward's output
  const void* dout;    // (B, T, H, D) contiguous
  const float* lse;    // (B, H, T)
  float* delta;        // (B, H, T) scratch, written first, read after
  void* dq;            // (B, T, H, D) contiguous
  void* dk;            // (B, S, K, D) contiguous
  void* dv;            // (B, S, K, D) contiguous
  int64_t q_sb, q_st, k_sb, k_st, v_sb, v_st;
  int T, S, H, K, D;
  int causal, q_offset;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the delta pass, then the grid of dk/dv and dq
// blocks
// ---------------------------------------------------------------------------

// delta = rowsum(dO * O) in f32: D / 8 threads a row, 16 bytes of each
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const BwdArgs a, int64_t rows) {
  constexpr int kLanes = D / 8;  // 16 or 8 threads a row, in aligned groups of a warp
  const int64_t r = (int64_t)blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int sub = threadIdx.x % kLanes;
  float acc = 0.f;
  if (r < rows) {
    const uint4 o = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.out) +
                                                    r * D + sub * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.dout) +
                                                    r * D + sub * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
      acc += df.x * of.x;
      acc += df.y * of.y;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && r < rows) {
    const int h = (int)(r % a.H);
    const int64_t bt = r / a.H;
    a.delta[(bt / a.T * a.H + h) * a.T + bt % a.T] = acc;
  }
}

// The blocks of the wgmma backward for head size D: two consumer
// warpgroups of 64 rows and one producer warpgroup; every tile is 64 rows
// of one head, [D / 64][64][64] bf16 with the 128-byte swizzle (TMA's).
template <int D>
struct Bwd {
  static constexpr int kThreads = 384;
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStages = 3;
  // dk/dv: K (two tiles) and V (two) resident, then per stage Q, dO and the
  // tile's lse (times log2 e) and delta; barriers full[s], empty[s], kv;
  // the block's four key-valid words
  static constexpr int kKVStageOff = 4 * kTile;
  static constexpr int kKVVecOff = kKVStageOff + kStages * 2 * kTile;
  static constexpr int kKVBarOff = kKVVecOff + kStages * 2 * 64 * 4;
  static constexpr int kKVSmem = kKVBarOff + 8 * (2 * kStages + 1) + 16 + 1024;
  // dq: Q (two tiles) and dO (two) resident, then per stage a key tile's K
  // and V; barriers full[s], empty[s], q; k0[s], bits[s][2], the
  // producer's double-buffered words [2][2]
  static constexpr int kQStageOff = 4 * kTile;
  static constexpr int kQBarOff = kQStageOff + kStages * 2 * kTile;
  static constexpr int kQSmem = kQBarOff + 8 * (2 * kStages + 1) + 4 * kStages + 8 * kStages +
                                16 + 1024;
};

// descriptor units (16 bytes) from a K-major [D / 64][64][64] tile's base to
// its features [16 kk, 16 kk + 16)
__device__ __forceinline__ uint64_t kstep(int kk) {
  return (uint64_t)((kk >> 2) * 64 * 128 / 16 + 2 * (kk & 3));
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (hv::smem_addr(p) & 1023)) & 1023);
}

// a warpgroup's 64 x D f32 accumulators as bf16 rows of a contiguous
// (.., rows, heads, D) tensor: `base` points at row 0's head; rows from
// `limit` on are not written
template <int NC>
__device__ __forceinline__ void store_wg_rows(__nv_bfloat16* base, int64_t row_stride,
                                              const float (&acc)[NC][32], int row_lo,
                                              int limit, int tq) {
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * tq;
      if (row_lo < limit)
        *reinterpret_cast<__nv_bfloat162*>(base + row_lo * row_stride + col) =
            __floats2bfloat162_rn(acc[c][4 * j], acc[c][4 * j + 1]);
      if (row_hi < limit)
        *reinterpret_cast<__nv_bfloat162*>(base + row_hi * row_stride + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2], acc[c][4 * j + 3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void bwd_dkv_block(const BwdArgs& a, const CUtensorMap* tmap_q,
                                              const CUtensorMap* tmap_k,
                                              const CUtensorMap* tmap_v,
                                              const CUtensorMap* tmap_do, const int kh,
                                              const int k0, const int b) {
  using W = Bwd<D>;
  constexpr int NC = D / 64;
  constexpr int kTile = W::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::kKVBarOff);
  uint64_t* empty = full + W::kStages;
  uint64_t* kv_bar = empty + W::kStages;
  uint32_t* s_words = reinterpret_cast<uint32_t*>(kv_bar + 1);  // [4]
  float* s_lse = reinterpret_cast<float*>(smem + W::kKVVecOff);  // [stage][64], x log2 e
  float* s_delta = s_lse + W::kStages * 64;                      // [stage][64]

  const int group = a.H / a.K;
  const int64_t kv_row = (int64_t)a.K * D;  // dk and dv are contiguous
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk) + (int64_t)b * a.S * kv_row +
                       (int64_t)kh * D;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv) + (int64_t)b * a.S * kv_row +
                       (int64_t)kh * D;

  // the block's keys: valid below S and under the mask, a word a warp
  if (threadIdx.x < 128) {
    const int p = k0 + threadIdx.x;
    const bool ok = p < a.S && (a.mask == nullptr || a.mask[(int64_t)b * a.S + p]);
    const uint32_t word = __ballot_sync(0xffffffffu, ok);
    if ((threadIdx.x & 31) == 0) s_words[threadIdx.x >> 5] = word;
  }
  // the query tiles that see the keys: from the first row whose position
  // reaches k0
  const int first_qt = a.causal ? max(0, k0 - a.q_offset) / 64 : 0;
  const int n_qt = (a.T + 63) / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::kStages; ++s) {
      hv::mbar_init(&full[s], 32);  // the producer warp's lanes; the TMA bytes
      hv::mbar_init(&empty[s], 8);  // one from each consumer warp
    }
    hv::mbar_init(kv_bar, 1);
    hv::mbar_init_fence();
  }
  __syncthreads();
  if ((s_words[0] | s_words[1] | s_words[2] | s_words[3]) == 0 || first_qt >= n_qt) {
    // no query reaches these keys: zeros
    for (int i = threadIdx.x; i < 128 * (D / 8); i += W::kThreads) {
      const int p = k0 + i / (D / 8), c = i % (D / 8);
      if (p < a.S) {
        *reinterpret_cast<uint4*>(dkb + p * kv_row + c * 8) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dvb + p * kv_row + c * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: K and V once, then Q, dO, lse and delta a query tile ----
    hv::reg_dealloc<40>();
    if (threadIdx.x >= 256 + 32) return;  // one warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hv::mbar_arrive_expect_tx(kv_bar, 4 * kTile);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int cb = 0; cb < NC; ++cb) {
          hv::tma_load_4d(smem + w * kTile + cb * 8192, tmap_k, 64 * cb, kh, k0 + 64 * w, b,
                          kv_bar);
          hv::tma_load_4d(smem + (2 + w) * kTile + cb * 8192, tmap_v, 64 * cb, kh,
                          k0 + 64 * w, b, kv_bar);
        }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < group; ++i) {
      const int h = kh * group + i;
      const float* lrow = a.lse + ((int64_t)b * a.H + h) * a.T;
      const float* drow = a.delta + ((int64_t)b * a.H + h) * a.T;
      for (int qt = first_qt; qt < n_qt; ++qt) {
        const int q0 = qt * 64;
        hv::mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
        for (int r = lane; r < 64; r += 32) {
          const bool in = q0 + r < a.T;
          s_lse[stage * 64 + r] = in ? lrow[q0 + r] * kLog2e : 0.f;
          s_delta[stage * 64 + r] = in ? drow[q0 + r] : 0.f;
        }
        if (lane == 0) {
          unsigned char* sq = smem + W::kKVStageOff + stage * 2 * kTile;
          hv::mbar_arrive_expect_tx(&full[stage], 2 * kTile);
#pragma unroll
          for (int cb = 0; cb < NC; ++cb) {
            hv::tma_load_4d(sq + cb * 8192, tmap_q, 64 * cb, h, q0, b, &full[stage]);
            hv::tma_load_4d(sq + kTile + cb * 8192, tmap_do, 64 * cb, h, q0, b, &full[stage]);
          }
        } else {
          hv::mbar_arrive(&full[stage]);  // after its lse and delta words
        }
        if (++stage == W::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [k0w, k0w + 64) ----
  hv::reg_alloc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0w = k0 + 64 * wg;
  const int kb_lo = 64 * wg + 16 * warp + g, kb_hi = kb_lo + 8;  // within the block
  const int key_lo = k0 + kb_lo, key_hi = k0 + kb_hi;
  const bool kok_lo = (s_words[kb_lo >> 5] >> (kb_lo & 31)) & 1u;
  const bool kok_hi = (s_words[kb_hi >> 5] >> (kb_hi & 31)) & 1u;
  const bool wg_all = (s_words[2 * wg] & s_words[2 * wg + 1]) == 0xffffffffu;
  const float scale2 = a.scale * kLog2e;
  const uint64_t dka = hv::desc_sw128(smem + wg * kTile);
  const uint64_t dva = hv::desc_sw128(smem + (2 + wg) * kTile);

  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  hv::mbar_wait(kv_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < group; ++i) {
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * 64;
      hv::mbar_wait(&full[stage], phase);
      // a tile whose queries all lie before the warpgroup's first key is idle
      if (!a.causal || q0 + 63 + a.q_offset >= k0w) {
        const unsigned char* sq = smem + W::kKVStageOff + stage * 2 * kTile;
        const unsigned char* sdo = sq + kTile;
        const uint64_t dqb = hv::desc_sw128(sq), ddo = hv::desc_sw128(sdo);
        float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
        hv::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hv::wgmma_ss_n64(st, dka + kstep(kk), dqb + kstep(kk), kk > 0);
        hv::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hv::wgmma_ss_n64(dpt, dva + kstep(kk), ddo + kstep(kk), kk > 0);
        hv::wgmma_commit();
        hv::wgmma_wait<1>();
#pragma unroll
        for (int e = 0; e < 32; ++e) hv::fence_operand(st[e]);

        // p = 2^(s scale log2 e - lse log2 e); masked pairs 0 (the key
        // mask, the T edge, the causal compare) on tiles that have any
        const float* sl = s_lse + stage * 64;
        const float* sd = s_delta + stage * 64;
        const bool need_mask = !wg_all || q0 + 64 > a.T ||
                               (a.causal && q0 + a.q_offset < k0w + 63);
        uint32_t pa[8][2];  // P^T rounded to bf16: [.][0] key row g, [.][1] g + 8
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tq;
          const float2 l2 = *reinterpret_cast<const float2*>(sl + col);
          float p0 = ex2(fmaf(st[4 * j], scale2, -l2.x));
          float p1 = ex2(fmaf(st[4 * j + 1], scale2, -l2.y));
          float p2 = ex2(fmaf(st[4 * j + 2], scale2, -l2.x));
          float p3 = ex2(fmaf(st[4 * j + 3], scale2, -l2.y));
          if (need_mask) {
            const int t0 = q0 + col, t1 = t0 + 1;
            const int lim0 = t0 + a.q_offset, lim1 = lim0 + 1;
            const bool in0 = t0 < a.T, in1 = t1 < a.T;
            if (!(kok_lo && in0 && (!a.causal || key_lo <= lim0))) p0 = 0.f;
            if (!(kok_lo && in1 && (!a.causal || key_lo <= lim1))) p1 = 0.f;
            if (!(kok_hi && in0 && (!a.causal || key_hi <= lim0))) p2 = 0.f;
            if (!(kok_hi && in1 && (!a.causal || key_hi <= lim1))) p3 = 0.f;
          }
          st[4 * j] = p0;
          st[4 * j + 1] = p1;
          st[4 * j + 2] = p2;
          st[4 * j + 3] = p3;
          pa[j][0] = pack_bf16(p0, p1);
          pa[j][1] = pack_bf16(p2, p3);
        }
        hv::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) hv::fence_operand(dpt[e]);
        uint32_t da[8][2];  // dS^T rounded to bf16
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * tq);
          da[j][0] = pack_bf16(st[4 * j] * (dpt[4 * j] - dl.x) * a.scale,
                               st[4 * j + 1] * (dpt[4 * j + 1] - dl.y) * a.scale);
          da[j][1] = pack_bf16(st[4 * j + 2] * (dpt[4 * j + 2] - dl.x) * a.scale,
                               st[4 * j + 3] * (dpt[4 * j + 3] - dl.y) * a.scale);
        }

        // dV += P^T dO, dK += dS^T Q: query tiles 2kk and 2kk + 1 are the A
        // fragment of queries [16 kk, 16 kk + 16); dO and Q the MN-major B
        // operand, 16 queries a step (2048 bytes), an n64 wgmma per 64
        // features
        hv::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t fp[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                                  pa[2 * kk + 1][1]};
#pragma unroll
          for (int c = 0; c < NC; ++c)
            hv::wgmma_rs_n64_tb(dv[c], fp, hv::desc_sw128_mn(sdo + c * 8192 + kk * 2048), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t fd[4] = {da[2 * kk][0], da[2 * kk][1], da[2 * kk + 1][0],
                                  da[2 * kk + 1][1]};
#pragma unroll
          for (int c = 0; c < NC; ++c)
            hv::wgmma_rs_n64_tb(dk[c], fd, hv::desc_sw128_mn(sq + c * 8192 + kk * 2048), 1);
        }
        hv::wgmma_commit();
        hv::wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            hv::fence_operand(dk[c][e]);
            hv::fence_operand(dv[c][e]);
          }
      }
      __syncwarp();
      if (lane == 0) hv::mbar_arrive(&empty[stage]);
      if (++stage == W::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  const int row_lo = k0w + 16 * warp + g;
  store_wg_rows<NC>(dkb, kv_row, dk, row_lo, a.S, tq);
  store_wg_rows<NC>(dvb, kv_row, dv, row_lo, a.S, tq);
}

template <int D>
__device__ __forceinline__ void bwd_dq_block(const BwdArgs& a, const CUtensorMap* tmap_q,
                                             const CUtensorMap* tmap_k,
                                             const CUtensorMap* tmap_v,
                                             const CUtensorMap* tmap_do, const int h,
                                             const int q0, const int b) {
  using W = Bwd<D>;
  constexpr int NC = D / 64;
  constexpr int kTile = W::kTile;
  constexpr int kWords = 2;  // mask words of a 64-key tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W::kQBarOff);
  uint64_t* empty = full + W::kStages;
  uint64_t* q_bar = empty + W::kStages;
  int* s_k0 = reinterpret_cast<int*>(q_bar + 1);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_k0 + W::kStages);  // [stage][2]
  uint32_t* s_pwords = s_bits + kWords * W::kStages;                   // [2][2]

  const int kh = h / (a.H / a.K);
  const int wg = threadIdx.x >> 7;
  int end = a.S;  // the key tiles B3 forward visited
  if (a.causal) end = min(end, min(q0 + 128, a.T) + a.q_offset);
  const int n_tiles = end <= 0 ? 0 : (end + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W::kStages; ++s) {
      // one from each producer warp (after its mask word); the TMA bytes
      hv::mbar_init(&full[s], kWords);
      hv::mbar_init(&empty[s], 8);  // one from each consumer warp
    }
    hv::mbar_init(q_bar, 1);
    hv::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q and dO once, then K and V a key tile, mask read with them ----
    hv::reg_dealloc<40>();
    const int ptid = threadIdx.x - 256;
    if (ptid >= 32 * kWords) return;
    const int pwarp = ptid >> 5, lane = ptid & 31;
    if (ptid == 0) {
      hv::mbar_arrive_expect_tx(q_bar, 4 * kTile);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int cb = 0; cb < NC; ++cb) {
          hv::tma_load_4d(smem + w * kTile + cb * 8192, tmap_q, 64 * cb, h, q0 + 64 * w, b,
                          q_bar);
          hv::tma_load_4d(smem + (2 + w) * kTile + cb * 8192, tmap_do, 64 * cb, h,
                          q0 + 64 * w, b, q_bar);
        }
    }
    const uint8_t* mrow = a.mask ? a.mask + (int64_t)b * a.S : nullptr;
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * 64;
      const int p = k0 + ptid;
      const bool ok = p < a.S && (mrow == nullptr || mrow[p]);
      const uint32_t word = __ballot_sync(0xffffffffu, ok);
      uint32_t* pw = s_pwords + kWords * (kt & 1);
      if (lane == 0) pw[pwarp] = word;
      hv::named_bar_sync(1, 32 * kWords);
      if ((pw[0] | pw[1]) == 0) continue;  // a tile with no valid key is never staged
      hv::mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) s_bits[kWords * stage + pwarp] = word;
      if (ptid == 0) {
        s_k0[stage] = k0;
        unsigned char* sk = smem + W::kQStageOff + stage * 2 * kTile;
        hv::mbar_arrive_expect_tx(&full[stage], 2 * kTile);
#pragma unroll
        for (int cb = 0; cb < NC; ++cb) {
          hv::tma_load_4d(sk + cb * 8192, tmap_k, 64 * cb, kh, k0, b, &full[stage]);
          hv::tma_load_4d(sk + kTile + cb * 8192, tmap_v, 64 * cb, kh, k0, b, &full[stage]);
        }
      } else if (lane == 0) {
        hv::mbar_arrive(&full[stage]);  // after its mask word
      }
      if (++stage == W::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the end: a stage whose k0 is -1
    hv::mbar_wait(&empty[stage], phase ^ 1);
    if (ptid == 0) s_k0[stage] = -1;
    if (lane == 0) hv::mbar_arrive(&full[stage]);
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [q0w, q0w + 64) ----
  hv::reg_alloc<232>();
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0w = q0 + 64 * wg;
  const int row_lo = q0w + 16 * warp + g, row_hi = row_lo + 8;
  const int pos_lo = row_lo + a.q_offset, pos_hi = pos_lo + 8;
  const int first_pos = q0w + a.q_offset;  // the warpgroup's first row
  const int64_t lrow = ((int64_t)b * a.H + h) * a.T;
  const float lse_lo = row_lo < a.T ? a.lse[lrow + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < a.T ? a.lse[lrow + row_hi] * kLog2e : 0.f;
  const float dl_lo = row_lo < a.T ? a.delta[lrow + row_lo] : 0.f;
  const float dl_hi = row_hi < a.T ? a.delta[lrow + row_hi] : 0.f;
  const float scale2 = a.scale * kLog2e;
  const uint64_t dqa = hv::desc_sw128(smem + wg * kTile);
  const uint64_t doa = hv::desc_sw128(smem + (2 + wg) * kTile);

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  hv::mbar_wait(q_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    hv::mbar_wait(&full[stage], phase);
    const int k0 = s_k0[stage];
    if (k0 < 0) break;
    // a tile wholly above the warpgroup's diagonal, or rows all past T
    if (q0w < a.T && (!a.causal || k0 <= first_pos + 63)) {
      const unsigned char* sk = smem + W::kQStageOff + stage * 2 * kTile;
      const unsigned char* sv = sk + kTile;
      const uint64_t dkb = hv::desc_sw128(sk), dvb = hv::desc_sw128(sv);
      float s[32], dp[32];
      hv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hv::wgmma_ss_n64(s, dqa + kstep(kk), dkb + kstep(kk), kk > 0);
      hv::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hv::wgmma_ss_n64(dp, doa + kstep(kk), dvb + kstep(kk), kk > 0);
      hv::wgmma_commit();
      hv::wgmma_wait<1>();
#pragma unroll
      for (int e = 0; e < 32; ++e) hv::fence_operand(s[e]);

      // the key mask where the tile has a masked key, the causal compare
      // where the tile reaches past the warpgroup's first row
      const uint32_t bits0 = s_bits[kWords * stage], bits1 = s_bits[kWords * stage + 1];
      const bool need_mask = (bits0 & bits1) != 0xffffffffu || (a.causal && k0 + 63 > first_pos);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p0 = ex2(fmaf(s[4 * j], scale2, -lse_lo));
        float p1 = ex2(fmaf(s[4 * j + 1], scale2, -lse_lo));
        float p2 = ex2(fmaf(s[4 * j + 2], scale2, -lse_hi));
        float p3 = ex2(fmaf(s[4 * j + 3], scale2, -lse_hi));
        if (need_mask) {
          const int col = 8 * j + 2 * tq;
          const uint32_t bits = col < 32 ? bits0 : bits1;
          const bool kv0 = (bits >> (col & 31)) & 1u, kv1 = (bits >> ((col & 31) + 1)) & 1u;
          const int kpos = k0 + col;
          if (!(kv0 && (!a.causal || kpos <= pos_lo))) p0 = 0.f;
          if (!(kv1 && (!a.causal || kpos + 1 <= pos_lo))) p1 = 0.f;
          if (!(kv0 && (!a.causal || kpos <= pos_hi))) p2 = 0.f;
          if (!(kv1 && (!a.causal || kpos + 1 <= pos_hi))) p3 = 0.f;
        }
        s[4 * j] = p0;
        s[4 * j + 1] = p1;
        s[4 * j + 2] = p2;
        s[4 * j + 3] = p3;
      }
      hv::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) hv::fence_operand(dp[e]);
      uint32_t da[8][2];  // dS rounded to bf16: [.][0] row g, [.][1] row g + 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        da[j][0] = pack_bf16(s[4 * j] * (dp[4 * j] - dl_lo) * a.scale,
                             s[4 * j + 1] * (dp[4 * j + 1] - dl_lo) * a.scale);
        da[j][1] = pack_bf16(s[4 * j + 2] * (dp[4 * j + 2] - dl_hi) * a.scale,
                             s[4 * j + 3] * (dp[4 * j + 3] - dl_hi) * a.scale);
      }

      // dQ += dS K: K the MN-major B operand, 16 keys a step (2048 bytes)
      hv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t fd[4] = {da[2 * kk][0], da[2 * kk][1], da[2 * kk + 1][0],
                                da[2 * kk + 1][1]};
#pragma unroll
        for (int c = 0; c < NC; ++c)
          hv::wgmma_rs_n64_tb(acc[c], fd, hv::desc_sw128_mn(sk + c * 8192 + kk * 2048), 1);
      }
      hv::wgmma_commit();
      hv::wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) hv::fence_operand(acc[c][e]);
    }
    __syncwarp();
    if (lane == 0) hv::mbar_arrive(&empty[stage]);
    if (++stage == W::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const int64_t row_st = (int64_t)a.H * D;  // dq is contiguous
  store_wg_rows<NC>(static_cast<__nv_bfloat16*>(a.dq) + (int64_t)b * a.T * row_st +
                        (int64_t)h * D,
                    row_st, acc, row_lo, a.T, tq);
}

// One launch for both kinds of block: the first n_dkv blocks of the grid
// are dk/dv blocks, the heaviest first (key tile 0 sees the most queries
// under causal masking; kv heads fastest), the rest dq blocks, again the
// heaviest first (the last query tile has the most keys). The dq blocks
// fill the SMs that the dk/dv blocks' tail leaves idle.
template <int D>
__global__ void __launch_bounds__(Bwd<D>::kThreads, 1)
    flash_bwd_wgmma_kernel(const BwdArgs a, const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __grid_constant__ CUtensorMap tmap_do, int n_dkv) {
  int i = blockIdx.x;
  if (i < n_dkv) {
    const int n_kt = (a.S + 127) / 128;
    const int kh = i % a.K;
    i /= a.K;
    bwd_dkv_block<D>(a, &tmap_q, &tmap_k, &tmap_v, &tmap_do, kh, i % n_kt * 128, i / n_kt);
  } else {
    const int n_qt = (a.T + 127) / 128;
    i -= n_dkv;
    const int h = i % a.H;
    i /= a.H;
    bwd_dq_block<D>(a, &tmap_q, &tmap_k, &tmap_v, &tmap_do, h, (n_qt - 1 - i % n_qt) * 128,
                    i / n_qt);
  }
}

// parts: 1 the delta pass, 2 the dk/dv blocks, 4 the dq blocks (7 is the
// backward; the others time a part alone)
template <int D>
cudaError_t launch_bwd_wgmma(const BwdArgs& a, int B, cudaStream_t stream, int parts) {
  const int64_t do_st = (int64_t)a.H * D;  // dout is contiguous
  CUtensorMap m[4];
  if (!kv_tensor_map(&m[0], a.q, B, a.T, a.H, D, a.q_st, a.q_sb, 64) ||
      !kv_tensor_map(&m[1], a.k, B, a.S, a.K, D, a.k_st, a.k_sb, 64) ||
      !kv_tensor_map(&m[2], a.v, B, a.S, a.K, D, a.v_st, a.v_sb, 64) ||
      !kv_tensor_map(&m[3], a.dout, B, a.T, a.H, D, do_st, do_st * a.T, 64))
    return cudaErrorInvalidValue;
  using W = Bwd<D>;
  constexpr int kSmem = W::kKVSmem > W::kQSmem ? W::kKVSmem : W::kQSmem;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if (parts & 1) {
    constexpr int kRows = 256 / (D / 8);  // rows a block of the delta pass
    const int64_t rows = (int64_t)B * a.T * a.H;
    flash_bwd_delta_kernel<D><<<(unsigned)((rows + kRows - 1) / kRows), 256, 0, stream>>>(
        a, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_dkv = parts & 2 ? a.K * ((a.S + 127) / 128) * B : 0;
  const int n_dq = parts & 4 ? a.H * ((a.T + 127) / 128) * B : 0;
  if (n_dkv + n_dq > 0)
    flash_bwd_wgmma_kernel<D><<<n_dkv + n_dq, W::kThreads, kSmem, stream>>>(
        a, m[0], m[1], m[2], m[3], n_dkv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 FMA backward (f32 inputs, and bf16 at other head sizes)
// ---------------------------------------------------------------------------

constexpr int kFmaRows = 32;  // rows a block owns: 8 per warp
constexpr int kFmaCols = 32;  // the other side's tile: one per lane

size_t bwd_fma_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kFmaRows * (d + 1) + 2 * (size_t)kFmaCols * (d + 1) +
                          2 * kFmaCols) + kFmaRows + kFmaCols;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fma_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, ld = D + 1;
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kFmaRows][ld]
  float* sdo = sq + kFmaRows * ld;                 // [kFmaRows][ld]
  float* sk = sdo + kFmaRows * ld;                 // [kFmaCols][ld]
  float* sv = sk + kFmaCols * ld;                  // [kFmaCols][ld]
  uint8_t* sok = reinterpret_cast<uint8_t*>(sv + kFmaCols * ld + 2 * kFmaCols);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFmaRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = static_cast<const T*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * D;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)kh * D;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)kh * D;
  const int64_t row_st = (int64_t)a.H * D;
  const int64_t head0 = (int64_t)b * a.T * row_st + (int64_t)h * D;
  const T* ob = static_cast<const T*>(a.out) + head0;
  const T* dob = static_cast<const T*>(a.dout) + head0;
  const uint8_t* mrow = a.mask ? a.mask + (int64_t)b * a.S : nullptr;
  const int64_t lrow = ((int64_t)b * a.H + h) * a.T;

  for (int i = tid; i < kFmaRows * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    sq[r * ld + d] = t < a.T ? to_f32(qb[(int64_t)t * a.q_st + d]) : 0.f;
    sdo[r * ld + d] = t < a.T ? to_f32(dob[(int64_t)t * row_st + d]) : 0.f;
  }
  __syncthreads();
  float lse[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, t = q0 + r;
    float dl = 0.f;
    if (t < a.T)
      for (int d = lane; d < D; d += 32) dl += sdo[r * ld + d] * to_f32(ob[t * row_st + d]);
    delta[rr] = warp_sum(dl);
    if (lane == 0 && t < a.T) a.delta[lrow + t] = delta[rr];
    lse[rr] = t < a.T ? a.lse[lrow + t] : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) acc[rr][i] = 0.f;
  }

  int end = a.S;
  if (a.causal) end = min(end, min(q0 + kFmaRows, a.T) + a.q_offset);
  const int n_tiles = end <= 0 ? 0 : (end + kFmaCols - 1) / kFmaCols;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFmaCols;
    bool key_ok = false;
    if (tid < kFmaCols) {
      const int p = k0 + tid;
      key_ok = p < a.S && (mrow == nullptr || mrow[p]);
    }
    if (!__syncthreads_or(key_ok)) continue;
    if (tid < kFmaCols) sok[tid] = key_ok;
    for (int i = tid; i < kFmaCols * D; i += kThreads) {
      const int j = i / D, d = i % D, p = k0 + j;
      const bool in = p < a.S;
      sk[j * ld + d] = in ? to_f32(kb[(int64_t)p * a.k_st + d]) : 0.f;
      sv[j * ld + d] = in ? to_f32(vb[(int64_t)p * a.v_st + d]) : 0.f;
    }
    __syncthreads();
    const bool lane_ok = sok[lane];
    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s += sq[r * ld + d] * sk[lane * ld + d];
        dp += sdo[r * ld + d] * sv[lane * ld + d];
      }
      const bool ok = lane_ok && (!a.causal || kpos <= q0 + r + a.q_offset);
      const float p = ok ? expf(s * a.scale - lse[rr]) : 0.f;
      const float ds = round_as<T>(p * (dp - delta[rr]) * a.scale);
      for (int j = 0; j < kFmaCols; ++j) {
        const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < kMaxDPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] += dj * sk[j * ld + d];
        }
      }
    }
  }
  T* dqb = static_cast<T*>(a.dq) + head0;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = q0 + warp * kRowsPerWarp + rr;
    if (t >= a.T) continue;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dqb[(int64_t)t * row_st + d] = from_f32<T>(acc[rr][i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_fma_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, ld = D + 1;
  float* sk = reinterpret_cast<float*>(smem_raw);  // [kFmaRows][ld]
  float* sv = sk + kFmaRows * ld;                  // [kFmaRows][ld]
  float* sq = sv + kFmaRows * ld;                  // [kFmaCols][ld]
  float* sdo = sq + kFmaCols * ld;                 // [kFmaCols][ld]
  float* slse = sdo + kFmaCols * ld;               // [kFmaCols]
  float* sdelta = slse + kFmaCols;                 // [kFmaCols]
  uint8_t* sok = reinterpret_cast<uint8_t*>(sdelta + kFmaCols);  // [kFmaRows]

  const int k0 = blockIdx.x * kFmaRows;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* mrow = a.mask ? a.mask + (int64_t)b * a.S : nullptr;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)b * a.k_sb + (int64_t)kh * D;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)b * a.v_sb + (int64_t)kh * D;

  bool key_ok = false;
  if (tid < kFmaRows) {
    const int p = k0 + tid;
    key_ok = p < a.S && (mrow == nullptr || mrow[p]);
    sok[tid] = key_ok;
  }
  for (int i = tid; i < kFmaRows * D; i += kThreads) {
    const int r = i / D, d = i % D, p = k0 + r;
    sk[r * ld + d] = p < a.S ? to_f32(kb[(int64_t)p * a.k_st + d]) : 0.f;
    sv[r * ld + d] = p < a.S ? to_f32(vb[(int64_t)p * a.v_st + d]) : 0.f;
  }
  const bool any_key = __syncthreads_or(key_ok);

  float dk[kRowsPerWarp][kMaxDPerLane], dv[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) dk[rr][i] = dv[rr][i] = 0.f;

  if (any_key) {
    const int first_q = a.causal ? max(0, k0 - a.q_offset) : 0;
    const int64_t row_st = (int64_t)a.H * D;
    for (int gi = 0; gi < group; ++gi) {
      const int h = kh * group + gi;
      const T* qb = static_cast<const T*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * D;
      const T* dob = static_cast<const T*>(a.dout) + (int64_t)b * a.T * row_st +
                     (int64_t)h * D;
      const int64_t lrow = ((int64_t)b * a.H + h) * a.T;
      for (int q0 = (first_q / kFmaCols) * kFmaCols; q0 < a.T; q0 += kFmaCols) {
        __syncthreads();
        for (int i = tid; i < kFmaCols * D; i += kThreads) {
          const int j = i / D, d = i % D, t = q0 + j;
          sq[j * ld + d] = t < a.T ? to_f32(qb[(int64_t)t * a.q_st + d]) : 0.f;
          sdo[j * ld + d] = t < a.T ? to_f32(dob[(int64_t)t * row_st + d]) : 0.f;
        }
        if (tid < kFmaCols) {
          const int t = q0 + tid;
          slse[tid] = t < a.T ? a.lse[lrow + t] : 0.f;
          sdelta[tid] = t < a.T ? a.delta[lrow + t] : 0.f;
        }
        __syncthreads();
        const int t = q0 + lane;  // this lane's query
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const int r = warp * kRowsPerWarp + rr;
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s += sk[r * ld + d] * sq[lane * ld + d];
            dp += sv[r * ld + d] * sdo[lane * ld + d];
          }
          const bool ok = sok[r] && t < a.T && (!a.causal || k0 + r <= t + a.q_offset);
          const float p = ok ? expf(s * a.scale - slse[lane]) : 0.f;
          const float ds = round_as<T>(p * (dp - sdelta[lane]) * a.scale);
          const float pr = round_as<T>(p);
          for (int j = 0; j < kFmaCols; ++j) {
            const float pj = __shfl_sync(0xffffffffu, pr, j);
            const float dj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
            for (int i = 0; i < kMaxDPerLane; ++i) {
              const int d = lane + 32 * i;
              if (d < D) {
                dv[rr][i] += pj * sdo[j * ld + d];
                dk[rr][i] += dj * sq[j * ld + d];
              }
            }
          }
        }
      }
    }
  }
  const int64_t kv_row_st = (int64_t)a.K * D;
  const int64_t kv_head0 = (int64_t)b * a.S * kv_row_st + (int64_t)kh * D;
  T* dkb = static_cast<T*>(a.dk) + kv_head0;
  T* dvb = static_cast<T*>(a.dv) + kv_head0;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int p = k0 + warp * kRowsPerWarp + rr;
    if (p >= a.S) continue;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dkb[(int64_t)p * kv_row_st + d] = from_f32<T>(dk[rr][i]);
        dvb[(int64_t)p * kv_row_st + d] = from_f32<T>(dv[rr][i]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_bwd_fma(const BwdArgs& a, int B, cudaStream_t stream) {
  const size_t bytes = bwd_fma_smem_bytes(a.D);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_fma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_fma_kernel<T>
      <<<dim3((a.T + kFmaRows - 1) / kFmaRows, a.H, B), kThreads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_fma_kernel<T>
      <<<dim3((a.S + kFmaRows - 1) / kFmaRows, a.K, B), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The backward of hv_flash_attention_fwd with the same q, k, v, mask,
// strides, causal rule and q_offset: out (the forward's output), dout, dq
// (B, T, H, D), dk and dv (B, S, K, D) contiguous, of q's dtype; lse
// (B, H, T) f32 from the forward; delta (B, H, T) f32 scratch. bf16 with D
// in {64, 128}, 16-byte aligned bases and strides that are multiples of 8
// runs on the tensor cores (the delta pass, the dk/dv kernel, the dq
// kernel), anything else with D <= 256 on f32 FMA (the dq kernel, then the
// dk/dv kernel). Returns cudaGetLastError().
extern "C" int hv_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int is_bf16, int B, int T, int S, int H, int K, int D, int64_t q_sb, int64_t q_st,
    int64_t k_sb, int64_t k_st, int64_t v_sb, int64_t v_st, int causal, int q_offset,
    float scale, int parts, void* stream) {
  if (B < 1 || T < 1 || S < 1 || K < 1 || H % K || D < 1 || D > 32 * kMaxDPerLane ||
      parts < 1 || parts > 7)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a = {q, k, v, static_cast<const uint8_t*>(mask), out, dout,
                     static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
                     q_sb, q_st, k_sb, k_st, v_sb, v_st, T, S, H, K, D, causal, q_offset,
                     scale};
  // the FMA route launches its two kernels or nothing
  const int fma = parts == 7 ? 0 : (int)cudaErrorInvalidValue;
  if (!is_bf16) return fma ? fma : (int)launch_bwd_fma<float>(a, B, st);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) % 16 == 0 &&
      (q_sb | q_st | k_sb | k_st | v_sb | v_st) % 8 == 0;
  if (aligned && D == 64) return (int)launch_bwd_wgmma<64>(a, B, st, parts);
  if (aligned && D == 128) return (int)launch_bwd_wgmma<128>(a, B, st, parts);
  return fma ? fma : (int)launch_bwd_fma<__nv_bfloat16>(a, B, st);
}
