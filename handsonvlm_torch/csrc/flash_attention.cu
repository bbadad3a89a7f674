// Blockwise (flash) attention for prefill-sized queries, forward and
// backward, for Hopper (sm_90a). The backward is described after the
// forward's kernels, at hv_flash_attention_bwd's definition.
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
using hv::ldmatrix_x4_trans;
using hv::mma_bf16;
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
// Two kernels, launched in this order on the stream:
// - dq: one block per (64 query rows, query head, batch row) sweeps the key
//   tiles the forward visited (none above the causal diagonal, none whose
//   keys are all masked). Its prologue computes delta for its rows and
//   writes it to the scratch (B, H, T) buffer the second kernel reads.
// - dk/dv: one block per (64 keys, kv head, batch row) sweeps, for each
//   query head of the kv head's group in turn, the query tiles that can see
//   its keys; the group's sum stays in the block's f32 registers, added in
//   a fixed order with no atomics, so a step is deterministic. A block
//   whose keys are all masked writes zeros.
//
// bf16 with D in {64, 128} runs on the tensor cores (mma.sync m16n8k16,
// f32 accumulators): each warp owns 16 rows (queries for dq, keys for
// dk/dv) and the other side comes in tiles of 32; S (or S^T) and dP (dP^T)
// are two fragment products like the forward's S, and the rounded p / ds
// are reused from the registers as the A fragments of the second products,
// whose B fragments come from the staged tiles through ldmatrix.trans.
// Anything else (f32, other head sizes up to 256) runs on f32 FMA, one key
// (dq) or one query (dk/dv) per lane, as the forward's FMA kernel.
//
// Bound: operations. At B = 1, T = S = 2048, causal, H = 32, D = 128 the
// backward's function needs five T x S x D products (S, dP, dq, dk, dv: 2
// flops per multiply-add) over the causal half, 86 GFLOP a layer, 0.087 ms
// at 989 TFLOP/s bf16 (the two kernels compute S and dP twice, seven
// products, which the bound does not count); its bytes (q, k, v, O, dO, dq, dk, dv, lse) are ~0.13
// GB, 0.04 ms at 3.35 TB/s. This first version re-reads K/V per query tile
// and Q/dO per key tile from L2 without overlapping loads and products;
// cp.async / TMA staging and wgmma are the later work toward the bound.

namespace {

constexpr int kBwdRows = 64;  // rows a block owns: 16 per warp
constexpr int kBwdCols = 32;  // the other side's tile

struct BwdArgs {
  const void* q;       // (B, T, H, D), head and feature axes contiguous
  const void* k;       // (B, S, K, D)
  const void* v;       // (B, S, K, D)
  const uint8_t* mask;  // (B, S) or nullptr
  const void* out;     // (B, T, H, D) contiguous: the forward's output
  const void* dout;    // (B, T, H, D) contiguous
  const float* lse;    // (B, H, T)
  float* delta;        // (B, H, T) scratch, written by the dq kernel
  void* dq;            // (B, T, H, D) contiguous
  void* dk;            // (B, S, K, D) contiguous
  void* dv;            // (B, S, K, D) contiguous
  int64_t q_sb, q_st, k_sb, k_st, v_sb, v_st;
  int T, S, H, K, D;
  int causal, q_offset;
  float scale;
};

// rows [r0, r0 + rows) x D of a (.., token, head, D) tensor -> smem[rows][D + 8]
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t token_stride, int r0, int rows,
                                           int limit) {
  constexpr int kLd = D + 8;
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * token_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = val;
  }
}

// acc[nt] (16 rows of A x 8 columns nt of B) += A B^T over D, A's 16 rows
// at sa (pitch D + 8), B's kBwdCols rows at sb
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[kBwdCols / 8][4],
                                        const __nv_bfloat16* sa,
                                        const __nv_bfloat16* sb, int g, int tq) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t fa[4];
    const __nv_bfloat16* ap = sa + g * kLd + kc * 16 + 2 * tq;
    fa[0] = *reinterpret_cast<const uint32_t*>(ap);
    fa[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kLd);
    fa[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
    fa[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kLd + 8);
#pragma unroll
    for (int nt = 0; nt < kBwdCols / 8; ++nt) {
      const __nv_bfloat16* bp = sb + (nt * 8 + g) * kLd + kc * 16 + 2 * tq;
      mma_bf16(acc[nt], fa, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

// out (16 x D) += P (16 x kBwdCols, bf16 A fragments in registers) @ the
// staged [kBwdCols][D] tile at sb
template <int D>
__device__ __forceinline__ void mma_pb(float (&out)[D / 8][4],
                                       const uint32_t (&pa)[kBwdCols / 8][2],
                                       const __nv_bfloat16* sb, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kc = 0; kc < kBwdCols / 16; ++kc) {
    const uint32_t fa[4] = {pa[2 * kc][0], pa[2 * kc][1], pa[2 * kc + 1][0],
                            pa[2 * kc + 1][1]};
    const __nv_bfloat16* brow =
        sb + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, brow + dn * 16);
      mma_bf16(out[2 * dn], fa, fb[0], fb[1]);
      mma_bf16(out[2 * dn + 1], fa, fb[2], fb[3]);
    }
  }
}

// store a warp's 16 x D f32 fragment rows as bf16 rows of a contiguous
// (.., rows, heads, D) tensor: `base` points at row 0's head
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t row_stride,
                                           const float (&acc)[D / 8][4], int row_lo,
                                           int limit, int tq) {
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * tq;
    if (row_lo < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + row_lo * row_stride + c) =
          __floats2bfloat162_rn(acc[i][0], acc[i][1]);
    if (row_hi < limit)
      *reinterpret_cast<__nv_bfloat162*>(base + row_hi * row_stride + c) =
          __floats2bfloat162_rn(acc[i][2], acc[i][3]);
  }
}

template <int D>
size_t bwd_mma_smem_bytes() {
  return (size_t)(2 * kBwdRows + 2 * kBwdCols) * (D + 8) * sizeof(__nv_bfloat16) +
         2 * kBwdCols * sizeof(float) + kBwdRows;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(const BwdArgs a) {
  constexpr int kLd = D + 8;
  constexpr int kCT = kBwdCols / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + kBwdRows * kLd;
  __nv_bfloat16* sk = sdo + kBwdRows * kLd;
  __nv_bfloat16* sv = sk + kBwdCols * kLd;
  float* sdelta = reinterpret_cast<float*>(sv + kBwdCols * kLd);  // [kBwdRows]
  uint8_t* sok = reinterpret_cast<uint8_t*>(sdelta + kBwdRows);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * D;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + (int64_t)b * a.k_sb + (int64_t)kh * D;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + (int64_t)b * a.v_sb + (int64_t)kh * D;
  const int64_t row_st = (int64_t)a.H * D;  // out, dout and dq are contiguous
  const int64_t head0 = (int64_t)b * a.T * row_st + (int64_t)h * D;
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(a.out) + head0;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) + head0;
  const uint8_t* mrow = a.mask ? a.mask + (int64_t)b * a.S : nullptr;
  const int64_t lrow = ((int64_t)b * a.H + h) * a.T;

  stage_rows<D>(sq, qb, a.q_st, q0, kBwdRows, a.T);
  stage_rows<D>(sdo, dob, row_st, q0, kBwdRows, a.T);
  // delta = rowsum(dO * O) in f32: each warp its 16 rows
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, t = q0 + r;
    float acc = 0.f;
    if (t < a.T)
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dob[t * row_st + d]) * __bfloat162float(ob[t * row_st + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      sdelta[r] = acc;
      if (t < a.T) a.delta[lrow + t] = acc;
    }
  }
  __syncthreads();

  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const float lse_lo = row_lo < a.T ? a.lse[lrow + row_lo] : 0.f;
  const float lse_hi = row_hi < a.T ? a.lse[lrow + row_hi] : 0.f;
  const float dl_lo = sdelta[warp * 16 + g], dl_hi = sdelta[warp * 16 + g + 8];
  const int qpos_lo = row_lo + a.q_offset, qpos_hi = qpos_lo + 8;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // the key tiles the forward visited: none past the last row's position
  int end = a.S;
  if (a.causal) end = min(end, min(q0 + kBwdRows, a.T) + a.q_offset);
  const int n_tiles = end <= 0 ? 0 : (end + kBwdCols - 1) / kBwdCols;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBwdCols;
    bool key_ok = false;
    if (tid < kBwdCols) {
      const int p = k0 + tid;
      key_ok = p < a.S && (mrow == nullptr || mrow[p]);
    }
    if (!__syncthreads_or(key_ok)) continue;
    if (tid < kBwdCols) sok[tid] = key_ok;
    stage_rows<D>(sk, kb, a.k_st, k0, kBwdCols, a.S);
    stage_rows<D>(sv, vb, a.v_st, k0, kBwdCols, a.S);
    __syncthreads();

    float s[kCT][4], dp[kCT][4];
#pragma unroll
    for (int i = 0; i < kCT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    mma_abt<D>(s, sq + warp * 16 * kLd, sk, g, tq);
    mma_abt<D>(dp, sdo + warp * 16 * kLd, sv, g, tq);

    uint32_t pa[kCT][2];  // ds rounded to bf16: [.][0] row g, [.][1] row g + 8
#pragma unroll
    for (int nt = 0; nt < kCT; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * tq + (e & 1);
        const bool hi = e >= 2;
        const bool ok = sok[j] && (!a.causal || k0 + j <= (hi ? qpos_hi : qpos_lo));
        const float p = ok ? expf(s[nt][e] * a.scale - (hi ? lse_hi : lse_lo)) : 0.f;
        ds[e] = p * (dp[nt][e] - (hi ? dl_hi : dl_lo)) * a.scale;
      }
      pa[nt][0] = pack_bf16(ds[0], ds[1]);
      pa[nt][1] = pack_bf16(ds[2], ds[3]);
    }
    mma_pb<D>(acc, pa, sk, lane);
  }
  store_rows<D>(static_cast<__nv_bfloat16*>(a.dq) + head0, row_st, acc, row_lo, a.T, tq);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma_kernel(const BwdArgs a) {
  constexpr int kLd = D + 8;
  constexpr int kCT = kBwdCols / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + kBwdRows * kLd;
  __nv_bfloat16* sq = sv + kBwdRows * kLd;
  __nv_bfloat16* sdo = sq + kBwdCols * kLd;
  float* slse = reinterpret_cast<float*>(sdo + kBwdCols * kLd);  // [kBwdCols]
  float* sdelta = slse + kBwdCols;                                // [kBwdCols]
  uint8_t* sok = reinterpret_cast<uint8_t*>(sdelta + kBwdCols);   // [kBwdRows]

  const int k0 = blockIdx.x * kBwdRows;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const uint8_t* mrow = a.mask ? a.mask + (int64_t)b * a.S : nullptr;

  bool key_ok = false;
  if (tid < kBwdRows) {
    const int p = k0 + tid;
    key_ok = p < a.S && (mrow == nullptr || mrow[p]);
    sok[tid] = key_ok;
  }
  const bool any_key = __syncthreads_or(key_ok);

  const int64_t kv_row_st = (int64_t)a.K * D;  // dk and dv are contiguous
  const int64_t kv_head0 = (int64_t)b * a.S * kv_row_st + (int64_t)kh * D;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  if (any_key) {
    stage_rows<D>(sk, static_cast<const __nv_bfloat16*>(a.k) + (int64_t)b * a.k_sb +
                          (int64_t)kh * D, a.k_st, k0, kBwdRows, a.S);
    stage_rows<D>(sv, static_cast<const __nv_bfloat16*>(a.v) + (int64_t)b * a.v_sb +
                          (int64_t)kh * D, a.v_st, k0, kBwdRows, a.S);
    const bool kok_lo = sok[warp * 16 + g], kok_hi = sok[warp * 16 + g + 8];
    // the first query tile whose rows can see key k0 under causal masking
    const int first_q = a.causal ? max(0, k0 - a.q_offset) : 0;
    const int64_t row_st = (int64_t)a.H * D;
    for (int i = 0; i < group; ++i) {
      const int h = kh * group + i;
      const __nv_bfloat16* qb =
          static_cast<const __nv_bfloat16*>(a.q) + (int64_t)b * a.q_sb + (int64_t)h * D;
      const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(a.dout) +
                                 (int64_t)b * a.T * row_st + (int64_t)h * D;
      const int64_t lrow = ((int64_t)b * a.H + h) * a.T;
      for (int q0 = (first_q / kBwdCols) * kBwdCols; q0 < a.T; q0 += kBwdCols) {
        __syncthreads();  // the previous tile's reads of sq, sdo, slse, sdelta are done
        stage_rows<D>(sq, qb, a.q_st, q0, kBwdCols, a.T);
        stage_rows<D>(sdo, dob, row_st, q0, kBwdCols, a.T);
        if (tid < kBwdCols) {
          const int t = q0 + tid;
          slse[tid] = t < a.T ? a.lse[lrow + t] : 0.f;
          sdelta[tid] = t < a.T ? a.delta[lrow + t] : 0.f;
        }
        __syncthreads();

        float st[kCT][4], dpt[kCT][4];
#pragma unroll
        for (int c = 0; c < kCT; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[c][e] = dpt[c][e] = 0.f;
        mma_abt<D>(st, sk + warp * 16 * kLd, sq, g, tq);
        mma_abt<D>(dpt, sv + warp * 16 * kLd, sdo, g, tq);

        uint32_t pa[kCT][2], da[kCT][2];  // p^T and ds^T as bf16 A fragments
#pragma unroll
        for (int nt = 0; nt < kCT; ++nt) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = nt * 8 + 2 * tq + (e & 1);  // query within the tile
            const bool hi = e >= 2;
            const int t = q0 + j;
            const bool ok = (hi ? kok_hi : kok_lo) && t < a.T &&
                            (!a.causal || (hi ? key_hi : key_lo) <= t + a.q_offset);
            p[e] = ok ? expf(st[nt][e] * a.scale - slse[j]) : 0.f;
            ds[e] = p[e] * (dpt[nt][e] - sdelta[j]) * a.scale;
          }
          pa[nt][0] = pack_bf16(p[0], p[1]);
          pa[nt][1] = pack_bf16(p[2], p[3]);
          da[nt][0] = pack_bf16(ds[0], ds[1]);
          da[nt][1] = pack_bf16(ds[2], ds[3]);
        }
        mma_pb<D>(dv, pa, sdo, lane);
        mma_pb<D>(dk, da, sq, lane);
      }
    }
  }
  store_rows<D>(static_cast<__nv_bfloat16*>(a.dk) + kv_head0, kv_row_st, dk, key_lo, a.S, tq);
  store_rows<D>(static_cast<__nv_bfloat16*>(a.dv) + kv_head0, kv_row_st, dv, key_lo, a.S, tq);
}

template <int D>
cudaError_t launch_bwd_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  const size_t bytes = bwd_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<D>
      <<<dim3((a.T + kBwdRows - 1) / kBwdRows, a.H, B), kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_mma_kernel<D>
      <<<dim3((a.S + kBwdRows - 1) / kBwdRows, a.K, B), kThreads, bytes, stream>>>(a);
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
// (B, H, T) f32 from the forward; delta (B, H, T) f32 scratch. Launches
// the dq kernel, then the dk/dv kernel. bf16 with D in {64, 128}, 16-byte
// aligned bases and strides that are multiples of 8 runs on the tensor
// cores, anything else with D <= 256 on f32 FMA. Returns cudaGetLastError().
extern "C" int hv_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
    int is_bf16, int B, int T, int S, int H, int K, int D, int64_t q_sb, int64_t q_st,
    int64_t k_sb, int64_t k_st, int64_t v_sb, int64_t v_st, int causal, int q_offset,
    float scale, void* stream) {
  if (B < 1 || T < 1 || S < 1 || K < 1 || H % K || D < 1 || D > 32 * kMaxDPerLane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a = {q, k, v, static_cast<const uint8_t*>(mask), out, dout,
                     static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
                     q_sb, q_st, k_sb, k_st, v_sb, v_st, T, S, H, K, D, causal, q_offset,
                     scale};
  if (!is_bf16) return (int)launch_bwd_fma<float>(a, B, st);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv)) % 16 == 0 &&
      (q_sb | q_st | k_sb | k_st | v_sb | v_st) % 8 == 0;
  if (aligned && D == 64) return (int)launch_bwd_mma<64>(a, B, st);
  if (aligned && D == 128) return (int)launch_bwd_mma<128>(a, B, st);
  return (int)launch_bwd_fma<__nv_bfloat16>(a, B, st);
}
