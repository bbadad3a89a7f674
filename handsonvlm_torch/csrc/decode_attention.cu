// Decode attention over one layer of the stacked KV cache, for Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/decode_attention.py::_decode_stacked_kernel in
// both of its modes: the bf16/f32 cache (quant=False, reached through
// decode_attention_stacked: kernel B1) and the int8 cache with per-(token,
// kv head) f32 scales (quant=True, reached through
// decode_attention_stacked_q: kernel B6). One kernel body, templated on the
// cache's element type and the head size, serves both entry points, and a
// third: kernel B12, which replaces
// handsonvlm_tpu/ops/decode_attention.py::_decode_kernel (reached through
// decode_attention): one query row per head over one layer's (B, S, K, D)
// cache with a scalar `length` and a (B, S) key mask, no per-row block
// table. There the listed tiles are every 32-key tile below `length`, in
// order (table == nullptr).
//
// The function: a query window of T <= 8 rows (T = 1 for plain decode,
// T > 1 for a speculative verify window) attends over positions
// [0, length) of one layer of the (L, B, S, K, D) cache with grouped-query
// heads, a (B, S) key mask, the per-row causal limit pos < length - (T-1)
// + tq, an fp32 online softmax, masked probabilities zeroed and l == 0 ->
// output 0 (a row with no valid key gives zeros). As the Pallas kernel,
// each row walks a compacted list of its cache blocks (block_k keys each,
// a multiple of 32): table[b, :counts[b]] are the blocks with a valid key
// below `length`, in order (built once per forward by the wrapper); other
// blocks are never read.
//
// Bound: bytes. A call must read 2 * (valid keys) * K * D * sizeof(cache
// type) bytes (B = 1, K = 32, D = 128, 450 keys, bf16: 7.4 MB, 2.2 us at
// 3.35 TB/s; the int8 cache and its scales: 3.8 MB, 1.1 us). The card
// reaches its rate only with enough bytes in flight (Little's law at
// 3.35 TB/s and ~1 us: ~25 KB per SM), and a one-row decode has almost no
// arithmetic to hide a stall behind. The design:
// - A thread block of four warps per (kv head, batch row, split, group of
//   up to eight query rows). Splits are cut over the ordinal of the row's
//   listed 32-key tiles and sized from the row's own count only (read on
//   the device, so the host needs no sync): serving compaction
//   (ops/cache_ops) deletes empty blocks and shifts the rest by whole
//   blocks, so every split sees the same tiles in the same order and a
//   live row's output is bit-equal across it.
// - The split's keys are cut into units of KW keys (~4 KB of K), dealt to
//   the warps round-robin by ordinal. Each warp looks up its units in the
//   row's block table itself and stages their K and V rows (and the int8
//   scales) by 16-byte cp.async into its own two-stage ring in shared
//   memory (4-byte copies for the scales), one unit ahead of the math; the
//   first two units' copies go out before the block loads its query rows.
//   Keys past `length` are zero-filled, never read; a unit's mask bytes are
//   loaded with its copies and applied when it is computed (a unit with no
//   valid key is not computed). No block barrier per tile: a warp waits on
//   its own copies.
// - A lane holds 8 consecutive features of one key (a 16-byte row chunk of
//   bf16, 8 bytes of int8, 32 of f32): a 128-wide key is 16 lanes, so one
//   warp instruction covers two keys. The score q.k is reduced by a shuffle
//   tree over the lanes of that key, in a fixed order.
// - Each warp runs its own online softmax over its keys (base 2: the
//   scale times log2 e inside the exponent's FMA), with m, l and each
//   row's output in registers; a lane's output sums the keys of its lane
//   group and is reduced over the groups once, at the end.
// - The warps' partials are merged in warp order through shared memory.
//   With one split the block writes the output. Otherwise the splits of a
//   (row, kv head, row group) are one thread block cluster (at most 8, the
//   portable size): each keeps its f32 (m, l, acc) in shared memory, and
//   after a cluster barrier the blocks each merge a share of the outputs,
//   every split in split order, from their peers' shared memory. One launch
//   a call and no scratch in device memory; the order of the sums does not
//   depend on which block ran first.
// The arithmetic of a query row does not depend on the other rows of the
// window (the rows of a block are independent lanes of the same code), so
// a window row is bit-equal to that row decoded alone.
//
// Over the int8 cache the dequantization is exact and needs no transpose,
// as in the Pallas kernel: each score is scaled by its key's k-scale
// ((q . k8) * ks == q . (k8 * ks)) and each probability, after it has been
// added to l, by its key's v-scale before the P.V product
// ((p * vs) . v8 == p . (v8 * vs)).
//
// Head sizes 16, 32, 64, 128 and 256 (a power of two: the lanes of a key
// form a shuffle subtree).
// Untried: a persistent schedule over (row, head) pairs; TMA bulk copies of
// a unit's rows; a split count chosen from the measured rate at each
// (B, length) instead of the SM count alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "mma.cuh"

namespace {

using hv::ex2;
using hv::kLog2e;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // keys of a listed tile (the split plan's unit)
constexpr int kRows = 8;       // query rows a block carries at most
constexpr int kStages = 2;     // a warp's ring: one unit computed, one in flight
constexpr int kMaxSplits = 8;  // splits of a row: one cluster (the portable size)

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 4 bytes global -> shared (the int8 cache's scales: their rows need not be
// 16-byte aligned); with `valid` false the 4 bytes are zero-filled
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hv::smem_addr(smem_dst)), "l"(src), "r"(valid ? 4 : 0));
}

// 8 features of a staged key row as floats
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(float (&x)[8], const int8_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = (float)(int8_t)(u.x >> (8 * i));
    x[4 + i] = (float)(int8_t)(u.y >> (8 * i));
  }
}
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Geometry of the body for a cache element type C and head size D.
template <typename C, int D>
struct Geo {
  static_assert(D >= 16 && D <= 256 && (D & (D - 1)) == 0, "head size: a power of two, 16..256");
  static constexpr bool kQuant = std::is_same<C, int8_t>::value;
  static constexpr int kLPK = D / 8;           // lanes of a key: 8 features a lane
  static constexpr int kKPI = 32 / kLPK;       // keys one warp instruction covers
  static constexpr int kKeyBytes = D * (int)sizeof(C);
  static constexpr int kChunks = kKeyBytes / 16;  // 16-byte chunks of a key row
  // keys of a unit: ~4 KB of K, at least one instruction, at most eight
  static constexpr int kKW0 = 4096 / kKeyBytes;
  static constexpr int kKW1 = kKW0 > kTile ? kTile : kKW0;
  static constexpr int kKW2 = kKW1 < kKPI ? kKPI : kKW1;
  static constexpr int kKW = kKW2 > 8 * kKPI ? 8 * kKPI : kKW2;
  static constexpr int kNJ = kKW / kKPI;       // instructions a unit
  static constexpr int kUPT = kTile / kKW;     // units a tile
  static constexpr int kScaleBytes = kQuant ? 2 * kKW * 4 : 0;
  static constexpr int kUnitBytes = 2 * kKW * kKeyBytes + kScaleBytes;
  static constexpr int kRing = kWarps * kStages * kUnitBytes;
  // the warps' partials (m, l, acc of each row), then the block's
  static constexpr int kMerge = (kWarps + 1) * kRows * (D + 2) * 4;
  static constexpr int kPool = kRing > kMerge ? kRing : kMerge;
};

// The split plan of one row: the row's listed tiles, count * (block_k /
// 32), cut into at most max_splits splits of split_tiles each; n_split of
// them are used (1 when the row is empty). It depends on nothing but the
// row's own count, so another row's list (a finished request's plane,
// emptied by compaction) never regroups it.
struct SplitPlan {
  int split_tiles;
  int n_split;
};

__device__ __forceinline__ SplitPlan split_plan(int count, int tiles_per_block,
                                                int max_splits) {
  const int total = count * tiles_per_block;
  if (total == 0) return {0, 1};
  const int want = min(max_splits, total);
  const int st = (total + want - 1) / want;
  return {st, (total + st - 1) / st};
}

// Dynamic shared memory: q rows [kRows][D] f32, then the warps' rings
// (reused by the warps' partials and the block's).
template <typename C, int D>
constexpr size_t smem_bytes() {
  return (size_t)kRows * D * 4 + Geo<C, D>::kPool;
}

// The block's merged partial (m, l and acc of its rows) in shared memory,
// after the warps' partials: the same offsets in every block of a cluster.
template <int D>
struct Partial {
  float* m;    // [kRows], base 2, scaled
  float* l;    // [kRows]
  float* acc;  // [kRows][D]
  __device__ explicit Partial(unsigned char* smem_raw) {
    float* warps = reinterpret_cast<float*>(smem_raw + kRows * D * 4);
    m = warps + kWarps * kRows * (D + 2);
    l = m + kRows;
    acc = l + kRows;
  }
};

struct Args {
  const void* q;        // (B, tw, H, D)
  const void* ck;       // (B, S, K, D), one layer
  const void* cv;
  const float* ks;      // (B, K, S), one layer (int8 cache) or null
  const float* vs;
  const uint8_t* mask;  // (B, S) or null
  const int* table;     // (B, nk) listed blocks, or null: blocks 0..dense_count-1
  const int* counts;    // (B,)
  int dense_count;
  void* out;            // (B, tw, H, D)
  int tw, H, K, S, length, nk, block_k, max_splits;
  float scale2;         // softmax scale x log2 e
};

// The splits of (row, kv head, row group) are one thread block cluster:
// each split's partial waits in its block's shared memory, and the first
// n_split blocks each merge a share of the outputs, every split in split
// order, reading their peers' shared memory. A block leaves only after the
// last read of its partial.
template <typename T, int D>
__device__ void merge_splits(const Args& a, unsigned char* smem_raw, int n_split, int b, int kh,
                             int r0, int nr) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const Partial<D> mine(smem_raw);
  cluster.sync();  // every split's partial is in place
  const int rank = (int)cluster.block_rank();
  if (rank < n_split) {
    T* out = static_cast<T*>(a.out);
    const int G_ = a.H / a.K;
    for (int i = rank * kThreads + (int)threadIdx.x; i < nr * D; i += n_split * kThreads) {
      const int r = i / D, d = i % D, row = r0 + r;
      float mm = -INFINITY;
      for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, *cluster.map_shared_rank(mine.m + r, s));
      const float mu = mm == -INFINITY ? 0.f : mm;
      float num = 0.f, den = 0.f;
      for (int s = 0; s < n_split; ++s) {
        const float e = ex2(*cluster.map_shared_rank(mine.m + r, s) - mu);
        num += e * *cluster.map_shared_rank(mine.acc + r * D + d, s);
        den += e * *cluster.map_shared_rank(mine.l + r, s);
      }
      const int g = row / a.tw, tq = row % a.tw;
      out[((size_t)(b * a.tw + tq) * a.H + kh * G_ + g) * D + d] =
          from_f32<T>(num / (den == 0.f ? 1.f : den));
    }
  }
  cluster.sync();  // no partial is read any more
}

template <typename T, typename C, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const Args a) {
  using G = Geo<C, D>;
  constexpr int LPK = G::kLPK, KPI = G::kKPI, KW = G::kKW, NJ = G::kNJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kRows][D]
  unsigned char* pool = smem_raw + kRows * D * 4;

  const int n_rg = gridDim.x / a.K;  // row groups of kRows query rows
  const int kh = blockIdx.x / n_rg;
  const int rg = blockIdx.x % n_rg;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tiles_per_block = a.block_k / kTile;
  const int count = a.table ? a.counts[b] : a.dense_count;
  const SplitPlan plan = split_plan(count, tiles_per_block, a.max_splits);
  const int G_ = a.H / a.K;
  const int R = G_ * a.tw;
  const int r0 = rg * kRows;
  const int nr = min(kRows, R - r0);
  if (split >= plan.n_split) {  // uniform over the block, and over its cluster
    if (plan.n_split > 1) merge_splits<T, D>(a, smem_raw, plan.n_split, b, kh, r0, nr);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const size_t pos_stride = (size_t)a.K * D;
  const C* kbase = static_cast<const C*>(a.ck) + (size_t)b * a.S * pos_stride + (size_t)kh * D;
  const C* vbase = static_cast<const C*>(a.cv) + (size_t)b * a.S * pos_stride + (size_t)kh * D;
  const float* ksrow = G::kQuant ? a.ks + ((size_t)b * a.K + kh) * a.S : nullptr;
  const float* vsrow = G::kQuant ? a.vs + ((size_t)b * a.K + kh) * a.S : nullptr;
  const uint8_t* mrow = a.mask ? a.mask + (size_t)b * a.S : nullptr;
  const int* trow = a.table ? a.table + (size_t)b * a.nk : nullptr;
  const int c0 = split * plan.split_tiles;
  const int n_tiles = max(0, min(count * tiles_per_block, c0 + plan.split_tiles) - c0);
  const int end = min(a.length, a.S);

  // this warp's units: u = warp, warp + 4, ... of the split's n_tiles * UPT
  const int n_units = n_tiles * G::kUPT;
  const int n_mine = n_units > warp ? (n_units - warp + kWarps - 1) / kWarps : 0;
  unsigned char* ring = pool + (size_t)warp * kStages * G::kUnitBytes;
  // the first position of this warp's i-th unit, from the row's block table
  auto unit_t0 = [&](int i) {
    const int u = warp + i * kWarps;
    const int c = c0 + u / G::kUPT;
    const int blk = trow ? trow[c / tiles_per_block] : c / tiles_per_block;
    return blk * a.block_k + (c % tiles_per_block) * kTile + (u % G::kUPT) * KW;
  };
  // K and V rows (and the int8 scales) of the keys below `end`; the rest
  // are zero-filled, never read. Returns lane j's key's mask byte (or 1),
  // loaded now and read when the unit is computed.
  auto prefetch = [&](int t0, int slot) {
    unsigned char* st = ring + slot * G::kUnitBytes;
    C* sk = reinterpret_cast<C*>(st);
    C* sv = reinterpret_cast<C*>(st + KW * G::kKeyBytes);
    for (int x = lane; x < KW * G::kChunks; x += 32) {
      const int key = x / G::kChunks, part = x % G::kChunks;
      const bool ok = t0 + key < end;
      const size_t off = ok ? (size_t)(t0 + key) * pos_stride + part * (16 / sizeof(C)) : 0;
      hv::cp_async16(sk + key * D + part * (16 / sizeof(C)), kbase + off, ok);
      hv::cp_async16(sv + key * D + part * (16 / sizeof(C)), vbase + off, ok);
    }
    if constexpr (G::kQuant) {
      float* ss = reinterpret_cast<float*>(st + 2 * KW * G::kKeyBytes);
      if (lane < KW) {
        const bool ok = t0 + lane < end;
        const int p = ok ? t0 + lane : 0;
        cp_async4(ss + lane, ksrow + p, ok);
        cp_async4(ss + KW + lane, vsrow + p, ok);
      }
    }
    return lane < KW && t0 + lane < end && mrow != nullptr ? mrow[t0 + lane] : (uint8_t)1;
  };

  // the first units' copies go out before anything else is waited for
  int t0s[kStages];
  uint8_t mbyte[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    t0s[s] = 0;
    mbyte[s] = 0;
    if (s < n_mine) {
      t0s[s] = unit_t0(s);
      mbyte[s] = prefetch(t0s[s], s);
    }
    hv::cp_async_commit();
  }

  // the block's query rows (row r = g * tw + tq, the Pallas kernel's layout)
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    float x = 0.f;
    if (r < nr) {
      const int g = row / a.tw, tq = row % a.tw;
      x = to_f32(q[((size_t)(b * a.tw + tq) * a.H + kh * G_ + g) * D + d]);
    }
    sq[i] = x;
  }
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }
  const int key_in = lane / LPK;  // the key of an instruction this lane holds
  const int feat = (lane % LPK) * 8;
  // row r's causal limit: pos < length - (tw - 1) + tq
  int lim[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) lim[r] = a.length - (a.tw - 1) + (r0 + r) % a.tw;

  for (int i0 = 0; i0 < n_mine; i0 += kStages) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int i = i0 + s;
      if (i < n_mine) {
        const int t0 = t0s[s];
        // the unit's valid keys: below `end`, mask set
        const uint32_t bits = __ballot_sync(0xffffffffu, lane < KW && t0 + lane < end &&
                                                             mbyte[s] != 0);
        hv::cp_async_wait<kStages - 1>();
        __syncwarp();  // every lane's copies of this unit have landed
        if (bits != 0u) {  // a unit with no valid key would add p = 0 alone
          const unsigned char* st = ring + s * G::kUnitBytes;
          const C* sk = reinterpret_cast<const C*>(st);
          const C* sv = reinterpret_cast<const C*>(st + KW * G::kKeyBytes);
          float ksc[NJ], vsc[NJ];
          bool kok[NJ];
          int pos[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int key = j * KPI + key_in;
            kok[j] = (bits >> key) & 1u;
            pos[j] = t0 + key;
            if constexpr (G::kQuant) {
              const float* ss = reinterpret_cast<const float*>(st + 2 * KW * G::kKeyBytes);
              ksc[j] = ss[key];
              vsc[j] = ss[KW + key];
            } else {
              ksc[j] = 1.f;
              vsc[j] = 1.f;
            }
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r >= nr) continue;
            float qr[8];
            const float4 qa = *reinterpret_cast<const float4*>(sq + r * D + feat);
            const float4 qb = *reinterpret_cast<const float4*>(sq + r * D + feat + 4);
            qr[0] = qa.x; qr[1] = qa.y; qr[2] = qa.z; qr[3] = qa.w;
            qr[4] = qb.x; qr[5] = qb.y; qr[6] = qb.z; qr[7] = qb.w;
            float sc[NJ];
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              float kx[8];
              load8(kx, sk + (j * KPI + key_in) * D + feat);
              float dot = 0.f;
#pragma unroll
              for (int e = 0; e < 8; ++e) dot = fmaf(qr[e], kx[e], dot);
#pragma unroll
              for (int o = LPK / 2; o >= 1; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
              // int8: (q . k8) * ks, then the softmax scale (in the exponent)
              if constexpr (G::kQuant) dot *= ksc[j];
              sc[j] = kok[j] && pos[j] < lim[r] ? dot : -INFINITY;
              mx = fmaxf(mx, sc[j]);
            }
#pragma unroll
            for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[r], mx * a.scale2);
            const float m_use = m_new == -INFINITY ? 0.f : m_new;
            const float corr = m_new == m[r] ? 1.f : ex2(m[r] - m_use);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              sc[j] = ex2(fmaf(sc[j], a.scale2, -m_use));  // masked: exactly 0
              sum += sc[j];
            }
#pragma unroll
            for (int o = LPK; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            l[r] = l[r] * corr + sum;
            m[r] = m_new;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              // l took p; the P.V product takes p * vs (v-scales folded into p)
              const float p = G::kQuant ? sc[j] * vsc[j] : sc[j];
              float vx[8];
              load8(vx, sv + (j * KPI + key_in) * D + feat);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e]);
            }
          }
        }
        __syncwarp();  // every lane is done with the slot before it is refilled
        if (i + kStages < n_mine) {
          t0s[s] = unit_t0(i + kStages);
          mbyte[s] = prefetch(t0s[s], s);
        }
      }
      hv::cp_async_commit();
    }
  }
  hv::cp_async_wait<0>();

  // a lane's output summed the keys of its lane group: sum the groups
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);

  // the warps' partials, merged in warp order
  __syncthreads();  // every warp is done with its ring: the pool is reused
  float* wm = reinterpret_cast<float*>(pool);  // [warp][kRows] m, then l
  float* wl = wm + kWarps * kRows;
  float* wacc = wl + kWarps * kRows;           // [warp][kRows][D]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nr) continue;
    if (lane == 0) {
      wm[warp * kRows + r] = m[r];
      wl[warp * kRows + r] = l[r];
    }
    if (lane < LPK) {
      float* dst = wacc + (warp * kRows + r) * D + feat;
      *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  const Partial<D> part(smem_raw);
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * kRows + r]);
    const float mu = mm == -INFINITY ? 0.f : mm;
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = ex2(wm[w * kRows + r] - mu);
      num += e * wacc[(w * kRows + r) * D + d];
      den += e * wl[w * kRows + r];
    }
    if (plan.n_split == 1) {
      const int row = r0 + r, g = row / a.tw, tq = row % a.tw;
      out[((size_t)(b * a.tw + tq) * a.H + kh * G_ + g) * D + d] =
          from_f32<T>(num / (den == 0.f ? 1.f : den));
    } else {
      part.acc[r * D + d] = num;
      if (d == 0) {
        part.m[r] = mm;
        part.l[r] = den;
      }
    }
  }
  if (plan.n_split > 1) merge_splits<T, D>(a, smem_raw, plan.n_split, b, kh, r0, nr);
}

template <typename T, typename C, int D>
cudaError_t launch_d(Args a, int B, cudaStream_t stream) {
  const int R = (a.H / a.K) * a.tw;
  const int n_rg = (R + kRows - 1) / kRows;
  constexpr size_t bytes = smem_bytes<C, D>();
  static_assert(bytes <= 232448, "one block's shared memory");
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T, C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  // the splits of a (row, kv head, row group): one cluster
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.K * n_rg, B, a.max_splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = a.max_splits;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, decode_attn_kernel<T, C, D>, a);
}

template <typename T, typename C>
cudaError_t launch(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, C, 16>(a, B, stream);
    case 32: return launch_d<T, C, 32>(a, B, stream);
    case 64: return launch_d<T, C, 64>(a, B, stream);
    case 128: return launch_d<T, C, 128>(a, B, stream);
    case 256: return launch_d<T, C, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_args(int nk, int block_k, int max_splits, int S) {
  return block_k <= 0 || block_k % kTile || max_splits <= 0 || max_splits > kMaxSplits ||
         nk != (S + block_k - 1) / block_k;
}

Args make_args(const void* q, const void* ck, const void* cv, const void* ks, const void* vs,
               const void* mask, const void* table, const void* counts, int dense_count,
               void* out, int tw, int H, int K, int S, int length, int nk, int block_k,
               int max_splits, float scale) {
  Args a;
  a.q = q;
  a.ck = ck;
  a.cv = cv;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.mask = static_cast<const uint8_t*>(mask);
  a.table = static_cast<const int*>(table);
  a.counts = static_cast<const int*>(counts);
  a.dense_count = dense_count;
  a.out = out;
  a.tw = tw;
  a.H = H;
  a.K = K;
  a.S = S;
  a.length = length;
  a.nk = nk;
  a.block_k = block_k;
  a.max_splits = max_splits;
  a.scale2 = scale * kLog2e;
  return a;
}

}  // namespace

// q, out: (B, tw, H, D); ck_layer, cv_layer: (B, S, K, D) views of one layer;
// mask: (B, S) bytes or null. All contiguous, of one dtype (bf16 or f32),
// 16-byte aligned; D in {16, 32, 64, 128, 256}. table (B, nk) int32 and
// counts (B,) int32: row b's listed blocks of block_k keys (a multiple of
// 32), nk = ceil(S / block_k). A row is cut into at most max_splits (1..8)
// splits, merged in the same launch. Returns cudaGetLastError().
extern "C" int hv_decode_attention_stacked(
    const void* q, const void* ck_layer, const void* cv_layer, const void* mask,
    const void* table, const void* counts, void* out, int is_bf16, int B, int tw, int H, int K,
    int D, int S, int length, int nk, int block_k, int max_splits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(nk, block_k, max_splits, S)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, ck_layer, cv_layer, nullptr, nullptr, mask, table, counts, 0,
                           out, tw, H, K, S, length, nk, block_k, max_splits, scale);
  if (is_bf16) return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, B, D, st);
  return (int)launch<float, float>(a, B, D, st);
}

// The same over an int8 cache: ck_layer, cv_layer (B, S, K, D) int8 and
// ks_layer, vs_layer (B, K, S) f32 scales, views of one layer; q and out
// bf16 or f32. Returns cudaGetLastError().
extern "C" int hv_decode_attention_stacked_q(
    const void* q, const void* ck_layer, const void* cv_layer, const void* ks_layer,
    const void* vs_layer, const void* mask, const void* table, const void* counts, void* out,
    int is_bf16, int B, int tw, int H, int K, int D, int S, int length, int nk, int block_k,
    int max_splits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(nk, block_k, max_splits, S)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, ck_layer, cv_layer, ks_layer, vs_layer, mask, table, counts, 0,
                           out, tw, H, K, S, length, nk, block_k, max_splits, scale);
  if (is_bf16) return (int)launch<__nv_bfloat16, int8_t>(a, B, D, st);
  return (int)launch<float, int8_t>(a, B, D, st);
}

// Kernel B12: q and out (B, H, D), k and v (B, S, K, D) one layer's cache, all
// contiguous and of one dtype (bf16 or f32); mask (B, S) bytes or null; the
// keys below `length` (1..S) are attended, in at most max_splits (1..8)
// splits. Returns cudaGetLastError().
extern "C" int hv_decode_attention(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int is_bf16, int B, int H,
                                   int K, int D, int S, int length, int max_splits,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_splits <= 0 || max_splits > kMaxSplits || length < 1 || length > S)
    return (int)cudaErrorInvalidValue;
  // the listed tiles are all those below `length`, 32 keys each
  const int tiles = (length + kTile - 1) / kTile;
  const int nk = (S + kTile - 1) / kTile;
  const Args a = make_args(q, k, v, nullptr, nullptr, mask, nullptr, nullptr, tiles, out, 1, H,
                           K, S, length, nk, kTile, max_splits, scale);
  if (is_bf16) return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, B, D, st);
  return (int)launch<float, float>(a, B, D, st);
}

extern "C" const char* hv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
