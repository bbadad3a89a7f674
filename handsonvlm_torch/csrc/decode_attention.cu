// Decode attention over one layer of the stacked KV cache, for Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/decode_attention.py::_decode_stacked_kernel in
// both of its modes: the bf16/f32 cache (quant=False, reached through
// decode_attention_stacked: kernel B1) and the int8 cache with per-(token,
// kv head) f32 scales (quant=True, reached through
// decode_attention_stacked_q: kernel B6). One kernel body, templated on the
// cache's element type, serves both entry points, and a third: kernel B12,
// which replaces handsonvlm_tpu/ops/decode_attention.py::_decode_kernel
// (reached through decode_attention): one query row per head over one
// layer's (B, S, K, D) cache with a scalar `length` and a (B, S) key mask,
// no per-row block table. There the body sweeps every 32-key tile below
// `length` in order (table == nullptr: the listed tiles are 0, 1, 2, ...),
// skips a tile with no valid key after reading its 32 mask bytes, zeroes
// masked probabilities (a fully masked tile adds nothing, as the Pallas
// kernel's explicit zeroing) and cuts the key range into splits merged in
// f32, so that one query over 4k keys still fills the card. B12's bound
// is B1's: the bytes of the keys and values below `length` (2 * length *
// K * D * sizeof(element); 4096 keys at K = 32, D = 128 in bf16: 67 MB,
// 20 us at 3.35 TB/s).
// It computes the same thing, not the same blocks: a query window of T <= 8
// rows (T = 1 for plain decode, T > 1 for a speculative verify window)
// attends over positions [0, length) of one layer of the (L, B, S, K, D)
// cache with grouped-query heads, a (B, S) key mask, the per-row causal
// limit pos < length - (T-1) + tq, an fp32 online softmax, masked
// probabilities zeroed explicitly and l == 0 -> output 0 (a row with no
// valid key gives zeros, not NaN or the block mean).
//
// The sweep: as the Pallas kernel, each row walks a compacted list of its
// cache blocks (block_k keys each, a multiple of 32): table[b, :counts[b]]
// are the blocks with a valid key below `length`, in order (the wrapper
// builds the list once per forward). Blocks with no valid key are never
// read. A thread block per (kv head, batch row, split) carries all
// groups x T query rows of that head (row r = g*T + tq, as the Pallas
// kernel lays them out) and sweeps its split in tiles of 32 keys. Splits
// are cut over the ordinal of the listed tiles, not over positions, and
// sized from the row's own count (read on the device, so the host needs
// no sync): serving compaction
// (ops/cache_ops) deletes empty blocks and shifts the rest by whole
// blocks, so every split sees the same tiles in the same order and a
// live row's output is bit-equal across it. Tiles with no valid key under
// the mask are skipped after reading 32 mask bytes. Scores use one warp
// per key (lanes split D); the softmax uses one warp per row (one lane per
// key); the P.V update gives each thread (row, d) pairs against a V tile
// staged in shared memory as fp32. Each split writes its fp32 (m, l, acc)
// to a scratch buffer, and a second kernel merges the splits in order
// (rescaling by exp(m_s - max m), l == 0 -> output 0). The caller passes a
// pointer to the layer (ck[layer_idx] is a free view in torch), so no copy
// of the cache is made.
//
// Over the int8 cache the dequantization is exact and needs no transpose,
// as in the Pallas kernel: each score is scaled by its key's k-scale
// ((q . k8) * ks == q . (k8 * ks)) and each probability, after it has been
// added to l, by its key's v-scale before the P.V product
// ((p * vs) . v8 == p . (v8 * vs)). The scales are (B, K, S) per layer,
// contiguous in S: a tile's 32 scales are one 128-byte read.
//
// Bound: memory. Each call reads 2 * (listed keys) * K * D * sizeof(cache
// type) bytes of cache (B = 1, K = 32, D = 128, ~450 keys at the 7B chat
// decode shape: ~7.4 MB per layer in bf16, 2.2 us at 3.35 TB/s; 3.8 MB
// with the int8 cache and its scales, 1.1 us). One block per (kv head,
// row) alone gives a grid of 32 blocks at B = 1, each walking ~14 tiles in
// series; the splits make the grid cover every SM about twice.
// cp.async/TMA staging of K and V, and 16-byte loads of the int8 rows (a
// lane reads one byte per element here), are the later work toward the
// bandwidth bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // keys per tile: one key per lane in the softmax
constexpr int kMaxDPerLane = 8;  // D <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// Dynamic shared memory, in this order: q[R*D], acc[R*D], v[kTile*D],
// s[R*kTile] (scores, then probabilities), m[R], l[R], corr[R] as floats,
// then ok[R*kTile] bytes.
size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (2 * (size_t)rows * d + (size_t)kTile * d +
                          (size_t)rows * kTile + 3 * (size_t)rows) +
         (size_t)rows * kTile;
}

// The split plan of one row, identical in both kernels: the row's listed
// tiles, count * (block_k / 32), cut into at most max_splits splits of
// split_tiles each; n_split of them are used (1 when the row is empty). It
// depends on nothing but the row's own count, so another row's list (a
// finished request's plane, emptied by compaction) never regroups it.
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

// T: the type of q and the output; C: the cache's (T, or int8_t with
// scales ks/vs, else nullptr)
template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const T* __restrict__ q,         // (B, tw, H, D)
                       const C* __restrict__ ck,        // (B, S, K, D), one layer
                       const C* __restrict__ cv,        // (B, S, K, D)
                       const float* __restrict__ ks,    // (B, K, S), one layer
                       const float* __restrict__ vs,    // (B, K, S)
                       const uint8_t* __restrict__ mask,  // (B, S) or nullptr
                       const int* __restrict__ table,   // (B, nk) listed blocks
                       const int* __restrict__ counts,  // (B,)
                       int dense_count,  // table == nullptr: blocks 0..dense_count-1
                       float* __restrict__ part_acc,  // (B, K, max_splits, R, D)
                       float* __restrict__ part_ml,   // (B, K, max_splits, 2, R)
                       int tw, int H, int K, int D, int S, int length, int nk,
                       int block_k, float scale) {
  constexpr bool kQuant = std::is_same<C, int8_t>::value;
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tiles_per_block = block_k / kTile;
  const int count = table ? counts[b] : dense_count;
  const SplitPlan plan = split_plan(count, tiles_per_block, gridDim.z);
  if (split >= plan.n_split) return;  // uniform over the block
  const int G = H / K;
  const int R = G * tw;
  float* sq = smem;
  float* sacc = sq + R * D;
  float* sv = sacc + R * D;
  float* ss = sv + kTile * D;
  float* sm = ss + R * kTile;
  float* sl = sm + R;
  float* scorr = sl + R;
  uint8_t* sok = reinterpret_cast<uint8_t*>(scorr + R);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D, g = r / tw, tq = r % tw;
    sq[i] = to_f32(q[((size_t)(b * tw + tq) * H + kh * G + g) * D + d]);
    sacc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
  }
  __syncthreads();

  const size_t pos_stride = (size_t)K * D;
  const C* kbase = ck + (size_t)b * S * pos_stride + (size_t)kh * D;
  const C* vbase = cv + (size_t)b * S * pos_stride + (size_t)kh * D;
  const float* ksrow = kQuant ? ks + ((size_t)b * K + kh) * S : nullptr;
  const float* vsrow = kQuant ? vs + ((size_t)b * K + kh) * S : nullptr;
  const uint8_t* mrow = mask ? mask + (size_t)b * S : nullptr;
  const int* trow = table ? table + (size_t)b * nk : nullptr;
  // this split's listed tiles of row b, and the end of the valid positions
  const int c0 = split * plan.split_tiles;
  const int c1 = min(count * tiles_per_block, c0 + plan.split_tiles);
  const int end = min(length, S);

  for (int c = c0; c < c1; ++c) {
    const int blk = trow ? trow[c / tiles_per_block] : c / tiles_per_block;
    const int t0 = blk * block_k + (c % tiles_per_block) * kTile;
    bool any = false;
    if (tid < kTile) {
      const int p = t0 + tid;
      any = p < end && (mrow == nullptr || mrow[p]);
    }
    if (!__syncthreads_or(any)) continue;  // no valid key in this tile

    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D, d = i % D, p = t0 + j;
      sv[i] = p < end ? to_f32(vbase[p * pos_stride + d]) : 0.f;
    }

    // scores: one warp per key, lanes split D; the key stays in registers
    // across the R query rows
    for (int j = warp; j < kTile; j += kWarps) {
      const int p = t0 + j;
      const bool key_ok = p < end && (mrow == nullptr || mrow[p]);
      float kr[kMaxDPerLane];
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        kr[i] = (key_ok && d < D) ? to_f32(kbase[p * pos_stride + d]) : 0.f;
      }
      const float kscale = kQuant && key_ok ? ksrow[p] : 1.f;
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) part += sq[r * D + d] * kr[i];
        }
        // int8: (q . k8) * ks, then the softmax scale, the Pallas order
        const float s = kQuant ? warp_sum(part) * kscale * scale : warp_sum(part) * scale;
        const int tq = r % tw;
        const bool ok = key_ok && p < length - (tw - 1) + tq;
        if (lane == 0) {
          ss[r * kTile + j] = ok ? s : kNegInf;
          sok[r * kTile + j] = ok;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row, lane j holds key j of the tile
    const int pos = t0 + lane;
    const float vscale = kQuant && pos < end ? vsrow[pos] : 1.f;
    for (int r = warp; r < R; r += kWarps) {
      const float s = ss[r * kTile + lane];
      const bool ok = sok[r * kTile + lane];
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      // masked probabilities are zeroed explicitly: a row whose keys are all
      // masked so far has s == m_new == NEG_INF and would otherwise get 1
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      // l takes p; the P.V product takes p * vs (v-scales folded into p)
      ss[r * kTile + lane] = kQuant ? p * vscale : p;
      if (lane == 0) {
        sm[r] = m_new;
        sl[r] = sl[r] * corr + psum;
        scorr[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = ss + r * kTile;
      float a = sacc[i] * scorr[r];
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) a += pr[j] * sv[j * D + d];
      sacc[i] = a;
    }
    __syncthreads();
  }

  const size_t part = ((size_t)b * K + kh) * gridDim.z + split;
  for (int i = tid; i < R * D; i += kThreads) part_acc[part * R * D + i] = sacc[i];
  for (int r = tid; r < R; r += kThreads) {
    part_ml[(part * 2) * R + r] = sm[r];
    part_ml[(part * 2 + 1) * R + r] = sl[r];
  }
}

// Merge the splits of one (kv head, batch row) in order: out = sum_s e_s
// acc_s / sum_s e_s l_s with e_s = exp(m_s - max_s m_s); a row with no
// valid key (every l_s == 0) gives 0. The split plan is recomputed from the
// counts, as the attention kernel computed it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml,
                             const int* __restrict__ counts,  // or nullptr:
                             int dense_count,                 // every row's count
                             T* __restrict__ out,  // (B, tw, H, D)
                             int max_splits, int tiles_per_block, int tw, int H,
                             int K, int D) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int R = G * tw;
  const int n_split =
      split_plan(counts ? counts[b] : dense_count, tiles_per_block, max_splits).n_split;
  const size_t first = ((size_t)b * K + kh) * max_splits;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D, g = r / tw, tq = r % tw;
    float m_max = kNegInf;
    for (int s = 0; s < n_split; ++s)
      m_max = fmaxf(m_max, part_ml[((first + s) * 2) * R + r]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float e = expf(part_ml[((first + s) * 2) * R + r] - m_max);
      num += e * part_acc[(first + s) * R * D + i];
      den += e * part_ml[((first + s) * 2 + 1) * R + r];
    }
    out[((size_t)(b * tw + tq) * H + kh * G + g) * D + d] =
        from_f32<T>(num / (den == 0.f ? 1.f : den));
  }
}

template <typename T, typename C>
cudaError_t launch(const void* q, const void* ck, const void* cv, const void* ks,
                   const void* vs, const void* mask, const void* table,
                   const void* counts, int dense_count, void* out, void* part_acc,
                   void* part_ml, int B, int tw, int H, int K, int D, int S, int length,
                   int nk, int block_k, int max_splits, float scale, cudaStream_t stream) {
  const int rows = (H / K) * tw;
  const size_t bytes = smem_bytes(rows, D);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  decode_attn_kernel<T, C><<<dim3(K, B, max_splits), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(ck),
      static_cast<const C*>(cv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(table), static_cast<const int*>(counts), dense_count,
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), tw, H, K, D, S,
      length, nk, block_k, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_merge_kernel<T><<<dim3(K, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(counts), dense_count, static_cast<T*>(out), max_splits,
      block_k / kTile, tw, H, K, D);
  return cudaGetLastError();
}

bool bad_args(int nk, int block_k, int max_splits, int S) {
  return block_k <= 0 || block_k % kTile || max_splits <= 0 ||
         nk != (S + block_k - 1) / block_k;
}

}  // namespace

// Shared memory the kernel needs for `rows` = (H / K) * T query rows of
// head size `d`; the wrapper checks it against the card's per-block limit.
extern "C" size_t hv_decode_attention_smem_bytes(int rows, int d) {
  return smem_bytes(rows, d);
}

// q, out: (B, tw, H, D); ck_layer, cv_layer: (B, S, K, D) views of one layer;
// mask: (B, S) bytes or null. All contiguous, of one dtype (bf16 or f32).
// table (B, nk) int32 and counts (B,) int32: row b's listed blocks of
// block_k keys (a multiple of 32), nk = ceil(S / block_k). part_acc
// (B, K, max_splits, R, D) and part_ml (B, K, max_splits, 2, R) are fp32
// scratch, R = (H / K) * tw. Returns cudaGetLastError().
extern "C" int hv_decode_attention_stacked(
    const void* q, const void* ck_layer, const void* cv_layer, const void* mask,
    const void* table, const void* counts, void* out, void* part_acc, void* part_ml,
    int is_bf16, int B, int tw, int H, int K, int D, int S, int length, int nk,
    int block_k, int max_splits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(nk, block_k, max_splits, S)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, ck_layer, cv_layer, nullptr, nullptr, mask, table, counts, 0, out, part_acc,
        part_ml, B, tw, H, K, D, S, length, nk, block_k, max_splits, scale, st);
  return (int)launch<float, float>(q, ck_layer, cv_layer, nullptr, nullptr, mask,
                                   table, counts, 0, out, part_acc, part_ml, B, tw,
                                   H, K, D, S, length, nk, block_k, max_splits,
                                   scale, st);
}

// The same over an int8 cache: ck_layer, cv_layer (B, S, K, D) int8 and
// ks_layer, vs_layer (B, K, S) f32 scales, views of one layer; q and out
// bf16 or f32. Returns cudaGetLastError().
extern "C" int hv_decode_attention_stacked_q(
    const void* q, const void* ck_layer, const void* cv_layer, const void* ks_layer,
    const void* vs_layer, const void* mask, const void* table, const void* counts,
    void* out, void* part_acc, void* part_ml, int is_bf16, int B, int tw, int H, int K,
    int D, int S, int length, int nk, int block_k, int max_splits, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(nk, block_k, max_splits, S)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16, int8_t>(
        q, ck_layer, cv_layer, ks_layer, vs_layer, mask, table, counts, 0, out, part_acc,
        part_ml, B, tw, H, K, D, S, length, nk, block_k, max_splits, scale, st);
  return (int)launch<float, int8_t>(q, ck_layer, cv_layer, ks_layer, vs_layer, mask,
                                    table, counts, 0, out, part_acc, part_ml, B, tw,
                                    H, K, D, S, length, nk, block_k, max_splits,
                                    scale, st);
}

// Kernel B12: q and out (B, H, D), k and v (B, S, K, D) one layer's cache, all
// contiguous and of one dtype (bf16 or f32); mask (B, S) bytes or null; the
// keys below `length` (1..S) are attended. part_acc (B, K, max_splits, R, D)
// and part_ml (B, K, max_splits, 2, R) are fp32 scratch, R = H / K. Returns
// cudaGetLastError().
extern "C" int hv_decode_attention(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* part_acc,
                                   void* part_ml, int is_bf16, int B, int H, int K, int D,
                                   int S, int length, int max_splits, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_splits <= 0 || length < 1 || length > S) return (int)cudaErrorInvalidValue;
  // the listed tiles are all those below `length`, 32 keys each
  const int tiles = (length + kTile - 1) / kTile;
  const int nk = (S + kTile - 1) / kTile;
  if (is_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, mask, nullptr, nullptr, tiles, out, part_acc, part_ml,
        B, 1, H, K, D, S, length, nk, kTile, max_splits, scale, st);
  return (int)launch<float, float>(q, k, v, nullptr, nullptr, mask, nullptr, nullptr,
                                   tiles, out, part_acc, part_ml, B, 1, H, K, D, S,
                                   length, nk, kTile, max_splits, scale, st);
}

extern "C" const char* hv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
