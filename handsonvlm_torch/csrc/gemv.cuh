// The weight-only GEMV of the quantized decoders, for Hopper (sm_90a): y =
// x @ W for a few rows of x over an int4 (csrc/int4_gemv.cu: B4a, B4b,
// B4c) or an int8 (csrc/int8_matmul.cu: B9 below its tensor-core rows)
// weight, one launch a call. The two instantiate this body with their
// decoder (Int4Dec over the tiled or the flat address map, Int8Dec);
// csrc/fused_decode.cu (B11) builds its two kernels from the body's parts
// (the ring, Int4Dec's steps with the scale folded into each weight, the
// warps' partials and the cluster's merge).
//
// Bound: bytes. At 7B decode (m = 1) the four fused int4 projections of a
// layer read 107.4 MB (0.0321 ms at 3.35 TB/s), the seven int8 ones 202.6
// MB (0.0605 ms); x and y are a few KB. The design, for what held the
// earlier kernels at 26-41% of that:
// - One launch a call. A block owns 128 output columns, up to 8 rows of x
//   and one split of the contraction; the splits of a column block (at
//   most 8) are one thread block cluster. Each block's f32 partial waits
//   in its shared memory, and after a cluster barrier the blocks each add
//   a share of the outputs over the splits in split order from their
//   peers' shared memory, scale (int8: the column scale), cast and store:
//   no merge kernel, no scratch in device memory, no atomics, the same bits
//   on every call.
// - Bytes in flight: a producer warp keeps an eight-stage ring of
//   shared memory full by TMA, an mbarrier a stage for its bytes and one
//   for its release. A stage is one contraction unit of the block's 128
//   columns (int4: one group, g/2 packed rows, with its 128 column scales;
//   int8: 64 rows), a [rows][128] byte box with the 128-byte swizzle: up to
//   88 KB in flight a block, two blocks an SM at most. Four consumer warps
//   take the stages round-robin. The caller's plan (gemv_split) gives a
//   projection the fewest splits that make 5/8 of the SMs' worth of blocks:
//   on an H100 a block streams best alone on its SM, and every extra block
//   pays a pipeline fill and its share of the merge (deeper rings, eight
//   consumer warps and more splits were each slower at the 7B shapes).
// - A window's rows on one weight read: a block applies each weight it
//   holds to up to 8 rows of x (mma.sync's N), so a verify window (5 rows)
//   or a slot batch (8) streams the weight once; more rows are more row
//   tiles of the grid, next to each other in launch order, so a weight
//   slab read for one row tile is found in L2 by the next.
// - A bf16 x runs its products on the tensor cores: mma.sync.m16n8k16 with
//   the weight as A (16 columns x 16 rows of d) and x's rows as B (N = 8,
//   rows past m zero: TMA fills them). The k16 step's order of rows is
//   free (x's B fragments follow it), so a register pairs the two values
//   the packed bytes keep together: int4, a byte's low nibble (row r of the
//   group) with its high nibble (row r + g/2), made bf16 in three
//   instructions (a byte permute, one lop3 into the mantissa of 128 with
//   the high nibble's sign bit flipped, a packed subtract of 136: exact for
//   -8..7); int8, the same column's bytes of rows 2t and 2t + 1 (a permute,
//   int8_pair). A thread reads 16 columns of two (int4) or four (int8) rows
//   with 16-byte shared loads a k16 step, conflict-free under the swizzle,
//   and feeds eight products. int4: each group's products accumulate in
//   f32 and its f32 scale applies as the group closes, as the Pallas
//   kernel does; int8: the column scale applies once, to the merged sum.
// - An f32 x runs exact f32 FMAs on the same ring (a lane, 4 columns and
//   every row of the tile): the tensor cores' f32 accumulation would round
//   its products' sums more coarsely (int8_matmul.cu's header); f32 inputs
//   serve the references.
// What holds it back (an H100, chip_smoke.py's B4b and B9 lines): a call
// pays a launch and a pipeline fill (a few us) that a 7B decode's 8-45 MB
// projections do not amortise, and the consumers' decode and products are
// not wholly hidden behind the stream (the last stages and the merge run
// after the last bytes arrive): the four fused int4 projections reach about
// half the bytes' bound, and so do the seven int8 ones.
// Row i of an m-row call is bit-equal to the same row alone: the splits
// come from the weight's shape and the SM count alone (the caller's
// gemv_split), each warp takes the same stages in the same order whatever
// m, the warps and then the splits add in a fixed order, and a row's
// products and sums never mix with another row's (mma's columns are
// independent). The flat and the tiled int4 layout of one weight give the
// same bits: the same column blocks (128 columns of one BN tile), splits
// and arithmetic, only the addresses differ.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "mma.cuh"
#include "weight_gemm.cuh"

namespace hv {
namespace {  // each source that includes this keeps its own instantiations

constexpr int kGvCols = 128;                   // output columns a block
constexpr int kGvRows = 8;                     // rows of x a block (mma's N)
constexpr int kGvWarps = 4;                    // consumer warps
constexpr int kGvThreads = 32 * (kGvWarps + 1);  // and a producer warp (one lane loads)
constexpr int kGvStages = 8;                   // the ring
constexpr int kGvMaxSplits = 8;                // splits of a column block: one cluster
constexpr int kGvXBox = kGvRows * 64 * 2;      // a [8][64] bf16 box of x: 1 KB

struct GemvArgs {
  const void* x;       // (m, d), bf16 or f32
  const float* scale;  // int8: (n,) column scales
  void* out;           // (m, n_out)
  int m, d, n_out;
  int units;           // contraction units: int4 groups, int8 64-row stages
  int per;             // units a split (split s: [s * per, (s + 1) * per))
  int bn;              // int4: the tile width BN; int8: n
  int cpt;             // column blocks a tile (int8: every block in one "tile")
  int G;               // int4: groups
  int flat;            // int4: the flat address map
};

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte e of w and of h = w >> 4 as a bf16 pair: (w's low nibble, stored
// biased by +8) in the low half, (its high nibble, two's complement) in
// the high half: 128 + (value + 8) in a mantissa of 128, less 136
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t h, int e) {
  const uint32_t p = __byte_perm(w, h, (uint32_t)(e | (e << 4) | ((4 + e) << 8) | ((4 + e) << 12)));
  uint32_t v;
  // (p & 0x000F000F) ^ 0x00080000 | 0x43004300 in one lop3: b ? a ^ c : c
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(v) : "r"(p), "r"(0x000F000Fu), "r"(0x43084300u));
  return as_u32(__hsub2(as_bf162(v), as_bf162(0x43084308u)));
}

// byte i of w holding u in its low 4 bits (the high 4 zero) as u - 8 in
// f32: u in the low mantissa bits of 2^23, less 2^23 + 8
__device__ __forceinline__ float nibble_f32(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | i)) - 8388616.0f;
}

// byte i of w ^ 0x80808080 (b + 128) as the int8 b in f32
__device__ __forceinline__ float byte_f32(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | i)) - 8388736.0f;
}

// ---------------------------------------------------------------------------
// Decoders: a stage's layout, its loads, and its products
// ---------------------------------------------------------------------------

// int4, groups of 2 * HALF rows: a stage is one group of the block's 128
// columns, [HALF][128] packed bytes, then (bf16 x) x's boxes at the group's
// d and d + HALF (the low and the high nibbles' rows), then the group's 128
// f32 scales. Tiled map: byte (g, r, c) of tile j at row (j G + g) HALF +
// r, column c of a [NB G HALF][BN] view; flat: row g HALF + r, column j BN
// + c of [G HALF][n].
template <int HALF>
struct Int4Dec {
  static constexpr int kSteps = HALF / 8;  // k16 steps a group
  static constexpr int kW = HALF * 128;
  static constexpr int kS = kW + 2 * kGvXBox;
  static constexpr int kStage = (kS + 4 * kGvCols + 1023) / 1024 * 1024;
  static constexpr bool kGroupScale = true;

  template <bool kBf16>
  __device__ static void load(unsigned char* st, uint64_t* bar, const CUtensorMap* tw,
                              const CUtensorMap* ts, const CUtensorMap* tx, const GemvArgs& a,
                              int j, int c0, int u, int row0) {
    mbar_arrive_expect_tx(bar, kW + 4 * kGvCols + (kBf16 ? 2 * kGvXBox : 0));
    const int col = a.flat ? j * a.bn + c0 : c0;
    const int grow = a.flat ? u : j * a.G + u;
    tma_load_2d(st, tw, col, grow * HALF, bar);
    tma_load_2d(st + kS, ts, col, grow, bar);
    if constexpr (kBf16) {
      tma_load_2d(st + kW, tx, u * 2 * HALF, row0, bar);
      tma_load_2d(st + kW + kGvXBox, tx, u * 2 * HALF + HALF, row0, bar);
    }
  }

  // one k16 step s of a group's products for thread (g, t) of a warp:
  // acc[T] the 16 x 8 tile T = 2k + e, A rows g and g + 8 = columns 16g +
  // 2T and + 1, (b0, b1) x's B fragments of the step. kFold: each weight
  // is bf16(bf16(q) * bf16(s)), its column's scale folded in before the
  // product (s2[c]: column 16g + c's bf16 scale in both halves; a
  // register's two values are rows r and r + HALF of one column, so one
  // packed multiply rounds both once); else the bare q, scaled later.
  template <bool kFold>
  __device__ static void mma_step(float (&acc)[8][4], const unsigned char* w, const uint32_t* s2,
                                  int s, uint32_t b0, uint32_t b1, int g, int t) {
    const int r0 = 8 * s + 2 * t;  // rows r0 (slot t) and r0 + 1 (slot t + 4)
    const uint4 w0 = lds128(w + r0 * 128 + ((g ^ (2 * t)) << 4));
    const uint4 w1 = lds128(w + (r0 + 1) * 128 + ((g ^ (2 * t + 1)) << 4));
    const uint32_t u0[4] = {w0.x, w0.y, w0.z, w0.w}, u1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t h0 = u0[k] >> 4, h1 = u1[k] >> 4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t af[4] = {nibble_pair(u0[k], h0, 2 * e), nibble_pair(u0[k], h0, 2 * e + 1),
                          nibble_pair(u1[k], h1, 2 * e), nibble_pair(u1[k], h1, 2 * e + 1)};
        if constexpr (kFold) {
          const int c = 4 * k + 2 * e;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            af[i] = as_u32(__hmul2(as_bf162(af[i]), as_bf162(s2[c + (i & 1)])));
        }
        mma_bf16(acc[2 * k + e], af, b0, b1);
      }
    }
  }

  // x's B fragments of k16 step s from the stage's two [8][64] boxes at xb
  // (the group's rows d0 .. + HALF - 1 and d0 + HALF ..): (x[g][d0 + r0],
  // x[g][d0 + HALF + r0]) and (x[g][d0 + r0 + 1], x[g][d0 + HALF + r0 + 1])
  __device__ static void x_frags(const unsigned char* xb, int s, int g, int t, uint32_t& b0,
                                 uint32_t& b1) {
    const int xo = g * 128 + ((s ^ g) << 4) + 4 * t;
    const uint32_t xl = lds32(xb + xo), xh = lds32(xb + kGvXBox + xo);
    b0 = __byte_perm(xl, xh, 0x5410);
    b1 = __byte_perm(xl, xh, 0x7632);
  }

  // one group's products on the tensor cores, x from the stage's boxes
  __device__ static void mma_stage(float (&acc)[8][4], const unsigned char* st, int g, int t) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t b0, b1;
      x_frags(st + kW, s, g, t, b0, b1);
      mma_step<false>(acc, st, nullptr, s, b0, b1, g, t);
    }
  }

  // one group's f32 products for a lane's 4 columns and the tile's rows
  __device__ static void fma_stage(float (&acc)[kGvRows][4], const unsigned char* st,
                                   const float* xr, int d, int mt, int u, int lane) {
    const float* xg = xr + (size_t)u * 2 * HALF;
#pragma unroll 4
    for (int r = 0; r < HALF; ++r) {
      const uint32_t w = lds32(st + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + 4 * (lane & 3));
      const uint32_t lo = w & 0x0F0F0F0Fu;
      const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // two's complement + 8
      float vl[4], vh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        vl[e] = nibble_f32(lo, e);
        vh[e] = nibble_f32(hi, e);
      }
#pragma unroll
      for (int row = 0; row < kGvRows; ++row) {
        if (row >= mt) break;
        const float xl = __ldg(xg + (size_t)row * d + r);
        const float xh = __ldg(xg + (size_t)row * d + HALF + r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[row][e] = fmaf(xl, vl[e], acc[row][e]);
          acc[row][e] = fmaf(xh, vh[e], acc[row][e]);
        }
      }
    }
  }
};

// int8, 64 rows of d a stage: [64][128] bytes, then (bf16 x) x's [8][64]
// box at the stage's rows. Rows past d arrive as zeros.
struct Int8Dec {
  static constexpr int kSteps = 4;
  static constexpr int kW = 64 * 128;
  static constexpr int kS = kW;  // no scale box
  static constexpr int kStage = kW + kGvXBox;
  static constexpr bool kGroupScale = false;

  template <bool kBf16>
  __device__ static void load(unsigned char* st, uint64_t* bar, const CUtensorMap* tw,
                              const CUtensorMap*, const CUtensorMap* tx, const GemvArgs&, int,
                              int c0, int u, int row0) {
    mbar_arrive_expect_tx(bar, kW + (kBf16 ? kGvXBox : 0));
    tma_load_2d(st, tw, c0, u * 64, bar);
    if constexpr (kBf16) tma_load_2d(st + kW, tx, u * 64, row0, bar);
  }

  __device__ static void mma_stage(float (&acc)[8][4], const unsigned char* st, int g, int t) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int r0 = 16 * s + 2 * t;  // rows r0, r0 + 1 (slot t), r0 + 8, r0 + 9 (slot t + 4)
      uint4 q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + (i & 1) + 8 * (i >> 1);
        q[i] = lds128(st + r * 128 + ((g ^ (r & 7)) << 4));
      }
      const uint32_t b0 = lds32(st + kW + g * 128 + (((2 * s) ^ g) << 4) + 4 * t);
      const uint32_t b1 = lds32(st + kW + g * 128 + (((2 * s + 1) ^ g) << 4) + 4 * t);
      const uint32_t v[4][4] = {{q[0].x, q[0].y, q[0].z, q[0].w}, {q[1].x, q[1].y, q[1].z, q[1].w},
                                {q[2].x, q[2].y, q[2].z, q[2].w}, {q[3].x, q[3].y, q[3].z, q[3].w}};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // byte 2e of the word: column 16g + 2T, byte 2e + 1: column + 1
          const uint32_t lo = (uint32_t)(2 * e) | ((uint32_t)(4 + 2 * e) << 8);
          const uint32_t hi = lo + 0x0101u;
          const uint32_t af[4] = {int8_pair(__byte_perm(v[0][k], v[1][k], lo)),
                                  int8_pair(__byte_perm(v[0][k], v[1][k], hi)),
                                  int8_pair(__byte_perm(v[2][k], v[3][k], lo)),
                                  int8_pair(__byte_perm(v[2][k], v[3][k], hi))};
          mma_bf16(acc[2 * k + e], af, b0, b1);
        }
    }
  }

  __device__ static void fma_stage(float (&acc)[kGvRows][4], const unsigned char* st,
                                   const float* xr, int d, int mt, int u, int lane) {
    const int d0 = u * 64;
#pragma unroll 4
    for (int r = 0; r < 64; ++r) {
      if (d0 + r >= d) break;
      const uint32_t w =
          lds32(st + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + 4 * (lane & 3)) ^ 0x80808080u;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = byte_f32(w, e);
#pragma unroll
      for (int row = 0; row < kGvRows; ++row) {
        if (row >= mt) break;
        const float xv = __ldg(xr + (size_t)row * d + d0 + r);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[row][e] = fmaf(xv, v[e], acc[row][e]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The body's parts: the ring, the warps' partials, the cluster's merge
// ---------------------------------------------------------------------------

// A ring of kStages stages of kBytes in shared memory (1024-byte aligned),
// an mbarrier a stage for its bytes ("full": the producer's arrival and
// the TMA bytes) and one for its release ("empty": the consuming warp's).
// Unit i of a block's contraction goes through stage i % kStages; a stage
// is released once kReaders warps have read it.
template <int kStages, int kBytes, int kReaders = 1>
struct GvRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;

  static constexpr int kSmem = kStages * kBytes + 2 * kStages * 8;

  __device__ explicit GvRing(unsigned char* smem)
      : base(smem),
        full(reinterpret_cast<uint64_t*>(smem + kStages * kBytes)),
        empty(reinterpret_cast<uint64_t*>(smem + kStages * kBytes) + kStages) {}

  // by thread 0, then a block barrier
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kReaders);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }

  __device__ __forceinline__ unsigned char* stage(int i) const { return base + (i % kStages) * kBytes; }
  __device__ __forceinline__ uint64_t* bar(int i) const { return &full[i % kStages]; }

  // the producer (one thread): load(stage, full barrier, i) for units
  // first .. count - 1, each once its stage is released
  template <typename Load>
  __device__ __forceinline__ void produce(int first, int count, Load&& load) const {
    for (int i = first; i < count; ++i) {
      mbar_wait(&empty[i % kStages], ((i / kStages) & 1) ^ 1);
      load(stage(i), bar(i), i);
    }
  }

  // consumer warp `warp` of kWarps (of each group of readers): use(stage, i)
  // for units warp, warp + kWarps, ..., releasing each stage after it. Every read of the stage is
  // done before its release: a read still in flight (its value wanted only
  // after the arrive) could see the next TMA write (generic reads, then an
  // async-proxy write).
  template <int kWarps, typename Use>
  __device__ __forceinline__ void consume(int warp, int lane, int count, Use&& use) const {
    for (int i = warp; i < count; i += kWarps) {
      mbar_wait(bar(i), (i / kStages) & 1);
      use(static_cast<const unsigned char*>(stage(i)), i);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % kStages]);
    }
  }
};

// a warp's mma-layout sums (tile T = 2k + e: columns 16g + 2T, + 1; rows
// 2t, 2t + 1) into part, [kGvRows][kGvCols] f32
__device__ __forceinline__ void store_mma_part(float* part, const float (&tot)[8][4], int g,
                                               int t) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int col = 16 * g + 2 * k;
    *reinterpret_cast<float2*>(part + (2 * t) * kGvCols + col) = make_float2(tot[k][0], tot[k][2]);
    *reinterpret_cast<float2*>(part + (2 * t + 1) * kGvCols + col) =
        make_float2(tot[k][1], tot[k][3]);
  }
}

// the warps' partials p4[w * vecs + v] summed in warp order into p4[v],
// by the kWarps * 32 consumer threads (thread index tid)
template <int kWarps>
__device__ __forceinline__ void sum_warp_parts(float4* p4, int vecs, int tid) {
  for (int v = tid; v < vecs; v += 32 * kWarps) {
    float4 s = p4[v];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 b = p4[w * vecs + v];
      s.x += b.x, s.y += b.y, s.z += b.z, s.w += b.w;
    }
    p4[v] = s;
  }
}

// the sum over the cluster's blocks (the splits of a column block), in
// rank order, of the float4 at p in each block's shared memory
__device__ __forceinline__ float4 split_sum(cooperative_groups::cluster_group& cluster,
                                            const float4* p, int splits) {
  float4 s = *cluster.map_shared_rank(p, 0);
  for (int r = 1; r < splits; ++r) {
    const float4 b = *cluster.map_shared_rank(p, r);
    s.x += b.x, s.y += b.y, s.z += b.z, s.w += b.w;
  }
  return s;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename Dec>
constexpr int gemv_smem() {
  return GvRing<kGvStages, Dec::kStage>::kSmem + 1024;  // + slack to align to 1024
}

// grid (splits, row tiles, column blocks), clusters of (splits, 1, 1).
// T: x's type (bf16: the tensor cores; f32: FMAs); To: out's.
template <typename Dec, typename T, typename To>
__global__ void __launch_bounds__(kGvThreads, 2)
    gemv_kernel(const __grid_constant__ CUtensorMap tm_w,  // the weight's bytes
                const __grid_constant__ CUtensorMap tm_s,  // int4: the group scales
                const __grid_constant__ CUtensorMap tm_x,  // bf16 x (m, d)
                const GemvArgs a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(kGvStages * Dec::kStage >= kGvWarps * kGvRows * kGvCols * 4,
                "the warps' partials fit the ring");
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  const GvRing<kGvStages, Dec::kStage> ring(smem_1024(smem_raw));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x, rt = blockIdx.y, q = blockIdx.z;
  const int j = q / a.cpt, c0 = (q % a.cpt) * kGvCols;
  const int valid = min(kGvCols, a.bn - c0);  // columns of the block in its tile
  const int row0 = rt * kGvRows, mt = min(kGvRows, a.m - row0);
  const int u0 = split * a.per, count = min(a.units, u0 + a.per) - u0;

  ring.init();

  if (warp == kGvWarps) {
    // ---- producer ----
    if (lane == 0)
      ring.produce(0, count, [&](unsigned char* st, uint64_t* bar, int i) {
        Dec::template load<kBf16>(st, bar, &tm_w, &tm_s, &tm_x, a, j, c0, u0 + i, row0);
      });
  } else {
    // ---- consumers: warp w takes the stages w, w + 4, ... ----
    float tot[8][4];  // bf16: tile T (mma layout); f32: row r, the lane's 4 columns
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][e] = 0.f;
    const int g = lane >> 2, t = lane & 3;
    const float* xr = nullptr;
    if constexpr (!kBf16) xr = static_cast<const float*>(a.x) + (size_t)row0 * a.d;
    ring.template consume<kGvWarps>(warp, lane, count, [&](const unsigned char* st, int i) {
      if constexpr (Dec::kGroupScale) {
        float acc[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
        if constexpr (kBf16)
          Dec::mma_stage(acc, st, g, t);
        else
          Dec::fma_stage(acc, st, xr, a.d, mt, u0 + i, lane);
        // the group's f32 scales: bf16, columns 16g .. + 15; f32, 4 lane .. + 3
        const float* sc = reinterpret_cast<const float*>(st + Dec::kS);
        if constexpr (kBf16) {
          float s[16];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 v = reinterpret_cast<const float4*>(sc + 16 * g)[k];
            s[4 * k] = v.x, s[4 * k + 1] = v.y, s[4 * k + 2] = v.z, s[4 * k + 3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            tot[k][0] = fmaf(s[2 * k], acc[k][0], tot[k][0]);
            tot[k][1] = fmaf(s[2 * k], acc[k][1], tot[k][1]);
            tot[k][2] = fmaf(s[2 * k + 1], acc[k][2], tot[k][2]);
            tot[k][3] = fmaf(s[2 * k + 1], acc[k][3], tot[k][3]);
          }
        } else {
          const float4 v = reinterpret_cast<const float4*>(sc)[lane];
          const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) tot[r][e] = fmaf(s[e], acc[r][e], tot[r][e]);
        }
      } else if constexpr (kBf16) {  // int8: one f32 sum over every stage
        Dec::mma_stage(tot, st, g, t);
      } else {
        Dec::fma_stage(tot, st, xr, a.d, mt, u0 + i, lane);
      }
    });
    // every stage is consumed: the ring holds the warps' partials, [8][128]
    // f32 each, then their sum in warp order over warp 0's
    named_bar_sync(1, 32 * kGvWarps);
    float* part = reinterpret_cast<float*>(ring.base) + warp * kGvRows * kGvCols;
    if constexpr (kBf16) {
      store_mma_part(part, tot, g, t);
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        *reinterpret_cast<float4*>(part + r * kGvCols + 4 * lane) =
            make_float4(tot[r][0], tot[r][1], tot[r][2], tot[r][3]);
    }
    named_bar_sync(1, 32 * kGvWarps);
    sum_warp_parts<kGvWarps>(reinterpret_cast<float4*>(ring.base), kGvRows * kGvCols / 4,
                             threadIdx.x);
  }

  // ---- the splits of the column block: one cluster, merged in split order
  __syncwarp();  // the producer's lane 0 rejoins its warp
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in place
  {
    const int splits = gridDim.x;
    const float4* mine = reinterpret_cast<const float4*>(ring.base);
    const int col0 = j * a.bn + c0;  // the block's first output column
    for (int v = split * kGvThreads + threadIdx.x; v < kGvRows * kGvCols / 4;
         v += splits * kGvThreads) {
      const int r = v / (kGvCols / 4), c = (v % (kGvCols / 4)) * 4;
      if (r >= mt || c >= valid) continue;  // BN and n are multiples of 16
      float4 s = split_sum(cluster, mine + v, splits);
      if (!Dec::kGroupScale) {
        const float4 cs = *reinterpret_cast<const float4*>(a.scale + col0 + c);
        s.x *= cs.x, s.y *= cs.y, s.z *= cs.z, s.w *= cs.w;
      }
      const size_t off = (size_t)(row0 + r) * a.n_out + col0 + c;
      if constexpr (std::is_same<To, float>::value)
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + off) = s;
      else
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + off) =
            make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    }
  }
  cluster.sync();  // no partial is read any more
}

// One launch: grid (splits, row tiles, column blocks), a cluster per
// column block and row tile (a block alone when there is one split).
template <typename Dec, typename T, typename To>
cudaError_t launch_gemv(const CUtensorMap& tm_w, const CUtensorMap& tm_s,
                        const CUtensorMap& tm_x, const GemvArgs& a, int splits, int blocks,
                        cudaStream_t stream) {
  constexpr int kSmem = gemv_smem<Dec>();
  static bool configured = false;
  cudaError_t err = allow_smem(gemv_kernel<Dec, T, To>, kSmem, configured);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (a.m + kGvRows - 1) / kGvRows, blocks);
  config.blockDim = dim3(kGvThreads);
  config.dynamicSmemBytes = kSmem;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  // one split: a launch of single blocks (each its own cluster), which
  // starts sooner than a cluster launch
  config.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, gemv_kernel<Dec, T, To>, tm_w, tm_s, tm_x, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// x (m, d) bf16 as TMA boxes of [8 rows][64 values], 128-byte swizzle; rows
// past m arrive as zeros
inline bool gemv_x_map(CUtensorMap* map, const void* x, int m, int d) {
  const uint64_t dims[2] = {(uint64_t)d, (uint64_t)m}, strides[1] = {(uint64_t)d * 2};
  const uint32_t box[2] = {64, kGvRows};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// a [rows][cols] byte matrix as [box_rows][128] boxes, 128-byte swizzle
inline bool gemv_w_map(CUtensorMap* map, const void* w, uint64_t rows, uint64_t cols,
                       int box_rows) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols};
  const uint32_t box[2] = {kGvCols, (uint32_t)box_rows};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// a [rows][cols] f32 matrix as [1][128] boxes
inline bool gemv_s_map(CUtensorMap* map, const void* s, uint64_t rows, uint64_t cols) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {cols * 4};
  const uint32_t box[2] = {kGvCols, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, s, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace
}  // namespace hv
