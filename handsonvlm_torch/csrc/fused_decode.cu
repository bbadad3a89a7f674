// A decode layer's whole MLP half over tiled int4 weights, for Hopper
// (sm_90a), on the body of csrc/gemv.cuh.
//
// Replaces handsonvlm_tpu/ops/fused_decode.py::_fused_mlp_kernel (:87),
// reached from the pallas_call at :159 (fused_mlp_stacked), which the JAX
// package keeps gated off (fused_mlp_ok, HANDSONVLM_FUSED_MLP=1) and wires
// into no decoder. For one layer and 1 <= B <= 8 rows of h (B, d):
//   xn  = bf16(h * rsqrt(mean(h^2) + eps) * nrm)           (f32 norm)
//   yg  = xn @ Wg, yu = xn @ Wu                             (f32 sums)
//   act = bf16(silu(yg) * yu)
//   out = h + act @ Wd                                      (f32, cast to h's dtype)
// with every int4 weight dequantized to bf16 as bf16(bf16(nibble - 8 or
// high nibble) * bf16(scale)) (the Pallas _dequant_tile) before its
// product, the products of bf16 values summed in f32. Wg and Wu are the
// tiled layout of ops.int8_matmul.tile_int4_stacked split by
// split_wgu_tiled into tiles of BNf columns (gate tile j pairs with up tile
// j), Wd the tiled w_down: byte (g, r, c) of tile j holds row r (low
// nibble, biased by +8) and row 64 + r (high nibble) of group g, column
// j*BN + c.
//
// Bound: bytes. At 7B a call reads 45.1 MB of gate and up bytes, 22.5 MB
// of down bytes and 4.2 MB of scales (71.8 MB, 0.021 ms at 3.35 TB/s); h,
// xn and act are a few hundred KB at most.
//
// Design: one call is two launches, fused_mlp_gate_up_kernel then
// fused_mlp_down_kernel, each built from the GEMV's parts (gemv.cuh: a block
// owns 128 output columns and one split of the contraction, the splits of a
// column block one cluster merged in split order through distributed
// shared memory, a TMA ring fed by a producer warp, consumer warps on
// mma.sync.m16n8k16 with the weight as A and up to 8 rows as B, rows past B
// zero). A block has eight consumer warps in two groups of four; both
// groups read every stage, warp w of a group the stages w, w + 4, ...
// - Gate / up: a stage holds one group (128 rows of d) of the block's 128
//   columns of both weights and their scales; the first group of warps
//   takes the gate products, the second the up products (six stages: with
//   four a warp had no stage queued behind the one it was reading). The
//   consumers first normalise the rows (each block reads h, a few KB to 128
//   KB, from L2) and write their split's xn into shared memory in the mma's
//   B-fragment order; the producer's TMA starts before the norm, which the
//   weights do not wait for. The merge applies silu(yg) * yu and writes act
//   (B, f) bf16 to a scratch.
// - Down: a stage is the GEMV's int4 stage (a group of w_down, act's two
//   [8][64] boxes, the scales); the groups take its first and its last four
//   k16 steps. The merge adds the residual h in f32.
// - The scale is folded into each weight before the product (Int4Dec's
//   mma_step<true>: one packed bf16 multiply of a register's two values,
//   rows r and r + 64 of one column, by that column's bf16 scale: exactly
//   bf16(bf16(q) * bf16(s))). Each group's (or half-group's) products are
//   summed on the tensor cores from zero and added to the warp's f32 sums,
//   so the sums are f32 over the whole contraction. f32 rows take the same
//   route: both versions round xn and act to bf16, so every product is bf16
//   x bf16; only the norm and the residual are f32.
// - The phase boundary: both kernels are programmatic dependent launches. A
//   block lets the next kernel of the stream start once its producer has
//   issued its last TMA and its consumers have read their last stage; the
//   down kernel's producer then primes its ring with the weight and scale
//   boxes of its first eight stages, and only its first TMA of act waits
//   (griddepcontrol.wait: the gate/up grid has completed and its writes are
//   visible, so act needs no flag). In a chain of layers the next gate/up
//   starts its weight stream the same way while a down kernel ends. Each
//   thread waits before it touches memory an earlier kernel may write or
//   read (h, act, out); the weights and scales are read before. A trigger
//   at the start of each block, which lets the next grid take the free SMs
//   at once, packed its blocks two to an SM and was slower.
// - Row i of a B-row call is bit-equal to the same row alone: the splits
//   come from the weights' shapes and the SM count alone (the caller's
//   fused_mlp_plan), a row's norm is summed in a fixed order by one warp,
//   mma's columns are independent, and the warps and then the splits add in
//   a fixed order; no atomics, the same bits on every call. One
//   instantiation serves B = 1..8 (mma's N = 8) for each dtype of h.
// What holds it back (an H100, chip_smoke.py's B11 lines): the products.
// Each weight costs four instructions to reach the tensor cores (a byte
// permute, a lop3, a packed subtract and the scale's packed multiply), one
// more than the GEMV's, and the gate/up kernel's 86 column blocks at 7B
// keep only 86 of the SMs busy; each kernel alone runs slower than its
// stream with the products skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "gemv.cuh"

namespace {

namespace cg = cooperative_groups;
using hv::kGvCols;
using hv::kGvRows;

constexpr int kHalf = 64;  // a group's packed rows (groups of 128, the JAX package's GROUP)
using Dec = hv::Int4Dec<kHalf>;
constexpr int kGroup = 2 * kHalf;
constexpr int kMaxRows = kGvRows;
constexpr int kMaxSplits = hv::kGvMaxSplits;
constexpr int kScales = 4 * kGvCols;  // a group's 128 f32 column scales
// eight consumer warps in two groups of four, each group reading every
// stage (warp w of a group takes the stages w, w + 4, ...), and a producer
// warp
constexpr int kWarps = 8;
constexpr int kGroups = 2;
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int kPartFloats = kGvRows * kGvCols;  // a warp's partial, [8][128] f32
constexpr int kVecs = kPartFloats / 4;

// gate / up: [gate bytes][up bytes][gate scales][up scales] a stage; group
// 0 takes its gate products, group 1 its up products
constexpr int kUpStages = 6;
constexpr int kUpStage = 2 * Dec::kW + 2 * kScales;
using UpRing = hv::GvRing<kUpStages, kUpStage, kGroups>;
// down: the GEMV's int4 stage, [bytes][act's two boxes][scales]; group q
// takes the k16 steps 4q .. 4q + 3
constexpr int kDownStages = 8;
using DownRing = hv::GvRing<kDownStages, Dec::kStage, kGroups>;
constexpr int kDownBytes = Dec::kW + 2 * hv::kGvXBox + kScales;

// a block's xn: [unit][k16 step][row < B][t] pairs of B fragments (b0, b1)
constexpr int kXnUnitRow = 8 * 4 * 8;  // bytes a group and row
// dynamic shared memory a block may ask for (the opt-in limit less 1 KB
// for the static part)
constexpr int kSmemCap = 227 * 1024 - 1024;
constexpr int kUpSmemFixed = UpRing::kSmem + 1024;  // + slack to align to 1024
constexpr int kDownSmem = DownRing::kSmem + 1024;

static_assert(kUpStage % 1024 == 0, "the up bytes start 1024-aligned");
static_assert(UpRing::kSmem >= kWarps * kPartFloats * 4, "the warps' partials fit the ring");
static_assert(DownRing::kSmem >= kWarps * kPartFloats * 4, "the partials fit the ring");
static_assert(kMaxRows <= kWarps, "a warp a row's norm");
static_assert(kWarps == 4 * kGroups && Dec::kSteps == 8, "the groups' shares of a stage");

struct MlpArgs {
  const void* h;    // (B, d) bf16 or f32
  const void* nrm;  // (d,) the layer's mlp_norm scale, bf16 or f32
  __nv_bfloat16* act;  // (B, f) scratch
  void* out;        // (B, d) in h's dtype
  int B, d, f, bnf, bnd;
  int cpt_f, cpt_d;  // column blocks a tile
  int gd, gf;        // groups of d and of f
  int per1, per2;    // groups a split of gate/up and of down
  int nrm_bf16;
  float eps;
};

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(hv::as_bf162(w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// The rows' norm and the block's xn, by the consumer warps: row b's sum of
// squares by warp b in a fixed order (lane l takes 8-value chunks l, l +
// 32, ...), then xn of the split's groups [u0, u0 + count) as B fragments:
// item (unit, k16 step s, row g) holds, for t = 0..3, (xn[g][k0 + 2t],
// xn[g][k0 + 64 + 2t]) and (xn[g][k0 + 2t + 1], xn[g][k0 + 65 + 2t]), k0 =
// the group's first row + 8s (the row order of Int4Dec::mma_step).
template <typename T>
__device__ __forceinline__ void norm_rows(const MlpArgs& a, uint4* xn, int u0, int count, int warp,
                                          int lane, float* rinv) {
  const T* h = static_cast<const T*>(a.h);
  const int d = a.d, B = a.B;
  if (warp < B) {
    float ss = 0.f;
#pragma unroll 8
    for (int c = lane; c < d / 8; c += 32) {
      float v[8];
      load8(h + (size_t)warp * d + 8 * c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rinv[warp] = rsqrtf(ss / (float)d + a.eps);
  }
  hv::named_bar_sync(1, 32 * kWarps);
  const int items = count * 8 * B;
#pragma unroll 2
  for (int i = warp * 32 + lane; i < items; i += 32 * kWarps) {
    const int g = i % B, s = (i / B) % 8, k0 = (u0 + i / (8 * B)) * kGroup + 8 * s;
    float xl[8], xh[8], nl[8], nh[8];
    load8(h + (size_t)g * d + k0, xl);
    load8(h + (size_t)g * d + k0 + kHalf, xh);
    if (a.nrm_bf16) {
      load8(static_cast<const __nv_bfloat16*>(a.nrm) + k0, nl);
      load8(static_cast<const __nv_bfloat16*>(a.nrm) + k0 + kHalf, nh);
    } else {
      load8(static_cast<const float*>(a.nrm) + k0, nl);
      load8(static_cast<const float*>(a.nrm) + k0 + kHalf, nh);
    }
    const float r = rinv[g];
    uint32_t f[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      f[2 * t] = hv::pack_bf16(xl[2 * t] * r * nl[2 * t], xh[2 * t] * r * nh[2 * t]);
      f[2 * t + 1] =
          hv::pack_bf16(xl[2 * t + 1] * r * nl[2 * t + 1], xh[2 * t + 1] * r * nh[2 * t + 1]);
    }
    xn[2 * i] = make_uint4(f[0], f[1], f[2], f[3]);
    xn[2 * i + 1] = make_uint4(f[4], f[5], f[6], f[7]);
  }
  hv::named_bar_sync(1, 32 * kWarps);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
}

// k16 steps kS0 .. kS0 + kN - 1 of one group's products of the weight at w
// (its 128 f32 column scales at sc) with x's B fragments b, each weight
// bf16(bf16(q) * bf16(s)), summed on the tensor cores from zero and then
// added to tot in f32, so the running sum over the contraction is kept by
// f32 adds (the tensor cores' own accumulation is not round-to-nearest)
template <int kS0, int kN>
__device__ __forceinline__ void group_products(float (&tot)[8][4], const unsigned char* w,
                                               const unsigned char* sc, const uint2 (&b)[kN],
                                               int g, int t) {
  uint32_t s2[16];  // columns 16g .. + 15: the bf16 scale in both halves
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(sc)[4 * g + k];
    s2[4 * k] = hv::pack_bf16(v.x, v.x), s2[4 * k + 1] = hv::pack_bf16(v.y, v.y);
    s2[4 * k + 2] = hv::pack_bf16(v.z, v.z), s2[4 * k + 3] = hv::pack_bf16(v.w, v.w);
  }
  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < kN; ++s) Dec::mma_step<true>(acc, w, s2, kS0 + s, b[s].x, b[s].y, g, t);
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[k][e] += acc[k][e];
}

// grid (splits, 1, column blocks of f), clusters of (splits, 1, 1)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_gate_up_kernel(const __grid_constant__ CUtensorMap tm_wg,
                             const __grid_constant__ CUtensorMap tm_sg,
                             const __grid_constant__ CUtensorMap tm_wu,
                             const __grid_constant__ CUtensorMap tm_su, const MlpArgs a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float rinv[kMaxRows];
  const UpRing ring(hv::smem_1024(smem_raw));
  uint4* xn = reinterpret_cast<uint4*>(ring.base + UpRing::kSmem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x, q = blockIdx.z;
  const int j = q / a.cpt_f, c0 = (q % a.cpt_f) * kGvCols;
  const int valid = min(kGvCols, a.bnf - c0);
  const int u0 = split * a.per1, count = min(a.gd, u0 + a.per1) - u0;
  const int B = a.B;

  ring.init();

  float* part = reinterpret_cast<float*>(ring.base);
  if (warp == kWarps) {
    // ---- producer: the weights need no earlier kernel, so no wait ----
    if (lane == 0)
      ring.produce(0, count, [&](unsigned char* st, uint64_t* bar, int i) {
        const int row = j * a.gd + u0 + i;  // the group's row of the [NB G][BN] scale view
        hv::mbar_arrive_expect_tx(bar, kUpStage);
        hv::tma_load_2d(st, &tm_wg, c0, row * kHalf, bar);
        hv::tma_load_2d(st + Dec::kW, &tm_wu, c0, row * kHalf, bar);
        hv::tma_load_2d(st + 2 * Dec::kW, &tm_sg, c0, row, bar);
        hv::tma_load_2d(st + 2 * Dec::kW + kScales, &tm_su, c0, row, bar);
      });
    __syncwarp();
    hv::griddep_launch_dependents();  // the stream's last TMA is issued
  } else {
    // ---- consumers: the norm (h may come from the kernel before), then
    // warps 0-3 (gate) and 4-7 (up) each take the stages w, w + 4, ...
    hv::griddep_wait();
    norm_rows<T>(a, xn, u0, count, warp, lane, rinv);
    const int g = lane >> 2, t = lane & 3, up = warp >> 2;
    float tot[8][4];
    zero(tot);
    ring.template consume<4>(warp & 3, lane, count, [&](const unsigned char* st, int i) {
      const uint2* xf = reinterpret_cast<const uint2*>(xn) + (size_t)i * 8 * B * 4 + g * 4 + t;
      uint2 b[Dec::kSteps];
#pragma unroll
      for (int s = 0; s < Dec::kSteps; ++s) b[s] = g < B ? xf[s * B * 4] : make_uint2(0u, 0u);
      group_products<0, Dec::kSteps>(tot, st + up * Dec::kW, st + 2 * Dec::kW + up * kScales, b,
                                     g, t);
    });
    hv::griddep_launch_dependents();
    // the warps' partials (gate: warps 0-3, up: 4-7), each four summed in
    // warp order into the first
    hv::named_bar_sync(1, 32 * kWarps);
    hv::store_mma_part(part + warp * kPartFloats, tot, g, t);
    hv::named_bar_sync(1, 32 * kWarps);
    hv::sum_warp_parts<4>(reinterpret_cast<float4*>(part) + up * 4 * kVecs, kVecs,
                          threadIdx.x & 127);
  }

  // ---- the splits merged in split order, act = bf16(silu(yg) * yu) ----
  __syncwarp();
  hv::griddep_wait();  // act may still be read by the kernel before (a reused scratch)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {
    const int splits = gridDim.x;
    const float4* mine = reinterpret_cast<const float4*>(part);
    const int col0 = j * a.bnf + c0;
    for (int v = split * kThreads + threadIdx.x; v < kVecs; v += splits * kThreads) {
      const int r = v / (kGvCols / 4), c = (v % (kGvCols / 4)) * 4;
      if (r >= B || c >= valid) continue;
      const float4 yg = hv::split_sum(cluster, mine + v, splits);
      const float4 yu = hv::split_sum(cluster, mine + 4 * kVecs + v, splits);
      const float x[4] = {yg.x, yg.y, yg.z, yg.w}, y[4] = {yu.x, yu.y, yu.z, yu.w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = x[e] / (1.f + expf(-x[e])) * y[e];
      *reinterpret_cast<uint2*>(a.act + (size_t)r * a.f + col0 + c) =
          make_uint2(hv::pack_bf16(o[0], o[1]), hv::pack_bf16(o[2], o[3]));
    }
  }
  cluster.sync();  // no partial is read any more
}

// grid (splits, 1, column blocks of d), clusters of (splits, 1, 1)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_down_kernel(const __grid_constant__ CUtensorMap tm_wd,
                          const __grid_constant__ CUtensorMap tm_sd,
                          const __grid_constant__ CUtensorMap tm_act, const MlpArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const DownRing ring(hv::smem_1024(smem_raw));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x, q = blockIdx.z;
  const int j = q / a.cpt_d, c0 = (q % a.cpt_d) * kGvCols;
  const int valid = min(kGvCols, a.bnd - c0);
  const int u0 = split * a.per2, count = min(a.gf, u0 + a.per2) - u0;

  ring.init();

  float* part = reinterpret_cast<float*>(ring.base);
  if (warp == kWarps) {
    // ---- producer: the first stages' weights before act exists ----
    if (lane == 0) {
      auto weights = [&](unsigned char* st, uint64_t* bar, int i) {
        const int row = j * a.gf + u0 + i;
        hv::mbar_arrive_expect_tx(bar, kDownBytes);  // act's boxes land later
        hv::tma_load_2d(st, &tm_wd, c0, row * kHalf, bar);
        hv::tma_load_2d(st + Dec::kS, &tm_sd, c0, row, bar);
      };
      auto acts = [&](unsigned char* st, uint64_t* bar, int i) {
        const int k = (u0 + i) * kGroup;
        hv::tma_load_2d(st + Dec::kW, &tm_act, k, 0, bar);
        hv::tma_load_2d(st + Dec::kW + hv::kGvXBox, &tm_act, k + kHalf, 0, bar);
      };
      const int primed = min(count, kDownStages);
      for (int i = 0; i < primed; ++i) weights(ring.stage(i), ring.bar(i), i);
      hv::griddep_wait();  // the gate/up grid has completed: act is written
      for (int i = 0; i < primed; ++i) acts(ring.stage(i), ring.bar(i), i);
      ring.produce(primed, count, [&](unsigned char* st, uint64_t* bar, int i) {
        weights(st, bar, i);
        acts(st, bar, i);
      });
    }
    __syncwarp();
    hv::griddep_launch_dependents();  // the next layer's gate/up may start its weights
  } else {
    // ---- consumers: group q (warps 4q .. 4q + 3) takes the k16 steps 4q ..
    // 4q + 3 of each stage
    const int g = lane >> 2, t = lane & 3, grp = warp >> 2;
    float tot[8][4];
    zero(tot);
    ring.template consume<4>(warp & 3, lane, count, [&](const unsigned char* st, int) {
      uint2 b[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) Dec::x_frags(st + Dec::kW, 4 * grp + s, g, t, b[s].x, b[s].y);
      if (grp)
        group_products<4, 4>(tot, st, st + Dec::kS, b, g, t);
      else
        group_products<0, 4>(tot, st, st + Dec::kS, b, g, t);
    });
    hv::griddep_launch_dependents();
    hv::named_bar_sync(1, 32 * kWarps);
    hv::store_mma_part(part + warp * kPartFloats, tot, g, t);
    hv::named_bar_sync(1, 32 * kWarps);
    hv::sum_warp_parts<kWarps>(reinterpret_cast<float4*>(part), kVecs, threadIdx.x);
  }

  // ---- the splits merged in split order, plus the residual ----
  __syncwarp();
  hv::griddep_wait();  // h and out: the kernels before have ended
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {
    const int splits = gridDim.x;
    const float4* mine = reinterpret_cast<const float4*>(part);
    const int col0 = j * a.bnd + c0;
    for (int v = split * kThreads + threadIdx.x; v < kVecs; v += splits * kThreads) {
      const int r = v / (kGvCols / 4), c = (v % (kGvCols / 4)) * 4;
      if (r >= a.B || c >= valid) continue;
      const float4 y = hv::split_sum(cluster, mine + v, splits);
      const size_t off = (size_t)r * a.d + col0 + c;
      if constexpr (std::is_same<T, float>::value) {
        const float4 h = *reinterpret_cast<const float4*>(static_cast<const float*>(a.h) + off);
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + off) =
            make_float4(y.x + h.x, y.y + h.y, y.z + h.z, y.w + h.w);
      } else {
        const uint2 hb =
            *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a.h) + off);
        const float2 h0 = __bfloat1622float2(hv::as_bf162(hb.x));
        const float2 h1 = __bfloat1622float2(hv::as_bf162(hb.y));
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + off) =
            make_uint2(hv::pack_bf16(y.x + h0.x, y.y + h0.y), hv::pack_bf16(y.z + h1.x, y.w + h1.y));
      }
    }
  }
  cluster.sync();  // no partial is read any more
}

// a programmatic dependent launch of grid (splits, 1, blocks), clusters of
// splits (a launch of single blocks when there is one split)
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int splits, int blocks, int smem, bool& configured,
                   cudaStream_t stream, const Args&... args) {
  cudaError_t err = hv::allow_smem(kernel, kSmemCap, configured);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, 1, blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = splits;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  config.attrs = attrs;
  config.numAttrs = splits > 1 ? 2 : 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mlp(const MlpArgs& a, const CUtensorMap* maps, int splits1, int splits2,
                       int parts, cudaStream_t stream) {
  static bool up_configured = false, down_configured = false;
  const int up_smem = kUpSmemFixed + a.per1 * kXnUnitRow * a.B;
  cudaError_t err = cudaSuccess;
  if (parts & 1)
    err = launch(fused_mlp_gate_up_kernel<T>, splits1, (a.f / a.bnf) * a.cpt_f, up_smem,
                 up_configured, stream, maps[0], maps[1], maps[2], maps[3], a);
  if (err != cudaSuccess || !(parts & 2)) return err;
  return launch(fused_mlp_down_kernel<T>, splits2, (a.d / a.bnd) * a.cpt_d, kDownSmem,
                down_configured, stream, maps[4], maps[5], maps[6], a);
}

bool covers(int units, int splits, int per) {
  return splits >= 1 && splits <= kMaxSplits && per >= 1 && (long long)(splits - 1) * per < units &&
         (long long)splits * per >= units;
}

bool misaligned(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 != 0; }

}  // namespace

// h (B, d) bf16 (h_bf16 = 1) or f32 and out (B, d) of the same dtype,
// contiguous; nrm (d,) bf16 (nrm_bf16 = 1) or f32; wg / wu (NBf, d/128, 64,
// BNf) int8 and sg / su (NBf, d/128, BNf) f32; wd (NBd, f/128, 64, BNd) int8
// and sd (NBd, f/128, BNd) f32: views of one layer; act a (B, f) bf16
// scratch; every pointer 16-byte aligned. 1 <= B <= 8; d and f multiples of
// 128; BNf and BNd multiples of 64 dividing f and d. Split s of the splits1
// (splits2) of gate/up (down), 1..8 (one cluster), covers groups [s*per1,
// (s+1)*per1) of d ([s*per2, ...) of f); B x per1 groups of xn fit a
// block's shared memory. Two launches (gate/up, then down as a programmatic
// dependent); returns the first CUDA error (0 on success).
extern "C" int hv_fused_mlp(const void* h, const void* nrm, const void* wg, const void* sg,
                            const void* wu, const void* su, const void* wd, const void* sd,
                            void* act, void* out, int h_bf16, int nrm_bf16, int B, int d, int f,
                            int BNf, int BNd, int splits1, int per1, int splits2, int per2,
                            float eps, int parts, void* stream) {
  if (B < 1 || B > kMaxRows || d < kGroup || d % kGroup || f < kGroup || f % kGroup || BNf < 64 ||
      BNf % 64 || f % BNf || BNd < 64 || BNd % 64 || d % BNd ||
      !covers(d / kGroup, splits1, per1) || !covers(f / kGroup, splits2, per2) ||
      kUpSmemFixed + (long long)per1 * kXnUnitRow * B > kSmemCap)
    return (int)cudaErrorInvalidValue;
  if (misaligned(h) || misaligned(nrm) || misaligned(wg) || misaligned(sg) || misaligned(wu) ||
      misaligned(su) || misaligned(wd) || misaligned(sd) || misaligned(act) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;
  MlpArgs a = {};
  a.h = h;
  a.nrm = nrm;
  a.act = static_cast<__nv_bfloat16*>(act);
  a.out = out;
  a.B = B, a.d = d, a.f = f, a.bnf = BNf, a.bnd = BNd;
  a.cpt_f = (BNf + kGvCols - 1) / kGvCols;
  a.cpt_d = (BNd + kGvCols - 1) / kGvCols;
  a.gd = d / kGroup, a.gf = f / kGroup;
  a.per1 = per1, a.per2 = per2;
  a.nrm_bf16 = nrm_bf16;
  a.eps = eps;
  // the tiled bytes as [NB G 64][BN] and the scales as [NB G][BN]; act (B, f)
  const int nbf = f / BNf, nbd = d / BNd;
  CUtensorMap maps[7];
  if (!hv::gemv_w_map(&maps[0], wg, (uint64_t)nbf * a.gd * kHalf, BNf, kHalf) ||
      !hv::gemv_s_map(&maps[1], sg, (uint64_t)nbf * a.gd, BNf) ||
      !hv::gemv_w_map(&maps[2], wu, (uint64_t)nbf * a.gd * kHalf, BNf, kHalf) ||
      !hv::gemv_s_map(&maps[3], su, (uint64_t)nbf * a.gd, BNf) ||
      !hv::gemv_w_map(&maps[4], wd, (uint64_t)nbd * a.gf * kHalf, BNd, kHalf) ||
      !hv::gemv_s_map(&maps[5], sd, (uint64_t)nbd * a.gf, BNd) ||
      !hv::gemv_x_map(&maps[6], act, B, f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(h_bf16 ? launch_mlp<__nv_bfloat16>(a, maps, splits1, splits2, parts, st)
                      : launch_mlp<float>(a, maps, splits1, splits2, parts, st));
}
