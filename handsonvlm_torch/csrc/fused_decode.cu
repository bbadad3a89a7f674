// A decode layer's whole MLP half in one launch, over tiled int4 weights, for
// Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/fused_decode.py::fused_mlp_stacked (the
// _fused_mlp_kernel pallas_call), which the JAX package keeps gated off
// (fused_mlp_ok, HANDSONVLM_FUSED_MLP=1) and wires into no decoder. For one
// layer and B <= 8 rows of h (B, d):
//   xn  = bf16(h * rsqrt(mean(h^2) + eps) * nrm)           (f32 norm)
//   yg  = xn @ Wg, yu = xn @ Wu                             (f32 sums)
//   act = bf16(silu(yg) * yu)
//   out = h + act @ Wd                                      (f32, cast to h's dtype)
// with every int4 weight dequantized to bf16 as bf16(bf16(nibble - 8 or
// high nibble) * bf16(scale)) (the Pallas _dequant_tile), products of bf16
// values summed in f32. Wg and Wu are the tiled layout of
// ops.int8_matmul.tile_int4_stacked split by split_wgu_tiled into tiles of
// BNf columns (256 at 7B: 43 tiles of f = 11008), Wd the tiled w_down (16
// tiles of BNd = 256 at 7B): byte (g, r, c) of tile j holds row r (low
// nibble, biased by +8) and row 64 + r (high nibble) of group g, column
// j*BN + c.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), the grid
// sized from the occupancy query so every block is resident, and one grid
// barrier. Every block first normalises the rows itself into shared memory
// (B x d bf16, rows past B as 0). Phase 1: blocks walk units of 64 columns
// of f; a unit's 256 threads are 16 column quads (4 columns, one 32-bit
// load of gate and of up bytes per weight row) by 16 lanes of the
// contraction (lane l takes groups l, l + 16, ...), sum gate and up for
// every row in registers, reduce the lanes in order through shared memory
// and write act for the unit's columns to a small global scratch (8 x f
// bf16). Then the barrier. Phase 2: every block copies act into shared
// memory (B x f bf16, 172 KB at B = 8) and blocks walk units of 64 columns
// of d the same way over Wd, adding the residual. The row count is a
// template parameter (1, 2, 4 or 8), so a single row does one row's FMAs.
//
// Bound: memory. At 7B a call reads 45.1 MB of gate and up bytes, 22.5 MB
// of down bytes and 4.2 MB of scales (71.8 MB, 0.021 ms at 3.35 TB/s); the
// activations are a few hundred KB. The Pallas kernel's sequential grid and
// phase-by-phase DMA have no counterpart here: blocks run their units in
// parallel. Later work: more units in flight per SM (phase 1 fills 172
// units, phase 2 only 64), wider loads, and fusing it into the decode step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 16;   // column quads of a unit
constexpr int kLanes = 16;   // lanes of the contraction
constexpr int kUnit = 64;    // columns per unit
constexpr int kGroup = 128;  // int4 contraction group (the JAX package's GROUP)
constexpr int kHalf = kGroup / 2;
constexpr int kMaxRows = 8;

struct Params {
  const void* h;        // (B, d) bf16 or f32
  const float* nrm;     // (d,) the layer's mlp_norm scale, f32
  const int8_t* wg;     // (NBf, Gd, 64, BNf): one layer
  const float* sg;      // (NBf, Gd, BNf)
  const int8_t* wu;
  const float* su;
  const int8_t* wd;     // (NBd, Gf, 64, BNd)
  const float* sd;      // (NBd, Gf, BNd)
  __nv_bfloat16* act;   // (8, f) scratch
  void* out;            // (B, d) in h's dtype
  int B, d, f, BNf, BNd;
  float eps;
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One unit's products: acc[b][e] += sum over the lane's groups and the 128
// rows of each of x[b][row] * bf16(q * s) for column quad*4 + e of the tile
// at `w` (G, 64, BN) / `s` (G, BN), column offset cc. x rows are `ld` apart.
template <int R>
__device__ __forceinline__ void unit_products(const int8_t* __restrict__ w,
                                              const float* __restrict__ s, int G, int BN,
                                              int cc, int lane, const __nv_bfloat16* x,
                                              int ld, float (&acc)[R][4]) {
  for (int g = lane; g < G; g += kLanes) {
    const int8_t* wp = w + (size_t)g * kHalf * BN + cc;
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(s + (size_t)g * BN + cc));
    const float sv[4] = {bf16_round(s4.x), bf16_round(s4.y), bf16_round(s4.z),
                         bf16_round(s4.w)};
    const __nv_bfloat16* xg = x + g * kGroup;
#pragma unroll 4
    for (int r = 0; r < kHalf; ++r) {
      const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)r * BN));
      float xlo[R], xhi[R];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        xlo[b] = __bfloat162float(xg[b * ld + r]);
        xhi[b] = __bfloat162float(xg[b * ld + kHalf + r]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int byte = (int)(int8_t)(uint8_t)(word >> (8 * e));
        // bf16(nibble) and bf16(s) are exact in f32, and so is their
        // product: one rounding gives the bf16 product
        const float wlo = bf16_round((float)((byte & 15) - 8) * sv[e]);
        const float whi = bf16_round((float)(byte >> 4) * sv[e]);
#pragma unroll
        for (int b = 0; b < R; ++b) {
          acc[b][e] = fmaf(xlo[b], wlo, acc[b][e]);
          acc[b][e] = fmaf(xhi[b], whi, acc[b][e]);
        }
      }
    }
  }
}

// Sum the 16 lanes' partials of one unit, in lane order: element t of this
// thread (index tid + t * kThreads of the R x 64 unit) into y[t].
template <int R>
__device__ __forceinline__ void reduce_lanes(float* red, const float (&acc)[R][4], int quad,
                                             int lane,
                                             float (&y)[(R * kUnit + kThreads - 1) / kThreads]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(lane * R + b) * kUnit + quad * 4 + e] = acc[b][e];
  __syncthreads();
#pragma unroll
  for (int t = 0; t < (R * kUnit + kThreads - 1) / kThreads; ++t) {
    const int i = tid + t * kThreads;
    float sum = 0.f;
    if (i < R * kUnit)
      for (int l = 0; l < kLanes; ++l) sum += red[l * R * kUnit + i];
    y[t] = sum;
  }
  __syncthreads();
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPer = (R * kUnit + kThreads - 1) / kThreads;
  __shared__ float rinv[R];
  const int tid = threadIdx.x;
  const int quad = tid % kQuads, lane = tid / kQuads;
  const int d = p.d, f = p.f;
  const int big = d > f ? d : f;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);               // [R][d], then [R][f]
  float* red = reinterpret_cast<float*>(smem + (size_t)R * big * 2);        // [kLanes][R][kUnit]
  const T* h = static_cast<const T*>(p.h);
  T* out = static_cast<T*>(p.out);

  // the norm of every row, in each block
  const int warp = tid / 32, wl = tid % 32;
  for (int b = warp; b < R; b += kThreads / 32) {
    float ss = 0.f;
    if (b < p.B)
      for (int k = wl; k < d; k += 32) {
        const float v = to_f32(h[(size_t)b * d + k]);
        ss = fmaf(v, v, ss);
      }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (wl == 0) rinv[b] = rsqrtf(ss / (float)d + p.eps);
  }
  __syncthreads();
  for (int i = tid; i < R * d; i += kThreads) {
    const int b = i / d, k = i % d;
    float v = 0.f;
    if (b < p.B) v = to_f32(h[(size_t)b * d + k]) * rinv[b] * p.nrm[k];
    xs[i] = __float2bfloat16(v);
  }
  __syncthreads();

  // phase 1: gate and up over units of 64 columns of f, act to the scratch
  const int Gd = d / kGroup, Gf = f / kGroup;
  for (int u = blockIdx.x; u < f / kUnit; u += gridDim.x) {
    const int c0 = u * kUnit, j = c0 / p.BNf, cc = c0 % p.BNf + quad * 4;
    const size_t tile_w = (size_t)j * Gd * kHalf * p.BNf, tile_s = (size_t)j * Gd * p.BNf;
    float ag[R][4], au[R][4];
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) ag[b][e] = au[b][e] = 0.f;
    unit_products<R>(p.wg + tile_w, p.sg + tile_s, Gd, p.BNf, cc, lane, xs, d, ag);
    unit_products<R>(p.wu + tile_w, p.su + tile_s, Gd, p.BNf, cc, lane, xs, d, au);
    float yg[kPer], yu[kPer];
    reduce_lanes<R>(red, ag, quad, lane, yg);
    reduce_lanes<R>(red, au, quad, lane, yu);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * kThreads;
      if (i < R * kUnit) {
        const float gv = yg[t];
        const float a = gv * (1.f / (1.f + expf(-gv))) * yu[t];
        p.act[(size_t)(i / kUnit) * f + c0 + i % kUnit] = __float2bfloat16(a);
      }
    }
  }

  cg::this_grid().sync();

  // phase 2: act into shared memory (written by other blocks: read through
  // L2), then down over units of 64 columns of d, plus the residual
  for (int i = tid; i < R * f / 8; i += kThreads)
    reinterpret_cast<uint4*>(xs)[i] = __ldcg(reinterpret_cast<const uint4*>(p.act) + i);
  __syncthreads();
  for (int u = blockIdx.x; u < d / kUnit; u += gridDim.x) {
    const int c0 = u * kUnit, j = c0 / p.BNd, cc = c0 % p.BNd + quad * 4;
    float ad[R][4];
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) ad[b][e] = 0.f;
    unit_products<R>(p.wd + (size_t)j * Gf * kHalf * p.BNd, p.sd + (size_t)j * Gf * p.BNd, Gf,
                     p.BNd, cc, lane, xs, f, ad);
    float y[kPer];
    reduce_lanes<R>(red, ad, quad, lane, y);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * kThreads;
      const int b = i / kUnit, col = c0 + i % kUnit;
      if (i < R * kUnit && b < p.B)
        out[(size_t)b * d + col] = from_f32<T>(y[t] + to_f32(h[(size_t)b * d + col]));
    }
  }
}

template <typename T, int R>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = fused_mlp_kernel<T, R>;
  const size_t smem =
      (size_t)R * (p.d > p.f ? p.d : p.f) * 2 + (size_t)kLanes * R * kUnit * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int units = (p.f > p.d ? p.f : p.d) / kUnit;
  const int grid = per_sm * sms < units ? per_sm * sms : units;
  Params args_p = p;
  void* args[] = {&args_p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  if (p.B == 1) return launch<T, 1>(p, stream);
  if (p.B == 2) return launch<T, 2>(p, stream);
  if (p.B <= 4) return launch<T, 4>(p, stream);
  return launch<T, 8>(p, stream);
}

bool misaligned(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 != 0; }

}  // namespace

// h (B, d) bf16 (h_bf16 = 1) or f32 and out (B, d) of the same dtype,
// contiguous; nrm (d,) f32; wg / wu (NBf, d/128, 64, BNf) int8 and sg / su
// (NBf, d/128, BNf) f32; wd (NBd, f/128, 64, BNd) int8 and sd (NBd, f/128,
// BNd) f32: views of one layer, 16-byte aligned; act an (8, f) bf16
// scratch. 1 <= B <= 8; d and f multiples of 128; BNf and BNd multiples of
// 64 dividing f and d. Returns the launch's CUDA error (0 on success).
extern "C" int hv_fused_mlp(const void* h, const void* nrm, const void* wg, const void* sg,
                            const void* wu, const void* su, const void* wd, const void* sd,
                            void* act, void* out, int h_bf16, int B, int d, int f, int BNf,
                            int BNd, float eps, void* stream) {
  if (B < 1 || B > kMaxRows || d < kGroup || d % kGroup || f < kGroup || f % kGroup ||
      BNf < kUnit || BNf % kUnit || f % BNf || BNd < kUnit || BNd % kUnit || d % BNd)
    return (int)cudaErrorInvalidValue;
  if (misaligned(wg) || misaligned(sg) || misaligned(wu) || misaligned(su) || misaligned(wd) ||
      misaligned(sd) || misaligned(act))
    return (int)cudaErrorMisalignedAddress;
  Params p{h,
           static_cast<const float*>(nrm),
           static_cast<const int8_t*>(wg),
           static_cast<const float*>(sg),
           static_cast<const int8_t*>(wu),
           static_cast<const float*>(su),
           static_cast<const int8_t*>(wd),
           static_cast<const float*>(sd),
           static_cast<__nv_bfloat16*>(act),
           out,
           B, d, f, BNf, BNd, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(h_bf16 ? launch_rows<__nv_bfloat16>(p, st) : launch_rows<float>(p, st));
}
