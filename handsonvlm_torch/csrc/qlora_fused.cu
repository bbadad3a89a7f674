// The fused QLoRA matmuls over an int8 base with a LoRA epilogue, for
// Hopper (sm_90a), on the tensor cores: the forward and the input gradient
// of every projection of the int8_fused train step.
//
// Replaces two pallas_calls of handsonvlm_tpu/ops/qlora_fused.py:
// _fwd_call (B10a, kernels _fwd_kernel and _fwd_lora_kernel) and _bwd_call
// (B10b, kernels _bwd_kernel and _bwd_lora_kernel). The numerics are the
// Pallas kernels':
// - forward: o = bf16(x) @ bf16(W8[l]) with f32 sums, times the column
//   scale s[l] in f32 once, plus (with an adapter) u_s @ b in f32, where
//   u_s = (bf16(x) @ bf16(a)) * ls is computed outside; one cast to bf16.
//   bf16(int8) is exact, so the base product is exact up to f32 summation;
// - backward: dx = bf16(g) @ (bf16(W8[l]) * bf16(s[l]))^T, the scale folded
//   into the bf16 dequantization (n is the contraction here), f32 sums,
//   plus (with an adapter) v_s @ a^T in f32, v_s = (bf16(g) @ bf16(b)^T) *
//   ls computed outside; one cast to bf16.
// The adapter term enters the f32 output tile before the single rounding,
// so the full-width delta never exists in device memory.
//
// The tile bodies are the port's own: the forward is B9's tensor-core tile
// (csrc/int8_matmul.cu: a 64 x 64 output tile, four warps of 32 x 32 WMMA
// bf16 16x16x16 fragments, d walked in 64-row steps, the int8 weight staged
// as exact bf16, the column scale on the f32 sums); the backward is B7's
// transposed operand (csrc/int4_transpose.cu: a 64 x 64 tile of dx, n
// walked in chunks, each chunk of W's rows dequantized to bf16 with the
// scale folded in and read by the fragments as the column-major B operand,
// which is W^T). The epilogue stages the f32 tile in shared memory and adds
// the low-rank term with f32 FMAs: the rank is walked in chunks of 32, each
// chunk's (64, 32) slice of u_s (v_s) and (32, 64) slice of b (a^T) staged,
// each thread summing one column over 32 rows. The TPU-only parts do not
// carry over: no rank padding to 128 (any r, r = 0 without an adapter), no
// VMEM block picking, no scalar-prefetched layer select (the caller passes
// the layer's views). Ragged edges are masked: rows past m, weight rows past
// d and columns past n.
//
// Bound: operations at training sizes. At m = 2048 a 7B layer's seven
// projections are 829 GFLOP of base products (0.84 ms at 989 TFLOP/s bf16),
// and at r = 128 the forward epilogue adds 22 GFLOP and the backward's 19
// GFLOP of f32 products (0.33 / 0.28 ms at the card's 67 TFLOP/s outside
// the tensor cores, which this first version uses). The bytes (202 MB of
// int8 weights and the activations) bound it below 0.16 ms. Later work
// toward the bound: cp.async / TMA staging that overlaps the products,
// wgmma, wider tiles that reuse each weight tile for more rows, the
// epilogue on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // four warps in a 2 x 2 arrangement
constexpr int kBM = 64;        // rows of m per block
constexpr int kBN = 64;        // output columns per block (n forward, d backward)
constexpr int kBK = 64;        // contraction per step (d forward, up to 64 of n backward)
constexpr int kLdA = kBK + 8;  // bf16 per staged row of x / g
constexpr int kLdB = kBN + 8;  // bf16 per staged row of the weight tile
constexpr int kLdC = kBN + 4;  // f32 per staged output row
constexpr int kRk = 32;        // rank per epilogue chunk
constexpr int kSmemA = kBM * kLdA * 2;
constexpr int kSmemB = kBK * kLdB * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmemTile = (kSmemA + kSmemB) > kSmemC ? (kSmemA + kSmemB) : kSmemC;
constexpr int kLdR = kBN + 1;  // f32 per staged row of b / a^T (no bank conflicts)
constexpr int kSmemLora = (kBM * kRk + kRk * kLdR) * 4;
constexpr int kSmemBytes = kSmemTile + kSmemLora;
constexpr int kRowsPerThread = kBM * kBN / kThreads;  // 32: one column, every other row

// Byte i of w (an int8 b) as a float: w ^ 0x80808080 holds b + 128 in byte
// i; placed in the low mantissa bits of 2^23, minus 2^23 + 128, gives b.
__device__ __forceinline__ float byte_f32(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | i)) - 8388736.0f;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The low-rank term of this block's tile: delta[i] for column `col` and row
// row0 + 2 i, the sum over k < r of lhs[row][k] * rhs(k, col) in f32, k
// ascending. lhs (m, r) row-major; rhs (r, ncols) row-major (forward: b), or
// with kTransRhs its transpose stored (ncols, r) (backward: a).
template <bool kTransRhs>
__device__ __forceinline__ void lora_epilogue(const float* __restrict__ lhs,
                                              const float* __restrict__ rhs, float* su,
                                              float* sr, int m0, int c0, int m, int ncols,
                                              int r, int col, int row0,
                                              float (&delta)[kRowsPerThread]) {
  const int tid = threadIdx.x;
  for (int k0 = 0; k0 < r; k0 += kRk) {
    for (int i = tid; i < kBM * kRk; i += kThreads) {
      const int rr = i / kRk, kk = i % kRk;
      su[i] = (m0 + rr < m && k0 + kk < r) ? lhs[(size_t)(m0 + rr) * r + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kRk * kBN; i += kThreads) {
      int kk, c;
      if (kTransRhs) {
        c = i / kRk;
        kk = i % kRk;
      } else {
        kk = i / kBN;
        c = i % kBN;
      }
      float v = 0.f;
      if (k0 + kk < r && c0 + c < ncols)
        v = kTransRhs ? rhs[(size_t)(c0 + c) * r + k0 + kk] : rhs[(size_t)(k0 + kk) * ncols + c0 + c];
      sr[kk * kLdR + c] = v;
    }
    __syncthreads();
    const int kn = min(kRk, r - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float bv = sr[kk * kLdR + col];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        delta[i] = fmaf(su[(row0 + 2 * i) * kRk + kk], bv, delta[i]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    qlora_fwd_kernel(const __nv_bfloat16* __restrict__ x,  // (m, d)
                     const int8_t* __restrict__ w,         // (d, n): one layer
                     const float* __restrict__ scale,      // (n,)
                     const float* __restrict__ us,         // (m, r) or null
                     const float* __restrict__ b,          // (r, n) or null
                     __nv_bfloat16* __restrict__ out,      // (m, n)
                     int m, int d, int n, int r) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);           // [kBM][kLdA]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + kSmemA);  // [kBK][kLdB]
  float* sc = reinterpret_cast<float*>(smem);                           // [kBM][kLdC]
  float* su = reinterpret_cast<float*>(smem + kSmemTile);               // [kBM][kRk]
  float* sr = su + kBM * kRk;                                           // [kRk][kLdR]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // w[k0:k0+64, n0:n0+64] -> sb as bf16 (exact), rows past d and columns
    // past n as 0
    for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
      const int rr = i / (kBN / 16), v = i % (kBN / 16);
      const int col = n0 + v * 16;
      uint4 wv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + rr < d && col < n)
        wv = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + rr) * n + col));
      const uint32_t words[4] = {wv.x ^ 0x80808080u, wv.y ^ 0x80808080u,
                                 wv.z ^ 0x80808080u, wv.w ^ 0x80808080u};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<__nv_bfloat162*>(sb + rr * kLdB + v * 16 + 4 * k + e) =
              __floats2bfloat162_rn(byte_f32(words[k], e), byte_f32(words[k], e + 1));
    }
    // x[m0:m0+64, k0:k0+64] -> sa, rows past m and columns past d as 0
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int rr = i / (kBK / 8), v = i % (kBK / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + rr < m && k0 + v * 8 < d)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + rr) * d + k0 + v * 8);
      *reinterpret_cast<uint4*>(sa + rr * kLdA + v * 8) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sb + kk * kLdB + wn * 32 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // stage the f32 tile (the staging buffers are free after the last sync)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  const int col = tid % kBN, row0 = tid / kBN;
  float delta[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) delta[i] = 0.f;
  if (r > 0) lora_epilogue<false>(us, b, su, sr, m0, n0, m, n, r, col, row0, delta);
  if (n0 + col < n) {
    const float s = scale[n0 + col];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int rr = row0 + 2 * i;
      if (m0 + rr < m)
        out[(size_t)(m0 + rr) * n + n0 + col] =
            __float2bfloat16(sc[rr * kLdC + col] * s + delta[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    qlora_bwd_kernel(const __nv_bfloat16* __restrict__ g,  // (m, n)
                     const int8_t* __restrict__ w,         // (d, n): one layer
                     const float* __restrict__ scale,      // (n,)
                     const float* __restrict__ vs,         // (m, r) or null
                     const float* __restrict__ a,          // (d, r) or null
                     __nv_bfloat16* __restrict__ out,      // (m, d)
                     int m, int d, int n, int r, int chunk) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);           // [kBM][kLdA]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(smem + kSmemA);  // [kBN][kLdB]
  float* sc = reinterpret_cast<float*>(smem);                           // [kBM][kLdC]
  float* su = reinterpret_cast<float*>(smem + kSmemTile);
  float* sr = su + kBM * kRk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int d0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int valid_rows = min(kBN, d - d0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < n; c0 += chunk) {
    // g[m0:m0+64, c0:c0+chunk] -> sa, rows past m as 0, 8 columns a thread
    const int segs8 = chunk / 8;
    for (int i = tid; i < kBM * segs8; i += kThreads) {
      const int rr = i / segs8, c = (i % segs8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + rr < m) val = *reinterpret_cast<const uint4*>(g + (size_t)(m0 + rr) * n + c0 + c);
      *reinterpret_cast<uint4*>(sa + rr * kLdA + c) = val;
    }
    // W[d0:d0+64, c0:c0+chunk] -> sb[d row][column] as bf16(w8 * bf16(s)),
    // rows past d as 0, 16 columns a thread: one 16-byte load of weights
    // and four of scales
    const int segs = chunk / 16;
    for (int i = tid; i < kBN * segs; i += kThreads) {
      const int rr = i / segs, c = (i % segs) * 16;
      __nv_bfloat16* dst = sb + rr * kLdB + c;
      if (rr >= valid_rows) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const uint4 wv =
          __ldg(reinterpret_cast<const uint4*>(w + (size_t)(d0 + rr) * n + c0 + c));
      const float4* sp = reinterpret_cast<const float4*>(scale + c0 + c);
      const uint32_t words[4] = {wv.x ^ 0x80808080u, wv.y ^ 0x80808080u,
                                 wv.z ^ 0x80808080u, wv.w ^ 0x80808080u};
      uint32_t packed[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 s4 = __ldg(sp + k);
        // bf16(int8) and bf16(s) are exact in f32, and so is their product:
        // one rounding gives the bf16 product
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(byte_f32(words[k], 0) * bf16_round(s4.x),
                                  byte_f32(words[k], 1) * bf16_round(s4.y));
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(byte_f32(words[k], 2) * bf16_round(s4.z),
                                  byte_f32(words[k], 3) * bf16_round(s4.w));
        packed[2 * k] = *reinterpret_cast<const uint32_t*>(&lo);
        packed[2 * k + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      *reinterpret_cast<uint4*>(dst + 8) =
          make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
    for (int kk = 0; kk < chunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * 32 + i * 16) * kLdA + kk, kLdA);
      // B[k][col] = W^T[c0 + kk + k][d0 + col] = sb[col][kk + k]: column-major
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sb + (wn * 32 + j * 16) * kLdB + kk, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  const int col = tid % kBN, row0 = tid / kBN;
  float delta[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) delta[i] = 0.f;
  if (r > 0) lora_epilogue<true>(vs, a, su, sr, m0, d0, m, d, r, col, row0, delta);
  if (d0 + col < d) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int rr = row0 + 2 * i;
      if (m0 + rr < m)
        out[(size_t)(m0 + rr) * d + d0 + col] = __float2bfloat16(sc[rr * kLdC + col] + delta[i]);
    }
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// Forward (B10a). x (m, d) bf16, contiguous; w8 (d, n) int8 and scale (n,)
// f32: views of one layer; us (m, r) and b (r, n) f32, contiguous, or null
// with r = 0 (no adapter); out (m, n) bf16. d is a multiple of 8, n of 16;
// x, w8 and scale 16-byte aligned. Returns cudaGetLastError().
extern "C" int hv_qlora_fwd(const void* x, const void* w8, const void* scale, const void* us,
                            const void* b, void* out, int m, int d, int n, int r,
                            void* stream) {
  if (m < 1 || d < 8 || d % 8 || n < 16 || n % 16 || r < 0 || (r > 0 && (!us || !b)) ||
      (m + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(w8) || misaligned(scale)) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  qlora_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<const float*>(us),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), m, d, n, r);
  return (int)cudaGetLastError();
}

// Input gradient (B10b). g (m, n) bf16, contiguous; w8 (d, n) int8 and
// scale (n,) f32: views of one layer; vs (m, r) and a (d, r) f32,
// contiguous, or null with r = 0; out (m, d) bf16. d is a multiple of 8, n
// of 16; g, w8 and scale 16-byte aligned. The contraction over n runs in
// chunks of 64 columns (32 or 16 where n is no multiple of 64), ascending.
// Returns cudaGetLastError().
extern "C" int hv_qlora_bwd(const void* g, const void* w8, const void* scale, const void* vs,
                            const void* a, void* out, int m, int d, int n, int r,
                            void* stream) {
  if (m < 1 || d < 8 || d % 8 || n < 16 || n % 16 || r < 0 || (r > 0 && (!vs || !a)) ||
      (m + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (misaligned(g) || misaligned(w8) || misaligned(scale)) return (int)cudaErrorMisalignedAddress;
  const int chunk = n % 64 == 0 ? 64 : (n % 32 == 0 ? 32 : 16);
  const dim3 grid((d + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  qlora_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<const float*>(vs),
      static_cast<const float*>(a), static_cast<__nv_bfloat16*>(out), m, d, n, r, chunk);
  return (int)cudaGetLastError();
}
