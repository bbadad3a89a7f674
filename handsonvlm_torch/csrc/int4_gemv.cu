// Int4 weight-only GEMV over the tiled and the flat layout, for Hopper
// (sm_90a): the body of csrc/gemv.cuh with the int4 decoder.
//
// Replaces three pallas_calls of handsonvlm_tpu/ops/int8_matmul.py that run
// the _gemv4_kernel body: _int4_gemv_tiled (B4b, the tiled stack that
// int4_matmul_stacked reaches for fewer than 128 rows),
// _int4_matmul_stacked_impl's flat branch (B4c, the flat stack (L, G, g/2,
// n), fewer than 128 rows) and int4_matmul (B4a, one flat (G, g/2, n)
// matrix at any row count, the per-projection leaves of
// maybe_int8_matmul): y = x @ dequant(w4[layer]) for decode (m = 1), small
// windows and, for B4a, any m.
//
// What it computes: y[m, n] = sum_g s[g, n] * sum_r x[m, g*g_size + r] *
// q[g, r, n] with f32 accumulation and the f32 group scale applied to each
// group's partial sum. The byte at (g, r, column) holds the value of row r
// (low nibble, biased by +8) and of row g/2 + r (high nibble, two's
// complement) of group g. Two address maps reach it, one body serves both:
// the tiled layout of tile_int4_stacked puts tile j's (G, g/2, BN) bytes in
// one contiguous block, byte (g, r, c) of tile j at ((j*G + g)*g/2 + r)*BN
// + c and its scale at (j*G + g)*BN + c; the flat layout puts it at
// (g*g/2 + r)*n + j*BN + c, rows of n bytes, and its scale at g*n + j*BN +
// c. Given the flat layout, the caller takes BN from the same weight's tiled
// layout (pick_block_n), so the column blocks, the splits and every sum are
// those of the tiled call: the two give the same bits. The TMA maps view
// the tiled bytes as [NB G g/2][BN] and the flat ones as [G g/2][n]; a
// block's 128 columns lie in one BN tile (a part of the last 128 when BN is
// not a multiple of 128: the columns past the tile are read, as zeros or as
// the next tile's, and not stored).
// The Pallas kernel's biased-nibble bf16 algebra (x_hi - 16 x_lo rounded to
// bf16) exists because Mosaic cannot shift i8; here both nibbles are
// unpacked exactly, and a bf16 x's products are exact on the tensor cores
// (bf16 x times a small integer), summed in f32.
//
// Bound and design: csrc/gemv.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv.cuh"

namespace {

using hv::GemvArgs;
using hv::Int4Dec;

template <int HALF>
cudaError_t launch_half(const void* x, const void* w4, const void* gs, const GemvArgs& a,
                        int is_bf16, int NB, int splits, cudaStream_t stream) {
  const uint64_t n = (uint64_t)NB * a.bn;
  // the tiled bytes as [NB G HALF][BN], the flat as [G HALF][n]; scales alike
  const uint64_t w_rows = a.flat ? (uint64_t)a.G * HALF : (uint64_t)NB * a.G * HALF;
  const uint64_t s_rows = a.flat ? (uint64_t)a.G : (uint64_t)NB * a.G;
  const uint64_t cols = a.flat ? n : (uint64_t)a.bn;
  CUtensorMap tm_w, tm_s, tm_x;
  if (!hv::gemv_w_map(&tm_w, w4, w_rows, cols, HALF) || !hv::gemv_s_map(&tm_s, gs, s_rows, cols))
    return cudaErrorInvalidValue;
  const int blocks = NB * a.cpt;
  if (is_bf16) {
    if (!hv::gemv_x_map(&tm_x, x, a.m, a.d)) return cudaErrorInvalidValue;
    return hv::launch_gemv<Int4Dec<HALF>, __nv_bfloat16, __nv_bfloat16>(tm_w, tm_s, tm_x, a,
                                                                          splits, blocks, stream);
  }
  // an f32 x is read directly: tm_w stands in for the unread map
  return hv::launch_gemv<Int4Dec<HALF>, float, float>(tm_w, tm_s, tm_w, a, splits, blocks,
                                                      stream);
}

}  // namespace

// x (m, d) and out (m, NB*BN) of one dtype (bf16 or f32), contiguous and
// 16-byte aligned; w4_layer and gs_layer: views of one layer of the
// stacked weights (16-byte aligned), tiled (flat = 0: (NB, G, half, BN)
// int8 and (NB, G, BN) f32) or flat (flat = 1: (G, half, NB*BN) int8 and
// (G, NB*BN) f32, BN the column tile). half is 8, 16, 32 or 64; BN a
// multiple of 16. Split s of the n_split (1..8, one cluster) covers groups
// [s*per, (s+1)*per). One launch; returns cudaGetLastError().
extern "C" int hv_int4_gemv(const void* x, const void* w4_layer, const void* gs_layer,
                            void* out, int is_bf16, int flat, int m, int NB, int G, int half,
                            int BN, int n_split, int per, void* stream) {
  const int cpt = (BN + hv::kGvCols - 1) / hv::kGvCols;
  if (BN < 16 || BN % 16 || m < 1 || (m + hv::kGvRows - 1) / hv::kGvRows > 65535 || NB < 1 ||
      (long long)NB * cpt > 65535 || G < 1 || n_split < 1 || n_split > hv::kGvMaxSplits ||
      per < 1 || (long long)(n_split - 1) * per >= G || (long long)n_split * per < G ||
      (half != 8 && half != 16 && half != 32 && half != 64))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w4_layer) |
       reinterpret_cast<uintptr_t>(gs_layer) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  GemvArgs a = {};
  a.x = x;
  a.out = out;
  a.m = m;
  a.d = G * 2 * half;
  a.n_out = NB * BN;
  a.units = G;
  a.per = per;
  a.bn = BN;
  a.cpt = cpt;
  a.G = G;
  a.flat = flat;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (half) {
    case 8: return (int)launch_half<8>(x, w4_layer, gs_layer, a, is_bf16, NB, n_split, st);
    case 16: return (int)launch_half<16>(x, w4_layer, gs_layer, a, is_bf16, NB, n_split, st);
    case 32: return (int)launch_half<32>(x, w4_layer, gs_layer, a, is_bf16, NB, n_split, st);
    default: return (int)launch_half<64>(x, w4_layer, gs_layer, a, is_bf16, NB, n_split, st);
  }
}
