// Pieces shared by the weight-only matmuls on wgmma (csrc/int4_prefill.cu,
// int4_transpose.cu, int8_matmul.cu, qlora_fused.cu): the exact conversion
// of packed int4 and int8 weights to bf16 pairs in registers, the load of
// a low-rank term's packed A fragments, the mbarrier ring position of a
// producer / consumer pipeline, the f32 -> bf16 conversion of an f32 input,
// and the in-order sum of split-K partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace hv {

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// two nibbles held as 128 + (value + 8) in the mantissas of a bf16 pair ->
// bf16(value * scale): an exact value and one rounding of the exact product
__device__ __forceinline__ uint32_t dequant2(uint32_t biased, __nv_bfloat162 scale) {
  const __nv_bfloat162 v = __hsub2(as_bf162(biased), as_bf162(0x43084308u));  // - 136
  return as_u32(__hmul2(v, scale));
}

// the low nibbles (stored biased by +8) of bytes 0 and 2 of p, as the
// biased bf16 pair dequant2 takes
__device__ __forceinline__ uint32_t low_nibbles(uint32_t p) {
  return (p & 0x000F000Fu) | 0x43004300u;
}

// the high nibbles (two's complement) of bytes 0 and 2 of p: XOR-ing bit 3
// adds 8
__device__ __forceinline__ uint32_t high_nibbles(uint32_t p) {
  return ((p >> 4) & 0x000F000Fu) ^ 0x43084308u;
}

// the int8 values in bytes 0 and 2 of p (bytes 1 and 3 ignored) as an exact
// bf16 pair: 128 + (b & 127) from the mantissa of 128.0, less 128, or 256
// where b's sign bit is set (b = (b & 127) - 128)
__device__ __forceinline__ uint32_t int8_pair(uint32_t p) {
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (p & 0x00800080u) ^ 0x43004300u;
  return as_u32(__hsub2(as_bf162(v), as_bf162(c)));
}

// one sub-tile's A operand of a low-rank term for one k16 step, packed in
// registers' order (csrc/qlora_fused.cu pack_frags_kernel): the four
// registers of the bf16 high parts at frag[at], of the rests at frag[at +
// part]
__device__ __forceinline__ void term_frags(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const uint4* __restrict__ frag, int64_t part,
                                           int64_t at) {
  const uint4 h = __ldg(frag + at), l = __ldg(frag + part + at);
  hi[0] = h.x, hi[1] = h.y, hi[2] = h.z, hi[3] = h.w;
  lo[0] = l.x, lo[1] = l.y, lo[2] = l.z, lo[3] = l.w;
}

// a stage of an mbarrier ring and the parity of its current phase
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// the block's dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's atom; the kernels ask for 1024 bytes of slack)
__device__ __forceinline__ unsigned char* smem_1024(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

namespace {  // each source that includes this keeps its own copy of the kernels

// out = sum over s of part[s], s ascending, cast to the output dtype
__global__ void merge_splits_kernel(const float4* __restrict__ part, void* __restrict__ out,
                                    int out_bf16, int64_t vecs, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < vecs;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 b = part[(int64_t)s * vecs + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    if (out_bf16) {
      uint2 o;
      o.x = pack_bf16(a.x, a.y);
      o.y = pack_bf16(a.z, a.w);
      static_cast<uint2*>(out)[i] = o;
    } else {
      static_cast<float4*>(out)[i] = a;
    }
  }
}

// f32 x -> bf16 (round to nearest even), 8 values a thread
__global__ void to_bf16_kernel(const float4* __restrict__ x, uint4* __restrict__ xb,
                               int64_t vecs) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < vecs;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 a = x[2 * i], b = x[2 * i + 1];
    xb[i] = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                       pack_bf16(b.z, b.w));
  }
}

}  // namespace

// blocks of 256 threads for a grid-stride loop over `work` items
inline int grid_for(int64_t work) {
  const int64_t blocks = (work + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

// fn(std::integral_constant<int, N>) for the row tile N (wgmma's N) the
// wrapper chose: 16, 32, 64, 104 or 128
template <typename Fn>
cudaError_t with_rows_tile(int rows_tile, Fn&& fn) {
  switch (rows_tile) {
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 104: return fn(std::integral_constant<int, 104>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

// set a kernel's dynamic shared memory limit once per process
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = err == cudaSuccess;
  return err;
}

}  // namespace hv
