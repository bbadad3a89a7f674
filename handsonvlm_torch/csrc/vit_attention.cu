// Full non-causal attention at CLIP ViT shapes, for Hopper (sm_90a).
//
// Replaces handsonvlm_tpu/ops/vit_attention.py::_vit_attn_kernel (reached
// through vit_attention). It computes unmasked, non-causal softmax
// attention of q, k, v laid out (B, T, H, 64) and writes the output in the
// same packed (B, T, H*64) layout, so no transpose is made on either side.
// Scores and softmax are fp32. Unlike the Pallas kernel, which casts the
// normalised probabilities to v's dtype before the P.V product, this kernel
// keeps p in fp32 (an online softmax normalises at the end); in bf16 the
// two differ by bf16 rounding of p, which the card-side tolerance covers.
//
// Design: one thread block per (query tile of 32 rows, head, frame), four
// warps of eight query rows each. The block loops over key tiles of 64
// with an online softmax (m, l, acc in registers), staging each K and V
// tile in shared memory as fp32 (row stride 65 so the per-lane key reads
// hit distinct banks). T = 257 is odd: query rows past T are computed but
// not stored, and keys past T get probability 0.
//
// Bound: at (B=10, T=257, H=16, D=64) the kernel does 2 * B * H * T^2 * 64
// ~ 1.35 GFMA on the fp32 CUDA cores against 4 * B * T * H * 64 * 2 bytes
// ~ 5.3 MB of traffic, so it is bound by fp32 FMA issue, not memory. The
// tensor cores (mma.sync or wgmma on bf16 tiles) are the later work that
// would move that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;          // the only head size (the JAX kernel's rule too)
constexpr int kQT = 32;         // query rows per block
constexpr int kKT = 64;         // keys per tile: two per lane
constexpr int kThreads = 128;
constexpr int kRowsPerWarp = kQT / (kThreads / 32);  // 8
constexpr float kNegInf = -1e30f;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vit_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int Tn,
                    int H, float scale) {
  __shared__ float sq[kQT][kD];
  __shared__ float sk[kKT][kD + 1];
  __shared__ float sv[kKT][kD + 1];
  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t tok = (size_t)H * kD;  // stride between tokens
  const size_t base = (size_t)b * Tn * tok + (size_t)h * kD;

  for (int i = tid; i < kQT * kD; i += kThreads) {
    const int r = i / kD, d = i % kD, t = q0 + r;
    sq[r][d] = t < Tn ? to_f32(q[base + t * tok + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc0[kRowsPerWarp], acc1[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
    acc0[rr] = 0.f;
    acc1[rr] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kKT) {
    __syncthreads();  // the previous tile is consumed (and sq is written)
    for (int i = tid; i < kKT * kD; i += kThreads) {
      const int j = i / kD, d = i % kD, t = k0 + j;
      const bool in = t < Tn;
      sk[j][d] = in ? to_f32(k[base + t * tok + d]) : 0.f;
      sv[j][d] = in ? to_f32(v[base + t * tok + d]) : 0.f;
    }
    __syncthreads();
    const bool ok0 = k0 + lane < Tn;
    const bool ok1 = k0 + lane + 32 < Tn;

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) {
        const float qd = sq[r][d];
        s0 += qd * sk[lane][d];
        s1 += qd * sk[lane + 32][d];
      }
      s0 = ok0 ? s0 * scale : kNegInf;
      s1 = ok1 ? s1 * scale : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p0 + p1);
      m[rr] = m_new;
      float a0 = acc0[rr] * corr, a1 = acc1[rr] * corr;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p0, j);
        a0 += pj * sv[j][lane];
        a1 += pj * sv[j][lane + 32];
      }
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p1, j);
        a0 += pj * sv[j + 32][lane];
        a1 += pj * sv[j + 32][lane + 32];
      }
      acc0[rr] = a0;
      acc1[rr] = a1;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int t = q0 + warp * kRowsPerWarp + rr;
    if (t < Tn) {
      const float inv = 1.f / l[rr];  // every row has T >= 1 valid keys
      out[base + t * tok + lane] = from_f32<T>(acc0[rr] * inv);
      out[base + t * tok + lane + 32] = from_f32<T>(acc1[rr] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tn, int H, float scale, cudaStream_t stream) {
  const dim3 grid((Tn + kQT - 1) / kQT, H, B);
  vit_attn_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tn, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, T, H, 64) contiguous, of one dtype (bf16 or f32).
// Returns cudaGetLastError() after the launch.
extern "C" int hv_vit_attention(const void* q, const void* k, const void* v,
                                void* out, int is_bf16, int B, int Tn, int H,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, out, B, Tn, H, scale, st);
  return (int)launch<float>(q, k, v, out, B, Tn, H, scale, st);
}
