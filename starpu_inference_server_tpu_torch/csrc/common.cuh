// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library has a plain C interface (extern "C"), is built by
// ops/_build.py with nvcc for sm_90a, and is called through ctypes. Each
// entry point launches on the stream it is given and returns
// cudaGetLastError(), which the Python wrapper checks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sis {

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round-to-nearest-even through bfloat16 and back (the x.astype(bf16)
// of the TPU int4 kernel)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sign-extended nibbles of one packed int4 byte: low = even row,
// high = odd row (pairwise layout, ops/quant.py:pack_int4)
__device__ __forceinline__ int sext_lo(uint8_t b) {
  return static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(b << 4))) >> 4;
}
__device__ __forceinline__ int sext_hi(uint8_t b) {
  return static_cast<int>(static_cast<int8_t>(b)) >> 4;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr float kNeg = -1e30f;  // mask value of the TPU kernels

// One query row per thread, online softmax over keys staged in shared
// memory as float [nk_pad][D] (rows past the valid range zero-filled).
// Key j (0-based in the stage) is attended when j < nk and, for
// consume(), its absolute index kbase + j <= kmax (causal); consume_bias()
// instead adds bias[j] to every logit (an additive key mask, as the
// encoder kernel of the TPU package does). Keys are taken SB at a time:
// the running max and the accumulator rescale once per sub-block.
template <int D, int SB>
struct FlashRow {
  float q[D];
  float acc[D];
  float m;
  float l;

  __device__ __forceinline__ void init() {
    m = kNeg;
    l = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
  }

  __device__ __forceinline__ void consume(const float* ks, const float* vs, int nk,
                                          int kbase, int kmax, float scale) {
    consume_with(ks, vs, nk, [&](int j, float dot) {
      return (kbase + j <= kmax) ? dot * scale : kNeg;
    });
  }

  __device__ __forceinline__ void consume_bias(const float* ks, const float* vs,
                                               const float* bias, int nk, float scale) {
    consume_with(ks, vs, nk, [&](int j, float dot) { return dot * scale + bias[j]; });
  }

  // logit(j, q.k_j) gives the logit of a key j < nk
  template <typename Logit>
  __device__ __forceinline__ void consume_with(const float* ks, const float* vs, int nk,
                                               Logit logit) {
    for (int j0 = 0; j0 < nk; j0 += SB) {
      float s[SB];
      float cmax = kNeg;
#pragma unroll
      for (int jj = 0; jj < SB; ++jj) {
        const float* kr = ks + (j0 + jj) * D;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          dot = fmaf(q[d], kv.x, dot);
          dot = fmaf(q[d + 1], kv.y, dot);
          dot = fmaf(q[d + 2], kv.z, dot);
          dot = fmaf(q[d + 3], kv.w, dot);
        }
        const int j = j0 + jj;
        s[jj] = (j < nk) ? logit(j, dot) : kNeg;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SB; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float* vr = vs + (j0 + jj) * D;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* out) const {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = from_f<T>(acc[d] * inv);
  }
};

}  // namespace sis
