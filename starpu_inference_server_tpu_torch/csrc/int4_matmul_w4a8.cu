// int4_matmul_w4a8: y[M,N] f32 = (x_q[M,K] @ unpack(w_p4[K/2,N])) * x_scale[M] * scale[N]
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/pallas_kernels.py
// int4_matmul_w4a8 (_int4_w4a8_kernel). Same function: int8 activations
// (per-row scales from ops/quant.py quantize_activations) times the
// pairwise-packed int4 weight (low nibble = row 2a, high nibble = row
// 2a+1, sign-extended), the product summed EXACTLY in int32, converted to
// f32 once and scaled as (acc * x_scale[m]) * scale[n]. Every llama-1b
// sum stays below 2^24 in magnitude (127 * 7 * 5504 < 4.9e6), so the
// result equals the plain version's float64 contraction bit for bit.
//
// Bound on the H100: at decode (M = 16 slots) the packed weight bytes
// (gate_up: 11.3 MB per call), since each weight byte feeds 4*M integer
// operations. Design: each block owns a BM x 64 output tile and walks K
// in 64-deep stages. Per stage, x_q is staged as int32 words of four
// consecutive k values per row, and the weight's 32 packed byte rows are
// unpacked into int32 words of four consecutive k values per column (two
// packed bytes per word), in shared memory only; each of the 256 threads
// accumulates TM x 4 outputs with __dp4a (four s8 x s8 products and an
// s32 add per instruction). The weight is read from device memory in its
// packed form once per BM-row band. Tensor cores (mma.sync s8) are the
// next step.

#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 64;          // K values per stage (32 packed byte rows)
constexpr int kKW = kBK / 4;     // int32 words per stage row
constexpr int kThreads = 256;

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xFF) | ((b & 0xFF) << 8) | ((c & 0xFF) << 16) | ((d & 0xFF) << 24);
}

// four consecutive k values (packed rows r0, r0 + 1) of one column
__device__ __forceinline__ int weight_word(uint8_t b0, uint8_t b1) {
  return pack4(sis::sext_lo(b0), sis::sext_hi(b0), sis::sext_lo(b1), sis::sext_hi(b1));
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
int4_w4a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                 const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 float* __restrict__ y, int M, int N, int K) {
  constexpr int BM = 16 * TM;
  __shared__ int x_s[BM][kKW + 1];              // +1: rows land on distinct banks
  __shared__ __align__(16) int w_s[kKW][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx * 4 .. + 3
  const int ty = tid / 16;  // rows ty * TM .. + TM - 1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int khalf = K / 2;
  const bool vec = (N % 4) == 0;

  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kKW; i += kThreads) {
      const int mm = i / kKW;
      const int kw = i % kKW;
      const int gm = m0 + mm;
      int vals[4] = {0, 0, 0, 0};
      if (gm < M) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + kw * 4 + e;
          if (gk < K) vals[e] = x[(size_t)gm * K + gk];
        }
      }
      x_s[mm][kw] = pack4(vals[0], vals[1], vals[2], vals[3]);
    }
    // one item = (stage word row kw, 4 columns): packed rows r0, r0 + 1
    for (int i = tid; i < kKW * (kBN / 4); i += kThreads) {
      const int kw = i / (kBN / 4);
      const int nn = (i % (kBN / 4)) * 4;
      const int gn = n0 + nn;
      const int r0 = k0 / 2 + 2 * kw;
      uint8_t b0[4] = {0, 0, 0, 0};
      uint8_t b1[4] = {0, 0, 0, 0};
      if (vec && gn + 3 < N) {
        if (r0 < khalf) {
          const uchar4 t = *reinterpret_cast<const uchar4*>(w + (size_t)r0 * N + gn);
          b0[0] = t.x; b0[1] = t.y; b0[2] = t.z; b0[3] = t.w;
        }
        if (r0 + 1 < khalf) {
          const uchar4 t = *reinterpret_cast<const uchar4*>(w + (size_t)(r0 + 1) * N + gn);
          b1[0] = t.x; b1[1] = t.y; b1[2] = t.z; b1[3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gn + e < N) {
            if (r0 < khalf) b0[e] = w[(size_t)r0 * N + gn + e];
            if (r0 + 1 < khalf) b1[e] = w[(size_t)(r0 + 1) * N + gn + e];
          }
        }
      }
      const int4 word = make_int4(weight_word(b0[0], b1[0]), weight_word(b0[1], b1[1]),
                                  weight_word(b0[2], b1[2]), weight_word(b0[3], b1[3]));
      *reinterpret_cast<int4*>(&w_s[kw][nn]) = word;
    }
    __syncthreads();

#pragma unroll 4
    for (int kw = 0; kw < kKW; ++kw) {
      const int4 b = *reinterpret_cast<const int4*>(&w_s[kw][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int a = x_s[ty * TM + i][kw];
        acc[i][0] = __dp4a(a, b.x, acc[i][0]);
        acc[i][1] = __dp4a(a, b.y, acc[i][1]);
        acc[i][2] = __dp4a(a, b.z, acc[i][2]);
        acc[i][3] = __dp4a(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
    const float sx = xs[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) y[(size_t)gm * N + gn] = (__int2float_rn(acc[i][j]) * sx) * scale[gn];
    }
  }
}

}  // namespace

extern "C" int sis_int4_matmul_w4a8(const void* x_q, const void* x_scale, const void* w_p4,
                                    const void* scale, void* y, int M, int N, int K,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreads);
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* xs = static_cast<const float*>(x_scale);
  const auto* w = static_cast<const uint8_t*>(w_p4);
  const auto* sc = static_cast<const float*>(scale);
  auto* out = static_cast<float*>(y);
  if (M > 16) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64);
    int4_w4a8_kernel<4><<<grid, block, 0, st>>>(x, xs, w, sc, out, M, N, K);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16);
    int4_w4a8_kernel<1><<<grid, block, 0, st>>>(x, xs, w, sc, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
