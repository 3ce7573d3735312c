// int4_matmul: y[M,N] f32 = (bf16(x[M,K]) @ unpack(w_p4[K/2,N])) * scale[N]
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/pallas_kernels.py
// int4_matmul (_int4_matmul_kernel). Same function: x is rounded to
// bfloat16 inside the kernel (also when it arrives as f32), the packed
// weight is unpacked pairwise (low nibble = row 2a, high nibble = row
// 2a+1, sign-extended), products accumulate in f32 and the per-column
// scale is applied to the f32 accumulator. The output is f32; the caller
// (ops/nn.py:dense) casts it to the compute dtype.
//
// Bound on the H100: at decode (M = 128 slots) the dense layers of
// llama-1b move ~0.4 GB of packed weights per step but do ~2*M FLOPs per
// weight; on CUDA cores (no tensor cores in this first version) the
// FLOPs bound it. Design: a shared-memory tiled SIMT GEMM. Each block
// owns a BM x 128 output tile, stages a 32-deep K slice of bf16-rounded
// x (transposed) and of the unpacked weight (4 bits -> f32, once per
// tile, never written to device memory) in shared memory, and each of
// its 256 threads accumulates TM x 8 outputs in registers. The weight
// is read from device memory in its packed form exactly once per
// BM-row band. Tensor cores (mma.sync / wgmma) are the next step.

#include "common.cuh"

namespace {

constexpr int kBN = 128;
constexpr int kBK = 32;  // K values per stage (16 packed byte rows)
constexpr int kThreads = 256;

template <typename TX, int TM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ y,
                   int M, int N, int K) {
  constexpr int BM = 16 * TM;
  __shared__ float xs[kBK][BM + 1];  // x tile, transposed; +1 breaks bank conflicts
  __shared__ __align__(16) float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int khalf = K / 2;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int mm = i / kBK;
      const int kk = i % kBK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K) v = sis::round_bf16(sis::to_f(x[(size_t)gm * K + gk]));
      xs[kk][mm] = v;
    }
    for (int i = tid; i < (kBK / 2) * kBN; i += kThreads) {
      const int rr = i / kBN;
      const int nn = i % kBN;
      const int gr = k0 / 2 + rr;
      const int gn = n0 + nn;
      int lo = 0, hi = 0;
      if (gr < khalf && gn < N) {
        const uint8_t b = w[(size_t)gr * N + gn];
        lo = sis::sext_lo(b);
        hi = sis::sext_hi(b);
      }
      ws[2 * rr][nn] = static_cast<float>(lo);
      ws[2 * rr + 1][nn] = static_cast<float>(hi);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < N) y[(size_t)gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

template <typename TX>
void launch(const void* x, const void* w, const void* scale, void* y, int M, int N, int K,
            cudaStream_t stream) {
  const dim3 block(kThreads);
  if (M > 16) {
    const dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64);
    int4_matmul_kernel<TX, 4><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), M, N, K);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16);
    int4_matmul_kernel<TX, 1><<<grid, block, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), M, N, K);
  }
}

}  // namespace

extern "C" int sis_int4_matmul(const void* x, const void* w_p4, const void* scale, void* y,
                               int M, int N, int K, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == sis::kBF16) {
    launch<__nv_bfloat16>(x, w_p4, scale, y, M, N, K, s);
  } else {
    launch<float>(x, w_p4, scale, y, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
