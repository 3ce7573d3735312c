// int8_matmul: y[M,N] f32 = (bf16(x[M,K]) @ w_q[K,N]) * scale[N]
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/pallas_kernels.py
// int8_matmul (_matmul_kernel). Same function: x is rounded to bfloat16
// inside the kernel (also when it arrives as f32), the int8 weight values
// are exact in f32, products accumulate in f32 and the per-column scale
// is applied to the f32 accumulator. The output is f32; the caller
// (ops/nn.py:dense, which routes int8 weights here at <= 64 rows) casts
// it to the compute dtype.
//
// Bound on the H100: on the path (the ResNet-18 fc, M = batch <= 32,
// K = 512, N = 1000) the work is ~2*M FLOPs per weight byte, far under the
// card's ~295 bf16 FLOPs per byte: the 0.5 MB of int8 weight (plus x and
// y) at the memory rate bounds it, a fraction of a microsecond, so a
// launch of this size is latency-bound in practice. Design: each block
// owns 32 output columns and all rows of one row band (up to 32 rows);
// a warp reads 4 K-rows x 32 bytes per step (one 32-byte sector per
// weight row, 4-byte loads when N % 4 == 0, else byte loads: N = 1000
// rows are 8-byte but not 16-byte aligned), and the 256 threads of the
// block split K 32 ways. x is staged once per 256-deep K slice in shared
// memory, bf16-rounded; each thread keeps rows x 4 f32 accumulators,
// which a shuffle and a shared-memory pass sum over the K split. The
// grid fills along N (32 columns per block) and never splits M below the
// 32-row band, so the weight is read from device memory once per band.
// The ragged edge (N not a multiple of 32) is masked in the kernel: no
// padded copy of the weight. Tensor cores and a split of K over blocks
// are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesN = 8;                  // lanes across columns, 4 columns each
constexpr int kCols = kLanesN * 4;          // 32 columns per block
constexpr int kKRows = kThreads / kLanesN;  // 32 K rows in flight per block
constexpr int kKC = 256;                    // K values of x staged per pass
constexpr int kBuf = 8192;                  // floats: x stage or the K-split reduction

template <typename TX, int MT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ y, int M, int N,
                   int K, int vec4) {
  static_assert(MT * kKC <= kBuf && (kThreads / 32) * MT * kCols <= kBuf, "buffer");
  __shared__ __align__(16) float buf[kBuf];

  const int tid = threadIdx.x;
  const int cg = tid % kLanesN;
  const int kr = tid / kLanesN;
  const int n = blockIdx.x * kCols + cg * 4;
  const int m0 = blockIdx.y * MT;

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    __syncthreads();
    for (int i = tid; i < MT * kKC; i += kThreads) {
      const int mm = i / kKC;
      const int kk = i % kKC;
      float v = 0.f;
      if (m0 + mm < M && kk < kc) v = sis::round_bf16(sis::to_f(x[(size_t)(m0 + mm) * K + k0 + kk]));
      buf[i] = v;
    }
    __syncthreads();
    for (int kk = kr; kk < kc; kk += kKRows) {
      const int8_t* wr = w + (size_t)(k0 + kk) * N + n;
      float b[4];
      if (vec4) {
        char4 c = make_char4(0, 0, 0, 0);
        if (n < N) c = *reinterpret_cast<const char4*>(wr);
        b[0] = c.x;
        b[1] = c.y;
        b[2] = c.z;
        b[3] = c.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = (n + j < N) ? static_cast<float>(wr[j]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float a = buf[i * kKC + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }

  // sum over the K split: the 4 K rows of a warp by shuffles, then the
  // 8 warps through shared memory
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][j] = v;
    }
  const int warp = tid / 32;
  const int lane = tid % 32;
  __syncthreads();
  if (lane < kLanesN) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) buf[(warp * MT + i) * kCols + cg * 4 + j] = acc[i][j];
  }
  __syncthreads();
  for (int i = tid; i < MT * kCols; i += kThreads) {
    const int mm = i / kCols;
    const int cc = i % kCols;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) s += buf[(wi * MT + mm) * kCols + cc];
    const int gm = m0 + mm;
    const int gn = blockIdx.x * kCols + cc;
    if (gm < M && gn < N) y[(size_t)gm * N + gn] = s * scale[gn];
  }
}

template <typename TX, int MT>
void launch_mt(const void* x, const void* w, const void* scale, void* y, int M, int N, int K,
               int vec4, cudaStream_t st) {
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  int8_matmul_kernel<TX, MT><<<grid, kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), M, N, K, vec4);
}

template <typename TX>
void launch(const void* x, const void* w, const void* scale, void* y, int M, int N, int K,
            cudaStream_t st) {
  // 4-byte weight loads need 4-byte aligned rows: N % 4 == 0 and an
  // aligned base pointer
  const int vec4 = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  if (M <= 1) {
    launch_mt<TX, 1>(x, w, scale, y, M, N, K, vec4, st);
  } else if (M <= 2) {
    launch_mt<TX, 2>(x, w, scale, y, M, N, K, vec4, st);
  } else if (M <= 4) {
    launch_mt<TX, 4>(x, w, scale, y, M, N, K, vec4, st);
  } else if (M <= 8) {
    launch_mt<TX, 8>(x, w, scale, y, M, N, K, vec4, st);
  } else if (M <= 16) {
    launch_mt<TX, 16>(x, w, scale, y, M, N, K, vec4, st);
  } else {
    launch_mt<TX, 32>(x, w, scale, y, M, N, K, vec4, st);
  }
}

}  // namespace

extern "C" int sis_int8_matmul(const void* x, const void* w_q, const void* scale, void* y,
                               int M, int N, int K, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == sis::kBF16) {
    launch<__nv_bfloat16>(x, w_q, scale, y, M, N, K, s);
  } else {
    launch<float>(x, w_q, scale, y, M, N, K, s);
  }
  return static_cast<int>(cudaGetLastError());
}
