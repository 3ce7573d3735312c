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
// Bound on the H100: at decode (M = 128 slots) a packed weight byte
// feeds 4 * M = 512 FLOPs, above the card's ~295 bf16 FLOPs per byte of
// device memory, so the bf16 tensor-core rate bounds the dense layers
// (gate_up: 5.8 GFLOP, 5.8 us); at M = 1 (the lm_head of a prefill) the
// packed bytes do. Either way the kernel has to run on the tensor cores
// and keep every SM busy.
//
// Design:
// - Tensor cores: mma.sync m16n8k16 bf16 -> f32. int4 values are exact in
//   bf16 and x is bf16 by the function's definition, so every product is
//   the one the CUDA-core version formed; only the order of the f32 sums
//   changes.
// - Unpacking in registers: one packed byte holds w[2a][n] and w[2a+1][n],
//   the two consecutive k of one B-fragment register, low k in the low
//   half. Each warp owns 32 output columns and numbers them so that mma
//   column c of n-tile j is warp column 4c + j: a lane's four n-tiles then
//   read 4 consecutive bytes, one 32-bit shared load per packed row, and
//   each byte becomes one register with integer ops and one exact bf16x2
//   fma (bits 0x4300 | (nibble ^ 8) are 136 + nibble; minus 136). The
//   accumulators come out as 8 consecutive columns per lane and row,
//   stored as two float4. The unpacked weight never exists in memory.
// - Staging: a ring of 3 stages of 64 k: the x tile as bf16 rows padded
//   to 144 bytes (ldmatrix reads A fragments without bank conflicts) and
//   the packed weight tile [32][BN] in rows padded to BN + 32 bytes (the
//   lanes' 32-bit reads hit 32 banks), both copied 16 bytes a thread with
//   cp.async (zero-filled past M, N and K). Shapes whose rows are not
//   16-byte multiples (K % 8, N % 16) or f32 x load element by element
//   into the same ring.
// - Filling 132 SMs: three tile variants (BM = 16, 64, 128 rows by
//   BN = 128 columns) and a split of K chosen by
//   ops/matmul_kernels.py:int4_matmul_plan, so that every main-path shape
//   launches at least one block per SM. Split s takes k-tiles
//   [s * KT / S, (s + 1) * KT / S), never empty. Partial sums go to an f32
//   workspace, and a second kernel adds them in split order and applies
//   the scale: no atomics, the same bits on every run.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBK = 64;               // k per stage (32 packed byte rows)
constexpr int kStages = 3;
constexpr int kArow = kBK + 8;        // bf16 per staged x row (144 bytes)
constexpr int kBpad = 32;             // bytes of padding per staged weight row

template <int MT, int WM, int WN>  // m16 tiles per warp, warps along M and along N
struct Cfg {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 32 * WN;
  static constexpr int kBrow = BN + kBpad;
  static constexpr int kAStage = BM * kArow * 2;    // bytes
  static constexpr int kBStage = (kBK / 2) * kBrow;  // bytes
  static constexpr int kSmem = kStages * (kAStage + kBStage);
};

// one packed byte (nibbles XOR 8, in bits 0..7) -> bf16x2 (row 2a low, 2a+1 high)
__device__ __forceinline__ uint32_t unpack_pair(uint32_t t) {
  const uint32_t r = (t & 0x0000000Fu) | ((t << 12) & 0x000F0000u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;  // (128 + nibble + 8) * 1 - 136, exact
}

template <typename TX, int MT, int WM, int WN>
__global__ void __launch_bounds__(Cfg<MT, WM, WN>::kThreads, 2)  // 2 blocks an SM: <= 128 registers
int4_matmul_mma(const TX* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ y,
                float* __restrict__ ws, int M, int N, int K, int vec) {
  using C = Cfg<MT, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_s = smem;                            // [stage][BM][kArow] bf16
  unsigned char* b_s = smem + kStages * C::kAStage;     // [stage][32][kBrow] bytes

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int n0 = blockIdx.x * C::BN;
  const int m0 = blockIdx.y * C::BM;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int khalf = K / 2;
  const int KT = (K + kBK - 1) / kBK;
  const int kt0 = (int)((long long)split * KT / splits);
  const int nk = (int)((long long)(split + 1) * KT / splits) - kt0;

  auto load = [&](int kt, int slot) {
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(a_s + slot * C::kAStage);
    uint8_t* bs = b_s + slot * C::kBStage;
    const int k0 = kt * kBK;
    const int r0 = kt * (kBK / 2);
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      if (vec) {
        for (int i = tid; i < C::BM * (kBK / 8); i += C::kThreads) {
          const int row = i / (kBK / 8);
          const int ch = i % (kBK / 8);
          const int gm = m0 + row;
          const int gk = k0 + ch * 8;
          const bool ok = gm < M && gk < K;
          sis::cp_async16(as + row * kArow + ch * 8, ok ? x + (size_t)gm * K + gk : x, ok);
        }
      }
    }
    if (!vec || !std::is_same<TX, __nv_bfloat16>::value) {
      for (int i = tid; i < C::BM * kBK; i += C::kThreads) {
        const int row = i / kBK;
        const int kk = i % kBK;
        const int gm = m0 + row;
        const int gk = k0 + kk;
        const float v = (gm < M && gk < K) ? sis::to_f(x[(size_t)gm * K + gk]) : 0.f;
        as[row * kArow + kk] = __float2bfloat16_rn(v);
      }
    }
    if (vec) {
      for (int i = tid; i < (kBK / 2) * (C::BN / 16); i += C::kThreads) {
        const int r = i / (C::BN / 16);
        const int ch = i % (C::BN / 16);
        const int gr = r0 + r;
        const int gn = n0 + ch * 16;
        const bool ok = gr < khalf && gn < N;
        sis::cp_async16(bs + r * C::kBrow + ch * 16, ok ? w + (size_t)gr * N + gn : w, ok);
      }
    } else {
      for (int i = tid; i < (kBK / 2) * C::BN; i += C::kThreads) {
        const int r = i / C::BN;
        const int nn = i % C::BN;
        const int gr = r0 + r;
        const int gn = n0 + nn;
        bs[r * C::kBrow + nn] = (gr < khalf && gn < N) ? w[(size_t)gr * N + gn] : 0;
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(kt0 + s, s);
    sis::cp_async_commit();
  }

  for (int t = 0; t < nk; ++t) {
    sis::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t has landed; stage t - 1 is free for the next load
    if (t + kStages - 1 < nk) load(kt0 + t + kStages - 1, (t + kStages - 1) % kStages);
    sis::cp_async_commit();

    const int slot = t % kStages;
    const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(a_s + slot * C::kAStage);
    const uint8_t* bs = b_s + slot * C::kBStage + wn * 32 + g * 4;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        sis::ldmatrix_x4(a[i], as + (wm * MT * 16 + i * 16 + lane % 16) * kArow + kk +
                                   (lane / 16) * 8);
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(bs + (kk / 2 + c4) * C::kBrow) ^ 0x88888888u;
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(bs + (kk / 2 + 4 + c4) * C::kBrow) ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b0 = unpack_pair(w0 >> (8 * j));
        const uint32_t b1 = unpack_pair(w1 >> (8 * j));
#pragma unroll
        for (int i = 0; i < MT; ++i) sis::mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  sis::cp_async_wait<0>();

  // lane (g, c4) holds, for rows g and g + 8 of each m16 tile, the warp's
  // columns 8 c4 .. 8 c4 + 7: n-tile j's d0 / d2 at 8 c4 + j, d1 / d3 at
  // 8 c4 + 4 + j
  const int col = n0 + wn * 32 + c4 * 8;
  const bool full = (N % 4 == 0) && col + 8 <= N;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = (ws == nullptr && col + e < N) ? scale[col + e] : 1.f;
  float* out = ws == nullptr ? y : ws + (size_t)split * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * h] * sc[j];
        v[4 + j] = acc[i][j][2 * h + 1] * sc[4 + j];
      }
      float* dst = out + (size_t)row * N + col;
      if (full) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < N) dst[e] = v[e];
      }
    }
  }
}

// y = (sum over splits of ws[s]) * scale, the splits added in order
__global__ void int4_splitk_reduce(const float* __restrict__ ws, const float* __restrict__ scale,
                                   float* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  if (N % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    float4* y4 = reinterpret_cast<float4*>(y);
    const size_t q = total / 4;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < q; i += step) {
      float4 s = w4[i];
      for (int p = 1; p < splits; ++p) {
        const float4 t = w4[(size_t)p * q + i];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      const int n = (int)((i * 4) % N);
      y4[i] = make_float4(s.x * scale[n], s.y * scale[n + 1], s.z * scale[n + 2],
                          s.w * scale[n + 3]);
    }
  } else {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
      float s = ws[i];
      for (int p = 1; p < splits; ++p) s += ws[(size_t)p * total + i];
      y[i] = s * scale[i % N];
    }
  }
}

template <typename TX, int MT, int WM, int WN>
int launch(const void* x, const void* w, const void* scale, void* y, void* ws, int M, int N,
           int K, int splits, cudaStream_t st) {
  using C = Cfg<MT, WM, WN>;
  auto kernel = int4_matmul_mma<TX, MT, WM, WN>;
  if (C::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec = aligned && K % 8 == 0 && N % 16 == 0;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y),
      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t work = (N % 4 == 0 ? (size_t)M * N / 4 : (size_t)M * N);
  const int blocks = (int)std::min<size_t>((work + 255) / 256, 4096);
  int4_splitk_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                              static_cast<const float*>(scale),
                                              static_cast<float*>(y), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// the tile variants of ops/matmul_kernels.py:INT4_TILES, by index
template <typename TX>
int launch_variant(int variant, const void* x, const void* w, const void* scale, void* y,
                   void* ws, int M, int N, int K, int splits, cudaStream_t st) {
  switch (variant) {
    case 0: return launch<TX, 1, 1, 4>(x, w, scale, y, ws, M, N, K, splits, st);  // 16 x 128
    case 1: return launch<TX, 2, 2, 4>(x, w, scale, y, ws, M, N, K, splits, st);  // 64 x 128
    case 2: return launch<TX, 4, 2, 4>(x, w, scale, y, ws, M, N, K, splits, st);  // 128 x 128
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ws: f32 [splits, M, N] when splits > 1 (else unused); variant and splits
// come from ops/matmul_kernels.py:int4_matmul_plan
extern "C" int sis_int4_matmul(const void* x, const void* w_p4, const void* scale, void* y,
                               void* ws, int M, int N, int K, int x_dtype, int variant,
                               int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int KT = (K + kBK - 1) / kBK;
  if (M <= 0 || N <= 0 || K <= 0 || K % 2 != 0 || splits < 1 || splits > KT ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == sis::kBF16)
    return launch_variant<__nv_bfloat16>(variant, x, w_p4, scale, y, ws, M, N, K, splits, s);
  return launch_variant<float>(variant, x, w_p4, scale, y, ws, M, N, K, splits, s);
}
