// fused_stem: the ResNet stem in one kernel, from the padded
// space-to-depth input to the pooled activation.
//
//   zp  bf16 [B, 118, 118, 12]  the 2x2 space-to-depth image, padded by 3
//   w   bf16 [192, 64]          the 7x7/s2 conv folded to 4x4/s1 over the
//                               12 s2d channels, rows (s, t, channel)
//   scale, shift f32 [64]       the folded batch-norm affine
//   out [B, 56, 56, 64]         bf16 or f32
//
//   y[p, q, o] = relu(scale[o] * sum_{s,t,c} zp[p+s+1, q+t+1, c] w[(4s+t)*12+c, o]
//                     + shift[o])                       p, q = 0..111
//   out[i, j, o] = max of y over rows 2i-1..2i+1, cols 2j-1..2j+1 (3x3/2
//                  max pool, padding 1)
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/stem_kernel.py
// fused_stem (_stem_kernel). Pool padding is exact as zeros because ReLU
// leaves every value >= 0; conv row -1 and column -1 (computed from the
// zero margin of zp) are zeroed before the pool, as _stem_kernel zeroes
// its row -1. The TPU wrapper's pre-expanded column taps work around a
// Mosaic limit; this kernel reads zp directly.
//
// Bound on the H100: per image 2*112*112*192*64 = 308 MFLOP against
// 0.33 MB in and 0.4 MB out: at the bf16 tensor-core rate the operations
// (10 us at B = 32) outweigh the bytes (7 us), so operations bound it;
// this first kernel computes in f32 on CUDA cores, so its own limit is
// the FMA rate. Design: the conv activation [B, 112, 112, 64] never
// reaches device memory. A block owns a 4 x 8 tile of pooled outputs
// (all 64 channels) of one image: it stages the folded weight (as f32,
// 48 KB) and the 12 x 20 x 12 zp patch the tile needs in shared memory,
// computes the tile's 9 x 17 conv positions (each thread 10 positions x 4
// channels, one float4 weight load feeding 40 FMAs), applies BN and ReLU
// into a 9 x 17 x 64 shared tile, and max-pools from there. 98 KB of
// dynamic shared memory per block.

#include "common.cuh"

namespace {

constexpr int kH = 118;                    // padded s2d height and width
constexpr int kCin = 12;
constexpr int kCout = 64;
constexpr int kTaps = 16 * kCin;           // 192
constexpr int kOut = 56;                   // pooled height and width
constexpr int kConv = 112;                 // conv height and width
constexpr int kPR = 4, kPC = 8;            // pooled rows, cols per block
constexpr int kYR = 2 * kPR + 1;           // 9 conv rows per block
constexpr int kYC = 2 * kPC + 1;           // 17 conv cols per block
constexpr int kZR = kYR + 3, kZC = kYC + 3;  // 12 x 20 zp patch
constexpr int kPos = kYR * kYC;            // 153 conv positions
constexpr int kThreads = 256;
constexpr int kCG = kCout / 4;             // 16 channel groups of 4
constexpr int kPG = kThreads / kCG;        // 16 position groups
constexpr int kPP = (kPos + kPG - 1) / kPG;  // 10 positions per thread
constexpr int kSmemFloats = kTaps * kCout + kZR * kZC * kCin + kPos * kCout;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

template <typename TO>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const __nv_bfloat16* __restrict__ zp, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  TO* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                        // [192][64]
  float* z_s = w_s + kTaps * kCout;         // [12][20][12]
  float* y_s = z_s + kZR * kZC * kCin;      // [153][64]

  const int j0 = blockIdx.x * kPC;
  const int i0 = blockIdx.y * kPR;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int yr0 = 2 * i0 - 1;  // first conv row / col of the tile
  const int yc0 = 2 * j0 - 1;

  for (int i = tid; i < kTaps * kCout; i += kThreads) w_s[i] = __bfloat162float(w[i]);
  // conv row r reads zp rows r+1..r+4: the patch starts at zp row yr0+1
  const __nv_bfloat16* zb = zp + (((size_t)b * kH + (yr0 + 1)) * kH + (yc0 + 1)) * kCin;
  for (int i = tid; i < kZR * kZC * kCin; i += kThreads) {
    const int rr = i / (kZC * kCin);
    const int rem = i % (kZC * kCin);
    z_s[i] = __bfloat162float(zb[(size_t)rr * kH * kCin + rem]);
  }
  __syncthreads();

  const int cg = tid % kCG;
  const int pg = tid / kCG;
  float acc[kPP][4];
  int zbase[kPP];
#pragma unroll
  for (int t = 0; t < kPP; ++t) {
    const int p = min(pg + kPG * t, kPos - 1);
    zbase[t] = ((p / kYC) * kZC + p % kYC) * kCin;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
  }
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int c = 0; c < kCin; ++c) {
        const int tap = (s * 4 + tt) * kCin + c;
        const float4 wv = *reinterpret_cast<const float4*>(w_s + tap * kCout + cg * 4);
        const int off = (s * kZC + tt) * kCin + c;
#pragma unroll
        for (int t = 0; t < kPP; ++t) {
          const float z = z_s[zbase[t] + off];
          acc[t][0] = fmaf(z, wv.x, acc[t][0]);
          acc[t][1] = fmaf(z, wv.y, acc[t][1]);
          acc[t][2] = fmaf(z, wv.z, acc[t][2]);
          acc[t][3] = fmaf(z, wv.w, acc[t][3]);
        }
      }
    }
  }

  // BN + ReLU into the shared tile; conv row/col -1 (outside the image)
  // becomes 0, the identity of the >= 0 max
#pragma unroll
  for (int t = 0; t < kPP; ++t) {
    const int p = pg + kPG * t;
    if (p >= kPos) continue;
    const int gr = yr0 + p / kYC;
    const int gc = yc0 + p % kYC;
    const bool inside = gr >= 0 && gr < kConv && gc >= 0 && gc < kConv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = cg * 4 + j;
      const float v = fmaxf(fmaf(acc[t][j], scale[o], shift[o]), 0.f);
      y_s[p * kCout + o] = inside ? v : 0.f;
    }
  }
  __syncthreads();

  for (int i = tid; i < kPR * kPC * kCout; i += kThreads) {
    const int o = i % kCout;
    const int pj = (i / kCout) % kPC;
    const int pi = i / (kCout * kPC);
    float m = 0.f;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        m = fmaxf(m, y_s[((2 * pi + dr) * kYC + 2 * pj + dc) * kCout + o]);
    out[(((size_t)b * kOut + i0 + pi) * kOut + j0 + pj) * kCout + o] = sis::from_f<TO>(m);
  }
}

template <typename TO>
int launch(const void* zp, const void* w, const void* scale, const void* shift, void* out,
           int B, cudaStream_t st) {
  static bool configured = false;  // the attribute is per function: set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_stem_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(kOut / kPC, kOut / kPR, B);
  fused_stem_kernel<TO><<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(zp), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sis_fused_stem(const void* zp, const void* w, const void* scale,
                              const void* shift, void* out, int B, int out_dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == sis::kBF16)
    return launch<__nv_bfloat16>(zp, w, scale, shift, out, B, st);
  return launch<float>(zp, w, scale, shift, out, B, st);
}
