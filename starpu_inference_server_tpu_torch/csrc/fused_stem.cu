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
// margin of zp) take no part in the pool, as _stem_kernel zeroes its
// row -1. The TPU wrapper's pre-expanded column taps work around a
// Mosaic limit; this kernel reads zp directly.
//
// Bound on the H100: per image 2*112*112*192*64 = 308 MFLOP against
// 0.33 MB in and 0.4 MB out; at the bf16 tensor-core rate the operations
// (10 us at B = 32) outweigh the bytes (7 us), so operations bound it.
//
// Design: an implicit GEMM on the tensor cores (wgmma m64n64k16, bf16 in,
// f32 sums), M = conv positions, N = 64 channels, K = 192 taps, with BN,
// ReLU and the pool fused behind it; the conv activation never reaches
// device memory. A work item is a tile of 7 x 8 pooled outputs (all 64
// channels) of one image: its 15 x 17 conv positions, flattened row by
// row into 16 m16 tiles. A block is two warpgroups; each runs two m64
// blocks of positions against the whole weight.
//  - A from registers. For a fixed row tap s the 48 taps of conv position
//    (p, q) are zp[p+s+1, q+1..q+4, 0..11], 96 contiguous bytes of the
//    staged patch, so K = 4 row taps x 3 k16 steps and an A fragment is
//    shared loads at a per-thread offset plus constants. A pixel is 24
//    bytes, so half the positions start off a 16-byte boundary: no
//    ldmatrix, and no wgmma A descriptor, without padding the channels to
//    16 (+33% MMA). Inside each k16 step the taps are permuted so that a
//    thread's two k pairs (2c, 2c+8) are the adjacent taps 4c..4c+3: one
//    64-bit load for a0/a2, one for a1/a3. Fragment row m of an m16 tile
//    is position 4 (m % 4) + m / 4, so the 16 lanes of a load phase read
//    8-word windows 96 bytes apart: 32 distinct banks. The next k16
//    step's fragments load while the tensor cores run this one.
//  - B from shared memory: the weight, staged once per block (cp.async of
//    the raw [192][64], then one shared-to-shared pass), as K-major 8 x 8
//    core matrices with the same tap permutation, no swizzle.
//  - Blocks loop over work items (grid = items, or fewer: persistent, see
//    ops/stem_kernel.py:stem_plan), and the next item's zp patch streams
//    in by cp.async while this one computes, into the second of two patch
//    buffers.
//  - Epilogue: BN + ReLU on the accumulators into a shared y tile (bf16
//    for bf16 output: rounding is monotone, so the max of rounded values
//    is the rounded max, and bf16 maxima take two channels an
//    instruction), then the 3x3/2 pool from there, 8 channels a thread,
//    skipping the positions outside the image. Two blocks fit an SM
//    (81 KB of shared memory for bf16 output, 114 registers).

#include <type_traits>

#include "common.cuh"

namespace {

using sis::cp_async16;

constexpr int kH = 118;                    // padded s2d height and width
constexpr int kCin = 12;
constexpr int kCout = 64;
constexpr int kTaps = 16 * kCin;           // 192
constexpr int kOut = 56;                   // pooled height and width
constexpr int kPR = 7;                     // pooled rows of a work item
constexpr int kPC = 8;                     // pooled cols of a work item
constexpr int kColTiles = kOut / kPC;      // 7
constexpr int kYC = 2 * kPC + 1;           // 17 conv cols of a work item
constexpr int kZC = kYC + 3;               // 20 patch pixels a row
constexpr int kZRowBytes = kZC * kCin * 2; // 480
// patch row pitch: a multiple of 16 (cp.async) whose step over the 17
// positions of a row (528 - 17 * 24 = 120 bytes) is -2 banks, so an m16
// tile that wraps to the next conv row stays close to conflict-free
constexpr int kZPitch = 528;
// the weight for wgmma: B^T as K-major 8 x 8 core matrices, 128 bytes
// apart along K, 24 x 128 apart along N
constexpr int kLBO = 128, kSBO = 24 * 128;
constexpr int kYR = 2 * kPR + 1;           // 15 conv rows of a work item
constexpr int kZR = kYR + 3;               // 18 patch rows
constexpr int kPos = kYR * kYC;            // 255 conv positions
constexpr int kMT = (kPos + 15) / 16;      // 16 m16 tiles
constexpr int kMW = 2;                     // m64 blocks a warpgroup (m16 tiles a warp)
constexpr int kWarps = kMT / kMW;          // 8: two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTiles = kOut / kPR;
constexpr int kItems = kRowTiles * kColTiles;  // work items of an image
constexpr int kZBytes = kZR * kZPitch;
constexpr int kWBytes = kTaps * kCout * 2;
static_assert(kOut % kPR == 0, "tile rows must divide 56");
static_assert(kMT % (4 * kMW) == 0, "whole warpgroups of m64 blocks");

// y tile row pitch in elements: the epilogue's stores of one warp land on
// 32 banks (f32, 8 bytes a lane) or on two wavefronts (bf16, whose rows
// stay 16-byte aligned for the pool's loads)
template <typename TO>
__host__ __device__ constexpr int y_pitch() { return sizeof(TO) == 4 ? kCout + 2 : kCout + 8; }

template <typename TO>
constexpr size_t smem_bytes() {
  return kWBytes + 2 * kCout * 4 + 2 * kZBytes + (size_t)kPos * y_pitch<TO>() * sizeof(TO);
}

// y tile element types: bf16 output keeps a bf16 tile, f32 an f32 one
template <typename TO>
__device__ __forceinline__ void store_pair(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = sis::pack_bf16x2(a, b);
}

// the running max of 8 channels of the y tile, in its own type: a bf16
// max is exact, two channels an instruction
struct Max8F32 {
  float2 m[4];
  __device__ __forceinline__ Max8F32() {
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void take(const float* p) {  // 8-byte aligned rows
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = reinterpret_cast<const float2*>(p)[k];
      m[k] = make_float2(fmaxf(m[k].x, x.x), fmaxf(m[k].y, x.y));
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = make_float4(m[0].x, m[0].y, m[1].x, m[1].y);
    reinterpret_cast<float4*>(p)[1] = make_float4(m[2].x, m[2].y, m[3].x, m[3].y);
  }
};
struct Max8BF16 {
  __nv_bfloat162 m[4];
  __device__ __forceinline__ Max8BF16() {
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = __float2bfloat162_rn(0.f);
  }
  __device__ __forceinline__ void take(const __nv_bfloat16* p) {  // 16-byte aligned rows
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = __hmax2(m[k], *reinterpret_cast<const __nv_bfloat162*>(&v[k]));
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(m);
  }
};
template <typename TO>
using Max8 = std::conditional_t<sizeof(TO) == 4, Max8F32, Max8BF16>;

// wgmma (sm_90a), A from registers: the warpgroup's D [64 x 64] (f32, each
// warp's 16 rows in the m16n8k16 C layout, d[n] the n-th 8 columns) +=
// A [64 x 16] (each warp's 16 rows as an m16n8k16 A fragment) x B [16 x 64]
// read from shared memory through the descriptor
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the shared-memory descriptor of the weight's k16 step at `p`, without
// swizzle: K-major core matrices of 8 rows x 16 bytes, kLBO bytes apart
// along K and kSBO bytes apart along N
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((sis::smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep registers that an in-flight wgmma reads or writes where they are
// until this point
__device__ __forceinline__ void hold(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void hold(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void stage_patch(char* z_s, const __nv_bfloat16* zp, int item) {
  const int b = item / kItems;
  const int rt = (item / kColTiles) % kRowTiles;
  const int ct = item % kColTiles;
  // conv row 2 kPR rt - 1 + r reads zp rows from 2 kPR rt + r on; likewise cols
  const char* src = reinterpret_cast<const char*>(
      zp + (((size_t)b * kH + 2 * kPR * rt) * kH + 2 * kPC * ct) * kCin);
  constexpr int kChunks = kZRowBytes / 16;  // 30 a row
  for (int i = threadIdx.x; i < kZR * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    cp_async16(z_s + r * kZPitch + ch * 16, src + (size_t)r * kH * kCin * 2 + ch * 16, true);
  }
}

// the A fragments of k16 step kk (row tap kk / 3, taps 16 (kk % 3) on)
// of a warp's m16 tiles: two 64-bit loads each
__device__ __forceinline__ void load_a(uint32_t (&a)[kMW][4], const char* zb,
                                       const int (&a_off)[kMW][2], int kk) {
#pragma unroll
  for (int i = 0; i < kMW; ++i) {
    const int k = (kk / 3) * kZPitch + (kk % 3) * 32;
    const uint2 lo = *reinterpret_cast<const uint2*>(zb + a_off[i][0] + k);
    const uint2 hi = *reinterpret_cast<const uint2*>(zb + a_off[i][1] + k);
    a[i][0] = lo.x, a[i][1] = hi.x, a[i][2] = lo.y, a[i][3] = hi.y;
  }
}

// part `part` of the 3x3/2 pool of work item `item` from its y tile, 8
// channels of one pooled output a thread. Conv row -1 (the first row of
// an image's first row of items) and column -1 lie outside the image and
// are skipped: the window's centre is inside, and every value is >= 0, so
// that is the pool's zero padding.
template <typename TO>
__device__ __forceinline__ void pool(const TO* y_s, TO* out, int item, int part) {
  constexpr int kYPitch = y_pitch<TO>();
  const int e = threadIdx.x + part * kThreads;
  if (e >= kPR * kPC * 8) return;
  const int b = item / kItems;
  const int rt = (item / kColTiles) % kRowTiles;
  const int ct = item % kColTiles;
  const int q8 = (e % 8) * 8;
  const int pj = (e / 8) % kPC;
  const int pi = e / (8 * kPC);
  const bool top = rt == 0 && pi == 0, left = ct == 0 && pj == 0;
  Max8<TO> m;
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dc = 0; dc < 3; ++dc)
      if (!(dr == 0 && top) && !(dc == 0 && left))
        m.take(y_s + ((2 * pi + dr) * kYC + 2 * pj + dc) * kYPitch + q8);
  const int oi = rt * kPR + pi, oj = ct * kPC + pj;
  m.store(out + (((size_t)b * kOut + oi) * kOut + oj) * kCout + q8);
}
constexpr int kPoolParts = (kPR * kPC * 8 + kThreads - 1) / kThreads;  // 2 a thread

template <typename TO>
__global__ void __launch_bounds__(kThreads, 2)
fused_stem_kernel(const __nv_bfloat16* __restrict__ zp, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  TO* __restrict__ out, int n_items) {
  constexpr int kYPitch = y_pitch<TO>();
  extern __shared__ __align__(16) char smem[];
  char* w_s = smem;                                                   // B^T, 24 KB
  float* sc_s = reinterpret_cast<float*>(smem + kWBytes);             // [64]
  float* sh_s = sc_s + kCout;                                         // [64]
  char* z_s = smem + kWBytes + 2 * kCout * 4;                         // 2 x [18][528 B]
  TO* y_s = reinterpret_cast<TO*>(z_s + 2 * kZBytes);                 // [255][kYPitch]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;

  // the weight (in its raw [192][64] order into the y tile's space
  // first), the affine and the first item's patch
  for (int i = tid; i < kTaps * 8; i += kThreads)
    cp_async16(reinterpret_cast<char*>(y_s) + i * 16, w + i * 8, true);
  if (tid < kCout) {
    sc_s[tid] = scale[tid];
    sh_s[tid] = shift[tid];
  }
  int item = blockIdx.x;
  if (item < n_items) stage_patch(z_s, zp, item);
  sis::cp_async_commit();

  // B^T as core matrices, 16 bytes (8 taps of one channel) a store.
  // Inside each k16 step the taps are permuted: tap 4i'+e (e < 2) is the
  // MMA's k = 2i'+e, tap 4i'+2+e its k = 2i'+8+e
  sis::cp_async_wait<0>();
  __syncthreads();
  const __nv_bfloat16* raw = reinterpret_cast<const __nv_bfloat16*>(y_s);
  for (int i = tid; i < kTaps / 8 * kCout; i += kThreads) {
    const int n = i % kCout, kg = i / kCout;  // 8 k: half kg % 2 of step kg / 2
    const __nv_bfloat16* col = raw + ((kg / 2) * 16 + 2 * (kg % 2)) * kCout + n;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)  // k = 8 (kg % 2) + 2q, +1: taps 4q + 2 (kg % 2), +1
      v[q] = (uint32_t)__bfloat16_as_ushort(col[4 * q * kCout]) |
             ((uint32_t)__bfloat16_as_ushort(col[(4 * q + 1) * kCout]) << 16);
    *reinterpret_cast<uint4*>(w_s + (n / 8) * kSBO + kg * kLBO + (n % 8) * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
  // generic-proxy writes that wgmma (the async proxy) will read
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // per-thread byte offsets of the A rows g and g + 8 (positions
  // 4 (g % 4) + g / 4 and 2 more) of each of the warp's m16 tiles in a
  // patch, and the same positions in y
  int a_off[kMW][2];
  int y_pos[kMW][2];
#pragma unroll
  for (int i = 0; i < kMW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // warpgroup wg's m64 blocks 2 wg and 2 wg + 1, warp w % 4 of it
      // rows 16 (w % 4) .. of each
      const int mt = ((warp / 4) * kMW + i) * 4 + warp % 4;
      const int p = mt * 16 + 4 * (g % 4) + g / 4 + 2 * h;
      y_pos[i][h] = p;
      const int pc = min(p, kPos - 1);  // rows past the tile compute a copy
      a_off[i][h] = (pc / kYC) * kZPitch + (pc % kYC) * (kCin * 2) + 8 * c;
    }

  for (int it = 0; item < n_items; item += gridDim.x, ++it) {
    const int next = item + gridDim.x;
    if (next < n_items) stage_patch(z_s + ((it + 1) % 2) * kZBytes, zp, next);
    sis::cp_async_commit();
    sis::cp_async_wait<1>();
    __syncthreads();
    const char* zb = z_s + (it % 2) * kZBytes;

    float acc[kMW][8][4];
#pragma unroll
    for (int i = 0; i < kMW; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

    // one k16 step of A in flight while the next one's fragments load;
    // step kk's weight is core matrices 2 kk and 2 kk + 1 along K
    uint32_t a[2][kMW][4];
    load_a(a[0], zb, a_off, 0);
#pragma unroll
    for (int kk = 0; kk < 12; ++kk) {
      const int cur = kk % 2;
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < kMW; ++i)
        wgmma_m64n64k16(acc[i], a[cur][i], wgmma_desc(w_s + kk * 2 * kLBO));
      wgmma_commit();
      if (kk + 1 < 12) {
        wgmma_wait<1>();  // step kk - 1 is done with a[1 - cur]
#pragma unroll
        for (int i = 0; i < kMW; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) hold(a[1 - cur][i][e]);
        load_a(a[1 - cur], zb, a_off, kk + 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kMW; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) hold(a[0][i][e]), hold(a[1][i][e]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hold(acc[i][n][e]);
    }

    // BN + ReLU into the y tile
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int o = n * 8 + 2 * c;
      const float2 sc = *reinterpret_cast<const float2*>(sc_s + o);
      const float2 sh = *reinterpret_cast<const float2*>(sh_s + o);
#pragma unroll
      for (int i = 0; i < kMW; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (y_pos[i][h] >= kPos) continue;
          const float v0 = fmaxf(fmaf(acc[i][n][2 * h], sc.x, sh.x), 0.f);
          const float v1 = fmaxf(fmaf(acc[i][n][2 * h + 1], sc.y, sh.y), 0.f);
          store_pair<TO>(y_s + y_pos[i][h] * kYPitch + o, v0, v1);
        }
    }
    __syncthreads();
#pragma unroll
    for (int part = 0; part < kPoolParts; ++part) pool(y_s, out, item, part);
    __syncthreads();  // the y tile and this patch buffer are free again
  }
  sis::cp_async_wait<0>();
}

template <typename TO>
int launch(const void* zp, const void* w, const void* scale, const void* shift, void* out,
           int B, int blocks, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<TO>();
  static bool configured = false;  // the attribute is per function: set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_stem_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_items = B * kItems;
  const int grid = (blocks <= 0 || blocks > n_items) ? n_items : blocks;
  fused_stem_kernel<TO><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(zp), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<TO*>(out), n_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks: the grid (<= 0 or more than the work items: one block a work
// item); each block takes every blocks-th work item
extern "C" int sis_fused_stem(const void* zp, const void* w, const void* scale,
                              const void* shift, void* out, int B, int out_dtype, int blocks,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == sis::kBF16)
    return launch<__nv_bfloat16>(zp, w, scale, shift, out, B, blocks, st);
  return launch<float>(zp, w, scale, shift, out, B, blocks, st);
}
