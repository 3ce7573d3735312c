// Tensor-core body of the three quantized matmul kernels:
// int4_matmul (K1), int8_matmul (K2) and int4_matmul_w4a8 (K6).
//
//   y[M,N] f32 = (x[M,K] @ W[K,N]) * scale[N]           (K1, K2)
//   y[M,N] f32 = (x_q[M,K] @ W[K,N]) * x_scale[M] * scale[N]   (K6)
//
// The weight lives in device memory in its quantized bytes only: K1 and
// K6 read the pairwise-packed int4 weight [K/2, N] (low nibble = row 2a,
// high nibble = row 2a + 1), K2 the int8 weight [K, N]. It is unpacked in
// registers, straight into mma B fragments, and never exists unpacked in
// memory.
//
// One body, three policies (the `Op` template argument):
//
//   Int4Bf16<TX> (K1)  A = bf16(x) (x f32 or bf16), B = int4, mma.sync
//                      m16n8k16 bf16 -> f32. One packed byte holds the two
//                      consecutive k of one B-fragment register; bits
//                      0x4300 | (nibble ^ 8) are 136 + nibble in bf16, so
//                      one bf16x2 fma makes the pair exactly.
//   Int8Bf16<TX> (K2)  A = bf16(x), B = int8, mma.sync m16n8k16 bf16 ->
//                      f32. 0x4300 | u is exact in bf16 only for u < 128
//                      (8 significand bits), so a byte goes through f32:
//                      the bits 0x4B0000uu (u = v + 128, placed by one
//                      prmt) are 2^23 + u exactly, minus 2^23 + 128 is v,
//                      and cvt.rn.bf16x2.f32 packs two (exact for |v| <=
//                      128). Every product is the plain version's.
//   Int4S8 (K6)        A = int8 activations, B = int4, mma.sync m16n8k32
//                      s8 x s8 -> s32. A B register is 4 consecutive k of
//                      one column: two packed bytes, nibbles masked and
//                      ordered by prmt, sign-extended bytewise
//                      (b | ((b & 0x08) * 0x1E) sets the high nibble of a
//                      negative value; no carry crosses a byte). The sum
//                      is exact in int32; it is converted to f32 once and
//                      scaled as (acc * x_scale[m]) * scale[n], so the
//                      result equals the float64 plain version bit for
//                      bit.
//
// Columns: each warp owns 32 output columns and numbers them so that mma
// column c of n-tile j is warp column 4c + j. A lane's four n-tiles then
// read 4 consecutive bytes of a weight row, one 32-bit shared load, and
// byte j feeds n-tile j. The accumulators come out as 8 consecutive
// columns per lane and row (two 16-byte stores).
//
// Staging: a ring of 3 stages of 64 k. A rows are padded (bf16: 144
// bytes, int8: 80 bytes) so ldmatrix reads fragments without bank
// conflicts; weight rows are padded so the lanes' 32-bit reads hit 32
// banks (K1 reads rows c apart: 160-byte rows; K2 and K6 read rows 2c
// apart: 144-byte rows). Both are copied 16 bytes a thread by cp.async
// (zero-filled past M, N and K); rows that are not 16-byte multiples
// (K % 8 for bf16, K % 16 for int8, N % 16) and f32 x load element by
// element into the same ring, so a ragged N is masked in the kernel with
// no padded weight copy.
//
// Filling 132 SMs: three tile variants (BM = 16, 64, 128 rows by BN =
// 128 columns) and a split of K chosen by a plan in
// ops/matmul_kernels.py, so that every main-path shape launches at least
// one block per SM. The 16- and 64-row tiles give each of their 4 warps
// every row of the tile, so a weight fragment is unpacked once for all
// of them; on the H100 the 64-row tile, twice over, also beat the
// 128-row one (two warps a column) at 128 rows, which it takes up to.
// Split s takes k-tiles [s KT / S, (s + 1) KT / S), never empty. Partial sums (f32, or int32 for K6) go to a workspace and
// a second kernel adds them in split order and applies the scales: no
// atomics, the same bits on every run.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace sis {
namespace qmm {

constexpr int kBK = 64;  // k per stage
constexpr int kStages = 3;

template <int MT, int WM, int WN>  // m16 tiles per warp, warps along M and along N
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 32 * WN;
};

struct Args {
  const void* x;         // [M, K] activations (Op::X)
  const float* x_scale;  // [M] per-row activation scales (K6), else null
  const uint8_t* w;      // weight bytes, Op::kBRows rows per 64 k, N columns
  const float* scale;    // [N]
  float* y;              // [M, N]
  void* ws;              // [splits, M, N] Op::Acc partial sums when split, else null
  int M, N, K;
};

__device__ __forceinline__ uint32_t ld_shared32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16 x 32 s8) * b (32 x 8 s8), s32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- A operands ----------------------------------------------------------------

// x (f32 or bf16) staged as bf16 rows of 64 k, 144 bytes apart
template <typename TX>
struct Bf16Rows {
  using X = TX;
  static constexpr int kPitch = (kBK + 8) * 2;

  __host__ static bool vectorized(const void* x, int K) {
    return std::is_same<TX, __nv_bfloat16>::value && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           K % 8 == 0;
  }
  template <int BM, int NT>
  __device__ static void load(unsigned char* dst, const TX* x, int m0, int k0, int M, int K,
                              int tid, bool vec) {
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(dst);
    constexpr int kRow = kPitch / 2;
    if (vec) {
      for (int i = tid; i < BM * (kBK / 8); i += NT) {
        const int row = i / (kBK / 8);
        const int ch = i % (kBK / 8);
        const int gm = m0 + row;
        const int gk = k0 + ch * 8;
        const bool ok = gm < M && gk < K;
        cp_async16(as + row * kRow + ch * 8, ok ? x + (size_t)gm * K + gk : x, ok);
      }
      return;
    }
    for (int i = tid; i < BM * kBK; i += NT) {
      const int row = i / kBK;
      const int kk = i % kBK;
      const int gm = m0 + row;
      const int gk = k0 + kk;
      const float v = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
      as[row * kRow + kk] = __float2bfloat16_rn(v);
    }
  }
  // the m16 x k16 A fragment of rows r0.. at k `kk`
  __device__ static void frag(uint32_t (&a)[4], const unsigned char* as, int r0, int kk,
                              int lane) {
    ldmatrix_x4(a, as + (r0 + lane % 16) * kPitch + kk * 2 + (lane / 16) * 16);
  }
};

// int8 x staged as rows of 64 k, 80 bytes apart
struct S8Rows {
  using X = int8_t;
  static constexpr int kPitch = kBK + 16;

  __host__ static bool vectorized(const void* x, int K) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 16 == 0;
  }
  template <int BM, int NT>
  __device__ static void load(unsigned char* dst, const int8_t* x, int m0, int k0, int M, int K,
                              int tid, bool vec) {
    if (vec) {
      for (int i = tid; i < BM * (kBK / 16); i += NT) {
        const int row = i / (kBK / 16);
        const int ch = i % (kBK / 16);
        const int gm = m0 + row;
        const int gk = k0 + ch * 16;
        const bool ok = gm < M && gk < K;
        cp_async16(dst + row * kPitch + ch * 16, ok ? x + (size_t)gm * K + gk : x, ok);
      }
      return;
    }
    for (int i = tid; i < BM * kBK; i += NT) {
      const int row = i / kBK;
      const int kk = i % kBK;
      const int gm = m0 + row;
      const int gk = k0 + kk;
      dst[row * kPitch + kk] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0;
    }
  }
  // the m16 x k32 A fragment of rows r0.. at k `kk`
  __device__ static void frag(uint32_t (&a)[4], const unsigned char* as, int r0, int kk,
                              int lane) {
    ldmatrix_x4(a, as + (r0 + lane % 16) * kPitch + kk + (lane / 16) * 16);
  }
};

// -- B unpacking -----------------------------------------------------------------

// one packed int4 byte (nibbles XOR 8, in bits 0..7) -> bf16x2 (row 2a low, 2a+1 high)
__device__ __forceinline__ uint32_t int4_pair_bf16(uint32_t t) {
  const uint32_t r = (t & 0x0000000Fu) | ((t << 12) & 0x000F0000u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;  // (128 + nibble + 8) * 1 - 136, exact
}

// byte J of `u` (an int8 value v stored as v + 128) -> v as f32, exactly
template <int J>
__device__ __forceinline__ float biased_byte(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | J)) - 8388736.f;  // 2^23 + 128
}

// sign-extend the nibbles held in the low half of each byte
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t b) {
  return b | ((b & 0x08080808u) * 0x1Eu);
}

// two packed rows (k 4c, 4c + 1 | 4c + 2, 4c + 3) of 4 columns -> the s8x4
// B registers of those 4 columns (4 consecutive k each)
__device__ __forceinline__ void int4_quads_s8(uint32_t r0, uint32_t r1, uint32_t (&b)[4]) {
  const uint32_t lo0 = r0 & 0x0F0F0F0Fu, hi0 = (r0 >> 4) & 0x0F0F0F0Fu;
  const uint32_t lo1 = r1 & 0x0F0F0F0Fu, hi1 = (r1 >> 4) & 0x0F0F0F0Fu;
  const uint32_t p0 = __byte_perm(lo0, hi0, 0x5140), q0 = __byte_perm(lo0, hi0, 0x7362);
  const uint32_t p1 = __byte_perm(lo1, hi1, 0x5140), q1 = __byte_perm(lo1, hi1, 0x7362);
  b[0] = sext_nibbles(__byte_perm(p0, p1, 0x5410));
  b[1] = sext_nibbles(__byte_perm(p0, p1, 0x7632));
  b[2] = sext_nibbles(__byte_perm(q0, q1, 0x5410));
  b[3] = sext_nibbles(__byte_perm(q0, q1, 0x7632));
}

// -- the three policies ------------------------------------------------------------
//
// Each gives: A (the staging of x), Acc, kBRows (weight byte rows per 64
// k), kBPad (padding of a staged weight row), stage() (the mma of one
// staged k-tile; `bs` points at the lane's 4 bytes of weight row 0) and
// finish() (an accumulated sum -> the f32 output).

template <typename TX>
struct Int4Bf16 {
  using A = Bf16Rows<TX>;
  using Acc = float;
  static constexpr int kBRows = kBK / 2;
  static constexpr int kBPad = 32;

  template <int MT, int BP>
  __device__ static void stage(float (&acc)[MT][4][4], const unsigned char* as,
                               const uint8_t* bs, int lane) {
    const int c4 = lane % 4;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) A::frag(a[i], as, i * 16, kk, lane);
      const uint32_t w0 = ld_shared32(bs + (kk / 2 + c4) * BP) ^ 0x88888888u;
      const uint32_t w1 = ld_shared32(bs + (kk / 2 + 4 + c4) * BP) ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b0 = int4_pair_bf16(w0 >> (8 * j));
        const uint32_t b1 = int4_pair_bf16(w1 >> (8 * j));
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  __device__ static float finish(float v, const float*, int, float sc) { return v * sc; }
};

template <typename TX>
struct Int8Bf16 {
  using A = Bf16Rows<TX>;
  using Acc = float;
  static constexpr int kBRows = kBK;
  static constexpr int kBPad = 16;

  template <int J>
  __device__ static uint32_t pair(uint32_t lo, uint32_t hi) {
    return pack_bf16x2(biased_byte<J>(lo), biased_byte<J>(hi));
  }
  template <int MT, int BP>
  __device__ static void stage(float (&acc)[MT][4][4], const unsigned char* as,
                               const uint8_t* bs, int lane) {
    const uint8_t* r = bs + 2 * (lane % 4) * BP;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) A::frag(a[i], as, i * 16, kk, lane);
      // rows kk + 2c, + 1 (b0) and kk + 2c + 8, + 9 (b1), each byte + 128
      const uint8_t* rk = r + kk * BP;
      const uint32_t w00 = ld_shared32(rk) ^ 0x80808080u;
      const uint32_t w01 = ld_shared32(rk + BP) ^ 0x80808080u;
      const uint32_t w10 = ld_shared32(rk + 8 * BP) ^ 0x80808080u;
      const uint32_t w11 = ld_shared32(rk + 9 * BP) ^ 0x80808080u;
      uint32_t b0[4], b1[4];
      b0[0] = pair<0>(w00, w01);
      b0[1] = pair<1>(w00, w01);
      b0[2] = pair<2>(w00, w01);
      b0[3] = pair<3>(w00, w01);
      b1[0] = pair<0>(w10, w11);
      b1[1] = pair<1>(w10, w11);
      b1[2] = pair<2>(w10, w11);
      b1[3] = pair<3>(w10, w11);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0[j], b1[j]);
    }
  }
  __device__ static float finish(float v, const float*, int, float sc) { return v * sc; }
};

struct Int4S8 {
  using A = S8Rows;
  using Acc = int;
  static constexpr int kBRows = kBK / 2;
  static constexpr int kBPad = 16;

  template <int MT, int BP>
  __device__ static void stage(int (&acc)[MT][4][4], const unsigned char* as, const uint8_t* bs,
                               int lane) {
    const uint8_t* r = bs + 2 * (lane % 4) * BP;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) A::frag(a[i], as, i * 16, kk, lane);
      // packed rows kk/2 + 2c, + 1 (k 4c .. 4c + 3) and + 8, + 9 (k 16 + 4c ..)
      const uint8_t* rk = r + (kk / 2) * BP;
      uint32_t b0[4], b1[4];
      int4_quads_s8(ld_shared32(rk), ld_shared32(rk + BP), b0);
      int4_quads_s8(ld_shared32(rk + 8 * BP), ld_shared32(rk + 9 * BP), b1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b0[j], b1[j]);
    }
  }
  __device__ static float finish(int v, const float* xs, int m, float sc) {
    return (__int2float_rn(v) * xs[m]) * sc;
  }
};

// -- the kernel ------------------------------------------------------------------------

template <typename Op, int MT, int WM, int WN>
struct Layout {
  using T = Tile<MT, WM, WN>;
  static constexpr int kBPitch = T::BN + Op::kBPad;
  static constexpr int kAStage = T::BM * Op::A::kPitch;
  static constexpr int kBStage = Op::kBRows * kBPitch;
  static constexpr int kSmem = kStages * (kAStage + kBStage);
};

template <typename Op, int MT, int WM, int WN>
__global__ void __launch_bounds__(Tile<MT, WM, WN>::kThreads, 2)  // 2 blocks an SM: <= 128 registers
matmul_mma(Args args, int vec_a, int vec_b) {
  using T = Tile<MT, WM, WN>;
  using L = Layout<Op, MT, WM, WN>;
  using X = typename Op::A::X;
  using Acc = typename Op::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_s = smem;                         // [stage][BM][A pitch]
  uint8_t* b_s = smem + kStages * L::kAStage;        // [stage][kBRows][kBPitch]

  const X* x = static_cast<const X*>(args.x);
  const uint8_t* w = args.w;
  const int M = args.M, N = args.N, K = args.K;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int n0 = blockIdx.x * T::BN;
  const int m0 = blockIdx.y * T::BM;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int wrows = (int)((long long)K * Op::kBRows / kBK);  // weight byte rows
  const int KT = (K + kBK - 1) / kBK;
  const int kt0 = (int)((long long)split * KT / splits);
  const int nk = (int)((long long)(split + 1) * KT / splits) - kt0;

  auto load = [&](int kt, int slot) {
    Op::A::template load<T::BM, T::kThreads>(a_s + slot * L::kAStage, x, m0, kt * kBK, M, K, tid,
                                             vec_a);
    uint8_t* bs = b_s + slot * L::kBStage;
    const int r0 = kt * Op::kBRows;
    if (vec_b) {
      for (int i = tid; i < Op::kBRows * (T::BN / 16); i += T::kThreads) {
        const int r = i / (T::BN / 16);
        const int ch = i % (T::BN / 16);
        const int gr = r0 + r;
        const int gn = n0 + ch * 16;
        const bool ok = gr < wrows && gn < N;
        cp_async16(bs + r * L::kBPitch + ch * 16, ok ? w + (size_t)gr * N + gn : w, ok);
      }
    } else {
      for (int i = tid; i < Op::kBRows * T::BN; i += T::kThreads) {
        const int r = i / T::BN;
        const int nn = i % T::BN;
        const int gr = r0 + r;
        const int gn = n0 + nn;
        bs[r * L::kBPitch + nn] = (gr < wrows && gn < N) ? w[(size_t)gr * N + gn] : 0;
      }
    }
  };

  Acc acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(kt0 + s, s);
    cp_async_commit();
  }

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t has landed; stage t - 1 is free for the next load
    if (t + kStages - 1 < nk) load(kt0 + t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const int slot = t % kStages;
    Op::template stage<MT, L::kBPitch>(
        acc, a_s + slot * L::kAStage + wm * MT * 16 * Op::A::kPitch,
        b_s + slot * L::kBStage + wn * 32 + g * 4, lane);
  }
  cp_async_wait<0>();

  // lane (g, c4) holds, for rows g and g + 8 of each m16 tile, the warp's
  // columns 8 c4 .. 8 c4 + 7: n-tile j's d0 / d2 at 8 c4 + j, d1 / d3 at
  // 8 c4 + 4 + j
  const int col = n0 + wn * 32 + c4 * 8;
  const bool full = (N % 4 == 0) && col + 8 <= N;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = col + e < N ? args.scale[col + e] : 1.f;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
      if (row >= M) continue;
      Acc v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * h];
        v[4 + j] = acc[i][j][2 * h + 1];
      }
      if (args.ws != nullptr) {  // raw partial sums of this split
        Acc* dst = static_cast<Acc*>(args.ws) + ((size_t)split * M + row) * N + col;
        if (full) {
          using V = typename std::conditional<std::is_same<Acc, float>::value, float4, int4>::type;
          reinterpret_cast<V*>(dst)[0] = V{v[0], v[1], v[2], v[3]};
          reinterpret_cast<V*>(dst)[1] = V{v[4], v[5], v[6], v[7]};
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < N) dst[e] = v[e];
        }
        continue;
      }
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = Op::finish(v[e], args.x_scale, row, sc[e]);
      float* dst = args.y + (size_t)row * N + col;
      if (full) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < N) dst[e] = o[e];
      }
    }
  }
}

// y = finish(sum over splits of ws[s]), the splits added in order
template <typename Op>
__global__ void splitk_reduce(Args args, int splits) {
  using Acc = typename Op::Acc;
  const Acc* ws = static_cast<const Acc*>(args.ws);
  const int M = args.M, N = args.N;
  const size_t total = (size_t)M * N;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  if (N % 4 == 0) {
    using V = typename std::conditional<std::is_same<Acc, float>::value, float4, int4>::type;
    const V* w4 = reinterpret_cast<const V*>(ws);
    float4* y4 = reinterpret_cast<float4*>(args.y);
    const size_t q = total / 4;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < q; i += step) {
      V s = w4[i];
      for (int p = 1; p < splits; ++p) {
        const V t = w4[(size_t)p * q + i];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      const int m = (int)((i * 4) / N);
      const int n = (int)((i * 4) % N);
      const float* sc = args.scale;
      y4[i] = make_float4(Op::finish(s.x, args.x_scale, m, sc[n]),
                          Op::finish(s.y, args.x_scale, m, sc[n + 1]),
                          Op::finish(s.z, args.x_scale, m, sc[n + 2]),
                          Op::finish(s.w, args.x_scale, m, sc[n + 3]));
    }
  } else {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
      Acc s = ws[i];
      for (int p = 1; p < splits; ++p) s += ws[(size_t)p * total + i];
      args.y[i] = Op::finish(s, args.x_scale, (int)(i / N), args.scale[i % N]);
    }
  }
}

template <typename Op, int MT, int WM, int WN>
int launch_tile(const Args& args, int splits, cudaStream_t st) {
  using T = Tile<MT, WM, WN>;
  using L = Layout<Op, MT, WM, WN>;
  auto kernel = matmul_mma<Op, MT, WM, WN>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec_a = Op::A::vectorized(args.x, args.K);
  const int vec_b = reinterpret_cast<uintptr_t>(args.w) % 16 == 0 && args.N % 16 == 0;
  const dim3 grid((args.N + T::BN - 1) / T::BN, (args.M + T::BM - 1) / T::BM, splits);
  Args a = args;
  if (splits == 1) a.ws = nullptr;
  kernel<<<grid, T::kThreads, L::kSmem, st>>>(a, vec_a, vec_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t work = (args.N % 4 == 0 ? (size_t)args.M * args.N / 4 : (size_t)args.M * args.N);
  const int blocks = (int)std::min<size_t>((work + 255) / 256, 4096);
  splitk_reduce<Op><<<blocks, 256, 0, st>>>(args, splits);
  return static_cast<int>(cudaGetLastError());
}

// Checks the arguments and launches tile variant `variant` (the index
// into ops/matmul_kernels.py:QMM_TILES) with `splits` ranges of K.
template <typename Op>
int launch(const Args& args, int variant, int splits, cudaStream_t st) {
  const int KT = (args.K + kBK - 1) / kBK;
  if (args.M <= 0 || args.N <= 0 || args.K <= 0 || (Op::kBRows < kBK && args.K % 2 != 0) ||
      splits < 1 || splits > KT || (splits > 1 && args.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return launch_tile<Op, 1, 1, 4>(args, splits, st);  // 16 x 128
    case 1: return launch_tile<Op, 4, 1, 4>(args, splits, st);  // 64 x 128
    case 2: return launch_tile<Op, 4, 2, 4>(args, splits, st);  // 128 x 128
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace qmm
}  // namespace sis
