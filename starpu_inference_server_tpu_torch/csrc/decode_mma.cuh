// Tensor-core, split-context attention over the int8 KV cache: the bf16
// body of the eight decode-side kernels, decode_attention (K3),
// window_decode_attention (K9), paged_decode_attention (K10),
// paged_window_decode_attention (K11) and their FLAT twins (K12a-d).
// Decode is its W = 1 case. The f32 routes keep the CUDA-core bodies of
// common.cuh.
//
//   q / out [S, W, Hq, D] bf16 (decode: [S, Hq, D], W = 1); int8 K/V and
//   f32 scales addressed per (slot, position, KV head) by a `Rows`
//   functor (common.cuh DenseRows / PagedRows, standard or FLAT); lengths
//   int32 [S]. Row w of slot s attends positions <= lengths[s] + w.
//
// Bound on the H100: device-memory bytes. A call reads each live slot's
// int8 K/V rows and their two scales once (136 bytes a position and KV
// head at D = 64) and does 4 * W * rep * D operations on them: at most
// 48 rows, far below the ~295 operations a byte where the tensor cores
// would bind.
//
// Design.
// - Work item: one (KV head, row group, slot, context split). The rows of
//   a KV head are its R = W * rep query rows in (w, rep) order; they are
//   cut into row groups of at most 16 * (256 / D) rows (2 m16 tiles at
//   D = 128, 8 at D = 32) so a thread's accumulators stay at 128 floats,
//   and each group is padded to MT m16 tiles. Every row of a group reads
//   the same K/V, so a K/V byte is read from device memory once a call
//   and group: R fits one group wherever W * rep * D <= 4096 (every
//   decode at D <= 128 up to rep 32, every verify at rep <= 8), and each
//   further group (a verify window at rep 16, MQA's 71 heads, D = 256 at
//   rep 32) reads the KV head's tiles again. The caller cuts the groups
//   (ops/decode_attention.py decode_group_rows: as even as whole rows
//   allow, only the last one shorter) from (R, D) alone, so the grid is
//   fixed for a shape and a CUDA graph of the call replays with any
//   lengths.
// - The block's 4 warps split the keys: the block stages 64-position
//   tiles (int8 K/V rows and their scales) by cp.async into a 2-stage
//   ring (one tile lands while the warps work on the other; 3 and 4
//   stages read no faster on the H100), and warp i takes positions
//   16 i .. 16 i + 15 of every tile with its own running max, sum and
//   accumulator. One __syncthreads a tile.
// - Operands widen in registers, not in shared memory: a lane reads its
//   bytes of a K or V row with one vector load and turns each pair of
//   int8 into a bf16x2 register exactly (int8x2_bf16x2: two logic ops
//   and one fma.rn.bf16x2). To make those loads whole rows, the D axis is
//   renumbered: in Q K^T, lane c takes d = c D/4 .. c D/4 + D/4 - 1 and
//   a 32-bit word of K feeds its k16 step as bytes (0, 2) and (1, 3) (Q
//   is staged in shared memory in the same order and read by ldmatrix),
//   and in P V, column n of output n-tile t is d = n D/8 + t, so a lane
//   reads D/8 consecutive bytes of four V rows. Rows are padded so each
//   vector load is conflict-free. Where a group's rows end at or before
//   16 mt + 8 (decode at rep <= 8), the padding rows g + 8 of m-tile mt
//   skip the softmax.
// - Head dims 32, 64, 80, 96, 128 and 256. At 80 and 96 a lane's bytes of
//   a row are not 16: K's D/4 (20, 24) load as 4- or 8-byte words, V's
//   D/8 (10, 12) as 2- or 4-byte ones, the last word of 10 half used
//   (n-tiles past D/8 are never formed); the staged rows stay whole
//   16-byte copies (80 and 96 are multiples of 16).
// - Scales and precision, as flash_mma.cuh's ChunkKeys: column j of S is
//   multiplied by k_scale[j] and then 1/sqrt(D) in f32 after the mma; a
//   position past a row's limit gets -1e30 and an exact 0 in P (never
//   exp(-1e30 - m) of a row with nothing yet, and never 0 times the NaN
//   scale of an unwritten page); column j of P is multiplied by
//   v_scale[j] in f32 and carried as hi + lo bf16 terms, two mma a tile,
//   so P V keeps f32 precision.
// - The 4 warps merge in shared memory in warp order (each row's factors
//   exp(m_w - m) once, then one pass over the outputs). With one split
//   the block writes `out`; with more, it writes (m, l, acc) in f32 to a
//   workspace and merge_kernel, one block per (KV head, slot, row),
//   combines the splits in split order. No atomics: every call gives the
//   same bits. A split wholly past the slot's last live position,
//   lengths[s] + W - 1, exits at once and the merge, which reads lengths
//   on the device, skips it.
// - What the shapes were chosen from: scripts/torch_decode_attention_probe.py
//   (ring depth, register caps, split counts, and a floor with the
//   arithmetic skipped) on the H100; PERF.md has the readings.
// - The split count is the wrapper's (ops/decode_attention.py
//   decode_split_plan: from static shapes only, so a CUDA graph replays
//   with new lengths); split i owns positions [i L, (i + 1) L) with
//   L = 64 ceil(ceil(T / 64) / splits).
#pragma once

#include "common.cuh"

namespace sis {
namespace dmma {

constexpr int kTile = 64;  // positions a staged tile, 16 a warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;

template <int D>
struct Layout {
  static constexpr int kKRow = D % 128 ? D : D + 16;  // int8 K row pitch
  static constexpr int kVRow = D + 16;              // int8 V row pitch
  static constexpr int kQRow = D + 8;               // bf16 Q row pitch (elements)
  static constexpr int kStage = kTile * (kKRow + kVRow) + 2 * kTile * 4;
  static constexpr size_t kRing = (size_t)kStages * kStage;
  // the warps' partials at the end (m, l, acc rows D + 4 apart) and the
  // rows' maxima, in floats
  __host__ __device__ static constexpr int partial(int mt) { return kWarps * 16 * mt * (D + 6); }
  static size_t bytes(int mt) {
    const size_t q = (size_t)16 * mt * kQRow * 2;
    const size_t merge = sizeof(float) * ((size_t)partial(mt) + 16 * mt);
    return kRing + q > merge ? kRing + q : merge;
  }
};

struct Args {
  const __nv_bfloat16* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* lengths;
  __nv_bfloat16* out;
  float* ws;  // splits > 1: acc [splits, S, Hkv, R, D], then (m, l) [splits, S, Hkv, R, 2]
  int T, W, Hkv, rep, D, splits, span;
  int groups, group_rows;  // row groups of a KV head (blockIdx.x = h * groups + group)
  float inv_sqrt_d;

  __device__ int live(int s) const {  // positions 0 .. live - 1 are attended by some row
    const int n = lengths[s] + W;
    return n < 1 ? 1 : (n > T ? T : n);
  }
  // element offset / D of row r (w-major) of KV head h in q and out
  __device__ size_t row(int s, int h, int r) const {
    return ((size_t)s * W + r / rep) * (Hkv * rep) + (size_t)h * rep + r % rep;
  }
};

// most m16 tiles of a row group: 128 accumulators a thread at any D
constexpr int max_tiles(int D) { return 256 / D; }

// the body's arguments from a C entry point's pointers (bf16 q / out)
inline Args make_args(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* lengths, void* out, void* ws, int T, int W,
                      int Hkv, int rep, int D, int splits, int group_rows) {
  return Args{static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
              static_cast<const int8_t*>(v), static_cast<const float*>(ks),
              static_cast<const float*>(vs), static_cast<const int*>(lengths),
              static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), T, W, Hkv, rep, D,
              splits, 0, 1, group_rows, 1.f / sqrtf(static_cast<float>(D))};
}

inline int positions(int T, int splits) {  // L of the plan
  const int tiles = (T + kTile - 1) / kTile;
  return kTile * ((tiles + splits - 1) / splits);
}

// m16 tiles instantiated for a group of R rows: up to max_tiles(D); D =
// 32 builds 8 for 5-8
inline int m_tiles(int R, int D) {
  const int mt = (R + 15) / 16;
  return (D == 32 && mt > 4) ? 8 : mt;
}

inline bool shape_ok(int R, int group_rows, int D) {
  return (D == 32 || D == 64 || D == 80 || D == 96 || D == 128 || D == 256) && R >= 1 &&
         group_rows >= 1 && group_rows <= 16 * max_tiles(D);
}

// N bytes of shared memory as (N + 3) / 4 words (the last one's high bytes
// zero when N % 4), by the widest loads N's offsets allow: 16 bytes when
// N % 16 == 0, else 8, 4 or 2 (the caller keeps p aligned to them)
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[(N + 3) / 4], const uint8_t* p) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + 16 * i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint2 x = *reinterpret_cast<const uint2*>(p + 8 * i);
      w[2 * i] = x.x;
      w[2 * i + 1] = x.y;
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(p + 4 * i);
  } else {
    static_assert(N % 2 == 0, "2-byte loads at least");
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i) w[i] = 0u;
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      w[i / 2] |= static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p + 2 * i))
                  << (16 * (i % 2));
  }
}

// the int8 values in bits 0-7 and 16-23 of t -> bf16x2, exactly. With
// v = low7 - 128 sign, bf16(128 + low7) is 0x4300 | low7 (exact below
// 256), -128 - 128 sign is 0xC300 | (sign << 7) (the sign bit lands on
// the exponent's lowest bit: -128 or -256), and one fma.rn.bf16x2 adds
// them; the sum, an integer of at most 8 bits, is exact.
__device__ __forceinline__ uint32_t int8x2_bf16x2(uint32_t t) {
  const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (t & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(c));
  return d;
}

template <int D, typename Rows>
__device__ __forceinline__ void issue(const Args& a, const Rows& rows, unsigned char* smem, int s,
                                      int h, int start, int end, int it) {
  using L = Layout<D>;
  constexpr int CH = D / 16;  // 16-byte chunks of a row
  unsigned char* st = smem + (it % kStages) * L::kStage;
  int8_t* k8 = reinterpret_cast<int8_t*>(st);
  int8_t* v8 = k8 + kTile * L::kKRow;
  float* sc = reinterpret_cast<float*>(v8 + kTile * L::kVRow);
  const int p0 = start + it * kTile;
  static_assert(kTile <= kThreads, "a scale pair a thread");
#pragma unroll
  for (int k = 0; k < (kTile * CH + kThreads - 1) / kThreads; ++k) {  // a fixed count
    const int i = threadIdx.x + k * kThreads;
    if (kTile * CH % kThreads && i >= kTile * CH) break;  // D = 80: 2.5 copies a thread
    const int r = i / CH;
    const int ch = i % CH;
    const bool ok = p0 + r < end;
    const size_t off = ok ? rows(s, p0 + r, h).kv * D + ch * 16 : 0;
    cp_async16(k8 + r * L::kKRow + ch * 16, a.k + off, ok);
    cp_async16(v8 + r * L::kVRow + ch * 16, a.v + off, ok);
  }
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    const bool ok = p0 + r < end;
    const size_t off = ok ? rows(s, p0 + r, h).sc : 0;
    cp_async4(sc + r, a.ks + off, ok);
    cp_async4(sc + kTile + r, a.vs + off, ok);
  }
}

template <int D, int MT, typename Rows>
__device__ __forceinline__ void attend(const Args& a, const Rows& rows) {
  using L = Layout<D>;
  constexpr int KC = D / 16;  // k16 steps of Q K^T
  constexpr int DT = D / 8;   // n8 tiles of O
  constexpr int KB = D / 4;   // bytes of a K row a lane reads
  constexpr int VB = D / 8;   // bytes of a V row a lane reads
  constexpr int VW = (VB + 3) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x / a.groups;
  const int r0 = (blockIdx.x % a.groups) * a.group_rows;  // the group's first row of the head
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;
  const int R = min(a.group_rows, a.W * a.rep - r0);  // the group's rows
  const int n = a.live(s);
  const int start = blockIdx.z * a.span;
  if (start >= n) return;  // the merge skips this split
  const int end = min(start + a.span, n);
  const int tiles = (end - start + kTile - 1) / kTile;

  // the last position each of the lane's rows (16 mt + g + 8 hh) attends
  int lim[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * mt + g + 8 * hh;
      lim[mt][hh] = r < R ? min(a.lengths[s] + (r0 + r) / a.rep, n - 1) : -1;
    }
  float o[MT][DT][4];
  float m_run[MT][2];
  float l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int t = 0; t < DT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][t][e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_run[mt][hh] = kNeg;
      l_run[mt][hh] = 0.f;
    }
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) issue<D>(a, rows, smem, s, h, start, end, st);
    cp_async_commit();
  }
  // Q, while the first tiles are in flight: 8 elements a load, stored in
  // the renumbered D order (see the head note); rows past R zero
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kRing);
#pragma unroll
  for (int k = 0; k < (2 * MT * D + kThreads - 1) / kThreads; ++k) {
    const int i = tid + k * kThreads;
    if (i >= 2 * MT * D) break;
    const int r = i / (D / 8);
    const int d0 = 8 * (i % (D / 8));
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < R) x = *reinterpret_cast<const uint4*>(a.q + a.row(s, h, r0 + r) * D + d0);
    const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // byte e of a K word is k 2c + e / 2 (+ 8 for odd e)
      const int d = d0 + j, c = d / KB, e = d % 4, kc = (d % KB) / 4;
      qs[r * L::kQRow + kc * 16 + (e & 1) * 8 + 2 * c + e / 2] = e8[j];
    }
  }
  const int key0 = 16 * warp;  // the warp's 16 positions of a tile
  bool fresh = true;           // no tile of this warp consumed yet
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    if (it + kStages - 1 < tiles) issue<D>(a, rows, smem, s, h, start, end, it + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (it % kStages) * L::kStage;
    const uint8_t* k8 = st;
    const uint8_t* v8 = k8 + kTile * L::kKRow;
    const float* kc = reinterpret_cast<const float*>(v8 + kTile * L::kVRow);
    const float* vc = kc + kTile;
    const int pos0 = start + it * kTile + key0;
    if (pos0 >= end) continue;  // nothing of this warp's 16 keys is live

    // S = Q K^T over the warp's 16 keys (n-tiles 0 and 1: keys 8 j + g)
    uint32_t kw[2][KB / 4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      load_words<KB>(kw[j], k8 + (key0 + 8 * j + g) * L::kKRow + c4 * KB);
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j][0] = int8x2_bf16x2(kw[j][kk]);       // bytes 0, 2: k 2c, 2c + 1
        b[j][1] = int8x2_bf16x2(kw[j][kk] >> 8);  // bytes 1, 3: k 2c + 8, 2c + 9
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qf[4];
        ldmatrix_x4(qf, qs + (16 * mt + lane % 16) * L::kQRow + kk * 16 + (lane / 16) * 8);
        mma_bf16(sc[mt][0], qf, b[0][0], b[0][1]);
        mma_bf16(sc[mt][1], qf, b[1][0], b[1][1]);
      }
    }

    // logits, online-softmax update, P as hi + lo bf16 A fragments
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // rows 16 mt + 8 .. are padding when R <= 16 mt + 8 (decode at rep
      // <= 8): their softmax is skipped, their P is 0
      const bool upper = 16 * mt + 8 < R;
      bool ok[2][4];
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ok[j][e] = false;
          if (e >= 2 && !upper) continue;
          const int key = key0 + 8 * j + 2 * c4 + (e & 1);
          ok[j][e] = pos0 - key0 + key <= lim[mt][e / 2];
          sc[mt][j][e] = ok[j][e] ? __fmul_rn(__fmul_rn(sc[mt][j][e], kc[key]), a.inv_sqrt_d)
                                  : kNeg;
          mx[e / 2] = fmaxf(mx[e / 2], sc[mt][j][e]);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh && !upper) continue;
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[mt][hh], mx[hh]);
        const float alpha = __expf(m_run[mt][hh] - m_new);
        m_run[mt][hh] = m_new;
        if (fresh) continue;  // the warp's first tile: l and acc are still 0
        l_run[mt][hh] *= alpha;
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          o[mt][t][2 * hh] *= alpha;
          o[mt][t][2 * hh + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // n-tile j -> A registers (j: a0, a1 | a2, a3)
        const int key = key0 + 8 * j + 2 * c4;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (hh && !upper) {
            ph[mt][2 * j + 1] = pl[mt][2 * j + 1] = 0u;
            continue;
          }
          const float p0 = ok[j][2 * hh] ? __expf(sc[mt][j][2 * hh] - m_run[mt][hh]) : 0.f;
          const float p1 =
              ok[j][2 * hh + 1] ? __expf(sc[mt][j][2 * hh + 1] - m_run[mt][hh]) : 0.f;
          l_run[mt][hh] += p0 + p1;
          const float w0 = ok[j][2 * hh] ? p0 * vc[key] : 0.f;
          const float w1 = ok[j][2 * hh + 1] ? p1 * vc[key + 1] : 0.f;
          const uint32_t hi = pack_bf16x2(w0, w1);
          ph[mt][2 * j + hh] = hi;
          pl[mt][2 * j + hh] = pack_bf16x2(w0 - bf16_lo(hi), w1 - bf16_hi(hi));
        }
      }
    }

    // O += P V: rows key0 + 2c, + 1 (b0) and + 8, + 9 (b1), bytes g VB ..
    const uint8_t* vr = v8 + (key0 + 2 * c4) * L::kVRow + g * VB;
    uint32_t vw[4][VW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_words<VB>(vw[i], vr + ((i & 1) + 8 * (i / 2)) * L::kVRow);
    }
#pragma unroll
    for (int x = 0; x < VW; ++x) {
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {  // byte jb of word x: output n-tile 4 x + jb
        if (4 * x + jb >= DT) continue;  // D = 80: the last word's high half
        const uint32_t sel = jb | ((4 + jb) << 8);  // byte jb of rows a, a + 1 -> bits 0, 16
        const uint32_t b0 = int8x2_bf16x2(__byte_perm(vw[0][x], vw[1][x], sel));
        const uint32_t b1 = int8x2_bf16x2(__byte_perm(vw[2][x], vw[3][x], sel));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][4 * x + jb], ph[mt], b0, b1);
          mma_bf16(o[mt][4 * x + jb], pl[mt], b0, b1);
        }
      }
    }
    fresh = false;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring and Q are free: the warps' partials go there

  // per warp: m [16 MT], l [16 MT], acc [16 MT][D] (d in natural order,
  // rows kPitch apart: 2-way bank conflicts at most)
  constexpr int kRows = 16 * MT;
  constexpr int kPitch = D + 4;
  constexpr int kPart = L::partial(MT) / kWarps;  // floats of one warp's partial
  float* part = reinterpret_cast<float*>(smem);
  float* mine = part + warp * kPart;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * mt + g + 8 * hh;
      float l = l_run[mt][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (c4 == 0) {
        mine[r] = m_run[mt][hh];
        mine[kRows + r] = l;
      }
      float* orow = mine + 2 * kRows + r * kPitch;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        orow[(2 * c4) * DT + t] = o[mt][t][2 * hh];
        orow[(2 * c4 + 1) * DT + t] = o[mt][t][2 * hh + 1];
      }
    }
  __syncthreads();
  // per row, in warp order: m = max m_w; each warp's m_w becomes its
  // factor exp(m_w - m), warp 0's l the row's sum
  if (tid < R) {
    float m = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, part[w * kPart + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(part[w * kPart + tid] - m);
      l += f * part[w * kPart + kRows + tid];
      part[w * kPart + tid] = f;
    }
    part[kRows + tid] = l;
    part[L::partial(MT) + tid] = m;
  }
  __syncthreads();

  const int head_rows = a.W * a.rep;  // the workspace's rows and the merge's
  const size_t part_row = (((size_t)blockIdx.z * gridDim.y + s) * a.Hkv + h) * head_rows + r0;
  const size_t ml_base = (size_t)a.splits * gridDim.y * a.Hkv * head_rows * D;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* p = part + w * kPart;
      acc += p[r] * p[2 * kRows + r * kPitch + d];
    }
    const float l = part[kRows + r];
    if (a.splits == 1) {
      a.out[a.row(s, h, r0 + r) * D + d] = __float2bfloat16_rn(acc / fmaxf(l, 1e-30f));
    } else {
      a.ws[(part_row + r) * D + d] = acc;
      if (d == 0) {
        a.ws[ml_base + 2 * (part_row + r)] = part[L::partial(MT) + r];
        a.ws[ml_base + 2 * (part_row + r) + 1] = l;
      }
    }
  }
}

// splits > 1: out = the splits' partials combined in split order, one
// block per (KV head, slot, row), one thread per column; splits past the
// slot's last live position are skipped. Every thread forms the row's
// factors exp(m_sp - m) itself (the same loads, broadcast), so nothing
// waits on shared memory.
__device__ __forceinline__ void merge(const Args& a) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int r = blockIdx.z;
  const int d = threadIdx.x;
  const int R = a.W * a.rep;
  const int live = (a.live(s) + a.span - 1) / a.span;
  const size_t stride = (size_t)gridDim.y * a.Hkv * R;  // rows of one split
  const size_t row = ((size_t)s * a.Hkv + h) * R + r;
  const float* ml = a.ws + (size_t)a.splits * stride * a.D;
  float m = kNeg;
  for (int sp = 0; sp < live; ++sp) m = fmaxf(m, ml[2 * (sp * stride + row)]);
  float l = 0.f, acc = 0.f;
  for (int sp = 0; sp < live; ++sp) {
    const size_t pr = sp * stride + row;
    const float f = __expf(ml[2 * pr] - m);
    l += f * ml[2 * pr + 1];
    acc += f * a.ws[pr * a.D + d];
  }
  a.out[a.row(s, h, r) * a.D + d] = __float2bfloat16_rn(acc / fmaxf(l, 1e-30f));
}

template <int D, int MT, typename Rows>
__global__ void __launch_bounds__(kThreads) attend_kernel(Args a, Rows rows) {
  attend<D, MT>(a, rows);
}

__global__ void __launch_bounds__(256) merge_kernel(Args a) { merge(a); }

template <int D, int MT, typename Rows>
inline int launch_tiles(const Args& a, const Rows& rows, int S, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes(MT);
  auto kernel = attend_kernel<D, MT, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.Hkv * a.groups, S, a.splits), kThreads, smem, stream>>>(a, rows);
  if (a.splits > 1) merge_kernel<<<dim3(a.Hkv, S, a.W * a.rep), D, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename Rows>
inline int launch_d(const Args& a, const Rows& rows, int S, int mt, cudaStream_t stream) {
  if (mt == 1) return launch_tiles<D, 1>(a, rows, S, stream);
  if constexpr (max_tiles(D) >= 2) {
    if (mt == 2) return launch_tiles<D, 2>(a, rows, S, stream);
  }
  if constexpr (max_tiles(D) >= 3) {
    if (mt == 3) return launch_tiles<D, 3>(a, rows, S, stream);
  }
  if constexpr (max_tiles(D) >= 4) {
    if (mt == 4) return launch_tiles<D, 4>(a, rows, S, stream);
  }
  if constexpr (D == 32) {
    if (mt == 8) return launch_tiles<D, 8>(a, rows, S, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch the body for `a` over S slots (a.T, a.splits, a.group_rows set;
// a.span and a.groups are derived here). Refuses a shape outside the
// limits, a group of more than max_tiles(D) m16 tiles, a split count that
// is not 1 .. ceil(T / 64), and splits > 1 without a workspace.
template <typename Rows>
inline int launch(Args a, const Rows& rows, int S, cudaStream_t stream) {
  const int R = a.W * a.rep;
  const int tiles = (a.T + kTile - 1) / kTile;
  if (!shape_ok(R, a.group_rows, a.D) || S < 1 || a.T < 1 || a.splits < 1 || a.splits > tiles ||
      (a.splits > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.span = positions(a.T, a.splits);
  a.groups = (R + a.group_rows - 1) / a.group_rows;
  const int mt = m_tiles(a.group_rows, a.D);
  switch (a.D) {
    case 32: return launch_d<32>(a, rows, S, mt, stream);
    case 64: return launch_d<64>(a, rows, S, mt, stream);
    case 80: return launch_d<80>(a, rows, S, mt, stream);
    case 96: return launch_d<96>(a, rows, S, mt, stream);
    case 128: return launch_d<128>(a, rows, S, mt, stream);
    default: return launch_d<256>(a, rows, S, mt, stream);
  }
}

}  // namespace dmma
}  // namespace sis
