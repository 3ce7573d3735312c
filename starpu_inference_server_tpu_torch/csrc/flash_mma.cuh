// Tensor-core flash attention tile: the bf16 body shared by
// bidirectional_attention (K7), causal_attention (K5) and
// chunk_prefill_attention (K4).
//
// One block of 4 warps owns 64 query rows, 16 a warp. The rows' Q tile
// comes in by cp.async and stays in registers as mma A fragments (at D =
// 256 it stays in shared memory and is read again each key tile: 64 more
// registers would spill). Key tiles of 64 positions (32 at D = 256, whose
// shared memory would not hold two 64-key rings of K, V and their int8
// staging) arrive through a cp.async double buffer, bf16
// rows padded by 16 bytes so ldmatrix is conflict-free. S = Q K^T is
// mma.sync m16n8k16 into f32; the online softmax runs on the accumulator
// fragments (a row lives in one quad: max and sum take two shuffles);
// P becomes bf16 A fragments in registers, where the m16n8k16
// accumulator layout is already the A layout of P V, and V is read with
// ldmatrix.trans. P is carried as two bf16 terms, hi = bf16(p) and lo =
// bf16(p - hi), two mma per P V tile, so the weights keep f32 precision
// to 2^-16: one bf16 P breaks the 2^-7 |ref| + 1e-3 that attention
// kernels are held to wherever an output cancels towards 0. The block
// owns every key of its rows, so a call gives the same bits every time.
//
// Where the keys come from, which of them a row attends and how a logit
// is formed is the key source's business (the `Keys` policy):
//
//   BiasKeys    (K7) every key tile; logit = s / sqrt(D) + bias[key]
//               (an additive key mask, -1e9 for padding).
//   CausalKeys  (K5) key tiles up to the block's last query position;
//               tiles wholly above it are never loaded. Only the
//               diagonal tiles (the last; the last two at D = 256, whose
//               key tiles are half the block's rows) mask per element,
//               key > position -> -1e30, the plain version's mask value.
//   ChunkKeys   (K4) the slot's int8 cache positions < start, then the
//               chunk's own keys causally, under one softmax. int8 tiles
//               are staged as int8 by cp.async and widened to bf16 in
//               shared memory (exact: |x| <= 127 fits the significand);
//               the scales stay out of the operands: column j of S is
//               multiplied by k_scale[j] / sqrt(D) in f32 after the mma,
//               column j of P by v_scale[j] in f32 before the hi/lo
//               split. That is the plain version's int8 * scale in f32
//               up to summation order.
//
// A policy provides tiles() (key tiles of the block), issue() (start the
// copies of tile `it` into buffer `slot`; per-key f32 factors are stored
// directly), widen() (after the tile has landed: turn int8 staging into
// bf16 rows; returns whether it wrote shared memory), logits() (turn the
// f32 dot products of a tile into logits in place) and pscale() (whether
// P's columns take the per-key v factor).
//
// Head dims: D = 32 (llama-tiny), 64, 80 (Phi-2), 96 (Phi-3-mini), 128
// and 256 (Gemma) are instantiated. At D = 32 Q K^T is two k16 steps and
// P V four n8 tiles; a bf16 row is 64 bytes, padded to 80, so the 8 row
// addresses of an ldmatrix fall on 8 distinct 16-byte bank groups (80 r
// mod 128 = 0, 80, 32, 112, 64, 16, 96, 48) and every cp.async
// destination stays 16-byte aligned; an int8 staging row is 32 bytes
// padded to 48. Every D + 8 of a multiple of 16 does the same (176, 208
// and 528 bytes at 80, 96 and 256); 80 and 96 are five and six k16 steps
// and ten and twelve n8 tiles, so no tile is partial.
//
// Query rows (QRows): q and out are [B, T, Hq, D]; row r of the block is
// position q0 + r of one query head. On the H100 this measured 1-5% ahead
// of the TPU kernels' KV-major packing (64 / rep positions x the rep
// query heads of a KV head, sharing each K/V tile), so only it is built.
#pragma once

#include "common.cuh"

namespace sis {
namespace flash {

constexpr int kBQ = 64;   // query rows per block (16 per warp)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int D>
struct Layout {
  static constexpr int kKeys = D > 128 ? 32 : 64;  // keys per staged tile
  static constexpr int kNT = kKeys / 8;            // n8 tiles of S
  static constexpr bool kQRegs = D <= 128;         // Q's fragments kept in registers
  static constexpr int kRow = D + 8;      // padded bf16 row (16 bytes past D)
  static constexpr int kI8Row = D + 16;   // padded int8 staging row
  static constexpr size_t kBf16 = (size_t)(kBQ + 4 * kKeys) * kRow * 2;  // q, k[2], v[2]
  static constexpr size_t kCols = 4 * kKeys * sizeof(float);              // kc[2], vc[2]
  static constexpr size_t kI8 = (size_t)4 * kKeys * kI8Row;              // k8[2], v8[2]
  static constexpr size_t bytes(bool int8) { return kBf16 + kCols + (int8 ? kI8 : 0); }
};

// the tile's shared memory, carved from one dynamic buffer
template <int D>
struct Smem {
  __nv_bfloat16* q;  // [kBQ][kRow]
  __nv_bfloat16* k;  // [2][kKeys][kRow]
  __nv_bfloat16* v;  // [2][kKeys][kRow]
  float* kc;         // [2][kKeys] per-key factor of S's columns
  float* vc;         // [2][kKeys] per-key factor of P's columns
  int8_t* k8;        // [2][kKeys][kI8Row] int8 staging
  int8_t* v8;

  __device__ explicit Smem(unsigned char* base) {
    using L = Layout<D>;
    q = reinterpret_cast<__nv_bfloat16*>(base);
    k = q + kBQ * L::kRow;
    v = k + 2 * L::kKeys * L::kRow;
    kc = reinterpret_cast<float*>(v + 2 * L::kKeys * L::kRow);
    vc = kc + 2 * L::kKeys;
    k8 = reinterpret_cast<int8_t*>(vc + 2 * L::kKeys);
    v8 = k8 + 2 * L::kKeys * L::kI8Row;
  }
  __device__ __nv_bfloat16* krow(int slot, int r) const {
    return k + (slot * Layout<D>::kKeys + r) * Layout<D>::kRow;
  }
  __device__ __nv_bfloat16* vrow(int slot, int r) const {
    return v + (slot * Layout<D>::kKeys + r) * Layout<D>::kRow;
  }
};

struct QRows {
  int b, T, hq;  // batch row, positions, query heads
  int q0;        // first position of the block
  int head;      // the block's query head
  __device__ int pos(int r) const { return q0 + r; }
  // element offset of row r in q / out
  __device__ size_t offset(int r) const { return ((size_t)b * T + pos(r)) * hq + head; }
};

// Copy `n` rows of D bf16 from `src` (row t at src + t * stride) into
// buffer `slot` of dst, 16 bytes per cp.async; rows >= n are zero-filled.
template <int D>
__device__ __forceinline__ void issue_bf16_rows(__nv_bfloat16* dst_k, __nv_bfloat16* dst_v,
                                                const __nv_bfloat16* k, const __nv_bfloat16* v,
                                                size_t stride, int n, int tid) {
  constexpr int CH = D / 8;
  constexpr int RW = Layout<D>::kRow;
  for (int i = tid; i < Layout<D>::kKeys * CH; i += kThreads) {
    const int r = i / CH;
    const bool ok = r < n;
    const size_t off = (size_t)(ok ? r : 0) * stride + (i % CH) * 8;
    cp_async16(dst_k + r * RW + (i % CH) * 8, k + off, ok);
    cp_async16(dst_v + r * RW + (i % CH) * 8, v + off, ok);
  }
}

// K7: every key tile, additive key bias (0 attend, -1e9 masked)
template <int D>
struct BiasKeys {
  const __nv_bfloat16* k;  // (b, position 0, kv head) of [B, T, Hkv, D]
  const __nv_bfloat16* v;
  const float* bias;       // (b, 0) of [B, T]
  size_t stride;           // Hkv * D
  int T;
  float scale;

  static constexpr int kKeys = Layout<D>::kKeys;
  static constexpr int kNT = Layout<D>::kNT;
  __device__ int tiles() const { return (T + kKeys - 1) / kKeys; }
  __device__ void issue(int it, int slot, const Smem<D>& sm, int tid) const {
    const int j0 = it * kKeys;
    issue_bf16_rows<D>(sm.krow(slot, 0), sm.vrow(slot, 0), k + j0 * stride, v + j0 * stride,
                       stride, T - j0, tid);
    for (int j = tid; j < kKeys; j += kThreads)
      sm.kc[slot * kKeys + j] = j0 + j < T ? bias[j0 + j] : kNeg;
  }
  __device__ bool widen(int, int, const Smem<D>&, int) const { return false; }
  __device__ bool pscale(int) const { return false; }
  __device__ void logits(float (&s)[kNT][4], int, const float* kc, int c4,
                         const int (&)[2]) const {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float b0 = kc[j * 8 + 2 * c4];
      const float b1 = kc[j * 8 + 2 * c4 + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[j][2 * h] = __fadd_rn(__fmul_rn(s[j][2 * h], scale), b0);
        s[j][2 * h + 1] = __fadd_rn(__fmul_rn(s[j][2 * h + 1], scale), b1);
      }
    }
  }
};

// scale every logit; on a diagonal tile (keys from j0) a key past the
// row's position gets kNeg
template <int NT>
__device__ __forceinline__ void causal_logits(float (&s)[NT][4], float scale, bool diagonal,
                                              int j0, int c4, const int (&pos)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j0 + j * 8 + 2 * c4 + (e & 1);
      s[j][e] = (diagonal && key > pos[e / 2]) ? kNeg : __fmul_rn(s[j][e], scale);
    }
}

// K5: causal over one sequence; `last` is the last key any row of the
// block attends (its last valid position), `first` the block's first
// position: a key tile reaching past it is diagonal
template <int D>
struct CausalKeys {
  const __nv_bfloat16* k;  // (b, position 0, kv head) of [B, T, Hkv, D]
  const __nv_bfloat16* v;
  size_t stride;           // Hkv * D
  int last;
  int first;
  float scale;

  static constexpr int kKeys = Layout<D>::kKeys;
  static constexpr int kNT = Layout<D>::kNT;
  __device__ int tiles() const { return last / kKeys + 1; }
  __device__ void issue(int it, int slot, const Smem<D>& sm, int tid) const {
    const int j0 = it * kKeys;
    issue_bf16_rows<D>(sm.krow(slot, 0), sm.vrow(slot, 0), k + j0 * stride, v + j0 * stride,
                       stride, last + 1 - j0, tid);
  }
  __device__ bool widen(int, int, const Smem<D>&, int) const { return false; }
  __device__ bool pscale(int) const { return false; }
  __device__ void logits(float (&s)[kNT][4], int it, const float*, int c4,
                         const int (&pos)[2]) const {
    const int j0 = it * kKeys;
    causal_logits(s, scale, j0 + kKeys - 1 > first, j0, c4, pos);
  }
};

// K4: the slot's int8 cache row (positions < past), then the chunk's own
// keys causally (chunk-relative positions, `last` and `first` as in
// CausalKeys)
template <int D>
struct ChunkKeys {
  const int8_t* k8;        // (position 0, kv head) of the int8 row [T, Hkv, D]
  const int8_t* v8;
  const float* ks;         // (position 0, kv head) of the scales [T, Hkv]
  const float* vs;
  const __nv_bfloat16* k;  // (position 0, kv head) of the chunk's keys [C, Hkv, D]
  const __nv_bfloat16* v;
  int hkv_count;           // Hkv: rows of one position
  int past;
  int last;
  int first;
  float scale;

  static constexpr int kKeys = Layout<D>::kKeys;
  static constexpr int kNT = Layout<D>::kNT;
  __device__ int past_tiles() const { return (past + kKeys - 1) / kKeys; }
  __device__ int tiles() const { return past_tiles() + last / kKeys + 1; }
  __device__ void issue(int it, int slot, const Smem<D>& sm, int tid) const {
    const int np = past_tiles();
    if (it >= np) {
      const int j0 = (it - np) * kKeys;
      const size_t stride = (size_t)hkv_count * D;
      issue_bf16_rows<D>(sm.krow(slot, 0), sm.vrow(slot, 0), k + j0 * stride,
                         v + j0 * stride, stride, last + 1 - j0, tid);
      return;
    }
    constexpr int CH = D / 16;  // 16-byte chunks of an int8 row
    constexpr int RW = Layout<D>::kI8Row;
    const int j0 = it * kKeys;
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int r = i / CH;
      const bool ok = j0 + r < past;
      const size_t off = (size_t)(ok ? j0 + r : 0) * hkv_count * D + (i % CH) * 16;
      cp_async16(sm.k8 + (slot * kKeys + r) * RW + (i % CH) * 16, k8 + off, ok);
      cp_async16(sm.v8 + (slot * kKeys + r) * RW + (i % CH) * 16, v8 + off, ok);
    }
    for (int j = tid; j < kKeys; j += kThreads) {
      const bool ok = j0 + j < past;
      const size_t p = (size_t)(ok ? j0 + j : 0) * hkv_count;
      sm.kc[slot * kKeys + j] = ok ? ks[p] : 0.f;
      sm.vc[slot * kKeys + j] = ok ? vs[p] : 0.f;
    }
  }
  // int8 staging of a past tile -> bf16 rows, 8 values a thread a step
  __device__ bool widen(int it, int slot, const Smem<D>& sm, int tid) const {
    if (it >= past_tiles()) return false;
    constexpr int CH = D / 8;
    constexpr int RW8 = Layout<D>::kI8Row;
    for (int i = tid; i < 2 * kKeys * CH; i += kThreads) {
      const int src = i / (kKeys * CH);  // 0: K, 1: V
      const int r = (i / CH) % kKeys;
      const int c = i % CH;
      const int8_t* from = (src ? sm.v8 : sm.k8) + (slot * kKeys + r) * RW8 + c * 8;
      const uint2 raw = *reinterpret_cast<const uint2*>(from);
      const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
      uint4 w;
      w.x = pack_bf16x2(static_cast<float>(x[0]), static_cast<float>(x[1]));
      w.y = pack_bf16x2(static_cast<float>(x[2]), static_cast<float>(x[3]));
      w.z = pack_bf16x2(static_cast<float>(x[4]), static_cast<float>(x[5]));
      w.w = pack_bf16x2(static_cast<float>(x[6]), static_cast<float>(x[7]));
      __nv_bfloat16* to = (src ? sm.vrow(slot, r) : sm.krow(slot, r)) + c * 8;
      *reinterpret_cast<uint4*>(to) = w;
    }
    return true;
  }
  __device__ bool pscale(int it) const { return it < past_tiles(); }
  __device__ void logits(float (&s)[kNT][4], int it, const float* kc, int c4,
                         const int (&pos)[2]) const {
    const int np = past_tiles();
    if (it >= np) {
      const int j0 = (it - np) * kKeys;
      causal_logits(s, scale, j0 + kKeys - 1 > first, j0, c4, pos);
      return;
    }
    const int j0 = it * kKeys;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = j * 8 + 2 * c4 + (e & 1);
        s[j][e] = j0 + jj < past ? __fmul_rn(__fmul_rn(s[j][e], kc[jj]), scale) : kNeg;
      }
  }
};

// The block's 64 query rows (`rows`) attend the keys of `keys`; writes
// the rows whose position is < rows.T. `smem`: Layout<D>::bytes(int8).
template <int D, typename Keys>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q,
                                       __nv_bfloat16* __restrict__ out, const QRows& rows,
                                       const Keys& keys, unsigned char* smem) {
  using L = Layout<D>;
  constexpr int RW = L::kRow;
  constexpr int CH = D / 8;   // 16-byte chunks per bf16 row
  constexpr int KC = D / 16;  // k16 steps of Q K^T
  constexpr int DT = D / 8;   // n8 tiles of O
  constexpr int kKeys = L::kKeys;
  constexpr int kNT = L::kNT;
  const Smem<D> sm(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;

  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH;
    const bool ok = rows.pos(r) < rows.T;
    cp_async16(sm.q + r * RW + (i % CH) * 8, q + (ok ? rows.offset(r) : 0) * D + (i % CH) * 8,
               ok);
  }
  const int ntiles = keys.tiles();
  keys.issue(0, 0, sm, tid);
  cp_async_commit();

  const int pos[2] = {rows.pos(warp * 16 + g), rows.pos(warp * 16 + g + 8)};
  uint32_t qf[L::kQRegs ? KC : 1][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {kNeg, kNeg};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};    // this lane's share of the row sums

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it % 2;
    if (it + 1 < ntiles) keys.issue(it + 1, slot ^ 1, sm, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (keys.widen(it, slot, sm, tid)) __syncthreads();
    if (L::kQRegs && it == 0) {
#pragma unroll
      for (int kc = 0; kc < (L::kQRegs ? KC : 1); ++kc)
        ldmatrix_x4(qf[kc], sm.q + (warp * 16 + lane % 16) * RW + kc * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* ks = sm.krow(slot, 0);
    const __nv_bfloat16* vs = sm.vrow(slot, 0);

    // S = Q K^T: n-tile pair np covers keys 16 np .. 16 np + 15
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qk[4];
      if constexpr (L::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[e] = qf[kc][e];
      } else {
        ldmatrix_x4(qk, sm.q + (warp * 16 + lane % 16) * RW + kc * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * RW + kc * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qk, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qk, kb[2], kb[3]);
      }
    }
    keys.logits(s, it, sm.kc + slot * kKeys, c4, pos);

    // online-softmax update of rows g, g + 8
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[h] = fmaxf(mx[h], fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = __expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, 16 keys at a time; P (times the key's v factor, where the
    // source has one) as hi + lo bf16 A fragments straight from S
    const bool pscale = keys.pscale(it);
    const float* vc = sm.vc + slot * kKeys;
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // n-tiles 2 kc (a0, a1) and 2 kc + 1 (a2, a3)
        const float* sj = s[2 * kc + half];
        const int jj = (2 * kc + half) * 8 + 2 * c4;
        const float f0 = pscale ? vc[jj] : 1.f;
        const float f1 = pscale ? vc[jj + 1] : 1.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g, g + 8
          const float p0 = __expf(sj[2 * h] - m_run[h]);
          const float p1 = __expf(sj[2 * h + 1] - m_run[h]);
          l_run[h] += p0 + p1;
          const float w0 = p0 * f0;
          const float w1 = p1 * f1;
          const uint32_t hi = pack_bf16x2(w0, w1);
          ph[2 * half + h] = hi;
          pl[2 * half + h] = pack_bf16x2(w0 - bf16_lo(hi), w1 - bf16_hi(hi));
        }
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kc * 16 + lane % 16) * RW + dp * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this slot is refilled by the next iteration's issue
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = warp * 16 + g + 8 * h;
    if (pos[h] >= rows.T) continue;
    __nv_bfloat16* dst = out + rows.offset(r) * D + 2 * c4;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) =
          pack_bf16x2(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
  }
}

// Launch a __global__ wrapper of attend() with Layout<D>::bytes(int8) of
// dynamic shared memory, raising the limit past the default 48 KB.
template <int D, typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, bool int8, cudaStream_t stream, Args... args) {
  const size_t smem = Layout<D>::bytes(int8);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace sis
