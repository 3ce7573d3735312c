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

// ---------------------------------------------------------------------------
// Tensor-core building blocks (sm_80+ PTX, run on Hopper): asynchronous
// 16-byte copies into shared memory, ldmatrix, and the warp-wide bf16
// mma.sync m16n8k16 with f32 accumulators.
//
// Fragment layouts of m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, 4 regs of bf16x2): a0 (row g, k 2c..2c+1), a1 (row g+8, same k),
//     a2 (row g, k 2c+8..2c+9), a3 (row g+8, k 2c+8..2c+9)
//   B (16 x 8, 2 regs): b0 (k 2c..2c+1, col g), b1 (k 2c+8..2c+9, col g)
//   C/D (16 x 8, 4 f32): d0, d1 (row g, cols 2c, 2c+1), d2, d3 (row g+8)
// In every bf16x2 register the lower k (or column) sits in the low 16 bits.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// `pred` false nothing is read and the 16 bytes are zero-filled
// (`src` must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared (a strided f32 scale); zero-filled when `pred`
// is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed: a [k][n] tile in shared memory gives
// B fragments
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16 bf16) * b (16 x 8 bf16), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// One query row per thread, online softmax over keys staged in shared
// memory as float [nk_pad][D] (rows past the valid range zero-filled).
// Key j (0-based in the stage) is attended when j < nk and, for
// consume(), its absolute index kbase + j <= kmax (causal); consume_bias()
// instead adds bias[j] to every logit (an additive key mask, as the
// encoder kernel of the TPU package does). Keys are taken SB at a time:
// the running max and the accumulator rescale once per sub-block.
template <int D, int SB>
struct FlashRow {
  // the d loops' unroll: whole up to D = 128; at 256 (Gemma) the q row
  // and accumulator live in local memory whatever the unroll, and a whole
  // unroll of every d loop only multiplies the code and its build time
  static constexpr int kU = D > 128 ? 8 : D;
  float q[D];
  float acc[D];
  float m;
  float l;

  __device__ __forceinline__ void init() {
    m = kNeg;
    l = 0.f;
#pragma unroll (kU)
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
#pragma unroll (kU)
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
#pragma unroll (kU)
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SB; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float* vr = vs + (j0 + jj) * D;
#pragma unroll (kU)
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
#pragma unroll (kU)
    for (int d = 0; d < D; ++d) out[d] = from_f<T>(acc[d] * inv);
  }
};

// ---------------------------------------------------------------------------
// Cache addressing, shared by every attention body over the int8 KV cache.
//
// The int8 K/V bytes of both cache layouts are the same: position `pos`
// of slot `s`, KV head `h` is the D-byte row `kv` of k / v viewed as
// [.., Hkv, D] rows (the FLAT layout's [.., T, Hkv*D] rows hold the same
// bytes). Only the f32 scales move: the standard layout keeps them
// [.., T, Hkv] (index kv, one per row), the FLAT layout [.., Hkv, T]
// (index sc, contiguous along positions for one head).
// ---------------------------------------------------------------------------

struct KVAddr {
  size_t kv;  // D-byte row of k / v
  size_t sc;  // element of the scales
};

// dense cache: k / v [S, T, Hkv, D] (or [S, T, Hkv*D]); scales [S, T, Hkv]
// or, FLAT, [S, Hkv, T]
template <bool Flat>
struct DenseRows {
  int T;
  int Hkv;
  __device__ __forceinline__ KVAddr operator()(int s, int pos, int h) const {
    const size_t kv = ((size_t)s * T + pos) * Hkv + h;
    return {kv, Flat ? ((size_t)s * Hkv + h) * T + pos : kv};
  }
};

// through the page table: logical position pos of slot s lives in pool
// page table[s, pos / page] at row pos % page; pools [N, page, Hkv, D]
// (or [N, page, Hkv*D]), scale pools [N, page, Hkv] or, FLAT,
// [N, Hkv, page]
template <bool Flat>
struct PagedRows {
  const int* table;
  int max_pages;
  int page;
  int Hkv;
  __device__ __forceinline__ KVAddr operator()(int s, int pos, int h) const {
    const size_t pid = table[(size_t)s * max_pages + pos / page];
    const int off = pos % page;
    const size_t kv = (pid * page + off) * Hkv + h;
    return {kv, Flat ? (pid * Hkv + h) * page + off : kv};
  }
};

// ---------------------------------------------------------------------------
// Decode attention over the dense int8 KV cache, f32 route: the body
// shared by decode_attention (standard layout) and flat_decode_attention
// (FLAT) for f32 queries (the bf16 route is decode_mma.cuh).
//
//   q / out [S, Hq, D] f32; k / v and their scales addressed by
//   `rows` (DenseRows); lengths int32 [S]: slot s attends positions
//   0..lengths[s] (the new token sits at lengths[s]). GQA: query head
//   h*rep + r reads KV head h; nothing is repeated.
//
// One block per (KV head, head group, slot) serves a group of the head's
// `rep` query heads (`heads` of them, at most kDecMaxRep and kDecMaxOut *
// kDecCH / D; the caller cuts the groups: ops/decode_attention.py
// decode_group_rows), so each K/V byte is read from device memory once a
// group; rep <= 8 at D <= 128 is one group. The loop over
// 128-position chunks runs inside the block (the TPU carried m/l/acc
// across sequential grid steps instead) and stops at the slot's length,
// so the cost tracks the live context, not max_len. Per chunk: each
// thread scores one position for all rep heads (k scale applied to the
// logit, 1/sqrt(D) folded in), one warp per head runs the online-softmax
// update, the V chunk is staged in shared memory as int8, and each
// thread accumulates its (head, d) outputs with the v scale folded into
// the probability. Under the FLAT layout a chunk's scales are one
// contiguous run per head; the arithmetic is the same, so both layouts
// give the same bits on the same logical cache.
// ---------------------------------------------------------------------------

constexpr int kDecCH = 128;    // positions per chunk == threads per block
constexpr int kDecMaxRep = 8;
constexpr int kDecMaxOut = 8;  // heads * D <= kDecMaxOut * kDecCH a block

inline bool decode_shape_ok(int rep, int heads, int D) {
  return D % 16 == 0 && rep >= 1 && heads >= 1 && heads <= kDecMaxRep &&
         heads * D <= kDecMaxOut * kDecCH;
}

inline size_t decode_smem_bytes(int rep, int D) {
  return (size_t)kDecCH * D +
         sizeof(float) * ((size_t)rep * D + (size_t)rep * kDecCH + kDecCH + 3 * (size_t)rep);
}

template <typename Rows>
__device__ __forceinline__ void decode_attention_body(
    const float* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ lengths, float* __restrict__ out, Rows rows, int T, int Hkv, int rep,
    int heads, int D, float inv_sqrt_d) {
  const int groups = (rep + heads - 1) / heads;
  const int h = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * heads;  // the group's first query head of h
  const int hq = Hkv * rep;
  rep = min(heads, rep - r0);  // from here on: the group's heads

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* v_s = reinterpret_cast<int8_t*>(smem);          // [CH][D]
  float* q_s = reinterpret_cast<float*>(smem + kDecCH * D);  // [rep][D]
  float* p_s = q_s + rep * D;                              // [rep][CH]
  float* vsc_s = p_s + rep * kDecCH;                       // [CH]
  float* m_s = vsc_s + kDecCH;                             // [rep]
  float* l_s = m_s + rep;                                  // [rep]
  float* a_s = l_s + rep;                                  // [rep]

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rd = rep * D;
  int n = lengths[s] + 1;
  n = n < 1 ? 1 : (n > T ? T : n);

  const size_t q_base = ((size_t)s * hq + (size_t)h * (hq / Hkv) + r0) * D;
  for (int i = tid; i < rd; i += kDecCH) q_s[i] = q[q_base + i];
  if (tid < rep) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kDecMaxOut];
#pragma unroll
  for (int j = 0; j < kDecMaxOut; ++j) acc[j] = 0.f;
  __syncthreads();

  const int segs = D / 16;
  for (int c0 = 0; c0 < n; c0 += kDecCH) {
    const int nc = min(kDecCH, n - c0);
    // phase 1: logits of position c0 + tid for every head of the group
    if (tid < nc) {
      const KVAddr a = rows(s, c0 + tid, h);
      float dots[kDecMaxRep];
#pragma unroll
      for (int r = 0; r < kDecMaxRep; ++r) dots[r] = 0.f;
      const int8_t* kr = k + a.kv * D;
      for (int sg = 0; sg < segs; ++sg) {
        const int4 raw = *reinterpret_cast<const int4*>(kr + sg * 16);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kv = static_cast<float>(kb[e]);
#pragma unroll
          for (int r = 0; r < kDecMaxRep; ++r)
            if (r < rep) dots[r] = fmaf(q_s[r * D + sg * 16 + e], kv, dots[r]);
        }
      }
      const float sc = ks[a.sc] * inv_sqrt_d;
#pragma unroll
      for (int r = 0; r < kDecMaxRep; ++r)
        if (r < rep) p_s[r * kDecCH + tid] = dots[r] * sc;
      vsc_s[tid] = vs[a.sc];
    } else {
      for (int r = 0; r < rep; ++r) p_s[r * kDecCH + tid] = kNeg;
      vsc_s[tid] = 0.f;
    }
    // stage the V chunk (int8) in shared memory, 16 bytes per load
    for (int i = tid; i < kDecCH * segs; i += kDecCH) {
      const int row = i / segs;
      const int sg = i % segs;
      int4 raw = make_int4(0, 0, 0, 0);
      if (row < nc)
        raw = *reinterpret_cast<const int4*>(v + rows(s, c0 + row, h).kv * D + sg * 16);
      *reinterpret_cast<int4*>(v_s + row * D + sg * 16) = raw;
    }
    __syncthreads();
    // phase 2: online-softmax update, one warp per head
    for (int r = warp; r < rep; r += kDecCH / 32) {
      float* pr = p_s + r * kDecCH;
      float vals[kDecCH / 32];
      float cmax = kNeg;
#pragma unroll
      for (int i = 0; i < kDecCH / 32; ++i) {
        vals[i] = pr[lane + 32 * i];
        cmax = fmaxf(cmax, vals[i]);
      }
      cmax = warp_max(cmax);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, cmax);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kDecCH / 32; ++i) {
        const float p = expf(vals[i] - m_new);
        pr[lane + 32 * i] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // phase 3: acc[(r, d)] = acc * alpha + sum_t p[r, t] * vs[t] * v[t, d]
#pragma unroll
    for (int j = 0; j < kDecMaxOut; ++j) {
      const int o = tid + j * kDecCH;
      if (o < rd) {
        const int r = o / D;
        const int d = o % D;
        const float* pr = p_s + r * kDecCH;
        float a = acc[j] * a_s[r];
        for (int tt = 0; tt < nc; ++tt)
          a = fmaf(pr[tt] * vsc_s[tt], static_cast<float>(v_s[tt * D + d]), a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kDecMaxOut; ++j) {
    const int o = tid + j * kDecCH;
    if (o < rd) {
      const int r = o / D;
      out[q_base + o] = acc[j] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

// Launch `kernel` (a __global__ wrapper of decode_attention_body) on a
// (Hkv * head groups, S) grid of kDecCH threads, `heads` query heads a
// group.
template <typename Kernel, typename... Args>
inline int launch_decode(Kernel kernel, int S, int Hkv, int rep, int heads, int D,
                         cudaStream_t stream, Args... args) {
  if (!decode_shape_ok(rep, heads, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (rep + heads - 1) / heads;
  kernel<<<dim3(Hkv * groups, S), kDecCH, decode_smem_bytes(heads, D), stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Window attention over the int8 KV cache, f32 route (the bf16 route of
// all six kernels is decode_mma.cuh): the body shared by
// window_decode_attention (dense cache, W query rows per slot),
// paged_decode_attention (page table, W = 1),
// paged_window_decode_attention (page table, W rows) and their FLAT
// twins.
//
//   q / out [S, W, Hq, D] f32; k / v and their scales addressed
//   per (slot, position, KV head) by `rows` (DenseRows or PagedRows);
//   lengths int32 [S]. Row w of slot s sits at position lengths[s] + w and
//   attends positions <= lengths[s] + w (the verify mask; W = 1 is the
//   decode mask). GQA: query head h*rep + r reads KV head h.
//
// One block per (KV head, row group, slot) serves a group of the head's
// W * rep query rows ((w, rep) order; `group_rows` of them, at most
// kWinMaxOut * kWinThreads / D: the caller cuts the groups,
// ops/decode_attention.py decode_group_rows), so each K/V byte is read
// from device memory once a group, not once per window row; W * rep * D
// <= 4096 is one group. The chunk loop stops at the window's last live position,
// lengths[s] + W - 1. Per 64-position chunk: K and V are dequantized into
// shared memory as f32 (the scale applied once per element), every (row,
// position) logit is one thread's dot product, one warp per row runs the
// online-softmax update, and each thread accumulates fixed (row, d)
// outputs in registers.
// ---------------------------------------------------------------------------

constexpr int kWinCH = 64;       // positions per staged chunk
constexpr int kWinThreads = 256;
constexpr int kWinMaxOut = 16;   // group rows * D <= kWinMaxOut * kWinThreads

inline size_t window_smem_bytes(int R, int D) {
  return sizeof(float) * ((size_t)kWinCH * (D + 1) + (size_t)kWinCH * D + (size_t)R * D +
                          (size_t)R * kWinCH + 3 * (size_t)R);
}

inline bool window_shape_ok(int R, int group_rows, int D) {
  return D % 16 == 0 && R >= 1 && group_rows >= 1 &&
         group_rows * D <= kWinMaxOut * kWinThreads &&
         window_smem_bytes(group_rows, D) <= 227 * 1024;
}

template <typename Rows>
__device__ __forceinline__ void window_attention(
    const float* __restrict__ q, const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ lengths, float* __restrict__ out, Rows rows, int T, int W, int Hkv,
    int rep, int most, int D, float inv_sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = (W * rep + most - 1) / most;
  const int r0 = (blockIdx.x % groups) * most;  // the group's first row of the head
  const int R = min(most, W * rep - r0);        // the group's rows
  const int KP = D + 1;  // padded K rows: a warp's 32 positions hit 32 banks
  float* k_s = reinterpret_cast<float*>(smem);  // [CH][D+1]
  float* v_s = k_s + kWinCH * KP;               // [CH][D]
  float* q_s = v_s + kWinCH * D;                // [R][D]
  float* p_s = q_s + R * D;                     // [R][CH]
  float* m_s = p_s + R * kWinCH;                // [R]
  float* l_s = m_s + R;                         // [R]
  float* a_s = l_s + R;                         // [R]

  const int h = blockIdx.x / groups;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hq = Hkv * rep;
  const int len = lengths[s];
  int n = len + W;  // positions 0 .. len + W - 1 are live for some row
  n = n < 1 ? 1 : (n > T ? T : n);

  // local row r is the head's row r0 + r = w * rep + rr: q[s, w, h * rep + rr, :]
  for (int i = tid; i < R * D; i += kWinThreads) {
    const int r = r0 + i / D;
    const int w = r / rep;
    q_s[i] = q[(((size_t)s * W + w) * hq + (size_t)h * rep + r % rep) * D + i % D];
  }
  if (tid < R) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kWinMaxOut];
#pragma unroll
  for (int j = 0; j < kWinMaxOut; ++j) acc[j] = 0.f;
  __syncthreads();

  const int segs = D / 16;
  for (int c0 = 0; c0 < n; c0 += kWinCH) {
    const int nc = min(kWinCH, n - c0);
    // stage the chunk's K and V, dequantized, 16 int8 values per load
    for (int i = tid; i < kWinCH * segs; i += kWinThreads) {
      const int j = i / segs;
      const int sg = i % segs;
      float* kd = k_s + j * KP + sg * 16;
      float* vd = v_s + j * D + sg * 16;
      if (j < nc) {
        const KVAddr a = rows(s, c0 + j, h);
        const int4 kraw = *reinterpret_cast<const int4*>(k + a.kv * D + sg * 16);
        const int4 vraw = *reinterpret_cast<const int4*>(v + a.kv * D + sg * 16);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kraw);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vraw);
        const float ksc = ks[a.sc];
        const float vsc = vs[a.sc];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          kd[e] = static_cast<float>(kb[e]) * ksc;
          vd[e] = static_cast<float>(vb[e]) * vsc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          kd[e] = 0.f;
          vd[e] = 0.f;
        }
      }
    }
    __syncthreads();
    // logits: local row r attends positions <= len + (r0 + r) / rep
    for (int i = tid; i < R * kWinCH; i += kWinThreads) {
      const int r = i / kWinCH;
      const int j = i % kWinCH;
      float logit = kNeg;
      if (j < nc && c0 + j <= len + (r0 + r) / rep) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * KP;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        logit = dot * inv_sqrt_d;
      }
      p_s[i] = logit;
    }
    __syncthreads();
    // online-softmax update, one warp per row
    for (int r = warp; r < R; r += kWinThreads / 32) {
      float* pr = p_s + r * kWinCH;
      const float v0 = pr[lane];
      const float v1 = pr[lane + 32];
      const float cmax = warp_max(fmaxf(v0, v1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, cmax);
      const float p0 = expf(v0 - m_new);
      const float p1 = expf(v1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc[(r, d)] = acc * alpha[r] + sum_j p[r, j] * v[j, d]
#pragma unroll
    for (int jo = 0; jo < kWinMaxOut; ++jo) {
      const int o = tid + jo * kWinThreads;
      if (o < R * D) {
        const int r = o / D;
        const int d = o % D;
        const float* pr = p_s + r * kWinCH;
        float a = acc[jo] * a_s[r];
        for (int j = 0; j < nc; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
        acc[jo] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int jo = 0; jo < kWinMaxOut; ++jo) {
    const int o = tid + jo * kWinThreads;
    if (o < R * D) {
      const int r = o / D;
      const int w = (r0 + r) / rep;
      const size_t dst =
          (((size_t)s * W + w) * hq + (size_t)h * rep + (r0 + r) % rep) * D + o % D;
      out[dst] = acc[jo] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

// Launch `kernel` (a __global__ wrapper of window_attention) on a
// (Hkv * row groups, S) grid, `rows` of the head's R rows a group; raises
// the dynamic shared-memory limit when the window needs more than the
// default 48 KB.
template <typename Kernel, typename... Args>
inline int launch_window(Kernel kernel, int S, int Hkv, int R, int rows, int D,
                         cudaStream_t stream, Args... args) {
  if (!window_shape_ok(R, rows, D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = window_smem_bytes(rows, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(Hkv * ((R + rows - 1) / rows), S), kWinThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sis
