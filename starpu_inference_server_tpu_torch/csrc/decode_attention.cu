// decode_attention: one query token per slot against the int8 KV cache.
//
//   q [S, Hq, D] (bf16 or f32), k/v int8 [S, T, Hkv, D], k/v scales f32
//   [S, T, Hkv], lengths int32 [S]; slot s attends positions
//   0..lengths[s] (the new token sits at lengths[s]). GQA: query head
//   h*rep + r reads KV head h; nothing is repeated. out [S, Hq, D].
//
// Replaces the TPU kernels starpu_inference_server_tpu/ops/
// decode_attention.py decode_attention (_grouped_kernel, slot-grouped
// grid, and _kernel, per-slot grid). One kernel covers both: the slot
// grouping was a fix for TPU grid-step overhead and is not needed here.
//
// Bound on the H100: device-memory bytes. Each step reads every live
// slot's int8 K/V rows and their scales once; the FLOPs are ~2 per byte.
// Design: one block per (KV head, slot) serves the head's `rep` query
// heads, so each K/V byte is read from device memory once. The loop over
// 128-position chunks runs inside the block (the TPU carried m/l/acc
// across sequential grid steps instead) and stops at the slot's length,
// so the cost tracks the live context, not max_len. Per chunk: each
// thread scores one position for all rep heads (k scale applied to the
// logit, 1/sqrt(D) folded in), one warp per head runs the online-softmax
// update, the V chunk is staged in shared memory as int8, and each
// thread accumulates its (head, d) outputs with the v scale folded into
// the probability.

#include "common.cuh"

namespace {

constexpr int kCH = 128;      // positions per chunk == threads per block
constexpr int kMaxRep = 8;
constexpr int kMaxOut = 8;    // rep * D <= kMaxOut * kCH

template <typename TQ>
__global__ void __launch_bounds__(kCH)
decode_attention_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        TQ* __restrict__ out, int T, int Hkv, int rep, int D,
                        float inv_sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* v_s = reinterpret_cast<int8_t*>(smem);                // [kCH][D]
  float* q_s = reinterpret_cast<float*>(smem + kCH * D);        // [rep][D]
  float* p_s = q_s + rep * D;                                   // [rep][kCH]
  float* vsc_s = p_s + rep * kCH;                               // [kCH]
  float* m_s = vsc_s + kCH;                                     // [rep]
  float* l_s = m_s + rep;                                       // [rep]
  float* a_s = l_s + rep;                                       // [rep]

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hq = Hkv * rep;
  const int rd = rep * D;
  int n = lengths[s] + 1;
  n = n < 1 ? 1 : (n > T ? T : n);

  const size_t q_base = ((size_t)s * hq + (size_t)h * rep) * D;
  for (int i = tid; i < rd; i += kCH) q_s[i] = sis::to_f(q[q_base + i]);
  if (tid < rep) {
    m_s[tid] = sis::kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;
  __syncthreads();

  const size_t row_stride = (size_t)Hkv * D;  // bytes between positions
  const int8_t* k_slot = k + (size_t)s * T * row_stride + (size_t)h * D;
  const int8_t* v_slot = v + (size_t)s * T * row_stride + (size_t)h * D;
  const float* ks_slot = ks + (size_t)s * T * Hkv + h;
  const float* vs_slot = vs + (size_t)s * T * Hkv + h;
  const int segs = D / 16;

  for (int c0 = 0; c0 < n; c0 += kCH) {
    const int nc = min(kCH, n - c0);
    // phase 1: logits of position c0 + tid for every head of the group
    {
      const int t = c0 + tid;
      if (tid < nc) {
        float dots[kMaxRep];
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) dots[r] = 0.f;
        const int8_t* kr = k_slot + (size_t)t * row_stride;
        for (int sg = 0; sg < segs; ++sg) {
          const int4 raw = *reinterpret_cast<const int4*>(kr + sg * 16);
          const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float kv = static_cast<float>(kb[e]);
#pragma unroll
            for (int r = 0; r < kMaxRep; ++r)
              if (r < rep) dots[r] = fmaf(q_s[r * D + sg * 16 + e], kv, dots[r]);
          }
        }
        const float sc = ks_slot[(size_t)t * Hkv] * inv_sqrt_d;
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) p_s[r * kCH + tid] = dots[r] * sc;
        vsc_s[tid] = vs_slot[(size_t)t * Hkv];
      } else {
        for (int r = 0; r < rep; ++r) p_s[r * kCH + tid] = sis::kNeg;
        vsc_s[tid] = 0.f;
      }
      // stage the V chunk (int8) in shared memory, 16 bytes per load
      for (int i = tid; i < kCH * segs; i += kCH) {
        const int row = i / segs;
        const int sg = i % segs;
        int4 raw = make_int4(0, 0, 0, 0);
        if (row < nc)
          raw = *reinterpret_cast<const int4*>(v_slot + (size_t)(c0 + row) * row_stride + sg * 16);
        *reinterpret_cast<int4*>(v_s + row * D + sg * 16) = raw;
      }
    }
    __syncthreads();
    // phase 2: online-softmax update, one warp per head
    for (int r = warp; r < rep; r += kCH / 32) {
      float* pr = p_s + r * kCH;
      float vals[kCH / 32];
      float cmax = sis::kNeg;
#pragma unroll
      for (int i = 0; i < kCH / 32; ++i) {
        vals[i] = pr[lane + 32 * i];
        cmax = fmaxf(cmax, vals[i]);
      }
      cmax = sis::warp_max(cmax);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, cmax);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kCH / 32; ++i) {
        const float p = expf(vals[i] - m_new);
        pr[lane + 32 * i] = p;
        psum += p;
      }
      psum = sis::warp_sum(psum);
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
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kCH;
      if (o < rd) {
        const int r = o / D;
        const int d = o % D;
        const float* pr = p_s + r * kCH;
        float a = acc[j] * a_s[r];
        for (int tt = 0; tt < nc; ++tt)
          a = fmaf(pr[tt] * vsc_s[tt], static_cast<float>(v_s[tt * D + d]), a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kCH;
    if (o < rd) {
      const int r = o / D;
      out[q_base + o] = sis::from_f<TQ>(acc[j] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

}  // namespace

extern "C" int sis_decode_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* lengths,
                                    void* out, int S, int T, int Hkv, int rep, int D,
                                    int q_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep > kMaxRep || rep * D > kMaxOut * kCH || D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)kCH * D + sizeof(float) * ((size_t)rep * D + (size_t)rep * kCH + kCH + 3 * rep);
  const dim3 grid(Hkv, S);
  const float inv = 1.f / sqrtf(static_cast<float>(D));
  if (q_dtype == sis::kBF16) {
    decode_attention_kernel<__nv_bfloat16><<<grid, kCH, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), T, Hkv, rep, D, inv);
  } else {
    decode_attention_kernel<float><<<grid, kCH, smem, st>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(lengths),
        static_cast<float*>(out), T, Hkv, rep, D, inv);
  }
  return static_cast<int>(cudaGetLastError());
}
