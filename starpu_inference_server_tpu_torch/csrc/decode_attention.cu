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
// Design (common.cuh decode_attention_body, shared with
// flat_decode_attention.cu): one block per (KV head, slot) serves the
// head's `rep` query heads, so each K/V byte is read once, and the loop
// over 128-position chunks stops at the slot's length.

#include "common.cuh"

namespace {

template <typename TQ>
__global__ void __launch_bounds__(sis::kDecCH)
decode_attention_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k,
                        const int8_t* __restrict__ v, const float* __restrict__ ks,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        TQ* __restrict__ out, int T, int Hkv, int rep, int D,
                        float inv_sqrt_d) {
  sis::decode_attention_body<TQ>(q, k, v, ks, vs, lengths, out, sis::DenseRows<false>{T, Hkv},
                                 T, Hkv, rep, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_decode_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* lengths,
                                    void* out, int S, int T, int Hkv, int rep, int D,
                                    int q_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv = 1.f / sqrtf(static_cast<float>(D));
  if (q_dtype == sis::kBF16) {
    return sis::launch_decode(
        decode_attention_kernel<__nv_bfloat16>, S, Hkv, rep, D, st,
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), T, Hkv, rep, D, inv);
  }
  return sis::launch_decode(
      decode_attention_kernel<float>, S, Hkv, rep, D, st, static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, Hkv, rep, D, inv);
}
