// flat_decode_attention: decode_attention over the FLAT cache layout.
//
//   q [S, Hq, D] (bf16 or f32), k/v int8 [S, T, Hkv*D], k/v scales f32
//   [S, Hkv, T], lengths int32 [S]; slot s attends positions
//   0..lengths[s]. GQA: query head h*rep + r reads KV head h.
//   out [S, Hq, D]; ws as decode_attention.
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// decode_attention.py _flat_kernel (via _flat_decode_attention, the
// pallas_call at :608): the standard kernel's online softmax over the
// flat [C, Hkv*D] blocks, with per-head lane slices and scales applied to
// the logits.
//
// Bound on the H100: device-memory bytes, as decode_attention. Design:
// the K/V bytes of the flat layout are the standard layout's, so the
// kernel is decode_attention's (decode_mma.cuh for bf16 queries,
// common.cuh decode_attention_body for f32) with the scale address of
// DenseRows<true>: a (KV head, slot) reads a tile's scales as one
// contiguous run instead of at stride Hkv. Nothing is transposed or
// copied; on the same logical cache the result has decode_attention's
// bits.

#include "decode_mma.cuh"

namespace {

__global__ void __launch_bounds__(sis::kDecCH)
flat_decode_attention_f32(const float* __restrict__ q, const int8_t* __restrict__ k,
                          const int8_t* __restrict__ v, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ lengths,
                          float* __restrict__ out, int T, int Hkv, int rep, int group, int D,
                          float inv_sqrt_d) {
  sis::decode_attention_body(q, k, v, ks, vs, lengths, out, sis::DenseRows<true>{T, Hkv}, T,
                             Hkv, rep, group, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_flat_decode_attention(const void* q, const void* k, const void* v,
                                         const void* ks, const void* vs, const void* lengths,
                                         void* out, void* ws, int S, int T, int Hkv, int rep,
                                         int D, int q_dtype, int splits, int group_rows,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == sis::kBF16) {
    return sis::dmma::launch(
        sis::dmma::make_args(q, k, v, ks, vs, lengths, out, ws, T, 1, Hkv, rep, D, splits,
                             group_rows),
        sis::DenseRows<true>{T, Hkv}, S, st);
  }
  return sis::launch_decode(
      flat_decode_attention_f32, S, Hkv, rep, group_rows, D, st, static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, Hkv, rep, group_rows, D,
      1.f / sqrtf(static_cast<float>(D)));
}
