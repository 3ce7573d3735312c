// decode_attention: one query token per slot against the int8 KV cache.
//
//   q [S, Hq, D] (bf16 or f32), k/v int8 [S, T, Hkv, D], k/v scales f32
//   [S, T, Hkv], lengths int32 [S]; slot s attends positions
//   0..lengths[s] (the new token sits at lengths[s]). GQA: query head
//   h*rep + r reads KV head h; nothing is repeated. out [S, Hq, D].
//   ws: f32 workspace of the split partials (null with one split).
//
// Replaces the TPU kernels starpu_inference_server_tpu/ops/
// decode_attention.py decode_attention (_grouped_kernel, slot-grouped
// grid, and _kernel, per-slot grid). One kernel covers both: the slot
// grouping was a fix for TPU grid-step overhead and is not needed here.
//
// Bound on the H100: device-memory bytes. Each step reads every live
// slot's int8 K/V rows and their scales once; the operations are ~2 a
// byte. Design: bf16 queries take decode_mma.cuh (the W = 1 case of the
// tensor-core body shared by all eight decode-side kernels): one work
// item per (KV head, row group, slot, context split) serves the head's
// rep query heads (one row group of one or two m16 tiles up to rep 32 at
// D = 64; MQA's 71 heads are two groups), its 4 warps split the keys of
// each 64-position tile, the int8 rows widen to bf16 in registers, and
// the context is split over blocks when the work items alone leave the
// card empty
// (ops/decode_attention.py decode_split_plan), the splits merged in
// order by a second kernel. f32 queries keep the CUDA-core body
// (common.cuh decode_attention_body), shared with
// flat_decode_attention.cu.

#include "decode_mma.cuh"

namespace {

__global__ void __launch_bounds__(sis::kDecCH)
decode_attention_f32(const float* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ lengths,
                     float* __restrict__ out, int T, int Hkv, int rep, int group, int D,
                     float inv_sqrt_d) {
  sis::decode_attention_body(q, k, v, ks, vs, lengths, out, sis::DenseRows<false>{T, Hkv}, T,
                             Hkv, rep, group, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_decode_attention(const void* q, const void* k, const void* v,
                                    const void* ks, const void* vs, const void* lengths,
                                    void* out, void* ws, int S, int T, int Hkv, int rep, int D,
                                    int q_dtype, int splits, int group_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == sis::kBF16) {
    return sis::dmma::launch(
        sis::dmma::make_args(q, k, v, ks, vs, lengths, out, ws, T, 1, Hkv, rep, D, splits,
                             group_rows),
        sis::DenseRows<false>{T, Hkv}, S, st);
  }
  return sis::launch_decode(
      decode_attention_f32, S, Hkv, rep, group_rows, D, st, static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, Hkv, rep, group_rows, D,
      1.f / sqrtf(static_cast<float>(D)));
}
