// flat_window_decode_attention: window_decode_attention (the
// speculative-decoding verify forward) over the FLAT cache layout.
//
//   q [S, W, Hq, D] (bf16 or f32), k/v int8 [S, T, Hkv*D], k/v scales f32
//   [S, Hkv, T], lengths int32 [S]; row w of slot s sits at position
//   lengths[s] + w (its KV already written) and attends positions
//   <= lengths[s] + w. out [S, W, Hq, D]; ws as window_decode_attention.
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// decode_attention.py _flat_window_kernel (via
// _flat_window_decode_attention, the pallas_call at :676).
//
// Bound on the H100: device-memory bytes, as window_decode_attention.
// Design: window_decode_attention's body (decode_mma.cuh for bf16
// queries, common.cuh window_attention for f32) with the scale address of
// DenseRows<true>; the K/V bytes are read in place and the scales of a
// staged tile lie in one contiguous run per head. Nothing is transposed or
// copied; on the same logical cache the result has
// window_decode_attention's bits.

#include "decode_mma.cuh"

namespace {

__global__ void __launch_bounds__(sis::kWinThreads)
flat_window_decode_attention_f32(const float* __restrict__ q, const int8_t* __restrict__ k,
                                 const int8_t* __restrict__ v, const float* __restrict__ ks,
                                 const float* __restrict__ vs, const int* __restrict__ lengths,
                                 float* __restrict__ out, int T, int W, int Hkv, int rep,
                                 int group, int D,
                                 float inv_sqrt_d) {
  sis::window_attention(q, k, v, ks, vs, lengths, out, sis::DenseRows<true>{T, Hkv}, T, W, Hkv,
                        rep, group, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_flat_window_decode_attention(const void* q, const void* k, const void* v,
                                                const void* ks, const void* vs,
                                                const void* lengths, void* out, void* ws, int S,
                                                int T, int W, int Hkv, int rep, int D,
                                                int q_dtype, int splits, int group_rows,
                                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == sis::kBF16) {
    return sis::dmma::launch(
        sis::dmma::make_args(q, k, v, ks, vs, lengths, out, ws, T, W, Hkv, rep, D, splits,
                             group_rows),
        sis::DenseRows<true>{T, Hkv}, S, st);
  }
  return sis::launch_window(
      flat_window_decode_attention_f32, S, Hkv, W * rep, group_rows, D, st,
      static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, W, Hkv, rep, group_rows, D,
      1.f / sqrtf(static_cast<float>(D)));
}
