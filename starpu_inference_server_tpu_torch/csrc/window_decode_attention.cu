// window_decode_attention: W query rows per slot against the int8 KV cache
// (the speculative-decoding verify forward).
//
//   q [S, W, Hq, D] (bf16 or f32), k/v int8 [S, T, Hkv, D], k/v scales f32
//   [S, T, Hkv], lengths int32 [S]; row w of slot s sits at position
//   lengths[s] + w (its KV already written) and attends positions
//   <= lengths[s] + w. out [S, W, Hq, D].
//
// Replaces the TPU kernels starpu_inference_server_tpu/ops/
// decode_attention.py window_decode_attention (_grouped_window_kernel,
// slot-grouped grid, and _window_kernel, per-slot grid). One kernel covers
// both: the slot grouping was a fix for TPU grid-step overhead.
//
// Bound on the H100: device-memory bytes. A verify reads every live slot's
// int8 K/V rows and scales once, and does 4 * W * Hq * D FLOPs per
// position (W = 5 or 9): still far below the card's ~295 FLOPs per byte.
// Design (common.cuh window_attention): one block per (KV head, slot)
// serves all W * rep query rows (20 or 36 at llama-1b), so the window does
// not read the KV W times, as looping the decode kernel over W would; the
// chunk loop stops at lengths[s] + W - 1, as the TPU kernel's clamped
// kv index does.

#include "common.cuh"

namespace {

template <typename TQ>
__global__ void __launch_bounds__(sis::kWinThreads)
window_decode_attention_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k,
                               const int8_t* __restrict__ v, const float* __restrict__ ks,
                               const float* __restrict__ vs, const int* __restrict__ lengths,
                               TQ* __restrict__ out, int T, int W, int Hkv, int rep, int D,
                               float inv_sqrt_d) {
  sis::window_attention<TQ>(q, k, v, ks, vs, lengths, out, sis::DenseRows<false>{T, Hkv}, T, W,
                            Hkv, rep, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_window_decode_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs,
                                           const void* lengths, void* out, int S, int T,
                                           int W, int Hkv, int rep, int D, int q_dtype,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv = 1.f / sqrtf(static_cast<float>(D));
  const int R = W * rep;
  if (q_dtype == sis::kBF16) {
    return sis::launch_window(
        window_decode_attention_kernel<__nv_bfloat16>, S, Hkv, R, D, st,
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(out), T, W, Hkv, rep, D, inv);
  }
  return sis::launch_window(
      window_decode_attention_kernel<float>, S, Hkv, R, D, st, static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, W, Hkv, rep, D, inv);
}
