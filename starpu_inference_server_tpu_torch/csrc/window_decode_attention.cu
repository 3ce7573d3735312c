// window_decode_attention: W query rows per slot against the int8 KV cache
// (the speculative-decoding verify forward).
//
//   q [S, W, Hq, D] (bf16 or f32), k/v int8 [S, T, Hkv, D], k/v scales f32
//   [S, T, Hkv], lengths int32 [S]; row w of slot s sits at position
//   lengths[s] + w (its KV already written) and attends positions
//   <= lengths[s] + w. out [S, W, Hq, D]; ws: f32 workspace of the split
//   partials (null with one split).
//
// Replaces the TPU kernels starpu_inference_server_tpu/ops/
// decode_attention.py window_decode_attention (_grouped_window_kernel,
// slot-grouped grid, and _window_kernel, per-slot grid). One kernel covers
// both: the slot grouping was a fix for TPU grid-step overhead.
//
// Bound on the H100: device-memory bytes. A verify reads every live slot's
// int8 K/V rows and scales once, and does 4 * W * Hq * D operations a
// position (W = 5 or 9): still far below the card's ~295 a byte.
// Design (decode_mma.cuh for bf16 queries): one work item per (KV head,
// slot, context split) serves all W * rep query rows (20 or 36 at
// llama-1b: 2 or 3 m16 tiles) on the tensor cores, so the window reads
// the KV once (rows past 16 * (256 / D) go to further row groups, each
// reading the head's K/V again); the 4 warps split each 64-position
// tile's keys; the
// context is split over blocks at the verify's 16 slots
// (ops/decode_attention.py decode_split_plan) and the splits merged in
// order; tiles stop at lengths[s] + W - 1, as the TPU kernel's clamped kv
// index does. f32 queries keep the CUDA-core body (common.cuh
// window_attention).

#include "decode_mma.cuh"

namespace {

__global__ void __launch_bounds__(sis::kWinThreads)
window_decode_attention_f32(const float* __restrict__ q, const int8_t* __restrict__ k,
                            const int8_t* __restrict__ v, const float* __restrict__ ks,
                            const float* __restrict__ vs, const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int W, int Hkv, int rep, int group,
                            int D,
                            float inv_sqrt_d) {
  sis::window_attention(q, k, v, ks, vs, lengths, out, sis::DenseRows<false>{T, Hkv}, T, W, Hkv,
                        rep, group, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_window_decode_attention(const void* q, const void* k, const void* v,
                                           const void* ks, const void* vs,
                                           const void* lengths, void* out, void* ws, int S,
                                           int T, int W, int Hkv, int rep, int D, int q_dtype,
                                           int splits, int group_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == sis::kBF16) {
    return sis::dmma::launch(
        sis::dmma::make_args(q, k, v, ks, vs, lengths, out, ws, T, W, Hkv, rep, D, splits,
                             group_rows),
        sis::DenseRows<false>{T, Hkv}, S, st);
  }
  return sis::launch_window(
      window_decode_attention_f32, S, Hkv, W * rep, group_rows, D, st, static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(out), T, W, Hkv, rep, group_rows, D,
      1.f / sqrtf(static_cast<float>(D)));
}
