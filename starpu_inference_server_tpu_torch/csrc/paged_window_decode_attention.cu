// paged_window_decode_attention: W query rows per slot against the paged
// int8 KV cache (the speculative-decoding verify forward on a paged
// cache).
//
//   q [S, W, Hq, D] (bf16 or f32); k/v pools int8 [N, page, Hkv, D], k/v
//   scale pools f32 [N, page, Hkv]; table int32 [S, max_pages]; lengths
//   int32 [S]. Row w of slot s sits at logical position lengths[s] + w and
//   attends logical positions <= lengths[s] + w. out [S, W, Hq, D]; ws as
//   paged_decode_attention.
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// decode_attention.py paged_window_decode_attention
// (_paged_window_kernel: the window kernel's body with table-indirect
// fetches).
//
// Bound on the H100: device-memory bytes (the live rows of every slot's
// pages, read once). Design: the dense window kernel's body
// (decode_mma.cuh for bf16 queries, common.cuh window_attention for f32),
// all W * rep rows of a (KV head, slot, split) together, with every staged
// position's row looked up in the table separately: a window may cross a
// page boundary (lengths + W - 1 can fall in the next page, which the
// allocator reserves as headroom), and nothing assumes a tile or a window
// lies in one page.

#include "decode_mma.cuh"

namespace {

__global__ void __launch_bounds__(sis::kWinThreads)
paged_window_decode_attention_f32(const float* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ table, const int* __restrict__ lengths, float* __restrict__ out,
    int max_pages, int page, int W, int Hkv, int rep, int group, int D, float inv_sqrt_d) {
  sis::window_attention(q, k, v, ks, vs, lengths, out,
                        sis::PagedRows<false>{table, max_pages, page, Hkv}, max_pages * page, W,
                        Hkv, rep, group, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_paged_window_decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* table, const void* lengths, void* out, void* ws, int S, int max_pages,
    int page, int W, int Hkv, int rep, int D, int q_dtype, int splits, int group_rows,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const sis::PagedRows<false> rows{static_cast<const int*>(table), max_pages, page, Hkv};
  if (q_dtype == sis::kBF16) {
    return sis::dmma::launch(sis::dmma::make_args(q, k, v, ks, vs, lengths, out, ws,
                                                  max_pages * page, W, Hkv, rep, D, splits,
                                                  group_rows),
                             rows, S, st);
  }
  return sis::launch_window(
      paged_window_decode_attention_f32, S,
      Hkv, W * rep, group_rows, D, st, static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), rows.table,
      static_cast<const int*>(lengths), static_cast<float*>(out), max_pages, page, W, Hkv,
      rep, group_rows, D, 1.f / sqrtf(static_cast<float>(D)));
}
