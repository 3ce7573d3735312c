// flat_paged_decode_attention: paged_decode_attention over FLAT page
// pools.
//
//   q [S, Hq, D] (bf16 or f32); k/v pools int8 [N, page, Hkv*D], k/v
//   scale pools f32 [N, Hkv, page]; table int32 [S, max_pages]; lengths
//   int32 [S]. Slot s attends logical positions 0..lengths[s]; position p
//   lives in pool page table[s, p / page] at row p % page. out [S, Hq, D];
//   ws as paged_decode_attention.
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// decode_attention.py _flat_paged_kernel (via _flat_paged_decode_attention,
// the pallas_call at :746): the flat decode body with table-indirect
// page fetches.
//
// Bound on the H100: device-memory bytes, as paged_decode_attention.
// Design: paged_decode_attention's body (decode_mma.cuh with W = 1 for
// bf16 queries, common.cuh window_attention for f32) with the address of
// PagedRows<true>: each staged row goes through the table, its K/V bytes
// are read in place and its scale sits at (page * Hkv + h) * page_size +
// row. Rows past lengths[s] (table entries of page 0, the garbage page)
// are never staged. On the same logical pool the result has
// paged_decode_attention's bits.

#include "decode_mma.cuh"

namespace {

__global__ void __launch_bounds__(sis::kWinThreads)
flat_paged_decode_attention_f32(const float* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ table, const int* __restrict__ lengths, float* __restrict__ out,
    int max_pages, int page, int W, int Hkv, int rep, int group, int D, float inv_sqrt_d) {
  sis::window_attention(q, k, v, ks, vs, lengths, out,
                        sis::PagedRows<true>{table, max_pages, page, Hkv}, max_pages * page, W,
                        Hkv, rep, group, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_flat_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* table, const void* lengths, void* out, void* ws, int S, int max_pages,
    int page, int Hkv, int rep, int D, int q_dtype, int splits, int group_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const sis::PagedRows<true> rows{static_cast<const int*>(table), max_pages, page, Hkv};
  if (q_dtype == sis::kBF16) {
    return sis::dmma::launch(sis::dmma::make_args(q, k, v, ks, vs, lengths, out, ws,
                                                  max_pages * page, 1, Hkv, rep, D, splits,
                                                  group_rows),
                             rows, S, st);
  }
  return sis::launch_window(
      flat_paged_decode_attention_f32, S,
      Hkv, 1 * rep, group_rows, D, st, static_cast<const float*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), rows.table,
      static_cast<const int*>(lengths), static_cast<float*>(out), max_pages, page, 1, Hkv,
      rep, group_rows, D, 1.f / sqrtf(static_cast<float>(D)));
}
