// flat_paged_decode_attention: paged_decode_attention over FLAT page
// pools.
//
//   q [S, Hq, D] (bf16 or f32); k/v pools int8 [N, page, Hkv*D], k/v
//   scale pools f32 [N, Hkv, page]; table int32 [S, max_pages]; lengths
//   int32 [S]. Slot s attends logical positions 0..lengths[s]; position p
//   lives in pool page table[s, p / page] at row p % page. out [S, Hq, D].
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// decode_attention.py _flat_paged_kernel (via _flat_paged_decode_attention,
// the pallas_call at :746): the flat decode body with table-indirect
// page fetches.
//
// Bound on the H100: device-memory bytes, as paged_decode_attention.
// Design: paged_decode_attention's body (common.cuh window_attention with
// W = 1) with the address of PagedRows<true>: each staged row goes
// through the table, its K/V bytes are read in place and its scale sits
// at (page * Hkv + h) * page_size + row, so a chunk inside one page reads
// its scales as one contiguous run per head. Rows past lengths[s] (table
// entries of page 0, the garbage page) are never staged. On the same
// logical pool the result has paged_decode_attention's bits.

#include "common.cuh"

namespace {

template <typename TQ>
__global__ void __launch_bounds__(sis::kWinThreads)
flat_paged_decode_attention_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k,
                                   const int8_t* __restrict__ v, const float* __restrict__ ks,
                                   const float* __restrict__ vs, const int* __restrict__ table,
                                   const int* __restrict__ lengths, TQ* __restrict__ out,
                                   int max_pages, int page, int Hkv, int rep, int D,
                                   float inv_sqrt_d) {
  sis::window_attention<TQ>(q, k, v, ks, vs, lengths, out,
                            sis::PagedRows<true>{table, max_pages, page, Hkv}, max_pages * page,
                            1, Hkv, rep, D, inv_sqrt_d);
}

}  // namespace

extern "C" int sis_flat_paged_decode_attention(const void* q, const void* k, const void* v,
                                               const void* ks, const void* vs,
                                               const void* table, const void* lengths,
                                               void* out, int S, int max_pages, int page,
                                               int Hkv, int rep, int D, int q_dtype,
                                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float inv = 1.f / sqrtf(static_cast<float>(D));
  if (q_dtype == sis::kBF16) {
    return sis::launch_window(
        flat_paged_decode_attention_kernel<__nv_bfloat16>, S, Hkv, rep, D, st,
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(table),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), max_pages, page,
        Hkv, rep, D, inv);
  }
  return sis::launch_window(
      flat_paged_decode_attention_kernel<float>, S, Hkv, rep, D, st,
      static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), max_pages, page, Hkv, rep, D,
      inv);
}
