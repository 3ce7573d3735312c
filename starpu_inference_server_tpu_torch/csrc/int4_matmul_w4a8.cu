// int4_matmul_w4a8: y[M,N] f32 = (x_q[M,K] @ unpack(w_p4[K/2,N])) * x_scale[M] * scale[N]
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/pallas_kernels.py
// int4_matmul_w4a8 (_int4_w4a8_kernel). Same function: int8 activations
// (per-row scales from ops/quant.py quantize_activations) times the
// pairwise-packed int4 weight (low nibble = row 2a, high nibble = row
// 2a+1, sign-extended), the product summed EXACTLY in int32, converted to
// f32 once and scaled as (acc * x_scale[m]) * scale[n]. Every llama-1b
// sum stays below 2^24 in magnitude (127 * 8 * 5504 < 5.6e6), so the
// result equals the plain version's float64 contraction bit for bit.
//
// Bound on the H100: at decode (M = 16 slots) the packed weight bytes
// (gate_up: 11.3 MB per call, 3.4 us), since each weight byte feeds 4 M
// integer operations, under the card's ~590 int8 operations per byte.
//
// Design: the tensor-core body of quant_matmul.cuh with its Int4S8
// policy: mma.sync m16n8k32 s8 x s8 -> s32, A (the int8 activations)
// through ldmatrix, K1's cp.async ring, tile variants and split-K plan
// (ops/matmul_kernels.py:w4a8_matmul_plan, its constants fitted to this
// kernel). A B register (4 consecutive k of one column) is built from
// two packed bytes in registers: nibbles masked, ordered by prmt and
// sign-extended bytewise. Split partials stay int32 in the workspace and
// the reduction adds them in int32 before the one conversion and the
// scales, so a split changes no bit.

#include "quant_matmul.cuh"

// ws: int32 [splits, M, N] when splits > 1 (else unused); variant and
// splits come from ops/matmul_kernels.py:w4a8_matmul_plan
extern "C" int sis_int4_matmul_w4a8(const void* x_q, const void* x_scale, const void* w_p4,
                                    const void* scale, void* y, void* ws, int M, int N, int K,
                                    int variant, int splits, void* stream) {
  using namespace sis::qmm;
  const Args args{x_q, static_cast<const float*>(x_scale), static_cast<const uint8_t*>(w_p4),
                  static_cast<const float*>(scale), static_cast<float*>(y), ws, M, N, K};
  return launch<Int4S8>(args, variant, splits, static_cast<cudaStream_t>(stream));
}
