// int4_matmul: y[M,N] f32 = (bf16(x[M,K]) @ unpack(w_p4[K/2,N])) * scale[N]
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/pallas_kernels.py
// int4_matmul (_int4_matmul_kernel). Same function: x is rounded to
// bfloat16 inside the kernel (also when it arrives as f32), the packed
// weight is unpacked pairwise (low nibble = row 2a, high nibble = row
// 2a+1, sign-extended), products accumulate in f32 and the per-column
// scale is applied to the f32 accumulator. The output is f32; the caller
// (ops/nn.py:dense) casts it to the compute dtype.
//
// Bound on the H100: at decode (M = 128 slots) a packed weight byte
// feeds 4 * M = 512 FLOPs, above the card's ~295 bf16 FLOPs per byte of
// device memory, so the bf16 tensor-core rate bounds the dense layers
// (gate_up: 5.8 GFLOP, 5.8 us); at M = 1 (the lm_head of a prefill) the
// packed bytes do. Either way the kernel has to run on the tensor cores
// and keep every SM busy.
//
// Design: the tensor-core body of quant_matmul.cuh with its Int4Bf16
// policy (mma.sync m16n8k16 bf16 -> f32). int4 values are exact in bf16
// and x is bf16 by the function's definition, so every product is the
// one the plain version forms; only the order of the f32 sums changes.
// One packed byte holds w[2a][n] and w[2a+1][n], the two consecutive k of
// one B-fragment register, and becomes that register with integer ops
// and one exact bf16x2 fma. A ring of 3 stages of 64 k, three tile
// variants and a split of K chosen by
// ops/matmul_kernels.py:int4_matmul_plan fill the card; the split sums
// are added in split order by a second kernel (the same bits on every
// run). K2 and K6 share the body with their own unpack policies.

#include "quant_matmul.cuh"

// ws: f32 [splits, M, N] when splits > 1 (else unused); variant and splits
// come from ops/matmul_kernels.py:int4_matmul_plan
extern "C" int sis_int4_matmul(const void* x, const void* w_p4, const void* scale, void* y,
                               void* ws, int M, int N, int K, int x_dtype, int variant,
                               int splits, void* stream) {
  using namespace sis::qmm;
  const Args args{x, nullptr, static_cast<const uint8_t*>(w_p4), static_cast<const float*>(scale),
                  static_cast<float*>(y), ws, M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == sis::kBF16) return launch<Int4Bf16<__nv_bfloat16>>(args, variant, splits, st);
  return launch<Int4Bf16<float>>(args, variant, splits, st);
}
