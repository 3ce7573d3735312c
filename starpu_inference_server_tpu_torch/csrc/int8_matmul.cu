// int8_matmul: y[M,N] f32 = (bf16(x[M,K]) @ w_q[K,N]) * scale[N]
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/pallas_kernels.py
// int8_matmul (_matmul_kernel). Same function: x is rounded to bfloat16
// inside the kernel (also when it arrives as f32), the int8 weight values
// are exact, products accumulate in f32 and the per-column scale is
// applied to the f32 accumulator. The output is f32; the caller
// (ops/nn.py:dense, which routes int8 weights here at <= 64 rows) casts
// it to the compute dtype.
//
// Bound on the H100: on the path (every dense layer of an int8 decode
// step, M = 16 or 64 slots, K x N up to 2048 x 11008 and 2048 x 32000;
// the ResNet-18 fc, M <= 32, K = 512, N = 1000) a weight byte feeds 2 M
// FLOPs, under the card's ~295 bf16 FLOPs per byte: the int8 weight
// bytes at the memory rate bound it (gate_up: 22.5 MB, 6.7 us).
//
// Design: the tensor-core body of quant_matmul.cuh with its Int8Bf16
// policy: mma.sync m16n8k16 bf16 -> f32, A from the bf16-rounded x through
// ldmatrix, a cp.async ring of weight tiles, the tile variant and split of
// K from ops/matmul_kernels.py:int8_matmul_plan (every path shape launches
// a block per SM, and the weight is read once per 16- or 64-row band),
// and a split-order reduction with no atomics. A weight byte becomes a
// bf16 operand exactly: the byte (biased by 128) is placed in the low
// bits of the f32 2^23 by one prmt, 2^23 + 128 is subtracted, and
// cvt.rn.bf16x2.f32 packs two k of one column into a B register, exact
// for |v| <= 128. Every product is then the one the plain version forms;
// only the order of the f32 sums changes. A ragged N (the fc's 1000) is
// masked in the kernel: no padded weight copy.

#include "quant_matmul.cuh"

// ws: f32 [splits, M, N] when splits > 1 (else unused); variant and splits
// come from ops/matmul_kernels.py:int8_matmul_plan
extern "C" int sis_int8_matmul(const void* x, const void* w_q, const void* scale, void* y,
                               void* ws, int M, int N, int K, int x_dtype, int variant,
                               int splits, void* stream) {
  using namespace sis::qmm;
  const Args args{x, nullptr, static_cast<const uint8_t*>(w_q), static_cast<const float*>(scale),
                  static_cast<float*>(y), ws, M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == sis::kBF16) return launch<Int8Bf16<__nv_bfloat16>>(args, variant, splits, st);
  return launch<Int8Bf16<float>>(args, variant, splits, st);
}
