// bidirectional_attention: flash self-attention of encoder layers.
//
//   q [B, T, Hq, D], k/v [B, T, Hkv, D] (bf16 or f32, one dtype),
//   key_bias f32 [B, T] (0 = attend, -1e9 = masked key), GQA without
//   repeats (query head h*rep+r reads KV head h); every query attends
//   every key: out = softmax(q k^T / sqrt(D) + key_bias) v, in the input
//   dtype, [B, T, Hq, D].
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// prefill_attention.py bidirectional_attention (_bidir_kernel with
// _flash_update). The mask stays ADDITIVE as there: a sample whose keys
// are all masked (every bias -1e9, as in a padding row of a batch
// bucket) gets the plain mean of v, like XLA and the TPU kernel, where
// a -inf mask would give NaN.
//
// Bound on the H100: on the path (BERT-base, B <= 16, T = 512, H = 12,
// D = 64) the 50 MB of q, k, v and out at the memory rate (15 us at
// B = 16) and the 4*B*H*T*T*D = 12.9 GFLOP at the bf16 tensor-core rate
// (13 us) are about even, bytes by a little. This first kernel computes
// in f32 on CUDA cores, so its own limit is the FMA rate (~67 TFLOP/s,
// 190 us), and the tensor cores are the way to the bound. Design: the causal kernel's shape
// (csrc/causal_attention.cu) with no causal skip: one block per (query
// tile, KV head, batch row), 128 threads = the tile's query rows for all
// rep heads, q row and f32 accumulator in registers; the block stages
// 64-key chunks of K, V and the key bias in shared memory once for all
// 128 rows and runs the online softmax (common.cuh FlashRow). q/k/v are
// read in place from the [B, T, H, D] layout that a reshape of the
// projections gives; the [Hq, T, T] scores never exist in device memory.

#include "common.cuh"

namespace {

constexpr int kRows = 128;
constexpr int kSB = 16;

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
bidirectional_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ bias,
                               T* __restrict__ out, int Tlen, int Hkv, int rep,
                               float inv_sqrt_d) {
  constexpr int BK = 4096 / D;  // keys per staged chunk (32 KB of K+V)
  __shared__ __align__(16) float ks_s[BK * D];
  __shared__ __align__(16) float vs_s[BK * D];
  __shared__ float bs_s[BK];

  const int bq = kRows / rep;  // query positions per tile
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t = q0 + tid / rep;
  const int head = h * rep + tid % rep;
  const int hq = Hkv * rep;

  sis::FlashRow<D, kSB> row;
  row.init();
  if (t < Tlen) {
    const T* qr = q + (((size_t)b * Tlen + t) * hq + head) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) row.q[d] = sis::to_f(qr[d]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) row.q[d] = 0.f;
  }

  for (int k0 = 0; k0 < Tlen; k0 += BK) {
    const int nk = min(BK, Tlen - k0);
    __syncthreads();
    for (int i = tid; i < BK * D; i += kRows) {
      const int j = i / D;
      const int d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = (((size_t)b * Tlen + k0 + j) * Hkv + h) * D + d;
        kv = sis::to_f(k[off]);
        vv = sis::to_f(v[off]);
      }
      ks_s[i] = kv;
      vs_s[i] = vv;
    }
    for (int j = tid; j < BK; j += kRows) bs_s[j] = j < nk ? bias[(size_t)b * Tlen + k0 + j] : 0.f;
    __syncthreads();
    row.consume_bias(ks_s, vs_s, bs_s, nk, inv_sqrt_d);
  }
  if (t < Tlen) row.store(out + (((size_t)b * Tlen + t) * hq + head) * D);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int Tlen, int Hkv, int rep, int D, cudaStream_t st) {
  const int bq = kRows / rep;
  const dim3 grid((Tlen + bq - 1) / bq, Hkv, B);
  const float inv = 1.f / sqrtf(static_cast<float>(D));
  const float* kb = static_cast<const float*>(bias);
  if (D == 64) {
    bidirectional_attention_kernel<T, 64><<<grid, kRows, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kb,
        static_cast<T*>(out), Tlen, Hkv, rep, inv);
  } else if (D == 128) {
    bidirectional_attention_kernel<T, 128><<<grid, kRows, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kb,
        static_cast<T*>(out), Tlen, Hkv, rep, inv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sis_bidirectional_attention(const void* q, const void* k, const void* v,
                                           const void* key_bias, void* out, int B, int Tlen,
                                           int Hkv, int rep, int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1 || kRows % rep != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == sis::kBF16)
    return launch<__nv_bfloat16>(q, k, v, key_bias, out, B, Tlen, Hkv, rep, D, st);
  return launch<float>(q, k, v, key_bias, out, B, Tlen, Hkv, rep, D, st);
}
