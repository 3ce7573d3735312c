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
// _flash_update). The mask stays ADDITIVE as there, applied after the
// 1/sqrt(D) scale: a sample whose keys are all masked (every bias -1e9,
// as in a padding row of a batch bucket) gets the plain mean of v, like
// XLA and the TPU kernel, where a -inf mask would give NaN. The final
// division is by max(l, 1e-30).
//
// Bound on the H100: on the path (BERT-base, B <= 16, T = 512, H = 12,
// D = 64) the 50 MB of q, k, v and out at the memory rate (15 us at
// B = 16) and the 4*B*H*T*T*D = 12.9 GFLOP at the bf16 tensor-core rate
// (13 us) are about even, bytes by a little. So both products have to
// run on the tensor cores, and every K/V byte should be read once per
// 64 query rows, not once per row.
//
// Two routes, chosen by dtype (not a fallback: each is the kernel of its
// dtype):
//
// bf16 (the path's): tensor-core flash attention, the tile of
// flash_mma.cuh (shared with causal_attention and
// chunk_prefill_attention) with its BiasKeys source. One block of 4 warps
// owns 64 query rows of one (query head, batch row); grid (T/64, Hq, B).
// Q K^T and P V run on mma.sync, K/V tiles and their bias arrive through
// a cp.async double buffer, and keys past T are zero-filled and biased by
// -1e30, so ragged T needs no other test. P is NOT rounded to one bf16:
// the plain version keeps f32 probabilities (the TPU kernel's
// arithmetic), and one bf16 moves an output by up to 2^-8 |v_j - out|,
// which breaks the 2^-7 |ref| + 1e-3 that chip_smoke.py holds attention
// kernels to wherever an output cancels towards 0; P goes into the P V
// product as hi + lo bf16 terms (the whole kernel's mma count x1.5).
//
// f32: one query row per thread on CUDA cores (common.cuh FlashRow), f32
// probabilities: the FP32 witnesses hold kernels on against off to 1e-5,
// which bf16 operands would break. One block per (query tile, KV head,
// batch row), 128 threads = the tile's query rows for all rep heads; the
// block stages 64-key chunks of K, V and the bias in shared memory once
// for all 128 rows. The [Hq, T, T] scores never exist in device memory on
// either route.

#include "flash_mma.cuh"

namespace {

// -- f32: one query row per thread -------------------------------------------

constexpr int kRows = 128;
constexpr int kSB = 16;

template <int D>
__global__ void __launch_bounds__(kRows)
bidirectional_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ out, int Tlen, int Hkv, int rep,
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
    const float* qr = q + (((size_t)b * Tlen + t) * hq + head) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) row.q[d] = qr[d];
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
        kv = k[off];
        vv = v[off];
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

// -- bf16: tensor-core flash attention (flash_mma.cuh) ------------------------

template <int D>
__global__ void __launch_bounds__(sis::flash::kThreads)
bidirectional_attention_mma(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                            int Tlen, int Hkv, int rep, float inv_sqrt_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const sis::flash::QRows rows{b, Tlen, Hkv * rep, (int)blockIdx.x * sis::flash::kBQ, head};
  const size_t base = ((size_t)b * Tlen * Hkv + head / rep) * D;
  const sis::flash::BiasKeys<D> keys{k + base, v + base, bias + (size_t)b * Tlen,
                                     (size_t)Hkv * D, Tlen, inv_sqrt_d};
  sis::flash::attend<D>(q, out, rows, keys, smem);
}

int launch_f32(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
               int Tlen, int Hkv, int rep, int D, cudaStream_t st) {
  const int bq = kRows / rep;
  const dim3 grid((Tlen + bq - 1) / bq, Hkv, B);
  const float inv = 1.f / sqrtf(static_cast<float>(D));
  const float* kb = static_cast<const float*>(bias);
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  if (D == 64) {
    bidirectional_attention_f32<64><<<grid, kRows, 0, st>>>(qf, kf, vf, kb,
                                                            static_cast<float*>(out), Tlen, Hkv,
                                                            rep, inv);
  } else if (D == 128) {
    bidirectional_attention_f32<128><<<grid, kRows, 0, st>>>(qf, kf, vf, kb,
                                                             static_cast<float*>(out), Tlen, Hkv,
                                                             rep, inv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
               int Tlen, int Hkv, int rep, cudaStream_t st) {
  const dim3 grid((Tlen + sis::flash::kBQ - 1) / sis::flash::kBQ, Hkv * rep, B);
  return sis::flash::launch<D>(
      bidirectional_attention_mma<D>, grid, false, st, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), Tlen, Hkv, rep,
      1.f / sqrtf(static_cast<float>(D)));
}

}  // namespace

extern "C" int sis_bidirectional_attention(const void* q, const void* k, const void* v,
                                           const void* key_bias, void* out, int B, int Tlen,
                                           int Hkv, int rep, int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1 || kRows % rep != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != sis::kBF16) return launch_f32(q, k, v, key_bias, out, B, Tlen, Hkv, rep, D, st);
  if (D == 64) return launch_mma<64>(q, k, v, key_bias, out, B, Tlen, Hkv, rep, st);
  if (D == 128) return launch_mma<128>(q, k, v, key_bias, out, B, Tlen, Hkv, rep, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
