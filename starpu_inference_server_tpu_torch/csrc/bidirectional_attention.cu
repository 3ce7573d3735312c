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
// bf16 (the path's): tensor-core flash attention. One block of 4 warps
// owns 64 query rows of one (query head, batch row), 16 rows a warp; grid
// (T/64, Hq, B). The block's Q tile comes in by cp.async and stays in
// registers as A fragments. 64-key K and V tiles (one row = D contiguous
// bf16 of [B, T, Hkv, D]) and their bias arrive through a cp.async double
// buffer, rows padded by 16 bytes so ldmatrix is conflict-free.
// S = Q K^T is mma.sync m16n8k16 into f32; the online softmax runs on the
// accumulator fragments (a row lives in one quad: max and sum take two
// shuffles); P becomes bf16 A fragments in registers, where the m16n8k16
// accumulator layout is already the A layout of P V, and V is read with
// ldmatrix.trans. Keys past T are zero-filled and biased by -1e30, so
// ragged T needs no other test. The block owns every key of its rows, so
// the result is the same on every run. P is NOT rounded to one bf16: the
// plain version keeps f32 probabilities (the TPU kernel's arithmetic),
// and one bf16 moves each weight by up to 2^-8 of itself, an output by
// up to 2^-8 |v_j - out|, which breaks the 2^-7 |ref| + 1e-3 that
// chip_smoke.py holds attention kernels to wherever an output cancels
// towards 0. So P is split into hi = bf16(p) and lo = bf16(p - hi), two
// mma per P V tile, which carries p to 2^-16: the P V half of the work
// doubles (the whole kernel's mma count by half) to keep f32 weights.
//
// f32: one query row per thread on CUDA cores (common.cuh FlashRow), f32
// probabilities: the FP32 witnesses hold kernels on against off to 1e-5,
// which bf16 operands would break. One block per (query tile, KV head,
// batch row), 128 threads = the tile's query rows for all rep heads; the
// block stages 64-key chunks of K, V and the bias in shared memory once
// for all 128 rows. The [Hq, T, T] scores never exist in device memory on
// either route.

#include "common.cuh"

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

// -- bf16: tensor-core flash attention ---------------------------------------

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBKV = 64;      // keys per staged tile
constexpr int kWarps = 4;

template <int D>
struct MmaSmem {
  static constexpr int kRow = D + 8;  // padded row, bf16 (16 bytes past D)
  static constexpr size_t kBytes = (size_t)(kBQ + 4 * kBKV) * kRow * 2 + 2 * kBKV * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
bidirectional_attention_mma(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                            int Tlen, int Hkv, int rep, float inv_sqrt_d) {
  constexpr int RW = MmaSmem<D>::kRow;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int KC = D / 16;  // k16 steps of Q K^T
  constexpr int NT = kBKV / 8;  // n8 tiles of S
  constexpr int DT = D / 8;  // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBQ][RW]
  __nv_bfloat16* k_s = q_s + kBQ * RW;                            // [2][kBKV][RW]
  __nv_bfloat16* v_s = k_s + 2 * kBKV * RW;                       // [2][kBKV][RW]
  float* b_s = reinterpret_cast<float*>(v_s + 2 * kBKV * RW);     // [2][kBKV]

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = head / rep;
  const int hq = Hkv * rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c4 = lane % 4;

  for (int i = tid; i < kBQ * CH; i += 32 * kWarps) {
    const int r = i / CH;
    const int t = q0 + r;
    const bool ok = t < Tlen;
    sis::cp_async16(q_s + r * RW + (i % CH) * 8,
                    q + (((size_t)b * Tlen + (ok ? t : 0)) * hq + head) * D + (i % CH) * 8, ok);
  }
  auto load_kv = [&](int j0, int slot) {
    for (int i = tid; i < kBKV * CH; i += 32 * kWarps) {
      const int r = i / CH;
      const int t = j0 + r;
      const bool ok = t < Tlen;
      const size_t off = (((size_t)b * Tlen + (ok ? t : 0)) * Hkv + hkv) * D + (i % CH) * 8;
      sis::cp_async16(k_s + (slot * kBKV + r) * RW + (i % CH) * 8, k + off, ok);
      sis::cp_async16(v_s + (slot * kBKV + r) * RW + (i % CH) * 8, v + off, ok);
    }
    for (int j = tid; j < kBKV; j += 32 * kWarps)
      b_s[slot * kBKV + j] = j0 + j < Tlen ? bias[(size_t)b * Tlen + j0 + j] : sis::kNeg;
  };

  const int ntiles = (Tlen + kBKV - 1) / kBKV;
  load_kv(0, 0);
  sis::cp_async_commit();

  uint32_t qf[KC][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {sis::kNeg, sis::kNeg};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv((it + 1) * kBKV, (it + 1) % 2);
    sis::cp_async_commit();
    sis::cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        sis::ldmatrix_x4(qf[kc], q_s + (warp * 16 + lane % 16) * RW + kc * 16 + (lane / 16) * 8);
    }
    const int slot = it % 2;
    const __nv_bfloat16* ks = k_s + slot * kBKV * RW;
    const __nv_bfloat16* vs = v_s + slot * kBKV * RW;
    const float* bs = b_s + slot * kBKV;

    // S = Q K^T: n-tile pair np covers keys 16 np .. 16 np + 15
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        sis::ldmatrix_x4(kb, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * RW + kc * 16 +
                                 ((lane / 8) % 2) * 8);
        sis::mma_bf16(s[2 * np], qf[kc], kb[0], kb[1]);
        sis::mma_bf16(s[2 * np + 1], qf[kc], kb[2], kb[3]);
      }
    }

    // logits (scale, then bias) and the online-softmax update of rows g, g + 8
    float mx[2] = {sis::kNeg, sis::kNeg};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = bs[j * 8 + 2 * c4];
      const float b1 = bs[j * 8 + 2 * c4 + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[j][2 * h] = __fadd_rn(__fmul_rn(s[j][2 * h], inv_sqrt_d), b0);
        s[j][2 * h + 1] = __fadd_rn(__fmul_rn(s[j][2 * h + 1], inv_sqrt_d), b1);
        mx[h] = fmaxf(mx[h], fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = __expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, 16 keys at a time. P goes into two bf16 A fragments
    // straight from S: hi = bf16(p) and lo = bf16(p - hi), so hi + lo
    // carries p to 2^-16 of itself
#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // n-tiles 2 kc (a0, a1) and 2 kc + 1 (a2, a3)
        const float* sj = s[2 * kc + half];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g, g + 8
          const float p0 = __expf(sj[2 * h] - m_run[h]);
          const float p1 = __expf(sj[2 * h + 1] - m_run[h]);
          l_run[h] += p0 + p1;
          const uint32_t hi = sis::pack_bf16x2(p0, p1);
          ph[2 * half + h] = hi;
          pl[2 * half + h] = sis::pack_bf16x2(p0 - sis::bf16_lo(hi), p1 - sis::bf16_hi(hi));
        }
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        sis::ldmatrix_x4_trans(vb, vs + (kc * 16 + lane % 16) * RW + dp * 16 + (lane / 16) * 8);
        sis::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        sis::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        sis::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        sis::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this slot is refilled by the next iteration's load
  }
  sis::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int t = q0 + warp * 16 + g + 8 * h;
    if (t >= Tlen) continue;
    __nv_bfloat16* dst = out + (((size_t)b * Tlen + t) * hq + head) * D + 2 * c4;
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) =
          sis::pack_bf16x2(o[i][2 * h] * inv, o[i][2 * h + 1] * inv);
  }
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
  auto kernel = bidirectional_attention_mma<D>;
  constexpr size_t smem = MmaSmem<D>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Tlen + kBQ - 1) / kBQ, Hkv * rep, B);
  kernel<<<grid, 32 * kWarps, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), Tlen, Hkv, rep, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
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
