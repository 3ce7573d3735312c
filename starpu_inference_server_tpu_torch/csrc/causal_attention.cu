// causal_attention: flash causal self-attention over a prefill block.
//
//   q [B, T, Hq, D], k/v [B, T, Hkv, D] (bf16 or f32, one dtype);
//   query t attends keys 0..t; GQA without repeats (query head h*rep+r
//   reads KV head h). out [B, T, Hq, D] in the input dtype.
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// prefill_attention.py causal_attention (_causal_kernel). Rows past the
// prompt length are padding: computed, never read (the decoder ignores
// them), exactly as on the TPU.
//
// Bound on the H100: at the main-path shapes (prefill buckets 64 to 512)
// the least time is the few MB of q, k, v and out at the memory rate,
// with the bf16 tensor-core time for the ~T*T/2*Hq*D*4 FLOPs close
// behind; at T <= 512 a call is too short to reach either, and the grid
// (T/64 tiles x heads) sets how much of the card it fills.
//
// Two routes, chosen by dtype (not a fallback: each is the kernel of its
// dtype):
//
// bf16 (the path's): the tensor-core tile of flash_mma.cuh with its
// CausalKeys source. Key tiles wholly above a block's last query position
// are never loaded (the TPU kernel skips them the same way), only the
// diagonal tile masks per element (-1e30, the plain version's mask), and
// the grid runs the longest query tiles first (tile index reversed in
// the slowest grid dimension), which balances the triangle. A block holds
// 64 positions of one query head (grid (Hq, B, T/64)); the TPU's KV-major
// packing of 64 / rep positions x the rep heads of a KV head measured 1-5%
// slower on the H100 (PERF.md).
//
// f32: one query row per thread on CUDA cores (common.cuh FlashRow), f32
// probabilities, the kernel of the FP32 witnesses. One block per (query
// tile, KV head's head group, batch row); its 128 threads are the tile's
// query rows for the group's heads (f32_heads: all rep heads of the KV
// head up to 128, floor(128 / heads) query positions, the threads past
// them idle when heads does not divide 128), each holding its q row and
// f32 accumulator in registers. The block loops
// over 64-key chunks of K/V up to the tile's last query position, stages
// each chunk in shared memory once for all 128 rows, and runs the online
// softmax in sub-blocks of 16 keys. The [Hq, T, T] scores never exist in
// device memory on either route.
//
// Both routes take head_dim 32, 64, 80, 96, 128 and 256 and any rep. At
// 32 (llama-tiny) the f32 route is instantiated too, rather than sending
// f32 inputs through the tensor cores with bf16 operands: that would
// change the function the FP32 witnesses compute. At 256 its q row and
// accumulator (512 floats) live in local memory: correct, and slow.

#include "flash_mma.cuh"

namespace {

constexpr int kRows = 128;
constexpr int kSB = 16;

// the query heads of a block of the f32 route (all of a KV head's, up to
// kRows) and its head groups
inline int f32_heads(int rep) { return rep < kRows ? rep : kRows; }

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
causal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int Tlen, int Hkv,
                        int rep, int heads, float inv_sqrt_d) {
  constexpr int BK = 4096 / D / kSB * kSB;  // keys per staged chunk (<= 32 KB of K+V)
  __shared__ __align__(16) float ks_s[BK * D];
  __shared__ __align__(16) float vs_s[BK * D];

  const int bq = kRows / heads;  // query positions per tile
  const int groups = (rep + heads - 1) / heads;
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y / groups;
  const int r = (blockIdx.y % groups) * heads + threadIdx.x % heads;  // head of the KV head
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t = q0 + tid / heads;
  const int head = h * rep + r;
  const int hq = Hkv * rep;
  const bool mine = tid < bq * heads && r < rep && t < Tlen;

  sis::FlashRow<D, kSB> row;
  row.init();
  if (mine) {
    const T* qr = q + (((size_t)b * Tlen + t) * hq + head) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) row.q[d] = sis::to_f(qr[d]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) row.q[d] = 0.f;
  }

  const int last = min(q0 + bq, Tlen) - 1;  // last key any row of the tile needs
  for (int k0 = 0; k0 <= last; k0 += BK) {
    const int nk = min(BK, last + 1 - k0);
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
    __syncthreads();
    row.consume(ks_s, vs_s, nk, k0, t, inv_sqrt_d);
  }
  if (mine) row.store(out + (((size_t)b * Tlen + t) * hq + head) * D);
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int Hkv,
               int rep, int D, cudaStream_t st) {
  const int heads = f32_heads(rep);
  const int bq = kRows / heads;
  const dim3 grid((Tlen + bq - 1) / bq, Hkv * ((rep + heads - 1) / heads), B);
  const float inv = 1.f / sqrtf(static_cast<float>(D));
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
#define SIS_CAUSAL_LAUNCH(DD)                                                            \
  causal_attention_kernel<float, DD><<<grid, kRows, 0, st>>>(qf, kf, vf, of, Tlen, Hkv, rep, \
                                                             heads, inv)
  switch (D) {
    case 32: SIS_CAUSAL_LAUNCH(32); break;
    case 64: SIS_CAUSAL_LAUNCH(64); break;
    case 80: SIS_CAUSAL_LAUNCH(80); break;
    case 96: SIS_CAUSAL_LAUNCH(96); break;
    case 128: SIS_CAUSAL_LAUNCH(128); break;
    case 256: SIS_CAUSAL_LAUNCH(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIS_CAUSAL_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: tensor-core flash attention (flash_mma.cuh) ------------------------

template <int D>
__global__ void __launch_bounds__(sis::flash::kThreads)
causal_attention_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int Tlen, int Hkv, int rep, float inv_sqrt_d) {
  using namespace sis::flash;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = gridDim.z - 1 - blockIdx.z;  // longest tiles first
  const int b = blockIdx.y;
  const QRows rows{b, Tlen, Hkv * rep, tile * kBQ, (int)blockIdx.x};
  const size_t base = ((size_t)b * Tlen * Hkv + blockIdx.x / rep) * D;
  const CausalKeys<D> keys{k + base, v + base, (size_t)Hkv * D, min(rows.q0 + kBQ, Tlen) - 1,
                           rows.q0, inv_sqrt_d};
  attend<D>(q, out, rows, keys, smem);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Tlen, int Hkv,
               int rep, cudaStream_t st) {
  const dim3 grid(Hkv * rep, B, (Tlen + sis::flash::kBQ - 1) / sis::flash::kBQ);
  return sis::flash::launch<D>(
      causal_attention_mma<D>, grid, false, st, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), Tlen, Hkv, rep, 1.f / sqrtf(static_cast<float>(D)));
}

}  // namespace

extern "C" int sis_causal_attention(const void* q, const void* k, const void* v, void* out,
                                    int B, int Tlen, int Hkv, int rep, int D, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != sis::kBF16) return launch_f32(q, k, v, out, B, Tlen, Hkv, rep, D, st);
  switch (D) {
    case 32: return launch_mma<32>(q, k, v, out, B, Tlen, Hkv, rep, st);
    case 64: return launch_mma<64>(q, k, v, out, B, Tlen, Hkv, rep, st);
    case 80: return launch_mma<80>(q, k, v, out, B, Tlen, Hkv, rep, st);
    case 96: return launch_mma<96>(q, k, v, out, B, Tlen, Hkv, rep, st);
    case 128: return launch_mma<128>(q, k, v, out, B, Tlen, Hkv, rep, st);
    case 256: return launch_mma<256>(q, k, v, out, B, Tlen, Hkv, rep, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
