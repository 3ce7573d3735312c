// chunk_prefill_attention: one prompt chunk attends the slot's int8 cache
// row (positions < start) and its own keys (causally) under ONE softmax.
//
//   q [C, Hq, D] (bf16 or f32); k_row/v_row int8 [T, Hkv, D] with f32
//   scales [T, Hkv]; k_cur/v_cur [C, Hkv, D] in the q dtype; start is the
//   chunk's absolute offset. Query row c attends cache positions
//   p < start and in-chunk keys j <= c. out [C, Hq, D] in the q dtype.
//
// Replaces the TPU kernel starpu_inference_server_tpu/ops/
// prefill_attention.py chunk_prefill_attention (_chunk_kernel). The TPU
// grid walked the cache chunks and then the in-chunk keys as sequential
// steps carrying m/l/acc in scratch; here both loops run inside one
// block. `start` arrives as a kernel argument: the engine tracks chunk
// offsets on the host, so no layer ever syncs the device to learn it.
//
// Bound on the H100: bytes and bf16 operations about even at start =
// 256, operations for longer pasts (C*start*Hq*D*4 FLOPs against
// start*Hkv*D*2 bytes of int8 cache).
//
// Two routes, chosen by dtype (not a fallback: each is the kernel of its
// dtype):
//
// bf16 (the path's): the tensor-core tile of flash_mma.cuh with its
// ChunkKeys source: the past's tiles arrive as int8 through cp.async and
// are widened to bf16 in shared memory (exact), with k_scale applied to
// S's columns after the mma and v_scale to P's before its hi/lo split, so
// the cache is read in its int8 form once per query tile and no rounded
// dequantized value appears; then the chunk's own keys, causally, as in
// causal_attention. Rows and grid order as there (64 chunk rows of one
// query head a block, grid (Hq, 1, tiles), longest tiles first).
//
// f32: as causal_attention's f32 route, one block per (query tile, KV
// head's head group) with one query row per thread for the group's heads
// (all rep heads up to 128), the kernel of the FP32 witnesses. Cache chunks are dequantized (int8 * scale -> f32)
// while they are staged in shared memory, once for all 128 rows.
//
// Both routes take head_dim 32, 64, 80, 96, 128 and 256 and any rep. At
// 32 (llama-tiny) the f32 route is instantiated too, rather than sending
// f32 inputs through the tensor cores with bf16 operands: that would
// change the function the FP32 witnesses compute.

#include "flash_mma.cuh"

namespace {

constexpr int kRows = 128;
constexpr int kSB = 16;

// the query heads of a block of the f32 route (all of a KV head's, up to
// kRows), as causal_attention's
inline int f32_heads(int rep) { return rep < kRows ? rep : kRows; }

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
chunk_prefill_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_row,
                     const int8_t* __restrict__ v_row, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const T* __restrict__ k_cur,
                     const T* __restrict__ v_cur, T* __restrict__ out, int C, int Tmax,
                     int Hkv, int rep, int heads, int start, float inv_sqrt_d) {
  constexpr int BK = 4096 / D / kSB * kSB;
  __shared__ __align__(16) float ks_s[BK * D];
  __shared__ __align__(16) float vs_s[BK * D];

  const int bq = kRows / heads;
  const int groups = (rep + heads - 1) / heads;
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y / groups;
  const int r = (blockIdx.y % groups) * heads + threadIdx.x % heads;  // head of the KV head
  const int tid = threadIdx.x;
  const int c = q0 + tid / heads;
  const int head = h * rep + r;
  const int hq = Hkv * rep;
  const bool mine = tid < bq * heads && r < rep && c < C;

  sis::FlashRow<D, kSB> row;
  row.init();
  if (mine) {
    const T* qr = q + ((size_t)c * hq + head) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) row.q[d] = sis::to_f(qr[d]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) row.q[d] = 0.f;
  }

  // part 1: the slot's int8 cache row, positions < start
  const int past = min(start, Tmax);
  for (int k0 = 0; k0 < past; k0 += BK) {
    const int nk = min(BK, past - k0);
    __syncthreads();
    for (int i = tid; i < BK * D; i += kRows) {
      const int j = i / D;
      const int d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t pos = (size_t)(k0 + j) * Hkv + h;
        kv = static_cast<float>(k_row[pos * D + d]) * k_scale[pos];
        vv = static_cast<float>(v_row[pos * D + d]) * v_scale[pos];
      }
      ks_s[i] = kv;
      vs_s[i] = vv;
    }
    __syncthreads();
    row.consume(ks_s, vs_s, nk, k0, past - 1, inv_sqrt_d);
  }

  // part 2: the chunk's own keys, causal (key j <= row c)
  const int last = min(q0 + bq, C) - 1;
  for (int k0 = 0; k0 <= last; k0 += BK) {
    const int nk = min(BK, last + 1 - k0);
    __syncthreads();
    for (int i = tid; i < BK * D; i += kRows) {
      const int j = i / D;
      const int d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off = ((size_t)(k0 + j) * Hkv + h) * D + d;
        kv = sis::to_f(k_cur[off]);
        vv = sis::to_f(v_cur[off]);
      }
      ks_s[i] = kv;
      vs_s[i] = vv;
    }
    __syncthreads();
    row.consume(ks_s, vs_s, nk, k0, c, inv_sqrt_d);
  }
  if (mine) row.store(out + ((size_t)c * hq + head) * D);
}

int launch_f32(const void* q, const void* kr, const void* vr, const void* ksc, const void* vsc,
               const void* kc, const void* vc, void* out, int C, int Tmax, int Hkv, int rep, int D,
               int start, cudaStream_t st) {
  const int heads = f32_heads(rep);
  const int bq = kRows / heads;
  const dim3 grid((C + bq - 1) / bq, Hkv * ((rep + heads - 1) / heads));
  const float inv = 1.f / sqrtf(static_cast<float>(D));
#define SIS_CHUNK_LAUNCH(DD)                                                                  \
  chunk_prefill_kernel<float, DD><<<grid, kRows, 0, st>>>(                                    \
      static_cast<const float*>(q), static_cast<const int8_t*>(kr),                           \
      static_cast<const int8_t*>(vr), static_cast<const float*>(ksc),                         \
      static_cast<const float*>(vsc), static_cast<const float*>(kc),                          \
      static_cast<const float*>(vc), static_cast<float*>(out), C, Tmax, Hkv, rep, heads,     \
      start, inv)
  switch (D) {
    case 32: SIS_CHUNK_LAUNCH(32); break;
    case 64: SIS_CHUNK_LAUNCH(64); break;
    case 80: SIS_CHUNK_LAUNCH(80); break;
    case 96: SIS_CHUNK_LAUNCH(96); break;
    case 128: SIS_CHUNK_LAUNCH(128); break;
    case 256: SIS_CHUNK_LAUNCH(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIS_CHUNK_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// -- bf16: tensor-core flash attention (flash_mma.cuh) ------------------------

template <int D>
__global__ void __launch_bounds__(sis::flash::kThreads)
chunk_prefill_mma(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_row,
                  const int8_t* __restrict__ v_row, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ k_cur,
                  const __nv_bfloat16* __restrict__ v_cur, __nv_bfloat16* __restrict__ out,
                  int C, int Tmax, int Hkv, int rep, int start, float inv_sqrt_d) {
  using namespace sis::flash;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = gridDim.z - 1 - blockIdx.z;  // longest tiles first
  const int hkv = blockIdx.x / rep;
  const QRows rows{0, C, Hkv * rep, tile * kBQ, (int)blockIdx.x};
  const ChunkKeys<D> keys{k_row + (size_t)hkv * D, v_row + (size_t)hkv * D,
                          k_scale + hkv, v_scale + hkv,
                          k_cur + (size_t)hkv * D, v_cur + (size_t)hkv * D,
                          Hkv, min(start, Tmax), min(rows.q0 + kBQ, C) - 1, rows.q0,
                          inv_sqrt_d};
  attend<D>(q, out, rows, keys, smem);
}

template <int D>
int launch_mma(const void* q, const void* kr, const void* vr, const void* ksc, const void* vsc,
               const void* kc, const void* vc, void* out, int C, int Tmax, int Hkv, int rep,
               int start, cudaStream_t st) {
  const dim3 grid(Hkv * rep, 1, (C + sis::flash::kBQ - 1) / sis::flash::kBQ);
  return sis::flash::launch<D>(
      chunk_prefill_mma<D>, grid, true, st, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(kr), static_cast<const int8_t*>(vr),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const __nv_bfloat16*>(kc), static_cast<const __nv_bfloat16*>(vc),
      static_cast<__nv_bfloat16*>(out), C, Tmax, Hkv, rep, start,
      1.f / sqrtf(static_cast<float>(D)));
}

}  // namespace

extern "C" int sis_chunk_prefill_attention(const void* q, const void* k_row, const void* v_row,
                                           const void* k_scale, const void* v_scale,
                                           const void* k_cur, const void* v_cur, void* out,
                                           int C, int Tmax, int Hkv, int rep, int D, int start,
                                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rep < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != sis::kBF16)
    return launch_f32(q, k_row, v_row, k_scale, v_scale, k_cur, v_cur, out, C, Tmax, Hkv, rep, D,
                      start, st);
#define SIS_CHUNK_MMA(DD)                                                                  \
  launch_mma<DD>(q, k_row, v_row, k_scale, v_scale, k_cur, v_cur, out, C, Tmax, Hkv, rep, \
                 start, st)
  switch (D) {
    case 32: return SIS_CHUNK_MMA(32);
    case 64: return SIS_CHUNK_MMA(64);
    case 80: return SIS_CHUNK_MMA(80);
    case 96: return SIS_CHUNK_MMA(96);
    case 128: return SIS_CHUNK_MMA(128);
    case 256: return SIS_CHUNK_MMA(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIS_CHUNK_MMA
}
