// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends over its K/V pages with an online softmax.
//
// Replaces two TPU kernels of src/repro/kernels/paged_attention.py:
//   * _kernel     (contiguous per-sequence pages [B, P, page, Hkv, D]);
//   * _kernel_bt  (a shared pool [N, page, Hkv, D] through block tables).
// One kernel serves both: a null block-table pointer means page slot p of
// sequence b is pool page b * P + p, the arithmetic of the contiguous
// slot-region pools (src/repro/models/attention.py:250-251).
//
// Bound on the H100: bytes.  A decode step does 2 FLOPs per K or V byte
// read (4 * D FLOPs per token and head group against 2 * D values), far
// below the ~295 FLOP/byte ridge, so the floor is reading each valid K/V
// token once at 3.35 TB/s.  What the design does about it:
//   * the Pallas grid (b, h, page) walked pages in order, carrying the
//     softmax state, and re-read each page per query head.  Here the grid
//     is (B, Hkv, P): one block per page slot, in parallel (B * Hkv
//     blocks alone leave most of the 132 SMs idle at serving batch
//     sizes).  A block reads its page of its kv head ONCE for all
//     rep = H / Hkv query heads (8 on TinyLlama) and writes its partial
//     (max, denominator, numerators); a second kernel combines the pages
//     of each (sequence, kv head).  Pages past the sequence's length are
//     not read at all, and the last page's reads stop at the length;
//   * K and V are staged in shared memory in tiles of TILE tokens, one
//     warp per token and lanes on neighbouring elements, so each token's
//     row is one coalesced read; scores and the weighted V sum then run
//     from shared memory.
// What it does not do yet: overlap a tile's loads with the previous
// tile's math (cp.async / TMA), or vector (16-byte) loads.
//
// Semantics kept from the TPU kernels: masked scores contribute exactly
// 0, the denominator is clamped at 1e-30 (so lengths == 0 gives zeros),
// query head h reads kv head h / rep, f32 accumulation throughout.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;  // tokens staged per step; two per lane in softmax

// Partial results of one page: per query head, dv numerators followed by
// the running max and the denominator.
__host__ __device__ inline int part_stride(int dv) { return dv + 2; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_pages(const T* __restrict__ q,        // [B, H, D]
                   const T* __restrict__ k_pool,   // [N, page, Hkv, D]
                   const T* __restrict__ v_pool,   // [N, page, Hkv, Dv]
                   const int* __restrict__ lengths,       // [B]
                   const int* __restrict__ block_tables,  // [B, P] or null
                   float* __restrict__ part,  // [B, Hkv, P, rep, Dv + 2]
                   int pages_per_seq, int page, int h, int hkv, int d,
                   int dv, float scale) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int p = blockIdx.z;
  const int rep = h / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = d + 1;  // padded K row: neighbouring tokens, other banks

  extern __shared__ float smem[];
  float* qs = smem;                 // [rep, D] this group's queries
  float* ks = qs + rep * d;         // [TILE, D + 1]
  float* vs = ks + TILE * dp;       // [TILE, Dv]
  float* sc = vs + TILE * dv;       // [rep, TILE] scores, then weights
  float* acc = sc + rep * TILE;     // [rep, Dv] running numerators
  float* m = acc + rep * dv;        // [rep] running max
  float* l = m + rep;               // [rep] running denominator
  float* corr = l + rep;            // [rep] this tile's correction

  const int len = max(0, min(lengths[b], pages_per_seq * page));
  const int t_end = min(len - p * page, page);   // valid tokens of the page
  if (t_end > 0) {
    for (int i = tid; i < rep * d; i += THREADS) {
      const int r = i / d, j = i % d;
      qs[i] = to_f32(q[((size_t)b * h + g * rep + r) * d + j]);
    }
  }
  for (int i = tid; i < rep * dv; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < rep; r += THREADS) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  const int pid = block_tables != nullptr
                      ? block_tables[(size_t)b * pages_per_seq + p]
                      : b * pages_per_seq + p;
  const T* kp = k_pool + (size_t)pid * page * hkv * d;
  const T* vp = v_pool + (size_t)pid * page * hkv * dv;

  for (int t0 = 0; t0 < t_end; t0 += TILE) {
    const int n_tok = min(TILE, t_end - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int t = warp; t < n_tok; t += WARPS) {
      const T* kr = kp + ((size_t)(t0 + t) * hkv + g) * d;
      const T* vr = vp + ((size_t)(t0 + t) * hkv + g) * dv;
      for (int c = lane; c < d; c += 32) ks[t * dp + c] = to_f32(kr[c]);
      for (int c = lane; c < dv; c += 32) vs[t * dv + c] = to_f32(vr[c]);
    }
    __syncthreads();

    // scores: a warp covers 32 neighbouring tokens of one query head
    for (int i = tid; i < rep * TILE; i += THREADS) {
      const int r = i / TILE, t = i % TILE;
      float s = NEG_INF;
      if (t < n_tok) {
        const float* qr = qs + r * d;
        const float* kr = ks + t * dp;
        float a = 0.f;
        for (int c = 0; c < d; ++c) a += qr[c] * kr[c];
        s = a * scale;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int r = warp; r < rep; r += WARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < TILE; t += 32) mx = fmaxf(mx, sc[r * TILE + t]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < TILE; t += 32) {
        const float w = softmax_weight(sc[r * TILE + t], m_new);
        sc[r * TILE + t] = w;
        sum += w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[r] = c;
        l[r] = c * l[r] + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + weights @ V
    for (int i = tid; i < rep * dv; i += THREADS) {
      const int r = i / dv, j = i % dv;
      const float* w = sc + r * TILE;
      float a = acc[i] * corr[r];
      for (int t = 0; t < n_tok; ++t) a += w[t] * vs[t * dv + j];
      acc[i] = a;
    }
  }
  __syncthreads();

  // this page's partial: an empty page leaves max NEG_INF, l 0, acc 0
  const int ps = part_stride(dv);
  float* dst =
      part + (((size_t)b * hkv + g) * pages_per_seq + p) * rep * ps;
  for (int i = tid; i < rep * dv; i += THREADS) {
    const int r = i / dv, j = i % dv;
    dst[r * ps + j] = acc[i];
  }
  for (int r = tid; r < rep; r += THREADS) {
    dst[r * ps + dv] = m[r];
    dst[r * ps + dv + 1] = l[r];
  }
}

// out = sum_p exp(m_p - M) acc_p / max(sum_p exp(m_p - M) l_p, 1e-30),
// M the largest page max.  Empty pages weigh 0; a sequence with no valid
// token has every acc_p and l_p 0 and writes zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_combine(const float* __restrict__ part, T* __restrict__ out,
                     int pages_per_seq, int h, int hkv, int dv) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int rep = h / hkv;
  const int ps = part_stride(dv);
  const float* src = part + ((size_t)b * hkv + g) * pages_per_seq * rep * ps;
  for (int i = threadIdx.x; i < rep * dv; i += THREADS) {
    const int r = i / dv, j = i % dv;
    float mx = NEG_INF;
    for (int p = 0; p < pages_per_seq; ++p)
      mx = fmaxf(mx, src[(p * rep + r) * ps + dv]);
    float num = 0.f, den = 0.f;
    for (int p = 0; p < pages_per_seq; ++p) {
      const float* e = src + (p * rep + r) * ps;
      const float w = expf(e[dv] - mx);
      num += w * e[j];
      den += w * e[dv + 1];
    }
    out[((size_t)b * h + g * rep + r) * dv + j] =
        from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* lengths, const void* block_tables, void* part,
           void* out, int b, int pages_per_seq, int page, int h, int hkv,
           int d, int dv, float scale, void* stream) {
  const int rep = h / hkv;
  const size_t smem =
      sizeof(float) * ((size_t)rep * d + (size_t)TILE * (d + 1) +
                       (size_t)TILE * dv + (size_t)rep * TILE +
                       (size_t)rep * dv + 3 * (size_t)rep);
  cudaError_t err = allow_smem(paged_decode_pages<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_decode_pages<T><<<dim3(b, hkv, pages_per_seq), THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(lengths),
      static_cast<const int*>(block_tables), static_cast<float*>(part),
      pages_per_seq, page, h, hkv, d, dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<T><<<dim3(b, hkv), THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<T*>(out), pages_per_seq,
      h, hkv, dv);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes.  ``part`` is f32 scratch of
// B * Hkv * P * (H / Hkv) * (Dv + 2) values.  Each returns
// cudaGetLastError() after its launches (0 on success).
extern "C" int paged_decode_f32(const void* q, const void* k_pool,
                                const void* v_pool, const void* lengths,
                                const void* block_tables, void* part,
                                void* out, int b, int pages_per_seq, int page,
                                int h, int hkv, int d, int dv, float scale,
                                void* stream) {
  return repro_torch::launch<float>(q, k_pool, v_pool, lengths, block_tables,
                                    part, out, b, pages_per_seq, page, h, hkv,
                                    d, dv, scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* lengths,
                                 const void* block_tables, void* part,
                                 void* out, int b, int pages_per_seq,
                                 int page, int h, int hkv, int d, int dv,
                                 float scale, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(
      q, k_pool, v_pool, lengths, block_tables, part, out, b, pages_per_seq,
      page, h, hkv, d, dv, scale, stream);
}
