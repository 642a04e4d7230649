// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends over its K/V pages, in one launch.
//
// Replaces two TPU kernels of src/repro/kernels/paged_attention.py:
//   * _kernel     (contiguous per-sequence pages [B, P, page, Hkv, D]);
//   * _kernel_bt  (a shared pool [N, page, Hkv, D] through block tables).
// One kernel serves both: a null block-table pointer means page slot p of
// sequence b is pool page b * P + p, the arithmetic of the contiguous
// slot-region pools (src/repro/models/attention.py:250-251).
//
// Bound on the H100: bytes, and below them latency.  A decode step does
// 2 FLOPs per K or V byte read (4 * D FLOPs per token and head group
// against 2 * D values), far below the ~295 FLOP/byte ridge, so the floor
// is reading each valid K/V token once at 3.35 TB/s: 0.46 us for TinyLlama
// at batch 4 and ~350 cached tokens.  That is far less than a launch, so
// what the design removes is fixed cost:
//   * split by tokens: the grid is (B, Hkv, ceil(P * page / SPLIT)) with
//     SPLIT = 64 tokens, so each live block does one tile and the blocks
//     past a sequence's length exit at once.  A block reads its tokens of
//     its kv head ONCE for all rep = H / Hkv query heads (8 on TinyLlama);
//   * short dependent chains: the length, the pool row of each of the
//     split's tokens (through the block table) and the query rows are
//     loaded at once; then the split's K rows, then its V rows, are issued
//     as 16-byte cp.async copies before any math, so V is in flight while
//     the scores and the softmax run; shared rows are padded by 16 bytes,
//     so the 8 rows a quarter-warp reads fall in 8 different bank groups;
//   * one launch: each live split writes its partial (numerators, max,
//     denominator per query head) and takes a ticket from an atomic
//     counter of its (sequence, kv head); the last to arrive combines the
//     partials and writes the output, then resets the counter to 0 for
//     the next call or CUDA-graph replay.  It reads the partials' maxima
//     and denominators once into shared memory, so its loads of the
//     numerators are independent.  A sequence of one split writes its
//     output directly;
//   * arithmetic: f32 FMAs from registers and shared memory are enough at
//     this intensity; one structure serves f32 and bf16.  The query rows
//     are converted to f32 in shared memory once and read by broadcast
//     (every lane of a warp reads the same element).  8 warps: at the
//     serving shape fewer blocks are live than the card has SMs, so each
//     block's own latency is the time, and 8 warps shorten it.
//
// Semantics kept from the TPU kernels: masked scores contribute exactly
// 0, the denominator is clamped at 1e-30, a sequence with lengths == 0
// writes zeros, query head h reads kv head h / rep, f32 accumulation
// throughout.
//
// Optionally (a non-null ``lse``) each query head's natural-log
// log-sum-exp of its scaled scores, max + log(denominator), is written
// too, -inf for a sequence with lengths == 0: at the single-split exit
// from the split's own max and denominator, at the combine from the
// combined ones.  A sequence-striped cache (one stripe of the tokens per
// rank) merges the ranks' outputs with it exactly.  The output does not
// depend on it: the same values are written with or without.
//
// The output is written in the inputs' type, or in f32 from bf16 inputs
// (``paged_decode_bf16_out_f32``): a stripe's partial for such a merge,
// not rounded to bf16 before it is weighted.  Both exits (the single
// split and the combine) write the f32 values they would round.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 64;  // tokens per block: two per lane in the softmax
constexpr int HB = 8;      // query heads one thread carries at once
static_assert(SPLIT == 64 && THREADS % SPLIT == 0, "softmax assumes 2x32");

// Partial results of one split: per query head, dv numerators followed
// by the split's max and denominator.
__host__ __device__ inline int part_stride(int dv) { return dv + 2; }

__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q,        // [B, H, D]
                    const T* __restrict__ k_pool,   // [N, page, Hkv, D]
                    const T* __restrict__ v_pool,   // [N, page, Hkv, Dv]
                    const int* __restrict__ lengths,       // [B]
                    const int* __restrict__ block_tables,  // [B, P] or null
                    float* __restrict__ part,  // [B, Hkv, splits, rep, Dv+2]
                    int* __restrict__ counters,            // [B * Hkv], 0
                    O* __restrict__ out,                   // [B, H, Dv]
                    float* __restrict__ lse,         // [B, H] or null
                    int pages_per_seq, int page, int h, int hkv, int d,
                    int dv, float scale) {
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int s = blockIdx.z;
  const int splits = gridDim.z;
  const int rep = h / hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = s * SPLIT;

  const int kld = d + CH, vld = dv + CH;  // padded shared rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);         // [SPLIT][D + pad]
  T* vs = ks + SPLIT * kld;                       // [SPLIT][Dv + pad]
  float* qs = reinterpret_cast<float*>(vs + SPLIT * vld);  // [rep][D]
  float* sc = qs + rep * d;       // [rep][SPLIT] scores, then weights
  float* ms = sc + rep * SPLIT;   // [rep] split max, then 1 / denominator
  float* ls = ms + rep;           // [rep] split denominator
  float* cw = ls + rep;           // [splits][rep] combine weights
  float* cl = cw + splits * rep;  // [splits][rep] partial denominators
  __shared__ size_t rows[SPLIT];  // pool row of each token of the split
  __shared__ int last;

  // 0. three independent loads at once: the length, the pool row of each
  //    token of the split (through the block table), the query rows
  const int len = max(0, min(lengths[b], pages_per_seq * page));
  if (tid < SPLIT) {
    const int tok = min(t0 + tid, pages_per_seq * page - 1);
    const int p = tok / page;
    const int pid = block_tables != nullptr
                        ? block_tables[(size_t)b * pages_per_seq + p]
                        : b * pages_per_seq + p;
    rows[tid] = ((size_t)pid * page + tok % page) * hkv + g;
  }
  const T* qg = q + ((size_t)b * h + (size_t)g * rep) * d;
  for (int i = tid; i < rep * d; i += THREADS) qs[i] = to_f32(qg[i]);
  const int n_live = (len + SPLIT - 1) / SPLIT;
  O* og = out + ((size_t)b * h + (size_t)g * rep) * dv;
  float* lg = lse != nullptr ? lse + (size_t)b * h + (size_t)g * rep
                             : nullptr;
  if (len == 0) {
    if (s == 0) {
      for (int i = tid; i < rep * dv; i += THREADS) og[i] = from_f32<O>(0.f);
      if (lg != nullptr)
        for (int r = tid; r < rep; r += THREADS) lg[r] = -INFINITY;
    }
    return;
  }
  if (s >= n_live) return;
  const int n_tok = min(SPLIT, len - t0);
  __syncthreads();

  // 1. the split's K rows, then its V rows, as 16-byte copies
  const int kc = d / CH, vc = dv / CH;
  for (int i = tid; i < n_tok * kc; i += THREADS) {
    const int j = i / kc, c = (i - j * kc) * CH;
    cp_async16(ks + j * kld + c, k_pool + rows[j] * d + c);
  }
  cp_async_commit();
  for (int i = tid; i < n_tok * vc; i += THREADS) {
    const int j = i / vc, c = (i - j * vc) * CH;
    cp_async16(vs + j * vld + c, v_pool + rows[j] * dv + c);
  }
  cp_async_commit();
  cp_async_wait<1>();  // K has landed
  __syncthreads();

  // 2. scores: thread -> token j, query heads r_first + u * (THREADS/SPLIT)
  {
    constexpr int RS = THREADS / SPLIT;
    const int j = tid % SPLIT;
    for (int r0 = tid / SPLIT; r0 < rep; r0 += RS * HB) {
      float acc[HB];
#pragma unroll
      for (int u = 0; u < HB; ++u) acc[u] = 0.f;
      if (j < n_tok) {
        const T* kr = ks + j * kld;
        for (int c = 0; c < d; c += CH) {
          float kf[CH];
          load_chunk(kr + c, kf);
#pragma unroll
          for (int u = 0; u < HB; ++u) {
            const int r = r0 + u * RS;
            if (r < rep) {
              const float* qr = qs + r * d + c;
#pragma unroll
              for (int e = 0; e < CH; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qr + e);
                acc[u] += qv.x * kf[e] + qv.y * kf[e + 1] +
                          qv.z * kf[e + 2] + qv.w * kf[e + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < HB; ++u) {
        const int r = r0 + u * RS;
        if (r < rep) sc[r * SPLIT + j] = j < n_tok ? acc[u] * scale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // 3. each head's softmax over the split, one warp per head
  for (int r = warp; r < rep; r += WARPS) {
    float* row = sc + r * SPLIT;
    const float x0 = row[lane], x1 = row[lane + 32];
    const float mx = warp_max(fmaxf(x0, x1));
    const float w0 = softmax_weight(x0, mx), w1 = softmax_weight(x1, mx);
    row[lane] = w0;
    row[lane + 32] = w1;
    const float sum = warp_sum(w0 + w1);
    if (lane == 0) {
      ms[r] = mx;
      ls[r] = sum;
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // 4. weighted V sum: thread -> column pair cp, heads r_first + u * hstep;
  //    a single split writes the output, otherwise its partial
  const int ps = part_stride(dv);
  float* dst = part + (((size_t)b * hkv + g) * splits + s) * rep * ps;
  const int npair = dv / 2;
  const int hstep = THREADS / npair;
  if (tid < hstep * npair) {
    const int cp = tid % npair;
    for (int r0 = tid / npair; r0 < rep; r0 += hstep * HB) {
      float2 acc[HB];
#pragma unroll
      for (int u = 0; u < HB; ++u) acc[u] = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < n_tok; ++j) {
        const float2 vv = load_pair(vs + j * vld + 2 * cp);
#pragma unroll
        for (int u = 0; u < HB; ++u) {
          const int r = r0 + u * hstep;
          if (r < rep) {
            const float w = sc[r * SPLIT + j];
            acc[u].x += w * vv.x;
            acc[u].y += w * vv.y;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < HB; ++u) {
        const int r = r0 + u * hstep;
        if (r >= rep) continue;
        if (n_live == 1) {
          const float inv = 1.f / fmaxf(ls[r], 1e-30f);
          og[r * dv + 2 * cp] = from_f32<O>(acc[u].x * inv);
          og[r * dv + 2 * cp + 1] = from_f32<O>(acc[u].y * inv);
        } else {
          *reinterpret_cast<float2*>(dst + r * ps + 2 * cp) = acc[u];
        }
      }
    }
  }
  if (n_live == 1) {
    if (lg != nullptr)
      for (int r = tid; r < rep; r += THREADS) lg[r] = ms[r] + logf(ls[r]);
    return;
  }
  for (int r = tid; r < rep; r += THREADS) {
    dst[r * ps + dv] = ms[r];
    dst[r * ps + dv + 1] = ls[r];
  }

  // 5. the last split of (b, g) to finish combines:
  //    out = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30)
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  int* counter = counters + (size_t)b * hkv + g;
  if (tid == 0) last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* src = part + ((size_t)b * hkv + g) * splits * rep * ps;
  for (int i = tid; i < n_live * rep; i += THREADS) {  // i = z * rep + r
    cw[i] = __ldcg(src + (size_t)i * ps + dv);
    cl[i] = __ldcg(src + (size_t)i * ps + dv + 1);
  }
  __syncthreads();
  for (int r = tid; r < rep; r += THREADS) {
    float mx = NEG_INF;
    for (int z = 0; z < n_live; ++z) mx = fmaxf(mx, cw[z * rep + r]);
    float den = 0.f;
    for (int z = 0; z < n_live; ++z) {
      const float w = expf(cw[z * rep + r] - mx);
      cw[z * rep + r] = w;
      den += w * cl[z * rep + r];
    }
    ms[r] = 1.f / fmaxf(den, 1e-30f);
    if (lg != nullptr) lg[r] = mx + logf(den);
  }
  __syncthreads();
  for (int i = tid; i < rep * npair; i += THREADS) {
    const int r = i / npair, cp = i - r * npair;
    float2 num = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int z = 0; z < n_live; ++z) {
      const float2 a = __ldcg(
          reinterpret_cast<const float2*>(src + (size_t)(z * rep + r) * ps) +
          cp);
      const float w = cw[z * rep + r];
      num.x += w * a.x;
      num.y += w * a.y;
    }
    og[r * dv + 2 * cp] = from_f32<O>(num.x * ms[r]);
    og[r * dv + 2 * cp + 1] = from_f32<O>(num.y * ms[r]);
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

template <typename T, typename O = T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* lengths, const void* block_tables, void* part,
           void* counters, void* out, void* lse, int b, int pages_per_seq,
           int page, int h, int hkv, int d, int dv, float scale,
           void* stream) {
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  const int rep = h / hkv;
  const int splits = (pages_per_seq * page + SPLIT - 1) / SPLIT;
  if (d % CH || dv % CH || dv > 2 * THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * (size_t)SPLIT * (d + CH + dv + CH) +
      sizeof(float) * ((size_t)rep * (d + SPLIT + 2 + 2 * splits));
  cudaError_t err = allow_smem(paged_decode_kernel<T, O>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, O><<<dim3(b, hkv, splits), THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(lengths),
      static_cast<const int*>(block_tables), static_cast<float*>(part),
      static_cast<int*>(counters), static_cast<O*>(out),
      static_cast<float*>(lse), pages_per_seq, page, h, hkv, d, dv, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes.  ``part`` is f32 scratch of
// B * Hkv * splits * (H / Hkv) * (Dv + 2) values, splits =
// ceil(P * page / 64); ``counters`` is B * Hkv int32 that are 0 on entry
// and 0 again when the launch has finished; ``lse`` is null or B * H
// f32 (each query head's log-sum-exp); ``out`` is B * H * Dv of the
// inputs' type, f32 for ``paged_decode_bf16_out_f32``.  Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int paged_decode_f32(const void* q, const void* k_pool,
                                const void* v_pool, const void* lengths,
                                const void* block_tables, void* part,
                                void* counters, void* out, void* lse, int b,
                                int pages_per_seq, int page, int h, int hkv,
                                int d, int dv, float scale, void* stream) {
  return repro_torch::launch<float>(q, k_pool, v_pool, lengths, block_tables,
                                    part, counters, out, lse, b,
                                    pages_per_seq, page, h, hkv, d, dv, scale,
                                    stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* lengths,
                                 const void* block_tables, void* part,
                                 void* counters, void* out, void* lse, int b,
                                 int pages_per_seq, int page, int h, int hkv,
                                 int d, int dv, float scale, void* stream) {
  return repro_torch::launch<__nv_bfloat16>(
      q, k_pool, v_pool, lengths, block_tables, part, counters, out, lse, b,
      pages_per_seq, page, h, hkv, d, dv, scale, stream);
}

extern "C" int paged_decode_bf16_out_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* lengths, const void* block_tables, void* part,
    void* counters, void* out, void* lse, int b, int pages_per_seq, int page,
    int h, int hkv, int d, int dv, float scale, void* stream) {
  return repro_torch::launch<__nv_bfloat16, float>(
      q, k_pool, v_pool, lengths, block_tables, part, counters, out, lse, b,
      pages_per_seq, page, h, hkv, d, dv, scale, stream);
}
