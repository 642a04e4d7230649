// Prefill attention for Hopper (sm_90a): a tile of BQ query rows of one
// head walks its visible keys in BK-token tiles with an online softmax.
// One kernel body, two layouts:
//
//   * chunked_prefill_paged -- replaces src/repro/kernels/
//     chunked_prefill.py:_kernel_paged.  A prefill chunk q [R, C, H, Dq]
//     at runtime offsets q_offsets[R] attends causally over the first
//     lengths[R] tokens of its sequence, read in place from a shared page
//     pool [N, page, Hkv, D] through block tables [R, P].  The block reads
//     its row's offset, length and page ids itself (there is no scalar
//     prefetch); a key at position k is visible to the query at position
//     q when k <= q and k < length.  A query row with no visible key
//     writes zeros.
//   * flash_prefill -- replaces src/repro/kernels/chunked_prefill.py:
//     _kernel.  Dense q [B, Sq, H, Dq] against k/v [B, Skv, Hkv, D] with a
//     q_offset, causal or not, an optional sliding window (key k visible
//     to query q when k > q - window), GQA, and Dq != Dv.  It uses the
//     guarded masked-score update of the paged kernels; K4's results are
//     the same because a fully masked leading block is wiped out by the
//     next block's correction factor.
//
// Bound on the H100: at the serving shapes (head_dim 64, a few hundred
// keys per query) attention does ~Skv/2 FLOPs per byte of K/V and Q, so
// it sits near the ridge of bf16 tensor-core peak and memory rate; this
// first kernel computes with plain f32 FMAs from shared memory, so it is
// bound by its own FMA issue rate, far above either floor.  What the
// design does about the traffic: each K/V tile is loaded once into
// shared memory (row-padded against bank conflicts) and reused by all BQ
// query rows of the tile, one thread per key resolving the key's row
// first so that no element load waits on a block-table load; the key
// loop stops at the causal limit of the tile's last row (and starts at
// the window's first key), so masked tiles are never read.  What is left for later: mma.sync / wgmma tensor
// cores, a Q tile shared by the rep query heads of a kv group, TMA loads.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per tile: one per lane in the softmax

struct PagedArgs {
  const int* lengths;       // [R]
  const int* q_offsets;     // [R]
  const int* block_tables;  // [R, P]
  int pages_per_seq;
  int page;
};

struct DenseArgs {
  int skv;
  int q_offset;
  int causal;
  int window;               // <= 0: no sliding window
};

template <typename T, bool PAGED>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, PagedArgs pa,
               DenseArgs da, int sq, int h, int hkv, int d, int dv,
               float scale) {
  const int b = blockIdx.x;
  const int hq = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int g = hq / (h / hkv);
  const int n_rows = min(BQ, sq - q0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = d + 1;  // padded K row: lanes on neighbouring keys hit
                         // different banks

  __shared__ size_t rows[BK];    // K/V row of each key in the tile
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ, D]
  float* ks = qs + BQ * d;       // [BK, D + 1]
  float* vs = ks + BK * dp;      // [BK, Dv]
  float* s = vs + BK * dv;       // [BQ, BK] scores, then weights
  float* acc = s + BQ * BK;      // [BQ, Dv]
  float* m = acc + BQ * dv;      // [BQ]
  float* l = m + BQ;             // [BQ]
  float* corr = l + BQ;          // [BQ]

  int off, len, kv_begin = 0, kv_end;
  if (PAGED) {
    off = pa.q_offsets[b];
    len = min(pa.lengths[b], pa.pages_per_seq * pa.page);
    kv_end = min(len, off + q0 + n_rows);
  } else {
    off = da.q_offset;
    len = da.skv;
    kv_end = da.causal ? min(len, off + q0 + n_rows) : len;
    if (da.window > 0) kv_begin = max(0, off + q0 - da.window + 1);
  }

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i % d;
    qs[i] = r < n_rows ? to_f32(q[(((size_t)b * sq + q0 + r) * h + hq) * d + c])
                       : 0.f;
  }
  for (int i = tid; i < BQ * dv; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < BQ; r += THREADS) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    const int n_keys = min(BK, kv_end - k0);
    __syncthreads();  // previous tile's readers are done with ks/vs/s
    // one thread per key resolves its row (paged: page id from the
    // table), so the element loads below carry no dependent load
    if (tid < n_keys) {
      const int kpos = k0 + tid;
      if (PAGED) {
        const int pid =
            pa.block_tables[(size_t)b * pa.pages_per_seq + kpos / pa.page];
        rows[tid] = ((size_t)pid * pa.page + kpos % pa.page) * hkv + g;
      } else {
        rows[tid] = ((size_t)b * da.skv + kpos) * hkv + g;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < BK * d; i += THREADS) {
      const int j = i / d, c = i % d;
      ks[j * dp + c] = j < n_keys ? to_f32(k[rows[j] * d + c]) : 0.f;
    }
#pragma unroll 4
    for (int i = tid; i < BK * dv; i += THREADS) {
      const int j = i / dv, c = i % dv;
      vs[i] = j < n_keys ? to_f32(v[rows[j] * dv + c]) : 0.f;
    }
    __syncthreads();

    // scores with the mask; a warp covers one query row's BK keys
    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, j = i % BK;
      const int qpos = off + q0 + r;
      const int kpos = k0 + j;
      bool ok = r < n_rows && kpos < kv_end;
      if (PAGED) {
        ok = ok && kpos <= qpos && kpos < len;
      } else {
        if (da.causal) ok = ok && kpos <= qpos;
        if (da.window > 0) ok = ok && kpos > qpos - da.window;
      }
      float acc_s = 0.f;
      if (ok) {
        const float* qr = qs + r * d;
        const float* kr = ks + j * dp;
        for (int c = 0; c < d; ++c) acc_s += qr[c] * kr[c];
      }
      s[i] = ok ? acc_s * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax, one warp per query row, one lane per key
    for (int r = warp; r < BQ; r += WARPS) {
      const float x = s[r * BK + lane];
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float w = softmax_weight(x, m_new);
      s[r * BK + lane] = w;
      const float sum = warp_sum(w);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[r] = c;
        l[r] = c * l[r] + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ * dv; i += THREADS) {
      const int r = i / dv, c = i % dv;
      const float* w = s + r * BK;
      float a = acc[i] * corr[r];
#pragma unroll
      for (int j = 0; j < BK; ++j) a += w[j] * vs[j * dv + c];
      acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < n_rows * dv; i += THREADS) {
    const int r = i / dv, c = i % dv;
    out[(((size_t)b * sq + q0 + r) * h + hq) * dv + c] =
        from_f32<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)BQ * d + (size_t)BK * (d + 1) +
                          (size_t)BK * dv + (size_t)BQ * BK +
                          (size_t)BQ * dv + 3 * (size_t)BQ);
}

template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, void* out,
           PagedArgs pa, DenseArgs da, int nb, int sq, int h, int hkv, int d,
           int dv, float scale, void* stream) {
  const size_t smem = smem_bytes(d, dv);
  cudaError_t err = allow_smem(prefill_kernel<T, PAGED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, h, (sq + BQ - 1) / BQ);
  prefill_kernel<T, PAGED><<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), pa, da, sq, h, hkv, d,
      dv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged(const void* q, const void* k_pool, const void* v_pool,
                 const void* lengths, const void* q_offsets,
                 const void* block_tables, void* out, int r, int sq, int h,
                 int hkv, int d, int dv, int page, int pages_per_seq,
                 float scale, void* stream) {
  PagedArgs pa{static_cast<const int*>(lengths),
               static_cast<const int*>(q_offsets),
               static_cast<const int*>(block_tables), pages_per_seq, page};
  DenseArgs da{0, 0, 1, 0};
  return launch<T, true>(q, k_pool, v_pool, out, pa, da, r, sq, h, hkv, d,
                         dv, scale, stream);
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, void* out,
                 int b, int sq, int skv, int h, int hkv, int d, int dv,
                 float scale, int q_offset, int causal, int window,
                 void* stream) {
  PagedArgs pa{nullptr, nullptr, nullptr, 0, 1};
  DenseArgs da{skv, q_offset, causal, window};
  return launch<T, false>(q, k, v, out, pa, da, b, sq, h, hkv, d, dv, scale,
                          stream);
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes.  Each returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int chunked_prefill_paged_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* lengths, const void* q_offsets, const void* block_tables,
    void* out, int r, int sq, int h, int hkv, int d, int dv, int page,
    int pages_per_seq, float scale, void* stream) {
  return repro_torch::launch_paged<float>(q, k_pool, v_pool, lengths,
                                          q_offsets, block_tables, out, r, sq,
                                          h, hkv, d, dv, page, pages_per_seq,
                                          scale, stream);
}

extern "C" int chunked_prefill_paged_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* lengths, const void* q_offsets, const void* block_tables,
    void* out, int r, int sq, int h, int hkv, int d, int dv, int page,
    int pages_per_seq, float scale, void* stream) {
  return repro_torch::launch_paged<__nv_bfloat16>(
      q, k_pool, v_pool, lengths, q_offsets, block_tables, out, r, sq, h,
      hkv, d, dv, page, pages_per_seq, scale, stream);
}

extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 void* out, int b, int sq, int skv, int h,
                                 int hkv, int d, int dv, float scale,
                                 int q_offset, int causal, int window,
                                 void* stream) {
  return repro_torch::launch_dense<float>(q, k, v, out, b, sq, skv, h, hkv, d,
                                          dv, scale, q_offset, causal, window,
                                          stream);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* out, int b, int sq,
                                  int skv, int h, int hkv, int d, int dv,
                                  float scale, int q_offset, int causal,
                                  int window, void* stream) {
  return repro_torch::launch_dense<__nv_bfloat16>(
      q, k, v, out, b, sq, skv, h, hkv, d, dv, scale, q_offset, causal,
      window, stream);
}
