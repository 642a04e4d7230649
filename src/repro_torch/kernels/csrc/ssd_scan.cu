// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel of src/repro/kernels/ssd_scan.py
// (ssd_chunk_scan).  Per (sequence b, head h) the sequence is cut into
// chunks of Q tokens and an f32 state S [P, N] is carried across them:
//   y[q]  = sum_{t<=q} (C_q . B_t) exp(seg_q - seg_t) x_t dt_t
//           + exp(seg_q) C_q . S_in
//   S_out = exp(total) S_in + sum_t exp(total - seg_t) (x_t dt_t) B_t^T
// with seg the within-chunk cumulative sum of a_h * dt and total its last
// value.  B and C are shared by the H / G heads of a group.
//
// Bound on the H100: bytes, at the serving shape (one 384-token prompt,
// 64 heads of 64, state 128, bf16).  The data-dependent work is about
// 1 GFLOP (C.B^T once per group and chunk, the causal products per head)
// against about 10 MB that must move once (x, y, B, C, dt, and the f32
// initial and final states), so the floor is ~3 us of HBM traffic.  What
// the design does about it:
//   * the TPU grid (b, h, chunk) walked the chunks in order with the state
//     in VMEM scratch.  Hopper blocks carry nothing between them, so each
//     block loops over the chunks itself and keeps the state in shared
//     memory from the initial state's read to the final state's write.
//   * the state's rows p are independent (C.B^T, the decay and the weights
//     do not depend on p), so the grid is (B, H, P / 32): one block per
//     32 state rows.  The serving path prefills one request at a time
//     (B 1, H 64), and a (b, h) grid would fill 64 of the 132 SMs; this
//     one launches 128 blocks.
//   * C.B^T does not depend on the head either: a first kernel computes
//     it once per (sequence, group, chunk), over the causal triangle, into
//     an f32 scratch [B, G, chunks, Q, Q] (196 KB for one 384-token
//     prompt, read from L2).  The scan kernel reads a row tile of it and
//     applies its head's decay, instead of redoing the product for each
//     of the H / G heads and each 32-row state tile.
//   * shared memory: B of the chunk [Q, N + 1], C of one 32-query tile
//     [32, N], the masked scores of that tile [32, Q], x * dt [Q, 32] and
//     the state [32, N + 1], all f32: 130 KB at Q = N = 128.  Scores are
//     taken a tile of 32 query rows at a time, and only for the key
//     columns a causal row can see, so the [Q, Q] score matrix is never
//     held whole.  Rows are padded to N + 1 where lanes walk rows.
//   * masking selects and never multiplies: exp(seg_q - seg_t) overflows
//     for t > q (seg decreases), and inf * 0 is NaN.
// What it does not do yet: tensor cores for the products, or overlapping
// the next chunk's loads with this chunk's arithmetic.
//
// Any chunk from 1 to 128 tokens (not only powers of two: a 37-token
// prompt scans as one chunk of 37) and any state size up to 128; f32 or
// bf16 x, B and C, f32 dt, a, states and arithmetic; y in x's type.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 256;
constexpr int PT = 32;     // state rows per block: one per lane
constexpr int QT = 32;     // query rows per score tile: 4 per warp
constexpr int MAX_Q = 128; // chunk limit: 4 key columns per lane
constexpr int MAX_N = 128; // state limit: 4 state columns per lane

__host__ __device__ inline int key_cols(int chunk) {
  return 32 * ((chunk + 31) / 32);
}

__host__ inline size_t cb_smem_floats(int chunk, int n) {
  return (size_t)chunk * (n + 1) + (size_t)QT * n;
}

// C.B^T of one chunk of one (sequence, group): rows q0 .. q0 + 31 against
// the key columns they can see (t < q0 + 32), raw dot products in f32,
// into cb [B, G, chunks, Q, key_cols(Q)].  Grid (B * G, chunks, Q / 32).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ bm,   // [B, L, G, N]
              const T* __restrict__ cm,   // [B, L, G, N]
              float* __restrict__ cb,     // [B, G, L / Q, Q, key_cols(Q)]
              int seqlen, int g, int n, int chunk) {
  const int b = blockIdx.x / g;
  const int grp = blockIdx.x % g;
  const int ic = blockIdx.y;
  const int q0 = blockIdx.z * QT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int np = n + 1;
  const int kt = key_cols(chunk);
  const int rows = min(chunk, q0 + QT);  // key rows a causal tile sees

  extern __shared__ float smem[];
  float* bs = smem;              // [rows, N + 1]
  float* cs = bs + chunk * np;   // [QT, N]
  const size_t tok0 = (size_t)b * seqlen + (size_t)ic * chunk;
  for (int i = tid; i < rows * n; i += THREADS) {
    const int t = i / n, c = i - (i / n) * n;
    bs[t * np + c] = to_f32(bm[((tok0 + t) * g + grp) * n + c]);
  }
  for (int i = tid; i < QT * n; i += THREADS) {
    const int r = i / n, c = i - (i / n) * n;
    cs[r * n + c] = q0 + r < chunk
                        ? to_f32(cm[((tok0 + q0 + r) * g + grp) * n + c])
                        : 0.f;
  }
  __syncthreads();

  // rows q0 + 4 warp + i against key columns lane + 32 j, j <= q0 / 32
  const int jt = q0 / 32 + 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < n; ++c) {
    float cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = cs[(warp * 4 + i) * n + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = lane + 32 * j;
      if (j < jt && t < chunk) {
        const float bv = bs[t * np + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += cv[i] * bv;
      }
    }
  }
  float* out = cb + (((size_t)b * g + grp) * (seqlen / chunk) + ic) *
                        (size_t)chunk * kt;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + warp * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < jt && q < chunk) out[(size_t)q * kt + lane + 32 * j] = acc[i][j];
    }
  }
}

__host__ inline size_t smem_floats(int chunk, int n) {
  return (size_t)chunk * (n + 1) + (size_t)QT * n +
         (size_t)QT * key_cols(chunk) + (size_t)chunk * PT +
         (size_t)PT * (n + 1) + 3 * (size_t)chunk;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x,         // [B, L, H, P]
                const float* __restrict__ dt,    // [B, L, H]
                const float* __restrict__ a,     // [H]
                const T* __restrict__ bm,        // [B, L, G, N]
                const T* __restrict__ cm,        // [B, L, G, N]
                const float* __restrict__ init,  // [B, H, P, N] or null
                const float* __restrict__ cb,    // ssd_cb_kernel's output
                T* __restrict__ y,               // [B, L, H, P]
                float* __restrict__ fin,         // [B, H, P, N]
                int seqlen, int h, int p, int g, int n, int chunk) {
  const int b = blockIdx.x;
  const int hh = blockIdx.y;
  const int p0 = blockIdx.z * PT;
  const int grp = hh / (h / g);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int np = n + 1;           // padded row of B and of the state
  const int kt = key_cols(chunk); // row of the score tile

  extern __shared__ float smem[];
  float* bs = smem;                // [Q, N + 1] B of the chunk
  float* cs = bs + chunk * np;     // [QT, N]    C of the query tile
  float* ss = cs + QT * n;         // [QT, kt]   masked, decayed scores
  float* xs = ss + QT * kt;        // [Q, PT]    x * dt
  float* st = xs + chunk * PT;     // [PT, N + 1] the carried state
  float* seg = st + PT * np;       // [Q] cumulative log decay
  float* eseg = seg + chunk;       // [Q] exp(seg)
  float* wdec = eseg + chunk;      // [Q] exp(total - seg)

  const float av = a[hh];
  const size_t state0 = ((size_t)b * h + hh) * p;  // row of (b, h, p = 0)
  for (int i = tid; i < PT * n; i += THREADS) {
    const int r = i / n, c = i - (i / n) * n;
    float v = 0.f;
    if (init != nullptr && p0 + r < p) v = init[(state0 + p0 + r) * n + c];
    st[r * np + c] = v;
  }

  const int nc = seqlen / chunk;
  for (int ic = 0; ic < nc; ++ic) {
    const size_t tok0 = (size_t)b * seqlen + (size_t)ic * chunk;
    const float* cbc = cb + (((size_t)b * g + grp) * nc + ic) *
                                (size_t)chunk * kt;  // this chunk's C.B^T
    for (int i = tid; i < chunk * n; i += THREADS) {
      const int t = i / n, c = i - (i / n) * n;
      bs[t * np + c] = to_f32(bm[((tok0 + t) * g + grp) * n + c]);
    }
    for (int i = tid; i < chunk * PT; i += THREADS) {
      const int t = i / PT, r = i % PT;
      float v = 0.f;
      if (p0 + r < p) {
        const size_t row = (tok0 + t) * h + hh;
        v = to_f32(x[row * p + p0 + r]) * dt[row];
      }
      xs[t * PT + r] = v;
    }
    // seg: warp 0, each lane a run of 4 consecutive steps, then an
    // inclusive scan of the runs across the lanes
    if (warp == 0) {
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        run += t < chunk ? av * dt[(tok0 + t) * h + hh] : 0.f;
        loc[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        if (t < chunk) seg[t] = excl + loc[k];
      }
      __syncwarp();
      const float total = seg[chunk - 1];
      for (int t = lane; t < chunk; t += 32) {
        eseg[t] = expf(seg[t]);
        wdec[t] = expf(total - seg[t]);
      }
    }
    __syncthreads();
    const float total = seg[chunk - 1];

    for (int q0 = 0; q0 < chunk; q0 += QT) {
      for (int i = tid; i < QT * n; i += THREADS) {
        const int r = i / n, c = i - (i / n) * n;
        cs[r * n + c] =
            q0 + r < chunk ? to_f32(cm[((tok0 + q0 + r) * g + grp) * n + c])
                           : 0.f;
      }
      __syncthreads();

      // masked, decayed scores of query rows q0 + 4 warp + i against key
      // columns lane + 32 j; a row sees keys t <= q, so only j <= q0 / 32
      const int jt = q0 / 32 + 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + warp * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = lane + 32 * j;
          if (j < jt) {
            float v = 0.f;
            if (q < chunk && t <= q)
              v = cbc[(size_t)q * kt + t] * expf(seg[q] - seg[t]);
            ss[(warp * 4 + i) * kt + t] = v;
          }
        }
      }
      __syncthreads();

      // y of query rows q0 + 4 warp + i, state row p0 + lane
      float ya[4] = {0.f, 0.f, 0.f, 0.f};
      const int tmax = min(q0 + QT, chunk);
      for (int t = 0; t < tmax; ++t) {
        const float xv = xs[t * PT + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i) ya[i] += ss[(warp * 4 + i) * kt + t] * xv;
      }
      float yo[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < n; ++c) {
        const float sv = st[lane * np + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) yo[i] += cs[(warp * 4 + i) * n + c] * sv;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + warp * 4 + i;
        if (q < chunk && p0 + lane < p) {
          y[((tok0 + q) * h + hh) * p + p0 + lane] =
              from_f32<T>(ya[i] + eseg[q] * yo[i]);
        }
      }
      __syncthreads();  // cs and ss are rewritten by the next tile
    }

    // state update: rows p0 + 4 warp + i, columns lane + 32 j
    float sa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sa[i][j] = 0.f;
    for (int t = 0; t < chunk; ++t) {
      const float w = wdec[t];
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = w * xs[t * PT + warp * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (c < n) {
          const float bv = bs[t * np + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) sa[i][j] += xv[i] * bv;
        }
      }
    }
    const float dec = expf(total);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (c < n) st[r * np + c] = dec * st[r * np + c] + sa[i][j];
      }
    }
    __syncthreads();  // bs, xs and seg are rewritten by the next chunk
  }

  for (int i = tid; i < PT * n; i += THREADS) {
    const int r = i / n, c = i - (i / n) * n;
    if (p0 + r < p) fin[(state0 + p0 + r) * n + c] = st[r * np + c];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* init, void* cb, void* y, void* fin,
           int b, int seqlen, int h, int p, int g, int n, int chunk,
           void* stream) {
  if (chunk < 1 || chunk > MAX_Q || n < 1 || n > MAX_N || g < 1 || h % g ||
      seqlen % chunk)
    return (int)cudaErrorInvalidValue;
  if (seqlen == 0 || b == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t cb_smem = sizeof(float) * cb_smem_floats(chunk, n);
  cudaError_t err = allow_smem(ssd_cb_kernel<T>, cb_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_cb_kernel<T><<<dim3(b * g, seqlen / chunk, (chunk + QT - 1) / QT),
                     THREADS, cb_smem, st>>>(
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<float*>(cb), seqlen, g, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * smem_floats(chunk, n);
  err = allow_smem(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<dim3(b, h, (p + PT - 1) / PT), THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(init),
      static_cast<const float*>(cb), static_cast<T*>(y),
      static_cast<float*>(fin), seqlen, h, p, g, n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes.  ``init`` may be null (a zero
// initial state).  ``cb`` is f32 scratch of B * G * L * key_cols(chunk)
// values (key_cols rounds the chunk up to a multiple of 32).  Each
// returns cudaGetLastError() after its launches (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, const void* init,
                            void* cb, void* y, void* fin, int b, int seqlen,
                            int h, int p, int g, int n, int chunk,
                            void* stream) {
  return repro_torch::launch<float>(x, dt, a, bm, cm, init, cb, y, fin, b,
                                    seqlen, h, p, g, n, chunk, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                             const void* bm, const void* cm, const void* init,
                             void* cb, void* y, void* fin, int b, int seqlen,
                             int h, int p, int g, int n, int chunk,
                             void* stream) {
  return repro_torch::launch<__nv_bfloat16>(x, dt, a, bm, cm, init, cb, y,
                                            fin, b, seqlen, h, p, g, n, chunk,
                                            stream);
}
