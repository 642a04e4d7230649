// The backward of the dense flash prefill for Hopper (sm_90a): dQ, dK and
// dV of softmax(scale * Q.K^T, masked) . V from the forward's output O, its
// per-row natural-log LSE and the incoming dO.
//
// Replaces the gradient of src/repro/kernels/chunked_prefill.py:_kernel
// (K4).  The reference has no backward kernel: repro/kernels defines no
// custom_vjp, so jax.grad differentiates the jnp oracle attention_ref on
// the CPU.  This is the port's own design, the FlashAttention-2 backward:
//
//   P  = exp(scale * Q.K^T - lse)      (recomputed, never stored)
//   dP = dO . V^T
//   dS = P o (dP - delta),   delta = rowsum(dO o O)
//   dV = P^T . dO,   dK = scale * dS^T . Q,   dQ = scale * dS . K
//
// The mask is the forward's: key k is visible to the query at absolute
// position p = q_offset + i when k <= p (causal) and k > p - window
// (sliding window); a row with no visible key has lse = -inf and gets
// zero gradients (every P of it is set to 0, never exp(-inf + inf)).
//
// Three launches, all deterministic (fixed summation order, no atomics):
//
//   * bwd_delta: one warp per (b, i, h) row, delta [B, H, Sq] f32;
//   * dkdv: one block per (key tile, kv head, sequence).  A block loads
//     its K/V tile once, walks the query tiles of all H / Hkv heads of its
//     group that can see the tile (causal: from the diagonal on; window:
//     up to the tile's last key + window - 1), accumulates dK and dV in
//     f32 and writes each once; GQA is summed inside the block;
//   * dq: one block per (query tile, head, sequence).  A block walks the
//     visible key tiles and writes dQ once.
//   The tensor-core body launches the longest causal walks first.
//
// Two bodies, chosen by the wrapper from (dtype, Dq, Dv) alone:
//
//   * bwd_tc, bf16 with (Dq, Dv) in {(64, 64), (128, 128), (160, 160),
//     (192, 192), (192, 128)}: the forward's FlashAttention-2 arrangement
//     (prefill_tc in chunked_prefill.cu) on mma.sync.m16n8k16, 4 warps of
//     16 rows each.  In dkdv a warp owns 16 keys: S^T = K.Q^T and dP^T =
//     V.dO^T accumulate in f32 registers, P^T and dS^T are formed there
//     and rounded to bf16 once as the A operands of dV += P^T.dO and dK +=
//     dS^T.Q (Q and dO read by ldmatrix.trans), as the forward feeds P to
//     P.V; dK and dV stay in registers across the whole walk.  In dq a
//     warp owns 16 query rows and the same holds for S, dP, dS and dQ +=
//     dS.K.  The walked tiles (Q and dO in dkdv, K and V in dq) are
//     double-buffered in shared memory by 16-byte cp.async; K and V (dkdv)
//     or Q and dO (dq) are staged once.  Only tiles that cross the
//     diagonal, the window's edge or a ragged end mask element by
//     element.  Where Dq + Dv > 256 a dkdv step takes 32 query rows, not
//     64, so that the two accumulators fit the registers.
//   * bwd_fma, everything else (f32, whose limit tensor cores would miss by
//     rounding through TF32, and bf16 at other head dims): f32 FMAs from
//     shared memory, 32 x 32 tiles, any Dq and Dv up to 256.
//
// Bound on the H100: at TinyLlama's training shape (B4 x S2048, H32, Hkv4,
// D64, causal) the five products over the visible half of the scores are
// ~172 GFLOP, 0.174 ms at the bf16 tensor-core peak (989 TFLOP/s); its
// bytes (Q, K, V, O, dO, LSE in; dQ, dK, dV out: ~153 MB) take 0.046 ms.
// So it is bound by operations, and the bf16 body runs on tensor cores.
// The dq launch recomputes S and dP rather than sharing them with dkdv
// through atomics or a second pass over stored P.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

struct BwdArgs {
  int sq, skv, h, hkv, d, dv;
  float scale;
  int q_offset, causal, window;  // window <= 0: none
};

__device__ __forceinline__ bool key_visible(const BwdArgs& a, int qpos,
                                            int kpos) {
  return (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || kpos > qpos - a.window);
}

// The query rows [begin, end) that can see a key of [k0, k0 + n).
__device__ __forceinline__ void query_rows(const BwdArgs& a, int k0, int n,
                                           int& begin, int& end) {
  begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  end = a.window > 0 ? min(a.sq, k0 + n - 1 + a.window - a.q_offset) : a.sq;
}

// The keys [begin, end) the query rows [i0, i0 + n) can see.
__device__ __forceinline__ void key_cols(const BwdArgs& a, int i0, int n,
                                         int& begin, int& end) {
  end = a.causal ? min(a.skv, a.q_offset + i0 + n) : a.skv;
  begin = a.window > 0 ? max(0, a.q_offset + i0 - a.window + 1) : 0;
}

// Row index (in units of the head dim) of position ``pos`` of head
// ``head`` in a [B, S, heads, D] tensor.
__device__ __forceinline__ size_t row_of(int b, int s, int pos, int heads,
                                         int head) {
  return ((size_t)b * s + pos) * heads + head;
}

// P and dS of one score (0 where masked or where the row saw no key).
__device__ __forceinline__ void p_ds(const BwdArgs& a, bool ok, float s,
                                     float dp, float lse, float delta,
                                     float& p, float& ds) {
  p = 0.f;
  ds = 0.f;
  if (ok && lse != -INFINITY) {
    p = expf(s * a.scale - lse);
    ds = p * (dp - delta);
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO o O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
          float* __restrict__ delta, int rows, int sq, int h, int dv) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (size_t)row * dv;
  const T* g = dout + (size_t)row * dv;
  float s = 0.f;
  for (int c = lane; c < dv; c += 32) s += to_f32(o[c]) * to_f32(g[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const int hh = row % h, i = (row / h) % sq, b = row / (h * sq);
    delta[((size_t)b * h + hh) * sq + i] = s;
  }
}

// ---------------------------------------------------------------------------
// bwd_fma: f32 FMAs from shared memory
// ---------------------------------------------------------------------------

namespace fma_body {

constexpr int THREADS = 256;
constexpr int BQ = 32;
constexpr int BK = 32;  // one key per lane in the score loop

size_t dkdv_smem(int d, int dv) {
  return sizeof(float) *
         ((size_t)BK * (d + 1) + (size_t)BK * (dv + 1) + (size_t)BK * d +
          (size_t)BK * dv + (size_t)BQ * d + (size_t)BQ * dv +
          2 * (size_t)BQ * BK + 2 * (size_t)BQ);
}

size_t dq_smem(int d, int dv) {
  return sizeof(float) *
         ((size_t)BQ * d + (size_t)BQ * dv + (size_t)BK * (d + 1) +
          (size_t)BK * (dv + 1) + 2 * (size_t)BQ * BK + (size_t)BQ * d +
          2 * (size_t)BQ);
}

// rows [0, n) of a [*, heads, D] tensor from ``row0`` on into f32 shared
// rows of stride ``ld``; zeros past n
template <typename T>
__device__ __forceinline__ void load_f32(float* dst, int ld, const T* src,
                                         int b, int s, int pos0, int heads,
                                         int head, int d, int rows, int n) {
  for (int i = threadIdx.x; i < rows * d; i += THREADS) {
    const int r = i / d, c = i % d;
    dst[r * ld + c] =
        r < n ? to_f32(src[row_of(b, s, pos0 + r, heads, head) * d + c])
              : 0.f;
  }
}

// P and dS of the tile (rows i0.., keys k0..) into ps / dss [BQ][BK]
__device__ __forceinline__ void tile_p_ds(const BwdArgs& a, const float* qs,
                                          const float* dos, const float* ks,
                                          const float* vs, const float* lse_s,
                                          const float* delta_s, int i0,
                                          int n_rows, int k0, int n_keys,
                                          float* ps, float* dss) {
  for (int e = threadIdx.x; e < BQ * BK; e += THREADS) {
    const int i = e / BK, j = e % BK;
    const bool ok = i < n_rows && j < n_keys &&
                    key_visible(a, a.q_offset + i0 + i, k0 + j);
    float s = 0.f, dp = 0.f;
    if (ok) {
      const float* qr = qs + i * a.d;
      const float* kr = ks + j * (a.d + 1);
      for (int c = 0; c < a.d; ++c) s += qr[c] * kr[c];
      const float* gr = dos + i * a.dv;
      const float* vr = vs + j * (a.dv + 1);
      for (int c = 0; c < a.dv; ++c) dp += gr[c] * vr[c];
    }
    float p, ds;
    p_ds(a, ok, s, dp, lse_s[i], delta_s[i], p, ds);
    ps[e] = p;
    dss[e] = ds;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_fma(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, BwdArgs a) {
  const int k0 = blockIdx.x * BK;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_keys = min(BK, a.skv - k0);
  const int rep = a.h / a.hkv;
  const int d = a.d, dvd = a.dv;

  extern __shared__ float smem[];
  float* ks = smem;                    // [BK][D + 1]
  float* vs = ks + BK * (d + 1);       // [BK][Dv + 1]
  float* dks = vs + BK * (dvd + 1);    // [BK][D]
  float* dvs = dks + BK * d;           // [BK][Dv]
  float* qs = dvs + BK * dvd;          // [BQ][D]
  float* dos = qs + BQ * d;            // [BQ][Dv]
  float* ps = dos + BQ * dvd;          // [BQ][BK]
  float* dss = ps + BQ * BK;           // [BQ][BK]
  float* lse_s = dss + BQ * BK;        // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  load_f32(ks, d + 1, k, b, a.skv, k0, a.hkv, g, d, BK, n_keys);
  load_f32(vs, dvd + 1, v, b, a.skv, k0, a.hkv, g, dvd, BK, n_keys);
  for (int i = threadIdx.x; i < BK * d; i += THREADS) dks[i] = 0.f;
  for (int i = threadIdx.x; i < BK * dvd; i += THREADS) dvs[i] = 0.f;

  int i_begin, i_end;
  query_rows(a, k0, n_keys, i_begin, i_end);
  for (int hh = g * rep; hh < (g + 1) * rep; ++hh) {
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      const int n_rows = min(BQ, i_end - i0);
      __syncthreads();  // the previous tile's readers are done
      load_f32(qs, d, q, b, a.sq, i0, a.h, hh, d, BQ, n_rows);
      load_f32(dos, dvd, dout, b, a.sq, i0, a.h, hh, dvd, BQ, n_rows);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const size_t at = ((size_t)b * a.h + hh) * a.sq + i0 + r;
        lse_s[r] = r < n_rows ? lse[at] : -INFINITY;
        delta_s[r] = r < n_rows ? delta[at] : 0.f;
      }
      __syncthreads();
      tile_p_ds(a, qs, dos, ks, vs, lse_s, delta_s, i0, n_rows, k0, n_keys,
                ps, dss);
      __syncthreads();
      for (int e = threadIdx.x; e < BK * dvd; e += THREADS) {
        const int j = e / dvd, c = e % dvd;
        float acc = 0.f;
        for (int i = 0; i < n_rows; ++i) acc += ps[i * BK + j] * dos[i * dvd + c];
        dvs[e] += acc;
      }
      for (int e = threadIdx.x; e < BK * d; e += THREADS) {
        const int j = e / d, c = e % d;
        float acc = 0.f;
        for (int i = 0; i < n_rows; ++i) acc += dss[i * BK + j] * qs[i * d + c];
        dks[e] += acc;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_keys * d; e += THREADS) {
    const int j = e / d, c = e % d;
    dk[row_of(b, a.skv, k0 + j, a.hkv, g) * d + c] =
        from_f32<T>(dks[e] * a.scale);
  }
  for (int e = threadIdx.x; e < n_keys * dvd; e += THREADS) {
    const int j = e / dvd, c = e % dvd;
    dv[row_of(b, a.skv, k0 + j, a.hkv, g) * dvd + c] = from_f32<T>(dvs[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_dq_fma(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, BwdArgs a) {
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / (a.h / a.hkv);
  const int n_rows = min(BQ, a.sq - i0);
  const int d = a.d, dvd = a.dv;

  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][D]
  float* dos = qs + BQ * d;            // [BQ][Dv]
  float* ks = dos + BQ * dvd;          // [BK][D + 1]
  float* vs = ks + BK * (d + 1);       // [BK][Dv + 1]
  float* ps = vs + BK * (dvd + 1);     // [BQ][BK]
  float* dss = ps + BQ * BK;           // [BQ][BK]
  float* dqs = dss + BQ * BK;          // [BQ][D]
  float* lse_s = dqs + BQ * d;         // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  load_f32(qs, d, q, b, a.sq, i0, a.h, hq, d, BQ, n_rows);
  load_f32(dos, dvd, dout, b, a.sq, i0, a.h, hq, dvd, BQ, n_rows);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const size_t at = ((size_t)b * a.h + hq) * a.sq + i0 + r;
    lse_s[r] = r < n_rows ? lse[at] : -INFINITY;
    delta_s[r] = r < n_rows ? delta[at] : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * d; i += THREADS) dqs[i] = 0.f;

  int kv_begin, kv_end;
  key_cols(a, i0, n_rows, kv_begin, kv_end);
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    const int n_keys = min(BK, kv_end - k0);
    __syncthreads();
    load_f32(ks, d + 1, k, b, a.skv, k0, a.hkv, g, d, BK, n_keys);
    load_f32(vs, dvd + 1, v, b, a.skv, k0, a.hkv, g, dvd, BK, n_keys);
    __syncthreads();
    tile_p_ds(a, qs, dos, ks, vs, lse_s, delta_s, i0, n_rows, k0, n_keys,
              ps, dss);
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * d; e += THREADS) {
      const int i = e / d, c = e % d;
      float acc = 0.f;
      for (int j = 0; j < n_keys; ++j) acc += dss[i * BK + j] * ks[j * (d + 1) + c];
      dqs[e] += acc;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * d; e += THREADS) {
    const int i = e / d, c = e % d;
    dq[row_of(b, a.sq, i0 + i, a.h, hq) * d + c] =
        from_f32<T>(dqs[e] * a.scale);
  }
}

}  // namespace fma_body

// ---------------------------------------------------------------------------
// bwd_tc: bf16 on tensor cores (mma.sync)
// ---------------------------------------------------------------------------

namespace tc_body {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 16 * WARPS;  // keys per dkdv block, 16 per warp
constexpr int BQ_DQ = 16 * WARPS;  // query rows per dq block, 16 per warp
constexpr int BK_DQ = 64;       // keys per tile of the dq walk
constexpr int PAD = 8;          // bf16 elements (16 bytes) after each row
constexpr float LOG2E = 1.4426950408889634f;

// query rows per tile of the dkdv walk: 64, or 32 where the two f32
// accumulators (dK over Dq, dV over Dv) already hold most registers
template <int DQ, int DV>
__host__ __device__ constexpr int bq_dkdv() { return DQ + DV <= 256 ? 64 : 32; }

template <int DQ, int DV>
constexpr size_t dkdv_smem() {
  // K and V tiles once, then two buffers of Q and dO tiles, LSE and delta
  return sizeof(bf16) * ((size_t)BK * (DQ + PAD) + (size_t)BK * (DV + PAD) +
                         2 * (size_t)bq_dkdv<DQ, DV>() * (DQ + DV + 2 * PAD)) +
         sizeof(float) * 4 * (size_t)bq_dkdv<DQ, DV>();
}

template <int DQ, int DV>
constexpr size_t dq_smem() {
  // Q and dO tiles once, then two buffers of K and V tiles
  return sizeof(bf16) * ((size_t)BQ_DQ * (DQ + DV + 2 * PAD) +
                         2 * (size_t)BK_DQ * (DQ + DV + 2 * PAD));
}

// rows [0, n) of a [*, heads, D] bf16 tensor from position ``pos0`` into
// shared rows of D + PAD by 16-byte cp.async; zeros past n (the copy
// reads nothing there)
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int s, int pos0, int heads,
                                          int head, int n) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < n;
    cp_async16(dst + r * (D + PAD) + c,
               src + row_of(b, s, pos0 + (ok ? r : 0), heads, head) * D + c,
               ok);
  }
}

// c[16 x 8 n] += A[16 x KD] . B[n x KD]^T for NT n-tiles: A's 16 rows at
// ``a_rows`` (row stride KD + PAD), B's rows at ``b_rows``; A fragments by
// ldmatrix, B fragments by ldmatrix (B stored row-major [n][k])
template <int KD, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const bf16* a_rows,
                                        const bf16* b_rows) {
  constexpr int LD = KD + PAD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b_rows + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16_16816(c[2 * np], a, bf[0], bf[1]);
      mma_bf16_16816(c[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// acc[16 x N] += X[16 x 16 KT] . Y[16 KT x N]: X the accumulator-layout
// tiles ``x`` (KT pairs of 8-column n-tiles, rounded to bf16 as the A
// operand), Y stored row-major [k][n] at ``y_rows`` (ldmatrix.trans)
template <int N, int KT>
__device__ __forceinline__ void mma_xy(float (&acc)[N / 8][4],
                                       const float (&x)[2 * KT][4],
                                       const bf16* y_rows) {
  constexpr int LD = N + PAD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < N / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, y_rows + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                  dp * 16 + (lane >> 4) * 8);
      mma_bf16_16816(acc[2 * dp], a, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

// rows ``row0`` and ``row0 + 8`` of an accumulator (this lane's two rows)
// to global, times ``mul``, where they are below ``n_valid``
template <int N, typename RowFn>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 8][4],
                                           bf16* dst, int row0, int n_valid,
                                           float mul, RowFn row_index) {
  const int qc = threadIdx.x & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + hr * 8;
    if (r < n_valid) {
      bf16* p = dst + row_index(r) * N;
#pragma unroll
      for (int n = 0; n < N / 8; ++n)
        *reinterpret_cast<uint32_t*>(p + n * 8 + qc * 2) =
            pack_bf16(acc[n][2 * hr] * mul, acc[n][2 * hr + 1] * mul);
    }
  }
}

// dK and dV of one 64-key tile: each warp owns 16 keys and walks every
// (head of the group, query tile) that sees the tile.  S^T = K.Q^T and
// dP^T = V.dO^T stay in registers; P^T and dS^T are formed there and fed
// straight back as the A operands of dV += P^T.dO and dK += dS^T.Q
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, BwdArgs a) {
  constexpr int BQ = bq_dkdv<DQ, DV>();
  constexpr int LDQ = DQ + PAD, LDV = DV + PAD;
  constexpr int NT = BQ / 8;  // 8-query n-tiles of S^T
  static_assert(DQ % 16 == 0 && DV % 16 == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LDQ]
  bf16* vs = ks + BK * LDQ;                      // [BK][LDV]
  bf16* qs = vs + BK * LDV;                      // [2][BQ][LDQ]
  bf16* gs = qs + 2 * BQ * LDQ;                  // [2][BQ][LDV]
  float* lse_s = reinterpret_cast<float*>(gs + 2 * BQ * LDV);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                             // [2][BQ]

  // grid (Hkv, B, key tiles): every group's first key tile, which the
  // most query tiles see under a causal mask, is launched first
  const int k0 = blockIdx.z * BK;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int n_keys = min(BK, a.skv - k0);
  const int rep = a.h / a.hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qr = lane >> 2, qc = lane & 3;
  const float scale2 = a.scale * LOG2E;

  int i_begin, i_end;
  query_rows(a, k0, n_keys, i_begin, i_end);
  const int qtiles = i_end > i_begin ? (i_end - i_begin + BQ - 1) / BQ : 0;
  const int n_iter = rep * qtiles;

  load_tile<DQ, BK>(ks, k, b, a.skv, k0, a.hkv, g, n_keys);
  load_tile<DV, BK>(vs, v, b, a.skv, k0, a.hkv, g, n_keys);
  // the (head, query tile) of step ``it``, and its copy into ``buf``
  auto tile_of = [&](int it, int& hh, int& i0, int& n_rows) {
    hh = g * rep + it / qtiles;
    i0 = i_begin + (it % qtiles) * BQ;
    n_rows = min(BQ, i_end - i0);
  };
  auto load_q = [&](int it, int buf) {
    int hh, i0, n_rows;
    tile_of(it, hh, i0, n_rows);
    load_tile<DQ, BQ>(qs + buf * BQ * LDQ, q, b, a.sq, i0, a.h, hh, n_rows);
    load_tile<DV, BQ>(gs + buf * BQ * LDV, dout, b, a.sq, i0, a.h, hh,
                      n_rows);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool ok = r < n_rows;
      const size_t at = ((size_t)b * a.h + hh) * a.sq + i0 + (ok ? r : 0);
      cp_async4(lse_s + buf * BQ + r, lse + at, ok);
      cp_async4(delta_s + buf * BQ + r, delta + at, ok);
    }
  };
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();  // group 0: K, V and the first query tile

  float dk_acc[DQ / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DQ / 8; ++n)
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) load_q(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    int hh, i0, n_rows;
    tile_of(it, hh, i0, n_rows);
    const bf16* qb = qs + buf * BQ * LDQ;
    const bf16* gb = gs + buf * BQ * LDV;
    const float* lb = lse_s + buf * BQ;
    const float* db = delta_s + buf * BQ;

    float s[NT][4], dp[NT][4];
    mma_abt<DQ, NT>(s, ks + warp * 16 * LDQ, qb);   // S^T = K . Q^T
    mma_abt<DV, NT>(dp, vs + warp * 16 * LDV, gb);  // dP^T = V . dO^T

    // a tile needs element masks only where it crosses the causal
    // diagonal, the window's edge, or a ragged end; elsewhere every row
    // sees every key (and so has a finite LSE)
    const int qlo = a.q_offset + i0;
    const bool edge = n_rows < BQ || n_keys < BK ||
                      (a.causal && k0 + BK - 1 > qlo) ||
                      (a.window > 0 && k0 <= qlo + BQ - 1 - a.window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + qc * 2 + (e & 1);
        const int kj = warp * 16 + qr + (e >> 1) * 8;
        const float l = lb[qi];
        bool ok = true;
        if (edge)
          ok = qi < n_rows && kj < n_keys && l != -INFINITY &&
               key_visible(a, qlo + qi, k0 + kj);
        const float p = ok ? exp2_approx(fmaf(s[n][e], scale2, -l * LOG2E))
                           : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - db[qi]);
      }
    }
    mma_xy<DV, BQ / 16>(dv_acc, s, gb);   // dV += P^T . dO
    mma_xy<DQ, BQ / 16>(dk_acc, dp, qb);  // dK += dS^T . Q
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();  // a block with no query tile still waits its copies

  auto key_row = [&](int j) { return row_of(b, a.skv, k0 + j, a.hkv, g); };
  store_rows<DQ>(dk_acc, dk, warp * 16 + qr, n_keys, a.scale, key_row);
  store_rows<DV>(dv_acc, dv, warp * 16 + qr, n_keys, 1.f, key_row);
}

// dQ of one 64-row query tile: each warp owns 16 rows and walks the
// visible key tiles, K and V double-buffered; S, dP, P and dS stay in
// registers, dS the A operand of dQ += dS.K
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, BwdArgs a) {
  constexpr int BQ = BQ_DQ, BKT = BK_DQ;
  constexpr int LDQ = DQ + PAD, LDV = DV + PAD;
  constexpr int NT = BKT / 8;  // 8-key n-tiles of S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDQ]
  bf16* gs = qs + BQ * LDQ;                      // [BQ][LDV]
  bf16* ks = gs + BQ * LDV;                      // [2][BKT][LDQ]
  bf16* vs = ks + 2 * BKT * LDQ;                 // [2][BKT][LDV]

  // grid (H, B, query tiles), the last query tiles (the longest causal
  // walks) launched first; the heads of one kv group are neighbours and
  // share each K/V tile through L2
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int g = hq / (a.h / a.hkv);
  const int n_rows = min(BQ, a.sq - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qr = lane >> 2, qc = lane & 3;
  const float scale2 = a.scale * LOG2E;

  int kv_begin, kv_end;
  key_cols(a, i0, n_rows, kv_begin, kv_end);
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BKT - 1) / BKT : 0;

  load_tile<DQ, BQ>(qs, q, b, a.sq, i0, a.h, hq, n_rows);
  load_tile<DV, BQ>(gs, dout, b, a.sq, i0, a.h, hq, n_rows);
  auto load_kv = [&](int t, int buf) {
    const int kt = kv_begin + t * BKT;
    const int n = min(BKT, kv_end - kt);
    load_tile<DQ, BKT>(ks + buf * BKT * LDQ, k, b, a.skv, kt, a.hkv, g, n);
    load_tile<DV, BKT>(vs + buf * BKT * LDV, v, b, a.skv, kt, a.hkv, g, n);
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();  // group 0: Q, dO and the first K/V tile

  // this lane's rows: r0 = warp * 16 + qr and r0 + 8
  const int r0 = warp * 16 + qr;
  float l2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + hr * 8;
    const size_t at = ((size_t)b * a.h + hq) * a.sq + i0 + min(r, n_rows - 1);
    l2[hr] = r < n_rows ? lse[at] * LOG2E : -INFINITY;
    dl[hr] = r < n_rows ? delta[at] : 0.f;
  }

  float dq_acc[DQ / 8][4];
#pragma unroll
  for (int n = 0; n < DQ / 8; ++n)
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kt = kv_begin + t * BKT;
    const int n_keys = min(BKT, kv_end - kt);
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kb = ks + buf * BKT * LDQ;
    const bf16* vb = vs + buf * BKT * LDV;

    float s[NT][4], dp[NT][4];
    mma_abt<DQ, NT>(s, qs + warp * 16 * LDQ, kb);   // S = Q . K^T
    mma_abt<DV, NT>(dp, gs + warp * 16 * LDV, vb);  // dP = dO . V^T

    const int qlo = a.q_offset + i0;
    const bool edge = n_rows < BQ || n_keys < BKT ||
                      (a.causal && kt + BKT - 1 > qlo) ||
                      (a.window > 0 && kt <= qlo + BQ - 1 - a.window);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int kj = n * 8 + qc * 2 + (e & 1);
        bool ok = true;
        if (edge)
          ok = r0 + hr * 8 < n_rows && kj < n_keys && l2[hr] != -INFINITY &&
               key_visible(a, qlo + r0 + hr * 8, kt + kj);
        const float p =
            ok ? exp2_approx(fmaf(s[n][e], scale2, -l2[hr])) : 0.f;
        dp[n][e] = p * (dp[n][e] - dl[hr]);
      }
    }
    mma_xy<DQ, BKT / 16>(dq_acc, dp, kb);  // dQ += dS . K
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

  auto q_row = [&](int i) { return row_of(b, a.sq, i0 + i, a.h, hq); };
  store_rows<DQ>(dq_acc, dq, r0, n_rows, a.scale, q_row);
}

}  // namespace tc_body

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
int launch_delta(const void* out, const void* dout, float* delta, int b,
                 int sq, int h, int dv, cudaStream_t st) {
  const int rows = b * sq * h;
  const int blocks = (rows + 7) / 8;  // 8 warps of 32 lanes a block
  if (blocks > 0)
    bwd_delta<T><<<blocks, 256, 0, st>>>(static_cast<const T*>(out),
                                         static_cast<const T*>(dout), delta,
                                         rows, sq, h, dv);
  return (int)cudaGetLastError();
}

template <int DQ, int DV>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int b, const BwdArgs& a, cudaStream_t st) {
  namespace tb = tc_body;
  using bf16 = __nv_bfloat16;
  const size_t s_kv = tb::dkdv_smem<DQ, DV>(), s_q = tb::dq_smem<DQ, DV>();
  cudaError_t err = allow_smem(tb::bwd_dkdv_tc<DQ, DV>, s_kv);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(tb::bwd_dq_tc<DQ, DV>, s_q);
  if (err != cudaSuccess) return (int)err;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* gb = static_cast<const bf16*>(dout);
  if (a.skv > 0) {
    const dim3 grid(a.hkv, b, (a.skv + tb::BK - 1) / tb::BK);
    tb::bwd_dkdv_tc<DQ, DV><<<grid, tb::THREADS, s_kv, st>>>(
        qb, kb, vb, gb, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.sq > 0) {
    const dim3 grid(a.h, b, (a.sq + tb::BQ_DQ - 1) / tb::BQ_DQ);
    tb::bwd_dq_tc<DQ, DV><<<grid, tb::THREADS, s_q, st>>>(
        qb, kb, vb, gb, lse, delta, static_cast<bf16*>(dq), a);
  }
  return (int)cudaGetLastError();
}

// ``tensor_cores`` is the wrapper's choice of body; the tensor-core body
// exists for bf16 at the (Dq, Dv) pairs below only, and asking for it
// elsewhere is an error, never a silent switch to the other body.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int b, int sq, int skv, int h, int hkv, int d,
           int dvd, float scale, int q_offset, int causal, int window,
           int tensor_cores, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs a{sq, skv, h, hkv, d, dvd, scale, q_offset, causal, window};
  float* delta_f = static_cast<float*>(delta);
  const float* lse_f = static_cast<const float*>(lse);
  int err = launch_delta<T>(out, dout, delta_f, b, sq, h, dvd, st);
  if (err != 0) return err;
  if (tensor_cores) {
    if (!std::is_same<T, __nv_bfloat16>::value)
      return (int)cudaErrorInvalidValue;
    if (d == 64 && dvd == 64)
      return launch_tc<64, 64>(q, k, v, dout, lse_f, delta_f, dq, dk, dv, b,
                               a, st);
    if (d == 128 && dvd == 128)
      return launch_tc<128, 128>(q, k, v, dout, lse_f, delta_f, dq, dk, dv,
                                 b, a, st);
    if (d == 160 && dvd == 160)
      return launch_tc<160, 160>(q, k, v, dout, lse_f, delta_f, dq, dk, dv,
                                 b, a, st);
    if (d == 192 && dvd == 192)
      return launch_tc<192, 192>(q, k, v, dout, lse_f, delta_f, dq, dk, dv,
                                 b, a, st);
    if (d == 192 && dvd == 128)
      return launch_tc<192, 128>(q, k, v, dout, lse_f, delta_f, dq, dk, dv,
                                 b, a, st);
    return (int)cudaErrorInvalidValue;
  }
  namespace fb = fma_body;
  const size_t s_kv = fb::dkdv_smem(d, dvd), s_q = fb::dq_smem(d, dvd);
  cudaError_t e = allow_smem(fb::bwd_dkdv_fma<T>, s_kv);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(fb::bwd_dq_fma<T>, s_q);
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  if (skv > 0) {
    const dim3 grid((skv + fb::BK - 1) / fb::BK, hkv, b);
    fb::bwd_dkdv_fma<T><<<grid, fb::THREADS, s_kv, st>>>(
        qt, kt, vt, gt, lse_f, delta_f, static_cast<T*>(dk),
        static_cast<T*>(dv), a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (sq > 0) {
    const dim3 grid((sq + fb::BQ - 1) / fb::BQ, h, b);
    fb::bwd_dq_fma<T><<<grid, fb::THREADS, s_q, st>>>(qt, kt, vt, gt, lse_f,
                                              delta_f, static_cast<T*>(dq), a);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes.  q [B, Sq, H, Dq], k [B, Skv, Hkv,
// Dq], v [B, Skv, Hkv, Dv], out and dout [B, Sq, H, Dv], lse [B, H, Sq]
// f32 from the forward; ``delta`` is [B, H, Sq] f32 scratch; dq, dk and
// dv are written whole (each element once).  ``tensor_cores`` selects the
// body (1: bwd_tc, bf16 only).  Each returns cudaGetLastError() after its
// launches (0 on success).
extern "C" int flash_prefill_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int h, int hkv, int d, int dvd,
    float scale, int q_offset, int causal, int window, int tensor_cores,
    void* stream) {
  return repro_torch::launch<float>(q, k, v, out, dout, lse, delta, dq, dk,
                                    dv, b, sq, skv, h, hkv, d, dvd, scale,
                                    q_offset, causal, window, tensor_cores,
                                    stream);
}

extern "C" int flash_prefill_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int h, int hkv, int d, int dvd,
    float scale, int q_offset, int causal, int window, int tensor_cores,
    void* stream) {
  return repro_torch::launch<__nv_bfloat16>(
      q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, skv, h, hkv, d, dvd,
      scale, q_offset, causal, window, tensor_cores, stream);
}
