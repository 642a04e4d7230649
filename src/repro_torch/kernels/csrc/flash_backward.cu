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
// Deterministic launches (fixed summation order, no atomics):
//
//   * delta = rowsum(dO o O) [B, H, Sq] f32: the FMA body's own launch,
//     bwd_delta, one warp per (b, i, h) row; the tensor-core body computes
//     it in the prologue of its dq launch, which runs first;
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
//   * bwd_wg, bf16 with (Dq, Dv) in {(64, 64), (128, 128), (160, 160),
//     (192, 192), (192, 128)}: the FlashAttention-3 arrangement on wgmma.
//     A block is one consumer warpgroup of 64 rows (keys in dkdv, query
//     rows in dq) beside one producer warp, which streams the walked tiles
//     through a ring of up to four stages: TMA copies
//     (cp.async.bulk.tensor) of one head's rows from 4-D maps of the [B, S,
//     heads, D] tensors, 128-byte swizzled, zero-filled past the ends,
//     each stage's arrival on an mbarrier and its release by the consumer
//     on another.  At D 64 two blocks share an SM (168 registers a
//     thread), so that one's exponentials overlap the other's products;
//     above, one block has 255.  ptxas keeps a warpgroup's wgmma in
//     flight only within the register budget the kernel starts with, so
//     no setmaxnreg moves registers from the producer: measured, two
//     consumer warpgroups beside a producer warpgroup (384 threads, 168
//     registers at entry) serialised their wgmma once a consumer needed
//     more, and beside a producer warp (288 threads) ptxas allowed no more
//     than 168 either (PERF.md).
//     - dkdv: S^T = K.Q^T and dP^T = V.dO^T with both operands in shared
//       memory (the producer hands over each tile's LSE and delta rows and
//       its position with it); P^T and dS^T are formed in the f32
//       accumulators and
//       rounded to bf16 once as the register A of dV += P^T.dO and dK +=
//       dS^T.Q, whose B is the same Q / dO tile read transposed by its
//       descriptor.  The query tile is Br = 64 rows up to Dq + Dv = 256,
//       32 up to 320 (D 160, MLA's 192 / 128) and 16 beyond, so that dK,
//       dV, S^T and dP^T fit the registers without spilling.
//     - dq: S = Q.K^T and dP = dO.V^T over 64-key tiles, dS the register
//       A of dQ += dS.K, K read transposed from the tile that fed S.
//     Each pair of products is issued alternately, so that one
//     accumulation chain's latency hides behind the other's; a tile's
//     products are waited for before the next tile's are issued (letting
//     them overlap made ptxas serialise every wgmma).  dK, dV and dQ stay
//     in f32 registers for the whole walk and are written once.
//     Only tiles that cross the causal diagonal, the window's edge or a
//     ragged end mask element by element; a row that sees no key (lse
//     -inf) gets P = 0.
//   * bwd_fma, everything else (f32, whose limit tensor cores would miss by
//     rounding through TF32, and bf16 at other head dims): f32 FMAs from
//     shared memory, 32 x 32 tiles, any Dq and Dv up to 256.
//
// Bound on the H100: at TinyLlama's training shape (B4 x S2048, H32, Hkv4,
// D64, causal) the five products over the visible half of the scores are
// ~172 GFLOP, 0.174 ms at the bf16 tensor-core peak (989 TFLOP/s); its
// bytes (Q, K, V, O, dO, LSE in; dQ, dK, dV out: ~153 MB) take 0.046 ms.
// So it is bound by operations, and what the design does about it: every
// product is a wgmma (up to m64n192k16 an instruction) fed from swizzled
// shared memory without bank conflicts; the copies are off the compute
// warps; two blocks a SM at D 64 overlap one's exponentials with the
// other's products.  The dq launch recomputes S and dP rather than sharing
// them with dkdv through atomics (whose order would vary from run to run)
// or a stored P: it executes seven products, ~240.6 GFLOP at that shape,
// 0.243 ms at the peak.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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
// bwd_wg: bf16 on wgmma, a TMA producer warp feeding two consumer
// warpgroups
// ---------------------------------------------------------------------------

namespace wg_body {

using bf16 = __nv_bfloat16;
namespace hp = hopper;

constexpr int WG = 128;                 // threads of a warpgroup
constexpr uint32_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr float LOG2E = 1.4426950408889634f;

constexpr int THREADS = WG + 32;         // a consumer and the producer warp

// bytes of shared memory of a ring of ``s`` stages beside ``fixed`` bytes
// staged once, with the barriers and the alignment slack; the stages a
// ring takes: as many, up to 4, as fit ``blocks`` blocks on an SM
__host__ __device__ constexpr uint32_t ring_smem(uint32_t fixed,
                                                 uint32_t stage, int s) {
  return fixed + s * stage + (2 * s + 1) * 8 + 1024;
}
__host__ __device__ constexpr int ring_stages(uint32_t fixed, uint32_t stage,
                                              int blocks) {
  return ring_smem(fixed, stage, 4) * blocks <= SMEM_LIMIT   ? 4
         : ring_smem(fixed, stage, 3) * blocks <= SMEM_LIMIT ? 3
                                                             : 2;
}

// query rows per tile of the dkdv walk.  The consumer thread holds dK (Dq
// / 2 floats), dV (Dv / 2), S^T and dP^T (Br / 2 each) of its 64 keys: Br
// 64 up to Dq + Dv = 256 (D 128: 192), 32 up to 320 (D 160, MLA's 192 /
// 128: 192), 16 beyond (192 / 192: 208)
__host__ __device__ constexpr int br_dkdv(int dq, int dv) {
  return dq + dv <= 256 ? 64 : dq + dv <= 320 ? 32 : 16;
}

// Blocks on one SM.  ptxas keeps a warpgroup's wgmma in flight only
// within the register budget a kernel starts with (setmaxnreg does not
// raise it).  At D 64 a consumer's live set (dkdv: dK, dV, S^T, dP^T, 128
// floats; dq: 96) fits the 168 registers that two 160-thread blocks leave
// a thread, so two blocks share an SM and one's exponentials overlap the
// other's products; elsewhere one block has up to 255.
__host__ __device__ constexpr int min_blocks(int dq, int dv) {
  return dq + dv <= 128 ? 2 : 1;
}

// Shared-memory layout of both kernels, byte offsets from a 1024-aligned
// base; every tile is in 128-byte-swizzled slabs (hopper.cuh).
template <int DQ, int DV>
struct Plan {
  static constexpr int BLOCKS = min_blocks(DQ, DV);
  // dkdv: K and V of the block's 64 keys once; a ring of (Q, dO) tiles,
  // each stage's LSE (log2 units) and delta rows and its tile's first
  // query row and whether it is the walk's last; barriers
  static constexpr int BR = br_dkdv(DQ, DV);
  static constexpr uint32_t KV_FIXED =
      hp::tile_bytes(64, DQ) + hp::tile_bytes(64, DV);
  static constexpr uint32_t KV_STAGE =
      hp::tile_bytes(BR, DQ) + hp::tile_bytes(BR, DV);
  static constexpr uint32_t KV_ROWS = 8 * BR + 8;  // LSE, delta, position
  static constexpr int KV_STAGES =
      ring_stages(KV_FIXED, KV_STAGE + KV_ROWS, BLOCKS);
  static constexpr uint32_t KV_SMEM =
      ring_smem(KV_FIXED, KV_STAGE + KV_ROWS, KV_STAGES);
  static constexpr uint32_t KV_K = 0;
  static constexpr uint32_t KV_V = hp::tile_bytes(64, DQ);
  static constexpr uint32_t KV_Q = KV_FIXED;  // stage s at + s KV_STAGE
  static constexpr uint32_t KV_LSE = KV_Q + KV_STAGES * KV_STAGE;
  static constexpr uint32_t KV_DELTA = KV_LSE + KV_STAGES * BR * 4;
  static constexpr uint32_t KV_POS = KV_DELTA + KV_STAGES * BR * 4;
  static constexpr uint32_t KV_BAR = KV_POS + KV_STAGES * 8;
  // dq: Q and dO of the block's 64 rows once; a ring of (K, V) tiles
  static constexpr int BC = 64;  // keys per tile of the walk
  static constexpr uint32_t Q_FIXED =
      hp::tile_bytes(64, DQ) + hp::tile_bytes(64, DV);
  static constexpr uint32_t Q_STAGE =
      hp::tile_bytes(BC, DQ) + hp::tile_bytes(BC, DV);
  static constexpr int Q_STAGES = ring_stages(Q_FIXED, Q_STAGE, BLOCKS);
  static constexpr uint32_t Q_SMEM = ring_smem(Q_FIXED, Q_STAGE, Q_STAGES);
  static constexpr uint32_t Q_Q = 0;
  static constexpr uint32_t Q_DO = hp::tile_bytes(64, DQ);
  static constexpr uint32_t Q_K = Q_FIXED;  // stage s at + s Q_STAGE
  static constexpr uint32_t Q_BAR = Q_K + Q_STAGES * Q_STAGE;
  static_assert(KV_SMEM * BLOCKS <= SMEM_LIMIT &&
                    Q_SMEM * BLOCKS <= SMEM_LIMIT,
                "shared memory");
};

// The 1024-aligned base of the dynamic shared memory (the launch asks
// for 1024 bytes of slack).
__device__ __forceinline__ uint32_t smem_base(unsigned char*& generic) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  generic = smem_raw + (base - raw);
  return base;
}

// K-major operand: k16 step ``ks`` of a tile of ``rows`` rows in slabs
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int ks) {
  return hp::smem_desc(tile + (ks / 4) * rows * hp::SLAB_ROW + (ks % 4) * 32,
                       16, 1024);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of a tile of ``rows`` rows,
// every slab of its columns
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return hp::smem_desc(tile + kk * 16 * hp::SLAB_ROW, rows * hp::SLAB_ROW,
                       1024);
}

// The k16 step ``kk`` of a 64 x N accumulator as the bf16 A operand of the
// next product (the accumulator's 8-column blocks 2 kk and 2 kk + 1)
template <int R>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[R],
                                     int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// P = 2^(S scale2 - lse2) and dS = P (dP - delta) in place over a thread's
// accumulator elements.  Elements 4 j .. 4 j + 3 lie on two rows and two
// columns; ``lse2(j)`` and ``delta(j)`` give the pair of values (log2
// units for the LSE) that they take, paired by column parity (the dkdv
// layout, queries along columns) or by row (dq).  ``visible(i)`` says
// whether element i's (query, key) pair is unmasked.  MASKED false is for
// a tile whose pairs are all visible (every row of it then has a finite
// LSE): one exponential, no test, per element
template <bool MASKED, bool BY_COLUMN, int R, typename L, typename D,
          typename V>
__device__ __forceinline__ void p_and_ds(float (&s)[R], float (&dp)[R],
                                         float scale2, L lse2, D delta,
                                         V visible) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float2 lj = lse2(j), dj = delta(j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const bool second = BY_COLUMN ? (e & 1) : (e >> 1);
      const float l = second ? lj.y : lj.x;
      const bool ok = !MASKED || (l != -INFINITY && visible(i));
      const float p = ok ? exp2_approx(fmaf(s[i], scale2, -l)) : 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - (second ? dj.y : dj.x));
    }
  }
}

// this thread's rows of a 64 x N accumulator, times ``mul``, to rows
// ``row_index(r)`` of a [*, N] bf16 tensor where r < n_valid
template <int N, typename RowFn>
__device__ __forceinline__ void store_acc(const float (&acc)[N / 2], bf16* dst,
                                          int n_valid, float mul,
                                          RowFn row_index) {
  const int t = threadIdx.x % WG, lane = t & 31;
  const int row0 = (t >> 5) * 16 + (lane >> 2), col0 = 2 * (lane & 3);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    if (r < n_valid) {
      bf16* p = dst + row_index(r) * N + col0;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            pack_bf16(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
    }
  }
}

// dK and dV of one 64-key tile of one kv head: the block walks every (head
// of the group, Br-row query tile) that sees one of its keys.  The
// producer warp streams Q, dO, LSE, delta and each tile's position through
// the ring; the consumer warpgroup forms S^T = K.Q^T and dP^T = V.dO^T (SS
// wgmma), P^T and dS^T in its accumulators, and feeds them back as the
// register A of dV += P^T.dO and dK += dS^T.Q (RS wgmma, Q and dO read
// MN-major from the same tiles).  The two products of each pair are
// issued alternately, so that each accumulation chain's latency hides
// behind the other's.
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, Plan<DQ, DV>::BLOCKS)
bwd_dkdv_wg(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v,
            const __grid_constant__ CUtensorMap map_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, BwdArgs a) {
  using P = Plan<DQ, DV>;
  constexpr int BR = P::BR, STAGES = P::KV_STAGES;
  unsigned char* sm;
  const uint32_t base = smem_base(sm);
  const uint32_t full = base + P::KV_BAR;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t kv_bar = empty + 8 * STAGES;

  // grid (Hkv, B, key tiles): every group's first key tile, which the
  // most query tiles see under a causal mask, is launched first.  Each
  // role works out the walk itself, so that no value lives across the
  // split into producer and consumer (it would spill there)
  const int k0 = blockIdx.z * 64;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  auto walk = [&](int& i_begin, int& qtiles) {
    int i_end;
    query_rows(a, k0, min(64, a.skv - k0), i_begin, i_end);
    qtiles = i_end > i_begin ? (i_end - i_begin + BR - 1) / BR : 0;
    return qtiles * (a.h / a.hkv);  // steps: (head of the group, tile)
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 32);   // the producer warp
      hp::mbar_init(empty + 8 * s, 4);   // the consumer's warps
    }
    hp::mbar_init(kv_bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= WG) {
    // ---- producer warp; lane 0 issues the copies ----
    float* lse_s = reinterpret_cast<float*>(sm + P::KV_LSE);      // [S][BR]
    float* delta_s = reinterpret_cast<float*>(sm + P::KV_DELTA);  // [S][BR]
    int* pos_s = reinterpret_cast<int*>(sm + P::KV_POS);          // [S][2]
    int i_begin, qtiles;
    const int n_iter = walk(i_begin, qtiles);
    const int rep = a.h / a.hkv;
    if (lane == 0) {
      hp::mbar_arrive_tx(kv_bar, P::KV_FIXED);
#pragma unroll 1
      for (int s = 0; s < hp::slabs(DQ); ++s)
        hp::tma_load_4d(base + P::KV_K + s * 64 * hp::SLAB_ROW, &map_k,
                        s * hp::SLAB, g, k0, b, kv_bar);
#pragma unroll 1
      for (int s = 0; s < hp::slabs(DV); ++s)
        hp::tma_load_4d(base + P::KV_V + s * 64 * hp::SLAB_ROW, &map_v,
                        s * hp::SLAB, g, k0, b, kv_bar);
    }
#pragma unroll 1
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      hp::mbar_wait(empty + 8 * st, ((it / STAGES) & 1) ^ 1);
      const int hh = g * rep + it / qtiles;
      const int i0 = i_begin + (it % qtiles) * BR;
      const float* lrow = lse + ((size_t)b * a.h + hh) * a.sq;
      const float* drow = delta + ((size_t)b * a.h + hh) * a.sq;
#pragma unroll
      for (int r0 = 0; r0 < BR; r0 += 32) {
        const int r = r0 + lane;
        if (r < BR) {
          const bool ok = i0 + r < a.sq;
          lse_s[st * BR + r] = ok ? lrow[i0 + r] * LOG2E : -INFINITY;
          delta_s[st * BR + r] = ok ? drow[i0 + r] : 0.f;
        }
      }
      if (lane == 0) {
        const uint32_t q_dst = base + P::KV_Q + st * P::KV_STAGE;
        const uint32_t g_dst = q_dst + hp::tile_bytes(BR, DQ);
        pos_s[2 * st] = i0;
        pos_s[2 * st + 1] = it + 1 == n_iter;
        hp::mbar_arrive_tx(full + 8 * st, P::KV_STAGE);
#pragma unroll 1
        for (int s = 0; s < hp::slabs(DQ); ++s)
          hp::tma_load_4d(q_dst + s * BR * hp::SLAB_ROW, &map_q,
                          s * hp::SLAB, hh, i0, b, full + 8 * st);
#pragma unroll 1
        for (int s = 0; s < hp::slabs(DV); ++s)
          hp::tma_load_4d(g_dst + s * BR * hp::SLAB_ROW, &map_do,
                          s * hp::SLAB, hh, i0, b, full + 8 * st);
      } else {
        hp::mbar_arrive(full + 8 * st);  // after this lane's LSE rows
      }
    }
    return;
  }

  // ---- consumer warpgroup: keys [k0, k0 + 64); each stage carries its
  // tile's first query row and whether it is the last, so that the walk's
  // bounds take no registers here ----
  const int warp = threadIdx.x >> 5, qr = lane >> 2, qc = lane & 3;
  const int n_keys = min(64, a.skv - k0);
  const float scale2 = a.scale * LOG2E;
  const uint32_t k_tile = base + P::KV_K, v_tile = base + P::KV_V;
  auto release = [&](int stage) {  // every read of the stage is done
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
  };

  float dk_acc[DQ / 2], dv_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DQ / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
  float s[BR / 2], dp[BR / 2];  // S^T and dP^T, then P^T and dS^T
  hp::mbar_wait(kv_bar, 0);

  int i_begin, qtiles;
  const bool any = walk(i_begin, qtiles) > 0;
  for (int it = 0; any; ++it) {
    const int st = it % STAGES;
    hp::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    const int2 pos = hp::lds_s32x2(base + P::KV_POS + 8 * st);
    const int i0 = pos.x;
    const uint32_t q_tile = base + P::KV_Q + st * P::KV_STAGE;
    const uint32_t g_tile = q_tile + hp::tile_bytes(BR, DQ);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < (DQ > DV ? DQ : DV) / 16; ++ks) {
      if (ks < DQ / 16)  // S^T = K . Q^T
        hp::wgmma_ss<BR>(s, desc_k(k_tile, 64, ks), desc_k(q_tile, BR, ks),
                         ks > 0);
      if (ks < DV / 16)  // dP^T = V . dO^T
        hp::wgmma_ss<BR>(dp, desc_k(v_tile, 64, ks), desc_k(g_tile, BR, ks),
                         ks > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    hp::fence_regs(dp);

    // a tile needs element masks only where it crosses the causal
    // diagonal, the window's edge, or a ragged end; elsewhere every row
    // sees every key (and so has a finite LSE).  Element i of S^T: key
    // 16 warp + qr + 8 (i / 2 % 2), query 8 (i / 4) + 2 qc + i % 2
    const int qlo = a.q_offset + i0;
    const int n_rows = a.sq - i0;
    const bool whole = n_rows >= BR && n_keys >= 64 &&
                       (!a.causal || k0 + 63 <= qlo) &&
                       (a.window <= 0 || k0 > qlo + BR - 1 - a.window);
    const uint32_t lb = base + P::KV_LSE + st * BR * 4;
    const uint32_t db = base + P::KV_DELTA + st * BR * 4;
    auto col = [&](int i) { return 8 * (i >> 2) + 2 * qc + (i & 1); };
    auto lse2 = [&](int j) { return hp::lds_f32x2(lb + 4 * col(4 * j)); };
    auto dl = [&](int j) { return hp::lds_f32x2(db + 4 * col(4 * j)); };
    auto visible = [&](int i) {
      const int kj = 16 * warp + qr + 8 * ((i >> 1) & 1);
      return col(i) < n_rows && kj < n_keys &&
             key_visible(a, qlo + col(i), k0 + kj);
    };
    if (whole)
      p_and_ds<false, true>(s, dp, scale2, lse2, dl, visible);
    else
      p_and_ds<true, true>(s, dp, scale2, lse2, dl, visible);
    uint32_t pa[BR / 16][4], da[BR / 16][4];
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      to_a(pa[kk], s, kk);
      to_a(da[kk], dp, kk);
    }
    hp::fence_regs(dv_acc);
    hp::fence_regs(dk_acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      // dV += P^T . dO and dK += dS^T . Q
      hp::wgmma_rs<DV>(dv_acc, pa[kk], desc_mn(g_tile, BR, kk));
      hp::wgmma_rs<DQ>(dk_acc, da[kk], desc_mn(q_tile, BR, kk));
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv_acc);
    hp::fence_regs(dk_acc);
    release(st);
    if (pos.y) break;  // the walk's last tile
  }

  auto key_row = [&](int r) { return row_of(b, a.skv, k0 + r, a.hkv, g); };
  store_acc<DQ>(dk_acc, dk, n_keys, a.scale, key_row);
  store_acc<DV>(dv_acc, dv, n_keys, 1.f, key_row);
}

// dQ of one 64-row query tile of one head, and the rows' delta =
// rowsum(dO o O), which the dkdv launch that follows reads.  The producer
// streams the visible K and V tiles through the ring.  S = Q.K^T and dP =
// dO.V^T (SS wgmma, Q and dO staged once), P and dS in the accumulators,
// dS the register A of dQ += dS.K (RS, K read MN-major from the tile that
// fed S).
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, Plan<DQ, DV>::BLOCKS)
bwd_dq_wg(const __grid_constant__ CUtensorMap map_q,
          const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v,
          const __grid_constant__ CUtensorMap map_do,
          const bf16* __restrict__ out, const bf16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta,
          bf16* __restrict__ dq, BwdArgs a) {
  using P = Plan<DQ, DV>;
  constexpr int BC = P::BC, STAGES = P::Q_STAGES;
  unsigned char* sm;
  const uint32_t base = smem_base(sm);
  const uint32_t full = base + P::Q_BAR;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qo_bar = empty + 8 * STAGES;

  // grid (H, B, query tiles), the last query tiles (the longest causal
  // walks) launched first; the heads of one kv group are neighbours and
  // share each K/V tile through L2
  const int i0 = (gridDim.z - 1 - blockIdx.z) * 64;
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rows = min(64, a.sq - i0);
  auto walk = [&](int& kv_begin) {  // each role's own, as in dkdv
    int kv_end;
    key_cols(a, i0, n_rows, kv_begin, kv_end);
    return kv_end > kv_begin ? (kv_end - kv_begin + BC - 1) / BC : 0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, 4);
    }
    hp::mbar_init(qo_bar, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= WG) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x != WG) return;
    int kv_begin;
    const int n_tiles = walk(kv_begin);
    const int g = hq / (a.h / a.hkv);
    hp::mbar_arrive_tx(qo_bar, P::Q_FIXED);
#pragma unroll 1
    for (int s = 0; s < hp::slabs(DQ); ++s)
      hp::tma_load_4d(base + P::Q_Q + s * 64 * hp::SLAB_ROW, &map_q,
                      s * hp::SLAB, hq, i0, b, qo_bar);
#pragma unroll 1
    for (int s = 0; s < hp::slabs(DV); ++s)
      hp::tma_load_4d(base + P::Q_DO + s * 64 * hp::SLAB_ROW, &map_do,
                      s * hp::SLAB, hq, i0, b, qo_bar);
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      hp::mbar_wait(empty + 8 * st, ((t / STAGES) & 1) ^ 1);
      const int kt = kv_begin + t * BC;
      const uint32_t k_dst = base + P::Q_K + st * P::Q_STAGE;
      const uint32_t v_dst = k_dst + hp::tile_bytes(BC, DQ);
      hp::mbar_arrive_tx(full + 8 * st, P::Q_STAGE);
#pragma unroll 1
      for (int s = 0; s < hp::slabs(DQ); ++s)
        hp::tma_load_4d(k_dst + s * BC * hp::SLAB_ROW, &map_k, s * hp::SLAB,
                        g, kt, b, full + 8 * st);
#pragma unroll 1
      for (int s = 0; s < hp::slabs(DV); ++s)
        hp::tma_load_4d(v_dst + s * BC * hp::SLAB_ROW, &map_v, s * hp::SLAB,
                        g, kt, b, full + 8 * st);
    }
    return;
  }

  // ---- consumer warpgroup: query rows [i0, i0 + 64) ----
  int kv_begin;
  const int n_tiles = walk(kv_begin);
  const int warp = threadIdx.x >> 5, qr = lane >> 2, qc = lane & 3;
  const float scale2 = a.scale * LOG2E;
  const uint32_t q_tile = base + P::Q_Q, g_tile = base + P::Q_DO;
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
  };

  // this thread's rows, 16 warp + qr and 8 below it: their LSE, and
  // delta = rowsum(dO o O), each of the row's four threads summing a
  // quarter of its columns
  float l2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * warp + qr + 8 * hr;
    float sum = 0.f;
    if (r < n_rows) {
      const size_t at = row_of(b, a.sq, i0 + r, a.h, hq) * DV + qc * (DV / 4);
      const uint4* o4 = reinterpret_cast<const uint4*>(out + at);
      const uint4* g4 = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int c = 0; c < DV / 32; ++c) {
        const uint4 ov = o4[c], gv = g4[c];
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(op[e]);
          const float2 gf = __bfloat1622float2(gp[e]);
          sum = fmaf(of.x, gf.x, sum);
          sum = fmaf(of.y, gf.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const size_t at = ((size_t)b * a.h + hq) * a.sq + i0 + r;
    l2[hr] = r < n_rows ? lse[at] * LOG2E : -INFINITY;
    dl[hr] = sum;
    if (r < n_rows && qc == 0) delta[at] = sum;
  }
  float dq_acc[DQ / 2];
#pragma unroll
  for (int i = 0; i < DQ / 2; ++i) dq_acc[i] = 0.f;
  float s[BC / 2], dp[BC / 2];  // S and dP, then P and dS
  hp::mbar_wait(qo_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    hp::mbar_wait(full + 8 * st, (t / STAGES) & 1);
    const int kt = kv_begin + t * BC;
    const uint32_t k_tile = base + P::Q_K + st * P::Q_STAGE;
    const uint32_t v_tile = k_tile + hp::tile_bytes(BC, DQ);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < (DQ > DV ? DQ : DV) / 16; ++ks) {
      if (ks < DQ / 16)  // S = Q . K^T
        hp::wgmma_ss<BC>(s, desc_k(q_tile, 64, ks), desc_k(k_tile, BC, ks),
                         ks > 0);
      if (ks < DV / 16)  // dP = dO . V^T
        hp::wgmma_ss<BC>(dp, desc_k(g_tile, 64, ks), desc_k(v_tile, BC, ks),
                         ks > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    hp::fence_regs(dp);

    // element i of S: row 16 warp + qr + 8 (i / 2 % 2), key
    // 8 (i / 4) + 2 qc + i % 2
    const int qlo = a.q_offset + i0;
    const bool whole = n_rows >= 64 && kt + BC <= a.skv &&
                       (!a.causal || kt + BC - 1 <= qlo) &&
                       (a.window <= 0 || kt > qlo + 63 - a.window);
    auto lse2 = [&](int) { return make_float2(l2[0], l2[1]); };
    auto delta_of = [&](int) { return make_float2(dl[0], dl[1]); };
    auto visible = [&](int i) {
      const int r = 16 * warp + qr + 8 * ((i >> 1) & 1);
      const int kj = 8 * (i >> 2) + 2 * qc + (i & 1);
      return r < n_rows && kt + kj < a.skv &&
             key_visible(a, qlo + r, kt + kj);
    };
    if (whole)
      p_and_ds<false, false>(s, dp, scale2, lse2, delta_of, visible);
    else
      p_and_ds<true, false>(s, dp, scale2, lse2, delta_of, visible);
    uint32_t da[BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) to_a(da[kk], dp, kk);
    hp::fence_regs(dq_acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)  // dQ += dS . K
      hp::wgmma_rs<DQ>(dq_acc, da[kk], desc_mn(k_tile, BC, kk));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dq_acc);
    release(st);
  }

  auto q_row = [&](int r) { return row_of(b, a.sq, i0 + r, a.h, hq); };
  store_acc<DQ>(dq_acc, dq, n_rows, a.scale, q_row);
}

// ---- host: tensor maps and the launch -------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, a driver call, through the runtime's entry-point
// query (the library links the static runtime, not libcuda); null if the
// driver lacks it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a [B, S, heads, D] bf16 tensor whose box is one head's
// ``rows`` rows by 64 columns (one slab), 128-byte swizzled; rows and
// columns past the tensor's ends read as zeros.  Returns a cudaError_t.
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
             int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)hopper::SLAB, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wg_body

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

// The tensor-core instances, each handed to ``fn`` as Inst<Dq, Dv>{};
// another (Dq, Dv) is an error, never a silent switch to the other body.
template <int DQ_, int DV_>
struct Inst {
  static constexpr int DQ = DQ_, DV = DV_;
};

template <typename Fn>
int dispatch_wg(int dq, int dv, Fn&& fn) {
  if (dq == 64 && dv == 64) return fn(Inst<64, 64>{});
  if (dq == 128 && dv == 128) return fn(Inst<128, 128>{});
  if (dq == 160 && dv == 160) return fn(Inst<160, 160>{});
  if (dq == 192 && dv == 192) return fn(Inst<192, 192>{});
  if (dq == 192 && dv == 128) return fn(Inst<192, 128>{});
  return (int)cudaErrorInvalidValue;
}

template <int DQ, int DV>
int launch_wg(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int b, const BwdArgs& a, cudaStream_t st) {
  namespace wb = wg_body;
  using P = wb::Plan<DQ, DV>;
  using bf16 = __nv_bfloat16;
  if (b == 0 || a.sq == 0 || a.skv == 0) {
    // nothing to walk (and no tensor map of an empty tensor): every
    // gradient that has elements is zero
    cudaMemsetAsync(dq, 0, (size_t)b * a.sq * a.h * DQ * sizeof(bf16), st);
    cudaMemsetAsync(dk, 0, (size_t)b * a.skv * a.hkv * DQ * sizeof(bf16), st);
    cudaMemsetAsync(dv, 0, (size_t)b * a.skv * a.hkv * DV * sizeof(bf16), st);
    return (int)cudaGetLastError();
  }
  // dkdv walks Q / dO in Br-row boxes over K / V staged in 64-row boxes;
  // dq walks K / V in BC-row boxes over Q / dO staged in 64-row boxes
  CUtensorMap q_br, do_br, k_bk, v_bk, q_64, do_64, k_bc, v_bc;
  int err;
  if ((err = wb::make_map(&q_br, q, b, a.sq, a.h, DQ, P::BR)) ||
      (err = wb::make_map(&do_br, dout, b, a.sq, a.h, DV, P::BR)) ||
      (err = wb::make_map(&k_bk, k, b, a.skv, a.hkv, DQ, 64)) ||
      (err = wb::make_map(&v_bk, v, b, a.skv, a.hkv, DV, 64)) ||
      (err = wb::make_map(&q_64, q, b, a.sq, a.h, DQ, 64)) ||
      (err = wb::make_map(&do_64, dout, b, a.sq, a.h, DV, 64)) ||
      (err = wb::make_map(&k_bc, k, b, a.skv, a.hkv, DQ, P::BC)) ||
      (err = wb::make_map(&v_bc, v, b, a.skv, a.hkv, DV, P::BC)))
    return err;
  cudaError_t e = allow_smem(wb::bwd_dkdv_wg<DQ, DV>, P::KV_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(wb::bwd_dq_wg<DQ, DV>, P::Q_SMEM);
  if (e != cudaSuccess) return (int)e;
  // dq first: its prologue writes the delta rows that dkdv reads
  const dim3 q_grid(a.h, b, (a.sq + 63) / 64);
  wb::bwd_dq_wg<DQ, DV><<<q_grid, wb::THREADS, P::Q_SMEM, st>>>(
      q_64, k_bc, v_bc, do_64, static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 kv_grid(a.hkv, b, (a.skv + 63) / 64);
  wb::bwd_dkdv_wg<DQ, DV><<<kv_grid, wb::THREADS, P::KV_SMEM, st>>>(
      q_br, k_bk, v_bk, do_br, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a);
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
  if (tensor_cores) {
    if (!std::is_same<T, __nv_bfloat16>::value)
      return (int)cudaErrorInvalidValue;
    return dispatch_wg(d, dvd, [&](auto inst) {
      using I = decltype(inst);
      return launch_wg<I::DQ, I::DV>(q, k, v, out, dout, lse_f, delta_f, dq,
                                     dk, dv, b, a, st);
    });
  }
  const int err = launch_delta<T>(out, dout, delta_f, b, sq, h, dvd, st);
  if (err != 0) return err;
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
// body (1: bwd_wg, bf16 only).  Each returns cudaGetLastError() after its
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

// The tiling of the tensor-core body's (dq, dv) instance into out[0..7):
// the dkdv query tile Br, the dq key tile, the blocks that share an SM,
// the two rings' stages and the two kernels' dynamic shared memory in
// bytes.  Returns cudaErrorInvalidValue for a pair without an instance.
extern "C" int flash_prefill_bwd_plan(int dq, int dv, void* out) {
  int* o = static_cast<int*>(out);
  return repro_torch::dispatch_wg(dq, dv, [&](auto inst) {
    using I = decltype(inst);
    using P = repro_torch::wg_body::Plan<I::DQ, I::DV>;
    const int v[7] = {P::BR,        P::BC,       P::BLOCKS,
                      P::KV_STAGES, P::Q_STAGES, (int)P::KV_SMEM,
                      (int)P::Q_SMEM};
    for (int i = 0; i < 7; ++i) o[i] = v[i];
    return 0;
  });
}
