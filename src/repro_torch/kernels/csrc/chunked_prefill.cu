// Prefill attention for Hopper (sm_90a): a tile of 64 query rows of one
// head walks its visible keys in 64-token tiles with an online softmax.
// One source, two layouts, each with two entry points:
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
// keys per query) attention does ~Skv/2 FLOPs per byte of Q, K and V, so
// it sits near the ridge of the bf16 tensor-core peak (989 TFLOP/s) and
// the memory rate (3.35 TB/s); the causal B4 x S512 prefill is 4.3 GFLOP,
// 0.064 ms on the 67 TFLOP/s f32 FMA pipe alone.  So bf16 runs on tensor
// cores, in two bodies chosen by the wrapper from (dtype, Dq, Dv) alone:
//
//   * prefill_tc, bf16 with (Dq, Dv) in {(64, 64), (128, 128), (160, 160),
//     (192, 192)} in both layouts, and the MLA shape (192, 128) dense only
//     (templated on DQ and DV: Q and K tiles are DQ wide, V tiles and the
//     O accumulator DV wide): the FlashAttention-2 arrangement on
//     mma.sync.m16n8k16.  4 warps take 64 query rows, 16 each; the Q tile
//     is staged once in shared memory.  At Dq <= 128 its A fragments stay
//     in registers (ldmatrix) for the whole key loop; at Dq 160 and 192
//     the f32 O accumulator alone takes 80 and 96 registers a thread at
//     Dv = Dq, so the Q fragments are read again from shared memory at
//     each k-step of every tile (one ldmatrix per 8 mma) instead of
//     holding 40-48 more; the MLA shape (Dq 192, Dv 128) does the same,
//     and with its V tiles 128 wide its tiles take 111,616 B of shared
//     memory against 128,000 B at (192, 192).  S = Q.K^T accumulates in
//     f32 registers; the online softmax runs there too, the row max and
//     sum reduced over the 4 lanes of a quad.  P is rounded to bf16 in
//     the registers that hold it (as the plain version rounds its
//     probabilities to v's dtype before the PV product) and is
//     the A operand of P.V, with V read by ldmatrix.trans; O accumulates
//     in f32 registers.  K and V tiles are double-buffered in shared
//     memory by 16-byte cp.async, so tile j+1 loads while tile j computes;
//     each shared row is padded by 16 bytes, so the 8 rows an ldmatrix
//     phase reads fall in 8 different bank groups.  In the paged layout
//     each thread resolves the pool row of the keys it copies through the
//     block table once per tile.  Only tiles that cross the diagonal, the
//     window's edge, the length or the ragged tail mask element by
//     element; keys past the end are zero-filled by the copy.  The grid
//     is (H, query tiles, B): the rep query heads of one kv head are
//     neighbours in launch order and share each K/V tile through L2, and
//     each sequence's longest causal tiles are launched first.  The
//     softmax weights are exp2(s * scale * log2 e - max), one FMA and one
//     ex2.approx each.
//   * prefill_fma, everything else (f32, whose limit against the plain
//     version is atol 2e-5 where tensor cores would round through TF32;
//     bf16 with other head dims such as Dq 96 / Dv 64):
//     f32 FMAs from shared memory, each K/V tile loaded once and reused
//     by the block's 64 query rows.
//
// Both bodies read only the keys a tile can see: the key loop runs from
// kv_begin (the window's first key) to kv_end (the causal limit of the
// tile's last row, or the length), so masked tiles are never read.  A
// score at or below NEG_INF / 2 weighs exactly 0, the denominator is
// clamped at 1e-30, and offsets and lengths are runtime values, so one
// build serves every chunk.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr float LOG2E = 1.4426950408889634f;

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
  float* lse;               // [B, H, Sq] natural-log LSE, or null
};

// The natural-log logsumexp of a row's scaled, masked scores from its
// running max ``m`` (in the units of the softmax's exponent, natural or
// log2) and sum ``l``: -inf for a row with no visible key (l == 0).
__device__ __forceinline__ float row_lse(float m, float l, float to_nat) {
  return l > 0.f ? m * to_nat + logf(l) : -INFINITY;
}

// The keys a query tile [q0, q0 + n_rows) of sequence b can see:
// [kv_begin, kv_end), and the absolute position of its first row.
struct KeyRange {
  int off, kv_begin, kv_end;
};

template <bool PAGED>
__device__ __forceinline__ KeyRange key_range(const PagedArgs& pa,
                                              const DenseArgs& da, int b,
                                              int q0, int n_rows) {
  KeyRange kr{0, 0, 0};
  if (PAGED) {
    kr.off = pa.q_offsets[b];
    const int len = min(pa.lengths[b], pa.pages_per_seq * pa.page);
    kr.kv_end = min(len, kr.off + q0 + n_rows);
  } else {
    kr.off = da.q_offset;
    kr.kv_end = da.causal ? min(da.skv, kr.off + q0 + n_rows) : da.skv;
    if (da.window > 0) kr.kv_begin = max(0, kr.off + q0 - da.window + 1);
  }
  return kr;
}

// Row (in units of head_dim) of key ``kpos`` of kv head g in K or V.
template <bool PAGED>
__device__ __forceinline__ size_t key_row(const PagedArgs& pa,
                                          const DenseArgs& da, int b, int g,
                                          int hkv, int kpos) {
  if (PAGED) {
    const int pid =
        pa.block_tables[(size_t)b * pa.pages_per_seq + kpos / pa.page];
    return ((size_t)pid * pa.page + kpos % pa.page) * hkv + g;
  }
  return ((size_t)b * da.skv + kpos) * hkv + g;
}

// ---------------------------------------------------------------------------
// prefill_tc: bf16 on tensor cores
// ---------------------------------------------------------------------------

namespace tc_body {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block, 16 per warp
constexpr int BK = 64;          // keys per tile
constexpr int PAD = 8;          // bf16 elements (16 bytes) after each row

constexpr size_t smem_bytes(int dq, int dv) {
  // Q tile and two K tiles of Dq, then two V tiles of Dv
  return sizeof(__nv_bfloat16) *
         ((size_t)(BQ + 2 * BK) * (dq + PAD) + (size_t)2 * BK * (dv + PAD));
}

}  // namespace tc_body

template <int DQ, int DV, bool PAGED>
__global__ void __launch_bounds__(tc_body::THREADS)
prefill_tc(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ out, PagedArgs pa, DenseArgs da,
           int sq, int h, int hkv, float scale) {
  using namespace tc_body;
  constexpr int LD = DQ + PAD;        // shared row stride of Q and K
  constexpr int LDV = DV + PAD;       // shared row stride of V
  constexpr int CPR = DQ / 8;         // 16-byte chunks per Q or K row
  constexpr int KSTEPS = DQ / 16;     // k-steps of Q.K^T
  constexpr int NT = BK / 8;          // 8-key n-tiles of S
  constexpr int OT = DV / 8;          // 8-column n-tiles of O
  constexpr bool Q_IN_REGS = DQ <= 128;
  static_assert(DQ % 16 == 0 && DV % 16 == 0 && DV <= DQ &&
                    (BQ * CPR) % THREADS == 0 && (BK * CPR) % THREADS == 0,
                "tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* ks = qs + BQ * LD;      // [2][BK][LD]
  __nv_bfloat16* vs = ks + 2 * BK * LD;  // [2][BK][LDV]

  const int hq = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int b = blockIdx.z;
  const int g = hq / (h / hkv);
  const int n_rows = min(BQ, sq - q0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qr = lane >> 2;  // this lane's row within an 8-row group
  const int qc = lane & 3;   // its column pair within an 8-column tile

  const KeyRange kr = key_range<PAGED>(pa, da, b, q0, n_rows);
  const bool causal = PAGED || da.causal;
  const int window = PAGED ? 0 : da.window;
  const int n_tiles =
      kr.kv_end > kr.kv_begin ? (kr.kv_end - kr.kv_begin + BK - 1) / BK : 0;

  // copy roles: 16-byte chunk i of a tile is row i / CPR, column
  // (i % CPR) * 8; thread tid copies chunks tid, tid + THREADS, ...
  for (int i = tid; i < BQ * CPR; i += THREADS) {
    const int r = i / CPR, cc = (i % CPR) * 8;
    const bool ok = r < n_rows;
    cp_async16(qs + r * LD + cc,
               q + (((size_t)b * sq + q0 + (ok ? r : 0)) * h + hq) * DQ + cc,
               ok);
  }
  // a chunk of a K row and, where Dv reaches its column, of the V row of
  // the same key (one key_row for both)
  auto load_kv = [&](int k0, int buf) {
#pragma unroll
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int r = i / CPR, cc = (i % CPR) * 8;
      const int kpos = k0 + r;
      const bool ok = kpos < kr.kv_end;
      const size_t row = ok ? key_row<PAGED>(pa, da, b, g, hkv, kpos) : 0;
      cp_async16(ks + (buf * BK + r) * LD + cc, k + row * DQ + cc, ok);
      if (DV == DQ || cc < DV)
        cp_async16(vs + (buf * BK + r) * LDV + cc, v + row * DV + cc, ok);
    }
  };
  if (n_tiles > 0) load_kv(kr.kv_begin, 0);
  cp_async_commit();  // group 0: Q and the first K/V tile

  const float scale2 = scale * LOG2E;  // scores in log2 units
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows qr and qr + 8, scaled
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  const int qpos0 = kr.off + q0 + warp * 16 + qr;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kr.kv_begin + t * BK;
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(k0 + BK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    const __nv_bfloat16* qrow = qs + (warp * 16 + (lane & 15)) * LD +
                                (lane >> 4) * 8;
    if (Q_IN_REGS && t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
    }

    // S = Q . K^T over the tile's 64 keys
    const __nv_bfloat16* kb = ks + buf * BK * LD;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t(&a)[4] = qf[Q_IN_REGS ? kk : 0];
      if (!Q_IN_REGS) ldmatrix_x4(a, qrow + kk * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * np], a, bf[0], bf[1]);
        mma_bf16_16816(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // mask only where the tile crosses an edge
    const bool edge =
        k0 + BK > kr.kv_end || (causal && k0 + BK - 1 > kr.off + q0) ||
        (window > 0 && k0 <= kr.off + q0 + BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + qc * 2 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          const bool ok = kpos < kr.kv_end && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) s[n][e] = NEG_INF;
        }
    }

    // online softmax in registers; a row lives on the 4 lanes of a quad.
    // Scores stay unscaled: the max is taken on them and the weight is
    // exp2(s * scale2 - max * scale2), one FMA and one ex2 per score.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a fully masked row keeps m at NEG_INF
      const float m_new =
          fmaxf(m[hr], mx <= NEG_INF * 0.5f ? NEG_INF : mx * scale2);
      const float corr = exp2_approx(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float x = s[n][e];
          const float p =
              x <= NEG_INF * 0.5f ? 0.f : exp2_approx(fmaf(x, scale2, -m_new));
          s[n][e] = p;
          sum += p;
        }
      }
      l[hr] = l[hr] * corr + sum;
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        o[n][2 * hr] *= corr;
        o[n][2 * hr + 1] *= corr;
      }
    }

    // O += P . V, P rounded to bf16 where it lies
    const __nv_bfloat16* vb = vs + buf * BK * LDV;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                    dp * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * dp], a, bf[0], bf[1]);
        mma_bf16_16816(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int r = warp * 16 + qr + hr * 8;
    // m is in log2 units (the scores times scale * log2 e): ln 2 brings
    // the LSE back to natural log, the unit the backward reads
    if (!PAGED && da.lse != nullptr && qc == 0 && r < n_rows)
      da.lse[((size_t)b * h + hq) * sq + q0 + r] =
          row_lse(m[hr], sum, 0.6931471805599453f);
    if (r < n_rows) {
      __nv_bfloat16* dst = out + (((size_t)b * sq + q0 + r) * h + hq) * DV;
#pragma unroll
      for (int n = 0; n < OT; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8 + qc * 2) =
            pack_bf16(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// prefill_fma: f32 FMAs from shared memory (f32, other head dims)
// ---------------------------------------------------------------------------

namespace fma_body {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per tile: one per lane in the softmax

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)BQ * d + (size_t)BK * (d + 1) +
                          (size_t)BK * dv + (size_t)BQ * BK +
                          (size_t)BQ * dv + 3 * (size_t)BQ);
}

}  // namespace fma_body

template <typename T, bool PAGED>
__global__ void __launch_bounds__(fma_body::THREADS)
prefill_fma(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, PagedArgs pa,
            DenseArgs da, int sq, int h, int hkv, int d, int dv,
            float scale) {
  using namespace fma_body;
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

  const KeyRange kr = key_range<PAGED>(pa, da, b, q0, n_rows);
  const int off = kr.off, kv_end = kr.kv_end;

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

  for (int k0 = kr.kv_begin; k0 < kv_end; k0 += BK) {
    const int n_keys = min(BK, kv_end - k0);
    __syncthreads();  // previous tile's readers are done with ks/vs/s
    // one thread per key resolves its row (paged: page id from the
    // table), so the element loads below carry no dependent load
    if (tid < n_keys) rows[tid] = key_row<PAGED>(pa, da, b, g, hkv, k0 + tid);
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
        ok = ok && kpos <= qpos;
      } else {
        if (da.causal) ok = ok && kpos <= qpos;
        if (da.window > 0) ok = ok && kpos > qpos - da.window;
      }
      float acc_s = 0.f;
      if (ok) {
        const float* qr = qs + r * d;
        const float* kr_ = ks + j * dp;
        for (int c = 0; c < d; ++c) acc_s += qr[c] * kr_[c];
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
  if (!PAGED && da.lse != nullptr) {
    for (int r = tid; r < n_rows; r += THREADS)
      da.lse[((size_t)b * h + hq) * sq + q0 + r] = row_lse(m[r], l[r], 1.f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DQ, int DV, bool PAGED>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              PagedArgs pa, DenseArgs da, int nb, int sq, int h, int hkv,
              float scale, cudaStream_t st) {
  const size_t smem = tc_body::smem_bytes(DQ, DV);
  cudaError_t err = allow_smem(prefill_tc<DQ, DV, PAGED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, (sq + tc_body::BQ - 1) / tc_body::BQ, nb);
  prefill_tc<DQ, DV, PAGED><<<grid, tc_body::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      pa, da, sq, h, hkv, scale);
  return (int)cudaGetLastError();
}

// ``tensor_cores`` is the wrapper's choice of body; the tensor-core body
// exists for bf16 with (Dq, Dv) in {(64, 64), (128, 128), (160, 160),
// (192, 192)}, and (192, 128) in the dense layout, only; asking for it
// elsewhere is an error, never a silent switch to the other body.
template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, void* out,
           PagedArgs pa, DenseArgs da, int nb, int sq, int h, int hkv, int d,
           int dv, float scale, int tensor_cores, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (!std::is_same<T, __nv_bfloat16>::value)
      return (int)cudaErrorInvalidValue;
    if (d == 64 && dv == 64)
      return launch_tc<64, 64, PAGED>(q, k, v, out, pa, da, nb, sq, h, hkv,
                                      scale, st);
    if (d == 128 && dv == 128)
      return launch_tc<128, 128, PAGED>(q, k, v, out, pa, da, nb, sq, h, hkv,
                                        scale, st);
    if (d == 160 && dv == 160)
      return launch_tc<160, 160, PAGED>(q, k, v, out, pa, da, nb, sq, h, hkv,
                                        scale, st);
    if (d == 192 && dv == 192)
      return launch_tc<192, 192, PAGED>(q, k, v, out, pa, da, nb, sq, h, hkv,
                                        scale, st);
    // MLA's prefill (deepseek-v3: Dq = 128 + 64, Dv = 128); no paged
    // caller has Dq != Dv
    if constexpr (!PAGED) {
      if (d == 192 && dv == 128)
        return launch_tc<192, 128, false>(q, k, v, out, pa, da, nb, sq, h,
                                          hkv, scale, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = fma_body::smem_bytes(d, dv);
  cudaError_t err = allow_smem(prefill_fma<T, PAGED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nb, h, (sq + fma_body::BQ - 1) / fma_body::BQ);
  prefill_fma<T, PAGED><<<grid, fma_body::THREADS, smem, st>>>(
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
                 float scale, int tensor_cores, void* stream) {
  PagedArgs pa{static_cast<const int*>(lengths),
               static_cast<const int*>(q_offsets),
               static_cast<const int*>(block_tables), pages_per_seq, page};
  DenseArgs da{0, 0, 1, 0, nullptr};
  return launch<T, true>(q, k_pool, v_pool, out, pa, da, r, sq, h, hkv, d,
                         dv, scale, tensor_cores, stream);
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, void* out,
                 void* lse, int b, int sq, int skv, int h, int hkv, int d,
                 int dv, float scale, int q_offset, int causal, int window,
                 int tensor_cores, void* stream) {
  PagedArgs pa{nullptr, nullptr, nullptr, 0, 1};
  DenseArgs da{skv, q_offset, causal, window, static_cast<float*>(lse)};
  return launch<T, false>(q, k, v, out, pa, da, b, sq, h, hkv, d, dv, scale,
                          tensor_cores, stream);
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes.  ``tensor_cores`` selects the body
// (1: prefill_tc, bf16 only); each returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int chunked_prefill_paged_f32(
    const void* q, const void* k_pool, const void* v_pool,
    const void* lengths, const void* q_offsets, const void* block_tables,
    void* out, int r, int sq, int h, int hkv, int d, int dv, int page,
    int pages_per_seq, float scale, int tensor_cores, void* stream) {
  return repro_torch::launch_paged<float>(
      q, k_pool, v_pool, lengths, q_offsets, block_tables, out, r, sq, h, hkv,
      d, dv, page, pages_per_seq, scale, tensor_cores, stream);
}

extern "C" int chunked_prefill_paged_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* lengths, const void* q_offsets, const void* block_tables,
    void* out, int r, int sq, int h, int hkv, int d, int dv, int page,
    int pages_per_seq, float scale, int tensor_cores, void* stream) {
  return repro_torch::launch_paged<__nv_bfloat16>(
      q, k_pool, v_pool, lengths, q_offsets, block_tables, out, r, sq, h,
      hkv, d, dv, page, pages_per_seq, scale, tensor_cores, stream);
}

// ``lse`` is null for serving; for training it receives the [B, H, Sq]
// natural-log LSE of every query row, which the backward reads.
extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int b, int sq, int skv,
                                 int h, int hkv, int d, int dv, float scale,
                                 int q_offset, int causal, int window,
                                 int tensor_cores, void* stream) {
  return repro_torch::launch_dense<float>(q, k, v, out, lse, b, sq, skv, h,
                                          hkv, d, dv, scale, q_offset, causal,
                                          window, tensor_cores, stream);
}

extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* out, void* lse, int b,
                                  int sq, int skv, int h, int hkv, int d,
                                  int dv, float scale, int q_offset,
                                  int causal, int window, int tensor_cores,
                                  void* stream) {
  return repro_torch::launch_dense<__nv_bfloat16>(
      q, k, v, out, lse, b, sq, skv, h, hkv, d, dv, scale, q_offset, causal,
      window, tensor_cores, stream);
}
