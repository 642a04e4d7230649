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
// initial and final states), so the floor is ~3 us of HBM traffic.  The
// TPU grid (b, h, chunk) walked the chunks in order with the state in
// VMEM scratch; Hopper blocks carry nothing between them, so each block
// loops over the chunks itself and carries the state.  The state's rows p
// are independent, so the grid is (B, H, P / 32): 128 blocks for one
// request of mamba2-1.3b.  Two bodies, chosen by the wrapper from the
// dtype alone (ssd_body in kernels/ssd_scan.py):
//
//   * ssd_tc, bf16: one launch, every product on tensor cores (mma.sync
//     m16n8k16, bf16 in, f32 accumulate).  B, C and x are bf16 and exact
//     as operands; the f32 factors (dt, the decays, the carried state)
//     are not, and one bf16 rounding of them (~4e-3) would miss the
//     limits.  So each f32 operand is split into bf16 hi + lo and
//     multiplies the exact side twice (~2^-16 relative):
//       - C.B^T, a 16x16 tile at a time from C's A fragments (held in
//         registers for a row block) and B by ldmatrix; recomputed per
//         head and state tile (no f32 scratch, no second launch).
//       - M' = C.B^T * exp(seg_q - seg_t) * dt_t, masked by selection (an
//         exact 0 where t > q or past the chunk: exp(seg_q - seg_t)
//         overflows above the diagonal and inf * 0 is NaN; the decay is
//         never factored as exp(seg_q) exp(-seg_t), which overflows as seg
//         falls).  Folding dt into M' leaves x exact.  The accumulator
//         layout of a tile is the A layout of the next product, so M' is
//         split where it lies; x enters by ldmatrix.trans.  The next
//         tile's C.B^T is issued before this tile's decay and split.
//       - C . S_in^T from the state's hi/lo copy in shared memory, scaled
//         by exp(seg_q) in f32; skipped while the state is zero.
//       - the state update (x dt w)^T . B: x^T by ldmatrix.trans, scaled
//         by dt * exp(total - seg) and split in registers; B by
//         ldmatrix.trans.  The state stays in f32 registers across the
//         chunks and is written once at the end; only its bf16 hi/lo
//         copy, the operand of C . S_in^T, goes through shared memory.
//     Warps: 8 compute warps and 4 producer warps.  The producers copy
//     C, B, x and dt of chunk i + 1 into the second of two stages by
//     16-byte cp.async (rows past the chunk, columns past N or P
//     zero-filled by a source size of 0) and compute its seg, exp(seg)
//     and dt * exp(total - seg), while the compute warps work on chunk i:
//     one warp alone keeps too few copies in flight to feed the block,
//     and copies issued by the compute warps stalled their products.  The
//     two compute warps of an SM sub-partition, r and r + 4, share query
//     row blocks r and 7 - r (9 causal tiles): warp r takes row r and the
//     first 4 - r tiles of row 7 - r, whose partial y it hands to warp
//     r + 4 through shared memory and a named barrier; warp r + 4 takes
//     the rest of row 7 - r.  Shared memory at Q = N = 128: two stages of
//     80 KB, the state's hi/lo copy 17 KB, the partial y 8 KB: 185 KB,
//     one block per SM, which at B = 1 (128 blocks) fills the card once.
//     Every N lays out and multiplies the full 128 state columns (those
//     past N zero-filled), so the k-steps over N are unrolled.
//   * the FMA body, f32 (whose limit tensor cores would miss through
//     TF32): f32 FMAs from shared memory.  C.B^T once per (sequence,
//     group, chunk), over the causal triangle, in ssd_cb_kernel into an f32
//     scratch [B, G, chunks, Q, key_cols(Q)], which ssd_scan_kernel reads
//     a 32-row tile at a time and decays per head; the state [32, N + 1]
//     in shared memory.  130 KB at Q = N = 128.
//
// Any chunk from 1 to 128 tokens (not only multiples of 16: a 37-token
// prompt scans as one chunk of 37) and any state size up to 128; f32 dt,
// a, states and accumulation; y in x's type.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int MAX_Q = 128;  // chunk limit
constexpr int MAX_N = 128;  // state limit

// ---------------------------------------------------------------------------
// the FMA body: f32
// ---------------------------------------------------------------------------

namespace fma_body {

constexpr int THREADS = 256;
constexpr int PT = 32;  // state rows per block: one per lane
constexpr int QT = 32;  // query rows per score tile: 4 per warp; MAX_Q is
                        // 4 key columns per lane, MAX_N 4 state columns

__host__ __device__ inline int key_cols(int chunk) {
  return 32 * ((chunk + 31) / 32);
}

__host__ inline size_t cb_smem_floats(int chunk, int n) {
  return (size_t)chunk * (n + 1) + (size_t)QT * n;
}

__host__ inline size_t smem_floats(int chunk, int n) {
  return (size_t)chunk * (n + 1) + (size_t)QT * n +
         (size_t)QT * key_cols(chunk) + (size_t)chunk * PT +
         (size_t)PT * (n + 1) + 3 * (size_t)chunk;
}

}  // namespace fma_body

// C.B^T of one chunk of one (sequence, group): rows q0 .. q0 + 31 against
// the key columns they can see (t < q0 + 32), raw dot products in f32,
// into cb [B, G, chunks, Q, key_cols(Q)].  Grid (B * G, chunks, Q / 32).
__global__ void __launch_bounds__(fma_body::THREADS)
ssd_cb_kernel(const float* __restrict__ bm,  // [B, L, G, N]
              const float* __restrict__ cm,  // [B, L, G, N]
              float* __restrict__ cb,        // [B, G, L / Q, Q, key_cols(Q)]
              int seqlen, int g, int n, int chunk) {
  using namespace fma_body;
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
    bs[t * np + c] = bm[((tok0 + t) * g + grp) * n + c];
  }
  for (int i = tid; i < QT * n; i += THREADS) {
    const int r = i / n, c = i - (i / n) * n;
    cs[r * n + c] = q0 + r < chunk
                        ? cm[((tok0 + q0 + r) * g + grp) * n + c]
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

__global__ void __launch_bounds__(fma_body::THREADS)
ssd_scan_kernel(const float* __restrict__ x,     // [B, L, H, P]
                const float* __restrict__ dt,    // [B, L, H]
                const float* __restrict__ a,     // [H]
                const float* __restrict__ bm,    // [B, L, G, N]
                const float* __restrict__ cm,    // [B, L, G, N]
                const float* __restrict__ init,  // [B, H, P, N] or null
                const float* __restrict__ cb,    // ssd_cb_kernel's output
                float* __restrict__ y,           // [B, L, H, P]
                float* __restrict__ fin,         // [B, H, P, N]
                int seqlen, int h, int p, int g, int n, int chunk) {
  using namespace fma_body;
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
      bs[t * np + c] = bm[((tok0 + t) * g + grp) * n + c];
    }
    for (int i = tid; i < chunk * PT; i += THREADS) {
      const int t = i / PT, r = i % PT;
      float v = 0.f;
      if (p0 + r < p) {
        const size_t row = (tok0 + t) * h + hh;
        v = x[row * p + p0 + r] * dt[row];
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
            q0 + r < chunk ? cm[((tok0 + q0 + r) * g + grp) * n + c]
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
              ya[i] + eseg[q] * yo[i];
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

// ---------------------------------------------------------------------------
// ssd_tc: bf16 on tensor cores
// ---------------------------------------------------------------------------

namespace tc_body {

constexpr int CWARPS = 8;   // compute warps
constexpr int PWARPS = 4;   // producer warps: one warp keeps too few
                            // 16-byte copies in flight to feed the block
constexpr int THREADS = 32 * (CWARPS + PWARPS);
constexpr int PTHREADS = 32 * PWARPS;
constexpr int PT = 32;         // state rows per block
constexpr int PAD = 8;         // bf16 elements (16 bytes) after each row
constexpr int LDX = PT + PAD;  // row of the x tile
constexpr int LDN = MAX_N + PAD;  // row of C, B and the state copies
constexpr int KMAX = MAX_N / 16;  // k-steps over the state
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Byte layout of the dynamic shared memory for a chunk of ``qp`` rows
// (rounded up to 16): two stages of {C, B [qp][LDN], x [qp][LDX] bf16;
// dt, seg, exp(seg), dt * exp(total - seg) [qp] f32}, the state's hi and
// lo copies [PT][LDN] bf16, and four 16 x 32 f32 partial y tiles.
struct Layout {
  size_t c, b, x, dt, seg, eseg, dtw, stage, sh, sl, ypart, bytes;
  __host__ __device__ explicit Layout(int qp) {
    const size_t bc = sizeof(__nv_bfloat16) * (size_t)qp * LDN;
    const size_t vec = sizeof(float) * (size_t)qp;
    c = 0;
    b = bc;
    x = 2 * bc;
    dt = x + sizeof(__nv_bfloat16) * (size_t)qp * LDX;
    seg = dt + vec;
    eseg = seg + vec;
    dtw = eseg + vec;
    stage = dtw + vec;
    sh = 2 * stage;
    sl = sh + sizeof(__nv_bfloat16) * (size_t)PT * LDN;
    ypart = sl + sizeof(__nv_bfloat16) * (size_t)PT * LDN;
    bytes = ypart + sizeof(float) * 4 * 16 * PT;
  }
};

// The producer and compute warps reach the block's barriers from
// different call sites, so every barrier is the non-aligned form, whose
// meaning PTX defines for divergent sites: barrier 0 meets all warps,
// named barriers 1..4 pair compute warp r with warp r + 4.
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0, %0;\n" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("barrier.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("barrier.sync %0, 64;\n" ::"r"(id) : "memory");
}

}  // namespace tc_body

// bf16 pair (lo half first) scaled by (w.x, w.y) in f32 and split.
__device__ __forceinline__ void scale_split(uint32_t pair, float2 w,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
  split_bf16(v.x * w.x, v.y * w.y, hi, lo);
}

__global__ void __launch_bounds__(tc_body::THREADS, 1)
ssd_tc(const __nv_bfloat16* __restrict__ x,   // [B, L, H, P]
       const float* __restrict__ dt,          // [B, L, H]
       const float* __restrict__ a,           // [H]
       const __nv_bfloat16* __restrict__ bm,  // [B, L, G, N]
       const __nv_bfloat16* __restrict__ cm,  // [B, L, G, N]
       const float* __restrict__ init,        // [B, H, P, N] or null
       __nv_bfloat16* __restrict__ y,         // [B, L, H, P]
       float* __restrict__ fin,               // [B, H, P, N]
       int seqlen, int h, int p, int g, int n, int chunk, int vec) {
  using namespace tc_body;
  const int b = blockIdx.x;
  const int hh = blockIdx.y;
  const int p0 = blockIdx.z * PT;
  const int grp = hh / (h / g);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qr = lane >> 2;  // this lane's row within an 8-row group
  const int qc = lane & 3;   // its column pair within an 8-column tile
  const int qp = round16(chunk);
  const int nb = qp / 16;    // 16-row blocks of the chunk
  const int nc = seqlen / chunk;
  const Layout lay(qp);
  constexpr int ldn = LDN;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto bf16_at = [&](int st, size_t off) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + st * lay.stage + off);
  };
  auto f32_at = [&](int st, size_t off) {
    return reinterpret_cast<float*>(smem_raw + st * lay.stage + off);
  };
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.sh);
  __nv_bfloat16* sl = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.sl);
  float* ypart = reinterpret_cast<float*>(smem_raw + lay.ypart);

  if (warp >= CWARPS) {
    // ---- producers: chunk ic + 1 lands and its decays are ready while
    // the compute warps work on chunk ic.  The last producer warp also
    // copies dt and computes the decays.
    const int ptid = tid - 32 * CWARPS;
    const bool scan_warp = warp == CWARPS + PWARPS - 1;
    // C, B and x of chunk ic into its stage
    auto copy_chunk = [&](int ic) {
      const int st = ic & 1;
      const size_t tok0 = (size_t)b * seqlen + (size_t)ic * chunk;
      __nv_bfloat16* cs = bf16_at(st, lay.c);
      __nv_bfloat16* bs = bf16_at(st, lay.b);
      __nv_bfloat16* xs = bf16_at(st, lay.x);
      if (vec) {  // 16-byte copies, zero-filled past the chunk, N and P
        constexpr int cpr = MAX_N / 8;
        for (int i = ptid; i < qp * cpr; i += PTHREADS) {
          const int t = i / cpr, c = (i - t * cpr) * 8;
          const bool ok = t < chunk && c < n;
          const size_t src = ok ? ((tok0 + t) * g + grp) * n + c : 0;
          cp_async16(cs + t * ldn + c, cm + src, ok);
          cp_async16(bs + t * ldn + c, bm + src, ok);
        }
        for (int i = ptid; i < qp * (PT / 8); i += PTHREADS) {
          const int t = i / (PT / 8), c = (i % (PT / 8)) * 8;
          const bool ok = t < chunk && p0 + c < p;
          cp_async16(xs + t * LDX + c,
                     x + (ok ? ((tok0 + t) * h + hh) * p + p0 + c : 0), ok);
        }
      } else {    // rows that are no whole number of 16-byte pieces
        const __nv_bfloat16 zero = __float2bfloat16(0.f);
        for (int i = ptid; i < qp * MAX_N; i += PTHREADS) {
          const int t = i / MAX_N, c = i % MAX_N;
          const bool ok = t < chunk && c < n;
          const size_t src = ((tok0 + t) * g + grp) * n + c;
          cs[t * ldn + c] = ok ? cm[src] : zero;
          bs[t * ldn + c] = ok ? bm[src] : zero;
        }
        for (int i = ptid; i < qp * PT; i += PTHREADS) {
          const int t = i / PT, c = i % PT;
          const bool ok = t < chunk && p0 + c < p;
          xs[t * LDX + c] =
              ok ? x[((tok0 + t) * h + hh) * p + p0 + c] : zero;
        }
      }
    };
    // dt of chunk ic, by the lanes of the scan warp
    auto copy_dt = [&](int ic) {
      const size_t tok0 = (size_t)b * seqlen + (size_t)ic * chunk;
      float* dts = f32_at(ic & 1, lay.dt);
      for (int t = lane; t < qp; t += 32)
        cp_async4(dts + t, dt + (t < chunk ? (tok0 + t) * h + hh : 0),
                  t < chunk);
    };
    // the decays of chunk ic (the scan warp, after its dt landed)
    auto decays = [&](int ic) {
      const int st = ic & 1;
      const float av = a[hh];
      const float* dts = f32_at(st, lay.dt);
      // seg: each lane a run of 4 consecutive steps, then an inclusive
      // scan of the runs across the lanes
      float* seg = f32_at(st, lay.seg);
      float* eseg = f32_at(st, lay.eseg);
      float* dtw = f32_at(st, lay.dtw);
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = lane * 4 + k;
        run += t < chunk ? av * dts[t] : 0.f;
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
        if (t < qp) seg[t] = excl + loc[k];  // rows past the chunk: total
      }
      __syncwarp();
      const float total = seg[chunk - 1];
      for (int t = lane; t < qp; t += 32) {
        eseg[t] = expf(seg[t]);
        dtw[t] = t < chunk ? dts[t] * expf(total - seg[t]) : 0.f;
      }
    };
    auto produce = [&](int ic) {
      copy_chunk(ic);
      if (scan_warp) copy_dt(ic);
      cp_async_commit();
      cp_async_wait<0>();
      if (scan_warp) {
        __syncwarp();
        decays(ic);
      }
    };
    produce(0);
    block_sync();  // chunk 0 ready
    for (int ic = 0; ic < nc; ++ic) {
      if (ic + 1 < nc) produce(ic + 1);
      block_sync();  // chunk ic done
      if (ic + 1 < nc) block_sync();  // the state copy is written
    }
    return;
  }

  // ---- compute warps.  The state: warp w holds rows 16 (w / 4) +
  // {qr, qr + 8} and columns 32 (w % 4) + 8 j + 2 qc + {0, 1} of the
  // block's 32 x N16 tile, in f32 registers for the whole scan
  const int pm = warp >> 2;
  const int nq = warp & 3;
  const bool srow = p0 + pm * 16 < p;  // this warp's state rows exist
  const size_t state0 = ((size_t)b * h + hh) * p;  // row of (b, h, p = 0)
  float sreg[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = p0 + pm * 16 + qr + (e >> 1) * 8;
      const int c = nq * 32 + j * 8 + qc * 2 + (e & 1);
      sreg[j][e] = init != nullptr && r < p && c < n
                       ? init[(state0 + r) * n + c] : 0.f;
    }
  // its bf16 hi/lo copy, the B operand of C . S^T
  auto store_state = [&]() {
    if (!srow) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = nq * 32 + j * 8 + qc * 2;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = pm * 16 + qr + hr * 8;
        uint32_t hi, lo;
        split_bf16(sreg[j][2 * hr], sreg[j][2 * hr + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sh + r * ldn + c) = hi;
        *reinterpret_cast<uint32_t*>(sl + r * ldn + c) = lo;
      }
    }
  };
  if (init != nullptr) store_state();
  block_sync();  // chunk 0 ready

  // Query row blocks: compute warps r and r + 4 (one SM sub-partition)
  // share rows r and 7 - r, 9 causal 16x16 tiles: warp r takes row r and
  // the first 4 - r tiles of row 7 - r, whose partial y it hands to warp
  // r + 4 through shared memory; warp r + 4 the other 4 tiles of row
  // 7 - r.  Each also takes its row's C . S_in^T.
  const int r = warp & 3;
  const bool pair = 7 - r < nb;  // row 7 - r exists in this chunk
  float* ypr = ypart + r * 16 * PT;

  for (int ic = 0; ic < nc; ++ic) {
    const int st = ic & 1;
    const __nv_bfloat16* cs = bf16_at(st, lay.c);
    const __nv_bfloat16* bs = bf16_at(st, lay.b);
    const __nv_bfloat16* xs = bf16_at(st, lay.x);
    const float* dts = f32_at(st, lay.dt);
    const float* seg = f32_at(st, lay.seg);
    const float* eseg = f32_at(st, lay.eseg);
    const float* dtw = f32_at(st, lay.dtw);
    const size_t tok0 = (size_t)b * seqlen + (size_t)ic * chunk;
    const bool has_state = ic > 0 || init != nullptr;

    uint32_t cf[KMAX][4];  // C of one row block, the A operand
    auto load_c = [&](int rb) {
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk)
        ldmatrix_x4(cf[kk], cs + (rb * 16 + (lane & 15)) * ldn + kk * 16 +
                                (lane >> 4) * 8);
    };
    // C.B^T of the loaded row block against key block jb, even and odd
    // k-steps in two accumulators
    auto cb_tile = [&](int jb, float (&s)[2][4]) {
      float u[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = u[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, bs + (jb * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 ldn +
                             kk * 16 + ((lane >> 3) & 1) * 8);
        float(&d)[2][4] = (kk & 1) ? u : s;
        mma_bf16_16816(d[0], cf[kk], bf[0], bf[1]);
        mma_bf16_16816(d[1], cf[kk], bf[2], bf[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += u[nt][e];
    };
    // acc += sum over key blocks j0..j1 of M'(rb, jb) . x(jb); the next
    // tile's C.B^T is issued before this tile's decay and split
    auto tiles = [&](int rb, int j0, int j1, float (&acc)[4][4]) {
      const int q_lo = rb * 16 + qr;
      const float sq[2] = {seg[q_lo], seg[q_lo + 8]};
      float s[2][4];
      cb_tile(j0, s);
      for (int jb = j0; jb <= j1; ++jb) {
        float nx[2][4];
        if (jb < j1) cb_tile(jb + 1, nx);
        // M' = C.B^T exp(seg_q - seg_t) dt_t, selected to 0 off the
        // causal triangle and past the chunk
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int t0 = jb * 16 + nt * 8 + qc * 2;
          const float2 sg = *reinterpret_cast<const float2*>(seg + t0);
          const float2 dv = *reinterpret_cast<const float2*>(dts + t0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q_lo + (e >> 1) * 8;
            const int t = t0 + (e & 1);
            const float sgt = (e & 1) ? sg.y : sg.x;
            const float dtt = (e & 1) ? dv.y : dv.x;
            s[nt][e] = t <= q && q < chunk
                           ? s[nt][e] *
                                 exp2_approx((sq[e >> 1] - sgt) * LOG2E) * dtt
                           : 0.f;
          }
        }
        uint32_t ah[4], al[4];
        split_bf16(s[0][0], s[0][1], ah[0], al[0]);
        split_bf16(s[0][2], s[0][3], ah[1], al[1]);
        split_bf16(s[1][0], s[1][1], ah[2], al[2]);
        split_bf16(s[1][2], s[1][3], ah[3], al[3]);
        // acc += M' . x over the key block
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          if (p0 + dp * 16 < p) {
            uint32_t bf[4];
            ldmatrix_x4_trans(
                bf, xs + (jb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                        dp * 16 + (lane >> 4) * 8);
            mma_bf16_16816(acc[2 * dp], ah, bf[0], bf[1]);
            mma_bf16_16816(acc[2 * dp], al, bf[0], bf[1]);
            mma_bf16_16816(acc[2 * dp + 1], ah, bf[2], bf[3]);
            mma_bf16_16816(acc[2 * dp + 1], al, bf[2], bf[3]);
          }
        }
        if (jb < j1) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = nx[nt][e];
        }
      }
    };
    // acc = C . S_in^T of the loaded row block, hi and lo apart
    auto c_state = [&](float (&acc)[4][4]) {
      float lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = lo[j][e] = 0.f;
      if (!has_state) return;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          if (p0 + dp * 16 >= p) continue;
          const int off = (dp * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldn +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, sh + off);
          ldmatrix_x4(bl, sl + off);
          mma_bf16_16816(acc[2 * dp], cf[kk], bh[0], bh[1]);
          mma_bf16_16816(lo[2 * dp], cf[kk], bl[0], bl[1]);
          mma_bf16_16816(acc[2 * dp + 1], cf[kk], bh[2], bh[3]);
          mma_bf16_16816(lo[2 * dp + 1], cf[kk], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += lo[j][e];
    };
    // y of row block rb = ya + exp(seg_q) yo, rounded to bf16
    auto store_y = [&](int rb, const float (&ya)[4][4],
                       const float (&yo)[4][4]) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = rb * 16 + qr + hr * 8;
        if (q >= chunk) continue;
        const float es = eseg[q];
        __nv_bfloat16* dst = y + ((tok0 + q) * h + hh) * p + p0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = j * 8 + qc * 2;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (p0 + c + e < p)
              dst[c + e] = __float2bfloat16(ya[j][2 * hr + e] +
                                            es * yo[j][2 * hr + e]);
        }
      }
    };

    float ya[4][4], yo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[j][e] = 0.f;
    if (warp < 4) {
      if (pair) {  // the first 4 - r tiles of row 7 - r, for warp r + 4
        load_c(7 - r);
        tiles(7 - r, 0, 3 - r, ya);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ypr[(j * 4 + e) * 32 + lane] = ya[j][e];
            ya[j][e] = 0.f;
          }
        __threadfence_block();
        pair_arrive(1 + r);
      }
      if (r < nb) {
        load_c(r);
        tiles(r, 0, r, ya);
        c_state(yo);
        store_y(r, ya, yo);
      }
    } else if (pair) {
      load_c(7 - r);
      tiles(7 - r, 4 - r, 7 - r, ya);
      c_state(yo);
      pair_sync(1 + r);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[j][e] += ypr[(j * 4 + e) * 32 + lane];
      store_y(7 - r, ya, yo);
    }

    // S = exp(total) S + (x dt w)^T . B over the chunk's key blocks
    if (srow) {
      const float dec = expf(seg[chunk - 1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sreg[j][e] *= dec;
      for (int kk = 0; kk < nb; ++kk) {
        uint32_t ax[4];
        ldmatrix_x4_trans(
            ax, xs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDX +
                    pm * 16 + ((lane >> 3) & 1) * 8);
        const int t0 = kk * 16 + qc * 2;
        const float2 w0 = *reinterpret_cast<const float2*>(dtw + t0);
        const float2 w1 = *reinterpret_cast<const float2*>(dtw + t0 + 8);
        uint32_t ah[4], al[4];
        scale_split(ax[0], w0, ah[0], al[0]);
        scale_split(ax[1], w0, ah[1], al[1]);
        scale_split(ax[2], w1, ah[2], al[2]);
        scale_split(ax[3], w1, ah[3], al[3]);
#pragma unroll
        for (int dn = 0; dn < 2; ++dn) {
          const int c0 = nq * 32 + dn * 16;
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldn +
                      c0 + (lane >> 4) * 8);
          mma_bf16_16816(sreg[2 * dn], ah, bf[0], bf[1]);
          mma_bf16_16816(sreg[2 * dn], al, bf[0], bf[1]);
          mma_bf16_16816(sreg[2 * dn + 1], ah, bf[2], bf[3]);
          mma_bf16_16816(sreg[2 * dn + 1], al, bf[2], bf[3]);
        }
      }
    }
    block_sync();  // chunk ic done: S_in and its stage are free
    if (ic + 1 < nc) {
      store_state();
      block_sync();  // the state copy is written
    }
  }

  if (srow) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = p0 + pm * 16 + qr + (e >> 1) * 8;
        const int c = nq * 32 + j * 8 + qc * 2 + (e & 1);
        if (rr < p && c < n) fin[(state0 + rr) * n + c] = sreg[j][e];
      }
  }
}

int launch_fma(const float* x, const float* dt, const float* a,
               const float* bm, const float* cm, const float* init, float* cb,
               float* y, float* fin, int b, int seqlen, int h, int p, int g,
               int n, int chunk, cudaStream_t st) {
  using namespace fma_body;
  const size_t cb_smem = sizeof(float) * cb_smem_floats(chunk, n);
  cudaError_t err = allow_smem(ssd_cb_kernel, cb_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_cb_kernel<<<dim3(b * g, seqlen / chunk, (chunk + QT - 1) / QT), THREADS,
                  cb_smem, st>>>(bm, cm, cb, seqlen, g, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * smem_floats(chunk, n);
  err = allow_smem(ssd_scan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<dim3(b, h, (p + PT - 1) / PT), THREADS, smem, st>>>(
      x, dt, a, bm, cm, init, cb, y, fin, seqlen, h, p, g, n, chunk);
  return (int)cudaGetLastError();
}

int launch_tc(const __nv_bfloat16* x, const float* dt, const float* a,
              const __nv_bfloat16* bm, const __nv_bfloat16* cm,
              const float* init, __nv_bfloat16* y, float* fin, int b,
              int seqlen, int h, int p, int g, int n, int chunk,
              cudaStream_t st) {
  using namespace tc_body;
  const size_t smem = Layout(round16(chunk)).bytes;
  const cudaError_t err = allow_smem(ssd_tc, smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need whole 16-byte rows and 16-byte aligned bases
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const int vec = p % 8 == 0 && n % 8 == 0 && aligned(x) && aligned(bm) &&
                  aligned(cm);
  ssd_tc<<<dim3(b, h, (p + PT - 1) / PT), THREADS, smem, st>>>(
      x, dt, a, bm, cm, init, y, fin, seqlen, h, p, g, n, chunk, vec);
  return (int)cudaGetLastError();
}

bool bad_shape(int seqlen, int h, int g, int n, int chunk) {
  return chunk < 1 || chunk > MAX_Q || n < 1 || n > MAX_N || g < 1 ||
         h % g || seqlen % chunk;
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes.  ``init`` may be null (a zero
// initial state).  ``cb`` (f32 only) is scratch of B * G * L *
// key_cols(chunk) floats (key_cols rounds the chunk up to a multiple of
// 32).  Each returns cudaGetLastError() after its launches (0 on
// success), or cudaErrorInvalidValue for a shape it does not take (an
// empty batch or sequence among them: the final state would stay unset).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, const void* init,
                            void* cb, void* y, void* fin, int b, int seqlen,
                            int h, int p, int g, int n, int chunk,
                            void* stream) {
  using namespace repro_torch;
  if (bad_shape(seqlen, h, g, n, chunk)) return (int)cudaErrorInvalidValue;
  if (seqlen < 1 || b < 1) return (int)cudaErrorInvalidValue;
  return launch_fma(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(init),
      static_cast<float*>(cb), static_cast<float*>(y),
      static_cast<float*>(fin), b, seqlen, h, p, g, n, chunk,
      static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                             const void* bm, const void* cm, const void* init,
                             void* y, void* fin, int b, int seqlen, int h,
                             int p, int g, int n, int chunk, void* stream) {
  using namespace repro_torch;
  if (bad_shape(seqlen, h, g, n, chunk)) return (int)cudaErrorInvalidValue;
  if (seqlen < 1 || b < 1) return (int)cudaErrorInvalidValue;
  return launch_tc(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<const float*>(init),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(fin), b, seqlen, h,
      p, g, n, chunk, static_cast<cudaStream_t>(stream));
}
