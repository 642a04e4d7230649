// The backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its jnp scan with
// jax.grad, and this is the gradient of ssd_chunk_scan (csrc/ssd_scan.cu,
// the port of _kernel in src/repro/kernels/ssd_scan.py).  Per (sequence
// b, head h), chunks of Q tokens, with u_t = dt_t x_t, seg the
// within-chunk cumulative sum of a_h dt, total its last value, G_qt =
// C_q.B_t, L_qt = exp(seg_q - seg_t) for t <= q (an exact 0 elsewhere,
// set by selection), S_c the state entering chunk c and dS_{c+1} the
// cotangent of the state leaving it:
//   dS_c  = e^{total} dS_{c+1} + sum_q e^{seg_q} dy_q C_q^T  (dS_nc = d_final)
//   du_t  = sum_{q>=t} G_qt L_qt dy_q + e^{total-seg_t} dS_{c+1} B_t
//   dG_qt = L_qt (dy_q . u_t)
//   dC_q  = sum_t dG_qt B_t + e^{seg_q} S_c^T dy_q
//   dB_t  = sum_q dG_qt C_q + e^{total-seg_t} dS_{c+1}^T u_t
//   dseg  : + sum_t W_qt, - sum_q W_qt (W = G o dG), + C_q . dC_state_q,
//           - u_t . du_state_t, and on the chunk's last position
//           dtotal = e^{total} <dS_{c+1}, S_c> + sum_t u_t . du_state_t
//   d(a dt) = the within-chunk reverse cumulative sum of dseg
//   dx = dt du, ddt = x . du + a d(a dt), da = sum d(a dt) dt,
//   dB and dC summed over the H / G heads of a group.
// kernels/ref.py::ssd_scan_bwd_ref takes the same steps in PyTorch.
//
// Bound on the H100 at mamba2-1.3b's training shape (B4 L2048 H64 P64 G1
// N128, chunk 128, bf16): operations, 66.9 GFLOP of products this data
// needs against 0.22 GB that must move once (x, dy, B, C, dt in; dx, dB,
// dC, ddt out), 0.068 ms at 989 TFLOP/s.  Hopper blocks carry nothing between
// them, and the reverse scan over chunks is sequential, so the work is cut
// where it is not:
//   1. ssd_bwd_pass: two sequential passes per (b, h, 32 state rows), in
//      one launch (grid z picks the pass): the states S_c entering every
//      chunk, forward from the initial state, and the cotangents dS_{c+1}
//      leaving every chunk, backward from d_final, each into an f32
//      scratch [B, chunks, H, P, N]; the cotangent pass writes
//      d_initial_state = dS_0.  The forward kernel and its serving times
//      are untouched: the backward recomputes the states.  In the bf16
//      body a block's next chunk lands in a second stage while it scans
//      this one, and two blocks share an SM.
//   2. ssd_bwd_chunk: every chunk at once, per (b, chunk, h, P tile),
//      given S_c and dS_{c+1}: dx, and f32 partials of dB and dC per head
//      and P tile, of ddt per P tile, and of da per block.  Its warps take
//      the block's products from one queue, costliest first.
//   3. ssd_bwd_reduce: each partial summed in a fixed order (heads of the
//      group, then P tiles; blocks for da) and rounded once.
// No float atomics: every sum has a fixed order, so two runs are bitwise
// equal.  Scratch at the training shape: the two state arrays 134 MB
// each, the dB and dC partials 268 MB each.
//
// Two bodies, chosen by the wrapper from the dtype alone
// (kernels/ssd_backward.py::bwd_body):
//   * bf16 on tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate):
//     B, C, x and dy are bf16 and exact as operands; the f32 factors (the
//     masked, decayed G and dG tiles, the recomputed S_c and dS_{c+1},
//     dt and the decays) are split into bf16 hi + lo and multiply the
//     exact side twice (~2^-16 relative), as ssd_tc does.  The chunk
//     kernel's tile is 64 state rows (all of mamba2's P) so that dy.u^T
//     sums over P within the block; G^T and (dy.u^T)^T tiles come out of
//     an MMA in the accumulator layout, which is the A layout of the next
//     product, so M = G o L and dG are split where they lie and never
//     touch shared memory.  Shared memory at Q = N = 128: C, B, x, dy and
//     the hi/lo copies of S_c and dS_{c+1}, 184,864 bytes, one block an
//     SM.
//   * f32 on FMAs (whose limits tensor cores would miss through TF32):
//     32 state rows a block, the chunk's query rows 32 at a time, G, W
//     and dG tiles in shared memory.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int MAX_Q = 128;  // chunk limit
constexpr int MAX_N = 128;  // state limit
constexpr int THREADS = 256;
constexpr int PASS_PT = 32;  // state rows of a pass block, both bodies

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shapes and pointers of one backward call.
struct Args {
  const void* x;      // [B, L, H, P]
  const float* dt;    // [B, L, H]
  const float* a;     // [H]
  const void* bm;     // [B, L, G, N]
  const void* cm;     // [B, L, G, N]
  const float* init;  // [B, H, P, N] or null
  const void* dy;     // [B, L, H, P]
  const float* dfin;  // [B, H, P, N] or null
  float* states;      // [B, nc, H, P, N]: S_c entering chunk c
  float* dstates;     // [B, nc, H, P, N]: dS_{c+1} leaving chunk c
  float* part_b;      // [B, L, H, npt, N]
  float* part_c;      // [B, L, H, npt, N]
  float* part_dt;     // [B, L, H, npt]
  float* part_da;     // [H, B * nc * npt]
  void* dx;           // [B, L, H, P]
  float* ddt;         // [B, L, H]
  float* da;          // [H]
  void* db;           // [B, L, G, N]
  void* dc;           // [B, L, G, N]
  float* dinit;       // [B, H, P, N]
  int b, seqlen, h, p, g, n, chunk, nc, npt;
};

// seg (the inclusive within-chunk sum of a dt), exp(seg) and exp(total -
// seg) of one chunk, by one warp: each lane a run of 4 consecutive steps,
// then an inclusive scan of the runs across the lanes (the forward's
// order).  Rows past the chunk (dt 0 there) carry seg = total.
__device__ void chunk_decays(const float* dts, float av, int chunk, int qp,
                             int lane, float* seg, float* eseg,
                             float* wdec) {
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
    if (t < qp) seg[t] = excl + loc[k];
  }
  __syncwarp();
  const float total = seg[chunk - 1];
  for (int t = lane; t < qp; t += 32) {
    eseg[t] = expf(seg[t]);
    wdec[t] = expf(total - seg[t]);
  }
  __syncwarp();
}

// The end of a chunk block, by warp 0, from its partials in shared memory:
// dseg [qp] (every term but dtotal), sstate [qp] (u_t . du_state_t), ddtx
// [qp] (x_t . du_t), and dot = <dS_{c+1}, S_c> over the block's rows.
// dtotal lands on the chunk's last position; the reverse cumulative sum
// gives d(a dt), whence the block's ddt and da partials.
__device__ void finish_chunk(const Args& A, float* dseg, const float* sstate,
                             const float* ddtx, const float* dts, float dot,
                             float etot, int bb, int ic, int hh, int pt,
                             int lane) {
  const int chunk = A.chunk;
  float s = 0.f;
  for (int t = lane; t < chunk; t += 32) s += sstate[t];
  s = warp_sum(s);
  if (lane == 0) dseg[chunk - 1] += etot * dot + s;
  __syncwarp();
  // reverse inclusive scan: lane owns steps 4 lane .. 4 lane + 3
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const int t = lane * 4 + k;
    run += t < chunk ? dseg[t] : 0.f;
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += u;
  }
  float excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.f;
  const float av = A.a[hh];
  float dap = 0.f;
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = lane * 4 + k;
    if (t < chunk) {
      const float dld = excl + loc[k];
      A.part_dt[((tok0 + t) * A.h + hh) * A.npt + pt] = ddtx[t] + av * dld;
      dap += dld * dts[t];
    }
  }
  dap = warp_sum(dap);
  if (lane == 0)
    A.part_da[(size_t)hh * A.b * A.nc * A.npt +
              ((size_t)bb * A.nc + ic) * A.npt + pt] = dap;
}

// ---------------------------------------------------------------------------
// the f32 body on FMAs
// ---------------------------------------------------------------------------

namespace fma_body {

constexpr int PT = 32;  // state rows of a chunk block: one per lane
constexpr int QT = 32;  // query rows of a tile: 4 per warp

// Pass block: chunk operand [Q][N + 1] (B or C), the vector side [Q][PT + 1]
// (x or dy), dt, seg, exp(seg), exp(total - seg)
__host__ inline size_t pass_smem_floats(int chunk, int n) {
  return (size_t)chunk * (n + 1) + (size_t)chunk * (PT + 1) + 4 * MAX_Q;
}

// Chunk block: C, B [Q][N + 1]; x, dy [Q][PT + 1]; two [QT][Q + 1] tiles
// (later dS [PT][N + 1]); dt, seg, exp(seg), exp(total - seg), dseg,
// column sums of W, sstate, ddtx, C . dC_state [MAX_Q]; 8 warp partials
__host__ __device__ inline size_t chunk_smem_floats(int chunk, int n) {
  const size_t tile = 2 * (size_t)QT * (chunk + 1);
  const size_t ds = (size_t)PT * (n + 1);
  return 2 * (size_t)chunk * (n + 1) + 2 * (size_t)chunk * (PT + 1) +
         (tile > ds ? tile : ds) + 9 * MAX_Q + 8;
}

}  // namespace fma_body

// The two sequential passes, f32.  Grid (B, H, 2 * ceil(P / 32)): z below
// ceil(P / 32) runs the state pass of tile z, above it the cotangent pass.
// A thread holds rows 4 warp + i and columns lane + 32 j of the block's
// 32 x N carried value.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_fma(Args A) {
  using namespace fma_body;
  const int bb = blockIdx.x;
  const int hh = blockIdx.y;
  const int tiles = (A.p + PASS_PT - 1) / PASS_PT;
  const bool cot = blockIdx.z >= tiles;
  const int p0 = (blockIdx.z - (cot ? tiles : 0)) * PASS_PT;
  const int grp = hh / (A.h / A.g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = A.chunk, n = A.n, h = A.h, p = A.p, g = A.g;
  const int np = n + 1;
  const float* mat = static_cast<const float*>(cot ? A.cm : A.bm);
  const float* vec = static_cast<const float*>(cot ? A.dy : A.x);
  float* out = cot ? A.dstates : A.states;
  const float* start = cot ? A.dfin : A.init;

  extern __shared__ float smem[];
  float* ms = smem;                   // [Q][N + 1]
  float* vs = ms + chunk * np;        // [Q][PT + 1]
  float* dts = vs + chunk * (PT + 1);
  float* seg = dts + MAX_Q;
  float* eseg = seg + MAX_Q;
  float* wdec = eseg + MAX_Q;

  const size_t state0 = ((size_t)bb * h + hh) * p;  // row (b, h, p = 0)
  float sr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = p0 + warp * 4 + i, c = lane + 32 * j;
      sr[i][j] = start != nullptr && r < p && c < n
                     ? start[(state0 + r) * n + c] : 0.f;
    }
  for (int k = 0; k < A.nc; ++k) {
    const int ic = cot ? A.nc - 1 - k : k;
    const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
    for (int i = tid; i < chunk * n; i += THREADS) {
      const int t = i / n, c = i - t * n;
      ms[t * np + c] = mat[((tok0 + t) * g + grp) * n + c];
    }
    for (int i = tid; i < chunk * PT; i += THREADS) {
      const int t = i / PT, r = i % PT;
      vs[t * (PT + 1) + r] =
          p0 + r < p ? vec[((tok0 + t) * h + hh) * p + p0 + r] : 0.f;
    }
    for (int t = tid; t < MAX_Q; t += THREADS)
      dts[t] = t < chunk ? A.dt[(tok0 + t) * h + hh] : 0.f;
    __syncthreads();
    if (warp == 0)
      chunk_decays(dts, A.a[hh], chunk, MAX_Q, lane, seg, eseg, wdec);
    __syncthreads();
    // the carried value at this chunk's boundary
    float* dst = out + (((size_t)bb * A.nc + ic) * h + hh) * (size_t)p * n;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = p0 + warp * 4 + i, c = lane + 32 * j;
        if (r < p && c < n) dst[(size_t)r * n + c] = sr[i][j];
      }
    // state: S = e^{total} S + sum_t dt_t e^{total-seg_t} x_t B_t^T;
    // cotangent: dS = e^{total} dS + sum_q e^{seg_q} dy_q C_q^T
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int t = 0; t < chunk; ++t) {
      const float w = cot ? eseg[t] : dts[t] * wdec[t];
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = w * vs[t * (PT + 1) + warp * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (c < n) {
          const float mv = ms[t * np + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += v[i] * mv;
        }
      }
    }
    const float dec = expf(seg[chunk - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sr[i][j] = dec * sr[i][j] + acc[i][j];
    __syncthreads();  // ms, vs and the decays are rewritten next chunk
  }
  if (cot) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = p0 + warp * 4 + i, c = lane + 32 * j;
        if (r < p && c < n) A.dinit[(state0 + r) * n + c] = sr[i][j];
      }
  }
}

// Every chunk's gradients, f32.  Grid (B * nc, H, ceil(P / 32)).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_fma(Args A) {
  using namespace fma_body;
  const int bb = blockIdx.x / A.nc;
  const int ic = blockIdx.x % A.nc;
  const int hh = blockIdx.y;
  const int pt = blockIdx.z;
  const int p0 = pt * PT;
  const int grp = hh / (A.h / A.g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = A.chunk, n = A.n, h = A.h, p = A.p, g = A.g;
  const int np = n + 1, xp = PT + 1, tq = chunk + 1;
  const float* xg = static_cast<const float*>(A.x);
  const float* dyg = static_cast<const float*>(A.dy);
  const float* bg = static_cast<const float*>(A.bm);
  const float* cg = static_cast<const float*>(A.cm);
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
  const size_t sbase = (((size_t)bb * A.nc + ic) * h + hh) * (size_t)p * n;
  const float* sc = A.states + sbase;    // S_c [P][N]
  const float* dsc = A.dstates + sbase;  // dS_{c+1} [P][N]

  extern __shared__ float smem[];
  float* cs = smem;                  // [Q][N + 1]
  float* bs = cs + chunk * np;       // [Q][N + 1]
  float* xs = bs + chunk * np;       // [Q][PT + 1]
  float* ys = xs + chunk * xp;       // [Q][PT + 1] dy
  float* mt = ys + chunk * xp;       // [QT][Q + 1] M = G o L; later dS
  float* wt = mt + QT * tq;          // [QT][Q + 1] W, then dG
  const size_t tile = 2 * (size_t)QT * tq, dsz = (size_t)PT * np;
  float* dts = mt + (tile > dsz ? tile : dsz);
  float* seg = dts + MAX_Q;
  float* eseg = seg + MAX_Q;
  float* wdec = eseg + MAX_Q;
  float* dseg = wdec + MAX_Q;    // sum_t W_qt, then every term
  float* colw = dseg + MAX_Q;    // sum_q W_qt
  float* sstate = colw + MAX_Q;  // u_t . du_state_t
  float* ddtx = sstate + MAX_Q;  // x_t . du_t
  float* cdot = ddtx + MAX_Q;    // C_q . dC_state_q
  float* red = cdot + MAX_Q;     // [8]

  for (int i = tid; i < chunk * n; i += THREADS) {
    const int t = i / n, c = i - t * n;
    const size_t src = ((tok0 + t) * g + grp) * n + c;
    cs[t * np + c] = cg[src];
    bs[t * np + c] = bg[src];
  }
  for (int i = tid; i < chunk * PT; i += THREADS) {
    const int t = i / PT, r = i % PT;
    const bool ok = p0 + r < p;
    const size_t src = ((tok0 + t) * h + hh) * p + p0 + r;
    xs[t * xp + r] = ok ? xg[src] : 0.f;
    ys[t * xp + r] = ok ? dyg[src] : 0.f;
  }
  for (int t = tid; t < MAX_Q; t += THREADS) {
    dts[t] = t < chunk ? A.dt[(tok0 + t) * h + hh] : 0.f;
    colw[t] = 0.f;
  }
  __syncthreads();
  if (warp == 0)
    chunk_decays(dts, A.a[hh], chunk, MAX_Q, lane, seg, eseg, wdec);
  __syncthreads();

  // dB accumulates over the query tiles: rows t = warp + 8 k, columns
  // n = lane + 32 j
  float dbr[16][4];
  float dur[16];  // du_intra: rows t = warp + 8 k, column p = lane
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    dur[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dbr[k][j] = 0.f;
  }

  for (int q0 = 0; q0 < chunk; q0 += QT) {
    const int tmax = min(q0 + QT, chunk);  // key columns this tile sees
    // (a) rows q = q0 + 4 warp + i, columns t = lane + 32 j
    float dgr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i, q = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = lane + 32 * j;
        dgr[i][j] = 0.f;
        if (t >= tmax) continue;
        float m = 0.f, w = 0.f;
        if (q < chunk && t <= q) {
          float gv = 0.f, dv = 0.f;
          for (int c = 0; c < n; ++c) gv += cs[q * np + c] * bs[t * np + c];
#pragma unroll 8
          for (int c = 0; c < PT; ++c) dv += ys[q * xp + c] * xs[t * xp + c];
          const float l = expf(seg[q] - seg[t]);
          m = gv * l;
          dgr[i][j] = dv * dts[t] * l;
          w = gv * dgr[i][j];
        }
        mt[r * tq + t] = m;
        wt[r * tq + t] = w;
      }
    }
    __syncthreads();
    // (b) W: row sums (into dseg_q), column sums (out of dseg_t), fixed
    // order: one thread per row or column
    if (tid < tmax) {
      float cs_ = 0.f;
      for (int r = 0; r < QT && q0 + r < chunk; ++r) cs_ += wt[r * tq + tid];
      colw[tid] += cs_;
    } else if (tid >= MAX_Q && tid < MAX_Q + QT && q0 + tid - MAX_Q < chunk) {
      const int r = tid - MAX_Q;
      float rs = 0.f;
      for (int t = 0; t < tmax; ++t) rs += wt[r * tq + t];
      dseg[q0 + r] = rs;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = lane + 32 * j;
        if (t < tmax) wt[(warp * 4 + i) * tq + t] = dgr[i][j];
      }
    __syncthreads();
    const int rows = min(QT, chunk - q0);
    // (c) du_intra_t += sum_q M_qt dy_q
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int t = warp + 8 * k;
      if (t < tmax) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r)
          s += mt[r * tq + t] * ys[(q0 + r) * xp + lane];
        dur[k] += s;
      }
    }
    // (d) dC of the tile's rows: e^{seg_q} dy_q S_c + sum_t dG_qt B_t
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i, q = q0 + r;
      float cd = 0.f;
      if (q < chunk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          if (c >= n) continue;
          float st = 0.f;
          for (int pp = 0; pp < PT && p0 + pp < p; ++pp)
            st += ys[q * xp + pp] * sc[(size_t)(p0 + pp) * n + c];
          st *= eseg[q];
          cd += cs[q * np + c] * st;
          float v = st;
          for (int t = 0; t <= q; ++t) v += wt[r * tq + t] * bs[t * np + c];
          A.part_c[(((tok0 + q) * h + hh) * A.npt + pt) * n + c] = v;
        }
      }
      cd = warp_sum(cd);
      if (lane == 0 && q < chunk) cdot[q] = cd;
    }
    // (e) dB_t += sum_q dG_qt C_q
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int t = warp + 8 * k;
      if (t >= tmax) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (c >= n) continue;
        float s = 0.f;
        for (int r = 0; r < rows; ++r)
          s += wt[r * tq + t] * cs[(q0 + r) * np + c];
        dbr[k][j] += s;
      }
    }
    __syncthreads();  // mt and wt are rewritten by the next tile
  }

  // dS_{c+1} of the block's rows into the tile space; <dS_{c+1}, S_c>
  float* dss = mt;  // [PT][N + 1]
  float dot = 0.f;
  for (int i = tid; i < PT * n; i += THREADS) {
    const int r = i / n, c = i - r * n;
    float v = 0.f;
    if (p0 + r < p) {
      v = dsc[(size_t)(p0 + r) * n + c];
      dot += v * sc[(size_t)(p0 + r) * n + c];
    }
    dss[r * np + c] = v;
  }
  dot = warp_sum(dot);
  if (lane == 0) red[warp] = dot;
  __syncthreads();
  // (f) du_state, du, dx, and the ddt and dseg terms of each row t
  float* dxg = static_cast<float*>(A.dx);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int t = warp + 8 * k;
    if (t >= chunk) continue;  // warp-uniform
    float ds = 0.f;
    for (int c = 0; c < n; ++c) ds += bs[t * np + c] * dss[lane * np + c];
    ds *= wdec[t];
    const float du = dur[k] + ds;
    const float xv = xs[t * xp + lane];
    const float us = warp_sum(dts[t] * xv * ds);
    const float xd = warp_sum(xv * du);
    if (p0 + lane < p) dxg[((tok0 + t) * h + hh) * p + p0 + lane] = dts[t] * du;
    if (lane == 0) {
      sstate[t] = us;
      ddtx[t] = xd;
    }
  }
  // (g) dB_t += dt_t e^{total-seg_t} x_t dS_{c+1}
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int t = warp + 8 * k;
    if (t >= chunk) continue;
    const float w = dts[t] * wdec[t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      if (c >= n) continue;
      float s = 0.f;
      for (int pp = 0; pp < PT; ++pp) s += xs[t * xp + pp] * dss[pp * np + c];
      A.part_b[(((tok0 + t) * h + hh) * A.npt + pt) * n + c] =
          dbr[k][j] + w * s;
    }
  }
  __syncthreads();
  if (warp == 0) {
    for (int t = lane; t < chunk; t += 32)
      dseg[t] = dseg[t] - colw[t] + cdot[t] - sstate[t];
    float d = 0.f;
    for (int w = 0; w < 8; ++w) d += red[w];
    __syncwarp();
    finish_chunk(A, dseg, sstate, ddtx, dts, d, expf(seg[chunk - 1]), bb, ic,
                 hh, pt, lane);
  }
}

// ---------------------------------------------------------------------------
// the bf16 body on tensor cores
// ---------------------------------------------------------------------------

namespace tc_body {

constexpr int PT = 64;          // state rows of a chunk block
constexpr int PAD = 8;          // bf16 elements (16 bytes) after each row
constexpr int LDN = MAX_N + PAD;
constexpr int LDP = PT + PAD;   // row of x and dy in the chunk block
constexpr int LDV = PASS_PT + PAD;  // row of x or dy in a pass block
constexpr int KN = MAX_N / 16;  // k-steps over the state
constexpr int KP = PT / 16;     // k-steps over the state rows
constexpr float LOG2E = 1.4426950408889634f;

// Pass block: two stages of {the chunk operand [qp][LDN] (B or C), the
// vector side [qp][LDV] (x or dy), dt [MAX_Q]}, then seg, exp(seg) and
// exp(total - seg) [MAX_Q]
__host__ __device__ inline size_t pass_stage_bytes(int qp) {
  return 2 * ((size_t)qp * LDN + (size_t)qp * LDV) + 4 * (size_t)MAX_Q;
}
__host__ inline size_t pass_smem_bytes(int qp) {
  return 2 * pass_stage_bytes(qp) + 3 * 4 * MAX_Q;
}

// Chunk block: C, B [qp][LDN]; x, dy [qp][LDP]; S_c and dS_{c+1} hi/lo
// [PT][LDN]; f32: dt, seg, exp(seg), exp(total - seg), dseg, sstate,
// ddtx, two C . dC_state halves [MAX_Q], the column sums of W [8][MAX_Q],
// 8 warp partials
struct Layout {
  size_t c, b, x, y, sh, sl, dh, dl, f32, bytes;
  __host__ __device__ explicit Layout(int qp) {
    const size_t mat = 2 * (size_t)qp * LDN, vec = 2 * (size_t)qp * LDP;
    const size_t st = 2 * (size_t)PT * LDN;
    c = 0;
    b = mat;
    x = 2 * mat;
    y = x + vec;
    sh = y + vec;
    sl = sh + st;
    dh = sl + st;
    dl = dh + st;
    f32 = dl + st;
    bytes = f32 + 4 * (17 * (size_t)MAX_Q + 8);
  }
};

}  // namespace tc_body

// rows x cols bf16 from global (row stride ``ld`` elements, the first
// ``rows`` rows and ``cols`` columns valid) into shared memory [.][lds],
// zero elsewhere up to ``rows_pad`` x ``cols_pad``.  When ``vec`` (every
// row a whole number of 16-byte pieces, 16-byte aligned) by cp.async,
// zero-filled by a source size of 0: the caller commits and waits, so
// that every tile of a block is in flight at once; else element by
// element.
__device__ void load_tile(__nv_bfloat16* dst, int lds,
                          const __nv_bfloat16* src, size_t ld, int rows,
                          int cols, int rows_pad, int cols_pad, bool vec) {
  if (vec) {
    const int cpr = cols_pad / 8;
    for (int i = threadIdx.x; i < rows_pad * cpr; i += THREADS) {
      const int t = i / cpr, c = (i - t * cpr) * 8;
      const bool ok = t < rows && c < cols;
      cp_async16(dst + t * lds + c, src + (ok ? t * ld + c : 0), ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += THREADS) {
      const int t = i / cols_pad, c = i - t * cols_pad;
      dst[t * lds + c] = t < rows && c < cols ? src[t * ld + c] : zero;
    }
  }
}

// The two sequential passes, bf16 (grid as ssd_bwd_pass_fma); the next
// chunk's tiles land in the other of two stages (cp.async) while this
// one is scanned, and two blocks share an SM (at most 128 registers a
// thread), so that one's decays and barriers overlap the other's
// products.  Warp w holds
// rows 16 (w / 4) + {qr, qr + 8} and columns 32 (w % 4) + 8 j + 2 qc + {0,
// 1} of the block's 32 x 128 carried value in f32 registers; each chunk
// adds (v w)^T . M with v = x, w = dt e^{total-seg}, M = B (state) or v =
// dy, w = e^{seg}, M = C (cotangent): v^T by ldmatrix.trans, scaled and
// split into hi + lo in registers; M by ldmatrix.trans.
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_pass_tc(Args A, int vec) {
  using namespace tc_body;
  const int bb = blockIdx.x;
  const int hh = blockIdx.y;
  const int tiles = (A.p + PASS_PT - 1) / PASS_PT;
  const bool cot = blockIdx.z >= tiles;
  const int p0 = (blockIdx.z - (cot ? tiles : 0)) * PASS_PT;
  const int grp = hh / (A.h / A.g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qr = lane >> 2, qc = lane & 3;
  const int chunk = A.chunk, n = A.n, h = A.h, p = A.p, g = A.g;
  const int qp = round16(chunk), nb = qp / 16;
  const __nv_bfloat16* mat =
      static_cast<const __nv_bfloat16*>(cot ? A.cm : A.bm);
  const __nv_bfloat16* vsrc =
      static_cast<const __nv_bfloat16*>(cot ? A.dy : A.x);
  float* out = cot ? A.dstates : A.states;
  const float* start = cot ? A.dfin : A.init;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stage = pass_stage_bytes(qp);
  auto ms_at = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + st * stage);
  };
  auto vs_at = [&](int st) { return ms_at(st) + qp * LDN; };
  auto dts_at = [&](int st) {
    return reinterpret_cast<float*>(vs_at(st) + qp * LDV);
  };
  float* seg = reinterpret_cast<float*>(smem_raw + 2 * stage);
  float* eseg = seg + MAX_Q;
  float* wdec = eseg + MAX_Q;
  // chunk k of the pass (in its order) into stage k & 1, in flight
  auto fetch = [&](int k) {
    const int ic = cot ? A.nc - 1 - k : k;
    const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
    load_tile(ms_at(k & 1), LDN, mat + (tok0 * g + grp) * n, (size_t)g * n,
              chunk, n, qp, MAX_N, vec);
    load_tile(vs_at(k & 1), LDV, vsrc + (tok0 * h + hh) * p + p0,
              (size_t)h * p, chunk, min(PASS_PT, p - p0), qp, PASS_PT, vec);
    float* dts = dts_at(k & 1);
    for (int t = tid; t < MAX_Q; t += THREADS)
      cp_async4(dts + t, A.dt + (t < chunk ? (tok0 + t) * h + hh : 0),
                t < chunk);
    cp_async_commit();
  };

  const int pm = warp >> 2, nq = warp & 3;
  const bool live = p0 + pm * 16 < p && nq * 32 < n;
  const size_t state0 = ((size_t)bb * h + hh) * p;
  float sr[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = p0 + pm * 16 + qr + (e >> 1) * 8;
      const int c = nq * 32 + j * 8 + qc * 2 + (e & 1);
      sr[j][e] = start != nullptr && r < p && c < n
                     ? start[(state0 + r) * n + c] : 0.f;
    }
  fetch(0);
  for (int k = 0; k < A.nc; ++k) {
    const int ic = cot ? A.nc - 1 - k : k;
    const __nv_bfloat16* ms = ms_at(k & 1);
    const __nv_bfloat16* vs = vs_at(k & 1);
    const float* dts = dts_at(k & 1);
    cp_async_wait<0>();
    // chunk k has landed, and every warp is done with chunk k - 1: its
    // stage takes chunk k + 1 while this one is scanned
    __syncthreads();
    if (k + 1 < A.nc) fetch(k + 1);
    if (warp == 0) {
      chunk_decays(dts, A.a[hh], chunk, MAX_Q, lane, seg, eseg, wdec);
      // the state pass weighs x by dt e^{total-seg}: into wdec
      if (!cot)
        for (int t = lane; t < MAX_Q; t += 32) wdec[t] *= dts[t];
    }
    __syncthreads();
    const float* w = cot ? eseg : wdec;
    float* dst = out + (((size_t)bb * A.nc + ic) * h + hh) * (size_t)p * n;
    if (live) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = p0 + pm * 16 + qr + (e >> 1) * 8;
          const int c = nq * 32 + j * 8 + qc * 2 + (e & 1);
          if (r < p && c < n) dst[(size_t)r * n + c] = sr[j][e];
        }
      const float dec = expf(seg[chunk - 1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sr[j][e] *= dec;
      for (int kk = 0; kk < nb; ++kk) {
        uint32_t av[4];
        ldmatrix_x4_trans(
            av, vs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDV +
                    pm * 16 + ((lane >> 3) & 1) * 8);
        const int t0 = kk * 16 + qc * 2;
        const float2 w0 = make_float2(w[t0], w[t0 + 1]);
        const float2 w1 = make_float2(w[t0 + 8], w[t0 + 9]);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
          const float2 ww = i < 2 ? w0 : w1;
          split_bf16(v.x * ww.x, v.y * ww.y, ah[i], al[i]);
        }
#pragma unroll
        for (int dn = 0; dn < 2; ++dn) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, ms + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                      nq * 32 + dn * 16 + (lane >> 4) * 8);
          mma_bf16_16816(sr[2 * dn], ah, bf[0], bf[1]);
          mma_bf16_16816(sr[2 * dn], al, bf[0], bf[1]);
          mma_bf16_16816(sr[2 * dn + 1], ah, bf[2], bf[3]);
          mma_bf16_16816(sr[2 * dn + 1], al, bf[2], bf[3]);
        }
      }
    }
  }
  if (cot && live) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = p0 + pm * 16 + qr + (e >> 1) * 8;
        const int c = nq * 32 + j * 8 + qc * 2 + (e & 1);
        if (r < p && c < n) A.dinit[(state0 + r) * n + c] = sr[j][e];
      }
  }
}

// A fragments (16 rows from row ``r0``, k-step ``kk``) of a row-major
// bf16 tile in shared memory
__device__ __forceinline__ void frag_a(uint32_t (&f)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int r0, int kk, int lane) {
  ldmatrix_x4(f, base + (r0 + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8);
}
// B fragments of two 8-column tiles (columns c0 .. c0 + 15) for k-step kk,
// from a tile stored [column][k] (k contiguous)
__device__ __forceinline__ void frag_b_nk(uint32_t (&f)[4],
                                          const __nv_bfloat16* base, int ld,
                                          int c0, int kk, int lane) {
  ldmatrix_x4(f, base + (c0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                     kk * 16 + ((lane >> 3) & 1) * 8);
}
// the same from a tile stored [k][column] (columns contiguous)
__device__ __forceinline__ void frag_b_kn(uint32_t (&f)[4],
                                          const __nv_bfloat16* base, int ld,
                                          int c0, int kk, int lane) {
  ldmatrix_x4_trans(f, base + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               ld + c0 + (lane >> 4) * 8);
}
// a 16 x 16 f32 accumulator tile (two 8-column tiles) split into the hi and
// lo A fragments of the next product
__device__ __forceinline__ void split_tile(const float (&s)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(s[0][0], s[0][1], hi[0], lo[0]);
  split_bf16(s[0][2], s[0][3], hi[1], lo[1]);
  split_bf16(s[1][0], s[1][1], hi[2], lo[2]);
  split_bf16(s[1][2], s[1][3], hi[3], lo[3]);
}
__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Every chunk's gradients, bf16.  Grid (B * nc, H, ceil(P / 64)); 8 warps.
// Every tile the block reads is in flight at once (cp.async), and the S_c
// and dS_{c+1} loads of a thread are issued in batches.  The warps then
// take the items of steps 1 and 2 from one queue, costliest first.
// Step 1, key row block t: du_state = e^{total-seg}
// (B . dS^T), then for each query block q >= t the tiles G^T = B . C^T and
// (dy . x^T)^T, masked and decayed in registers into M^T and W^T, M^T split
// and multiplied with dy; W's row and column sums.  Step 2, the warps
// share 32 items: dC of a query block and dB of a key block, each for one
// 64-column half of N: the state term (dy . S_c or x . dS_{c+1}, scaled
// per row), then the causal dG (or dG^T) tiles from dy . x^T, split and
// multiplied with B (or C).  Step 3, warp 0: dseg, ddt and da.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_tc(Args A, int vec) {
  using namespace tc_body;
  const int bb = blockIdx.x / A.nc;
  const int ic = blockIdx.x % A.nc;
  const int hh = blockIdx.y;
  const int pt = blockIdx.z;
  const int p0 = pt * PT;
  const int grp = hh / (A.h / A.g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qr = lane >> 2, qc = lane & 3;
  const int chunk = A.chunk, n = A.n, h = A.h, p = A.p, g = A.g;
  const int qp = round16(chunk), nb = qp / 16;
  const int kn = round16(n) / 16;  // k-steps over N that hold data
  const Layout lay(qp);
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
  const size_t sbase = (((size_t)bb * A.nc + ic) * h + hh) * (size_t)p * n;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto bf = [&](size_t off) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + off);
  };
  __nv_bfloat16 *cs = bf(lay.c), *bs = bf(lay.b), *xs = bf(lay.x),
                *ys = bf(lay.y), *sh = bf(lay.sh), *sl = bf(lay.sl),
                *dh = bf(lay.dh), *dl = bf(lay.dl);
  float* dts = reinterpret_cast<float*>(smem_raw + lay.f32);
  float* seg = dts + MAX_Q;
  float* eseg = seg + MAX_Q;
  float* wdec = eseg + MAX_Q;
  float* dseg = wdec + MAX_Q;    // - sum_q W_qt (step 1), then every term
  float* sstate = dseg + MAX_Q;  // u_t . du_state_t
  float* ddtx = sstate + MAX_Q;  // x_t . du_t
  float* cdot = ddtx + MAX_Q;    // [2][MAX_Q] C_q . dC_state_q per half
  float* colw = cdot + 2 * MAX_Q;  // [8][MAX_Q] sum_t W_qt per key block
  float* red = colw + 8 * MAX_Q;   // [8]

  load_tile(cs, LDN, static_cast<const __nv_bfloat16*>(A.cm) +
                         (tok0 * g + grp) * n, (size_t)g * n, chunk, n, qp,
            MAX_N, vec);
  load_tile(bs, LDN, static_cast<const __nv_bfloat16*>(A.bm) +
                         (tok0 * g + grp) * n, (size_t)g * n, chunk, n, qp,
            MAX_N, vec);
  load_tile(xs, LDP, static_cast<const __nv_bfloat16*>(A.x) +
                         (tok0 * h + hh) * p + p0, (size_t)h * p, chunk,
            min(PT, p - p0), qp, PT, vec);
  load_tile(ys, LDP, static_cast<const __nv_bfloat16*>(A.dy) +
                         (tok0 * h + hh) * p + p0, (size_t)h * p, chunk,
            min(PT, p - p0), qp, PT, vec);
  for (int t = tid; t < MAX_Q; t += THREADS)
    cp_async4(dts + t, A.dt + (t < chunk ? (tok0 + t) * h + hh : 0),
              t < chunk);
  cp_async_commit();
  // S_c and dS_{c+1}, split into hi/lo pairs, and their inner product;
  // each thread's loads of a batch are issued before any is used
  constexpr int PAIRS = PT * (MAX_N / 2), BATCH = PAIRS / (2 * THREADS);
  float dot = 0.f;
  for (int i0 = tid; i0 < PAIRS; i0 += BATCH * THREADS) {
    float2 sv[BATCH], dv[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * THREADS;
      const int r = i / (MAX_N / 2), c = (i - r * (MAX_N / 2)) * 2;
      sv[k] = dv[k] = make_float2(0.f, 0.f);
      if (p0 + r < p) {
        const size_t at = sbase + (size_t)(p0 + r) * n + c;
        if (c < n) {
          sv[k].x = A.states[at];
          dv[k].x = A.dstates[at];
        }
        if (c + 1 < n) {
          sv[k].y = A.states[at + 1];
          dv[k].y = A.dstates[at + 1];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * THREADS;
      const int r = i / (MAX_N / 2), c = (i - r * (MAX_N / 2)) * 2;
      dot += sv[k].x * dv[k].x + sv[k].y * dv[k].y;
      uint32_t hi, lo;
      split_bf16(sv[k].x, sv[k].y, hi, lo);
      *reinterpret_cast<uint32_t*>(sh + r * LDN + c) = hi;
      *reinterpret_cast<uint32_t*>(sl + r * LDN + c) = lo;
      split_bf16(dv[k].x, dv[k].y, hi, lo);
      *reinterpret_cast<uint32_t*>(dh + r * LDN + c) = hi;
      *reinterpret_cast<uint32_t*>(dl + r * LDN + c) = lo;
    }
  }
  dot = warp_sum(dot);
  if (lane == 0) red[warp] = dot;
  __shared__ int next_item;  // the work queue of steps 1 and 2
  if (tid == 0) next_item = 0;
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0)
    chunk_decays(dts, A.a[hh], chunk, MAX_Q, lane, seg, eseg, wdec);
  __syncthreads();

  // ---- steps 1 and 2: one queue of items that the warps take in turn
  // (an integer counter: which warp takes an item changes nothing in its
  // arithmetic), the costliest first: step 1's 8 key blocks, then step
  // 2's 32 items by their number of causal tiles, 8 down to 1
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(&next_item, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= 8 + 32) break;
    if (item < 8) {
      // ---- step 1: du and W of key row block tb
      const int tb = item;
      if (tb >= nb) continue;
      uint32_t bfr[KN][4];  // B rows of the block, the A operand over N
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        if (kk < kn) frag_a(bfr[kk], bs, LDN, tb * 16, kk, lane);
      uint32_t xfr[KP][4];  // x rows of the block, the A operand over P
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        frag_a(xfr[kk], xs, LDP, tb * 16, kk, lane);
      float acc[8][4];      // du [16 x 64]
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // du_state = e^{total-seg_t} B_t . dS^T
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        if (kk >= kn) continue;
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t fh[4], fl[4];
          frag_b_nk(fh, dh, LDN, dp * 16, kk, lane);
          frag_b_nk(fl, dl, LDN, dp * 16, kk, lane);
          mma_bf16_16816(acc[2 * dp], bfr[kk], fh[0], fh[1]);
          mma_bf16_16816(acc[2 * dp], bfr[kk], fl[0], fl[1]);
          mma_bf16_16816(acc[2 * dp + 1], bfr[kk], fh[2], fh[3]);
          mma_bf16_16816(acc[2 * dp + 1], bfr[kk], fl[2], fl[3]);
        }
      }
      float us[2] = {0.f, 0.f};  // u_t . du_state_t of rows qr, qr + 8
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = tb * 16 + qr + hr * 8;
        const float wv = wdec[t];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = acc[j][2 * hr + e];
            v *= wv;
            us[hr] += bf16_at(xs + t * LDP + j * 8 + qc * 2 + e) * v;
          }
        us[hr] *= dts[t];
      }
      float rw[2] = {0.f, 0.f};  // sum_q W_qt of rows qr, qr + 8
      for (int qb = tb; qb < nb; ++qb) {
        float gs[2][4], ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) gs[nt][e] = ds[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          if (kk >= kn) continue;
          uint32_t f[4];
          frag_b_nk(f, cs, LDN, qb * 16, kk, lane);
          mma_bf16_16816(gs[0], bfr[kk], f[0], f[1]);
          mma_bf16_16816(gs[1], bfr[kk], f[2], f[3]);
        }
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {
          uint32_t f[4];
          frag_b_nk(f, ys, LDP, qb * 16, kk, lane);
          mma_bf16_16816(ds[0], xfr[kk], f[0], f[1]);
          mma_bf16_16816(ds[1], xfr[kk], f[2], f[3]);
        }
        // M^T = G^T L^T and W^T = M^T o (dy . u^T)^T, selected to 0 off
        // the causal triangle and past the chunk
        float cw[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = tb * 16 + qr + (e >> 1) * 8;
            const int q = qb * 16 + nt * 8 + qc * 2 + (e & 1);
            float m = 0.f, w = 0.f;
            if (t <= q && q < chunk) {
              m = gs[nt][e] * exp2_approx((seg[q] - seg[t]) * LOG2E);
              w = m * ds[nt][e] * dts[t];
            }
            gs[nt][e] = m;
            rw[e >> 1] += w;
            cw[nt][e & 1] += w;
          }
        // column sums over the block's 16 rows: lanes of one qc
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = cw[nt][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (qr == 0) colw[tb * MAX_Q + qb * 16 + nt * 8 + qc * 2 + e] = v;
          }
        uint32_t mh[4], ml[4];
        split_tile(gs, mh, ml);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t f[4];
          frag_b_kn(f, ys, LDP, dp * 16, qb, lane);
          mma_bf16_16816(acc[2 * dp], mh, f[0], f[1]);
          mma_bf16_16816(acc[2 * dp], ml, f[0], f[1]);
          mma_bf16_16816(acc[2 * dp + 1], mh, f[2], f[3]);
          mma_bf16_16816(acc[2 * dp + 1], ml, f[2], f[3]);
        }
      }
      // dx = dt du; x . du; the row terms of dseg
      float xd[2] = {0.f, 0.f};
      __nv_bfloat16* dxg = static_cast<__nv_bfloat16*>(A.dx);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = tb * 16 + qr + hr * 8;
        const float dtv = dts[t];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pp = j * 8 + qc * 2 + e;
            const float du = acc[j][2 * hr + e];
            xd[hr] += bf16_at(xs + t * LDP + pp) * du;
            if (t < chunk && p0 + pp < p)
              dxg[((tok0 + t) * h + hh) * p + p0 + pp] =
                  __float2bfloat16(dtv * du);
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float a_ = us[hr], b_ = xd[hr], c_ = rw[hr];
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          a_ += __shfl_xor_sync(0xffffffffu, a_, o);
          b_ += __shfl_xor_sync(0xffffffffu, b_, o);
          c_ += __shfl_xor_sync(0xffffffffu, c_, o);
        }
        const int t = tb * 16 + qr + hr * 8;
        if (qc == 0) {
          sstate[t] = a_;
          ddtx[t] = b_;
          dseg[t] = -c_;
        }
      }
      continue;
    }
    // ---- step 2: dC of query block rb (tiles rb + 1), or dB of key block
    // rb (tiles nb - rb), for the 64 state columns of half nh
    const int qi = item - 8, cost = 8 - qi / 4;
    const bool is_c = qi % 4 < 2;
    const int nh = qi & 1, rb = is_c ? cost - 1 : nb - cost;
    if (rb < 0 || rb >= nb || nh * 64 >= n) continue;  // warp-uniform
    const __nv_bfloat16* own = is_c ? ys : xs;    // the block's rows
    const __nv_bfloat16* other = is_c ? xs : ys;  // the rows it pairs with
    uint32_t rf[KP][4];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      frag_a(rf[kk], own, LDP, rb * 16, kk, lane);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // the state term: dy . S_c (dC) or x . dS_{c+1} (dB)
    const __nv_bfloat16* th = is_c ? sh : dh;
    const __nv_bfloat16* tl = is_c ? sl : dl;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t fh[4], fl[4];
        frag_b_kn(fh, th, LDN, nh * 64 + dn * 16, kk, lane);
        frag_b_kn(fl, tl, LDN, nh * 64 + dn * 16, kk, lane);
        mma_bf16_16816(acc[2 * dn], rf[kk], fh[0], fh[1]);
        mma_bf16_16816(acc[2 * dn], rf[kk], fl[0], fl[1]);
        mma_bf16_16816(acc[2 * dn + 1], rf[kk], fh[2], fh[3]);
        mma_bf16_16816(acc[2 * dn + 1], rf[kk], fl[2], fl[3]);
      }
    float cd[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rb * 16 + qr + hr * 8;
      const float sc = is_c ? eseg[r] : dts[r] * wdec[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[j][2 * hr + e];
          v *= sc;
          if (is_c)
            cd[hr] += bf16_at(cs + r * LDN + nh * 64 + j * 8 + qc * 2 + e) * v;
        }
    }
    if (is_c) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float v = cd[hr];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (qc == 0) cdot[nh * MAX_Q + rb * 16 + qr + hr * 8] = v;
      }
    }
    // the causal tiles: dG (rows q, columns t <= q) for dC, dG^T (rows t,
    // columns q >= t) for dB, from (dy . x^T) or (x . dy^T)
    const __nv_bfloat16* mul = is_c ? bs : cs;
    const int j0 = is_c ? 0 : rb, j1 = is_c ? rb : nb - 1;
    for (int jb = j0; jb <= j1; ++jb) {
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        uint32_t f[4];
        frag_b_nk(f, other, LDP, jb * 16, kk, lane);
        mma_bf16_16816(s[0], rf[kk], f[0], f[1]);
        mma_bf16_16816(s[1], rf[kk], f[2], f[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rb * 16 + qr + (e >> 1) * 8;
          const int cl = jb * 16 + nt * 8 + qc * 2 + (e & 1);
          const int q = is_c ? r : cl, t = is_c ? cl : r;
          s[nt][e] = t <= q && q < chunk
                         ? s[nt][e] * dts[t] *
                               exp2_approx((seg[q] - seg[t]) * LOG2E)
                         : 0.f;
        }
      uint32_t gh[4], gl[4];
      split_tile(s, gh, gl);
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t f[4];
        frag_b_kn(f, mul, LDN, nh * 64 + dn * 16, jb, lane);
        mma_bf16_16816(acc[2 * dn], gh, f[0], f[1]);
        mma_bf16_16816(acc[2 * dn], gl, f[0], f[1]);
        mma_bf16_16816(acc[2 * dn + 1], gh, f[2], f[3]);
        mma_bf16_16816(acc[2 * dn + 1], gl, f[2], f[3]);
      }
    }
    float* part = is_c ? A.part_c : A.part_b;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rb * 16 + qr + hr * 8;
      if (r >= chunk) continue;
      float* dst = part + (((tok0 + r) * h + hh) * A.npt + pt) * n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nh * 64 + j * 8 + qc * 2 + e;
          if (c < n) dst[c] = acc[j][2 * hr + e];
        }
    }
  }
  __syncthreads();

  // ---- step 3: dseg, then ddt and da
  if (warp == 0) {
    for (int q = lane; q < chunk; q += 32) {
      float v = dseg[q] - sstate[q] + cdot[q];
      if (n > 64) v += cdot[MAX_Q + q];
      for (int tb = 0; tb <= q / 16; ++tb) v += colw[tb * MAX_Q + q];
      dseg[q] = v;
    }
    float d = 0.f;
    for (int w = 0; w < 8; ++w) d += red[w];
    __syncwarp();
    finish_chunk(A, dseg, sstate, ddtx, dts, d, expf(seg[chunk - 1]), bb, ic,
                 hh, pt, lane);
  }
}

// ---------------------------------------------------------------------------
// the reduction: every partial summed in a fixed order, rounded once
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce(Args A) {
  const size_t nbc = (size_t)A.b * A.seqlen * A.g * A.n;
  const size_t ndt = (size_t)A.b * A.seqlen * A.h;
  const size_t total = 2 * nbc + ndt + A.h;
  const int rep = A.h / A.g, npt = A.npt, n = A.n;
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    if (i < 2 * nbc) {
      const bool is_c = i >= nbc;
      const size_t j = is_c ? i - nbc : i;
      const int c = (int)(j % n);
      const size_t bt = j / n / A.g;  // (b, t)
      const int grp = (int)(j / n % A.g);
      const float* part = is_c ? A.part_c : A.part_b;
      float s = 0.f;
      for (int r = 0; r < rep; ++r)
        for (int k = 0; k < npt; ++k)
          s += part[((bt * A.h + grp * rep + r) * npt + k) * n + c];
      (is_c ? static_cast<T*>(A.dc) : static_cast<T*>(A.db))[j] =
          from_f32<T>(s);
    } else if (i < 2 * nbc + ndt) {
      const size_t j = i - 2 * nbc;
      float s = 0.f;
      for (int k = 0; k < npt; ++k) s += A.part_dt[j * npt + k];
      A.ddt[j] = s;
    } else {
      const int hh = (int)(i - 2 * nbc - ndt);
      const size_t cnt = (size_t)A.b * A.nc * npt;
      float s = 0.f;
      for (size_t k = 0; k < cnt; ++k) s += A.part_da[hh * cnt + k];
      A.da[hh] = s;
    }
  }
}

int launch(Args A, bool bf16, cudaStream_t st) {
  const int pass_tiles = (A.p + PASS_PT - 1) / PASS_PT;
  const dim3 pass_grid(A.b, A.h, 2 * pass_tiles);
  const dim3 chunk_grid(A.b * A.nc, A.h, A.npt);
  cudaError_t err;
  if (bf16) {
    auto aligned = [](const void* q) {
      return reinterpret_cast<uintptr_t>(q) % 16 == 0;
    };
    const int vec = A.p % 8 == 0 && A.n % 8 == 0 && aligned(A.x) &&
                    aligned(A.dy) && aligned(A.bm) && aligned(A.cm);
    const int qp = round16(A.chunk);
    const size_t pass_smem = tc_body::pass_smem_bytes(qp);
    err = allow_smem(ssd_bwd_pass_tc, pass_smem);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_pass_tc<<<pass_grid, THREADS, pass_smem, st>>>(A, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = tc_body::Layout(qp).bytes;
    err = allow_smem(ssd_bwd_chunk_tc, smem);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_chunk_tc<<<chunk_grid, THREADS, smem, st>>>(A, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_reduce<__nv_bfloat16><<<1024, THREADS, 0, st>>>(A);
  } else {
    const size_t pass_smem =
        sizeof(float) * fma_body::pass_smem_floats(A.chunk, A.n);
    err = allow_smem(ssd_bwd_pass_fma, pass_smem);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_pass_fma<<<pass_grid, THREADS, pass_smem, st>>>(A);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem =
        sizeof(float) * fma_body::chunk_smem_floats(A.chunk, A.n);
    err = allow_smem(ssd_bwd_chunk_fma, smem);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_chunk_fma<<<chunk_grid, THREADS, smem, st>>>(A);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_reduce<float><<<1024, THREADS, 0, st>>>(A);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes, one per dtype: x, B, C, dy, dx, dB
// and dC in that dtype; dt, a, the states, the partials, ddt, da and
// d_initial_state f32.  ``init`` and ``dfin`` may be null (zeros).
// ``scratch`` holds, in f32 and in this order, the states and the
// cotangents [B, L / chunk, H, P, N] each, the dB and dC partials [B, L,
// H, npt, N] each, the ddt partials [B, L, H, npt] and the da partials
// [H, B * L / chunk * npt], with npt = ceil(P / tile) and tile 64 (bf16)
// or 32 (f32).  Each returns cudaGetLastError() after its launches (0 on
// success), or cudaErrorInvalidValue for a shape it does not take (an
// empty batch or sequence among them).
namespace {
int entry(const void* x, const void* dt, const void* a, const void* bm,
          const void* cm, const void* init, const void* dy, const void* dfin,
          void* scratch, void* dx, void* ddt, void* da, void* db, void* dc,
          void* dinit, int b, int seqlen, int h, int p, int g, int n,
          int chunk, void* stream, bool bf16) {
  using namespace repro_torch;
  if (chunk < 1 || chunk > MAX_Q || n < 1 || n > MAX_N || g < 1 || h % g ||
      seqlen % chunk || p < 1 || b < 1 || seqlen < 1)
    return (int)cudaErrorInvalidValue;
  Args A;
  A.x = x;
  A.dt = static_cast<const float*>(dt);
  A.a = static_cast<const float*>(a);
  A.bm = bm;
  A.cm = cm;
  A.init = static_cast<const float*>(init);
  A.dy = dy;
  A.dfin = static_cast<const float*>(dfin);
  A.b = b;
  A.seqlen = seqlen;
  A.h = h;
  A.p = p;
  A.g = g;
  A.n = n;
  A.chunk = chunk;
  A.nc = seqlen / chunk;
  const int tile = bf16 ? tc_body::PT : fma_body::PT;
  A.npt = (p + tile - 1) / tile;
  const size_t states = (size_t)b * A.nc * h * p * n;
  const size_t parts = (size_t)b * seqlen * h * A.npt * n;
  float* s = static_cast<float*>(scratch);
  A.states = s;
  A.dstates = s + states;
  A.part_b = s + 2 * states;
  A.part_c = A.part_b + parts;
  A.part_dt = A.part_c + parts;
  A.part_da = A.part_dt + (size_t)b * seqlen * h * A.npt;
  A.dx = dx;
  A.ddt = static_cast<float*>(ddt);
  A.da = static_cast<float*>(da);
  A.db = db;
  A.dc = dc;
  A.dinit = static_cast<float*>(dinit);
  return launch(A, bf16, static_cast<cudaStream_t>(stream));
}
}  // namespace

// The dynamic shared memory of each kernel at (chunk, n), in bytes, into
// out[4]: the tensor-core pass and chunk kernels, the FMA pass and chunk
// kernels.  Returns 0.
extern "C" int ssd_scan_bwd_smem(int chunk, int n, void* out) {
  using namespace repro_torch;
  int* o = static_cast<int*>(out);
  o[0] = (int)tc_body::pass_smem_bytes(round16(chunk));
  o[1] = (int)tc_body::Layout(round16(chunk)).bytes;
  o[2] = (int)(sizeof(float) * fma_body::pass_smem_floats(chunk, n));
  o[3] = (int)(sizeof(float) * fma_body::chunk_smem_floats(chunk, n));
  return 0;
}

extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* a,
                                const void* bm, const void* cm,
                                const void* init, const void* dy,
                                const void* dfin, void* scratch, void* dx,
                                void* ddt, void* da, void* db, void* dc,
                                void* dinit, int b, int seqlen, int h, int p,
                                int g, int n, int chunk, void* stream) {
  return entry(x, dt, a, bm, cm, init, dy, dfin, scratch, dx, ddt, da, db, dc,
               dinit, b, seqlen, h, p, g, n, chunk, stream, false);
}

extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* a,
                                 const void* bm, const void* cm,
                                 const void* init, const void* dy,
                                 const void* dfin, void* scratch, void* dx,
                                 void* ddt, void* da, void* db, void* dc,
                                 void* dinit, int b, int seqlen, int h, int p,
                                 int g, int n, int chunk, void* stream) {
  return entry(x, dt, a, bm, cm, init, dy, dfin, scratch, dx, ddt, da, db, dc,
               dinit, b, seqlen, h, p, g, n, chunk, stream, true);
}
