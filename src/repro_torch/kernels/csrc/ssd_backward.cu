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
// Bound on an NVIDIA H100 80GB HBM3 (700 W) at mamba2-1.3b's training
// shape (B4 L2048 H64 P64 G1 N128, chunk 128, bf16): the bytes that must
// move once (x, dy, B, C, dt in; dx, dB, dC, ddt out), 0.22 GB, 0.066 ms
// at 3.35 TB/s, above the least products this data needs (49.9 GFLOP: C.B^T
// once per group and chunk, dG summed over a group's heads before its two
// products with B and C), 0.050 ms at 989 TFLOP/s.  Hopper blocks carry
// nothing between them and the reverse scan over chunks is sequential, so
// the work is cut where it is not, in four launches:
//   1. ssd_bwd_decays: each (b, chunk, h)'s dt, seg, e^seg and
//      e^{total-seg}, one warp each; every later launch reads them.
//   2. ssd_bwd_pass: the two sequential passes in one launch (grid z picks
//      the pass): the states S_c entering every chunk, forward from the
//      initial state, and the cotangents dS_{c+1} leaving every chunk,
//      backward from d_final, into one slot per (b, chunk, h); the
//      cotangent pass writes d_initial_state = dS_0.  A CTA owns two heads
//      of a group, so that each chunk's B or C tile is loaded once for
//      both, and assembles each outgoing state in shared memory for one
//      bulk copy.  The states in HBM, 0.27 GB written and read at the
//      training shape, are the floor of this arrangement (0.16 ms); the
//      forward kernel and its serving times are untouched: the backward
//      recomputes the states.
//   3. ssd_bwd_dbc: dB and dC.  A thread-block cluster owns one (b, chunk,
//      group), one of the two and its 64-column slabs of N; its CTAs split
//      the group's heads (4 slices of 16 heads for each of two slabs at the
//      training shape; the cluster is sized from H / G, and where few
//      chunks would leave SMs idle, one cluster of 8 slices per slab) and
//      walk them in a fixed order.  Each of its two consumer warpgroups
//      owns 64 rows: per head the state term (e^seg dy.S_c, or
//      e^{total-seg} u.dS_{c+1}) is added to the rows' f32 accumulator, and
//      dG (or dG^T) is summed over the heads, so that dG.B (dG^T.C) is one
//      product per CTA, not one per head.  The CTAs' accumulators are then
//      summed through distributed shared memory in a fixed rank order, each
//      CTA rounding a slice of the columns: no per-head partial goes
//      through HBM.  The dC side writes each head's C_q .
//      dC_state_q, the one dseg term that needs dC per head, and with dS's
//      slab loaded beside S's, its share of <dS_{c+1}, S_c>.
//   4. ssd_bwd_dx: dx, ddt and a da partial per (b, chunk, h), clusters of
//      head slices that share B and C (more slices, down to a head a CTA,
//      where few chunks would leave SMs idle).  Per head and query half:
//      G^T = B.C^T and D^T = x.dy^T, W's row and column sums, M^T = G^T o
//      L^T; du = e^{total-seg} B.dS^T + M^T.dy.  G^T is formed per head:
//      held across heads (64 f32 a thread) it spilled at ptxas's 255
//      registers, and forming it again cost nothing measurable.  The
//      service warp closes each head (dseg, its reverse scan, ddt, the da
//      partial) while the others work on the next; the last CTA to finish
//      sums da.
// No float atomics: every sum over heads, cluster ranks, tiles and
// positions runs in a fixed order (an integer counter only picks which
// CTA sums da), so two runs are bitwise equal.  Scratch at the training
// shape: the two state slot arrays 134 MB each, the decays 8.4 MB, the C
// . dC_state and <dS, S> terms 4.3 MB.
//
// Two bodies, chosen by the wrapper from the dtype alone
// (kernels/ssd_backward.py::bwd_body):
//   * bf16 ("tensor-core"): every product on wgmma.  Two consumer
//     warpgroups and no producer warp (a ninth warp would cap each thread
//     at 168 registers): one warp of the lighter warpgroup serves the
//     ring, loading B and C once (TMA, multicast to every CTA of the
//     cluster, each CTA issuing a share of the boxes), then each head's x
//     and dy tiles (TMA) and its state image and decays (bulk copies)
//     through two mbarrier stages, so that the next head lands while this
//     one's products run; each head's products go out in one batch.
//     Tiles stay in the 128-byte-swizzled slab layout (hopper.cuh); the
//     passes write S_c and dS_{c+1} straight into that layout as bf16 hi +
//     lo planes, which the chunk launches read as wgmma operands.  B, C,
//     x and dy are exact as operands; the f32 factors (S_c, dS_{c+1}, M
//     and the summed dG) are split into bf16 hi + lo (~2^-16 relative): M
//     and dG come out of an accumulator and feed the next product as
//     wgmma's register A; the decays scale an accumulator's rows in f32.
//     Where a tensor's strides are not 16-byte multiples (P or N not a
//     multiple of 64) the service warp copies the same tiles with loads
//     and stores.
//   * f32 ("tf32x3"): the same launches and ownership (the passes on
//     FMAs), every chunk product on mma.sync m16n8k8 in TF32 with each
//     operand split hi + lo and three products (hi.hi + hi.lo + lo.hi,
//     ~2^-21 relative: one TF32 rounding would miss SSD_BWD_TOL), operands
//     read from global memory.

#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

namespace hp = hopper;

constexpr int MAX_Q = 128;  // chunk limit: the rows of every chunk tile
constexpr int MAX_N = 128;  // state limit
constexpr int MAX_P = 64;   // head-dim limit: one slab of state rows
constexpr int THREADS = 256;
constexpr int WG = 128;
constexpr int CONSUMERS = 2 * WG;  // two warpgroups of 64 chunk rows
constexpr int STAGES = 2;
constexpr int DEC = 4 * MAX_Q;  // decays of one (b, chunk, h)
// C . dC_state of one (b, chunk, h) per 64-column slab of N, then the
// slabs' partials of <dS_{c+1}, S_c> (and two floats of padding)
constexpr int CDOT = 2 * MAX_Q + 4;
constexpr int RED_LD = 64 + 4;  // floats per row of the reduction buffer
constexpr uint32_t IMG_SLAB = MAX_P * hp::SLAB_ROW;  // 64 state rows, bytes
constexpr float LOG2E = 1.4426950408889634f;

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
  float* states;      // [B, nc, H] slots: S_c entering chunk c
  float* dstates;     // [B, nc, H] slots: dS_{c+1} leaving chunk c
  float* dec;         // [B, nc, H][4][MAX_Q]: dt, seg, e^seg, e^{total-seg}
  float* cdot;        // [B, nc, H][CDOT]: C . dC_state, <dS, S> per slab
  float* part_da;     // [H][B * nc]
  unsigned* done;     // dx CTAs finished (the last sums da); 0 between calls
  void* dx;           // [B, L, H, P]
  float* ddt;         // [B, L, H]
  float* da;          // [H]
  void* db;           // [B, L, G, N]
  void* dc;           // [B, L, G, N]
  float* dinit;       // [B, H, P, N]
  int b, seqlen, h, p, g, n, chunk, nc;
  int ns;    // 64-column slabs of N
  int slot;  // floats of one state slot
  int cs;      // CTAs of a cluster
  int slices;  // the slices of a group's heads among them (dB / dC: cs / ns)
  int hs;      // heads of a CTA
};

// A state slot holds, per (b, chunk, h), S_c or dS_{c+1}: in the bf16 body
// the image the chunk launches load, two bf16 planes (hi, then lo) of
// 64 rows by ns slabs in the 128-byte-swizzled layout, rows past P and
// columns past N zero; in the f32 body [P][N] f32.  Either fits ns 4096
// floats.
__host__ __device__ inline int slot_floats(int n) {
  return hp::slabs(n) * 2 * (int)IMG_SLAB / 4;
}

__host__ __device__ inline size_t slot_index(const Args& A, int b, int c,
                                             int h) {
  return ((size_t)b * A.nc + c) * A.h + h;
}

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

// one warp writes the decays of a chunk, [4][MAX_Q], to ``dst``
__device__ void store_decays(float* dst, const float* dts, const float* seg,
                             const float* eseg, const float* wdec, int lane) {
  for (int t = lane; t < MAX_Q; t += 32) {
    dst[t] = dts[t];
    dst[MAX_Q + t] = seg[t];
    dst[2 * MAX_Q + t] = eseg[t];
    dst[3 * MAX_Q + t] = wdec[t];
  }
}

// byte offset of element (r, c) of a bf16 tile of ``rows`` rows in
// 128-byte-swizzled slabs
__host__ __device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// Each (b, chunk, h)'s decays [4][MAX_Q] (dt, seg, e^seg, e^{total-seg}),
// one warp each: every later launch reads them.
__global__ void __launch_bounds__(THREADS) ssd_bwd_decays(Args A) {
  __shared__ float buf[THREADS / 32][4][MAX_Q];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t item = (size_t)blockIdx.x * (THREADS / 32) + warp;
  if (item == 0 && lane == 0) *A.done = 0;
  if (item >= (size_t)A.b * A.nc * A.h) return;
  const int hh = (int)(item % A.h);
  const int ic = (int)(item / A.h % A.nc);
  const int bb = (int)(item / A.h / A.nc);
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * A.chunk;
  float(*w)[MAX_Q] = buf[warp];
  for (int t = lane; t < MAX_Q; t += 32)
    w[0][t] = t < A.chunk ? A.dt[(tok0 + t) * A.h + hh] : 0.f;
  __syncwarp();
  chunk_decays(w[0], A.a[hh], A.chunk, MAX_Q, lane, w[1], w[2], w[3]);
  store_decays(A.dec + item * DEC, w[0], w[1], w[2], w[3], lane);
}

// ---------------------------------------------------------------------------
// the passes
// ---------------------------------------------------------------------------

namespace fma_body {

constexpr int PT = 32;  // state rows of a pass block: one per lane

// Pass block: chunk operand [Q][N + 1] (B or C), the vector side [Q][PT + 1]
// (x or dy), the chunk's decays
__host__ inline size_t pass_smem_floats(int chunk, int n) {
  return (size_t)chunk * (n + 1) + (size_t)chunk * (PT + 1) + DEC;
}

}  // namespace fma_body

// The two sequential passes, f32.  Grid (B, H, 2 * ceil(P / 32)): z below
// ceil(P / 32) runs the state pass of tile z, above it the cotangent pass.
// A thread holds rows 4 warp + i and columns lane + 32 j of the block's
// 32 x N carried value; the slots take [P][N] f32.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_fma(Args A) {
  using namespace fma_body;
  const int bb = blockIdx.x;
  const int hh = blockIdx.y;
  const int tiles = (A.p + PT - 1) / PT;
  const bool cot = blockIdx.z >= tiles;
  const int p0 = (blockIdx.z - (cot ? tiles : 0)) * PT;
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
  float* dec = vs + chunk * (PT + 1);  // dt, seg, e^seg, e^{total-seg}

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
    for (int t = tid; t < DEC; t += THREADS)
      dec[t] = A.dec[slot_index(A, bb, ic, hh) * DEC + t];
    __syncthreads();
    // the carried value at this chunk's boundary
    float* dst = out + slot_index(A, bb, ic, hh) * A.slot;
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
      const float w = cot ? dec[2 * MAX_Q + t] : dec[t] * dec[3 * MAX_Q + t];
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
    const float etot = dec[2 * MAX_Q + chunk - 1];  // e^{total}
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sr[i][j] = etot * sr[i][j] + acc[i][j];
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

// ---------------------------------------------------------------------------
// the chunk launches: shared pieces
// ---------------------------------------------------------------------------

// Shared memory of a tensor-core chunk CTA, byte offsets from a
// 1024-aligned base: the B and C tiles [128 rows][N] once, then two
// stages of {x, dy [128][64], the state image (dB / dC: one slab of S_c,
// or of dS_{c+1}, and for dC the slab of dS_{c+1} too), the decays, C .
// dC_state per slab, the head's partial vectors (dx launch)}, then the
// barriers.  The dB / dC launch reuses the stages as its
// [128][RED_LD] f32 reduction buffer.
struct Lay {
  uint32_t bt, ct, stage, stage_bytes, x, y, img, dec, cd, vrow, vsst, vxd,
      vcol, vdot, bar, bytes;
  __host__ __device__ explicit Lay(int ns) {
    const uint32_t tile = hp::tile_bytes(MAX_Q, ns * 64);
    bt = 0;
    ct = tile;
    stage = 2 * tile;
    x = 0;
    y = hp::tile_bytes(MAX_Q, MAX_P);
    img = 2 * y;
    dec = img + 4 * IMG_SLAB;
    cd = dec + 4 * DEC;
    vrow = cd + 4 * CDOT;
    vsst = vrow + 4 * MAX_Q;
    vxd = vsst + 4 * MAX_Q;
    vcol = vxd + 4 * MAX_Q;  // [8 warps][MAX_Q]
    vdot = vcol + 8 * 4 * MAX_Q;
    stage_bytes = (vdot + 64 + 1023) / 1024 * 1024;
    bar = stage + STAGES * stage_bytes;
    bytes = bar + 8 * (2 * STAGES + 1) + 1024;  // and the alignment slack
  }
};

// The dynamic shared memory of the f32 chunk CTAs: each thread's 64 f32 of
// G^T (dx launch) or of the summed dG (dB / dC launch), then the dx
// launch's 32 of M and its partial vectors, or the dB / dC launch's
// reduction buffer
constexpr uint32_t F32_HELD_BYTES = 4 * 64 * CONSUMERS;
constexpr uint32_t F32_VEC_BYTES =
    F32_HELD_BYTES + 4 * 32 * CONSUMERS + 4 * (4 * MAX_Q + 8 * MAX_Q + 8);
constexpr uint32_t F32_RED_BYTES = F32_HELD_BYTES + 4 * MAX_Q * RED_LD;

__device__ __forceinline__ uint32_t smem_base(unsigned char*& generic) {
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  const uint32_t raw = smem_addr(smem_dyn);
  const uint32_t base = (raw + 1023) & ~1023u;
  generic = smem_dyn + (base - raw);
  return base;
}

// K-major wgmma operand: k16 step ``ks`` of a tile of ``rows`` rows in slabs
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int ks) {
  return hp::smem_desc(tile + (ks / 4) * rows * hp::SLAB_ROW + (ks % 4) * 32,
                       16, 1024);
}

// MN-major operand: rows [16 kk, 16 kk + 16) of one 64-column slab
__device__ __forceinline__ uint64_t desc_mn(uint32_t slab, int kk) {
  return hp::smem_desc(slab + kk * 16 * hp::SLAB_ROW, 8 * hp::SLAB_ROW, 1024);
}

// k16 step ``kk`` of a 64 x 64 f32 accumulator tile as the hi and lo bf16
// A operands of the next product
__device__ __forceinline__ void split_a(const float (&x)[32], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1], hi[i], lo[i]);
}

__device__ __forceinline__ float2 bf16x2_at(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 bf16x2_of(uint32_t v) {
  __nv_bfloat162 b;
  memcpy(&b, &v, 4);
  return __bfloat1622float2(b);
}

// ---- 3xTF32 products for the f32 body -------------------------------------

namespace tf32 {

__device__ __forceinline__ uint32_t cvt(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt(x);
  lo = cvt(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi.hi + hi.lo + lo.hi of one k8 step into the 8 columns at c
__device__ __forceinline__ void mma3(float* c, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(c, ah, h0, h1);
  mma(c, ah, l0, l1);
  mma(c, al, h0, h1);
}

// d[16 rows of the warp][64] (+)= A[16][K] . B[K][64], K a multiple of 8:
// fa(r, k) for the warp's row r, fb(k, col); the accumulator in the wgmma
// register layout (register 4 j + e: row lane / 4 + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2)
template <class FA, class FB>
__device__ __forceinline__ void mm(float (&d)[32], int k_len, FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < k_len; k0 += 8) {
    uint32_t ah[4], al[4];
    split(fa(g, k0 + t), ah[0], al[0]);
    split(fa(g + 8, k0 + t), ah[1], al[1]);
    split(fa(g, k0 + t + 4), ah[2], al[2]);
    split(fa(g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma3(&d[4 * j], ah, al, fb(k0 + t, 8 * j + g), fb(k0 + t + 4, 8 * j + g));
  }
}

// the same with A the warp's rows of a 64-column accumulator tile, its
// element i read by fa(i) (the tile is held in shared memory, so the k
// loop need not be unrolled): the accumulator's column pair (2 t, 2 t +
// 1) is the k8 step's (t, t + 4), so B's rows are read in that order
template <class FA, class FB>
__device__ __forceinline__ void mm_acc(float (&d)[32], FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int m = 0; m < 8; ++m) {
    uint32_t ah[4], al[4];
    split(fa(4 * m), ah[0], al[0]);
    split(fa(4 * m + 2), ah[1], al[1]);
    split(fa(4 * m + 1), ah[2], al[2]);
    split(fa(4 * m + 3), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma3(&d[4 * j], ah, al, fb(8 * m + 2 * t, 8 * j + g),
           fb(8 * m + 2 * t + 1, 8 * j + g));
  }
}

}  // namespace tf32

// Where a thread's accumulator element i lies in its warpgroup's 64 x 64
// tile: row 16 warp + lane / 4 + 8 (i / 2 % 2), column 8 (i / 4) + 2 (lane
// % 4) + i % 2
struct Frag {
  int r0, c0;  // the row and column of element 0
  __device__ Frag() {
    const int lane = threadIdx.x & 31;
    r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    c0 = 2 * (lane & 3);
  }
  __device__ __forceinline__ int row(int hr) const { return r0 + 8 * hr; }
  __device__ __forceinline__ int col(int jj) const { return 8 * jj + c0; }
};

// quad sum: the four lanes that hold one row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the sum over a warp's 8 row groups of a column partial
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// The end of one (b, chunk, h) of the dx launch, by one warp, from the
// head's partial vectors (row sums of W [MAX_Q], u . du_state, x . du,
// the column sums of W per consumer warp [nwarps][MAX_Q]), <dS_{c+1},
// S_c>, its decays and C . dC_state (a partial per slab of N, summed here
// in slab order): dseg, the
// chunk's last position's dtotal, the reverse cumulative sum d(a dt),
// whence ddt and the da partial.  ``nwarps`` consumer warps wrote.
__device__ void finish_head(const Args& A, const float* vrow,
                            const float* vsst, const float* vxd,
                            const float* vcol, float dot, const float* dec,
                            const float* cd, int nwarps, int bb, int ic,
                            int hh, int lane) {
  const int chunk = A.chunk;
  const float* dts = dec;
  float dv[4], sv = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = lane * 4 + k;
    float v = 0.f;
    if (t < chunk) {
      float cw = 0.f;
      for (int w = 0; w < nwarps; ++w) cw += vcol[w * MAX_Q + t];
      const float cdt = A.ns > 1 ? cd[t] + cd[MAX_Q + t] : cd[t];
      v = cw - vrow[t] + cdt - vsst[t];
      sv += vsst[t];
    }
    dv[k] = v;
  }
  const float s = warp_sum(sv);
  const float etot = dec[2 * MAX_Q + chunk - 1];  // e^{total}
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (lane * 4 + k == chunk - 1) dv[k] += etot * dot + s;
  // reverse inclusive scan: lane owns steps 4 lane .. 4 lane + 3
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    run += dv[k];
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
      A.ddt[(tok0 + t) * A.h + hh] = vxd[t] + av * dld;
      dap += dld * dts[t];
    }
  }
  dap = warp_sum(dap);
  if (lane == 0) A.part_da[(size_t)hh * A.b * A.nc + (size_t)bb * A.nc + ic] = dap;
}

// After every head of a dx CTA is closed, by all its threads: the CTA
// counts itself done, and the last of them sums every head's da partials
// over (b, chunk) -- four strided partial sums a head, combined in a
// fixed order: the counter picks which CTA sums, never the order of a
// sum -- then rearms the counter for the next call.
__device__ void finish_da(const Args& A) {
  __shared__ unsigned last;
  __syncthreads();  // every head's partial is written
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned ctas = gridDim.x * gridDim.y * gridDim.z;
    last = atomicAdd(A.done, 1u) == ctas - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int cnt = A.b * A.nc;
  const int q = threadIdx.x & 3;
  for (int h0 = 0; h0 < A.h; h0 += blockDim.x / 4) {
    const int hh = h0 + (int)threadIdx.x / 4;
    float s = 0.f;
    if (hh < A.h) {
      const float* pd = A.part_da + (size_t)hh * cnt;
#pragma unroll 8
      for (int k = q; k < cnt; k += 4) s += __ldcg(pd + k);
    }
    const float s1 = __shfl_down_sync(0xffffffffu, s, 1);
    const float s2 = __shfl_down_sync(0xffffffffu, s, 2);
    const float s3 = __shfl_down_sync(0xffffffffu, s, 3);
    if (q == 0 && hh < A.h) A.da[hh] = ((s + s1) + s2) + s3;
  }
  if (threadIdx.x == 0) *A.done = 0;
}

// ---- the tensor-core ring --------------------------------------------------

// The valid part of a [rows_tile][64 slabs] bf16 tile in swizzled slabs
// (the first ``rows`` rows and ``cols`` columns) from global (row stride
// ``ld`` elements), by one warp with loads and stores: the path of tensors
// whose strides TMA refuses.  The rest of the tile is the same for every
// chunk and was zeroed once (zero_smem).
__device__ void copy_tile(unsigned char* dst, int rows_tile,
                          const __nv_bfloat16* src, size_t ld, int rows,
                          int cols) {
  constexpr int U = 4;  // pieces a lane has in flight
  const int lane = threadIdx.x & 31;
  const int cpr = (cols + 7) / 8;  // 16-byte pieces of a row with data
  const int total = rows * cpr;
  for (int i0 = lane; i0 < total; i0 += 32 * U) {
    uint32_t v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u;
      const int r = i / cpr, c = (i % cpr) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = c + 2 * e;
        const float lo = i < total && c0 < cols
                             ? __bfloat162float(src[r * ld + c0])
                             : 0.f;
        const float hi = i < total && c0 + 1 < cols
                             ? __bfloat162float(src[r * ld + c0 + 1])
                             : 0.f;
        v[u][e] = pack_bf16(lo, hi);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u;
      if (i < total)
        *reinterpret_cast<uint4*>(dst + swz(rows_tile, i / cpr, (i % cpr) * 8)) =
            make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
  }
}

// ``bytes`` (a multiple of 16) of shared memory at ``dst`` set to zero by
// every thread of the block
__device__ void zero_smem(unsigned char* dst, uint32_t bytes) {
  for (uint32_t i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(0, 0, 0, 0);
}

// B and C of the cluster's (b, chunk, group) into every CTA of the
// cluster, by the service warp: each CTA expects the whole tiles on
// ``bar``; with TMA its rank issues every cs-th of the 2 ns boxes,
// multicast to the cluster; else each CTA copies its own.
__device__ void load_bc(const CUtensorMap* mb, const CUtensorMap* mc,
                        const Args& A, uint32_t base, unsigned char* sm,
                        const Lay& L, uint32_t bar, int bb, int ic, int grp,
                        int rank, int tma) {
  const int lane = threadIdx.x & 31;
  const uint32_t tile = hp::tile_bytes(MAX_Q, A.ns * 64);
  if (tma) {
    if (lane == 0) {
      hp::mbar_arrive_tx(bar, 2 * tile);
      for (int i = rank; i < 2 * A.ns; i += A.cs) {
        const int s = i % A.ns;
        const uint32_t dst = base + (i < A.ns ? L.bt : L.ct) + s * MAX_Q * 128;
        const CUtensorMap* m = i < A.ns ? mb : mc;
        if (A.cs > 1)
          hp::tma_load_4d_multicast(dst, m, s * hp::SLAB, grp, ic * A.chunk,
                                    bb, bar, (uint16_t)((1u << A.cs) - 1));
        else
          hp::tma_load_4d(dst, m, s * hp::SLAB, grp, ic * A.chunk, bb, bar);
      }
    } else {
      hp::mbar_arrive(bar);
    }
    return;
  }
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * A.chunk;
  for (int m = 0; m < 2; ++m)
    copy_tile(sm + (m == 0 ? L.bt : L.ct), MAX_Q,
              static_cast<const __nv_bfloat16*>(m == 0 ? A.bm : A.cm) +
                  (tok0 * A.g + grp) * A.n,
              (size_t)A.g * A.n, min(MAX_Q, A.chunk), A.n);
  hp::fence_proxy_async();  // the copies feed wgmma
  hp::mbar_arrive(bar);
}

// One head's stage: x and dy [128 rows][64] (TMA, or copies), the decays
// and the state image by bulk copies -- for the dB / dC launch only slab
// ``slab`` of its hi and lo planes (and of ``other``'s, dS_{c+1} for dC,
// after them), for the dx launch (``slab`` -1) the whole image and C .
// dC_state -- all completing on ``bar``; every service lane arrives once.
__device__ void load_head(const CUtensorMap* mx, const CUtensorMap* mdy,
                          const Args& A, uint32_t base, unsigned char* sm,
                          const Lay& L, uint32_t st, uint32_t bar,
                          const float* state, const float* other, int bb,
                          int ic, int hh, int slab, int tma) {
  const int lane = threadIdx.x & 31;
  const size_t slot = slot_index(A, bb, ic, hh);
  const bool with_cd = slab < 0;
  const uint32_t img_bytes =
      (with_cd ? 2 * A.ns : other != nullptr ? 4 : 2) * IMG_SLAB;
  const uint32_t tx = img_bytes + 4 * DEC + (with_cd ? 4 * CDOT : 0) +
                      (tma ? 2 * hp::tile_bytes(MAX_Q, MAX_P) : 0);
  const uint32_t sb = base + st;
  if (!tma) {
    const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * A.chunk;
    for (int m = 0; m < 2; ++m)
      copy_tile(sm + st + (m == 0 ? L.x : L.y), MAX_Q,
                static_cast<const __nv_bfloat16*>(m == 0 ? A.x : A.dy) +
                    (tok0 * A.h + hh) * A.p,
                (size_t)A.h * A.p, min(MAX_Q, A.chunk), A.p);
    hp::fence_proxy_async();  // the copies feed wgmma
  }
  if (lane == 0) {
    hp::mbar_arrive_tx(bar, tx);
    if (tma) {
      hp::tma_load_4d(sb + L.x, mx, 0, hh, ic * A.chunk, bb, bar);
      hp::tma_load_4d(sb + L.y, mdy, 0, hh, ic * A.chunk, bb, bar);
    }
    const unsigned char* img =
        reinterpret_cast<const unsigned char*>(state + slot * A.slot);
    if (with_cd) {
      hp::bulk_load(sb + L.img, img, img_bytes, bar);
      hp::bulk_load(sb + L.cd, A.cdot + slot * CDOT, 4 * CDOT, bar);
    } else {
      hp::bulk_load(sb + L.img, img + slab * IMG_SLAB, IMG_SLAB, bar);
      hp::bulk_load(sb + L.img + IMG_SLAB, img + (A.ns + slab) * IMG_SLAB,
                    IMG_SLAB, bar);
      if (other != nullptr) {
        const unsigned char* o =
            reinterpret_cast<const unsigned char*>(other + slot * A.slot);
        hp::bulk_load(sb + L.img + 2 * IMG_SLAB, o + slab * IMG_SLAB,
                      IMG_SLAB, bar);
        hp::bulk_load(sb + L.img + 3 * IMG_SLAB,
                      o + (A.ns + slab) * IMG_SLAB, IMG_SLAB, bar);
      }
    }
    hp::bulk_load(sb + L.dec, A.dec + slot * DEC, 4 * DEC, bar);
  } else {
    hp::mbar_arrive(bar);
  }
}

// ---------------------------------------------------------------------------
// the passes, bf16
// ---------------------------------------------------------------------------

// Shared memory of a tensor-core pass CTA, byte offsets from a 1024-aligned
// base: two stages of {B or C [128][N] (the chunk's, shared by the CTA's
// heads), x or dy of its two heads [2][128][64], their decays [2][DEC]},
// each head's outgoing state image, then the barriers
struct PassLay {
  uint32_t m, v, dec, stage_bytes, img, bar, bytes;
  __host__ __device__ explicit PassLay(int ns) {
    m = 0;
    v = hp::tile_bytes(MAX_Q, 64 * ns);
    dec = v + 2 * hp::tile_bytes(MAX_Q, MAX_P);
    stage_bytes = (dec + 2 * 4 * DEC + 1023) / 1024 * 1024;
    img = STAGES * stage_bytes;  // [2 heads][2 planes][ns slabs]
    bar = img + 2 * 2 * ns * IMG_SLAB;
    bytes = bar + 8 * 2 * STAGES + 1024;  // and the alignment slack
  }
};

// MN-major operand over every slab of a tile of ``rows`` rows: its rows
// [16 kk, 16 kk + 16)
__device__ __forceinline__ uint64_t desc_mn_tile(uint32_t tile, int rows,
                                                 int kk) {
  return hp::smem_desc(tile + kk * 16 * hp::SLAB_ROW, rows * hp::SLAB_ROW,
                       1024);
}

// Step ``k`` of a pass (chunk k forward, or nc - 1 - k backward) into
// stage ``st``: the chunk's B (state) or C (cotangent) tile and, per head
// of the CTA, its x or dy tile and its decays; by the service warp, every
// lane arriving once on ``bar``.
__device__ void load_step(const CUtensorMap* mm, const CUtensorMap* mv,
                          const Args& A, uint32_t base, unsigned char* sm,
                          const PassLay& L, uint32_t st, uint32_t bar, bool cot,
                          int k, int bb, int grp, int h0, int hpc, int tma) {
  const int lane = threadIdx.x & 31;
  const int ic = cot ? A.nc - 1 - k : k;
  const uint32_t sb = base + st;
  const uint32_t tile = hp::tile_bytes(MAX_Q, 64 * A.ns);
  const uint32_t tx = hpc * 4 * DEC +
                      (tma ? tile + hpc * hp::tile_bytes(MAX_Q, MAX_P) : 0);
  if (!tma) {
    const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * A.chunk;
    const int rows = min(MAX_Q, A.chunk);
    copy_tile(sm + st + L.m, MAX_Q,
              static_cast<const __nv_bfloat16*>(cot ? A.cm : A.bm) +
                  (tok0 * A.g + grp) * A.n,
              (size_t)A.g * A.n, rows, A.n);
    for (int w = 0; w < hpc; ++w)
      copy_tile(sm + st + L.v + w * hp::tile_bytes(MAX_Q, MAX_P), MAX_Q,
                static_cast<const __nv_bfloat16*>(cot ? A.dy : A.x) +
                    (tok0 * A.h + h0 + w) * A.p,
                (size_t)A.h * A.p, rows, A.p);
    hp::fence_proxy_async();  // the copies feed wgmma
  }
  if (lane == 0) {
    hp::mbar_arrive_tx(bar, tx);
    if (tma) {
      for (int sl = 0; sl < A.ns; ++sl)
        hp::tma_load_4d(sb + L.m + sl * MAX_Q * 128, mm, sl * hp::SLAB, grp,
                        ic * A.chunk, bb, bar);
      for (int w = 0; w < hpc; ++w)
        hp::tma_load_4d(sb + L.v + w * hp::tile_bytes(MAX_Q, MAX_P), mv, 0,
                        h0 + w, ic * A.chunk, bb, bar);
    }
    for (int w = 0; w < hpc; ++w)
      hp::bulk_load(sb + L.dec + w * 4 * DEC,
                    A.dec + slot_index(A, bb, ic, h0 + w) * DEC, 4 * DEC, bar);
  } else {
    hp::mbar_arrive(bar);
  }
}

// The two sequential passes, bf16 on wgmma.  Grid (B, H / hpc, 2): z 0 the
// state pass (S_c entering every chunk, forward from the initial state),
// z 1 the cotangent pass (dS_{c+1} leaving every chunk, backward from
// d_final, then d_initial_state); a CTA owns hpc (1 or 2) heads of one
// group, warpgroup w head h0 + w, so that the chunk's B or C tile is
// loaded once for both.  Per chunk a warpgroup writes its carried 64 x N
// value (f32 accumulators) to the chunk's slot as the bf16 hi and lo
// planes of the image the chunk launches load, scales it by e^{total}
// and adds (v w)^T . M (v = x, w = dt e^{total-seg}, M = B; or v = dy, w
// = e^seg, M = C): v^T by ldmatrix.trans from the swizzled tile, scaled
// and split hi + lo in registers as wgmma's A, M read MN-major.  The image
// is assembled in shared memory and written by one bulk copy, not by
// scattered 4-byte stores.  Warp 4, the service warp, keeps the next
// chunk's tiles landing (TMA) while this one's products run.
template <int NS>
__global__ void __launch_bounds__(CONSUMERS, 1)
ssd_bwd_pass_wg(const __grid_constant__ CUtensorMap mx,
                const __grid_constant__ CUtensorMap mdy,
                const __grid_constant__ CUtensorMap mb,
                const __grid_constant__ CUtensorMap mc, Args A, int tma,
                int hpc) {
  const PassLay L(NS);
  unsigned char* sm;
  const uint32_t base = smem_base(sm);
  const uint32_t full = base + L.bar, empty = full + 8 * STAGES;
  const bool cot = blockIdx.z == 1;
  const int bb = blockIdx.x;
  const int h0 = blockIdx.y * hpc;
  const int grp = h0 / (A.h / A.g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const bool svc = warp == 4;
  const CUtensorMap* mm = cot ? &mc : &mb;
  const CUtensorMap* mv = cot ? &mdy : &mx;
  if (!tma) zero_smem(sm, L.bar);  // tile and image padding
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 32);
      hp::mbar_init(empty + 8 * s, 4 * hpc);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  auto service = [&](int k) {  // after step k: its stage takes step k + 2
    const int st = k % STAGES;
    hp::mbar_wait(empty + 8 * st, (k / STAGES) & 1);
    if (k + STAGES < A.nc)
      load_step(mm, mv, A, base, sm, L, L.stage_bytes * st, full + 8 * st,
                cot, k + STAGES, bb, grp, h0, hpc, tma);
  };
  if (svc)
    for (int k = 0; k < STAGES && k < A.nc; ++k)
      load_step(mm, mv, A, base, sm, L, L.stage_bytes * k, full + 8 * k, cot,
                k, bb, grp, h0, hpc, tma);
  if (wg >= hpc) {
    if (svc)
      for (int k = 0; k < A.nc; ++k) service(k);
    return;
  }
  const int hh = h0 + wg;
  const int chunk = A.chunk, n = A.n, p = A.p;
  const Frag f;
  const int qc = lane & 3, pm = warp & 3;
  float* out = cot ? A.dstates : A.states;
  const float* start = cot ? A.dfin : A.init;
  const size_t state0 = ((size_t)bb * A.h + hh) * p;
  float sr[32 * NS];
#pragma unroll
  for (int i = 0; i < 32 * NS; ++i) {
    const int r = f.row((i >> 1) & 1), c = 8 * (i >> 2) + f.c0 + (i & 1);
    sr[i] = start != nullptr && r < p && c < n ? start[(state0 + r) * n + c]
                                               : 0.f;
  }
#pragma unroll 1
  for (int k = 0; k < A.nc; ++k) {
    const int st = k % STAGES;
    const int ic = cot ? A.nc - 1 - k : k;
    hp::mbar_wait(full + 8 * st, (k / STAGES) & 1);
    const uint32_t sb = base + st * L.stage_bytes;
    unsigned char* sg = sm + st * L.stage_bytes;
    const float* dec = reinterpret_cast<const float*>(sg + L.dec) + wg * DEC;
    // the carried value at this chunk's boundary, into its slot's image:
    // assembled in shared memory once the last chunk's copy has read it,
    // then one bulk copy by the warpgroup's first thread
    const bool lead = (threadIdx.x & (WG - 1)) == 0;
    if (lead) hp::bulk_wait<0, true>();
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
    unsigned char* im = sm + L.img + wg * 2 * NS * IMG_SLAB;
#pragma unroll
    for (int i = 0; i < 32 * NS; i += 2) {
      const int r = f.row((i >> 1) & 1), c = 8 * (i >> 2) + f.c0;
      if (r < p && c < n) {
        uint32_t hi, lo;
        split_bf16(sr[i], sr[i + 1], hi, lo);
        const uint32_t at = swz(MAX_P, r, c);
        *reinterpret_cast<uint32_t*>(im + at) = hi;
        *reinterpret_cast<uint32_t*>(im + NS * IMG_SLAB + at) = lo;
      }
    }
    hp::fence_proxy_async();  // the writes feed the bulk copy
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
    if (lead) {
      hp::bulk_store(out + slot_index(A, bb, ic, hh) * A.slot,
                     base + L.img + wg * 2 * NS * IMG_SLAB,
                     2 * NS * IMG_SLAB);
      hp::bulk_commit();
    }
    const float etot = dec[2 * MAX_Q + chunk - 1];  // e^{total}
#pragma unroll
    for (int i = 0; i < 32 * NS; ++i) sr[i] *= etot;
    // the weights of v's rows: dt e^{total-seg} (state), e^seg (cotangent)
    auto w2 = [&](int t) {
      return cot ? make_float2(t < chunk ? dec[2 * MAX_Q + t] : 0.f,
                               t + 1 < chunk ? dec[2 * MAX_Q + t + 1] : 0.f)
                 : make_float2(dec[t] * dec[3 * MAX_Q + t],
                               dec[t + 1] * dec[3 * MAX_Q + t + 1]);
    };
    const unsigned char* vt = sg + L.v + wg * hp::tile_bytes(MAX_Q, MAX_P);
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int t = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int p0 = pm * 16 + ((lane >> 3) & 1) * 8;
      uint32_t av[4];
      ldmatrix_x4_trans(av, vt + t * 128 + (((p0 >> 3) ^ (t & 7)) << 4));
      const int t0 = kk * 16 + qc * 2;
      const float2 w0 = w2(t0), w1 = w2(t0 + 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = bf16x2_of(av[i]);
        const float2 ww = i < 2 ? w0 : w1;
        split_bf16(v.x * ww.x, v.y * ww.y, ah[kk][i], al[kk][i]);
      }
    }
    hp::fence_regs(sr);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t bd = desc_mn_tile(sb + L.m, MAX_Q, kk);
      hp::wgmma_rs<64 * NS>(sr, ah[kk], bd);
      hp::wgmma_rs<64 * NS>(sr, al[kk], bd);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sr);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * st);
    if (svc) service(k);
  }
  if (cot) {
#pragma unroll
    for (int i = 0; i < 32 * NS; ++i) {
      const int r = f.row((i >> 1) & 1), c = 8 * (i >> 2) + f.c0 + (i & 1);
      if (r < p && c < n) A.dinit[(state0 + r) * n + c] = sr[i];
    }
  }
  if ((threadIdx.x & (WG - 1)) == 0) hp::bulk_wait<0, false>();
}

// ---------------------------------------------------------------------------
// dB and dC
// ---------------------------------------------------------------------------

// What keeps a tensor-core CTA's ring of stages full: the maps, the state
// it streams, its (b, chunk, group) and first head.  One warp of the CTA
// (the service warp, a consumer warp of the lighter warpgroup or of an
// idle one) loads B and C, primes the ring, and after each head waits
// until every consumer warp has released the head's stage, closes the
// head (dx launch) and loads head i + STAGES into it: a ninth, producer
// warp would cap every thread at 168 registers (65,536 over three warps
// on one of the SM's four schedulers), too few for the accumulators.
struct Ring {
  const CUtensorMap* mx;
  const CUtensorMap* mdy;
  const float* state;
  const float* other;  // dC's dS_{c+1}, for <dS_{c+1}, S_c>; else null
  unsigned char* sm;
  Lay L;
  uint32_t base, full, empty;
  int bb, ic, h0, slab, tma;
};

__device__ __forceinline__ void prime(const Args& A, const Ring& R) {
  for (int it = 0; it < STAGES && it < A.hs; ++it)
    load_head(R.mx, R.mdy, A, R.base, R.sm, R.L,
              R.L.stage + it * R.L.stage_bytes, R.full + 8 * it, R.state,
              R.other, R.bb, R.ic, R.h0 + it, R.slab, R.tma);
}

__device__ __forceinline__ void service(const Args& A, const Ring& R, int it,
                                        bool dx, int nwarps) {
  const int st = it % STAGES;
  hp::mbar_wait(R.empty + 8 * st, (it / STAGES) & 1);
  const Lay& L = R.L;
  const float* v =
      reinterpret_cast<const float*>(R.sm + L.stage + st * L.stage_bytes);
  if (dx) {
    const float* cd = v + L.cd / 4;
    const float dot =
        A.ns > 1 ? cd[2 * MAX_Q] + cd[2 * MAX_Q + 1] : cd[2 * MAX_Q];
    finish_head(A, v + L.vrow / 4, v + L.vsst / 4, v + L.vxd / 4,
                v + L.vcol / 4, dot, v + L.dec / 4, cd, nwarps, R.bb, R.ic,
                R.h0 + it, threadIdx.x & 31);
  } else if (R.other != nullptr && (threadIdx.x & 31) == 0) {
    // the slab's <dS_{c+1}, S_c>, the consumer warps' partials in order
    float dot = 0.f;
    for (int w = 0; w < nwarps; ++w) dot += v[L.vdot / 4 + w];
    A.cdot[slot_index(A, R.bb, R.ic, R.h0 + it) * CDOT + 2 * MAX_Q + R.slab] =
        dot;
  }
  __syncwarp();
  if (it + STAGES < A.hs)
    load_head(R.mx, R.mdy, A, R.base, R.sm, R.L,
              R.L.stage + st * R.L.stage_bytes, R.full + 8 * st, R.state,
              R.other, R.bb, R.ic, R.h0 + it + STAGES, R.slab, R.tma);
}

// The consumer warpgroups' f32 accumulators (one 64-column slab of N) into
// the reduction buffer (row-major [128][RED_LD]), summed over the CTAs of
// the cluster (the head slices of that slab) in rank order, by column
// slices, each CTA rounding its slice into dB or dC.
__device__ void write_red(float* red, const float (&acc)[32], int rb,
                          const Frag& f) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<float2*>(red + (64 * rb + f.row(hr)) * RED_LD +
                                 f.col(jj)) =
          make_float2(acc[4 * jj + 2 * hr], acc[4 * jj + 2 * hr + 1]);
}

template <typename T>
__device__ void cluster_reduce(const Args& A, uint32_t red_addr, bool is_c,
                               int slice, int j, int bb, int ic, int grp,
                               int nthreads) {
  // the slab's CTAs are ranks [rank - slice, rank - slice + slices)
  const int first = (int)hp::cluster_rank() - slice;
  const int cw = 64 / A.slices;  // columns of this CTA's slice
  const int groups = cw / 4;
  T* out = static_cast<T*>(is_c ? A.dc : A.db);
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * A.chunk;
  const int rows = min(MAX_Q, A.chunk);
  for (int it = threadIdx.x; it < rows * groups; it += nthreads) {
    const int r = it / groups, cl = slice * cw + (it % groups) * 4;
    const uint32_t at = red_addr + 4 * (r * RED_LD + cl);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < A.slices; ++k) {
      const float4 v = hp::ld_cluster_f32x4(hp::cluster_map(at, first + k));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    T* dst = out + ((tok0 + r) * A.g + grp) * A.n + 64 * j + cl;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (64 * j + cl + e < A.n) dst[e] = from_f32<T>(sv[e]);
  }
}

// The rows [64 RB, 64 RB + 64) of dC (IS_C) or dB for the N slab ``j``,
// summed over the CTA's heads, by one consumer warpgroup; NQB row blocks
// in the chunk.  Per head: the state term T = own . state (own = dy rows,
// state = S_c for dC; x rows and dS_{c+1} for dB; the state's slab as hi +
// lo), its rows scaled in f32 by e^seg (dC) or dt e^{total-seg} (dB) and
// added to ``acc``; dC also dots each row with C for dseg's C_q .
// dC_state_q; D = dy.x^T (dC: query rows, the key halves t <= q) or
// x.dy^T (dB: key rows, the query halves q >= t), masked and decayed in
// registers into dG (dG^T) and summed over the heads in f32.  Then acc +=
// sum dG . B (dC) or sum dG^T . C (dB), the sum split hi + lo as the
// register A.  Every condition around a wgmma is a template argument.
template <bool IS_C, int NQB, int RB>
__device__ __forceinline__ void dbc_consumer(
    const Args& A, const Ring& R, uint32_t bcb, bool svc, float (&acc)[32]) {
  const uint32_t base = R.base, full = R.full, empty = R.empty;
  unsigned char* sm = R.sm;
  const Lay& L = R.L;
  const int j = R.slab, bb = R.bb, ic = R.ic, h0 = R.h0;
  constexpr int K0 = IS_C ? 0 : RB, K1 = IS_C ? RB : NQB - 1;
  const int lane = threadIdx.x & 31;
  const Frag f;
  const int chunk = A.chunk;
  float gs[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = gs[0][i] = gs[1][i] = 0.f;
  hp::mbar_wait(bcb, 0);
#pragma unroll 1
  for (int it = 0; it < A.hs; ++it) {
    const int st = it % STAGES;
    hp::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    const uint32_t sb = base + L.stage + st * L.stage_bytes;
    unsigned char* sg = sm + L.stage + st * L.stage_bytes;
    const float* dec = reinterpret_cast<const float*>(sg + L.dec);
    const uint32_t own = sb + (IS_C ? L.y : L.x) + 64 * RB * 128;
    const uint32_t oth = sb + (IS_C ? L.x : L.y);
    float scale[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 64 * RB + f.row(hr);
      scale[hr] = r < chunk ? (IS_C ? dec[2 * MAX_Q + r]
                                    : dec[r] * dec[3 * MAX_Q + r])
                            : 0.f;
    }
    // the head's products in one batch: T, then D's halves
    float t[32], d[2][32];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_ss_tb64(t, desc_k(own, MAX_Q, kk), desc_mn(sb + L.img, kk),
                        kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_ss_tb64(t, desc_k(own, MAX_Q, kk),
                        desc_mn(sb + L.img + IMG_SLAB, kk), 1);
#pragma unroll
    for (int k = K0; k <= K1; ++k)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hp::wgmma_ss<64>(d[k], desc_k(own, MAX_Q, ks),
                         desc_k(oth + 64 * k * 128, MAX_Q, ks), ks > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(t);
#pragma unroll
    for (int k = K0; k <= K1; ++k) hp::fence_regs(d[k]);
    {
      float cd[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 64 * RB + f.row(hr);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float v0 = t[4 * jj + 2 * hr] * scale[hr];
          const float v1 = t[4 * jj + 2 * hr + 1] * scale[hr];
          acc[4 * jj + 2 * hr] += v0;
          acc[4 * jj + 2 * hr + 1] += v1;
          if (IS_C) {
            const float2 c2 =
                bf16x2_at(sm + L.ct + swz(MAX_Q, r, 64 * j + f.col(jj)));
            cd[hr] += c2.x * v0 + c2.y * v1;
          }
        }
      }
      if (IS_C) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v = quad_sum(cd[hr]);
          const int r = 64 * RB + f.row(hr);
          if ((lane & 3) == 0 && r < chunk)
            A.cdot[slot_index(A, bb, ic, h0 + it) * CDOT + j * MAX_Q + r] = v;
        }
        // this slab's <dS_{c+1}, S_c>: S_c's hi and lo planes, then
        // dS_{c+1}'s, 512 pieces of 16 bytes each, over the warpgroups
        float dot = 0.f;
#pragma unroll
        for (int m = 0; m < 4 / NQB; ++m) {
          const uint32_t k = (threadIdx.x + m * 128 * NQB) * 16;
          const unsigned char* im = sg + L.img + k;
          const uint4 q[4] = {*reinterpret_cast<const uint4*>(im),
                              *reinterpret_cast<const uint4*>(im + IMG_SLAB),
                              *reinterpret_cast<const uint4*>(im + 2 * IMG_SLAB),
                              *reinterpret_cast<const uint4*>(im + 3 * IMG_SLAB)};
          const uint32_t w[4][4] = {{q[0].x, q[0].y, q[0].z, q[0].w},
                                    {q[1].x, q[1].y, q[1].z, q[1].w},
                                    {q[2].x, q[2].y, q[2].z, q[2].w},
                                    {q[3].x, q[3].y, q[3].z, q[3].w}};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 s0 = bf16x2_of(w[0][e]), s1 = bf16x2_of(w[1][e]);
            const float2 d0 = bf16x2_of(w[2][e]), d1 = bf16x2_of(w[3][e]);
            dot += (s0.x + s1.x) * (d0.x + d1.x) +
                   (s0.y + s1.y) * (d0.y + d1.y);
          }
        }
        dot = warp_sum(dot);
        if (lane == 0)
          reinterpret_cast<float*>(sg)[L.vdot / 4 + (threadIdx.x >> 5)] = dot;
      }
    }
#pragma unroll
    for (int k = K0; k <= K1; ++k) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 64 * RB + f.row(hr);
        const float sr = dec[MAX_Q + r];
        const float dtr = dec[r];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 64 * k + f.col(jj);
          const float2 sc = *reinterpret_cast<const float2*>(dec + MAX_Q + c);
          const float2 dc = *reinterpret_cast<const float2*>(dec + c);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = IS_C ? r : c + e, tt = IS_C ? c + e : r;
            const float segc = e ? sc.y : sc.x;
            const float dtt = IS_C ? (e ? dc.y : dc.x) : dtr;
            const float rel = IS_C ? sr - segc : segc - sr;
            const int i = 4 * jj + 2 * hr + e;
            gs[k][i] += tt <= q && q < chunk
                            ? d[k][i] * dtt * exp2_approx(rel * LOG2E)
                            : 0.f;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * st);
    if (svc) service(A, R, it, false, 4 * NQB);
  }
  uint32_t gh[2][4][4], gl[2][4][4];
#pragma unroll
  for (int k = K0; k <= K1; ++k)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_a(gs[k], kk, gh[k][kk], gl[k][kk]);
  const uint32_t mul = base + (IS_C ? L.bt : L.ct) + j * MAX_Q * 128;
  hp::fence_regs(acc);
  hp::wgmma_fence();
#pragma unroll
  for (int k = K0; k <= K1; ++k)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = desc_mn(mul + 64 * k * 128, kk);
      hp::wgmma_rs<64>(acc, gh[k][kk], bd);
      hp::wgmma_rs<64>(acc, gl[k][kk], bd);
    }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
}

// dB or dC of one (b, chunk, group), bf16 on wgmma.  Grid (slices ns, 2,
// B nc G), clusters (slices, 1, 1): grid y 0 is dC, 1 dB; the cluster
// x / slices takes N's slab of that index, its CTA of rank r the heads [r
// hs, r hs + hs) of the group.  Warpgroup rb (0, 1) owns the chunk rows [64 rb, 64 rb + 64)
// (dbc_consumer); the service warp loads B and C once (multicast) and
// each head's x, dy, state slab and decays through the ring.
__global__ void __launch_bounds__(CONSUMERS, 1)
ssd_bwd_dbc_tc(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mdy,
               const __grid_constant__ CUtensorMap mb,
               const __grid_constant__ CUtensorMap mc, Args A, int tma) {
  const Lay L(A.ns);
  unsigned char* sm;
  const uint32_t base = smem_base(sm);
  const uint32_t full = base + L.bar, empty = full + 8 * STAGES;
  const uint32_t bcb = empty + 8 * STAGES;
  const int rank = (int)hp::cluster_rank();
  const bool is_c = blockIdx.y == 0;
  const int grp = blockIdx.z % A.g;
  const int ic = blockIdx.z / A.g % A.nc;
  const int bb = blockIdx.z / A.g / A.nc;
  const int nqb = A.chunk > 64 ? 2 : 1;
  const int warp = threadIdx.x >> 5;
  // the service warp: in the warpgroup with fewer dG halves, or the idle
  const int svc = nqb == 2 && is_c ? 0 : 4;
  const Ring R{&mx, &mdy, is_c ? A.states : A.dstates,
               is_c ? A.dstates : nullptr, sm, L, base, full, empty, bb, ic,
               grp * (A.h / A.g) + (int)blockIdx.x % A.slices * A.hs,
               (int)blockIdx.x / A.slices, tma};

  if (!tma) zero_smem(sm, L.bar);  // tile padding
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 32);
      hp::mbar_init(empty + 8 * s, 4 * nqb);
    }
    hp::mbar_init(bcb, 32);
    hp::mbar_fence_init();
  }
  __syncthreads();
  hp::cluster_sync();  // every CTA's barriers exist before a multicast lands

  if (warp == svc) {
    load_bc(&mb, &mc, A, base, sm, L, bcb, bb, ic, grp, rank, tma);
    prime(A, R);
  }
  const int rb = warp >> 2;
  float acc[32];
  auto run = [&](auto is_c_, auto nqb_, auto rb_) {
    dbc_consumer<decltype(is_c_)::value, decltype(nqb_)::value,
                 decltype(rb_)::value>(A, R, bcb, warp == svc, acc);
  };
  using T_ = std::true_type;
  using F_ = std::false_type;
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  if (nqb == 1) {
    if (rb == 0) {
      is_c ? run(T_{}, I1{}, I0{}) : run(F_{}, I1{}, I0{});
    } else if (warp == svc) {
      for (int it = 0; it < A.hs; ++it) service(A, R, it, false, 4);
    }
  } else if (rb == 0) {
    is_c ? run(T_{}, I2{}, I0{}) : run(F_{}, I2{}, I0{});
  } else {
    is_c ? run(T_{}, I2{}, I1{}) : run(F_{}, I2{}, I1{});
  }
  __syncthreads();  // every consumer is done with the stages
  if (rb < nqb)
    write_red(reinterpret_cast<float*>(sm + L.stage), acc, rb, Frag());
  hp::cluster_sync();
  cluster_reduce<__nv_bfloat16>(A, base + L.stage, is_c,
                                (int)blockIdx.x % A.slices, R.slab, bb, ic,
                                grp, CONSUMERS);
  hp::cluster_sync();  // no CTA leaves while a peer reads its buffer
}

// The same on 3xTF32 mma.sync, operands from global memory: 256 threads,
// the two warpgroups' rows as in the tensor-core body; each warp forms its
// 16 rows of every product.
__global__ void __launch_bounds__(CONSUMERS, 1)
ssd_bwd_dbc_f32(Args A) {
  extern __shared__ __align__(16) unsigned char smf[];
  float* held = reinterpret_cast<float*>(smf);  // the summed dG, [64][256]
  float* red = held + 64 * CONSUMERS;
  auto gs = [&](int k, int i) -> float& {
    return held[(32 * k + i) * CONSUMERS + threadIdx.x];
  };
  const int slice = (int)blockIdx.x % A.slices;
  const int j = (int)blockIdx.x / A.slices;
  const bool is_c = blockIdx.y == 0;
  const int grp = blockIdx.z % A.g;
  const int ic = blockIdx.z / A.g % A.nc;
  const int bb = blockIdx.z / A.g / A.nc;
  const int nqb = A.chunk > 64 ? 2 : 1;
  const int h0 = grp * (A.h / A.g) + slice * A.hs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp >> 2, w16 = 16 * (warp & 3);
  const bool active = rb < nqb;
  const int chunk = A.chunk, p = A.p, n = A.n, h = A.h;
  const Frag f;
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
  const float* xg = static_cast<const float*>(A.x);
  const float* dyg = static_cast<const float*>(A.dy);
  const float* bg = static_cast<const float*>(A.bm);
  const float* cg = static_cast<const float*>(A.cm);
  const float* mulg = is_c ? bg : cg;
  const int kp = (p + 7) / 8 * 8;
  auto mat = [&](const float* m, int r, int c) {  // B or C element
    return r < chunk && c < n ? __ldg(m + ((tok0 + r) * A.g + grp) * n + c)
                              : 0.f;
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = gs(0, i) = gs(1, i) = 0.f;
  if (active) {
#pragma unroll 1
    for (int it = 0; it < A.hs; ++it) {
      const int hh = h0 + it;
      const size_t slot = slot_index(A, bb, ic, hh);
      const float* dec = A.dec + slot * DEC;
      const float* stt = (is_c ? A.states : A.dstates) + slot * A.slot;
      const float* ownp = is_c ? dyg : xg;
      const float* othp = is_c ? xg : dyg;
      auto own = [&](int r, int k) {  // the block's rows, warp-local r
        const int t = 64 * rb + w16 + r;
        return t < chunk && k < p ? __ldg(ownp + ((tok0 + t) * h + hh) * p + k)
                                  : 0.f;
      };
      float cd[2] = {0.f, 0.f};
      float scale[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 64 * rb + f.row(hr);
        scale[hr] = r < chunk ? (is_c ? dec[2 * MAX_Q + r]
                                      : dec[r] * dec[3 * MAX_Q + r])
                              : 0.f;
      }
      {
        float t[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) t[i] = 0.f;
        tf32::mm(t, kp, own, [&](int k, int c) {
          const int cc = 64 * j + c;
          return k < p && cc < n ? __ldg(stt + k * n + cc) : 0.f;
        });
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 64 * rb + f.row(hr);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * jj + 2 * hr + e;
              const float v = t[i] * scale[hr];
              acc[i] += v;
              if (is_c) cd[hr] += mat(cg, r, 64 * j + f.col(jj) + e) * v;
            }
        }
      }
      if (is_c) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float v = quad_sum(cd[hr]);
          const int r = 64 * rb + f.row(hr);
          if ((lane & 3) == 0 && r < chunk)
            A.cdot[slot * CDOT + j * MAX_Q + r] = v;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (is_c ? k > rb : (k < rb || k >= nqb)) continue;
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        tf32::mm(d, kp, own, [&](int kk, int c) {
          const int tt = 64 * k + c;
          return tt < chunk && kk < p
                     ? __ldg(othp + ((tok0 + tt) * h + hh) * p + kk)
                     : 0.f;
        });
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 64 * rb + f.row(hr);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 64 * k + f.col(jj) + e;
              const int q = is_c ? r : c, tt = is_c ? c : r;
              const int i = 4 * jj + 2 * hr + e;
              gs(k, i) += tt <= q && q < chunk
                              ? d[i] * dec[tt] *
                                    expf(dec[MAX_Q + q] - dec[MAX_Q + tt])
                              : 0.f;
            }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (is_c ? k > rb : (k < rb || k >= nqb)) continue;
      tf32::mm_acc(acc, [&](int i) { return gs(k, i); },
                   [&](int kr, int c) {
                     return mat(mulg, 64 * k + kr, 64 * j + c);
                   });
    }
    write_red(red, acc, rb, f);
  }
  hp::cluster_sync();
  cluster_reduce<float>(A, smem_addr(red), is_c, slice, j, bb, ic, grp,
                        CONSUMERS);
  hp::cluster_sync();
}

// ---------------------------------------------------------------------------
// dx, ddt, da
// ---------------------------------------------------------------------------

// The key rows [64 TB, 64 TB + 64) of dx, by one consumer warpgroup, for
// the CTA's heads; NS slabs of N, NQB row blocks in the chunk.  Per head
// du = e^{total-seg} B.dS^T (dS hi + lo) and u . du_state; per query half
// q >= t, G^T = B.C^T and D^T = x.dy^T in one batch, W = G o L o dt D and
// its row and column sums, M^T = G^T o L^T split hi + lo and du +=
// M^T.dy; dx = dt du, x . du, the rows' sums into the stage's vectors,
// which the service warp reads when it closes the head.  Every condition
// around a wgmma is a template argument.
template <int NS, int NQB, int TB>
__device__ __forceinline__ void dx_consumer(const Args& A, const Ring& R,
                                            uint32_t bcb, bool svc) {
  constexpr bool ROWS = TB < NQB;  // else the warpgroup only releases
  const uint32_t base = R.base, full = R.full;
  unsigned char* sm = R.sm;
  const Lay& L = R.L;
  const int bb = R.bb, ic = R.ic, h0 = R.h0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Frag f;
  const int chunk = A.chunk, p = A.p;
  const uint32_t brow0 = base + L.bt + 64 * TB * 128;  // B rows of the block
  if (ROWS) hp::mbar_wait(bcb, 0);
  __nv_bfloat16* dxg = static_cast<__nv_bfloat16*>(A.dx);
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
#pragma unroll 1
  for (int it = 0; it < A.hs; ++it) {
    const int st = it % STAGES;
    const int hh = h0 + it;
    hp::mbar_wait(full + 8 * st, (it / STAGES) & 1);
    uint32_t sb = base + L.stage + st * L.stage_bytes;
    uint32_t brow = brow0;
    // opaque to the compiler: the head's descriptors are formed here, not
    // hoisted out of the loop into registers the accumulators need
    asm volatile("" : "+r"(sb), "+r"(brow));
    unsigned char* sg = sm + L.stage + st * L.stage_bytes;
    const float* dec = reinterpret_cast<const float*>(sg + L.dec);
    float* vf = reinterpret_cast<float*>(sg);
    // the query halves this block's keys never see: zero column sums
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if ((j < TB || j >= NQB) && lane < 16)
        *reinterpret_cast<float4*>(vf + L.vcol / 4 + warp * MAX_Q + 64 * j +
                                   4 * lane) = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ROWS) {
      // du_state = B . dS^T, hi + lo
      float du[32];
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * NS; ++ks)
        hp::wgmma_ss<64>(du, desc_k(brow, MAX_Q, ks),
                         desc_k(sb + L.img, MAX_P, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < 4 * NS; ++ks)
        hp::wgmma_ss<64>(du, desc_k(brow, MAX_Q, ks),
                         desc_k(sb + L.img + NS * IMG_SLAB, MAX_P, ks), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(du);
      float sst[2] = {0.f, 0.f}, rw[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = 64 * TB + f.row(hr);
        const float w = t < chunk ? dec[3 * MAX_Q + t] : 0.f;
        const float dtt = dec[t];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 x2 = bf16x2_at(sg + L.x + swz(MAX_Q, t, f.col(jj)));
          float& a0 = du[4 * jj + 2 * hr];
          float& a1 = du[4 * jj + 2 * hr + 1];
          a0 *= w;
          a1 *= w;
          sst[hr] += dtt * (x2.x * a0 + x2.y * a1);
        }
      }
      // per query half: D^T = x . dy^T; W = G o L o dt D, its row and
      // column sums; M = G o L split hi + lo; du += M^T . dy
#pragma unroll
      for (int j = TB; j < NQB; ++j) {
        float* colw = vf + L.vcol / 4 + warp * MAX_Q + 64 * j;
        float d[32], gj[32];
        hp::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4 * NS; ++ks)
          hp::wgmma_ss<64>(gj, desc_k(brow, MAX_Q, ks),
                           desc_k(base + L.ct + 64 * j * 128, MAX_Q, ks),
                           ks > 0);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          hp::wgmma_ss<64>(d, desc_k(sb + L.x + 64 * TB * 128, MAX_Q, ks),
                           desc_k(sb + L.y + 64 * j * 128, MAX_Q, ks), ks > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(d);
        hp::fence_regs(gj);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int q0 = 64 * j + f.col(jj);
          const float2 sq = *reinterpret_cast<const float2*>(dec + MAX_Q + q0);
          float c2[2] = {0.f, 0.f};
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int t = 64 * TB + f.row(hr);
            const float st_ = dec[MAX_Q + t], dtt = dec[t];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * jj + 2 * hr + e, q = q0 + e;
              const bool ok = t <= q && q < chunk;
              const float l =
                  ok ? exp2_approx(((e ? sq.y : sq.x) - st_) * LOG2E) : 0.f;
              const float m = gj[i] * l;
              const float w = m * d[i] * dtt;
              rw[hr] += w;
              c2[e] += w;
              d[i] = m;
            }
          }
          c2[0] = col_sum(c2[0]);
          c2[1] = col_sum(c2[1]);
          if (lane < 4)
            *reinterpret_cast<float2*>(colw + f.col(jj)) =
                make_float2(c2[0], c2[1]);
        }
        uint32_t mh[4][4], ml[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) split_a(d, kk, mh[kk], ml[kk]);
        hp::fence_regs(du);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bd = desc_mn(sb + L.y + 64 * j * 128, kk);
          hp::wgmma_rs<64>(du, mh[kk], bd);
          hp::wgmma_rs<64>(du, ml[kk], bd);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(du);
      }
      // dx = dt du; x . du; the rows' sums into the head's vectors
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = 64 * TB + f.row(hr);
        const float dtt = dec[t];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int pp = f.col(jj);
          const float2 x2 = bf16x2_at(sg + L.x + swz(MAX_Q, t, pp));
          const float a0 = du[4 * jj + 2 * hr], a1 = du[4 * jj + 2 * hr + 1];
          xd[hr] += x2.x * a0 + x2.y * a1;
          if (t < chunk) {
            __nv_bfloat16* o = dxg + ((tok0 + t) * A.h + hh) * p + pp;
            if (pp + 1 < p && (p & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(dtt * a0, dtt * a1);
            } else {
              if (pp < p) o[0] = __float2bfloat16(dtt * a0);
              if (pp + 1 < p) o[1] = __float2bfloat16(dtt * a1);
            }
          }
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float a_ = quad_sum(rw[hr]), b_ = quad_sum(sst[hr]),
                    c_ = quad_sum(xd[hr]);
        const int t = 64 * TB + f.row(hr);
        if ((lane & 3) == 0) {
          vf[L.vrow / 4 + t] = a_;
          vf[L.vsst / 4 + t] = b_;
          vf[L.vxd / 4 + t] = c_;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(R.empty + 8 * st);
    if (svc) service(A, R, it, true, CONSUMERS / 32);
  }
  if (svc) __threadfence();  // the da partials, before finish_da counts
}

// dx, ddt and the da partial of one (b, chunk, group, head slice), bf16 on
// wgmma (grid (slices, 1, B nc G), clusters (slices, 1, 1), which share B
// and C).  Warpgroup tb owns the key rows [64 tb, 64 tb + 64)
// (dx_consumer; with one row block the second only dots); warp 4, the
// service warp, closes head i (finish_head) when every warp has released
// its stage, before loading head i + 2 into it.
template <int NS>
__global__ void __launch_bounds__(CONSUMERS, 1)
ssd_bwd_dx_tc(const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap mdy,
              const __grid_constant__ CUtensorMap mb,
              const __grid_constant__ CUtensorMap mc, Args A, int tma) {
  const Lay L(NS);
  unsigned char* sm;
  const uint32_t base = smem_base(sm);
  const uint32_t full = base + L.bar, empty = full + 8 * STAGES;
  const uint32_t bcb = empty + 8 * STAGES;
  const int rank = (int)hp::cluster_rank();
  const int grp = blockIdx.z % A.g;
  const int ic = blockIdx.z / A.g % A.nc;
  const int bb = blockIdx.z / A.g / A.nc;
  const int nqb = A.chunk > 64 ? 2 : 1;
  const int warp = threadIdx.x >> 5;
  constexpr int SVC = 4;
  const Ring R{&mx, &mdy, A.dstates, nullptr, sm, L, base, full, empty, bb,
               ic, grp * (A.h / A.g) + (int)blockIdx.x * A.hs, -1, tma};

  if (!tma) zero_smem(sm, L.bar);  // tile padding
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(full + 8 * s, 32);
      hp::mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    hp::mbar_init(bcb, 32);
    hp::mbar_fence_init();
  }
  __syncthreads();
  hp::cluster_sync();

  if (warp == SVC) {
    load_bc(&mb, &mc, A, base, sm, L, bcb, bb, ic, grp, rank, tma);
    prime(A, R);
  }
  const int tb = warp >> 2;
  const bool svc = warp == SVC;
  if (nqb == 1) {
    if (tb == 0)
      dx_consumer<NS, 1, 0>(A, R, bcb, svc);
    else
      dx_consumer<NS, 1, 1>(A, R, bcb, svc);
  } else if (tb == 0) {
    dx_consumer<NS, 2, 0>(A, R, bcb, svc);
  } else {
    dx_consumer<NS, 2, 1>(A, R, bcb, svc);
  }
  finish_da(A);
  hp::cluster_sync();  // no CTA leaves while its multicast is in flight
}

// The same on 3xTF32 mma.sync, operands from global memory, 256 threads:
// each head's vectors go to shared memory and warp 0 closes the head.
__global__ void __launch_bounds__(CONSUMERS, 1)
ssd_bwd_dx_f32(Args A) {
  extern __shared__ __align__(16) unsigned char smf[];
  float* held = reinterpret_cast<float*>(smf);  // G^T, [64][256]
  auto g = [&](int j, int i) -> float& {
    return held[(32 * j + i) * CONSUMERS + threadIdx.x];
  };
  float* mheld = held + 64 * CONSUMERS;  // M of the half, [32][256]
  float* vf = mheld + 32 * CONSUMERS;
  float* vrow = vf;
  float* vsst = vrow + MAX_Q;
  float* vxd = vsst + MAX_Q;
  float* vcol = vxd + MAX_Q;       // [8][MAX_Q]
  float* vdot = vcol + 8 * MAX_Q;  // [8]
  const int grp = blockIdx.z % A.g;
  const int ic = blockIdx.z / A.g % A.nc;
  const int bb = blockIdx.z / A.g / A.nc;
  const int nqb = A.chunk > 64 ? 2 : 1;
  const int h0 = grp * (A.h / A.g) + (int)blockIdx.x * A.hs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tb = warp >> 2, w16 = 16 * (warp & 3);
  const bool active = tb < nqb;
  const int chunk = A.chunk, p = A.p, n = A.n, h = A.h;
  const Frag f;
  const size_t tok0 = (size_t)bb * A.seqlen + (size_t)ic * chunk;
  const float* xg = static_cast<const float*>(A.x);
  const float* dyg = static_cast<const float*>(A.dy);
  const float* bg = static_cast<const float*>(A.bm);
  const float* cg = static_cast<const float*>(A.cm);
  const int kp = (p + 7) / 8 * 8, kn = (n + 7) / 8 * 8;
  auto mat = [&](const float* m, int r, int c) {
    return r < chunk && c < n ? __ldg(m + ((tok0 + r) * A.g + grp) * n + c)
                              : 0.f;
  };
  auto brow = [&](int r, int k) { return mat(bg, 64 * tb + w16 + r, k); };
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    float gt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gt[i] = 0.f;
    if (active && j >= tb && j < nqb)
      tf32::mm(gt, kn, brow,
               [&](int k, int c) { return mat(cg, 64 * j + c, k); });
#pragma unroll
    for (int i = 0; i < 32; ++i) g(j, i) = gt[i];
  }
  float* dxg = static_cast<float*>(A.dx);
#pragma unroll 1
  for (int it = 0; it < A.hs; ++it) {
    const int hh = h0 + it;
    const size_t slot = slot_index(A, bb, ic, hh);
    const float* dec = A.dec + slot * DEC;
    const float* dst = A.dstates + slot * A.slot;
    const float* sst_ = A.states + slot * A.slot;
    auto xv = [&](int t, int k) {
      return t < chunk && k < p ? __ldg(xg + ((tok0 + t) * h + hh) * p + k)
                                : 0.f;
    };
    auto dyv = [&](int t, int k) {
      return t < chunk && k < p ? __ldg(dyg + ((tok0 + t) * h + hh) * p + k)
                                : 0.f;
    };
    if (active) {
      float du[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) du[i] = 0.f;
      tf32::mm(du, kn, brow, [&](int k, int c) {
        return c < p && k < n ? __ldg(dst + c * n + k) : 0.f;
      });
      float sst[2] = {0.f, 0.f}, rw[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = 64 * tb + f.row(hr);
        const float w = t < chunk ? dec[3 * MAX_Q + t] : 0.f;
        const float dtt = dec[t];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& a0 = du[4 * jj + 2 * hr + e];
            a0 *= w;
            sst[hr] += dtt * xv(t, f.col(jj) + e) * a0;
          }
      }
#pragma unroll 1
      for (int j = 0; j < 2; ++j) {
        float* colw = vcol + warp * MAX_Q + 64 * j;
        if (j < tb || j >= nqb) {
          if (lane < 16)
            *reinterpret_cast<float4*>(colw + 4 * lane) =
                make_float4(0.f, 0.f, 0.f, 0.f);
          continue;
        }
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        tf32::mm(d, kp, [&](int r, int k) { return xv(64 * tb + w16 + r, k); },
                 [&](int k, int c) { return dyv(64 * j + c, k); });
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float c2[2] = {0.f, 0.f};
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int t = 64 * tb + f.row(hr);
            const float dtt = dec[t];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * jj + 2 * hr + e, q = 64 * j + f.col(jj) + e;
              const bool ok = t <= q && q < chunk;
              const float l =
                  ok ? expf(dec[MAX_Q + q] - dec[MAX_Q + t]) : 0.f;
              const float m = g(j, i) * l;
              const float w = m * d[i] * dtt;
              rw[hr] += w;
              c2[e] += w;
              mheld[i * CONSUMERS + threadIdx.x] = m;
            }
          }
          c2[0] = col_sum(c2[0]);
          c2[1] = col_sum(c2[1]);
          if (lane < 4)
            *reinterpret_cast<float2*>(colw + f.col(jj)) =
                make_float2(c2[0], c2[1]);
        }
        tf32::mm_acc(du,
                     [&](int i) { return mheld[i * CONSUMERS + threadIdx.x]; },
                     [&](int k, int c) { return dyv(64 * j + k, c); });
      }
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = 64 * tb + f.row(hr);
        const float dtt = dec[t];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pp = f.col(jj) + e;
            const float a0 = du[4 * jj + 2 * hr + e];
            xd[hr] += xv(t, pp) * a0;
            if (t < chunk && pp < p)
              dxg[((tok0 + t) * h + hh) * p + pp] = dtt * a0;
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float a_ = quad_sum(rw[hr]), b_ = quad_sum(sst[hr]),
                    c_ = quad_sum(xd[hr]);
        const int t = 64 * tb + f.row(hr);
        if ((lane & 3) == 0) {
          vrow[t] = a_;
          vsst[t] = b_;
          vxd[t] = c_;
        }
      }
      float dot = 0.f;
      for (int k = threadIdx.x; k < p * n; k += WG * nqb)
        dot += __ldg(dst + k) * __ldg(sst_ + k);
      dot = warp_sum(dot);
      if (lane == 0) vdot[warp] = dot;
    }
    __syncthreads();
    if (warp == 0)
      finish_head(A, vrow, vsst, vxd, vcol, [&] {
        float d = 0.f;  // the warps' partials in order
        for (int w = 0; w < 4 * nqb; ++w) d += vdot[w];
        return d;
      }(), dec, A.cdot + slot * CDOT, 4 * nqb, bb, ic, hh, lane);
    __syncthreads();
  }
  if (warp == 0) __threadfence();
  finish_da(A);
  hp::cluster_sync();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The head slices of a cluster: the largest power of two up to ``most``
// that divides the heads of a group
__host__ __device__ inline int cluster_size(int rep, int most = 8) {
  int cs = most;
  while (rep % cs) cs /= 2;
  return cs;
}

// The two chunk launches' arrangements: the CTAs of a cluster (which share
// B and C by multicast), the head slices of a group (a CTA each, per 64-
// column slab of N for dB / dC) and the heads of a CTA.  dB / dC: a
// cluster holds every slab's slices, up to 8 CTAs, summed through
// distributed shared memory; while that would hold fewer than two CTAs
// per SM, one cluster per slab, of up to 8 slices.  dx: clusters of up to
// 8 slices, and more slices (fewer heads a CTA) while the launch would
// hold fewer than two CTAs per SM.
struct Arrange {
  int cs, slices, hs;
};
__host__ __device__ inline Arrange arrange_dbc(int rep, int ns, long units) {
  const int s = cluster_size(rep, 8 / ns);
  if (units * 2 * ns * s >= 2 * 132) return {s * ns, s, rep / s};
  const int t = cluster_size(rep);
  return {t, t, rep / t};
}
__host__ __device__ inline Arrange arrange_dx(int rep, long units) {
  const int cs = cluster_size(rep);
  int s = cs;
  while (rep % (2 * s) == 0 && units * s < 2 * 132) s *= 2;
  return {cs, s, rep / s};
}

template <typename K, typename... Args_>
int launch_cluster(K kernel, dim3 grid, int threads, size_t smem, int cs,
                   cudaStream_t st, Args_... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// whether the bf16 tensors go through TMA: every stride a whole number of
// 16-byte pieces and every base 16-byte aligned (else the service warp
// copies)
bool tma_ok(const Args& A) {
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  return A.p == MAX_P && A.n % 64 == 0 && aligned(A.x) && aligned(A.dy) &&
         aligned(A.bm) && aligned(A.cm);
}

int launch(Args A, bool bf16, cudaStream_t st) {
  const int rep = A.h / A.g;
  const long units = (long)A.b * A.nc * A.g;
  const Arrange ad = arrange_dbc(rep, A.ns, units),
                ax = arrange_dx(rep, units);
  Args D = A, X = A;
  D.cs = ad.cs, D.slices = ad.slices, D.hs = ad.hs;
  X.cs = ax.cs, X.slices = ax.slices, X.hs = ax.hs;
  const dim3 dbc_grid(ad.slices * A.ns, 2, units);
  const dim3 dx_grid(ax.slices, 1, units);
  cudaError_t err;
  int code;
  const size_t items = (size_t)A.b * A.nc * A.h;
  ssd_bwd_decays<<<(unsigned)((items + THREADS / 32 - 1) / (THREADS / 32)),
                   THREADS, 0, st>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    const int tma = tma_ok(A);
    CUtensorMap mx, mdy, mb, mc;
    if (tma) {
      if ((code = hp::make_map(&mx, A.x, A.b, A.seqlen, A.h, A.p, MAX_Q)) ||
          (code = hp::make_map(&mdy, A.dy, A.b, A.seqlen, A.h, A.p, MAX_Q)) ||
          (code = hp::make_map(&mb, A.bm, A.b, A.seqlen, A.g, A.n, MAX_Q)) ||
          (code = hp::make_map(&mc, A.cm, A.b, A.seqlen, A.g, A.n, MAX_Q)))
        return code;
    } else {
      memset(&mx, 0, sizeof(mx));
      mdy = mb = mc = mx;
    }
    // the passes: two heads of a group a CTA where the group has an even
    // number of heads
    const int hpc = rep % 2 == 0 ? 2 : 1;
    const dim3 wg_pass_grid(A.b, A.h / hpc, 2);
    const size_t pass_smem = PassLay(A.ns).bytes;
    err = A.ns == 1 ? allow_smem(ssd_bwd_pass_wg<1>, pass_smem)
                    : allow_smem(ssd_bwd_pass_wg<2>, pass_smem);
    if (err != cudaSuccess) return (int)err;
    if (A.ns == 1)
      ssd_bwd_pass_wg<1><<<wg_pass_grid, CONSUMERS, pass_smem, st>>>(
          mx, mdy, mb, mc, A, tma, hpc);
    else
      ssd_bwd_pass_wg<2><<<wg_pass_grid, CONSUMERS, pass_smem, st>>>(
          mx, mdy, mb, mc, A, tma, hpc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = Lay(A.ns).bytes;
    if ((code = launch_cluster(ssd_bwd_dbc_tc, dbc_grid, CONSUMERS, smem,
                               ad.cs, st, mx, mdy, mb, mc, D, tma)))
      return code;
    code = A.ns == 1
               ? launch_cluster(ssd_bwd_dx_tc<1>, dx_grid, CONSUMERS, smem,
                                ax.cs, st, mx, mdy, mb, mc, X, tma)
               : launch_cluster(ssd_bwd_dx_tc<2>, dx_grid, CONSUMERS, smem,
                                ax.cs, st, mx, mdy, mb, mc, X, tma);
    if (code) return code;
  } else {
    const int pass_tiles = (A.p + fma_body::PT - 1) / fma_body::PT;
    const dim3 pass_grid(A.b, A.h, 2 * pass_tiles);
    const size_t pass_smem =
        sizeof(float) * fma_body::pass_smem_floats(A.chunk, A.n);
    err = allow_smem(ssd_bwd_pass_fma, pass_smem);
    if (err != cudaSuccess) return (int)err;
    ssd_bwd_pass_fma<<<pass_grid, THREADS, pass_smem, st>>>(A);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if ((code = launch_cluster(ssd_bwd_dbc_f32, dbc_grid, CONSUMERS,
                               F32_RED_BYTES, ad.cs, st, D)))
      return code;
    if ((code = launch_cluster(ssd_bwd_dx_f32, dx_grid, CONSUMERS,
                               F32_VEC_BYTES, ax.cs, st, X)))
      return code;
  }
  return 0;
}

}  // namespace
}  // namespace repro_torch

// C entry points, bound with ctypes, one per dtype: x, B, C, dy, dx, dB
// and dC in that dtype; dt, a, the scratch, ddt, da and d_initial_state
// f32.  ``init`` and ``dfin`` may be null (zeros).  ``scratch`` holds, in
// f32 and in this order, the state slots and the cotangent slots [B, L /
// chunk, H] of ceil(N / 64) 4096 floats each, the decays [B, L / chunk,
// H][4][128], the C . dC_state terms [B, L / chunk, H][2][128] (one per
// 64-column slab of N) and the da partials [H][B L / chunk].  Each returns cudaGetLastError() after its
// launches (0 on success), or cudaErrorInvalidValue for a shape it does
// not take (an empty batch or sequence, P above 64, among them).
namespace {
int entry(const void* x, const void* dt, const void* a, const void* bm,
          const void* cm, const void* init, const void* dy, const void* dfin,
          void* scratch, void* dx, void* ddt, void* da, void* db, void* dc,
          void* dinit, int b, int seqlen, int h, int p, int g, int n,
          int chunk, void* stream, bool bf16) {
  using namespace repro_torch;
  if (chunk < 1 || chunk > MAX_Q || n < 1 || n > MAX_N || g < 1 || h % g ||
      seqlen % chunk || p < 1 || p > MAX_P || b < 1 || seqlen < 1)
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
  A.ns = hopper::slabs(n);
  A.slot = slot_floats(n);
  A.cs = A.slices = A.hs = 0;  // set per launch (launch)
  const size_t bch = (size_t)b * A.nc * h;
  float* s = static_cast<float*>(scratch);
  A.states = s;
  A.dstates = s + bch * A.slot;
  A.dec = A.dstates + bch * A.slot;
  A.cdot = A.dec + bch * DEC;
  A.part_da = A.cdot + bch * CDOT;
  A.done = reinterpret_cast<unsigned*>(A.part_da + bch);
  A.dx = dx;
  A.ddt = static_cast<float*>(ddt);
  A.da = static_cast<float*>(da);
  A.db = db;
  A.dc = dc;
  A.dinit = static_cast<float*>(dinit);
  return launch(A, bf16, static_cast<cudaStream_t>(stream));
}
}  // namespace

// The host-side plan at (chunk, n, heads per group) into out[7]: the pass
// kernel's dynamic shared memory (tensor-core body, then f32), the chunk
// launches' (tensor-core, f32 dB / dC, f32 dx), and the two chunk
// launches' cluster sizes (dB / dC, dx).  Returns 0.
extern "C" int ssd_scan_bwd_plan(int chunk, int n, int rep, void* out) {
  using namespace repro_torch;
  int* o = static_cast<int*>(out);
  o[0] = (int)PassLay(hopper::slabs(n)).bytes;
  o[1] = (int)(sizeof(float) * fma_body::pass_smem_floats(chunk, n));
  o[2] = (int)Lay(hopper::slabs(n)).bytes;
  o[3] = (int)F32_RED_BYTES;
  o[4] = (int)F32_VEC_BYTES;
  o[5] = arrange_dbc(rep, hopper::slabs(n), 1 << 20).cs;
  o[6] = arrange_dx(rep, 1 << 20).cs;
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
