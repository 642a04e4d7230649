"""The backward of the SSD chunked scan on the card: the wrapper of
``csrc/ssd_backward.cu``.

``ssd_chunk_scan_bwd`` computes the gradient of ``ssd_chunk_scan`` (K5,
which replaces the Pallas ``_kernel`` of ``repro/kernels/ssd_scan.py``).
The reference has no backward kernel -- its ``jax.grad`` differentiates
the jnp scan -- so this is the port's own, deterministic, in four
launches: each chunk's decays; the state and cotangent passes; dB and dC,
where a cluster of CTAs owns a (sequence, chunk, group), splits its heads
and sums its CTAs' accumulators through distributed shared memory in a
fixed rank order; dx, ddt and da on clusters of head slices.  No float
atomics, and no per-head partial of dB or dC goes through device memory.
It takes CUDA tensors only; ``kernels/ops.py`` routes a CPU graph to the
plain ``ref.ssd_scan_bwd_ref`` through the same ``SSDScan`` function.
Two bodies, chosen by ``bwd_body`` from the dtype alone: bf16 on
``wgmma`` fed by TMA (the f32 factors split into bf16 hi + lo), f32 on
``mma.sync`` in TF32 with every operand split hi + lo (three products).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import (
    MAX_CHUNK,
    MAX_STATE,
    _check_devices,
    _check_dtypes,
)

ENTRY = {"tensor-core": "ssd_scan_bwd_bf16", "tf32x3": "ssd_scan_bwd_f32"}
MAX_HEAD_DIM = 64   # P: one 64-column slab of state rows per head
# csrc/ssd_backward.cu: decays of one (sequence, chunk, head) -- dt, seg,
# e^seg, e^{total-seg} over the 128-row chunk tile -- and its C . dC_state
# per 64-column slab of N, then the slabs' partials of <dS_{c+1}, S_c>
# (and two floats of padding)
DECAY_FLOATS = 4 * MAX_CHUNK
CDOT_FLOATS = 2 * MAX_CHUNK + 4
SMEM_LIMIT = 232_448   # bytes of shared memory an H100 block may use


def bwd_body(dtype: torch.dtype) -> str:
    """Which body of ``csrc/ssd_backward.cu`` a call runs:
    ``"tensor-core"`` (``wgmma``) for bf16, ``"tf32x3"`` (``mma.sync`` in
    TF32, three products per split pair) for f32."""
    return "tensor-core" if dtype == torch.bfloat16 else "tf32x3"


def cluster_size(heads_per_group: int, most: int = 8) -> int:
    """The slices of one group's heads that a cluster's CTAs walk: the
    largest power of two up to ``most`` that divides them (csrc
    ``cluster_size``)."""
    cs = most
    while heads_per_group % cs:
        cs //= 2
    return cs


def arrangement(heads_per_group: int, n: int, units: int = 1 << 20) -> dict:
    """Each chunk launch's arrangement (csrc ``arrange_dbc``,
    ``arrange_dx``) as (CTAs of a cluster, head slices of a group per
    64-column slab of N, heads of a CTA), for ``units`` = B * L / chunk *
    G.  dB and dC: a cluster holds every slab's slices, up to 8 CTAs;
    while that launch would hold fewer than two CTAs per SM, one cluster
    per slab of up to 8 slices.  dx: clusters of up to 8 slices, and more
    slices while the launch would hold fewer than two CTAs per SM."""
    ns = -(-n // 64)
    cs = cluster_size(heads_per_group)
    joint = cluster_size(heads_per_group, 8 // ns)
    dbc = ((joint * ns, joint, heads_per_group // joint)
           if units * 2 * ns * joint >= 2 * 132
           else (cs, cs, heads_per_group // cs))
    s = cs
    while heads_per_group % (2 * s) == 0 and units * s < 2 * 132:
        s *= 2
    return {"dbc": dbc, "dx": (cs, s, heads_per_group // s)}


def slot_floats(n: int) -> int:
    """f32 of one (sequence, chunk, head) state slot: the bf16 body's image
    (hi and lo planes of 64 state rows by ``ceil(N / 64)`` 128-byte
    slabs), which also holds the f32 body's [P][N]."""
    return -(-n // 64) * 2 * 64 * 128 // 4


def tma_dims(b: int, seqlen: int, heads: int, d: int) -> tuple:
    """The 4-D tensor map of a [B, L, heads, D] bf16 tensor as the chunk
    launches encode it (``hopper::make_map``): dims innermost first, the
    byte strides of the outer three, and the box (one 64-column slab of
    one head's 128 chunk rows)."""
    return ((d, heads, seqlen, b), (2 * d, 2 * heads * d, 2 * seqlen * heads * d),
            (64, 1, MAX_CHUNK, 1))


def uses_tma(p: int, n: int) -> bool:
    """Whether the bf16 body's producer loads x, dy, B and C by TMA: every
    stride a whole number of 16-byte pieces and one slab per head; else
    it copies the same tiles (pointers 16-byte aligned as well on the
    card)."""
    return p == MAX_HEAD_DIM and n % 64 == 0


PLAN_KEYS = ("pass_tc", "pass_f32", "chunk_tc", "dbc_f32", "dx_f32",
             "cluster_dbc", "cluster_dx")


def card_plan(chunk: int, n: int, heads_per_group: int) -> dict:
    """The built library's plan at ``(chunk, n, heads_per_group)``
    (``ssd_scan_bwd_plan``): each kernel's dynamic shared memory in bytes
    and the two chunk launches' cluster sizes; builds the library on
    first use."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    fn = _build.load("ssd_backward").ssd_scan_bwd_plan
    _build.check(fn(chunk, n, heads_per_group, ctypes.addressof(out)),
                 "ssd_scan_bwd_plan")
    return dict(zip(PLAN_KEYS, out))


def chunk_smem(n: int) -> int:
    """Dynamic shared memory of a tensor-core chunk CTA (csrc ``Lay``): B
    and C [128][N] in slabs, two stages of {x, dy [128][64], four 64 x 64
    state slabs (the dx launch's whole image; dC's slab of S_c and of
    dS_{c+1}, each hi and lo), the decays, C . dC_state per slab, the
    head's partial vectors} each rounded to 1 KB, five barriers and the 1
    KB alignment slack."""
    ns = -(-n // 64)
    tile = MAX_CHUNK * ns * 128
    stage = 2 * MAX_CHUNK * 128 + 4 * 64 * 128 + 4 * (
        DECAY_FLOATS + CDOT_FLOATS + 3 * MAX_CHUNK + 8 * MAX_CHUNK) + 64
    stage = -(-stage // 1024) * 1024
    return 2 * tile + 2 * stage + 8 * 5 + 1024


def pass_smem(n: int) -> int:
    """Dynamic shared memory of a tensor-core pass CTA (csrc ``PassLay``):
    two stages of {B or C [128][N], x or dy of two heads [2][128][64],
    their decays} each rounded to 1 KB, each head's outgoing state image
    (two bf16 planes of 64 rows by ``ceil(N / 64)`` slabs), four barriers
    and the 1 KB alignment slack."""
    ns = -(-n // 64)
    stage = MAX_CHUNK * ns * 128 + 2 * MAX_CHUNK * 128 + 2 * 4 * DECAY_FLOATS
    stage = -(-stage // 1024) * 1024
    return 2 * stage + 2 * 2 * ns * 64 * 128 + 8 * 4 + 1024


def scratch_floats(b: int, seqlen: int, h: int, p: int, n: int, chunk: int,
                   body: str) -> int:
    """f32 scratch of one call, in the order the C entry point lays it
    out: the state slots entering and the cotangent slots leaving every
    (sequence, chunk, head) (``slot_floats``), the decays and C . dC_state
    of each, the da partials [H, B * L / chunk], and the count of dx CTAs
    done (with padding, 4 floats).  The same for both bodies; no term
    holds a per-position copy of N for each head."""
    del p, body
    bch = b * (seqlen // chunk) * h
    return bch * (2 * slot_floats(n) + DECAY_FLOATS + CDOT_FLOATS) + bch + 4


def ssd_chunk_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b_mat: torch.Tensor, c_mat: torch.Tensor,
                       dy: torch.Tensor, *, chunk_size: int = 64,
                       initial_state: torch.Tensor | None = None,
                       d_final: torch.Tensor | None = None):
    """``(dx, ddt, da, dB, dC, d_initial_state)`` of ``ssd_chunk_scan(x,
    dt, a, b_mat, c_mat, chunk_size=, initial_state=)`` for the cotangents
    ``dy`` [B, L, H, P] (x's dtype) of y and ``d_final`` [B, H, P, N] f32
    (or None: zeros) of the final state.  dx, dB and dC come out in x's
    dtype, summed in f32 and rounded once; ddt, da and d_initial_state in
    f32.  Shapes as the forward takes them, with at least one sequence
    and one position; every tensor contiguous on the card.  Shapes, then dtypes, then devices are checked before anything
    is allocated or launched.  Launches on the current stream without
    synchronising."""
    tensors = {"x": x, "dt": dt, "a": a, "b_mat": b_mat, "c_mat": c_mat,
               "initial_state": initial_state, "dy": dy, "d_final": d_final}
    bsz, seqlen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if (dt.shape != (bsz, seqlen, h) or a.shape != (h,)
            or b_mat.shape != (bsz, seqlen, g, n) or c_mat.shape != b_mat.shape
            or h % g or not 1 <= n <= MAX_STATE or not 1 <= p <= MAX_HEAD_DIM
            or not 1 <= chunk_size <= MAX_CHUNK or seqlen % chunk_size
            or bsz < 1 or seqlen < 1 or dy.shape != x.shape
            or any(t is not None and t.shape != (bsz, h, p, n)
                   for t in (initial_state, d_final))):
        raise ValueError(
            f"ssd_chunk_scan_bwd: bad shapes x {tuple(x.shape)} dt "
            f"{tuple(dt.shape)} a {tuple(a.shape)} B {tuple(b_mat.shape)} "
            f"C {tuple(c_mat.shape)} dy {tuple(dy.shape)} chunk {chunk_size} "
            f"(B, L >= 1, L % chunk == 0, chunk <= {MAX_CHUNK}, "
            f"N <= {MAX_STATE}, P <= {MAX_HEAD_DIM}, H % G == 0; states "
            f"[B, H, P, N])")
    _check_dtypes(tensors, "ssd_chunk_scan_bwd")
    if dy.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_scan_bwd: dy must be {x.dtype}, got "
                        f"{dy.dtype}")
    _check_devices(tensors, "ssd_chunk_scan_bwd")
    body = bwd_body(x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    db = torch.empty_like(b_mat)
    dc = torch.empty_like(c_mat)
    ddt = torch.empty((bsz, seqlen, h), **f32)
    da = torch.empty((h,), **f32)
    d_init = torch.empty((bsz, h, p, n), **f32)
    scratch = torch.empty(
        scratch_floats(bsz, seqlen, h, p, n, chunk_size, body), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = getattr(_build.load("ssd_backward"), ENTRY[body])
    code = fn(ptr(x), ptr(dt), ptr(a), ptr(b_mat), ptr(c_mat),
              ptr(initial_state), ptr(dy), ptr(d_final), ptr(scratch),
              ptr(dx), ptr(ddt), ptr(da), ptr(db), ptr(dc), ptr(d_init),
              bsz, seqlen, h, p, g, n, chunk_size,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ssd_chunk_scan_bwd")
    _build.count(ssd_chunk_scan_bwd)
    return dx, ddt, da, db, dc, d_init


ssd_chunk_scan_bwd.launches = 0
