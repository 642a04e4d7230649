"""The backward of the SSD chunked scan on the card: the wrapper of
``csrc/ssd_backward.cu``.

``ssd_chunk_scan_bwd`` computes the gradient of ``ssd_chunk_scan`` (K5,
which replaces the Pallas ``_kernel`` of ``repro/kernels/ssd_scan.py``).
The reference has no backward kernel -- its ``jax.grad`` differentiates
the jnp scan -- so this is the port's own, deterministic: three launches
(the state and cotangent passes, every chunk's partials, their fixed-order
reduction), no float atomics.  It takes CUDA tensors only;
``kernels/ops.py`` routes a CPU graph to the plain
``ref.ssd_scan_bwd_ref`` through the same ``SSDScan`` function.  Two
bodies, chosen by ``bwd_body`` from the dtype alone: bf16 on tensor
cores (``mma.sync``, the f32 factors split into bf16 hi + lo), f32 on
FMAs.
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

ENTRY = {"tensor-core": "ssd_scan_bwd_bf16", "fma": "ssd_scan_bwd_f32"}
# state rows of a chunk block (csrc/ssd_backward.cu tc_body::PT and
# fma_body::PT): the dB, dC, ddt and da partials are per tile of them
TILE = {"tensor-core": 64, "fma": 32}


def bwd_body(dtype: torch.dtype) -> str:
    """Which body of ``csrc/ssd_backward.cu`` a call runs: ``"tensor-core"``
    for bf16, ``"fma"`` for f32, as the forward chooses (``ssd_body``)."""
    return "tensor-core" if dtype == torch.bfloat16 else "fma"


SMEM_KEYS = ("pass_tc", "chunk_tc", "pass_fma", "chunk_fma")


def card_smem(chunk: int, n: int) -> dict:
    """Each kernel's dynamic shared memory in bytes at ``(chunk, n)``, as
    the built library sizes it (``ssd_scan_bwd_smem``); builds the library
    on first use."""
    out = (ctypes.c_int * len(SMEM_KEYS))()
    fn = _build.load("ssd_backward").ssd_scan_bwd_smem
    _build.check(fn(chunk, n, ctypes.addressof(out)), "ssd_scan_bwd_smem")
    return dict(zip(SMEM_KEYS, out))


def scratch_floats(b: int, seqlen: int, h: int, p: int, n: int, chunk: int,
                   body: str) -> int:
    """f32 scratch of one call, in the order the C entry point lays it
    out: the states entering and the cotangents leaving every chunk [B,
    L / chunk, H, P, N] each, the dB and dC partials [B, L, H, npt, N]
    each, the ddt partials [B, L, H, npt] and the da partials [H, B * L /
    chunk * npt], with npt the number of ``TILE`` row tiles of P."""
    nc = seqlen // chunk
    npt = -(-p // TILE[body])
    return (2 * b * nc * h * p * n + 2 * b * seqlen * h * npt * n
            + b * seqlen * h * npt + h * b * nc * npt)


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
            or h % g or not 1 <= n <= MAX_STATE
            or not 1 <= chunk_size <= MAX_CHUNK or seqlen % chunk_size
            or bsz < 1 or seqlen < 1 or dy.shape != x.shape
            or any(t is not None and t.shape != (bsz, h, p, n)
                   for t in (initial_state, d_final))):
        raise ValueError(
            f"ssd_chunk_scan_bwd: bad shapes x {tuple(x.shape)} dt "
            f"{tuple(dt.shape)} a {tuple(a.shape)} B {tuple(b_mat.shape)} "
            f"C {tuple(c_mat.shape)} dy {tuple(dy.shape)} chunk {chunk_size} "
            f"(B, L >= 1, L % chunk == 0, chunk <= {MAX_CHUNK}, "
            f"N <= {MAX_STATE}, H % G == 0; states [B, H, P, N])")
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
