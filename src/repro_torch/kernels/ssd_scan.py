"""The Mamba-2 SSD chunked scan on the card: the wrapper of
``csrc/ssd_scan.cu``.

``ssd_chunk_scan`` replaces the Pallas ``_kernel`` of
``repro/kernels/ssd_scan.py``.  It takes CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to the plain ``ref.ssd_scan_ref``.
Each launch runs one of the two bodies of the kernel, chosen by
``ssd_body`` from the dtype alone: bf16 runs on tensor cores
(``mma.sync``, one launch), f32 on f32 FMAs (two launches).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 128     # the kernel's score tile
MAX_STATE = 128     # its state tile
# the C entry point of each body; only the FMA body takes the f32 C.B^T
# scratch, as its ninth pointer
ENTRY = {"tensor-core": "ssd_scan_bf16", "fma": "ssd_scan_f32"}


def ssd_body(dtype: torch.dtype) -> str:
    """Which body of ``csrc/ssd_scan.cu`` a launch runs: ``"tensor-core"``
    for bf16, ``"fma"`` for f32 (whose limit tensor cores would miss by
    rounding through TF32).  Every chunk size and head dim the scan takes
    runs its dtype's body."""
    return "tensor-core" if dtype == torch.bfloat16 else "fma"


def _check_inputs(tensors: dict, what: str = "ssd_chunk_scan") -> None:
    """``_check_devices``, then ``_check_dtypes``; ``what`` names the
    caller."""
    _check_devices(tensors, what)
    _check_dtypes(tensors, what)


def _check_devices(tensors: dict, what: str) -> None:
    """Every tensor given is on the card and contiguous."""
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check_dtypes(tensors: dict, what: str) -> None:
    """x, B and C share one of ``_DTYPES``; dt, a and the states
    (``initial_state``, and the backward's ``d_final``) are f32."""
    x, b_mat, c_mat = tensors["x"], tensors["b_mat"], tensors["c_mat"]
    if x.dtype not in _DTYPES or b_mat.dtype != x.dtype \
            or c_mat.dtype != x.dtype:
        raise TypeError(f"{what}: x/B/C must share one of "
                        f"{list(_DTYPES)}, got {x.dtype}/{b_mat.dtype}/"
                        f"{c_mat.dtype}")
    for name in ("dt", "a", "initial_state", "d_final"):
        t = tensors.get(name)
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32")


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                   chunk_size: int = 64,
                   initial_state: torch.Tensor | None = None):
    """x [B, L, H, P]; dt [B, L, H] f32; a [H] f32; B/C [B, L, G, N];
    ``initial_state`` [B, H, P, N] f32 or None (zeros).

    Returns ``(y [B, L, H, P] in x's dtype, final_state [B, H, P, N]
    f32)``, the contract of ``ref.ssd_scan_ref``.  ``L`` must be a
    multiple of ``chunk_size`` (1 to 128), ``N`` at most 128, ``B`` and
    ``L`` at least 1; shapes are checked before devices and dtypes, so an
    empty call is refused on every device.  Launches
    on the current stream without synchronising.  Called directly it
    refuses a graph (``_build.refuse_grad``): training reaches it through
    ``ops.SSDScan``, whose backward is ``ssd_backward.ssd_chunk_scan_bwd``."""
    _build.refuse_grad("ssd_chunk_scan", x, dt, a, b_mat, c_mat,
                       initial_state)
    bsz, seqlen, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if (dt.shape != (bsz, seqlen, h) or a.shape != (h,)
            or b_mat.shape != (bsz, seqlen, g, n) or c_mat.shape != b_mat.shape
            or h % g or not 1 <= n <= MAX_STATE
            or not 1 <= chunk_size <= MAX_CHUNK or seqlen % chunk_size
            or bsz < 1 or seqlen < 1
            or (initial_state is not None
                and initial_state.shape != (bsz, h, p, n))):
        raise ValueError(
            f"ssd_chunk_scan: bad shapes x {tuple(x.shape)} dt "
            f"{tuple(dt.shape)} a {tuple(a.shape)} B {tuple(b_mat.shape)} "
            f"C {tuple(c_mat.shape)} chunk {chunk_size} (B, L >= 1, "
            f"L % chunk == 0, chunk <= {MAX_CHUNK}, N <= {MAX_STATE}, "
            f"H % G == 0)")
    _check_inputs({"x": x, "dt": dt, "a": a, "b_mat": b_mat,
                   "c_mat": c_mat, "initial_state": initial_state})
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(),
            None if initial_state is None else initial_state.data_ptr()]
    body = ssd_body(x.dtype)
    if body == "fma":
        # C.B^T of every (sequence, group, chunk), key columns padded to 32
        key_cols = -(-chunk_size // 32) * 32
        cb = torch.empty(bsz * g * seqlen * key_cols, dtype=torch.float32,
                         device=x.device)
        ptrs.append(cb.data_ptr())
    fn = getattr(_build.load("ssd_scan"), ENTRY[body])
    code = fn(*ptrs, y.data_ptr(), final.data_ptr(), bsz, seqlen, h, p, g,
              n, chunk_size, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ssd_chunk_scan")
    _build.count(ssd_chunk_scan)
    return y, final


ssd_chunk_scan.launches = 0
