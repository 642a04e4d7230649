"""Prefill attention on the card: the wrappers of
``csrc/chunked_prefill.cu``.

* ``chunked_prefill_paged`` replaces the Pallas ``_kernel_paged`` of
  ``repro/kernels/chunked_prefill.py``: a prefill chunk at runtime
  offsets attends over a shared page pool through block tables.
* ``flash_prefill`` replaces its ``_kernel``: dense flash attention with
  a ``q_offset``, causal or not, an optional sliding window, GQA and
  Dq != Dv.

Both take CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the
plain versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check(name: str, tensors: dict, ints: dict) -> None:
    for n, t in {**tensors, **ints}.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {n} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    dts = {t.dtype for t in tensors.values()}
    if len(dts) != 1 or next(iter(dts)) not in _DTYPES:
        raise TypeError(f"{name}: q/k/v must share one of {list(_DTYPES)}, "
                        f"got {sorted(map(str, dts))}")
    for n, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {n} must be int32")


def chunked_prefill_paged(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, lengths: torch.Tensor,
                          block_tables: torch.Tensor,
                          q_offsets: torch.Tensor, *,
                          softmax_scale: float | None = None) -> torch.Tensor:
    """q [R, C, H, Dq] over pool [N, page, Hkv, D]/[.., Dv] through
    block tables [R, P]; ``lengths``/``q_offsets`` [R] int32.  Returns
    [R, C, H, Dv]; query rows with no visible key are zeros."""
    _check("chunked_prefill_paged", {"q": q, "k_pool": k_pool, "v_pool": v_pool},
           {"lengths": lengths, "block_tables": block_tables,
            "q_offsets": q_offsets})
    r, c, h, d = q.shape
    if k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("chunked_prefill_paged: pools must be "
                         "[N, page, Hkv, D]")
    _, page, hkv, dk = k_pool.shape
    dv = v_pool.shape[-1]
    if (dk != d or v_pool.shape[:3] != k_pool.shape[:3] or h % hkv
            or max(d, dv) > 256 or block_tables.dim() != 2
            or block_tables.shape[0] != r or lengths.shape != (r,)
            or q_offsets.shape != (r,)):
        raise ValueError(
            f"chunked_prefill_paged: bad shapes q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} block_tables "
            f"{tuple(block_tables.shape)} (head_dim <= 256, H % Hkv == 0)")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty((r, c, h, dv), dtype=q.dtype, device=q.device)
    fn = getattr(_build.load("chunked_prefill"),
                 f"chunked_prefill_paged_{_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
              lengths.data_ptr(), q_offsets.data_ptr(),
              block_tables.data_ptr(), out.data_ptr(), r, c, h, hkv, d, dv,
              page, block_tables.shape[1], scale,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "chunked_prefill_paged")
    chunked_prefill_paged.launches += 1
    return out


chunked_prefill_paged.launches = 0


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  sliding_window: int | None = None, lengths=None,
                  softmax_scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, H, Dq] against k [B, Skv, Hkv, Dq], v [.., Dv]; returns
    [B, Sq, H, Dv].  ``q_offset`` is the absolute position of q[:, 0].
    Like the TPU kernel it replaces, it takes no ``lengths``."""
    if lengths is not None:
        raise NotImplementedError("use paged_attention for length masking")
    _check("flash_prefill", {"q": q, "k": k, "v": v}, {})
    b, sq, h, d = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_prefill: k/v must be [B, Skv, Hkv, D]")
    _, skv, hkv, dk = k.shape
    dv = v.shape[-1]
    if (k.shape[0] != b or dk != d or v.shape[:3] != k.shape[:3] or h % hkv
            or max(d, dv) > 256):
        raise ValueError(
            f"flash_prefill: bad shapes q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} "
            "(head_dim <= 256, H % Hkv == 0)")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    fn = getattr(_build.load("chunked_prefill"),
                 f"flash_prefill_{_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
              skv, h, hkv, d, dv, scale, int(q_offset), int(bool(causal)),
              int(sliding_window or 0),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
