"""Paged decode attention on the card: the wrapper of
``csrc/paged_attention.cu``.

One CUDA kernel replaces both Pallas decode kernels of
``repro/kernels/paged_attention.py`` (contiguous pages and block
tables), in one launch: each sequence's keys are cut into splits of
``SPLIT`` tokens (``decode_splits``), each split computes a softmax
partial for the query heads of its kv head, and the last split of each
(sequence, kv head) to finish combines them; asked for, it also writes
each query head's log-sum-exp, so that partial attentions over stripes
of one sequence merge exactly, and from bf16 inputs it can write its
output in f32, so that such partials merge unrounded.  ``paged_decode`` takes
CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to the plain
version in ``kernels/ref.py``.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SPLIT = 64   # tokens per block: ``SPLIT`` in csrc/paged_attention.cu

# Per device, the kernel's arrival counters: zeros, and zero again after
# every launch, so one buffer serves every call and CUDA-graph replay.
# That holds only while every launch that shares the buffer is ordered
# on one stream: two launches running at once on two streams would count
# each other's arrivals.  The serving threads (replicas, adapter workers,
# the streaming worker) all launch on the device's default stream.
# Buffers are only ever added, never freed, because a captured graph
# keeps the address it was captured with; ``_COUNTERS_LOCK`` makes the
# check-then-grow atomic across those threads.
_COUNTERS: dict[torch.device, list[torch.Tensor]] = {}
_COUNTERS_LOCK = threading.Lock()


def decode_splits(pages_per_seq: int, page: int) -> int:
    """The number of token splits the kernel's grid has per (sequence,
    kv head): ``ceil(pages_per_seq * page / SPLIT)``.  Split ``s`` covers
    tokens ``[s * SPLIT, (s + 1) * SPLIT)``; splits at or past a
    sequence's length exit without work."""
    return -(-pages_per_seq * page // SPLIT)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's counter buffer, grown to at least ``n`` entries."""
    with _COUNTERS_LOCK:
        bufs = _COUNTERS.setdefault(device, [])
        if not bufs or bufs[-1].numel() < n:
            if (device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    "paged_decode: call it once outside CUDA-graph capture "
                    "first, so that its counters exist")
            bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                    device=device))
        return bufs[-1]


def _check_inputs(q, k, v, lengths, block_tables):
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_cuda:
            raise ValueError(f"paged_decode: {name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"paged_decode: q/k/v must share one of "
                        f"{list(_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("paged_decode: lengths must be int32")
    if block_tables is not None:
        if (not block_tables.is_cuda or block_tables.dtype != torch.int32
                or not block_tables.is_contiguous()):
            raise ValueError("paged_decode: block_tables must be a "
                             "contiguous int32 CUDA tensor")


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 lengths: torch.Tensor,
                 block_tables: torch.Tensor | None = None, *,
                 softmax_scale: float | None = None,
                 return_lse: bool = False,
                 out_dtype: torch.dtype | None = None):
    """Decode attention of ``q`` [B, H, D] over paged K/V; returns
    [B, H, Dv] in ``out_dtype`` (q's dtype, or f32: the f32 values that
    q's dtype would round), and with ``return_lse`` also each head's
    log-sum-exp of its scaled scores, [B, H] f32 (natural log; -inf for
    a sequence of length 0): ``(out, lse)``.  The output is the same with
    or without it.

    With ``block_tables`` [B, P] (int32), k/v are a shared pool
    [N, page, Hkv, D]; without, they are contiguous per-sequence pages
    [B, P, page, Hkv, D] (the pool viewed by slot region, no copy).
    ``lengths`` [B] int32 counts each sequence's valid tokens.  Launches
    on the current stream without synchronising.  It has no backward
    and refuses a graph (``_build.refuse_grad``)."""
    _build.refuse_grad("paged_decode", q, k_pool, v_pool)
    _check_inputs(q, k_pool, v_pool, lengths, block_tables)
    b, h, d = q.shape
    if block_tables is None:
        if k_pool.dim() != 5 or k_pool.shape[0] != b:
            raise ValueError("paged_decode: contiguous pages must be "
                             f"[B, P, page, Hkv, D], got {tuple(k_pool.shape)}")
        pages_per_seq = k_pool.shape[1]
        k_pool = k_pool.flatten(0, 1)
        v_pool = v_pool.flatten(0, 1)
    else:
        if block_tables.dim() != 2 or block_tables.shape[0] != b:
            raise ValueError("paged_decode: block_tables must be [B, P]")
        pages_per_seq = block_tables.shape[1]
    if k_pool.dim() != 4:
        raise ValueError(f"paged_decode: pool must be [N, page, Hkv, D], "
                         f"got {tuple(k_pool.shape)}")
    _, page, hkv, dk = k_pool.shape
    dv = v_pool.shape[-1]
    if (dk != d or v_pool.shape[:3] != k_pool.shape[:3] or h % hkv
            or max(d, dv) > 256 or d % 8 or dv % 8 or lengths.shape != (b,)):
        raise ValueError(
            f"paged_decode: bad shapes q {tuple(q.shape)} k "
            f"{tuple(k_pool.shape)} v {tuple(v_pool.shape)} lengths "
            f"{tuple(lengths.shape)} (head_dim <= 256 and a multiple of 8, "
            "H % Hkv == 0)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode: k/v pools must be 16-byte aligned")
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"paged_decode: out_dtype must be {q.dtype} or "
                        f"float32, got {out_dtype}")
    out = torch.empty((b, h, dv), dtype=out_dtype, device=q.device)
    # per-split partial (numerators, max, denominator) of each query head
    part = torch.empty((b, hkv, decode_splits(pages_per_seq, page), h // hkv,
                        dv + 2), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    counters = _counters(q.device, b * hkv)
    name = _DTYPES[q.dtype] + ("_out_f32" if out_dtype != q.dtype else "")
    fn = getattr(_build.load("paged_attention"), f"paged_decode_{name}")
    code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
              lengths.data_ptr(),
              None if block_tables is None else block_tables.data_ptr(),
              part.data_ptr(), counters.data_ptr(), out.data_ptr(),
              None if lse is None else lse.data_ptr(), b,
              pages_per_seq, page, h, hkv, d, dv, scale,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_decode")
    _build.count(paged_decode)
    return (out, lse) if return_lse else out


paged_decode.launches = 0
