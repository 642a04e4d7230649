"""Plain PyTorch versions of the attention kernels.

These are the semantics of record for the port's CUDA kernels, and the
path a CPU tensor takes: ``kernels/ops.py`` sends CPU inputs here and
CUDA inputs to the kernels, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  They mirror
``repro/kernels/ref.py`` (``attention_ref``, ``paged_attention_ref`` in
both layouts, ``chunked_prefill_paged_ref``) and compute scores in f32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, H, D] by repeating each KV head."""
    hkv = k.shape[2]
    if hkv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // hkv, dim=2)


def attention_ref(
    q: torch.Tensor,              # [B, Sq, H, Dq]
    k: torch.Tensor,              # [B, Skv, Hkv, Dq]
    v: torch.Tensor,              # [B, Skv, Hkv, Dv]
    *,
    causal: bool = True,
    q_offset: int = 0,
    sliding_window: int | None = None,
    lengths: torch.Tensor | None = None,   # [B] valid kv length per row
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Multi-head attention with GQA, a causal offset and a sliding window.

    ``q_offset`` is the absolute position of ``q[:, 0]`` within the kv
    sequence; with ``sliding_window`` the query at position p sees keys in
    ``(p - window, p]``.  Returns ``[B, Sq, H, Dv]`` in q's dtype."""
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    skv = k.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None] + q_offset
    kv_pos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    if lengths is not None:
        valid = kv_pos < lengths.to(dev)[:, None, None, None]
        logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def paged_attention_ref(
    q: torch.Tensor,              # [B, H, D] one decode query per sequence
    k_pages: torch.Tensor,        # [B, P, page, Hkv, D] or pool [N, page, Hkv, D]
    v_pages: torch.Tensor,        # same layout as k_pages
    lengths: torch.Tensor,        # [B] valid tokens in the cache
    *,
    softmax_scale: float | None = None,
    block_tables: torch.Tensor | None = None,   # [B, P] page ids
) -> torch.Tensor:
    """Decode attention over a block-paged KV cache (one new token).

    Without ``block_tables`` the pages are the contiguous per-sequence
    list ``[B, P, page, Hkv, D]``; with them, k/v are a shared pool
    ``[N, page, Hkv, D]`` and each sequence's pages come from its table
    row.  GQA is contracted per KV-head group.  A row with
    ``lengths == 0`` returns zeros."""
    if block_tables is not None:
        k_pages = k_pages[block_tables.long()]
        v_pages = v_pages[block_tables.long()]
    b, p, page, hkv, d = k_pages.shape
    dv = v_pages.shape[-1]
    h = q.shape[1]
    rep = h // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    k = k_pages.reshape(b, p * page, hkv, d)
    v = v_pages.reshape(b, p * page, hkv, dv)
    qg = q.reshape(b, hkv, rep, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k).float() * scale
    lengths = lengths.to(q.device)
    valid = (torch.arange(p * page, device=q.device)[None, None, None, :]
             < lengths[:, None, None, None])
    s = torch.where(valid, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v).reshape(b, h, dv)
    any_valid = (lengths > 0)[:, None, None]
    return torch.where(any_valid, out, torch.zeros_like(out))


def chunked_prefill_paged_ref(
    q: torch.Tensor,              # [B, Sq, H, D] one prefill chunk per row
    k_pool: torch.Tensor,         # [N, page, Hkv, D] shared page pool
    v_pool: torch.Tensor,         # [N, page, Hkv, Dv]
    lengths: torch.Tensor,        # [B] total valid kv tokens
    block_tables: torch.Tensor,   # [B, P] page ids into the pool
    q_offsets: torch.Tensor,      # [B] absolute position of q[:, 0]
    *,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Chunked prefill over a paged KV cache.

    Row ``b``'s queries sit at positions ``q_offsets[b] + i`` and attend
    causally over the first ``lengths[b]`` tokens of the sequence, read
    through its block table.  Query rows with no visible key return
    zeros."""
    b, sq, h, d = q.shape
    _, page, hkv, dv = v_pool.shape
    p = block_tables.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    rep = h // hkv
    bt = block_tables.long()
    k = k_pool[bt].reshape(b, p * page, hkv, d)
    v = v_pool[bt].reshape(b, p * page, hkv, dv)
    qg = q.reshape(b, sq, hkv, rep, d)
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k).float() * scale
    dev = q.device
    q_pos = q_offsets.to(dev)[:, None] + torch.arange(sq, device=dev)[None, :]
    k_pos = torch.arange(p * page, device=dev)[None, :]
    mask = ((k_pos[:, None, :] <= q_pos[..., None])
            & (k_pos[:, None, :] < lengths.to(dev)[:, None, None]))
    s = torch.where(mask[:, None, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqs,bsgd->bqgrd", probs, v).reshape(b, sq, h, dv)
    row_valid = mask.any(dim=-1)[..., None, None]
    return torch.where(row_valid, out, torch.zeros_like(out))
