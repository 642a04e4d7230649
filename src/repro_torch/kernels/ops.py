"""Kernel entry points, dispatched by the device of the input.

A CPU tensor takes the plain PyTorch version in ``kernels/ref.py``; a
CUDA tensor launches the hand-written Hopper kernel, or the call raises.
There is no switch and no fallback: the device alone decides.  The
signatures are those of ``repro/kernels/ops.py`` without ``impl``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.chunked_prefill import (
    chunked_prefill_paged as _chunked_prefill_paged_kernel,
)
from repro_torch.kernels.chunked_prefill import flash_prefill
from repro_torch.kernels.paged_attention import paged_decode


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no attention kernel for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    sliding_window: int | None = None, lengths=None,
                    softmax_scale: float | None = None):
    """Prefill attention ([B,Sq,H,D] x [B,Skv,Hkv,D])."""
    if _on_cpu(q):
        return ref.attention_ref(
            q, k, v, causal=causal, q_offset=q_offset,
            sliding_window=sliding_window, lengths=lengths,
            softmax_scale=softmax_scale)
    return flash_prefill(
        q, k, v, causal=causal, q_offset=q_offset,
        sliding_window=sliding_window, lengths=lengths,
        softmax_scale=softmax_scale)


def paged_attention(q, k_pages, v_pages, lengths, *,
                    softmax_scale: float | None = None, block_tables=None):
    """Decode attention over a paged KV cache ([B,H,D] x [B,P,page,Hkv,D],
    or a pool [N,page,Hkv,D] through ``block_tables`` [B,P])."""
    if _on_cpu(q):
        return ref.paged_attention_ref(
            q, k_pages, v_pages, lengths, softmax_scale=softmax_scale,
            block_tables=block_tables)
    return paged_decode(q, k_pages, v_pages, lengths, block_tables,
                        softmax_scale=softmax_scale)


def chunked_prefill_paged(q, k_pool, v_pool, lengths, block_tables,
                          q_offsets, *, softmax_scale: float | None = None):
    """Prefill-chunk attention over a shared page pool ([B,Sq,H,D] x
    [N,page,Hkv,D] through [B,P] block tables, runtime offsets)."""
    if _on_cpu(q):
        return ref.chunked_prefill_paged_ref(
            q, k_pool, v_pool, lengths, block_tables, q_offsets,
            softmax_scale=softmax_scale)
    return _chunked_prefill_paged_kernel(
        q, k_pool, v_pool, lengths, block_tables, q_offsets,
        softmax_scale=softmax_scale)
