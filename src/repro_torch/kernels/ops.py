"""Kernel entry points, dispatched by the device of the input.

A CPU tensor takes the plain PyTorch version in ``kernels/ref.py``; a
CUDA tensor launches the hand-written Hopper kernel, or the call raises.
There is no switch and no fallback: the device alone decides.  The
signatures are those of ``repro/kernels/ops.py`` without ``impl``.

Training: when grad is enabled and q, k or v requires it,
``flash_attention`` goes through ``FlashAttention``, whose forward keeps
the LSE and whose backward is the hand-written kernel on the card
(``kernels/flash_backward.py``) and the plain ``ref.attention_bwd_ref``
on the CPU.  Likewise ``ssd_scan`` goes through ``SSDScan``, whose
backward is ``kernels/ssd_backward.py`` on the card and the plain
``ref.ssd_scan_bwd_ref`` on the CPU.  The decode and the paged prefill
have no backward and refuse a graph, and so do the raw kernel wrappers.

Under a mesh (``repro_torch.distributed``) the layers call
``flash_attention`` and ``ssd_scan`` inside ``local_map``, so a kernel,
its autograd ``Function`` and its backward see each rank's local shards
as plain tensors.  A ``DTensor`` that reaches an entry point here raises:
no kernel takes a shard for the whole tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.chunked_prefill import (
    chunked_prefill_paged as _chunked_prefill_paged_kernel,
)
from repro_torch.kernels.chunked_prefill import flash_prefill
from repro_torch.kernels.flash_backward import flash_prefill_bwd
from repro_torch.kernels.paged_attention import paged_decode
from repro_torch.kernels.ssd_backward import ssd_chunk_scan_bwd
from repro_torch.kernels.ssd_scan import ssd_chunk_scan


def _on_cpu(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        raise TypeError(
            "a DTensor reached a kernel: under a mesh the layer calls it "
            "inside local_map, on each rank's local shards")
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


class FlashAttention(torch.autograd.Function):
    """The dense prefill with its gradient.  The forward saves q, k, v, the
    output and its per-row LSE; the backward recomputes the probabilities
    from them (``flash_prefill`` with ``return_lse`` and
    ``flash_prefill_bwd`` on the card, ``ref.attention_fwd_lse_ref`` and
    ``ref.attention_bwd_ref`` on the CPU: the device alone decides)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, sliding_window,
                softmax_scale):
        kw = dict(causal=causal, q_offset=q_offset,
                  sliding_window=sliding_window, softmax_scale=softmax_scale)
        if _on_cpu(q):
            out, lse = ref.attention_fwd_lse_ref(q, k, v, **kw)
        else:
            out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        d_out = d_out.contiguous()
        if _on_cpu(q):
            grads = ref.attention_bwd_ref(q, k, v, out, lse, d_out, **ctx.kw)
        else:
            grads = flash_prefill_bwd(q, k, v, out, lse, d_out, **ctx.kw)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    sliding_window: int | None = None, lengths=None,
                    softmax_scale: float | None = None):
    """Prefill attention ([B,Sq,H,D] x [B,Skv,Hkv,D]).  On the CPU a
    long key sequence (``Skv >= STREAMING_KV_THRESHOLD``, no
    ``lengths``) streams over key blocks and never builds the full
    score matrix, as the reference's jnp path does.  With grad enabled
    and an input that requires it, the call goes through
    ``FlashAttention`` (no ``lengths``: the reference's training never
    passes them)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if lengths is not None:
            raise NotImplementedError("flash_attention: no gradient with "
                                      "lengths")
        return FlashAttention.apply(q, k, v, causal, q_offset,
                                    sliding_window, softmax_scale)
    if _on_cpu(q):
        if lengths is None and k.shape[1] >= ref.STREAMING_KV_THRESHOLD:
            return ref.attention_streaming_ref(
                q, k, v, causal=causal, q_offset=q_offset,
                sliding_window=sliding_window, softmax_scale=softmax_scale,
                block_k=ref.STREAMING_BLOCK_K)
        return ref.attention_ref(
            q, k, v, causal=causal, q_offset=q_offset,
            sliding_window=sliding_window, lengths=lengths,
            softmax_scale=softmax_scale)
    return flash_prefill(
        q, k, v, causal=causal, q_offset=q_offset,
        sliding_window=sliding_window, lengths=lengths,
        softmax_scale=softmax_scale)


def paged_attention(q, k_pages, v_pages, lengths, *,
                    softmax_scale: float | None = None, block_tables=None,
                    return_lse: bool = False, out_dtype=None):
    """Decode attention over a paged KV cache ([B,H,D] x [B,P,page,Hkv,D],
    or a pool [N,page,Hkv,D] through ``block_tables`` [B,P]); with
    ``return_lse``, ``(out, lse [B,H] f32)``; ``out_dtype`` f32 keeps a
    bf16 call's output unrounded."""
    if _on_cpu(q):
        return ref.paged_attention_ref(
            q, k_pages, v_pages, lengths, softmax_scale=softmax_scale,
            block_tables=block_tables, return_lse=return_lse,
            out_dtype=out_dtype)
    return paged_decode(q, k_pages, v_pages, lengths, block_tables,
                        softmax_scale=softmax_scale, return_lse=return_lse,
                        out_dtype=out_dtype)


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


def _ssd_forward(x, dt, a, b_mat, c_mat, chunk_size, initial_state):
    if _on_cpu(x):
        return ref.ssd_scan_ref(x, dt, a, b_mat, c_mat,
                                chunk_size=chunk_size,
                                initial_state=initial_state)
    return ssd_chunk_scan(x, dt, a, b_mat, c_mat, chunk_size=chunk_size,
                          initial_state=initial_state)


class SSDScan(torch.autograd.Function):
    """The SSD chunked scan with its gradient.  The forward saves x, dt,
    a, B, C and the initial state; the backward recomputes the chunk
    states from them (``ssd_chunk_scan_bwd`` on the card,
    ``ref.ssd_scan_bwd_ref`` on the CPU: the device alone decides).  A
    cotangent that is not given (the final state unused) counts as
    zeros."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, initial_state, chunk_size):
        ctx.set_materialize_grads(False)
        y, final = _ssd_forward(x, dt, a, b_mat, c_mat, chunk_size,
                                initial_state)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, initial_state)
        ctx.chunk_size = chunk_size
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a, b_mat, c_mat, initial_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if d_final is not None:
            d_final = d_final.float().contiguous()
        if _on_cpu(x):
            grads = ref.ssd_scan_bwd_ref(x, dt, a, b_mat, c_mat,
                                         initial_state, dy, d_final,
                                         ctx.chunk_size)
        else:
            grads = ssd_chunk_scan_bwd(
                x, dt, a, b_mat, c_mat, dy.to(x.dtype),
                chunk_size=ctx.chunk_size, initial_state=initial_state,
                d_final=d_final)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk_size: int = 64,
             initial_state=None):
    """Mamba-2 SSD chunked scan ([B,L,H,P] -> y, final_state).  With
    grad enabled and an input that requires it, the call goes through
    ``SSDScan``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b_mat, c_mat, initial_state)):
        return SSDScan.apply(x, dt, a, b_mat, c_mat, initial_state,
                             chunk_size)
    return _ssd_forward(x, dt, a, b_mat, c_mat, chunk_size, initial_state)


# the single-token recurrence is plain PyTorch on every device, as the
# reference computes it in jnp on every backend: it is no kernel
ssd_decode_step = ref.ssd_decode_step_ref
