"""GQA attention: dense prefill, paged chunked prefill and paged decode,
ported from ``repro/models/attention.py``.

The paged functions update the per-layer pool views ``k_pool`` /
``v_pool`` **in place** (the reference returned new pools and relied on
XLA donation).  A per-layer view ``pool[l]`` is contiguous, and reaches
the kernels without a copy.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.cache import dequant_kvc, quant_kvc
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_, torch_dtype, weight
from repro_torch.models.rope import apply_rope


class Attention(nn.Module):
    """Projection weights ``wq`` [d, H*hd], ``wk``/``wv`` [d, Hkv*hd],
    ``wo`` [H*hd, d]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dt = torch_dtype(cfg.dtype)
        self.wq = weight((d, h * hd), dt, device)
        self.wk = weight((d, hkv * hd), dt, device)
        self.wv = weight((d, hkv * hd), dt, device)
        self.wo = weight((h * hd, d), dt, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def _project_qkv(p: Attention, x, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(b, s, h, hd)
    k = (x @ p.wk).reshape(b, s, hkv, hd)
    v = (x @ p.wv).reshape(b, s, hkv, hd)
    return q, k, v


def attention_prefill(p: Attention, x, cfg: ModelConfig, *, q_offset: int = 0,
                      kv_cache: tuple | None = None):
    """Full-sequence causal attention; returns ``(out, (k, v))``.
    ``kv_cache=(k_prefix, v_prefix)`` [B, Sp, Hkv, hd] is a restored
    prefix: fresh K/V are appended after it and queries attend across
    both (the dense flash kernel with ``q_offset = Sp``)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.arange(s, device=x.device) + q_offset
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rotary_pct)
    if kv_cache is not None:
        k = torch.cat([kv_cache[0].to(k.dtype), k], dim=1)
        v = torch.cat([kv_cache[1].to(v.dtype), v], dim=1)
    out = ops.flash_attention(
        q, k, v, causal=True,
        q_offset=kv_cache[0].shape[1] if kv_cache is not None else 0)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return out @ p.wo, (k, v)


def _masked_rows(ok, page_ids, slots, pool, values):
    """Targets and values of a per-token pool write with the rows of
    ``ok == False`` masked out, without a host sync.

    The reference drops such rows by pushing their page id out of range
    (scatter mode ``drop``); torch raises on an out-of-range index on the
    CPU and faults on the GPU.  Here every masked row is pointed instead
    at the first valid row's target and given that row's value, so it
    rewrites the same bytes; with no valid row at all, every row
    rewrites the target's current value."""
    first = torch.argmax(ok.to(torch.int32))
    pid_f, slot_f = page_ids[first], slots[first]
    fill = torch.where(ok[first], values[first], pool[pid_f, slot_f])
    page_ids = torch.where(ok, page_ids, pid_f)
    slots = torch.where(ok, slots, slot_f)
    values = torch.where(ok[:, None, None], values, fill)
    return page_ids, slots, values


def attention_prefill_paged(p: Attention, x, cfg: ModelConfig, *, k_pool,
                            v_pool, block_tables, q_offsets, n_valid):
    """A batch of prefill chunks against the shared page pool.

    ``x`` [R, C, d_model]; ``k_pool``/``v_pool`` [N, page, Hkv, hd] (one
    layer, updated in place); ``block_tables`` [R, P]; ``q_offsets`` /
    ``n_valid`` [R] int32.  Each row's chunk K/V are written into its
    pages first (per token, so a chunk need not start on a page
    boundary); positions past ``n_valid`` are masked out of the write.
    Then the chunk's queries attend over everything valid so far, read in
    place through the block tables.  Returns the attention output."""
    r, c = x.shape[0], x.shape[1]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    page = k_pool.shape[1]
    num_tables = block_tables.shape[1]
    dev = x.device

    q, k_new, v_new = _project_qkv(p, x, cfg)
    positions = q_offsets[:, None] + torch.arange(c, dtype=torch.int32,
                                                  device=dev)   # [R, C]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.rotary_pct)

    ok = (torch.arange(c, device=dev)[None, :] < n_valid[:, None]).reshape(-1)
    table_idx = torch.clamp(positions // page, 0, num_tables - 1).long()
    page_ids = torch.gather(block_tables, 1, table_idx).reshape(-1).long()
    slots = (positions % page).reshape(-1).long()
    int8_kvc = k_pool.dtype == torch.int8
    if int8_kvc:
        k_new, v_new = quant_kvc(k_new), quant_kvc(v_new)
    kw = k_new.reshape(r * c, hkv, hd).to(k_pool.dtype)
    vw = v_new.reshape(r * c, hkv, hd).to(v_pool.dtype)
    pid_k, slot_k, kw = _masked_rows(ok, page_ids, slots, k_pool, kw)
    pid_v, slot_v, vw = _masked_rows(ok, page_ids, slots, v_pool, vw)
    k_pool.index_put_((pid_k, slot_k), kw)
    v_pool.index_put_((pid_v, slot_v), vw)
    if int8_kvc:
        k_read, v_read = dequant_kvc(k_pool, x.dtype), dequant_kvc(v_pool, x.dtype)
    else:
        k_read, v_read = k_pool, v_pool
    out = ops.chunked_prefill_paged(
        q.contiguous(), k_read, v_read, q_offsets + n_valid, block_tables,
        q_offsets)
    return out.reshape(r, c, h * hd) @ p.wo


def attention_decode_paged(p: Attention, x, cfg: ModelConfig, *, k_pool,
                           v_pool, block_tables, lengths,
                           contiguous: bool = False):
    """One-token decode against the shared page pool (continuous
    batching); ``x`` [B, 1, d_model], ``lengths`` [B] int32 tokens already
    cached per sequence.  The new K/V is written in place at position
    ``lengths[b]``; then every slot attends over its pages.

    ``contiguous`` (slot-region pools): slot ``b`` owns pages
    ``[b*P, (b+1)*P)``, so the page id is arithmetic and attention reads
    the pool as ``[B, P, page, Hkv, hd]`` by reshape; otherwise pages
    resolve through ``block_tables`` [B, P]."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    page = k_pool.shape[1]
    pos = lengths

    q, k_new, v_new = _project_qkv(p, x, cfg)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.rotary_pct)

    if contiguous:
        p_max = k_pool.shape[0] // b
        table_idx = torch.clamp(pos // page, 0, p_max - 1)
        page_ids = (torch.arange(b, device=x.device) * p_max + table_idx)
    else:
        table_idx = torch.clamp(pos // page, 0, block_tables.shape[1] - 1)
        page_ids = torch.gather(block_tables, 1,
                                table_idx[:, None].long())[:, 0]
    page_ids = page_ids.long()
    slots = (pos % page).long()
    int8_kvc = k_pool.dtype == torch.int8
    if int8_kvc:
        k_new, v_new = quant_kvc(k_new), quant_kvc(v_new)
    k_pool.index_put_((page_ids, slots), k_new[:, 0].to(k_pool.dtype))
    v_pool.index_put_((page_ids, slots), v_new[:, 0].to(v_pool.dtype))
    if int8_kvc:
        k_read, v_read = dequant_kvc(k_pool, x.dtype), dequant_kvc(v_pool, x.dtype)
    else:
        k_read, v_read = k_pool, v_pool
    qd = q[:, 0].contiguous()
    if contiguous:
        hkv = k_read.shape[2]
        shape = (b, k_read.shape[0] // b, page, hkv, k_read.shape[3])
        out = ops.paged_attention(qd, k_read.reshape(shape),
                                  v_read.reshape(shape), pos + 1)
    else:
        out = ops.paged_attention(qd, k_read, v_read, pos + 1,
                                  block_tables=block_tables)
    return out.reshape(b, 1, h * hd) @ p.wo
