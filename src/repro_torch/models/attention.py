"""GQA attention: dense prefill (causal, or non-causal for an encoder
and for cross-attention), paged chunked prefill, paged decode, and
decode over a dense per-sequence cache or a frozen cross K/V, ported
from ``repro/models/attention.py``.

The paged functions update the per-layer pool views ``k_pool`` /
``v_pool``, and ``attention_decode`` the per-layer cache views
``k_cache`` / ``v_cache``, **in place** (the reference returned new
arrays and relied on XLA donation).  A per-layer view ``pool[l]`` is
contiguous, and reaches the kernels without a copy.

Under a mesh (training, ``repro_torch.distributed``) the projections and
RoPE run as ``DTensor`` ops; a projection sharded inside a head is
gathered before the head split, and a gradient before the backward of a
merge (``sharding.split_heads`` / ``merge_heads``), and the dense
prefill kernel runs in ``local_map`` on each rank's batch rows and heads
(``flash_attention``).  Decode over a cache
striped over its sequence dim runs the decode kernel on each rank's
stripe and merges the stripes (``attention_decode``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.decode import run_striped
from repro_torch.distributed.sharding import (
    active_rules,
    divisible,
    is_dtensor,
    maybe_shard,
    merge_heads,
    partial_over,
    placements,
    run_local,
    split_heads,
)
from repro_torch.kernels import ops
from repro_torch.models.cache import dequant_kvc, quant_kvc
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_, torch_dtype, weight
from repro_torch.models.rope import apply_rope

PAGE_SIZE = 128  # KV-cache page (= the paper's 128-token block)


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


def _project_qkv(p: Attention, x, cfg: ModelConfig, kv_x=None):
    """q from ``x``, and k / v from ``kv_x`` (cross-attention's source)
    or, without it, from ``x``."""
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_x = x if kv_x is None else kv_x
    return (split_heads(x @ p.wq, h, hd), split_heads(kv_x @ p.wk, hkv, hd),
            split_heads(kv_x @ p.wv, hkv, hd))


def flash_attention(q, k, v, **kw):
    """``ops.flash_attention``; under a mesh, inside ``local_map`` on each
    rank's batch rows and query heads (``sharded_flash_attention``)."""
    rules = active_rules()
    if rules is None or not is_dtensor(q):
        return ops.flash_attention(q, k, v, **kw)
    return sharded_flash_attention(q, k, v, rules, **kw)


def sharded_flash_attention(q, k, v, rules, **kw):
    """The dense prefill kernel on each rank's shards: batch over the data
    axes and query heads over ``model`` where they divide.  K/V heads go
    over ``model`` with the queries when they divide too; otherwise every
    rank of ``model`` reads K/V whole (their gradient is then a partial
    sum) and keeps the heads its query heads meet, so query head ``h``
    always meets K/V head ``h // rep`` on its own rank."""
    mesh = q.device_mesh
    tp = rules.model_axis
    h, hkv = q.shape[2], k.shape[2]
    spec_q = divisible(q.shape, (rules.data, None, tp, None), rules)
    m = rules.axis_size(tp) if spec_q[2] is not None else 1
    kv_split = m == 1 or hkv % m == 0
    spec_kv = (spec_q[0], None, spec_q[2] if kv_split else None, None)
    place_q, place_kv = placements(spec_q, mesh), placements(spec_kv, mesh)
    grad_kv = place_kv if kv_split else partial_over(place_kv, mesh, tp)

    def local(ql, kl, vl):
        if not kv_split:
            hl, rep = h // m, h // hkv
            r = mesh.get_local_rank(tp)
            heads = (r * hl + torch.arange(hl, device=kl.device)) // rep
            if hl % rep == 0 or rep % hl == 0:
                heads = heads[::min(rep, hl)]   # each K/V head once
            kl, vl = kl[:, :, heads], vl[:, :, heads]
        return ops.flash_attention(ql, kl, vl, **kw)

    return run_local(local, mesh, (place_q, place_kv, place_kv), place_q,
                     (place_q, grad_kv, grad_kv))(q, k, v)


def attention_prefill(p: Attention, x, cfg: ModelConfig, *, q_offset: int = 0,
                      sliding_window: int | None = None,
                      kv_cache: tuple | None = None, kv_x=None,
                      causal: bool = True):
    """Full-sequence attention; returns ``(out, (k, v))``.
    ``kv_cache=(k_prefix, v_prefix)`` [B, Sp, Hkv, hd] is a restored
    prefix: fresh K/V are appended after it and queries attend across
    both (the dense flash kernel with ``q_offset = Sp``).

    ``causal=False`` is the encoder's self-attention (RoPE as usual).
    With ``kv_x`` [B, S_src, d_model] the call is cross-attention: K/V
    are projected from ``kv_x``, neither q nor k gets RoPE, and every
    query sees every source position (non-causal, offset 0).

    ``sliding_window`` (the training forward's ``cfg.sliding_window``)
    lets the query at position p see keys in ``(p - window, p]``; it goes
    to the kernel as it is, as the reference passes it."""
    b, s, _ = x.shape
    cross = kv_x is not None
    q, k, v = _project_qkv(p, x, cfg, kv_x)
    if not cross:
        pos = torch.arange(s, device=x.device) + q_offset
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rotary_pct)
    if kv_cache is not None:
        k = torch.cat([kv_cache[0].to(k.dtype), k], dim=1)
        v = torch.cat([kv_cache[1].to(v.dtype), v], dim=1)
    offset = kv_cache[0].shape[1] if kv_cache is not None and not cross else 0
    out = flash_attention(q, k, v, causal=causal and not cross,
                          q_offset=offset, sliding_window=sliding_window)
    return merge_heads(out) @ p.wo, (k, v)


def _masked_rows(ok, page_ids, slots, pool, values):
    """Targets and values of a per-token pool write with the rows of
    ``ok == False`` masked out, without a host sync.

    The reference drops such rows by pushing their page id out of range
    (scatter mode ``drop``); torch raises on an out-of-range index on the
    CPU and faults on the GPU.  Here every masked row is pointed instead
    at the first valid row's target and given that row's value, so it
    rewrites the same bytes; with no valid row at all, every row
    rewrites the target's current value."""
    # a one-element index: indexing by a 0-d tensor reads it on the host
    first = torch.argmax(ok.to(torch.int32)).reshape(1)
    pid_f, slot_f = page_ids[first], slots[first]
    fill = torch.where(ok[first][:, None, None], values[first],
                       pool[pid_f, slot_f])
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
    q = maybe_shard(q, "decode_qkv")
    k_new = maybe_shard(k_new, "decode_qkv")
    v_new = maybe_shard(v_new, "decode_qkv")

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
    return merge_heads(out) @ p.wo


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
    page = k_pool.shape[1]
    pos = lengths

    q, k_new, v_new = _project_qkv(p, x, cfg)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.rotary_pct)
    q = maybe_shard(q, "decode_qkv")
    k_new = maybe_shard(k_new, "decode_qkv")
    v_new = maybe_shard(v_new, "decode_qkv")

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
    return merge_heads(out[:, None]) @ p.wo


def attention_decode(p: Attention, x, cfg: ModelConfig, *, k_cache=None,
                     v_cache=None, pos=None,
                     sliding_window: int | None = None,
                     cross_kv: tuple | None = None):
    """One-token decode over a dense per-sequence cache; ``x`` [B, 1,
    d_model], ``k_cache``/``v_cache`` [B, S, Hkv, hd] (one layer, updated
    in place), ``pos`` [B] int32 tokens already cached per sequence.
    Returns the attention output [B, 1, d_model].

    With ``cross_kv=(k, v)`` [B, S_src, Hkv, hd] (one layer of the
    encoder-decoder's frozen cross K/V) the call is cross-attention
    instead: q = ``x @ wq`` without RoPE attends over all ``S_src``
    positions of every row, and nothing is written (the self cache and
    ``pos`` are not read).

    RoPE is applied at the absolute position ``pos`` before the write.
    With ``sliding_window`` the cache is a ring of ``S`` slots: the new
    K/V lands in slot ``pos % S`` and attention reads
    ``min(pos + 1, S)`` slots, so relative phases stay right after the
    ring wraps.  Without one, a row at ``pos >= S`` writes nothing (the
    reference's one-hot matches no slot) and reads all ``S``.

    The new row is written by index (one row per sequence) where the
    reference selects it with a one-hot ``where`` over the whole cache:
    the same values without a pass over all ``S`` slots per layer and
    step.

    A cache that is a ``DTensor`` striped over its sequence dim
    (``sharding.cache_specs``; ``x`` and the weights ``DTensor``s too)
    is attended stripe by stripe: each rank writes the new row only where
    it owns the slot, runs the kernel with its log-sum-exp over its
    stripe, and the ranks' partials merge (``distributed/decode.py``)."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    if cross_kv is not None:
        k, v = cross_kv
        q = split_heads(x @ p.wq, h, hd)
        n_valid = torch.full((b,), k.shape[1], dtype=torch.int32,
                             device=x.device)
        out = _decode_attend(q, k, v, n_valid)
        return merge_heads(out[:, None]) @ p.wo
    s_cache = k_cache.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.rotary_pct)
    # with TP attention projections and a striped cache, gather the tiny
    # q / k / v rather than the cache
    q = maybe_shard(q, "decode_qkv")
    k_new = maybe_shard(k_new, "decode_qkv")
    v_new = maybe_shard(v_new, "decode_qkv")

    slot = pos % s_cache if sliding_window else pos
    n_valid = torch.clamp(pos + 1, max=s_cache) if sliding_window else pos + 1
    out = _decode_attend(q, k_cache, v_cache, n_valid,
                         (k_new, v_new, slot))
    return merge_heads(out[:, None]) @ p.wo


def _decode_attend(q, k_cache, v_cache, n_valid, new=None):
    """Attention of ``q`` [B, 1, H, hd] over the cache [B, S, Hkv, hd]
    (``n_valid`` [B] valid slots a row), after writing ``new = (k_new,
    v_new [B, 1, Hkv, hd], slot [B])`` where given; returns [B, H, hd].
    A ``DTensor`` cache runs ``_attend_stripe`` on each rank's stripe
    and merges the partials (``run_striped``), which the kernel writes in
    f32 when there are several; ``n_valid`` and ``slot`` are whole on
    every rank."""
    s_cache = k_cache.shape[1]
    if not is_dtensor(k_cache):
        return _attend_stripe(q, k_cache, v_cache, n_valid, new, 0, s_cache)

    def stripe(st, ql, *rest):
        news, (kl, vl) = rest[:-2], rest[-2:]
        new_l = (*news, new[2][st.rows]) if new else None
        return _attend_stripe(
            ql, kl, vl, n_valid[st.rows], new_l, st.start, s_cache,
            return_lse=True,
            out_dtype=torch.float32 if st.count > 1 else None)

    rows = (q, *new[:2]) if new else (q,)
    return run_striped(stripe, rows, (k_cache, v_cache))


def _attend_stripe(q, k_cache, v_cache, n_valid, new, start: int,
                   s_total: int, *, return_lse: bool = False,
                   out_dtype=None):
    """One stripe's part of ``_decode_attend``, on plain tensors: the
    cache holds slots ``[start, start + S_stripe)`` of ``s_total``.  The
    new row (``new``) is written where its slot falls in the stripe (and
    below ``s_total``); then the kernel attends over the stripe's valid
    slots, ``clamp(n_valid - start, 0, S_stripe)``, with its
    log-sum-exp when ``return_lse``, its output in ``out_dtype``
    (``ops.paged_attention``).  An int8 cache is dequantized here."""
    b, s_l = k_cache.shape[:2]
    if new is not None:
        k_new, v_new, slot = new
        at = slot - start
        keep = ((at >= 0) & (at < s_l) & (slot < s_total))[:, None, None]
        rows = torch.arange(b, device=k_cache.device)
        at = torch.clamp(at, 0, s_l - 1).long()
        if k_cache.dtype == torch.int8:
            k_new, v_new = quant_kvc(k_new), quant_kvc(v_new)
        for cache, row in ((k_cache, k_new), (v_cache, v_new)):
            cache[rows, at] = torch.where(keep, row[:, 0].to(cache.dtype),
                                          cache[rows, at])
    lengths = torch.clamp(n_valid - start, 0, s_l).to(torch.int32)
    if k_cache.dtype == torch.int8:
        k_read, v_read = (dequant_kvc(k_cache, q.dtype),
                          dequant_kvc(v_cache, q.dtype))
    else:
        k_read, v_read = k_cache, v_cache
    return _paged(q[:, 0].contiguous(), k_read, v_read, lengths,
                  return_lse=return_lse, out_dtype=out_dtype)


def _paged(q, k_cache, v_cache, lengths, *, return_lse: bool = False,
           out_dtype=None):
    """View the contiguous cache ``[B, S, Hkv, hd]`` as pages of
    ``PAGE_SIZE`` tokens (one page of ``S`` when that does not divide
    ``S``) and run the paged-decode kernel."""
    b, s, hkv, hd = k_cache.shape
    page = PAGE_SIZE if s % PAGE_SIZE == 0 else s
    kp = k_cache.reshape(b, s // page, page, hkv, hd)
    vp = v_cache.reshape(b, s // page, page, hkv, v_cache.shape[-1])
    return ops.paged_attention(q, kp, vp, lengths, return_lse=return_lse,
                               out_dtype=out_dtype)
