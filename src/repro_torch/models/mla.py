"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), ported
from ``repro/models/mla.py``.

MLA compresses K/V into a per-token latent ``c_kv`` (kv_lora_rank) plus
one RoPE key shared by the heads (qk_rope_head_dim).  The decode cache
holds only ``c_kv || k_rope`` -- 576 values per token and layer at
deepseek-v3's widths, about 14x fewer than GQA K/V -- and that pair is
the payload SkyMemory blocks and chunks for this family.

Prefill expands the latent to full K/V and runs the dense flash kernel
(``ops.flash_attention`` with Dq = dn + dr and Dv = dv); decode uses the
absorbed form: W_UK folds into the query and W_UV into the output, so
attention runs against the latent cache.  The reference computes decode
in jnp outside any Pallas kernel, and so it stays plain PyTorch here.
Weights keep the reference's names and ``[in, out]`` layouts, with
``w_uk`` [H, r, dn] and ``w_uv`` [H, r, dv] per head.  Under a mesh the
prefill's kernel runs in ``local_map`` on each rank's heads, through
``attention.flash_attention``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.decode import run_striped
from repro_torch.distributed.sharding import (
    is_dtensor,
    merge_heads,
    split_heads,
)
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Norm, dense_init_, torch_dtype, weight
from repro_torch.models.rope import apply_rope


class MLA(nn.Module):
    """``wq_a`` [d, qr], ``q_norm``, ``wq_b`` [qr, H*(dn+dr)], ``wkv_a``
    [d, r+dr], ``kv_norm``, ``w_uk`` [H, r, dn], ``w_uv`` [H, r, dv] and
    ``wo`` [H*dv, d]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        dt = torch_dtype(cfg.dtype)
        self.wq_a = weight((d, qr), dt, device)
        self.q_norm = Norm(cfg, device, qr)
        self.wq_b = weight((qr, h * (dn + dr)), dt, device)
        self.wkv_a = weight((d, r + dr), dt, device)
        self.kv_norm = Norm(cfg, device, r)
        self.w_uk = weight((h, r, dn), dt, device)
        self.w_uv = weight((h, r, dv), dt, device)
        self.wo = weight((h * dv, d), dt, device)

    def init(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals, as ``init_mla`` draws them: the
        per-head ``w_uk`` / ``w_uv`` over the latent rank."""
        for w in (self.wq_a, self.wq_b, self.wkv_a):
            dense_init_(w, generator)
        for w in (self.w_uk, self.w_uv):
            dense_init_(w, generator, fan_in=w.shape[1])
        dense_init_(self.wo, generator)


def _queries(p: MLA, x, cfg: ModelConfig, positions):
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = split_heads(p.q_norm(x @ p.wq_a) @ p.wq_b, cfg.num_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latent(p: MLA, x, cfg: ModelConfig, positions):
    r = cfg.kv_lora_rank
    kv = x @ p.wkv_a
    c_kv = p.kv_norm(kv[..., :r])
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]                # [B, S, dr]
    return c_kv, k_rope


def _expand(c_kv, w):
    """The latent [B, S, r] through per-head ``w`` [H, r, d]: [B, S, H, d],
    contiguous (the reference's ``einsum('bsr,hrd->bshd')``)."""
    h, _, d = w.shape
    return split_heads(c_kv @ merge_heads(w.permute(1, 0, 2)), h, d)


def mla_prefill(p: MLA, x, cfg: ModelConfig, *, q_offset: int = 0,
                sliding_window: int | None = None,
                latent_prefix: tuple | None = None):
    """Full-sequence causal MLA; returns ``(out, (c_kv, k_rope))``, the
    latent pair covering prefix and fresh tokens (the KVC payload).

    ``latent_prefix=(ckv [B, Sp, r], kr [B, Sp, dr])`` is a restored
    prefix: the fresh latents are appended after it, and the queries
    (at positions ``q_offset ...``) attend across both.
    ``sliding_window`` goes to the kernel, as in the reference."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    positions = torch.arange(s, device=x.device) + q_offset
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latent(p, x, cfg, positions)
    if latent_prefix is not None:
        c_kv = torch.cat([latent_prefix[0].to(c_kv.dtype), c_kv], dim=1)
        k_rope = torch.cat([latent_prefix[1].to(k_rope.dtype), k_rope], dim=1)
    skv = c_kv.shape[1]
    # the kernel takes contiguous q/k/v: ``cat`` writes the broadcast
    # RoPE key into every head's row
    k = torch.cat([_expand(c_kv, p.w_uk),
                   k_rope[:, :, None].expand(b, skv, h, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = flash_attention(q, k, _expand(c_kv, p.w_uv), causal=True,
                          q_offset=skv - s, sliding_window=sliding_window,
                          softmax_scale=(dn + dr) ** -0.5)
    return merge_heads(out) @ p.wo, (c_kv, k_rope)


def mla_decode(p: MLA, x, cfg: ModelConfig, *, ckv_cache, krope_cache, pos,
               sliding_window: int | None = None):
    """Absorbed-MLA decode of one token per sequence against the latent
    cache; ``x`` [B, 1, d_model], ``ckv_cache`` [B, S, r] and
    ``krope_cache`` [B, S, dr] (one layer, updated in place), ``pos`` [B]
    int32 tokens already cached per sequence.  Returns the attention
    output [B, 1, d_model].

    With ``sliding_window`` the cache is a ring of ``S`` slots (the new
    latent lands in slot ``pos % S``, attention reads ``min(pos + 1,
    S)`` slots); without one, a row at ``pos >= S`` writes nothing.  The
    new row is written by index where the reference selects it with a
    one-hot ``where`` over the whole cache: the same values without a
    pass over all ``S`` slots per layer and step.

    Latents that are ``DTensor``s striped over their sequence dim
    (``sharding.cache_specs``) are attended stripe by stripe in
    ``local_map``: each rank scores its stripe with a local max and sum
    and each head's log-sum-exp, and the latent contexts [B, H, r] merge
    (``distributed/decode.py``) before ``w_uv``."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = pos[:, None]
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_new, kr_new = _latent(p, x, cfg, positions)

    s_cache = ckv_cache.shape[1]
    slot = pos % s_cache if sliding_window else pos
    n_valid = torch.clamp(pos + 1, max=s_cache) if sliding_window else pos + 1

    # W_UK absorbed into the query: q_abs[h] = q_nope[h] . W_UK[h]^T
    q_abs = torch.einsum("bhd,hrd->bhr", q_nope[:, 0], p.w_uk)
    args = (q_abs, q_rope[:, 0], c_new, kr_new)
    scale = (dn + dr) ** -0.5
    if not is_dtensor(ckv_cache):
        ctx = _latent_stripe(*args, ckv_cache, krope_cache, n_valid, slot, 0,
                             s_cache, scale, x.dtype)
    else:
        def stripe(st, *ts):
            return _latent_stripe(*ts, n_valid[st.rows], slot[st.rows],
                                  st.start, s_cache, scale, x.dtype,
                                  return_lse=True)

        ctx = run_striped(stripe, args, (ckv_cache, krope_cache))
    out = torch.einsum("bhr,hrd->bhd", ctx, p.w_uv)
    return merge_heads(out)[:, None] @ p.wo


def _latent_stripe(q_abs, q_rope, c_new, kr_new, ckv_cache, krope_cache,
                   n_valid, slot, start: int, s_total: int, scale: float,
                   dtype, *, return_lse: bool = False):
    """One stripe of ``mla_decode`` on plain tensors: the latents hold
    slots ``[start, start + S_stripe)`` of ``s_total``.  Writes the new
    latent where its slot falls in the stripe, then returns the latent
    context [B, H, r] of the softmax over the stripe's valid slots, and
    with ``return_lse`` each head's log-sum-exp over them (-inf for a
    stripe without one)."""
    b, s_l = ckv_cache.shape[:2]
    at = slot - start
    keep = ((at >= 0) & (at < s_l) & (slot < s_total))[:, None]
    rows = torch.arange(b, device=ckv_cache.device)
    at = torch.clamp(at, 0, s_l - 1).long()
    for cache, new in ((ckv_cache, c_new), (krope_cache, kr_new)):
        cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype),
                                      cache[rows, at])
    lengths = torch.clamp(n_valid - start, 0, s_l)

    scores = torch.einsum("bhr,bsr->bhs", q_abs, ckv_cache.to(q_abs.dtype))
    scores = scores + torch.einsum("bhd,bsd->bhs", q_rope,
                                   krope_cache.to(q_rope.dtype))
    scores = scores.float() * scale
    valid = (torch.arange(s_l, device=scores.device)[None, None, :]
             < lengths[:, None, None])
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.einsum("bhs,bsr->bhr", probs, ckv_cache.to(dtype))
    if not return_lse:
        return ctx
    lse = torch.where((lengths > 0)[:, None], torch.logsumexp(scores, -1),
                      -torch.inf)
    return ctx, lse
