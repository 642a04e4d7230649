"""The model, ported from ``repro/models/model.py``: the GQA decoder
(dense, MoE, and the VLM backbone) and the attention-free SSM (Mamba-2)
stack.

``Model`` is an ``nn.Module`` holding its weights (``embed``, an
``nn.ModuleList`` of ``blocks``, ``final_norm``) on one device.  The
reference's ``lax.scan`` over stacked layers is a Python loop over
``self.blocks``.  A block's feed-forward is its ``mlp`` or, when
``cfg.num_experts``, its ``moe`` (every layer: ``first_k_dense`` applies
only with MLA in the reference).  The GQA families serve through the
paged steps, which write each layer's K/V into ``k_pool[l]`` /
``v_pool[l]`` in place; the SSM family through ``decode_step`` over the
fixed-size dense cache of ``init_cache``.  Any other family raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    Attention,
    attention_decode_paged,
    attention_prefill,
    attention_prefill_paged,
)
from repro_torch.models.cache import (
    PagedKVCache,
    init_cache,
    supports_paged_decode,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Embed, Norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssd import SSD, ssd_decode, ssd_prefill


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.arch_type not in ("dense", "moe", "vlm", "ssm")
            or cfg.use_mla or cfg.is_encoder_decoder or cfg.sliding_window):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA, MoE, VLM and SSM families "
            "are ported; the MLA, hybrid, encoder-decoder and "
            "sliding-window families wait for ROADMAP.md queue 1")


class Block(nn.Module):
    """Attention and a feed-forward: ``mlp``, or ``moe`` for the MoE
    family (the reference's ``_init_block``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm2 = Norm(cfg, device)
        self.is_moe = cfg.num_experts > 0
        if self.is_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        if self.is_moe:
            return self.moe(h)[0]       # (y, aux): serving drops the aux
        return self.mlp(h)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.ssd = SSD(cfg, device)


class Model(nn.Module):
    """Dense GQA decoder or SSM stack on ``device`` (default ``"cuda"``,
    which raises when no CUDA device is present).  Weights are
    uninitialised until ``init`` or
    ``repro_torch.convert.params_from_numpy`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.is_ssm = cfg.arch_type == "ssm"
        self.embed = Embed(cfg, self.device)
        block = SSMBlock if self.is_ssm else Block
        self.blocks = nn.ModuleList(
            block(cfg, self.device) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg, self.device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator`` (on the model's device):
        truncated-normal fan-in for every matrix, ones for norm scales --
        the distribution of ``repro.models.model.Model.init``, not its
        bits."""
        self.embed.init(generator)
        for blk in self.blocks:
            if self.is_ssm:
                blk.ssd.init(generator)
            else:
                blk.attn.init(generator)
                (blk.moe if blk.is_moe else blk.mlp).init(generator)
        return self

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, q_offset: int = 0,
                collect_state: bool = False, prefix_state: dict | None = None,
                image_embeds: torch.Tensor | None = None):
        """Full-sequence causal forward over ``tokens`` [B, S].  The VLM
        family prepends ``image_embeds`` [B, N_img, D] (the stubbed anyres
        patch embeddings), as the reference's ``Model.embed`` does; ``S``
        then counts both.

        Returns ``(logits [B, S, V], state)``; ``state`` is
        ``{"kv": {"k": [L, B, S', Hkv, hd], "v": ...}}`` when
        ``collect_state`` (else None), with ``S'`` covering the prefix.
        ``prefix_state`` (same layout) is a restored prefix whose last
        position is ``q_offset - 1``: the tokens attend over it through
        the dense flash kernel with a non-zero offset.

        For the SSM family ``state`` is ``{"ssm": {"conv": [L, B, K-1,
        C], "state": [L, B, H, P, N]}}`` and ``prefix_state`` a snapshot
        of that layout, which the scan resumes from (``q_offset`` is then
        only the snapshot's position)."""
        cfg = self.cfg
        x = self.embed.embed(tokens)
        if cfg.arch_type == "vlm" and image_embeds is not None:
            x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
        if self.is_ssm:
            return self._ssm_forward(x, collect_state, prefix_state)
        ks, vs = [], []
        for l, blk in enumerate(self.blocks):
            pref = None
            if prefix_state is not None:
                pref = (prefix_state["kv"]["k"][l], prefix_state["kv"]["v"][l])
            a, (k, v) = attention_prefill(blk.attn, blk.norm1(x), cfg,
                                          q_offset=q_offset, kv_cache=pref)
            x = x + a
            x = x + blk.ffn(blk.norm2(x))
            if collect_state:
                ks.append(k)
                vs.append(v)
        logits = self.embed.logits(self.final_norm(x))
        state = None
        if collect_state:
            state = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        return logits, state

    def _ssm_forward(self, x, collect_state, prefix_state):
        convs, states = [], []
        for l, blk in enumerate(self.blocks):
            pref = None
            if prefix_state is not None:
                pref = {"conv": prefix_state["ssm"]["conv"][l],
                        "state": prefix_state["ssm"]["state"][l]}
            y, st = ssd_prefill(blk.ssd, blk.norm1(x), self.cfg, state=pref)
            x = x + y
            if collect_state:
                convs.append(st["conv"])
                states.append(st["state"])
        logits = self.embed.logits(self.final_norm(x))
        state = None
        if collect_state:
            state = {"ssm": {"conv": torch.stack(convs),
                             "state": torch.stack(states)}}
        return logits, state

    # ------------------------------------------------------------------
    def init_cache(self, batch: int) -> dict:
        """The SSM family's dense decode cache for ``batch`` sequences
        (its size does not depend on the sequence length)."""
        return init_cache(self.cfg, batch, device=self.device)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One serve step of the SSM family: ``tokens`` [B, 1] after the
        states in ``cache``, which is updated in place (the reference
        returns a new cache).  Returns logits [B, 1, V]."""
        if not self.is_ssm:
            raise NotImplementedError(
                f"{self.cfg.name}: dense families decode through "
                "decode_step_paged")
        conv, state = cache["ssm"]["conv"], cache["ssm"]["state"]
        x = self.embed.embed(tokens)
        for l, blk in enumerate(self.blocks):
            y, cv, st = ssd_decode(blk.ssd, blk.norm1(x), self.cfg,
                                   conv_state=conv[l], ssm_state=state[l])
            conv[l].copy_(cv)
            state[l].copy_(st)
            x = x + y
        return self.embed.logits(self.final_norm(x))

    # ------------------------------------------------------------------
    @property
    def supports_paged_decode(self) -> bool:
        return supports_paged_decode(self.cfg)

    def init_paged_cache(self, *, num_slots: int, page_size: int,
                         max_seq_len: int,
                         num_pages: int | None = None) -> PagedKVCache:
        return PagedKVCache(self.cfg, num_slots=num_slots,
                            page_size=page_size, max_seq_len=max_seq_len,
                            num_pages=num_pages, device=self.device)

    @torch.no_grad()
    def decode_step_paged(self, k_pool, v_pool, tokens, block_tables,
                          lengths, *, contiguous: bool = False):
        """One continuous-batching decode step over the shared page pool.

        ``tokens`` [B, 1] at per-sequence positions ``lengths`` [B] int32;
        ``k_pool``/``v_pool`` [L, N, page, Hkv, hd] are updated in place;
        ``block_tables`` [B, P] int32 (None with ``contiguous=True``).
        Returns logits [B, 1, V]."""
        cfg = self.cfg
        x = self.embed.embed(tokens)
        for l, blk in enumerate(self.blocks):
            x = x + attention_decode_paged(
                blk.attn, blk.norm1(x), cfg, k_pool=k_pool[l],
                v_pool=v_pool[l], block_tables=block_tables,
                lengths=lengths, contiguous=contiguous)
            x = x + blk.ffn(blk.norm2(x))
        return self.embed.logits(self.final_norm(x))

    @torch.no_grad()
    def prefill_chunk_paged(self, k_pool, v_pool, tokens, block_tables,
                            q_offsets, n_valid):
        """A batch of prefill chunks over the shared page pool.

        ``tokens`` [R, C], row ``i`` starting at position ``q_offsets[i]``
        with ``n_valid[i] <= C`` real tokens (int32 [R] each); the pools
        are updated in place through ``block_tables`` [R, P].  Returns the
        logits of each row's last valid position, [R, V]."""
        cfg = self.cfg
        x = self.embed.embed(tokens)
        for l, blk in enumerate(self.blocks):
            x = x + attention_prefill_paged(
                blk.attn, blk.norm1(x), cfg, k_pool=k_pool[l],
                v_pool=v_pool[l], block_tables=block_tables,
                q_offsets=q_offsets, n_valid=n_valid)
            x = x + blk.ffn(blk.norm2(x))
        idx = torch.clamp(n_valid.long() - 1, min=0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]   # [R, D]
        return self.embed.logits(self.final_norm(last))
