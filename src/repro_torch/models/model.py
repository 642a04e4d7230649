"""The model, ported from ``repro/models/model.py``: the GQA decoder
(dense, MoE, and the VLM backbone, with or without a sliding window),
the MLA decoder (deepseek-v3), the attention-free SSM (Mamba-2) stack,
the hybrid (zamba2: SSM layers with one shared attention block), and
the encoder-decoder (seamless-m4t).

``Model`` is an ``nn.Module`` holding its weights (``embed``, an
``nn.ModuleList`` of ``blocks``, ``final_norm``, the hybrid's
``shared_attn``, and the encoder-decoder's ``encoder``,
``encoder_norm`` and ``cross``) on one device.  The reference's
``lax.scan`` over stacked layers, and its segmented scans of the hybrid,
are a Python loop over ``self.blocks``: the hybrid runs its shared block
after every layer ``l`` with ``cfg.is_attn_layer(l)``, which is the
reference's period segmentation.  A block's attention is ``Attention``
or, with ``cfg.use_mla``, ``MLA``; its feed-forward is its ``mlp`` or,
when ``cfg.num_experts``, its ``moe``, except in the first
``cfg.first_k_dense`` layers of an MLA model (the reference applies
``first_k_dense`` only with MLA, as two stacks, ``blocks_dense`` and
``blocks``; here they are one ``nn.ModuleList``).  The encoder-decoder
encodes ``frames`` (the stubbed speech frontend's embeddings) with
non-causal self-attention, and each decoder layer attends over the
encoder output through its cross block (``cross[l]``) after its
self-attention.  The GQA families without a window serve through the
paged steps, which write each layer's K/V into ``k_pool[l]`` /
``v_pool[l]`` in place; the SSM, hybrid and MLA families and a windowed
GQA model through ``decode_step`` over the dense cache of
``init_cache``, which also holds the encoder-decoder's cross K/V.

Training: ``train_loss`` is the reference's ``Model.train_loss`` (mean
token cross-entropy, plus the MoE aux summed over layers, plus the MLA
model's multi-token-prediction loss through ``Model.mtp``, which serving
never reads).  ``forward`` and ``encode`` build a graph when grad is
enabled and a parameter requires it; the serving paths call them under
``torch.no_grad()``.  ``remat`` recomputes each block in the backward:
``"full"`` keeps only its input (``torch.utils.checkpoint``), ``"dots"``
also its matmul outputs and ``"dots_no_batch"`` those without a batch
dimension (selective checkpointing), as the reference's ``jax.checkpoint``
policies do.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    at_layout,
    is_dtensor,
    layer,
    maybe_shard,
    roll,
)
from repro_torch.models.attention import (
    Attention,
    attention_decode,
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
from repro_torch.models.layers import (
    MLP,
    Embed,
    Norm,
    cross_entropy_loss,
    torch_dtype,
    weight,
)
from repro_torch.models.mla import MLA, mla_decode, mla_prefill
from repro_torch.models.moe import MoE
from repro_torch.models.ssd import SSD, ssd_decode, ssd_prefill


_MATMULS = {"dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default),
            "dots_no_batch": (torch.ops.aten.mm.default,
                              torch.ops.aten.addmm.default)}


def _save_matmuls(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str | None):
    """``fn`` recomputed in the backward under ``policy`` (None or
    ``"none"``: as it is; ``"full"``: only the inputs are kept;
    ``"dots"`` / ``"dots_no_batch"``: the outputs of every matrix product,
    or of those without a batch dimension, are kept too), as the
    reference's ``_remat`` wraps a block in ``jax.checkpoint``.  Without
    grad there is no backward, and ``fn`` runs as it is."""
    if policy is None or policy == "none":
        return fn
    if policy not in ("full", *_MATMULS):
        raise ValueError(f"unknown remat policy {policy!r}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if policy == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                functools.partial(_save_matmuls,
                                                  _MATMULS[policy]))
        return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx)
    return run


def _moe_layer(cfg: ModelConfig, l: int) -> bool:
    """Whether layer ``l`` of an attention stack is a MoE layer: the
    MoE family's, except the first ``first_k_dense`` layers of an MLA
    model."""
    return cfg.num_experts > 0 and not (cfg.use_mla
                                        and l < cfg.first_k_dense)


def _store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; into a ``DTensor`` cache view, into its local
    shard, ``src`` first laid out as ``dst`` is."""
    if is_dtensor(dst):
        dst.to_local().copy_(at_layout(src, dst).to_local())
    else:
        dst.copy_(src)


class Block(nn.Module):
    """Attention (``Attention``, or ``MLA``) and a feed-forward: ``mlp``,
    or ``moe`` in a MoE layer (the reference's ``_init_block``)."""

    def __init__(self, cfg: ModelConfig, device, *, moe: bool):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.attn = (MLA if cfg.use_mla else Attention)(cfg, device)
        self.norm2 = Norm(cfg, device)
        self.is_moe = moe
        if self.is_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def ffn(self, h: torch.Tensor):
        """``(y, aux)``: the MoE layer's load-balance and z-loss aux, or
        None for an MLP."""
        if self.is_moe:
            return self.moe(h)
        return self.mlp(h), None


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm1 = Norm(cfg, device)
        self.ssd = SSD(cfg, device)


class NormAttn(nn.Module):
    """A norm and attention, no feed-forward: the hybrid's shared block
    (``params["shared_attn"]``, one set of weights reused at every
    attention layer of the stack) and a decoder layer's cross block
    (``params["cross"]``, one per layer of the encoder-decoder)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.norm = Norm(cfg, device)
        self.attn = Attention(cfg, device)


class MTP(nn.Module):
    """The multi-token-prediction head (``params["mtp"]``): ``proj``
    [depth, 2d, d], ``blocks`` (depth dense blocks) and ``norm``.  Only
    ``train_loss`` reads it, and only depth 0, as the reference does."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        self.proj = weight((cfg.mtp_depth, 2 * d, d), torch_dtype(cfg.dtype),
                           device)
        self.blocks = nn.ModuleList(Block(cfg, device, moe=False)
                                    for _ in range(cfg.mtp_depth))
        self.norm = Norm(cfg, device)


class Model(nn.Module):
    """GQA or MLA decoder, SSM stack, hybrid or encoder-decoder on
    ``device`` (default ``"cuda"``, which raises when no CUDA device is
    present).  Weights are uninitialised until ``init`` or
    ``repro_torch.convert.params_from_numpy`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        # the SSM and hybrid stacks are SSD layers
        self.is_ssm = cfg.arch_type in ("ssm", "hybrid")
        self.embed = Embed(cfg, self.device)
        self.blocks = nn.ModuleList(
            SSMBlock(cfg, self.device) if self.is_ssm
            else Block(cfg, self.device, moe=_moe_layer(cfg, l))
            for l in range(cfg.num_layers))
        self.shared_attn = (NormAttn(cfg, self.device)
                            if cfg.arch_type == "hybrid" else None)
        self.encoder = self.encoder_norm = self.cross = None
        if cfg.is_encoder_decoder:
            self.encoder = nn.ModuleList(
                Block(cfg, self.device, moe=False)
                for _ in range(cfg.num_encoder_layers))
            self.encoder_norm = Norm(cfg, self.device)
            self.cross = nn.ModuleList(NormAttn(cfg, self.device)
                                       for _ in range(cfg.num_layers))
        self.mtp = MTP(cfg, self.device) if cfg.mtp_depth else None
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
        if self.shared_attn is not None:
            self.shared_attn.attn.init(generator)
        if self.encoder is not None:
            for blk in self.encoder:
                blk.attn.init(generator)
                blk.mlp.init(generator)
            for cb in self.cross:
                cb.attn.init(generator)
        if self.mtp is not None:
            proj = self.mtp.proj
            tmp = torch.randn(proj.shape, generator=generator,
                              device=proj.device)
            proj.copy_(tmp.mul_(proj.shape[1] ** -0.5))
            for blk in self.mtp.blocks:
                blk.attn.init(generator)
                blk.mlp.init(generator)
        return self

    # ------------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, *, q_offset: int = 0,
                collect_state: bool = False, prefix_state: dict | None = None,
                image_embeds: torch.Tensor | None = None,
                frames: torch.Tensor | None = None,
                sliding_window: int | None = None,
                remat: str | None = None):
        """Full-sequence causal forward over ``tokens`` [B, S].  The VLM
        family prepends ``image_embeds`` [B, N_img, D] (the stubbed anyres
        patch embeddings), as the reference's ``Model.embed`` does; ``S``
        then counts both.  The encoder-decoder family needs ``frames``
        [B, S_src, D] (the stubbed speech frontend's embeddings): they are
        encoded (``encode``) and every decoder layer attends over the
        encoder output after its self-attention.

        Returns ``(logits [B, S, V], state)``; ``state`` is
        ``{"kv": {"k": [L, B, S', Hkv, hd], "v": ...}}`` when
        ``collect_state`` (else None), with ``S'`` covering the prefix.
        ``prefix_state`` (same layout) is a restored prefix whose last
        position is ``q_offset - 1``: the tokens attend over it through
        the dense flash kernel with a non-zero offset.  For MLA the state
        is the latents, ``{"mla": {"ckv": [L, B, S', r], "kr": [L, B, S',
        dr]}}``, and so is the prefix.

        The encoder-decoder's ``state`` also holds each layer's cross
        K/V, ``{"cross": {"k": [L, B, S_src, Hkv, hd], "v": ...}}``,
        which ``decode_step`` reads from its cache.

        For the SSM family ``state`` is ``{"ssm": {"conv": [L, B, K-1,
        C], "state": [L, B, H, P, N]}}`` and ``prefix_state`` a snapshot
        of that layout, which the scan resumes from (``q_offset`` is then
        only the snapshot's position).  The hybrid's ``state`` holds both:
        ``ssm`` for every layer and ``kv`` [n_attn, B, S', Hkv, hd] for
        the shared block's invocations.

        ``sliding_window`` and ``remat`` are the training forward's (see
        ``train_loss``); serving passes neither."""
        logits, _, state = self._forward(
            tokens, q_offset=q_offset, collect_state=collect_state,
            prefix_state=prefix_state, image_embeds=image_embeds,
            frames=frames, sliding_window=sliding_window, remat=remat)
        return logits, state

    def _forward(self, tokens, *, q_offset=0, collect_state=False,
                 prefix_state=None, image_embeds=None, frames=None,
                 sliding_window=None, remat=None):
        """``forward``'s ``(logits, aux, state)``: ``aux`` is the MoE aux
        summed over the layers (an f32 zero without experts), which only
        ``train_loss`` reads."""
        cfg = self.cfg
        x = self._embed(tokens, image_embeds)
        if self.is_ssm:
            return self._ssm_forward(x, q_offset, collect_state,
                                     prefix_state, sliding_window, remat)
        enc_out = None
        if cfg.is_encoder_decoder:
            if frames is None:
                raise ValueError(f"{cfg.name}: forward needs frames")
            enc_out = self.encode(frames, remat=remat)
        part, names = (("mla", ("ckv", "kr")) if cfg.use_mla
                       else ("kv", ("k", "v")))
        layers = []                         # each layer's (k, v) or latents
        crosses = []                        # each layer's cross (k, v)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = _remat(self._attn_block, remat)
        for l, blk in enumerate(self.blocks):
            pref = None
            if prefix_state is not None:
                pref = tuple(prefix_state[part][n][l] for n in names)
            cross = self.cross[l] if enc_out is not None else None
            x, a, st, ckv = block(blk, x, enc_out, cross, q_offset,
                                  sliding_window, pref)
            if a is not None:
                aux = aux + a
            if collect_state:
                layers.append(st)
                if enc_out is not None:
                    crosses.append(ckv)
        logits = maybe_shard(self.embed.logits(self.final_norm(x)), "logits")
        state = None
        if collect_state:
            state = {part: {n: torch.stack([st[i] for st in layers])
                            for i, n in enumerate(names)}}
            if crosses:
                state["cross"] = {n: torch.stack([c[i] for c in crosses])
                                  for i, n in enumerate(("k", "v"))}
        return logits, aux, state

    def _embed(self, tokens, image_embeds=None):
        """Token embeddings, the VLM's patch embeddings in front (the
        reference's ``Model.embed``)."""
        x = self.embed.embed(tokens)
        if self.cfg.arch_type == "vlm" and image_embeds is not None:
            x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
        return maybe_shard(x, "act_btd")

    def _attn_block(self, blk, x, enc_out, cross, q_offset, sliding_window,
                    pref):
        """One decoder layer (the reference's ``_attn_block``): attention
        (or MLA), the cross block when ``enc_out`` is given, the
        feed-forward.  Returns ``(x, aux or None, self state, cross (k,
        v))``."""
        cfg = self.cfg
        if cfg.use_mla:
            a, st = mla_prefill(blk.attn, blk.norm1(x), cfg,
                                q_offset=q_offset,
                                sliding_window=sliding_window,
                                latent_prefix=pref)
        else:
            a, st = attention_prefill(blk.attn, blk.norm1(x), cfg,
                                      q_offset=q_offset,
                                      sliding_window=sliding_window,
                                      kv_cache=pref)
        x = x + a
        ckv = None
        if enc_out is not None:
            c, ckv = attention_prefill(cross.attn, cross.norm(x), cfg,
                                       kv_x=enc_out, causal=False)
            x = x + c
        y, aux = blk.ffn(blk.norm2(x))
        return maybe_shard(x + y, "act_btd"), aux, st, ckv

    def encode(self, frames: torch.Tensor, *,
               remat: str | None = None) -> torch.Tensor:
        """The encoder-decoder's encoder (the reference's ``_encode``):
        ``frames`` [B, S_src, D] cast to the model dtype, then every
        encoder layer's non-causal self-attention (RoPE at positions
        ``0..S_src-1``) and MLP, then the encoder norm; each layer under
        ``remat``."""
        cfg = self.cfg

        def layer(blk, x):
            a, _ = attention_prefill(blk.attn, blk.norm1(x), cfg,
                                     causal=False)
            x = x + a
            return maybe_shard(x + blk.mlp(blk.norm2(x)), "act_btd")

        layer = _remat(layer, remat)
        x = frames.to(self.embed.tok.dtype)
        for blk in self.encoder:
            x = layer(blk, x)
        return self.encoder_norm(x)

    def _ssm_forward(self, x, q_offset, collect_state, prefix_state,
                     sliding_window=None, remat=None):
        cfg = self.cfg
        convs, states, ks, vs = [], [], [], []
        pre_kv = prefix_state.get("kv") if prefix_state is not None else None

        def ssm_layer(blk, x, pref):
            y, st = ssd_prefill(blk.ssd, blk.norm1(x), cfg, state=pref)
            return maybe_shard(x + y, "act_btd"), st

        # the reference recomputes the SSD layers, not the shared block
        ssm_layer = _remat(ssm_layer, remat)
        j = 0                                   # shared-attention call
        for l, blk in enumerate(self.blocks):
            pref = None
            if prefix_state is not None:
                pref = {"conv": prefix_state["ssm"]["conv"][l],
                        "state": prefix_state["ssm"]["state"][l]}
            x, st = ssm_layer(blk, x, pref)
            if collect_state:
                convs.append(st["conv"])
                states.append(st["state"])
            if self.shared_attn is not None and cfg.is_attn_layer(l):
                sa = self.shared_attn
                pref_kv = (None if pre_kv is None
                           else (pre_kv["k"][j], pre_kv["v"][j]))
                a, (k, v) = attention_prefill(
                    sa.attn, sa.norm(x), cfg, q_offset=q_offset,
                    sliding_window=sliding_window, kv_cache=pref_kv)
                x = maybe_shard(x + a, "act_btd")
                if collect_state:
                    ks.append(k)
                    vs.append(v)
                j += 1
        logits = maybe_shard(self.embed.logits(self.final_norm(x)), "logits")
        state = None
        if collect_state:
            state = {"ssm": {"conv": torch.stack(convs),
                             "state": torch.stack(states)}}
            if ks:
                state["kv"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=x.device), state

    # ------------------------------------------------------------------
    def train_loss(self, batch: dict, *, remat: str | None = None):
        """The reference's ``Model.train_loss``: ``(loss, {"ce", "aux",
        "loss"})``.  ``batch`` holds ``tokens`` and ``targets`` [B, S] on
        the model's device, and ``image_embeds`` (VLM) or ``frames``
        (encoder-decoder) where the family takes them.  The loss is the
        mean cross-entropy of position t's logits against ``targets[t+1]``
        (the VLM's image positions dropped), plus 0.3 x the MTP loss when
        the model has an MTP head, plus the MoE aux summed over layers;
        ``ce`` is the first term alone.  Attention runs at
        ``cfg.sliding_window``."""
        cfg = self.cfg
        tokens, targets = batch["tokens"], batch["targets"]
        image_embeds = batch.get("image_embeds")
        logits, aux, _ = self._forward(
            tokens, image_embeds=image_embeds, frames=batch.get("frames"),
            sliding_window=cfg.sliding_window or None, remat=remat)
        if cfg.arch_type == "vlm" and image_embeds is not None:
            logits = logits[:, image_embeds.shape[1]:]
        loss = cross_entropy_loss(logits[:, :-1], targets[:, 1:])
        metrics = {"ce": loss, "aux": aux}
        if self.mtp is not None:
            loss = loss + 0.3 * self._mtp_loss(tokens, targets)
        total = loss + aux
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, tokens, targets):
        """DeepSeek-V3 multi-token prediction, as the reference computes it:
        ``[h_t ; emb(token_{t+1})]`` (the embedding rolled by one, so the
        last position wraps to the first) through ``proj[0]`` and block 0
        (no MoE, no window), then the MTP norm and the unembedding,
        predicting token t+2."""
        x = self._embed(tokens)
        h = torch.cat([x, roll(x, -1, 1)], dim=-1)
        h = (h @ self.mtp.proj[0]).to(x.dtype)
        h2 = self._attn_block(self.mtp.blocks[0], h, None, None, 0, None,
                              None)[0]
        lg = self.embed.logits(self.mtp.norm(h2))
        return cross_entropy_loss(lg[:, :-2], targets[:, 2:])

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int | None = None, *,
                   src_len: int | None = None) -> dict:
        """The dense decode cache (``models/cache.py::init_cache``) for
        ``batch`` sequences of up to ``seq_len`` tokens (K/V, or MLA
        latents), and for the encoder-decoder the cross K/V of
        ``src_len`` frames; the SSM family's does not depend on the
        sequence length."""
        return init_cache(self.cfg, batch, seq_len, src_len=src_len,
                          device=self.device)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor, pos=None):
        """One serve step over the dense ``cache``, which is updated in
        place (the reference returns a new cache): ``tokens`` [B, 1] at
        per-sequence positions ``pos`` [B] int32, the tokens each
        sequence has cached.  The SSM family needs no ``pos``.  The
        encoder-decoder's layers attend over ``cache["cross"]`` after
        their self-attention; that part is read, never written.  Returns
        logits [B, 1, V].

        Sharded (under ``use_rules``, the weights distributed): the cache
        leaves are ``DTensor``s laid out by ``sharding.cache_shardings``
        and each rank updates its own shard in place; ``tokens`` is a
        ``DTensor`` (rows over data, or whole), ``pos`` a plain tensor
        that every rank holds whole; the logits come back a ``DTensor``.
        Attention and MLA decode stripe by stripe and merge; the SSM
        recurrence runs on each rank's heads."""
        cfg = self.cfg
        swin = cfg.sliding_window or None
        if pos is None and cfg.arch_type != "ssm":
            raise ValueError(f"{cfg.name}: decode_step needs pos")
        x = self.embed.embed(tokens)
        kv = cache.get("kv")
        j = 0                                   # shared-attention call
        for l, blk in enumerate(self.blocks):
            if self.is_ssm:
                conv = layer(cache["ssm"]["conv"], l)
                state = layer(cache["ssm"]["state"], l)
                y, cv, st = ssd_decode(blk.ssd, blk.norm1(x), cfg,
                                       conv_state=conv, ssm_state=state)
                _store(conv, cv)
                _store(state, st)
                x = x + y
                if self.shared_attn is not None and cfg.is_attn_layer(l):
                    sa = self.shared_attn
                    x = x + attention_decode(
                        sa.attn, sa.norm(x), cfg, k_cache=layer(kv["k"], j),
                        v_cache=layer(kv["v"], j), pos=pos,
                        sliding_window=swin)
                    j += 1
            elif cfg.use_mla:
                x = x + mla_decode(
                    blk.attn, blk.norm1(x), cfg,
                    ckv_cache=layer(cache["mla"]["ckv"], l),
                    krope_cache=layer(cache["mla"]["kr"], l), pos=pos,
                    sliding_window=swin)
                x = x + blk.ffn(blk.norm2(x))[0]
            else:
                x = x + attention_decode(
                    blk.attn, blk.norm1(x), cfg, k_cache=layer(kv["k"], l),
                    v_cache=layer(kv["v"], l), pos=pos, sliding_window=swin)
                if self.cross is not None:
                    cb = self.cross[l]
                    x = x + attention_decode(
                        cb.attn, cb.norm(x), cfg,
                        cross_kv=(layer(cache["cross"]["k"], l),
                                  layer(cache["cross"]["v"], l)))
                x = x + blk.ffn(blk.norm2(x))[0]
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
            x = x + blk.ffn(blk.norm2(x))[0]
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
            x = x + blk.ffn(blk.norm2(x))[0]
        idx = torch.clamp(n_valid.long() - 1, min=0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]   # [R, D]
        return self.embed.logits(self.final_norm(last))
