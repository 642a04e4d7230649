"""Mixture-of-Experts with capacity-based dispatch, ported from
``repro/models/moe.py``.

Top-k routing with per-group capacity: tokens are processed in fixed
groups of ``g = min(moe_group_size, tokens)``; each expert accepts at
most ``moe_capacity(cfg, g)`` tokens per group, filled in token order
(the k choices of one token count together), and tokens past capacity
fall back to the residual path.  The reference's one-hot dispatch and
combine einsums become a scatter of each kept (token, choice) into its
expert's buffer slot, a batched matmul over experts, and a gather of the
k outputs back onto each token -- the same products, without the
[G, g, E, C] one-hot tensor and without a host sync.  Routing is f32;
the expert products run in the weights' dtype, as the reference's
einsums do.  The reference's
sharding hooks (``maybe_shard``, ``REPRO_MOE_SHARD``) are dropped: the
port has no mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init_, torch_dtype, weight


def moe_capacity(cfg: ModelConfig, group: int) -> int:
    c = int(group * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # >=4, rounded up to a multiple of 4


class SharedExperts(nn.Module):
    """The always-on experts, one SwiGLU of width
    ``expert_d_ff * num_shared_experts``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        fs = cfg.expert_d_ff * cfg.num_shared_experts
        dt = torch_dtype(cfg.dtype)
        self.wi_gate = weight((d, fs), dt, device)
        self.wi_up = weight((d, fs), dt, device)
        self.wo = weight((fs, d), dt, device)


class MoE(nn.Module):
    """``router`` [D, E] (f32), ``wi_gate`` / ``wi_up`` [E, D, F], ``wo``
    [E, F, D], and ``shared`` when ``cfg.num_shared_experts``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
        dt = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.router = weight((d, e), torch.float32, device)
        self.wi_gate = weight((e, d, f), dt, device)
        self.wi_up = weight((e, d, f), dt, device)
        self.wo = weight((e, f, d), dt, device)
        self.shared = (SharedExperts(cfg, device)
                       if cfg.num_shared_experts else None)

    def init(self, generator: torch.Generator) -> None:
        """Fan-in truncated normals, as ``init_moe`` draws them: the
        router and the shared experts over their first axis, the routed
        experts over D (``wi_*``) and F (``wo``)."""
        d, f = self.cfg.d_model, self.cfg.expert_d_ff
        dense_init_(self.router, generator)
        dense_init_(self.wi_gate, generator, fan_in=d)
        dense_init_(self.wi_up, generator, fan_in=d)
        dense_init_(self.wo, generator, fan_in=f)
        if self.shared is not None:
            for w in self.shared.parameters():
                dense_init_(w, generator)

    def forward(self, x: torch.Tensor):
        return moe_forward(self, x, self.cfg)


def moe_route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Routing of ``x`` [B, S, D]: the group size ``g`` and, per group,
    the f32 router logits and probabilities [G, g, E] and the top-k
    weights (renormalised) and expert ids [G, g, k].  Padding tokens of
    the last group are zeros, as in the reference."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    g = min(cfg.moe_group_size, t)
    pad = (-t) % g
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    xt = tokens.reshape(-1, g, d)
    logits = xt.float() @ p.router                                # [G,g,E]
    probs = torch.softmax(logits, dim=-1)
    # a stable sort breaks ties toward the lower expert id, as
    # ``lax.top_k`` does (a zero padding token ties every expert)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :cfg.num_experts_per_tok], \
        top_i[..., :cfg.num_experts_per_tok]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return g, xt, logits, probs, top_p, top_i


def _slots(top_i: torch.Tensor, g: int, cfg: ModelConfig):
    """Expert membership [G, g, E] (0/1), each token's slot in each
    expert's buffer -- the count of earlier members of that expert in the
    group, in token order, so a token's k choices count together -- and
    the capacity."""
    member = F.one_hot(top_i, cfg.num_experts).sum(2)
    return member, torch.cumsum(member, dim=1) - 1, moe_capacity(cfg, g)


@torch.no_grad()
def moe_keep(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The (group, token, expert) triples capacity routing keeps, [G, g,
    E] bool: the reference's ``keep``."""
    g, _, _, _, _, top_i = moe_route(p, x, cfg)
    member, position, cap = _slots(top_i, g, cfg)
    return (position < cap) & (member > 0)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, S, D] -> (y [B, S, D], aux).  Works for S=1 decode too.
    Differentiable: the router's gradient flows through the combine
    weights (``top_p``) and the aux loss; the dispatch writes into a fresh
    buffer (``index_put``), whose backward gathers the rows back."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = b * s
    g, xt, logits, probs, top_p, top_i = moe_route(p, x, cfg)
    ng = xt.shape[0]

    member, position, cap = _slots(top_i, g, cfg)
    pos = torch.gather(position, 2, top_i)                    # [G,g,k]
    keep = pos < cap
    # buffer row (group, expert, slot) of each kept choice; a dropped one
    # points at one spare row past the buffers, read back as zeros
    spare = ng * e * cap
    gi = torch.arange(ng, device=x.device)[:, None, None]
    row = torch.where(keep, (gi * e + top_i) * cap + pos, spare)

    buf = x.new_zeros(spare + 1, d)
    buf[row.reshape(-1)] = xt[:, :, None, :].expand(ng, g, k, d).reshape(-1, d)
    expert_in = buf[:spare].view(ng, e, cap, d).transpose(0, 1).reshape(
        e, ng * cap, d)                                       # [E,G*C,D]
    h = F.silu(torch.bmm(expert_in, p.wi_gate)) * torch.bmm(expert_in, p.wi_up)
    expert_out = torch.bmm(h, p.wo).view(e, ng, cap, d).transpose(0, 1)
    out = torch.cat([expert_out.reshape(spare, d), x.new_zeros(1, d)])

    # combine: each token sums its k choices' outputs, weighted by its
    # renormalised top-k probabilities cast to x.dtype, in f32 and in a
    # fixed order (no atomics)
    wk = top_p.to(x.dtype).float()[..., None]                 # [G,g,k,1]
    y = (out[row].float() * wk).sum(2).reshape(ng * g, d)
    y = y[:t].to(x.dtype).view(b, s, d)

    if p.shared is not None:
        sp = p.shared
        hs = F.silu(x @ sp.wi_gate) * (x @ sp.wi_up)
        y = y + hs @ sp.wo

    # Switch-style load-balance aux loss + router z-loss
    frac_tokens = member.float().mean(1)                      # [G,E]
    frac_probs = probs.mean(1)                                # [G,E]
    balance = e * (frac_tokens * frac_probs).sum(-1).mean()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    aux = cfg.router_aux_coef * balance + 1e-3 * z
    return y, aux
