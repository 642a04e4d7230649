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
einsums do.  Under a mesh (``repro_torch.distributed``) the routing,
the experts and the combine each run in ``local_map``
(``_sharded_moe``): groups over the data axes, experts over ``model``
(expert parallelism) at the reference's ``moe_expert`` points.  The
reference's ``REPRO_MOE_SHARD`` switch is not carried: the port always
constrains the expert buffers, its default ``all`` less the one-hot
tensor it does not build.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (
    active_rules,
    is_dtensor,
    maybe_shard,
    partial_over,
    placements,
    run_local,
)
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


def _group(x: torch.Tensor, cfg: ModelConfig, tokens: int):
    """``x`` [..., D] as groups [G, g, D] of ``g = min(moe_group_size,
    tokens)`` tokens, the last group padded with zero tokens."""
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    g = min(cfg.moe_group_size, tokens)
    pad = (-flat.shape[0]) % g
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    return g, flat.reshape(-1, g, d)


def _route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig):
    """The f32 router logits and probabilities [G, g, E] and the top-k
    weights (renormalised) and expert ids [G, g, k] of groups ``xt``."""
    logits = xt.float() @ router                                # [G,g,E]
    probs = torch.softmax(logits, dim=-1)
    # a stable sort breaks ties toward the lower expert id, as
    # ``lax.top_k`` does (a zero padding token ties every expert)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :cfg.num_experts_per_tok], \
        top_i[..., :cfg.num_experts_per_tok]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_i


def moe_route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Routing of ``x`` [B, S, D]: the group size ``g`` and, per group,
    the grouped tokens [G, g, D], the f32 router logits and probabilities
    [G, g, E] and the top-k weights (renormalised) and expert ids [G, g,
    k].  Padding tokens of the last group are zeros, as in the
    reference."""
    g, xt = _group(x, cfg, x.shape[0] * x.shape[1])
    return (g, xt, *_route(p.router, xt, cfg))


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


def _dispatch(router, x, cfg: ModelConfig, tokens: int):
    """Route ``x`` [B, S, D] (``tokens`` of the whole batch, which fix the
    group size) and scatter each kept (token, choice) into its expert's
    buffer slot.  Returns ``expert_in`` [G, E, C, D]; each choice's buffer
    row [G, g, k] (a dropped one points at one spare row past the
    buffers, read back as zeros) and combine weight ``top_p`` [G, g, k];
    and the aux terms per group, the load balance [G] and the squared
    router logsumexp [G, g]."""
    d = x.shape[-1]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g, xt = _group(x, cfg, tokens)
    ng = xt.shape[0]
    logits, probs, top_p, top_i = _route(router, xt, cfg)
    member, position, cap = _slots(top_i, g, cfg)
    pos = torch.gather(position, 2, top_i)                    # [G,g,k]
    keep = pos < cap
    spare = ng * e * cap
    gi = torch.arange(ng, device=x.device)[:, None, None]
    row = torch.where(keep, (gi * e + top_i) * cap + pos, spare)
    buf = x.new_zeros(spare + 1, d)
    buf[row.reshape(-1)] = xt[:, :, None, :].expand(ng, g, k, d).reshape(-1, d)
    expert_in = buf[:spare].view(ng, e, cap, d)
    # Switch-style load balance and router z-loss terms
    balance = (member.float().mean(1) * probs.mean(1)).sum(-1)   # [G]
    zsq = torch.logsumexp(logits, dim=-1).square()              # [G,g]
    return expert_in, row, top_p, balance, zsq


def _experts(expert_in, wi_gate, wi_up, wo):
    """The SwiGLU experts over their buffers, [G, E, C, D] -> [G, E, C,
    D], as one batched matmul per weight."""
    ng, e, cap, d = expert_in.shape
    xin = expert_in.transpose(0, 1).reshape(e, ng * cap, d)   # [E,G*C,D]
    h = F.silu(torch.bmm(xin, wi_gate)) * torch.bmm(xin, wi_up)
    return torch.bmm(h, wo).view(e, ng, cap, d).transpose(0, 1)


def _combine(expert_out, row, top_p, b: int, s: int):
    """Each token's k choices' outputs, weighted by its renormalised top-k
    probabilities cast to the activations' dtype, summed in f32 in a fixed
    order (no atomics); the first ``b * s`` tokens as [b, s, D]."""
    ng, e, cap, d = expert_out.shape
    out = torch.cat([expert_out.reshape(ng * e * cap, d),
                     expert_out.new_zeros(1, d)])
    wk = top_p.to(expert_out.dtype).float()[..., None]        # [G,g,k,1]
    y = (out[row].float() * wk).sum(2).reshape(-1, d)
    return y[:b * s].to(expert_out.dtype).view(b, s, d)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, S, D] -> (y [B, S, D], aux).  Works for S=1 decode too.
    Differentiable: the router's gradient flows through the combine
    weights (``top_p``) and the aux loss; the dispatch writes into a fresh
    buffer (``index_put``), whose backward gathers the rows back.  Under a
    mesh the three steps run on each rank's shards (``_sharded_moe``)."""
    b, s, _ = x.shape
    rules = active_rules()
    if rules is not None and is_dtensor(x):
        y, balance, zsq = _sharded_moe(p, x, cfg, rules)
    else:
        expert_in, row, top_p, balance, zsq = _dispatch(p.router, x, cfg,
                                                        b * s)
        expert_out = _experts(expert_in, p.wi_gate, p.wi_up, p.wo)
        y = _combine(expert_out, row, top_p, b, s)
    if p.shared is not None:
        sp = p.shared
        hs = F.silu(x @ sp.wi_gate) * (x @ sp.wi_up)
        y = y + hs @ sp.wo
    aux = (cfg.router_aux_coef * (cfg.num_experts * balance.mean())
           + 1e-3 * zsq.mean())
    return y, aux


def _sharded_moe(p: MoE, x, cfg: ModelConfig, rules):
    """``moe_forward``'s three steps under a mesh, each in ``local_map``
    (``DTensor`` has no sharding rule for the sort, the cumulative slot
    count or the scatter).  Groups ride the data axes when whole groups
    fall on each rank's batch rows, else every data rank routes the whole
    batch; the router is read whole.  The expert buffers and weights then
    ride ``model`` by expert (``moe_expert``), and the combine gathers
    every expert's buffer back.  The reference also constrains its
    one-hot dispatch tensor (``moe_dispatch``); the port scatters into the
    buffers and has no such tensor."""
    mesh, tp = x.device_mesh, rules.model_axis
    b, s, _ = x.shape
    tokens = b * s
    g = min(cfg.moe_group_size, tokens)
    dsize = rules.axis_size(rules.data_axes)
    aligned = tokens % g == 0 and b % dsize == 0 and (tokens // g) % dsize == 0
    dp_ = rules.data if aligned else None

    def place(*spec):
        return placements(spec, mesh)

    def read_whole(pl):
        """A weight every data rank reads whole for its own rows: its
        gradient is a partial sum over the data axes."""
        return pl if dp_ is None else partial_over(pl, mesh, rules.data_axes)

    x_pl = place(dp_, None, None)
    group = place(dp_, None, None)
    expert_in, row, top_p, balance, zsq = run_local(
        lambda xl, r: _dispatch(r, xl, cfg, tokens), mesh,
        (x_pl, place(None, None)),
        (place(dp_, None, None, None), group, group, place(dp_), group),
        (x_pl, read_whole(place(None, None))))(x, p.router)
    expert_in = maybe_shard(expert_in, "moe_expert")
    buf_pl = list(expert_in.placements)
    ep = tp if any(pl.is_shard(1) for pl in buf_pl) else None
    w_pl = place(ep, None, None)
    expert_out = run_local(
        _experts, mesh, (buf_pl, w_pl, w_pl, w_pl), buf_pl,
        (buf_pl, *[read_whole(w_pl)] * 3))(expert_in, p.wi_gate, p.wi_up,
                                           p.wo)
    expert_out = maybe_shard(expert_out, "moe_expert")
    b_loc = b // dsize if aligned else b
    y = run_local(
        lambda eo, r, tw: _combine(eo, r, tw, b_loc, s), mesh,
        (place(dp_, None, None, None), group, group), x_pl)(
            expert_out, row, top_p)
    return y, balance, zsq
