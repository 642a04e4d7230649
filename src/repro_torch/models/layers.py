"""Shared building blocks: initialisers, norms, MLPs, embeddings.

Weights keep the reference's ``[in, out]`` layout, so ``x @ W`` reads as
in ``repro/models/layers.py``.  Norm scales are f32 and norms compute in
f32 before casting back; ``gelu`` is the tanh approximation, as
``jax.nn.gelu`` is.

Under a mesh (``repro_torch.distributed``) the norms and MLPs run as
``DTensor`` ops; the vocab-sharded embedding lookup and the
cross-entropy over vocab-sharded logits run in ``local_map`` (DTensor's
own rule for the lookup's backward fails in some torch releases, and a
softmax over a sharded vocab would gather the logits).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (
    active_rules,
    divisible,
    is_dtensor,
    partial_over,
    placements,
    run_local,
)
from repro_torch.models.config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def weight(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised inference weight (filled by ``dense_init_`` or a
    converted checkpoint).  It does not require grad, so serving builds no
    graph; training turns ``requires_grad`` on (``training.loop``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                fan_in: int | None = None) -> None:
    """Truncated-normal fan-in init in place: N(0, 1) cut at +-2, scaled
    by fan_in ** -0.5 (drawn in f32, cast to the weight's dtype) -- the
    distribution of ``repro.models.layers.dense_init``."""
    fan_in = fan_in if fan_in is not None else w.shape[0]
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.copy_(tmp.mul_(fan_in ** -0.5))


class Norm(nn.Module):
    """RMSNorm or LayerNorm with an f32 scale (and bias)."""

    def __init__(self, cfg: ModelConfig, device, d: int | None = None):
        super().__init__()
        d = d if d is not None else cfg.d_model
        self.kind = cfg.norm_type
        self.eps = cfg.norm_eps
        self.scale = nn.Parameter(torch.ones(d, device=device),
                                  requires_grad=False)
        if self.kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, device=device),
                                     requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.kind == "layernorm":
            mean = x32.mean(-1, keepdim=True)
            var = x32.var(-1, keepdim=True, unbiased=False)
            y = (x32 - mean) * torch.rsqrt(var + self.eps)
            y = y * self.scale + self.bias
        else:
            ms = x32.square().mean(-1, keepdim=True)
            y = x32 * torch.rsqrt(ms + self.eps) * self.scale
        return y.to(x.dtype)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba-2 gated RMSNorm, ``norm(x * silu(z)) * scale``.  As in the
    reference, the gate is applied in the model dtype and only then
    upcast to f32 for the norm."""
    x32 = (x * F.silu(z)).float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, (d_ff if d_ff is not None else cfg.d_ff)
        dt = torch_dtype(cfg.dtype)
        self.kind = cfg.mlp_type
        if self.kind == "swiglu":
            self.wi_gate = weight((d, f), dt, device)
            self.wi_up = weight((d, f), dt, device)
        else:
            self.wi = weight((d, f), dt, device)
        self.wo = weight((f, d), dt, device)

    def init(self, generator: torch.Generator) -> None:
        for w in self.parameters():
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "swiglu":
            h = F.silu(x @ self.wi_gate) * (x @ self.wi_up)
        elif self.kind == "squared_relu":
            h = torch.square(F.relu(x @ self.wi))
        else:
            h = F.gelu(x @ self.wi, approximate="tanh")
        return h @ self.wo


class TokenCrossEntropy(torch.autograd.Function):
    """Each token's cross-entropy ``logsumexp(logits) - logits[target]``
    of f32 ``logits`` [..., V_local] whose vocab may be split over the
    ranks of ``group`` (this rank holding entries ``v0 .. v0 +
    V_local``): the max, the sum of exponentials and the gold logit are
    reduced across the group, a scalar per token, so no rank gathers the
    logits.  With ``group`` None the vocab is whole.  The backward is
    ``softmax - onehot`` on the local entries, from the saved
    exponentials; it needs no collective."""

    @staticmethod
    def forward(ctx, logits, targets, group, v0):
        import torch.distributed as dist

        vl = logits.shape[-1]
        m = logits.amax(-1)
        if group is not None:
            dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        s = e.sum(-1)
        local = targets.long() - v0
        ok = (local >= 0) & (local < vl)
        local = local.clamp(0, vl - 1)
        gold = torch.where(ok, torch.gather(logits, -1, local[..., None])[
            ..., 0], 0.0)
        if group is not None:
            dist.all_reduce(s, group=group)
            dist.all_reduce(gold, group=group)
        ctx.save_for_backward(e, s, local, ok)
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, g):
        e, s, local, ok = ctx.saved_tensors
        d = e / s[..., None]
        d.scatter_add_(-1, local[..., None], -ok.to(d.dtype)[..., None])
        return d * g[..., None], None, None, None


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32, ``mean(logsumexp(logits) -
    logits[target])``: ``repro/models/layers.py::cross_entropy_loss``
    without a mask or z-loss (``train_loss`` passes neither).  Under a
    mesh the logits' vocab is split over ``model`` and each token's terms
    are reduced across it (``TokenCrossEntropy``), as the reference's
    one-hot contraction reduces over its sharded vocab."""
    rules = active_rules()
    if rules is None or not is_dtensor(logits):
        return TokenCrossEntropy.apply(logits.float(), targets, None,
                                       0).mean()
    mesh, tp = logits.device_mesh, rules.model_axis
    spec = divisible(logits.shape, (rules.data, None, tp), rules)
    split = spec[2] is not None and rules.axis_size(tp) > 1
    if not split:
        spec = (*spec[:2], None)

    def local(lg, tg):
        group = mesh.get_group(tp) if split else None
        v0 = mesh.get_local_rank(tp) * lg.shape[-1] if split else 0
        return TokenCrossEntropy.apply(lg.float(), tg, group, v0)

    tok = placements(spec[:2], mesh)
    return run_local(local, mesh, (placements(spec, mesh), tok), tok)(
        logits, targets).mean()


class Embed(nn.Module):
    """Token embedding ``tok`` [V, d] and, unless tied, ``unembed`` [d, V]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.tied = cfg.tie_embeddings
        self.d_model = cfg.d_model
        self.tok = weight((cfg.vocab_size, cfg.d_model), dt, device)
        if not self.tied:
            self.unembed = weight((cfg.d_model, cfg.vocab_size), dt, device)

    def init(self, generator: torch.Generator) -> None:
        dense_init_(self.tok, generator, fan_in=self.d_model)
        if not self.tied:
            dense_init_(self.unembed, generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The rows of ``tok`` for ``tokens``.  Under a mesh the lookup
        runs in ``local_map``: ``tok`` is read whole over the data axes
        and, where its vocab rides ``model``, each rank looks up the
        tokens in its own rows and the ranks' rows sum (a partial sum
        over ``model``), as the reference's vocab-sharded gather does."""
        rules = active_rules()
        if rules is None or not is_dtensor(self.tok):
            return self.tok[tokens.long()]
        mesh, tp = self.tok.device_mesh, rules.model_axis
        split = (self.tok.shape[0] % rules.axis_size(tp) == 0
                 and rules.axis_size(tp) > 1)
        dp_ = divisible(tokens.shape, (rules.data, None), rules)[0]
        w_pl = placements((tp if split else None, None), mesh)
        t_pl = placements((dp_, None), mesh)
        out_pl = placements((dp_, None, None), mesh)
        w_grad = (partial_over(w_pl, mesh, rules.data_axes)
                  if dp_ is not None else w_pl)
        if split:
            out_pl = partial_over(out_pl, mesh, tp)

        def lookup(w, t):
            if not split:
                return w[t.long()]
            rows = t.long() - mesh.get_local_rank(tp) * w.shape[0]
            ok = (rows >= 0) & (rows < w.shape[0])
            return torch.where(ok[..., None], w[rows.clamp(0, w.shape[0] - 1)],
                               0.0)

        return run_local(lookup, mesh, (w_pl, t_pl), out_pl,
                         (w_grad, t_pl))(self.tok, tokens)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.tied:
            return x @ self.tok.T
        return x @ self.unembed
