"""Shared building blocks: initialisers, norms, MLPs, embeddings.

Weights keep the reference's ``[in, out]`` layout, so ``x @ W`` reads as
in ``repro/models/layers.py``.  Norm scales are f32 and norms compute in
f32 before casting back; ``gelu`` is the tanh approximation, as
``jax.nn.gelu`` is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32, ``mean(logsumexp(logits) -
    logits[target])``: ``repro/models/layers.py::cross_entropy_loss``
    without a mask or z-loss (``train_loss`` passes neither).  The gold
    logit is gathered; the reference contracts with a one-hot for its
    sharded vocab, the same value."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - gold).mean()


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
        return self.tok[tokens.long()]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.tied:
            return x @ self.tok.T
        return x @ self.unembed
