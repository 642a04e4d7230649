"""AdamW and its schedule, written out by hand as
``repro/training/optimizer.py`` computes them (no ``torch.optim``: the
eps placement, the global-norm clip and the f32 arithmetic follow the
reference).

The optimizer state is ``{"m": {name: tensor}, "v": {name: tensor},
"step": int32 scalar}``, the moments keyed by the parameter's name in
``Model.named_parameters()``.  ``adamw_update`` updates the parameters
and the state in place (the reference returns new trees).

Weight decay falls on every parameter whose name does not end in one of
``NO_DECAY`` and whose rank is at least 2.  The port's parameters are
per layer, so that is the per-layer rank.  The reference judges the rank
of its stacked trees, where a layer axis makes the SSD conv biases
(``conv_x_b``, ``conv_bc_b``, ``[L, di]`` stacked) rank 2, and decays
them against its own docstring; the port does not copy that (ROADMAP
section 3).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import torch_dtype

NO_DECAY = ("scale", "bias", "a_log", "dt_bias", "d_skip", "norm_scale")


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


def lr_at(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; an f32
    scalar on ``device``."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict[str, torch.Tensor],
                   moment_dtype: str = "float32") -> dict:
    """Zero moments in ``moment_dtype`` beside each named parameter."""
    dt = torch_dtype(moment_dtype)
    device = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in params.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays parameter ``name``: a matrix (per-layer rank
    >= 2) whose leaf name is not one of ``NO_DECAY``."""
    return name.rsplit(".", 1)[-1] not in NO_DECAY and p.dim() >= 2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor | None], state: dict):
    """One AdamW step in place; returns ``(params, state, {"grad_norm",
    "lr"})`` with the metrics as f32 device scalars.  A parameter without
    a gradient (None: it took no part in the loss) is stepped with zeros,
    as ``jax.grad`` gives them."""
    g_all = {n: (g if g is not None else torch.zeros_like(params[n]))
             for n, g in grads.items()}
    gnorm = global_norm(g_all.values())
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state["step"] += 1
    lr = lr_at(cfg, state["step"], device=gnorm.device)
    t = state["step"].float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    for name, p in params.items():
        g = g_all[name].float() * clip
        m_s, v_s = state["m"][name], state["v"][name]
        m = cfg.b1 * m_s.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v_s.float() + (1 - cfg.b2) * torch.square(g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decays(name, p):
            update = update + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * update)
        m_s.copy_(m)
        v_s.copy_(v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
