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

from repro_torch.distributed.sharding import at_layout, is_dtensor, local
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
                   moment_dtype: str = "float32",
                   layouts: dict[str, list] | None = None) -> dict:
    """Zero moments in ``moment_dtype`` beside each named parameter.  A
    ``DTensor`` parameter's moments are ``DTensor``s laid out as it is,
    or by ``layouts[name]`` where given (ZeRO-1: ``training.loop``)."""
    dt = torch_dtype(moment_dtype)
    device = local(next(iter(params.values()))).device
    layouts = layouts or {}

    def zeros():
        out = {}
        for n, p in params.items():
            if is_dtensor(p):
                from torch.distributed.tensor import zeros as dzeros

                out[n] = dzeros(p.shape, dtype=dt, device_mesh=p.device_mesh,
                                placements=layouts.get(n, list(p.placements)))
            else:
                out[n] = torch.zeros(p.shape, dtype=dt, device=p.device)
        return out

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _owned(t) -> bool:
    """Whether this rank counts its shard of ``t`` in a sum over every
    rank: it holds the first replica along each mesh axis that replicates
    ``t`` (a plain tensor: always)."""
    if not is_dtensor(t):
        return True
    mesh = t.device_mesh
    return all(pl.is_shard() or mesh.get_local_rank(i) == 0
               for i, pl in enumerate(t.placements))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32.  ``DTensor``s
    (sharded or replicated, never partial sums) count each element once:
    every rank sums the squares of the shards it owns (``_owned``), and
    one all-reduce over the world adds the ranks' sums."""
    tensors = list(tensors)
    total = sum(torch.sum(torch.square(local(x).float())) if _owned(x)
                else torch.zeros((), device=local(x).device)
                for x in tensors)
    if any(is_dtensor(x) for x in tensors):
        import torch.distributed as dist

        dist.all_reduce(total)
    return torch.sqrt(total)


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
    as ``jax.grad`` gives them.

    ``DTensor`` parameters are stepped shard by shard: each gradient and
    parameter is read at its moments' layout, the elementwise update runs
    on the local shards, and a parameter whose moments are laid out
    otherwise (ZeRO-1) gathers its new values back to its own layout.
    The schedule, the clip and the bias corrections are plain 0-d
    tensors, the same on every rank."""
    g_all = {n: at_layout(g if g is not None
                          else torch.zeros_like(params[n]), state["m"][n])
             for n, g in grads.items()}
    gnorm = global_norm(g_all.values())
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state["step"] += 1
    lr = lr_at(cfg, state["step"], device=gnorm.device)
    t = state["step"].float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    for name, p in params.items():
        m_d = state["m"][name]
        g = local(g_all[name]).float() * clip
        m_s, v_s = local(m_d), local(state["v"][name])
        pv = local(at_layout(p, m_d))
        m = cfg.b1 * m_s.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v_s.float() + (1 - cfg.b2) * torch.square(g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decays(name, p):
            update = update + cfg.weight_decay * pv.float()
        new = pv.float() - lr * update
        if is_dtensor(p) and list(p.placements) != list(m_d.placements):
            from torch.distributed.tensor import DTensor

            new = at_layout(DTensor.from_local(
                new.to(p.dtype), m_d.device_mesh, list(m_d.placements),
                run_check=False), p).to_local()
        local(p).copy_(new)
        m_s.copy_(m)
        v_s.copy_(v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
