"""Rotary position embeddings with partial-rotary support.

Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` as
``repro/models/rope.py`` does (not the half-split ``rotate_half``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import replicated_like


def rope_freqs(head_dim: int, theta: float, rotary_pct: float = 1.0,
               device=None):
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps), rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [S] or [B, S] absolute positions.  A
    ``DTensor`` ``x`` is rotated by replicated angles (every rank holds
    all positions: the sequence dim is never sharded)."""
    d = x.shape[-1]
    inv, rot_dim = rope_freqs(d, theta, rotary_pct, device=x.device)
    if rot_dim == 0:
        return x
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[..., None] * inv[None, None, :]        # [B, S, rot/2]
    cos = replicated_like(torch.cos(angles)[:, :, None, :], x)
    sin = replicated_like(torch.sin(angles)[:, :, None, :], x)
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)
