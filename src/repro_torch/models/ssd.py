"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060), ported
from ``repro/models/ssd.py``.

Prefill runs the chunked SSD scan (``ops.ssd_scan``: the Hopper kernel on
CUDA tensors, the plain version on CPU ones); decode is the O(1)
per-token state recurrence.  The decode state ``(conv, state)`` is a
fixed-size snapshot, and for this family that snapshot is the block
SkyMemory stores.  Weights keep the reference's separate projections and
``[in, out]`` layouts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense_init_,
    rms_norm_gated,
    torch_dtype,
    weight,
)


def _dims(cfg: ModelConfig):
    return (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
            cfg.ssm_head_dim)


class SSD(nn.Module):
    """The weights of one Mamba-2 mixer: projections ``wz``/``wx``/``wb``/
    ``wc``/``wdt`` and ``out_proj`` and the depthwise convs in the model
    dtype; ``a_log``, ``dt_bias``, ``d_skip`` and ``norm_scale`` in f32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        di, g, n, h, _ = _dims(cfg)
        dt = torch_dtype(cfg.dtype)
        k = cfg.ssm_conv
        self.wz = weight((d, di), dt, device)
        self.wx = weight((d, di), dt, device)
        self.wb = weight((d, g * n), dt, device)
        self.wc = weight((d, g * n), dt, device)
        self.wdt = weight((d, h), dt, device)
        self.conv_x_w = weight((k, di), dt, device)
        self.conv_x_b = weight((di,), dt, device)
        self.conv_bc_w = weight((k, 2 * g * n), dt, device)
        self.conv_bc_b = weight((2 * g * n,), dt, device)
        self.a_log = weight((h,), torch.float32, device)
        self.dt_bias = weight((h,), torch.float32, device)
        self.d_skip = weight((h,), torch.float32, device)
        self.norm_scale = weight((di,), torch.float32, device)
        self.out_proj = weight((di, d), dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The distribution of ``repro.models.ssd.init_ssd``: fan-in
        truncated normals (the convs' fan-in is their width), zero conv
        biases, ``A = -exp(a_log)`` with ``exp(a_log)`` uniform in
        [1, 16], ``dt_bias`` the inverse softplus of a log-uniform step in
        [1e-3, 0.1], ``d_skip`` and ``norm_scale`` ones."""
        for w in (self.wz, self.wx, self.wb, self.wc, self.wdt,
                  self.out_proj):
            dense_init_(w, generator)
        k = self.conv_x_w.shape[0]
        dense_init_(self.conv_x_w, generator, fan_in=k)
        dense_init_(self.conv_bc_w, generator, fan_in=k)
        self.conv_x_b.zero_()
        self.conv_bc_b.zero_()
        h = self.a_log.shape[0]
        dev = self.a_log.device

        def uniform(lo, hi):
            return torch.rand(h, generator=generator, device=dev) * (hi - lo) + lo

        self.a_log.copy_(torch.log(uniform(1.0, 16.0)))
        dt_init = torch.exp(uniform(math.log(1e-3), math.log(0.1)))
        self.dt_bias.copy_(dt_init + torch.log(-torch.expm1(-dt_init)))
        self.d_skip.fill_(1.0)
        self.norm_scale.fill_(1.0)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 seqlen: int) -> torch.Tensor:
    """Depthwise causal conv, unrolled over the (small) kernel width, in
    the reference's order of sums."""
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = sum(up[:, j: j + seqlen] * w[j] for j in range(k))
    return out + b


def ssd_prefill(m: SSD, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None):
    """x [B, L, D] -> ``(out [B, L, D], {"conv", "state"})``.

    ``state`` is an optional snapshot ``{"conv": [B, K-1, di+2gn],
    "state": [B, H, P, N]}`` restored from SkyMemory: the scan resumes
    from it without rescanning the cached prefix.  The returned
    ``conv`` is the pre-conv input of the last K-1 positions, the
    ``state`` the scan's final state (f32)."""
    bsz, seqlen, _ = x.shape
    di, g, n, h, p = _dims(cfg)
    k1 = cfg.ssm_conv - 1
    z = x @ m.wz
    xin = x @ m.wx
    bc = torch.cat([x @ m.wb, x @ m.wc], dim=-1)
    dt = x @ m.wdt

    ssm_state0 = None
    if state is not None:
        tail = state["conv"]                      # [B, K-1, di+2gn]
        ssm_state0 = state["state"].float().contiguous()
        conv_in_x = torch.cat([tail[..., :di].to(xin.dtype), xin], 1)
        conv_in_bc = torch.cat([tail[..., di:].to(bc.dtype), bc], 1)
        cx = _causal_conv(conv_in_x, m.conv_x_w, m.conv_x_b,
                          conv_in_x.shape[1])[:, tail.shape[1]:]
        cbc = _causal_conv(conv_in_bc, m.conv_bc_w, m.conv_bc_b,
                           conv_in_bc.shape[1])[:, tail.shape[1]:]
    else:
        conv_in_x, conv_in_bc = xin, bc
        cx = _causal_conv(xin, m.conv_x_w, m.conv_x_b, seqlen)
        cbc = _causal_conv(bc, m.conv_bc_w, m.conv_bc_b, seqlen)
    cx = F.silu(cx)
    cbc = F.silu(cbc)

    xh = cx.reshape(bsz, seqlen, h, p)
    b_mat = cbc[..., : g * n].reshape(bsz, seqlen, g, n)
    c_mat = cbc[..., g * n:].reshape(bsz, seqlen, g, n)
    dt = F.softplus(dt.float() + m.dt_bias)

    # always the configured chunk, padded (the reference takes
    # min(chunk, seqlen)): the card's scan rounds the final state by the
    # chunk length, so a prefill resumed from a snapshot would otherwise
    # leave another state than the full prefill it replaces
    chunk = cfg.ssm_chunk
    pad = (-seqlen) % chunk
    if pad:
        # zero-pad to a chunk multiple; dt = 0 on padded steps keeps the
        # recurrence exact (decay exp(0) = 1, update 0)
        xh_s = F.pad(xh, (0, 0, 0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    else:
        xh_s = xh
    y, ssm_state = ops.ssd_scan(
        xh_s.contiguous(), dt.contiguous(), -torch.exp(m.a_log),
        b_mat.contiguous(), c_mat.contiguous(), chunk_size=chunk,
        initial_state=ssm_state0)
    if pad:
        y = y[:, :seqlen]
    y = y + m.d_skip[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(bsz, seqlen, di)
    y = rms_norm_gated(y, z, m.norm_scale, cfg.norm_eps)
    out = y @ m.out_proj

    # pre-conv tails for decode resumption (= the cacheable snapshot).
    # The reference slices the new tokens alone (xin[:, -k1:]), which is
    # shorter than K-1 when fewer than K-1 tokens are prefilled; here the
    # tail is taken from the conv's whole input (snapshot tail, or the
    # causal zeros, in front of the new tokens), so it always holds K-1
    # positions.  With L >= K-1 the two are the same values.
    conv_in = torch.cat([conv_in_x, conv_in_bc], dim=-1)
    if conv_in.shape[1] < k1:
        conv_in = F.pad(conv_in, (0, 0, k1 - conv_in.shape[1], 0))
    return out, {"conv": conv_in[:, -k1:], "state": ssm_state}


def ssd_decode(m: SSD, x: torch.Tensor, cfg: ModelConfig, *,
               conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x [B, 1, D]; the O(1) recurrence.  Returns ``(out [B, 1, D],
    conv_state', ssm_state')``."""
    bsz = x.shape[0]
    di, g, n, h, p = _dims(cfg)
    xt = x[:, 0]
    z = xt @ m.wz
    xin = xt @ m.wx
    bc = torch.cat([xt @ m.wb, xt @ m.wc], dim=-1)
    dt = xt @ m.wdt

    new_in = torch.cat([xin, bc], dim=-1)                        # [B, C]
    window = torch.cat([conv_state.to(new_in.dtype), new_in[:, None]],
                       dim=1)                                    # [B, K, C]
    cx = torch.einsum("bkc,kc->bc", window[..., :di], m.conv_x_w) \
        + m.conv_x_b
    cbc = torch.einsum("bkc,kc->bc", window[..., di:], m.conv_bc_w) \
        + m.conv_bc_b
    cx = F.silu(cx)
    cbc = F.silu(cbc)

    xh = cx.reshape(bsz, h, p)
    bv = cbc[:, : g * n].reshape(bsz, g, n)
    cv = cbc[:, g * n:].reshape(bsz, g, n)
    dt = F.softplus(dt.float() + m.dt_bias)                     # [B, H]
    y, new_ssm = ops.ssd_decode_step(xh, dt, -torch.exp(m.a_log), bv, cv,
                                     ssm_state)
    y = y + m.d_skip[None, :, None].to(y.dtype) * xh
    y = rms_norm_gated(y.reshape(bsz, di), z, m.norm_scale, cfg.norm_eps)
    return (y @ m.out_proj)[:, None], window[:, 1:], new_ssm
