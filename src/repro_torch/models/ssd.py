"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060), ported
from ``repro/models/ssd.py``.

Prefill runs the chunked SSD scan (``ops.ssd_scan``: the Hopper kernel on
CUDA tensors, the plain version on CPU ones); decode is the O(1)
per-token state recurrence.  The decode state ``(conv, state)`` is a
fixed-size snapshot, and for this family that snapshot is the block
SkyMemory stores.  Weights keep the reference's separate projections and
``[in, out]`` layouts.

Under a mesh (training, ``repro_torch.distributed``) the projections,
the gates and the gated norm run as ``DTensor`` ops (the norm's mean
over the ``model``-sharded inner dim is a sum across shards); the
causal convs (whose padding DTensor mislays in some torch releases) and
the scan run in ``local_map`` on each rank's batch rows and channels or
heads (``_causal_conv``, ``scan``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (
    active_rules,
    at_layout,
    divisible,
    is_dtensor,
    merge_heads,
    partial_over,
    placements,
    run_local,
    split_heads,
)
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
    the reference's order of sums.  Under a mesh it runs in ``local_map``
    on each rank's batch rows and channels (batch over the data axes,
    channels over ``model`` where they divide); the taps and bias, read
    whole over data, get partial-sum gradients there."""
    rules = active_rules()
    if rules is None or not is_dtensor(u):
        return _conv_taps(u, w, b, seqlen)
    mesh, tp = u.device_mesh, rules.model_axis
    dp_, _, cp = divisible(u.shape, (rules.data, None, tp), rules)
    u_pl = placements((dp_, None, cp), mesh)
    w_pl, b_pl = placements((None, cp), mesh), placements((cp,), mesh)

    def grad(pl):
        return pl if dp_ is None else partial_over(pl, mesh, rules.data_axes)

    return run_local(lambda *t: _conv_taps(*t, seqlen), mesh,
                     (u_pl, w_pl, b_pl), u_pl,
                     (u_pl, grad(w_pl), grad(b_pl)))(u, w, b)


def _conv_taps(u, w, b, seqlen: int):
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = sum(up[:, j: j + seqlen] * w[j] for j in range(k))
    return out + b


def _scan(xh, dt, a, b_mat, c_mat, state0, chunk: int):
    """``ops.ssd_scan`` over the sequence padded to a multiple of
    ``chunk``; returns ``(y [B, L, H, P], final state)``.

    Always the configured chunk, padded (the reference takes
    ``min(chunk, seqlen)``): the card's scan rounds the final state by the
    chunk length, so a prefill resumed from a snapshot would otherwise
    leave another state than the full prefill it replaces.  Zeros pad the
    sequence; ``dt = 0`` on padded steps keeps the recurrence exact (decay
    ``exp(0) = 1``, update 0)."""
    seqlen = xh.shape[1]
    pad = (-seqlen) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, final = ops.ssd_scan(
        xh.contiguous(), dt.contiguous(), a, b_mat.contiguous(),
        c_mat.contiguous(), chunk_size=chunk, initial_state=state0)
    return (y[:, :seqlen] if pad else y), final


def scan(xh, dt, a, b_mat, c_mat, state0, chunk: int):
    """``_scan``; under a mesh, inside ``local_map`` on each rank's batch
    rows and heads (batch over the data axes and heads over ``model``
    where they divide).  B and C have ``G`` groups, which need not follow
    the heads (mamba2 has one), so every rank of ``model`` reads them
    whole and their gradient is a partial sum over ``model``; A has no
    batch dim, so its gradient is a partial sum over the data axes."""
    rules = active_rules()
    if rules is None or not is_dtensor(xh):
        return _scan(xh, dt, a, b_mat, c_mat, state0, chunk)
    mesh, tp = xh.device_mesh, rules.model_axis
    spec_x = divisible(xh.shape, (rules.data, None, tp, None), rules)
    dp_, tp_ = spec_x[0], spec_x[2]

    def place(*spec):
        return placements(spec, mesh)

    place_bc = place(dp_, None, None, None)
    grad_bc = place_bc if tp_ is None else partial_over(place_bc, mesh, tp)
    # A has no batch dim: each data rank's gradient is its rows' part
    grad_a = (place(tp_) if dp_ is None
              else partial_over(place(tp_), mesh, rules.data_axes))
    place_s = place(dp_, tp_, None, None)
    ins = [place(*spec_x), place(dp_, None, tp_), place(tp_), place_bc,
           place_bc, place_s if state0 is not None else None]
    grads = [ins[0], ins[1], grad_a, grad_bc, grad_bc, ins[5]]
    return run_local(
        lambda *t: _scan(*t, chunk), mesh, ins, (place(*spec_x), place_s),
        grads)(xh, dt, a, b_mat, c_mat, state0)


def ssd_prefill(m: SSD, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None):
    """x [B, L, D] -> ``(out [B, L, D], {"conv", "state"})``.

    ``state`` is an optional snapshot ``{"conv": [B, K-1, di+2gn],
    "state": [B, H, P, N]}`` restored from SkyMemory: the scan resumes
    from it without rescanning the cached prefix.  The returned
    ``conv`` is the pre-conv input of the last K-1 positions, the
    ``state`` the scan's final state (f32)."""
    seqlen = x.shape[1]
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

    xh = split_heads(cx, h, p)
    b_mat = split_heads(cbc[..., : g * n], g, n)
    c_mat = split_heads(cbc[..., g * n:], g, n)
    dt = F.softplus(dt.float() + m.dt_bias)
    y, ssm_state = scan(xh, dt, -torch.exp(m.a_log), b_mat, c_mat,
                        ssm_state0, cfg.ssm_chunk)
    y = y + m.d_skip[None, None, :, None].to(y.dtype) * xh
    y = rms_norm_gated(merge_heads(y), z, m.norm_scale, cfg.norm_eps)
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


def decode_recurrence(xh, dt, a, bv, cv, ssm_state):
    """``ops.ssd_decode_step``; with a ``DTensor`` state (``[B, H, P, N]``,
    heads over ``model`` as ``sharding.cache_specs`` lays it out), inside
    ``local_map`` on each rank's rows and heads.  B and C (``[B, G, N]``)
    are read whole over the head axes, and each rank takes the groups its
    heads read (head ``h`` reads group ``h // (H / G)``)."""
    if not is_dtensor(ssm_state):
        return ops.ssd_decode_step(xh, dt, a, bv, cv, ssm_state)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.decode import block_index

    mesh = ssm_state.device_mesh
    pls = list(ssm_state.placements)         # batch Shard(0), heads Shard(1)
    a_pl = [Shard(0) if pl.is_shard(1) else Replicate() for pl in pls]
    rows = [pl if pl.is_shard(0) else Replicate() for pl in pls]
    head_axes = tuple(n for n, pl in zip(mesh.mesh_dim_names, pls)
                      if pl.is_shard(1))
    rep = xh.shape[1] // bv.shape[1]

    def local(xl, dtl, al, bl, cl, sl):
        h_l = xl.shape[1]
        first = block_index(mesh, head_axes)[0] * h_l
        groups = (first + torch.arange(h_l, device=xl.device)) // rep
        return ops.ssd_decode_step(xl, dtl, al, bl[:, groups], cl[:, groups],
                                   sl)

    return run_local(local, mesh, (pls, pls, a_pl, rows, rows, pls),
                     (pls, pls))(xh, dt, a, bv, cv, ssm_state)


def ssd_decode(m: SSD, x: torch.Tensor, cfg: ModelConfig, *,
               conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """x [B, 1, D]; the O(1) recurrence.  Returns ``(out [B, 1, D],
    conv_state', ssm_state')``.  Under a mesh the state's heads ride
    ``model`` and the recurrence runs on each rank's heads
    (``decode_recurrence``); the conv state stays whole over ``model``."""
    di, g, n, h, p = _dims(cfg)
    xt = x[:, 0]
    z = xt @ m.wz

    def rows(t):          # a projection laid out as the conv state's rows
        return at_layout(t, conv_state)

    xin = rows(xt @ m.wx)
    bc = torch.cat([rows(xt @ m.wb), rows(xt @ m.wc)], dim=-1)
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

    xh = split_heads(cx, h, p)
    bv = split_heads(cbc[:, : g * n], g, n)
    cv = split_heads(cbc[:, g * n:], g, n)
    dt = F.softplus(dt.float() + m.dt_bias)                     # [B, H]
    y, new_ssm = decode_recurrence(xh, dt, -torch.exp(m.a_log), bv, cv,
                                   ssm_state)
    y = y + m.d_skip[None, :, None].to(y.dtype) * xh
    y = rms_norm_gated(merge_heads(y), z, m.norm_scale, cfg.norm_eps)
    return (y @ m.out_proj)[:, None], window[:, 1:], new_ssm
