"""Sharding rules: logical activation and parameter axes -> mesh axes, the
port's ``repro/distributed/sharding.py`` over ``torch.distributed``.

Mesh layout: ``(data, model)`` on one host or ``(pod, data, model)``
across pods.  Batch rides (pod, data); heads, FFN, experts and vocab ride
``model``; with ``fsdp`` a second parameter axis rides data.

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: None, a mesh axis name, or a tuple of names (the dim
split over several axes, the first the major one).  Specs are computed
from the mesh's axis names and sizes alone (``MeshShape`` stands for a
mesh that has no ranks, such as the 256- and 512-device production
meshes); ``placements`` turns one into ``DTensor`` placements on a live
``DeviceMesh``.

The port keeps each layer's weights apart, so a parameter is named as
``Model.named_parameters`` names it, and its spec is the reference's spec
of the stacked leaf (``convert.locations``) without the layer dim.
Parameter specs fall back to replication on a dim that does not divide
its mesh axes, as the reference's do.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MeshShape:
    """A mesh given by its axis names and sizes alone."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_names(mesh) -> tuple[str, ...]:
    return (mesh.axis_names if isinstance(mesh, MeshShape)
            else tuple(mesh.mesh_dim_names))


@dataclass(frozen=True)
class AxisRules:
    mesh: object                                 # DeviceMesh or MeshShape
    data_axes: tuple[str, ...] = ("data",)      # ("pod", "data") multi-pod
    model_axis: str = "model"
    shard_kv_heads: bool = True                  # False -> replicate K/V proj
    seq_shard_cache: bool = False                # long_500k context sharding
    fsdp: bool = True                            # shard params over data too
    attn_tp: bool = True                         # False: attention weights
                                                 # keep all heads local
    seq_parallel_acts: bool = False              # residual-stream
                                                 # activations sharded over
                                                 # (data, model)

    @property
    def data(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in axes:
            n *= sizes[a]
        return n


_local = threading.local()


def active_rules() -> AxisRules | None:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules | None):
    prev = active_rules()
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


# ---------------------------------------------------------------------------
# Specs and placements.
# ---------------------------------------------------------------------------

def fits(shape, spec: tuple, rules: AxisRules) -> bool:
    """Whether every dim of ``shape`` divides the mesh axes of its entry."""
    return all(axes is None or dim % rules.axis_size(axes) == 0
               for dim, axes in zip(shape, spec))


def divisible(shape, spec: tuple, rules: AxisRules) -> tuple:
    """``spec`` with each entry whose dim does not divide it replaced by
    None (the reference's fallback).  A dim of size 1 is never sharded
    either: it divides only axes of size 1, where sharding is the same
    layout as replicating, and ``DTensor``'s view rules drop such a dim
    (a one-row batch would fail at ``x @ w``)."""
    return tuple(axes if axes is not None and dim > 1
                 and dim % rules.axis_size(axes) == 0 else None
                 for dim, axes in zip(shape, spec))


def placements(spec: tuple, mesh) -> list:
    """``DTensor`` placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` or
    a ``MeshShape``): each mesh axis a
    dim's entry names shards that dim (``Shard(d)``, so a dim over two
    axes gets two, major first as the mesh orders them); an axis no entry
    names replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in axis_names(mesh):
        dims = [d for d, axes in enumerate(spec)
                if axes == axis or (isinstance(axes, tuple) and axis in axes)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# Activation constraints (called from model code; no-op without rules).
# ---------------------------------------------------------------------------

_LOGICAL_ACT = {
    # (batch, seq, d_model)
    "act_btd": lambda r: (
        r.data, r.model_axis if r.seq_parallel_acts else None, None),
    # (batch, seq, hidden/heads*hd) - model-parallel feature dim
    "act_btf": lambda r: (r.data, None, r.model_axis),
    # logits (batch, seq, vocab)
    "logits": lambda r: (r.data, None, r.model_axis),
    # moe dispatch (groups, tokens, experts, capacity)
    "moe_dispatch": lambda r: (r.data, None, r.model_axis, None),
    # per-expert activations (groups, experts, capacity, d)
    "moe_expert": lambda r: (r.data, r.model_axis, None, None),
    # decode q/k/v right after projection [B, 1, H, hd]: replicate heads so
    # the (tiny) query is gathered instead of the (huge) model-striped cache
    "decode_qkv": lambda r: (r.data, None, None, None),
}


def maybe_shard(x, logical: str):
    """``x`` redistributed to the layout of ``logical`` under the active
    rules: the identity without rules, for a tensor that is not a
    ``DTensor``, and where a dim does not divide its axes (the reference
    skips such a constraint whole)."""
    rules = active_rules()
    if rules is None or not is_dtensor(x):
        return x
    spec_fn = _LOGICAL_ACT.get(logical)
    if spec_fn is None:
        return x
    spec = spec_fn(rules)
    if not fits(x.shape, spec, rules):
        return x
    return x.redistribute(x.device_mesh, placements(
        divisible(x.shape, spec, rules), x.device_mesh))


# ---------------------------------------------------------------------------
# Head splits and merges.
#
# The reference shards a projection's flat out-dim wherever it divides,
# which can fall inside a head (3 heads of 64 over 2 ranks), and XLA
# reshards the head split.  ``DTensor`` views a tensor into heads, or
# heads back into one dim, only where every rank holds whole heads: in
# the forward, and for the gradient that comes back.  So a head split or
# merge of a ``DTensor`` first gathers the axes that cut heads, and on a
# mesh with an axis that does not divide the heads the view's output
# gathers its gradient the same way before the view's backward runs.
# Elsewhere they are plain reshapes.
# ---------------------------------------------------------------------------

def _uneven(t, n: int) -> bool:
    """Whether ``t`` is a ``DTensor`` on a mesh with an axis that does
    not divide ``n`` heads."""
    return is_dtensor(t) and any(size > 1 and n % size
                                 for size in t.device_mesh.shape)


def _whole_heads(t, dim: int, n: int):
    """The ``DTensor`` ``t`` gathered over the axes that shard its dim
    ``dim`` (``n`` heads, or ``n`` heads' flat features) unless together
    they divide ``n``."""
    from torch.distributed.tensor import Replicate

    pls = list(t.placements)
    ways = 1
    for pl, size in zip(pls, t.device_mesh.shape):
        ways *= size if pl.is_shard(dim) else 1
    if n % ways == 0:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_shard(dim) else pl for pl in pls])


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity, whose backward gathers the gradient as
    ``_whole_heads`` does."""

    @staticmethod
    def forward(ctx, t, dim, n):
        ctx.heads = (dim, n)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            g = _whole_heads(g, *ctx.heads)
        return g, None, None


def split_heads(t, n: int, d: int):
    """``t`` [..., n * d] as [..., n, d]."""
    if is_dtensor(t):
        t = _whole_heads(t, t.ndim - 1, n)
    out = t.reshape(*t.shape[:-1], n, d)
    if not _uneven(t, n):
        return out
    return _WholeHeadsGrad.apply(out, out.ndim - 2, n)


def merge_heads(t):
    """``t`` [..., n, d] as [..., n * d]."""
    n, d = t.shape[-2:]
    if not _uneven(t, n):
        return t.reshape(*t.shape[:-2], n * d)
    out = _whole_heads(t, t.ndim - 2, n).reshape(*t.shape[:-2], n * d)
    return _WholeHeadsGrad.apply(out, out.ndim - 1, n)


# ---------------------------------------------------------------------------
# Parameter specs.
# ---------------------------------------------------------------------------

def _pad_left(spec: tuple, ndim: int) -> tuple:
    return (None,) * (ndim - len(spec)) + spec


def _rule_for(path: tuple[str, ...], ndim: int, rules: AxisRules) -> tuple:
    name = path[-1]
    in_moe = "moe" in path and "shared" not in path
    tp = rules.model_axis
    atp = tp if rules.attn_tp else None       # attention tensor parallelism
    dp = rules.data if rules.fsdp else None   # FSDP/ZeRO-3 second axis
    if in_moe and name in ("wi_gate", "wi_up", "wo"):
        return (tp, dp, None)              # (E, ., .) expert parallel + fsdp
    if name == "tok":
        return (tp, dp)                    # vocab-sharded embedding
    if name == "unembed":
        return (dp, tp)
    if name in ("wq", "wq_b"):
        return (dp, atp)
    if name in ("wi", "wi_gate", "wi_up", "wz", "wx", "wdt", "wb", "wc"):
        return (dp, tp)
    if name in ("wk", "wv"):
        return (dp, atp) if rules.shard_kv_heads else (dp, None)
    if name == "wo":
        return (atp, dp)
    if name == "out_proj":
        return (tp, dp)
    if name in ("w_uk", "w_uv"):
        return (atp, dp, None)             # heads
    if name in ("wkv_a", "wq_a"):
        return (dp, None)
    if name in ("conv_x_w",):
        return (None, tp)
    if name in ("conv_x_b", "norm_scale"):
        return (tp,)
    return ()                              # replicate


def param_specs(model, rules: AxisRules) -> dict[str, tuple]:
    """Each parameter's spec by its ``named_parameters`` name: the
    reference's spec of its leaf, where a stacked leaf drops its leading
    layer entry.  Only shapes are read, so a model on the ``meta`` device
    serves."""
    from repro_torch.convert import locations   # convert imports the model

    locs = locations(model)
    out = {}
    for name, p in model.named_parameters():
        path, layer = locs[name]
        shape = tuple(p.shape) if layer is None else (0, *p.shape)
        spec = divisible(shape, _pad_left(_rule_for(path, len(shape), rules),
                                          len(shape)), rules)
        out[name] = spec if layer is None else spec[1:]
    return out


def param_shardings(model, rules: AxisRules) -> dict[str, list]:
    """Each parameter's ``DTensor`` placements on ``rules.mesh`` (a
    ``DeviceMesh``)."""
    return {name: placements(spec, rules.mesh)
            for name, spec in param_specs(model, rules).items()}


@torch.no_grad()
def distribute_model(model, rules: AxisRules):
    """Replace every parameter of ``model`` by a ``DTensor`` laid out by
    ``param_shardings`` (those that are already ``DTensor``s stay).  Every
    rank holds the same whole weights (drawn from one seed or read from
    one file), so each keeps its own shard and nothing is sent.  Returns
    the model."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    layout = param_shardings(model, rules)
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            if is_dtensor(p):
                continue
            full = f"{mod_name}.{pname}" if mod_name else pname
            d = distribute_tensor(p.data, rules.mesh, layout[full],
                                  src_data_rank=None)
            mod.register_parameter(
                pname, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


# ---------------------------------------------------------------------------
# Batch and cache specs.
# ---------------------------------------------------------------------------

def batch_spec(rules: AxisRules, *, batch_shardable: bool = True) -> tuple:
    return (rules.data,) if batch_shardable else (None,)


def rows_shardable(batch: int, rules: AxisRules) -> bool:
    """Whether a batch of ``batch`` rows rides the data axes: it divides
    them and has more than one row (``divisible``)."""
    return divisible((batch,), (rules.data,), rules)[0] is not None


def cache_specs(cache: dict, rules: AxisRules, *, batch: int) -> dict:
    """Decode-cache specs, ``{part: {name: spec}}`` over a cache of
    ``init_cache``'s layout (``(layers, batch, seq, heads..., dim)``;
    only shapes are read, so ``meta`` tensors serve).

    The cache *sequence* dim is striped across ranks -- the paper's chunk
    striping at chip scale:

    * batch >= data size: batch over data, sequence over ``model``;
    * batch < data size (or ``rules.seq_shard_cache``): sequence over
      *every* axis, the data axes major.

    Decode attention then runs on each rank's stripe and the ranks'
    partials merge (``distributed/decode.py``).  The SSM state keeps its
    heads over ``model`` and its batch over data (not at batch < data
    size); the conv state its batch alone.  A dim that does not divide
    its axes falls back to None."""
    dsize = rules.axis_size(rules.data_axes)
    seq_shard = rules.seq_shard_cache or batch < dsize
    tp = rules.model_axis
    b_ax = None if seq_shard else rules.data

    def spec_of(part: str, name: str, t) -> tuple:
        if part == "ssm":
            spec = ((None, b_ax, tp, None, None) if name == "state"
                    else (None, b_ax, None, None))
        else:                           # kv / mla / cross: (L, B, S, ...)
            s_ax = (*rules.data_axes, tp) if seq_shard else tp
            spec = (None, b_ax, s_ax) + (None,) * (t.dim() - 3)
        return divisible(t.shape, spec[:t.dim()], rules)

    return {part: {name: spec_of(part, name, t) for name, t in leaves.items()}
            for part, leaves in cache.items()}


def cache_shardings(cache: dict, rules: AxisRules, *, batch: int) -> dict:
    """Each cache leaf's ``DTensor`` placements on ``rules.mesh``."""
    return {part: {name: placements(spec, rules.mesh)
                   for name, spec in leaves.items()}
            for part, leaves in cache_specs(cache, rules,
                                            batch=batch).items()}


@torch.no_grad()
def distribute_cache(cache: dict, rules: AxisRules, *, batch: int) -> dict:
    """The cache with every leaf a ``DTensor`` laid out by
    ``cache_shardings``.  Every rank holds the same whole cache (zeros, or
    one prefill's state), so each keeps its own shard and nothing is
    sent."""
    from torch.distributed.tensor import distribute_tensor

    layout = cache_shardings(cache, rules, batch=batch)
    return {part: {name: distribute_tensor(t, rules.mesh, layout[part][name],
                                           src_data_rank=None)
                   for name, t in leaves.items()}
            for part, leaves in cache.items()}


def layer(t: torch.Tensor, l: int) -> torch.Tensor:
    """Layer ``l`` of a stacked cache leaf ``[L, ...]``.  Of a ``DTensor``
    (whose layer dim is never sharded) it is a ``DTensor`` over a view
    of the local shard, so that writes to its local tensor land in the
    cache."""
    if not is_dtensor(t):
        return t[l]
    from torch.distributed.tensor import DTensor, Shard

    pls = [Shard(pl.dim - 1) if pl.is_shard() else pl for pl in t.placements]
    return DTensor.from_local(t.to_local()[l], t.device_mesh, pls,
                              run_check=False, shape=t.shape[1:],
                              stride=t.stride()[1:])


# ---------------------------------------------------------------------------
# Local computation on DTensors.
# ---------------------------------------------------------------------------

def replicated_like(t: torch.Tensor, ref):
    """``t``, a plain tensor every rank computes alike (RoPE's angles, a
    zero), as a replicated ``DTensor`` on ``ref``'s mesh when ``ref`` is
    one, else ``t`` itself."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def partial_over(pls: list, mesh, axes) -> list:
    """``pls`` with every replicated mesh axis of ``axes`` made a partial
    sum: the gradient placements of an input that each rank of those axes
    reads only in part."""
    from torch.distributed.tensor import Partial

    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return [Partial() if name in axes and pl.is_replicate() else pl
            for name, pl in zip(mesh.mesh_dim_names, pls)]


def run_local(fn, mesh, in_placements, out_placements,
              grad_placements=None):
    """``fn`` on each rank's local shards (``local_map``): its DTensor
    arguments are redistributed to ``in_placements`` (None for an
    argument that is not a tensor) and its outputs come back as DTensors
    with ``out_placements``.  ``grad_placements`` are the placements of
    the inputs' gradients, where they differ from ``in_placements``."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(tuple(grad_placements)
                                         if grad_placements else None),
                     device_mesh=mesh, redistribute_inputs=True)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (a view that writes through),
    or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a ``DTensor``, gathered (a collective: every
    rank of its mesh calls it), or ``t`` itself."""
    return t.full_tensor() if is_dtensor(t) else t


def _roll_shards(t, shift: int, dim: int):
    """``torch.roll`` of the ``DTensor`` ``t`` on each rank's shard, the
    dim first gathered over the axes that split it; other placements,
    partial sums too, pass through."""
    from torch.distributed.tensor import DTensor, Replicate

    pls = [Replicate() if pl.is_shard(dim) else pl for pl in t.placements]
    if pls != list(t.placements):
        t = t.redistribute(t.device_mesh, pls)
    return DTensor.from_local(torch.roll(t.to_local(), shift, dim),
                              t.device_mesh, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


class _Roll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shift, dim):
        ctx.roll = (-shift, dim)
        return _roll_shards(t, shift, dim)

    @staticmethod
    def backward(ctx, g):
        return _roll_shards(g, *ctx.roll), None, None


def roll(t: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(t, shift, dim)``; a ``DTensor`` is rolled on each
    rank's shard, forward and backward (the layout rule torch 2.13's
    ``DTensor`` has for ``aten.roll``; torch 2.11's has none)."""
    if not is_dtensor(t):
        return torch.roll(t, shift, dims=dim)
    return _Roll.apply(t, shift, dim)


def at_layout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements when ``like`` is a
    ``DTensor``, else ``t``."""
    if not is_dtensor(like):
        return t
    return t.redistribute(like.device_mesh, list(like.placements))
