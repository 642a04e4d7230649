"""Decode attention over a sequence-striped cache, flash-decoding style.

``sharding.cache_specs`` stripes the decode cache's sequence dim over
``model`` (over every axis when the batch is smaller than the data
axes): each rank holds one contiguous stripe of every row's tokens.  A
rank attends over its stripe alone and gets a partial output and each
head's log-sum-exp; the ranks' partials are all-gathered over exactly
the striped axes (a few kB per row, never the cache) and merged in a
fixed stripe order, so every rank ends with bitwise the same result.
The reference leaves that reduction to GSPMD; here it is explicit.

``run_striped`` runs a layer's stripe function on each rank in
``local_map`` and merges; ``Stripes`` describes one rank's stripe of a
cache ``DTensor``; ``gather`` and ``merge_partials`` are the collective
and the merge.  With one stripe nothing is gathered or merged, so a
``(1, 1)`` mesh gives the unsharded step's values.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import run_local


@dataclass(frozen=True)
class Stripes:
    """One rank's part of a cache ``DTensor``: its stripe of the sequence
    and its block of batch rows.  Axes are named major first, as the
    placements shard the dim."""

    mesh: object
    seq_axes: tuple[str, ...]   # the axes that stripe the sequence
    count: int                  # stripes, the product of their sizes
    start: int                  # this rank's first token
    length: int                 # tokens per stripe
    batch_axes: tuple[str, ...]
    rows: slice                 # this rank's rows of the global batch


def block_index(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """This rank's index among the ``count`` blocks a dim split over
    ``axes`` (major first) is cut into: ``(index, count)``."""
    index, count = 0, 1
    names = tuple(mesh.mesh_dim_names)
    for ax in axes:
        size = mesh.shape[names.index(ax)]
        index = index * size + mesh.get_local_rank(ax)
        count *= size
    return index, count


def stripes_of(t, seq_dim: int = 1, batch_dim: int = 0) -> Stripes:
    """The ``Stripes`` of this rank in the cache ``DTensor`` ``t`` (one
    layer, ``[B, S, ...]``)."""
    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names)

    def axes(dim):
        return tuple(n for n, pl in zip(names, t.placements)
                     if pl.is_shard(dim))

    seq_axes, batch_axes = axes(seq_dim), axes(batch_dim)
    idx, count = block_index(mesh, seq_axes)
    length = t.shape[seq_dim] // count
    bidx, bcount = block_index(mesh, batch_axes)
    nb = t.shape[batch_dim] // bcount
    return Stripes(mesh, seq_axes, count, idx * length, length, batch_axes,
                   slice(bidx * nb, (bidx + 1) * nb))


def row_placements(st: Stripes) -> list:
    """Placements of a per-row tensor (batch first) beside the cache:
    its rows over the cache's batch axes, whole on every other axis."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if n in st.batch_axes else Replicate()
            for n in st.mesh.mesh_dim_names]


def gather(t: torch.Tensor, st: Stripes) -> torch.Tensor:
    """Every stripe's ``t`` (this rank's local partial), stacked in
    stripe order: ``[st.count, *t.shape]``.  An all-gather over each
    striped axis, the minor one first."""
    import torch.distributed as dist

    out = t.contiguous()[None]
    for ax in reversed(st.seq_axes):
        group = st.mesh.get_group(ax)
        parts = [torch.empty_like(out)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts)
    return out


def merge_partials(outs, lses, dtype=None) -> torch.Tensor:
    """Merge per-stripe attention partials: ``outs`` [R, B, H, Dv] (each
    normalised over its own stripe) and ``lses`` [R, B, H] (each head's
    log-sum-exp over the stripe, -inf where the stripe holds no valid
    token) into ``sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M)``,
    ``M`` the largest ``lse_r``.  Sums in f32 in stripe order; a row with
    no valid token in any stripe gets zeros, as the paged-decode kernel
    gives.  Returns [B, H, Dv] in ``dtype`` (``outs``' dtype by default:
    partials may come in f32, unrounded, for a merge in bf16); one stripe
    is returned as it is, cast to ``dtype``."""
    dtype = dtype or outs[0].dtype
    if len(outs) == 1:
        return outs[0].to(dtype)
    m = lses[0]
    for r in range(1, len(lses)):
        m = torch.maximum(m, lses[r])
    m = torch.where(torch.isfinite(m), m, 0.0)
    num = torch.zeros(outs[0].shape, dtype=torch.float32,
                      device=outs[0].device)
    den = torch.zeros(m.shape, dtype=torch.float32, device=m.device)
    for r in range(len(outs)):
        w = torch.exp(lses[r] - m)
        num = num + w[..., None] * outs[r].float()
        den = den + w
    out = torch.where(den[..., None] > 0,
                      num / torch.where(den > 0, den, 1.0)[..., None], 0.0)
    return out.to(dtype)


def run_striped(fn, rows: tuple, caches: tuple):
    """``fn(st, *rows_local, *caches_local) -> (partial, lse)`` on each
    rank's stripe of ``caches`` (one layer's cache ``DTensor``s, striped
    alike) and its block of ``rows`` (per-row ``DTensor``s, batch
    first), inside ``local_map``; the partials merged across the stripes.
    Returns the merged result in the dtype of ``rows[0]`` (the query), a
    ``DTensor`` whose rows ride the caches' batch axes."""
    st = stripes_of(caches[0])
    pls = row_placements(st)

    def local(*ts):
        part, lse = fn(st, *ts)
        if st.count == 1:
            return part
        return merge_partials(gather(part, st), gather(lse, st),
                              ts[0].dtype)

    return run_local(local, st.mesh,
                     (pls,) * len(rows) + tuple(list(c.placements)
                                                for c in caches),
                     pls)(*rows, *caches)
