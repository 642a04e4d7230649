"""SkyMemory placement math on a 2D device torus, and the rotation
migration of cache shards as a ``torch.distributed`` exchange.

The port's counterpart of ``repro/core/tpu_cache.py``, which models the
TPU's ICI torus: the same +GRID abstraction the paper assumes for
satellites, at chip scale.

* *chunk striping*  -> sequence-dim sharding of the paged KV cache across
  the ``data`` mesh axis (``kvc_sharding``: each rank holds ``1/n`` of the
  context blocks);
* *hop-aware placement* -> assigning logical cache shards to mesh
  positions in BFS rings around the decode host so a gather touches the
  fewest hops (``TorusGrid.ring_layout``);
* *rotation migration* -> every rank forwards its shard one position
  along the axis in one ``batch_isend_irecv`` (``migrate_shards``): NCCL
  on the card, gloo on the CPU;
* the paper's worst-case latency estimator (``gather_cost_s``) over a
  ``LinkModel`` the caller gives: the port carries no link constants of
  its own.

The host math is numpy and plain Python, bitwise the reference's;
``torch`` is imported only by the two distributed functions, so
``repro_torch.core`` stays torch-free.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.mapping import Strategy, _bfs_offsets


@dataclass(frozen=True)
class LinkModel:
    """One link of the device torus: latency per hop and bytes per
    second over the last link."""

    hop_latency_s: float
    link_bytes_per_s: float


@dataclass(frozen=True)
class TorusGrid:
    """A 2D device torus (rows x cols) -- chip-scale +GRID."""

    rows: int
    cols: int

    @property
    def size(self) -> int:
        return self.rows * self.cols

    def hops(self, a: tuple[int, int], b: tuple[int, int]) -> int:
        dr = abs(a[0] - b[0])
        dc = abs(a[1] - b[1])
        return min(dr, self.rows - dr) + min(dc, self.cols - dc)

    def ring_layout(
        self, num_shards: int, center: tuple[int, int] = (0, 0),
        strategy: Strategy = Strategy.HOP,
    ) -> list[tuple[int, int]]:
        """Positions for logical shards 0..n-1, BFS rings around ``center``.

        The same traversal that reproduces the paper's Figs 14-15, so shard 0
        sits on the host device and shard *i*'s hop distance grows ~sqrt(i).
        """
        if num_shards > self.size:
            raise ValueError("more shards than devices")
        bound = None
        if strategy is Strategy.ROTATION_HOP:
            side = int(math.ceil(math.sqrt(num_shards)))
            bound = (side, side)
        offs = _bfs_offsets(num_shards, bound=bound, torus=(self.cols, self.rows))
        return [
            ((center[0] + ds) % self.rows, (center[1] + dp) % self.cols)
            for dp, ds in offs
        ]

    def worst_hops(self, layout: list[tuple[int, int]], center: tuple[int, int]) -> int:
        return max((self.hops(center, pos) for pos in layout), default=0)


def gather_cost_s(
    grid: TorusGrid,
    layout: list[tuple[int, int]],
    center: tuple[int, int],
    bytes_per_shard: int,
    link: LinkModel,
) -> float:
    """Paper Eq-3-style worst-case fetch estimate over ``link``.

    Per-shard fetch = hop latency x hops + serialization over the last link;
    all shards move in parallel (paper: chunks queried in parallel), so the
    gather cost is the max.
    """
    per = [
        grid.hops(center, pos) * link.hop_latency_s
        + bytes_per_shard / link.link_bytes_per_s
        for pos in layout
    ]
    return max(per, default=0.0)


def row_major_layout(grid: TorusGrid, num_shards: int) -> list[tuple[int, int]]:
    """The rotation-aware (Fig 13) baseline layout at chip scale."""
    if num_shards > grid.size:
        raise ValueError("more shards than devices")
    return [(i // grid.cols, i % grid.cols) for i in range(num_shards)]


def strategy_cost_table(
    grid: TorusGrid, num_shards: int, bytes_per_shard: int,
    link: LinkModel, center: tuple[int, int] | None = None,
) -> dict[str, float]:
    """Compare the paper's placements as chip-scale gather costs."""
    if center is None:
        center = (grid.rows // 2, grid.cols // 2)
    layouts = {
        "rotation(row-major)": row_major_layout(grid, num_shards),
        "hop(bfs-rings)": grid.ring_layout(num_shards, center, Strategy.HOP),
        "rotation_hop(boxed-rings)": grid.ring_layout(
            num_shards, center, Strategy.ROTATION_HOP
        ),
    }
    return {
        name: gather_cost_s(grid, layout, center, bytes_per_shard, link)
        for name, layout in layouts.items()
    }


def shard_layout_permutation(
    grid: TorusGrid, num_shards: int, center: tuple[int, int],
    strategy: Strategy = Strategy.ROTATION_HOP,
) -> np.ndarray:
    """Permutation p where logical shard i lives at flat device index p[i]."""
    layout = grid.ring_layout(num_shards, center, strategy)
    return np.array([r * grid.cols + c for r, c in layout], dtype=np.int32)


def device_grid_for_mesh(mesh, axes: tuple[str, str] = ("data", "model")) -> TorusGrid:
    """The torus of a 2D ``DeviceMesh`` named ``axes``."""
    names = mesh.mesh_dim_names
    return TorusGrid(rows=mesh.shape[names.index(axes[0])],
                     cols=mesh.shape[names.index(axes[1])])


# ---------------------------------------------------------------------------
# torch.distributed pieces: the sharded paged-KVC layout + the shard shift.
# ---------------------------------------------------------------------------

def kvc_sharding(mesh, *, seq_axis: str = "data", head_axis: str = "model"):
    """``DTensor`` placements, one per dim of ``mesh``, for a paged KV
    cache [n_blocks, block, kv_heads, head_dim]: context blocks striped
    over ``seq_axis`` (the paper's chunk striping, ``Shard(0)``), KV heads
    over ``head_axis`` (tensor parallel, ``Shard(2)``), replicated over
    any other dim."""
    from torch.distributed.tensor import Replicate, Shard

    by_name = {seq_axis: Shard(0), head_axis: Shard(2)}
    return tuple(by_name.get(name, Replicate())
                 for name in mesh.mesh_dim_names)


def migrate_shards(x, mesh, *, axis: str = "data", shift: int = 1):
    """Rotation migration at chip scale: cyclically shift cache shards
    ``shift`` positions along ``axis``.

    ``x`` is a ``DTensor`` on ``mesh`` whose leading dim is sharded over
    ``axis``.  Mirrors the paper's §3.4 parallel per-plane migration:
    the shard at position ``i`` of the axis moves to ``(i + shift) % n``,
    every move in one ``batch_isend_irecv``.  A position that maps to
    itself (every position of a ring of one, ``n == 1``) sends its shard
    to itself on NCCL; gloo cannot pair a rank with itself, so there the
    shard is copied, the same identity.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    dim = mesh.mesh_dim_names.index(axis)
    if x.placements[dim] != Shard(0):
        raise ValueError(f"leading dim must be sharded over {axis!r}, "
                         f"got {x.placements}")
    n = mesh.size(dim)
    me = mesh.get_local_rank(dim)
    local = x.to_local().contiguous()
    out = torch.empty_like(local)
    dst, src = (me + shift) % n, (me - shift) % n
    group = mesh.get_group(dim)
    if dst == me and dist.get_backend(group) == "gloo":
        out.copy_(local)
    else:
        ops = [dist.P2POp(dist.isend, local,
                          dist.get_global_rank(group, dst), group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, src), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return DTensor.from_local(out, mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())
