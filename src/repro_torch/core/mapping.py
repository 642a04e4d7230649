"""Server-to-satellite placement strategies (paper §3.4-3.7, Figs 13-15).

The port's own copy of ``repro/core/mapping.py``.

A *server* is a virtual chunk destination: chunk ``i`` of a block lands on
server ``i mod num_servers`` (paper §3.1).  A placement strategy assigns each
logical server id (1-based, matching the paper's figures) a satellite.

The paper's concentric-circle layouts (Figs 14-15) are reproduced exactly by
a breadth-first traversal from the center satellite with neighbor order
north, east, south, west (up, right, down, left in the figures), optionally
bounded to the LOS box.  This is verified against the published 3x3 and 5x5
grids in the tests.
"""
from __future__ import annotations

import enum
import math
from collections import deque

from repro_torch.core.constellation import ConstellationSpec, LosWindow, Sat


class Strategy(enum.Enum):
    ROTATION = "rotation"
    HOP = "hop"
    ROTATION_HOP = "rotation_hop"


# BFS neighbor order: up (north), right (east), down (south), left (west).
_BFS_STEPS = ((0, -1), (1, 0), (0, 1), (-1, 0))  # (d_plane, d_slot)


def _bfs_offsets(
    num_servers: int,
    *,
    bound: tuple[int, int] | None,
    torus: tuple[int, int] | None,
) -> list[tuple[int, int]]:
    """(d_plane, d_slot) offsets from center for server ids 1..num_servers.

    ``bound``: optional (rows, cols) LOS box limit around the center.
    ``torus``: (num_planes, sats_per_plane) for wraparound dedup; required
    when unbounded so the BFS terminates on small constellations.
    """
    if bound is not None:
        rows, cols = bound
        lo_c, hi_c = -((cols - 1) // 2), cols // 2
        lo_r, hi_r = -((rows - 1) // 2), rows // 2

    def in_bound(dp: int, ds: int) -> bool:
        if bound is None:
            return True
        return lo_c <= dp <= hi_c and lo_r <= ds <= hi_r

    def canon(dp: int, ds: int) -> tuple[int, int]:
        if torus is None:
            return dp, ds
        n, m = torus
        return dp % n, ds % m

    out: list[tuple[int, int]] = []
    seen = {canon(0, 0)}
    queue: deque[tuple[int, int]] = deque([(0, 0)])
    out.append((0, 0))
    while queue and len(out) < num_servers:
        dp, ds = queue.popleft()
        for sp, ss in _BFS_STEPS:
            np_, ns = dp + sp, ds + ss
            key = canon(np_, ns)
            if key in seen or not in_bound(np_, ns):
                continue
            seen.add(key)
            queue.append((np_, ns))
            out.append((np_, ns))
            if len(out) == num_servers:
                break
    if len(out) < num_servers:
        raise ValueError(
            f"cannot place {num_servers} servers: only {len(out)} positions"
        )
    return out


def bounding_box_side(num_servers: int) -> int:
    """Paper §3.7: the LOS bounding box side is ceil(sqrt(num_servers))."""
    return int(math.ceil(math.sqrt(num_servers)))


def place_servers(
    strategy: Strategy,
    spec: ConstellationSpec,
    window: LosWindow,
    num_servers: int,
) -> list[Sat]:
    """Map server ids 1..num_servers to satellites.

    Returns a list where index ``i`` holds the satellite of server ``i+1``.

    * ROTATION      -- row-major, left->right top->bottom over the LOS window
                       (Fig 13 / §3.5); requires num_servers <= window area.
    * HOP           -- concentric BFS rings around the window center,
                       unbounded (Fig 14 / §3.6); for on-board hosts.
    * ROTATION_HOP  -- BFS rings bounded to a ceil(sqrt(S))-sided box
                       centered on the window center (Fig 15 / §3.7).
    """
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if strategy is Strategy.ROTATION:
        sats = window.sats(spec)
        if num_servers > len(sats):
            raise ValueError(
                f"rotation-aware placement needs num_servers <= LOS area "
                f"({num_servers} > {len(sats)})"
            )
        return sats[:num_servers]
    if strategy is Strategy.HOP:
        offs = _bfs_offsets(
            num_servers,
            bound=None,
            torus=(spec.num_planes, spec.sats_per_plane),
        )
    else:
        side = bounding_box_side(num_servers)
        offs = _bfs_offsets(
            num_servers,
            bound=(side, side),
            torus=(spec.num_planes, spec.sats_per_plane),
        )
    c = window.center
    return [spec.wrap(Sat(c.plane + dp, c.slot + ds)) for dp, ds in offs]


def layout_grid(
    strategy: Strategy, side: int, *, spec: ConstellationSpec | None = None
) -> list[list[int]]:
    """Render a strategy as the paper's side x side figure grid.

    Cell value = logical server id (1-based); 0 = unused cell (possible for
    HOP whose diamond does not fill the square).  Reproduces Figs 13-15.
    """
    if spec is None:
        # Large enough torus that wraparound does not fold the figure.
        spec = ConstellationSpec(4 * side, 4 * side, altitude_km=550.0)
    center = Sat(2 * side, 2 * side)
    window = LosWindow(center, side, side)
    num = side * side
    sats = place_servers(strategy, spec, window, num)
    tl = window.top_left(spec)
    grid = [[0] * side for _ in range(side)]
    for sid, sat in enumerate(sats, start=1):
        dp, ds = spec.torus_delta(tl, sat)
        if 0 <= ds < side and 0 <= dp < side:
            grid[ds][dp] = sid
    return grid


def hop_rings(num_servers: int) -> list[int]:
    """Hop count (ring index) of each server id under BFS placement."""
    offs = _bfs_offsets(num_servers, bound=None, torus=None)
    return [abs(dp) + abs(ds) for dp, ds in offs]
