"""Rotation chunk migration (paper §3.4, §3.8 step 7, Figs 5/8).

The port's own copy of ``repro/core/migration.py``.

When satellites drift out of the LOS window their chunks are migrated -- in
parallel within each orbital plane -- to the satellites about to enter LOS.
A migration is harmless if the chunk briefly exists on both satellites
(paper §3.7), so moves are modeled copy-then-delete.

A move carries metadata too: the directory-stripe shards
homed on the departing satellite (and its replica offsets) ride along to
the destination, so lookups keep resolving through the live server map
after rotation (``ConstellationKVC.execute_move``).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.constellation import ConstellationSpec, LosWindow, Sat


@dataclass(frozen=True)
class Move:
    server_id: int  # 1-based logical server id
    src: Sat
    dst: Sat


def plan_migration(
    spec: ConstellationSpec,
    old_window: LosWindow,
    new_window: LosWindow,
    server_map: list[Sat],
) -> list[Move]:
    """Plan per-plane parallel moves for servers whose satellite left LOS.

    A server whose satellite is no longer inside ``new_window`` is reassigned
    to the satellite in the *same orbital plane* offset by the window height
    (the satellite entering LOS at the same relative position), repeatedly
    until it lands inside the window (handles multi-step shifts).
    """
    d_slot = spec.torus_delta(old_window.center, new_window.center)[1]
    step = new_window.rows if d_slot >= 0 else -new_window.rows
    moves: list[Move] = []
    for sid0, sat in enumerate(server_map):
        if new_window.contains(spec, sat):
            continue
        dst = sat
        for _ in range(spec.sats_per_plane):  # bounded walk
            dst = spec.wrap(Sat(dst.plane, dst.slot + step))
            if new_window.contains(spec, dst):
                break
        moves.append(Move(server_id=sid0 + 1, src=sat, dst=dst))
    return moves


def migration_planes(moves: list[Move]) -> dict[int, list[Move]]:
    """Group moves by orbital plane -- each group executes in parallel."""
    groups: dict[int, list[Move]] = {}
    for m in moves:
        groups.setdefault(m.src.plane, []).append(m)
    return groups
