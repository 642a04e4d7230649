"""+GRID 2D-torus LEO constellation model (paper §2, §3.2; Eqs 1-4).

The port's own copy of ``repro/core/constellation.py``.

Coordinate convention (matches the paper's simulation section):
  * a satellite is identified by ``Sat(plane, slot)``:
      - ``plane``  -- orbital-plane index, east-west direction, wraps modulo
        ``num_planes`` (the paper's ``s`` / ``N``);
      - ``slot``   -- position within the plane, north-south direction, wraps
        modulo ``sats_per_plane`` (the paper's ``o`` / ``M``).
  * the +GRID torus gives every satellite 4 ISL links: north/south to the
    adjacent slots of its own plane, east/west to the same slot of the
    adjacent planes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterator

R_EARTH_KM = 6371.0
C_KM_S = 299_792.458  # speed of light in vacuum (FSO ISL)


@dataclasses.dataclass(frozen=True, order=True)
class Sat:
    """A satellite position on the torus grid."""

    plane: int  # east-west column
    slot: int   # north-south row within the plane


@dataclasses.dataclass(frozen=True)
class ConstellationSpec:
    """A walker-delta style +GRID constellation (paper §3.2)."""

    num_planes: int        # N
    sats_per_plane: int    # M
    altitude_km: float
    inclination_deg: float = 53.0

    def __post_init__(self) -> None:
        if self.num_planes < 1 or self.sats_per_plane < 1:
            raise ValueError("constellation must have >=1 plane and >=1 sat/plane")
        if self.altitude_km <= 0:
            raise ValueError("altitude must be positive")

    @property
    def num_sats(self) -> int:
        return self.num_planes * self.sats_per_plane

    # -- Eq (1): worst-case distance between adjacent sats in the same plane.
    def intra_plane_distance_km(self) -> float:
        m = self.sats_per_plane
        return (R_EARTH_KM + self.altitude_km) * math.sqrt(
            2.0 * (1.0 - math.cos(2.0 * math.pi / m))
        )

    # -- Eq (2): worst-case distance between adjacent sats of adjacent planes.
    def inter_plane_distance_km(self) -> float:
        n = self.num_planes
        return (R_EARTH_KM + self.altitude_km) * math.sqrt(
            2.0 * (1.0 - math.cos(2.0 * math.pi / n))
        )

    def wrap(self, sat: Sat) -> Sat:
        return Sat(sat.plane % self.num_planes, sat.slot % self.sats_per_plane)

    def all_sats(self) -> Iterator[Sat]:
        for p in range(self.num_planes):
            for s in range(self.sats_per_plane):
                yield Sat(p, s)

    # ------------------------------------------------------------------
    # Torus metric (paper §4 directional distances).
    # ------------------------------------------------------------------
    def d_north(self, slot: int, slot_t: int) -> int:
        m = self.sats_per_plane
        if slot_t < slot:
            return slot - slot_t
        if slot_t > slot:
            return slot + m - slot_t
        return 0

    def d_south(self, slot: int, slot_t: int) -> int:
        m = self.sats_per_plane
        if slot_t > slot:
            return slot_t - slot
        if slot_t < slot:
            return m - slot + slot_t
        return 0

    def d_west(self, plane: int, plane_t: int) -> int:
        n = self.num_planes
        if plane_t < plane:
            return plane - plane_t
        if plane_t > plane:
            return plane + n - plane_t
        return 0

    def d_east(self, plane: int, plane_t: int) -> int:
        n = self.num_planes
        if plane_t > plane:
            return plane_t - plane
        if plane_t < plane:
            return n - plane + plane_t
        return 0

    def torus_delta(self, src: Sat, dst: Sat) -> tuple[int, int]:
        """Signed minimal (d_plane, d_slot) from ``src`` to ``dst``.

        Positive d_plane = east, positive d_slot = south.
        """
        src, dst = self.wrap(src), self.wrap(dst)
        de = self.d_east(src.plane, dst.plane)
        dw = self.d_west(src.plane, dst.plane)
        dn = self.d_north(src.slot, dst.slot)
        ds = self.d_south(src.slot, dst.slot)
        d_plane = de if de <= dw else -dw
        d_slot = ds if ds <= dn else -dn
        return d_plane, d_slot

    def hops(self, src: Sat, dst: Sat) -> int:
        """Minimal number of ISL hops on the +GRID torus (Manhattan)."""
        dp, ds = self.torus_delta(src, dst)
        return abs(dp) + abs(ds)

    def greedy_route(self, src: Sat, dst: Sat) -> list[Sat]:
        """Greedy one-axis-at-a-time route (paper §4), incl. endpoints."""
        src, dst = self.wrap(src), self.wrap(dst)
        path = [src]
        cur = src
        while cur != dst:
            dn = self.d_north(cur.slot, dst.slot)
            ds = self.d_south(cur.slot, dst.slot)
            dw = self.d_west(cur.plane, dst.plane)
            de = self.d_east(cur.plane, dst.plane)
            if 0 < dn <= ds or (ds == 0 and dn > 0):
                step = (0, -1) if dn <= ds else (0, 1)
            elif 0 < ds:
                step = (0, 1)
            elif 0 < dw <= de or (de == 0 and dw > 0):
                step = (-1, 0) if dw <= de else (1, 0)
            elif 0 < de:
                step = (1, 0)
            else:  # pragma: no cover - loop guard
                break
            cur = self.wrap(Sat(cur.plane + step[0], cur.slot + step[1]))
            path.append(cur)
        return path

    # ------------------------------------------------------------------
    # Physical distances / latencies.
    # ------------------------------------------------------------------
    def step_distance_km(self, d_plane: int, d_slot: int) -> float:
        """Eq (3): straight-line ISL distance for a (d_plane, d_slot) offset."""
        dm = self.intra_plane_distance_km()   # along-plane (slot direction)
        dn = self.inter_plane_distance_km()   # across planes
        return math.sqrt((dm * d_slot) ** 2 + (dn * d_plane) ** 2)

    def isl_distance_km(self, src: Sat, dst: Sat) -> float:
        dp, ds = self.torus_delta(src, dst)
        return self.step_distance_km(dp, ds)

    def isl_path_distance_km(self, src: Sat, dst: Sat) -> float:
        """Distance along the greedy +GRID route (one link at a time)."""
        dp, ds = self.torus_delta(src, dst)
        return abs(ds) * self.intra_plane_distance_km() + abs(dp) * (
            self.inter_plane_distance_km()
        )

    def path_latency_s(self, d_plane: int, d_slot: int) -> float:
        """Latency along the greedy +GRID route for a signed torus offset.

        THE single source of truth for routed ISL latency: per-hop
        intra-/inter-plane latencies times hop counts.  ``IslTransport``,
        the analytic simulator sweeps, and the serving router all price
        hops through here (or through the two one-hop scalars below), so
        a replica's hop-awareness score and the latency it later
        experiences come from the same model.
        """
        return (
            abs(d_slot) * self.intra_plane_latency_s()
            + abs(d_plane) * self.inter_plane_latency_s()
        )

    def isl_latency_s(self, src: Sat, dst: Sat, *, routed: bool = True) -> float:
        if routed:
            return self.path_latency_s(*self.torus_delta(src, dst))
        return self.isl_distance_km(src, dst) / C_KM_S

    def slant_range_km(self, ground_offset_km: float) -> float:
        """Eq (4): ground-to-satellite distance for a sub-satellite-point
        offset of ``ground_offset_km`` from the observer."""
        return math.sqrt(ground_offset_km**2 + self.altitude_km**2)

    def uplink_latency_s(self, ground_offset_km: float = 0.0) -> float:
        """Ground-to-overhead-satellite latency (Eq 4 at the given
        sub-satellite-point offset; 0 = directly underneath)."""
        return self.slant_range_km(ground_offset_km) / C_KM_S

    def ground_latency_s(self, sat: Sat, center: Sat) -> float:
        """Latency of a direct ground link to ``sat`` when the observer sits
        under ``center`` (the closest / directly-overhead satellite)."""
        d = self.isl_distance_km(center, sat)  # ground-projected offset
        return self.uplink_latency_s(d)

    def intra_plane_latency_s(self) -> float:
        """Paper Figs 1-2: one-hop intra-plane ISL latency."""
        return self.intra_plane_distance_km() / C_KM_S

    def inter_plane_latency_s(self) -> float:
        """One-hop inter-plane (east-west) ISL latency."""
        return self.inter_plane_distance_km() / C_KM_S


@functools.lru_cache(maxsize=4096)
def one_hop_intra_plane_latency_s(
    sats_per_plane: int, altitude_km: float
) -> float:
    """Figs 1-2 one-hop intra-plane latency for an (M, h) point.

    The analytic sweeps (``core.simulator``) call this in tight loops;
    caching here replaces the throwaway per-call ``ConstellationSpec``
    they used to build and keeps the latency math in this module.
    """
    return ConstellationSpec(
        num_planes=max(sats_per_plane, 2),
        sats_per_plane=sats_per_plane,
        altitude_km=altitude_km,
    ).intra_plane_latency_s()


@dataclasses.dataclass(frozen=True)
class LosWindow:
    """The rectangular LOS region of the grid around a center satellite.

    ``rows`` x ``cols`` box (slots x planes), centered on ``center``.
    """

    center: Sat
    rows: int
    cols: int

    def __post_init__(self) -> None:
        if self.rows < 1 or self.cols < 1:
            raise ValueError("LOS window must be at least 1x1")

    def offsets(self) -> list[tuple[int, int]]:
        """Row-major (d_slot, d_plane) offsets from the window's top-left."""
        return [(r, c) for r in range(self.rows) for c in range(self.cols)]

    def top_left(self, spec: ConstellationSpec) -> Sat:
        return spec.wrap(
            Sat(
                self.center.plane - (self.cols - 1) // 2,
                self.center.slot - (self.rows - 1) // 2,
            )
        )

    def sats(self, spec: ConstellationSpec) -> list[Sat]:
        """Row-major list (left->right, top->bottom) of satellites in LOS."""
        tl = self.top_left(spec)
        return [
            spec.wrap(Sat(tl.plane + c, tl.slot + r)) for r, c in self.offsets()
        ]

    def contains(self, spec: ConstellationSpec, sat: Sat) -> bool:
        dp, ds = spec.torus_delta(self.center, sat)
        return (
            -((self.cols - 1) // 2) <= dp <= self.cols // 2
            and -((self.rows - 1) // 2) <= ds <= self.rows // 2
        )

    def shifted(
        self, spec: ConstellationSpec, d_slot: int = 1, d_plane: int = 0
    ) -> "LosWindow":
        """The window after a rotation step.

        Satellites orbit within their plane, so relative to a ground observer
        the LOS box drifts along the *slot* (within-plane) direction; chunk
        migration is therefore parallel per orbital plane (paper §3.4, Figs
        5/8).  ``d_slot=1`` advances the window by one within-plane position.
        """
        return LosWindow(
            spec.wrap(Sat(self.center.plane + d_plane, self.center.slot + d_slot)),
            self.rows,
            self.cols,
        )
