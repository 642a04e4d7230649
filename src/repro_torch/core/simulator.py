"""Worst-case chunk-fetch latency simulator (paper §4, Figs 1, 2, 16).

The port's own copy of ``repro/core/simulator.py``: numpy only, the
same arithmetic in the same order, so every result is bitwise the
reference's.

The paper's simulator computes, per placement strategy, the worst-case
latency over all chunk servers -- propagation to the farthest chunk (Eqs
1-4) plus per-chunk processing.  Our cost model (documented here because
Fig 16's exact model is not fully specified in the text):

* per-server latency  ``L_i = prop_i + chunks_i * proc_time``
* block latency       ``L   = max_i L_i``   (all servers queried in parallel)

Propagation per strategy (matching each strategy's §3.5-3.7 use case):

* ROTATION      -- ground-hosted LLM with direct links to *all* LOS
  satellites; servers fill the full LOS window row-major; ``prop_i`` is the
  slant range (Eq 4) to satellite *i*.  Migration re-anchors the mapping, so
  there is no rotation drift.
* HOP           -- single uplink to the (initial) center satellite plus ISL
  ring routing.  No migration, so as the constellation rotates the rings
  drift away from the uplink point: we average the worst case over a full
  within-plane rotation period.
* ROTATION_HOP  -- single uplink to the current center plus ISL routing
  inside the ceil(sqrt(S)) bounding box; per-step migration keeps the rings
  anchored (drift-free).

Reproduced claims: rotation+hop is lowest across altitudes; ~8-9x more
servers cut latency ~90% (the processing term scales 1/S); latency grows
with altitude; one intra-plane ISL hop lands between SSD and HDD latency
for ~50+ satellites per plane.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.constellation import (
    ConstellationSpec,
    LosWindow,
    Sat,
    one_hop_intra_plane_latency_s,
)
from repro_torch.core.mapping import Strategy, place_servers
from repro_torch.core.chunking import num_chunks as _num_chunks

# Paper Table 1 (approximate latency per memory type, seconds).
MEMORY_HIERARCHY_S: dict[str, tuple[float, float]] = {
    "CPU": (10e-9, 15e-9),
    "GPU": (50e-9, 100e-9),
    "RDMA": (2e-6, 5e-6),
    "SSD": (20e-6, 200e-6),
    "HDD": (2e-3, 20e-3),
    "NAS": (30e-3, 40e-3),
    "LEO (current RF)": (20e-3, 50e-3),
    "LEO (theoretical Laser)": (2e-3, 4e-3),
}


@dataclass(frozen=True)
class SimConfig:
    """Paper Table 2 defaults."""

    kvc_bytes: int = 221 * 1024 * 1024
    chunk_bytes: int = 6 * 1024
    num_servers: int = 81          # paper sweeps 9..81
    chunk_processing_time_s: float = 0.002  # paper sweeps 0.002..0.02
    altitude_km: float = 550.0     # paper sweeps 160..2000
    max_satellites: int = 15       # window rows  (within-plane)
    max_orbs: int = 15             # window cols  (planes)
    center_satellite: int = 8      # 1-based, paper Table 2
    center_orb: int = 8
    num_planes: int = 15
    sats_per_plane: int = 15


@dataclass(frozen=True)
class SimResult:
    strategy: str
    num_servers: int
    altitude_km: float
    worst_latency_s: float
    worst_propagation_s: float
    worst_processing_s: float
    chunks_total: int


def _spec(cfg: SimConfig) -> ConstellationSpec:
    return ConstellationSpec(
        num_planes=cfg.num_planes,
        sats_per_plane=cfg.sats_per_plane,
        altitude_km=cfg.altitude_km,
    )


def _window(cfg: SimConfig) -> LosWindow:
    center = Sat(cfg.center_orb - 1, cfg.center_satellite - 1)
    return LosWindow(center, cfg.max_satellites, cfg.max_orbs)


def _chunks_per_server(cfg: SimConfig) -> list[int]:
    total = _num_chunks(cfg.kvc_bytes, cfg.chunk_bytes)
    base, rem = divmod(total, cfg.num_servers)
    return [base + (1 if i < rem else 0) for i in range(cfg.num_servers)]


def worst_case_latency(strategy: Strategy, cfg: SimConfig) -> SimResult:
    spec = _spec(cfg)
    window = _window(cfg)
    center = window.center
    chunks = _chunks_per_server(cfg)
    total = sum(chunks)
    uplink_s = spec.uplink_latency_s()

    if strategy is Strategy.ROTATION:
        sats = place_servers(strategy, spec, window, cfg.num_servers)
        props = [spec.ground_latency_s(s, center) for s in sats]
        per = [p + c * cfg.chunk_processing_time_s for p, c in zip(props, chunks)]
        i = max(range(len(per)), key=per.__getitem__)
        return SimResult(
            strategy.value, cfg.num_servers, cfg.altitude_km,
            per[i], props[i], chunks[i] * cfg.chunk_processing_time_s, total,
        )

    sats = place_servers(strategy, spec, window, cfg.num_servers)
    offsets = [spec.torus_delta(center, s) for s in sats]
    # per-hop latencies from the spec -- the single ISL cost source shared
    # with IslTransport / ConstellationSpec.path_latency_s
    lat_m = spec.intra_plane_latency_s()
    lat_n = spec.inter_plane_latency_s()

    if strategy is Strategy.ROTATION_HOP:
        phases = [0]  # per-step migration keeps rings anchored
    else:  # HOP: no migration -> drift over a full within-plane period
        phases = list(range(cfg.sats_per_plane))

    # Vectorized phase sweep (the O(phases x servers) hot loop); argmax's
    # first-max tie-breaking matches the original strict `>` scan.
    dp = np.abs(np.array([o[0] for o in offsets], dtype=np.int64))
    ds = np.array([o[1] for o in offsets], dtype=np.int64)
    proc = np.array(chunks, dtype=np.int64) * cfg.chunk_processing_time_s
    phase_arr = np.array(phases, dtype=np.int64)
    path_s = (dp[None, :] * lat_n
              + np.abs(ds[None, :] - phase_arr[:, None]) * lat_m)
    prop_all = uplink_s + path_s                            # [phases, servers]
    tot_all = prop_all + proc[None, :]
    best = np.argmax(tot_all, axis=1)                       # [phases]
    rows = np.arange(len(phases))
    per_phase_tot = tot_all[rows, best]
    per_phase_prop = prop_all[rows, best]
    per_phase_proc = proc[best]

    worst_total = worst_prop = worst_proc = 0.0
    acc = 0.0
    for i in range(len(phases)):
        acc += float(per_phase_tot[i])   # sequential sum: seed float order
        if per_phase_tot[i] > worst_total:
            worst_total = float(per_phase_tot[i])
            worst_prop = float(per_phase_prop[i])
            worst_proc = float(per_phase_proc[i])
    mean_total = acc / len(phases)
    return SimResult(
        strategy.value, cfg.num_servers, cfg.altitude_km,
        mean_total, worst_prop, worst_proc, total,
    )


def sweep(
    *,
    strategies: tuple[Strategy, ...] = (
        Strategy.ROTATION,
        Strategy.HOP,
        Strategy.ROTATION_HOP,
    ),
    servers: tuple[int, ...] = (9, 25, 49, 81),
    altitudes_km: tuple[float, ...] = (160.0, 550.0, 1000.0, 2000.0),
    base: SimConfig = SimConfig(),
) -> list[SimResult]:
    """The paper's Fig-16 sweep: strategy x #servers x altitude."""
    out: list[SimResult] = []
    for strat in strategies:
        for s in servers:
            for h in altitudes_km:
                cfg = dataclasses.replace(base, num_servers=s, altitude_km=h)
                out.append(worst_case_latency(strat, cfg))
    return out


# ---------------------------------------------------------------------------
# Figs 1-2: intra-plane one-hop ISL latency vs (M, h).
# ---------------------------------------------------------------------------

def intra_plane_latency_s(sats_per_plane: int, altitude_km: float) -> float:
    """One-hop intra-plane latency at an (M, h) point -- delegates to the
    cached single-source helper in ``core.constellation``."""
    return one_hop_intra_plane_latency_s(sats_per_plane, altitude_km)


def isl_latency_grid(
    ms: tuple[int, ...] = (10, 20, 30, 40, 50, 70, 100),
    altitudes_km: tuple[float, ...] = (160, 550, 1000, 1500, 2000),
) -> list[tuple[int, float, float]]:
    return [
        (m, h, intra_plane_latency_s(m, h)) for m in ms for h in altitudes_km
    ]


def memory_tier_for_latency(latency_s: float) -> str:
    """Classify a latency into the paper's Table-1 hierarchy."""
    for name, (lo, hi) in MEMORY_HIERARCHY_S.items():
        if lo <= latency_s <= hi:
            return name
    # Between tiers: report the pair it falls between.
    tiers = sorted(MEMORY_HIERARCHY_S.items(), key=lambda kv: kv[1][0])
    prev = tiers[0][0]
    for name, (lo, _) in tiers:
        if latency_s < lo:
            return f"between {prev} and {name}"
        prev = name
    return prev


def required_sats_per_plane_for(latency_s: float, altitude_km: float) -> int:
    """Smallest M whose one-hop intra-plane latency is below ``latency_s``."""
    for m in range(2, 10_000):
        if intra_plane_latency_s(m, altitude_km) <= latency_s:
            return m
    raise ValueError("unreachable latency")
