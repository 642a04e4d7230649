"""Per-tenant SLOs, goodput accounting, and overload admission control.

(A copy of ``repro/serving/slo.py``.)

Under sustained arrivals the honest serving metric is not tokens/s but
*goodput*: tokens delivered inside their tenant's latency SLO
(TTFT + per-request ITL tail), measured over the run.  This module is
the accounting side of the streaming tier:

* ``SLO`` -- one tenant's targets: time-to-first-token and the p95 of
  the request's own inter-token gaps (a per-request tail, so one stalled
  request cannot hide inside an engine-wide distribution).
* ``SLOTracker`` -- folds completed/shed requests into per-tenant
  attainment, goodput tokens, and stream-wide ITL tail percentiles;
  ``report(elapsed_s)`` is the counter block benchmarks and the example
  print.  With ``window_s`` set it additionally buckets every arrival
  into fixed *virtual-time* windows keyed by the arrival's ``t_s`` --
  attribution by arrival time is a pure function of the seeded stream,
  so windowed goodput replays deterministically -- and with ``phases``
  (a ``FaultPhases``) each window is tagged ``pre_churn`` / ``churn`` /
  ``post_heal``, making "goodput holds within X% through churn and
  recovers after heal" a computable bar.
* ``AdmissionController`` -- the overload valve at the cluster's front
  door: when outstanding routed work exceeds ``capacity_tokens``, new
  requests *below* ``protect_priority`` are shed; protected tenants are
  always admitted and additionally ride the scheduler's
  preemption-by-offload priority inside each engine.  Deciding on
  committed-token load (not latency) keeps the shed set a pure function
  of the arrival history, so deterministic replays stay deterministic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.stats import SampleReservoir


@dataclass(frozen=True)
class SLO:
    """Latency targets for one tenant (virtual==wall seconds at the
    serving host; ``inf`` disables a bound)."""

    ttft_s: float = math.inf
    itl_p95_s: float = math.inf


def itl_tail(samples_s: list[float], q: float = 95.0) -> float:
    """The q-th percentile of one request's inter-token gaps."""
    if not samples_s:
        return 0.0
    return float(np.percentile(np.asarray(samples_s, np.float64), q))


@dataclass
class TenantCounters:
    offered: int = 0
    shed: int = 0
    completed: int = 0
    attained: int = 0
    tokens: int = 0
    attained_tokens: int = 0

    def attainment(self) -> float:
        return self.attained / max(self.completed, 1)


@dataclass(frozen=True)
class FaultPhases:
    """A fault arc's phase boundaries on the virtual timeline (both
    relative to stream start, i.e. ``FaultPlan.churn_span``): churn
    opens at the first kill and closes at the last heal.  A goodput
    window is ``pre_churn`` only when it ends before the first kill and
    ``post_heal`` only when it starts at/after the last heal; anything
    straddling a boundary is (conservatively) ``churn``."""

    churn_start_s: float
    heal_s: float = math.inf

    def tag(self, t0_s: float, t1_s: float) -> str:
        if t1_s <= self.churn_start_s:
            return "pre_churn"
        if t0_s >= self.heal_s:
            return "post_heal"
        return "churn"


class SLOTracker:
    """Stream-wide SLO bookkeeping (one instance per serve_stream)."""

    def __init__(self, slos: dict[str, SLO] | None = None, *,
                 default: SLO | None = None,
                 window_s: float | None = None,
                 phases: FaultPhases | None = None) -> None:
        if window_s is not None and window_s <= 0:
            raise ValueError(f"window_s must be > 0 (got {window_s})")
        self.slos = dict(slos or {})
        self.default = default if default is not None else SLO()
        self.per_tenant: dict[str, TenantCounters] = {}
        self.itl_all_s = SampleReservoir()
        self.window_s = window_s
        self.phases = phases
        self.windows: dict[int, TenantCounters] = {}

    def slo_for(self, tenant: str) -> SLO:
        return self.slos.get(tenant, self.default)

    def _bucket(self, tenant: str) -> TenantCounters:
        return self.per_tenant.setdefault(tenant, TenantCounters())

    def _window(self, t_s: float | None) -> TenantCounters | None:
        if self.window_s is None or t_s is None:
            return None
        return self.windows.setdefault(
            int(t_s // self.window_s), TenantCounters())

    # ------------------------------------------------------------------
    def note_offered(self, tenant: str, *, t_s: float | None = None) -> None:
        self._bucket(tenant).offered += 1
        w = self._window(t_s)
        if w is not None:
            w.offered += 1

    def note_shed(self, tenant: str, *, t_s: float | None = None) -> None:
        self._bucket(tenant).shed += 1
        w = self._window(t_s)
        if w is not None:
            w.shed += 1

    def observe(self, tenant: str, *, ttft_s: float,
                itl_samples_s: list[float], new_tokens: int,
                t_s: float | None = None) -> bool:
        """Fold one completed request; returns whether it attained its
        tenant's SLO (TTFT within target AND the request's own ITL p95
        within target).  ``t_s`` (the request's *arrival* virtual time)
        additionally credits the request to its goodput window."""
        slo = self.slo_for(tenant)
        ok = (ttft_s <= slo.ttft_s
              and itl_tail(itl_samples_s) <= slo.itl_p95_s)
        for b in filter(None, (self._bucket(tenant), self._window(t_s))):
            b.completed += 1
            b.tokens += new_tokens
            if ok:
                b.attained += 1
                b.attained_tokens += new_tokens
        self.itl_all_s.extend(itl_samples_s)
        return ok

    # ------------------------------------------------------------------
    def timeline(self) -> list[dict]:
        """The windowed goodput timeline: one row per fixed virtual-time
        window from 0 through the last populated one (gaps materialize
        as empty windows -- a silent traffic hole should READ as zero
        goodput, not vanish), tagged with its fault phase.  Goodput here
        is attained tokens per *virtual* window second; ratios between
        windows are unit-free."""
        if self.window_s is None or not self.windows:
            return []
        out = []
        for i in range(max(self.windows) + 1):
            w = self.windows.get(i, TenantCounters())
            t0 = i * self.window_s
            t1 = t0 + self.window_s
            out.append({
                "t0_s": t0,
                "t1_s": t1,
                "phase": (self.phases.tag(t0, t1)
                          if self.phases is not None else "steady"),
                "offered": w.offered,
                "shed": w.shed,
                "completed": w.completed,
                "attained": w.attained,
                "tokens": w.tokens,
                "attained_tokens": w.attained_tokens,
                "goodput_tokens_per_s": w.attained_tokens / self.window_s,
            })
        return out

    def phase_report(self) -> dict:
        """Per-phase aggregates over the timeline -- the numbers the
        "goodput holds through churn / recovers after heal" bars divide:
        each phase's windows folded, plus its goodput per virtual
        second of phase duration."""
        phases: dict[str, dict] = {}
        for row in self.timeline():
            agg = phases.setdefault(row["phase"], {
                "windows": 0, "duration_s": 0.0, "offered": 0, "shed": 0,
                "completed": 0, "attained": 0, "tokens": 0,
                "attained_tokens": 0,
            })
            agg["windows"] += 1
            agg["duration_s"] += row["t1_s"] - row["t0_s"]
            for k in ("offered", "shed", "completed", "attained",
                      "tokens", "attained_tokens"):
                agg[k] += row[k]
        for agg in phases.values():
            agg["goodput_tokens_per_s"] = (
                agg["attained_tokens"] / max(agg["duration_s"], 1e-9))
        return phases

    def report(self, elapsed_s: float) -> dict:
        """The goodput/attainment counter block."""
        total = TenantCounters()
        for b in self.per_tenant.values():
            total.offered += b.offered
            total.shed += b.shed
            total.completed += b.completed
            total.attained += b.attained
            total.tokens += b.tokens
            total.attained_tokens += b.attained_tokens
        xs = np.asarray(self.itl_all_s or [0.0], np.float64)
        windowed = ({"windows": self.timeline(),
                     "phases": self.phase_report()}
                    if self.window_s is not None else {})
        return {
            **windowed,
            "elapsed_s": elapsed_s,
            "offered": total.offered,
            "shed": total.shed,
            "completed": total.completed,
            "attained": total.attained,
            "attainment": total.attainment(),
            "tokens": total.tokens,
            "tokens_per_s": total.tokens / max(elapsed_s, 1e-9),
            "goodput_tokens_per_s":
                total.attained_tokens / max(elapsed_s, 1e-9),
            "itl_tail_s": {
                "p95": float(np.percentile(xs, 95)),
                "p99": float(np.percentile(xs, 99)),
                "max": float(xs.max()),
            },
            "per_tenant": {
                name: {
                    "offered": b.offered,
                    "shed": b.shed,
                    "completed": b.completed,
                    "attained": b.attained,
                    "attainment": b.attainment(),
                    "tokens": b.tokens,
                    "attained_tokens": b.attained_tokens,
                }
                for name, b in sorted(self.per_tenant.items())
            },
        }


@dataclass
class AdmissionController:
    """Load-threshold shedding at the streaming front door.

    ``admit`` is a pure function of the router's outstanding committed
    tokens: below ``capacity_tokens`` everyone enters; above it only
    priorities >= ``protect_priority`` do (they are never shed -- inside
    the engines the scheduler's priority preemption then defers the
    admitted low-priority work too).  ``shed_count`` is the controller's
    own tally, independent of any tracker."""

    capacity_tokens: int
    protect_priority: int = 1
    shed_count: int = field(default=0, init=False)

    def admit(self, priority: int, load_tokens: int) -> bool:
        if priority >= self.protect_priority:
            return True
        if load_tokens < self.capacity_tokens:
            return True
        self.shed_count += 1
        return False
