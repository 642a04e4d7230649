"""Engine-level counters and latency percentiles.

One ``EngineStats`` object is shared by the facade, the scheduler, and
the executor-side runtimes; benchmarks reset it between timed runs by
assigning a fresh instance to ``Engine.stats``.  A scale-out cluster
keeps one instance per replica and folds them with ``EngineStats.merge``
/ ``EngineStats.merged`` -- counters add and the raw TTFT/ITL sample
lists concatenate, so ``latency_percentiles`` on the merged object are
true cluster-level percentiles, not averages of per-replica percentiles.

The TTFT/ITL sample fields are ``SampleReservoir`` lists: open-ended
streaming serves decode without a natural end, so unbounded per-token
sample lists would grow without limit.  Below the cap the reservoir IS
the full sample list (closed-batch runs and their percentile tests see
exact data); past it, uniform reservoir sampling keeps the percentiles
honest at O(1) memory -- the same scheme ``TransportStats`` uses for
transport op latencies.

(A copy of ``repro/serving/stats.py``.)
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np


def _percentiles(xs: list[float]) -> dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    p50, p95, p99 = np.percentile(np.asarray(xs, np.float64), [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99)}


class SampleReservoir(list):
    """A ``list`` whose growth is bounded by uniform reservoir sampling.

    Drop-in for the plain sample lists ``EngineStats`` carried before
    streaming: equality, ``len``, indexing, and iteration behave like a
    list, and every sample lands in arrival order until ``cap`` -- so
    short (closed-batch) runs see exactly the data they always did.
    Past ``cap``, each new sample replaces a uniformly random slot with
    probability ``cap / n_seen`` (seeded, like ``TransportStats``), so
    percentiles over an open-ended stream stay unbiased at fixed memory.
    """

    __slots__ = ("cap", "n_seen", "_rng")

    def __init__(self, iterable: Iterable[float] = (), *,
                 cap: int = 8192, seed: int = 0x5EED) -> None:
        super().__init__()
        self.cap = cap
        self.n_seen = 0
        self._rng = random.Random(seed)
        self.extend(iterable)

    def append(self, x: float) -> None:
        self.n_seen += 1
        if len(self) < self.cap:
            super().append(x)
        else:
            j = self._rng.randrange(self.n_seen)
            if j < self.cap:
                self[j] = x

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.append(x)


@dataclass
class EngineStats:
    requests: int = 0
    cached_tokens: int = 0
    prefilled_tokens: int = 0
    decoded_tokens: int = 0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    decode_steps: int = 0             # jitted step programs launched
    mid_decode_admissions: int = 0    # requests admitted into a live batch
    prefill_chunks: int = 0           # chunk programs fused into steps
    # tiered-KV swap activity (preemption-by-offload):
    preemptions: int = 0              # sequences offloaded out of the pool
    restores: int = 0                 # preempted sequences brought back
    offloaded_pages: int = 0          # pool pages exported to the host tier
    spilled_blocks: int = 0           # host-tier blocks spilled to L2
    replayed_tokens: int = 0          # tail tokens recomputed at restore
    # experienced constellation latency (clocked fabrics only): an L2 Get
    # completes at a virtual time; chunks are deferred to overlap the
    # flight with decode steps, and whatever cannot be hidden is waited
    # out -- the nonzero cost that makes the orbital tier real
    l2_wait_s: float = 0.0            # virtual seconds blocked on fetches
    l2_fetch_waits: int = 0           # fetches with un-hidden flight time
    l2_deferred_chunks: int = 0       # chunk slots spent overlapping flights
    # fault tolerance (k-replica constellation under churn): degraded
    # reads served this replica after falling through dead replicas;
    # lost_blocks counts L2 lookups/restores where the index pointed at
    # blocks the constellation could no longer serve (the prefix --
    # or part of it -- was recomputed instead of crashing)
    degraded_reads: int = 0
    lost_blocks: int = 0
    # graceful degradation (graded link faults + the L3 ground tier):
    # chunk ops this replica's L2 calls completed over rerouted paths,
    # and lookups/restores the ground tier answered after every orbital
    # replica fell through -- the reads that would have been lost_blocks
    # (recompute) without a durable tier below the constellation
    detoured_ops: int = 0
    ground_hits: int = 0
    # decentralized directory (striped replicated metadata): lookups
    # this replica's L2 calls resolved only after probing >=1 dead
    # directory-stripe home, and promised prefixes the fabric degraded
    # to a shorter served prefix (a later chunk gone from every replica)
    degraded_lookups: int = 0
    shortened_prefixes: int = 0
    # payload codec: wall-clock seconds the quantized-payload dequantize
    # leg spent on the fetch-ahead worker -- decompression that ran
    # overlapped with live decode steps instead of on the serving loop
    dequant_overlap_s: float = 0.0
    ttft_s: list[float] = field(default_factory=SampleReservoir)
    # per decoded token:
    itl_s: list[float] = field(default_factory=SampleReservoir)
    # the subset of itl_s observed by running sequences while an
    # admission was in flight -- the tail the chunked scheduler exists
    # to flatten (a whole-run p99 dilutes a few admission stalls away)
    itl_admission_s: list[float] = field(default_factory=SampleReservoir)

    def __post_init__(self) -> None:
        # callers (and tests) may pass plain lists; rebind them as
        # reservoirs so an open-ended stream cannot grow them unbounded
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, list) and not isinstance(v, SampleReservoir):
                setattr(self, f.name, SampleReservoir(v))

    def latency_percentiles(self) -> dict[str, dict[str, float]]:
        """p50/p95/p99 of time-to-first-token and inter-token latency --
        the serving SLO view of the run (tokens/s hides admission
        stalls; the ITL tail is where stop-the-world prefill shows)."""
        return {"ttft_s": _percentiles(self.ttft_s),
                "itl_s": _percentiles(self.itl_s),
                "itl_admission_s": _percentiles(self.itl_admission_s)}

    # ------------------------------------------------------------------
    def merge(self, other: "EngineStats") -> "EngineStats":
        """Fold ``other`` into this object (cluster aggregation): numeric
        counters add, sample lists concatenate.  Returns self."""
        for f in dataclasses.fields(self):
            mine, theirs = getattr(self, f.name), getattr(other, f.name)
            if isinstance(mine, list):
                mine.extend(theirs)
            else:
                setattr(self, f.name, mine + theirs)
        return self

    @classmethod
    def merged(cls, parts: Iterable["EngineStats"]) -> "EngineStats":
        """Cluster-level stats from per-replica parts (parts unchanged)."""
        out = cls()
        for p in parts:
            out.merge(p)
        return out
