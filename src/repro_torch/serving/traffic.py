"""Seeded open-ended traffic: the arrival processes that drive streaming.

(A copy of ``repro/serving/traffic.py``.)

A production cluster never sees a closed batch; it sees *processes* --
steady Poisson request streams, diurnal load swings, and bursty tenants
whose requests arrive in correlated clumps with shared document
prefixes (the paper's repeated-context workload, CELESTIAL's continuous
operation).  This module generates those streams deterministically from
a seed:

* ``TenantSpec`` describes one tenant: its arrival process (``poisson``
  / ``diurnal`` / ``bursty``), rate, prompt-length distribution,
  prefix-reuse probability over a per-tenant document pool, decode
  length, and scheduling priority (the SLO tier).
* ``TrafficGenerator`` merges every tenant's stream into one
  time-ordered iterator of ``Arrival(t_s, tenant, Request)`` -- open
  ended (generate as much as you consume), with ``take(n)`` /
  ``until(t_end)`` for bounded slices.

Times are *virtual* seconds on the fabric clock; the cluster's
streaming front door paces wall time by the clock rate.  Every draw --
inter-arrival gaps, burst sizes, prompt lengths, document choices --
comes from per-tenant ``random.Random`` instances seeded from strings
(CPython hashes string seeds with sha512, independent of
``PYTHONHASHSEED``), so the same seed yields the same
``(arrival_time, tenant, prompt)`` stream in any process.
"""
from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass
from typing import Iterator, Sequence

from repro_torch.serving.request import Request
from repro_torch.serving.sampler import SamplingParams


@dataclass(frozen=True)
class Arrival:
    """One request's arrival on the stream (virtual seconds)."""

    t_s: float
    tenant: str
    request: Request


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic model (all times in virtual seconds)."""

    name: str
    rate_rps: float                   # mean arrivals per second
    process: str = "poisson"          # "poisson" | "diurnal" | "bursty"
    # bursty: bursts arrive as Poisson at rate/burst_size, each carrying
    # a geometric number of requests (mean burst_size) spaced ~spread
    burst_size: int = 4
    burst_spread_s: float = 0.02
    # diurnal: lam(t) = rate * (1 + amplitude * sin(2*pi*t/period)),
    # realized by thinning a homogeneous process at the peak rate
    diurnal_period_s: float = 60.0
    diurnal_amplitude: float = 0.8
    # prompts: uniform char-length range (the byte tokenizer maps chars
    # ~1:1 to tokens); with probability prefix_reuse_p the prompt opens
    # with one of the tenant's shared documents (cache-friendly prefix)
    prompt_chars: tuple[int, int] = (48, 160)
    prefix_reuse_p: float = 0.0
    num_documents: int = 4
    doc_chars: int = 96
    max_new_tokens: int = 16
    priority: int = 0                 # Request.priority (SLO tier)

    def __post_init__(self) -> None:
        # fail loudly at construction, not corruptly at draw time:
        if not self.rate_rps > 0.0:
            raise ValueError(
                f"TenantSpec {self.name!r}: rate_rps must be > 0 (got "
                f"{self.rate_rps}); a zero/negative rate would raise "
                "from inside expovariate on the first draw")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError(
                f"TenantSpec {self.name!r}: diurnal_amplitude must be "
                f"in [0, 1] (got {self.diurnal_amplitude}); beyond 1 "
                "the instantaneous rate goes negative and the thinning "
                "loop silently drops that phase of the day -- a hidden "
                "traffic hole, not more swing")


_WORDS = (
    "sky", "memory", "orbit", "cache", "relay", "prefix", "block",
    "token", "fabric", "anchor", "plane", "hop", "window", "chunk",
    "decode", "rotate", "ground", "stripe", "swarm", "laser",
)


def _filler(rng: random.Random, n_chars: int) -> str:
    """Deterministic pseudo-text of roughly ``n_chars`` characters."""
    parts: list[str] = []
    total = 0
    while total < n_chars:
        w = _WORDS[rng.randrange(len(_WORDS))]
        parts.append(w)
        total += len(w) + 1
    return " ".join(parts)[:n_chars]


def poisson_times(rate_rps: float, rng: random.Random) -> Iterator[float]:
    """Homogeneous Poisson arrival times (exponential gaps), open-ended."""
    t = 0.0
    while True:
        t += rng.expovariate(rate_rps)
        yield t


def diurnal_times(rate_rps: float, amplitude: float, period_s: float,
                  rng: random.Random) -> Iterator[float]:
    """Nonhomogeneous Poisson with a sinusoidal day/night swing, via
    thinning at the peak rate."""
    lam_max = rate_rps * (1.0 + amplitude)
    t = 0.0
    while True:
        t += rng.expovariate(lam_max)
        lam = rate_rps * (1.0 + amplitude
                          * math.sin(2.0 * math.pi * t / period_s))
        if rng.random() * lam_max <= lam:
            yield t


def bursty_times(rate_rps: float, burst_size: int, spread_s: float,
                 rng: random.Random) -> Iterator[float]:
    """Correlated clumps: burst starts are Poisson at rate/burst_size,
    each burst carries a geometric number of requests (mean burst_size)
    spaced by small exponential gaps.  Mean rate stays ``rate_rps``."""
    burst_size = max(1, burst_size)
    t = 0.0
    last = 0.0
    while True:
        t = max(t + rng.expovariate(rate_rps / burst_size), last)
        n = 1
        while n < 4 * burst_size and rng.random() > 1.0 / burst_size:
            n += 1
        tb = t
        for _ in range(n):
            yield tb
            last = tb
            tb += rng.expovariate(1.0 / spread_s)


@dataclass
class TrafficGenerator:
    """Merge every tenant's seeded stream into one time-ordered arrival
    iterator.  Deterministic: the same ``(tenants, seed)`` produces the
    same ``(t_s, tenant, prompt, priority, max_new_tokens)`` stream."""

    tenants: Sequence[TenantSpec]
    seed: int = 0

    def arrivals(self) -> Iterator[Arrival]:
        streams = [self._tenant_stream(spec) for spec in self.tenants]
        return heapq.merge(*streams, key=lambda a: (a.t_s, a.tenant))

    def take(self, n: int) -> list[Arrival]:
        out = []
        for arr in self.arrivals():
            out.append(arr)
            if len(out) >= n:
                break
        return out

    def until(self, t_end_s: float) -> list[Arrival]:
        out = []
        for arr in self.arrivals():
            if arr.t_s > t_end_s:
                break
            out.append(arr)
        return out

    # ------------------------------------------------------------------
    def _tenant_stream(self, spec: TenantSpec) -> Iterator[Arrival]:
        # independent rngs for times and prompt content, so changing one
        # distribution never perturbs the other's draws
        t_rng = random.Random(f"{self.seed}/{spec.name}/times")
        p_rng = random.Random(f"{self.seed}/{spec.name}/prompts")
        doc_rng = random.Random(f"{self.seed}/{spec.name}/docs")
        docs = [f"<{spec.name}/doc{j}> " + _filler(doc_rng, spec.doc_chars)
                for j in range(max(1, spec.num_documents))]
        if spec.process == "poisson":
            times = poisson_times(spec.rate_rps, t_rng)
        elif spec.process == "diurnal":
            times = diurnal_times(spec.rate_rps, spec.diurnal_amplitude,
                                  spec.diurnal_period_s, t_rng)
        elif spec.process == "bursty":
            times = bursty_times(spec.rate_rps, spec.burst_size,
                                 spec.burst_spread_s, t_rng)
        else:
            raise ValueError(f"unknown arrival process: {spec.process!r}")
        lo, hi = spec.prompt_chars
        for serial, t in enumerate(times):
            if spec.prefix_reuse_p and p_rng.random() < spec.prefix_reuse_p:
                doc = docs[p_rng.randrange(len(docs))]
                prompt = f"{doc} q{serial}: " + _filler(
                    p_rng, max(8, lo // 4))
            else:
                prompt = f"[{spec.name}#{serial}] " + _filler(
                    p_rng, p_rng.randint(lo, hi))
            req = Request(
                prompt=prompt,
                sampling=SamplingParams(max_new_tokens=spec.max_new_tokens),
                priority=spec.priority,
                tenant=spec.name,
            )
            yield Arrival(t_s=t, tenant=spec.name, request=req)


def standard_tenants(n: int, total_rate_rps: float, *,
                     max_new_tokens: int = 16,
                     prompt_chars: tuple[int, int] = (48, 160),
                     prefix_reuse_p: float = 0.5) -> list[TenantSpec]:
    """A ready-made multi-tenant mix for examples and benchmarks:
    tenant 0 is the high-priority ``pro`` tier (steady Poisson), the
    rest alternate bursty document-reuse tenants and diurnal
    free-tier traffic, splitting ``total_rate_rps`` evenly."""
    n = max(1, n)
    rate = total_rate_rps / n
    specs = [TenantSpec(
        name="pro", rate_rps=rate, process="poisson", priority=1,
        prompt_chars=prompt_chars, max_new_tokens=max_new_tokens)]
    for i in range(1, n):
        if i % 2:
            specs.append(TenantSpec(
                name=f"burst{i}", rate_rps=rate, process="bursty",
                burst_size=3, prefix_reuse_p=prefix_reuse_p,
                prompt_chars=prompt_chars,
                max_new_tokens=max_new_tokens))
        else:
            specs.append(TenantSpec(
                name=f"diurnal{i}", rate_rps=rate, process="diurnal",
                diurnal_period_s=30.0, prompt_chars=prompt_chars,
                max_new_tokens=max_new_tokens))
    return specs
