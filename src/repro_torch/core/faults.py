"""Constellation fault model: satellite churn and ISL outages.

The port's own copy of ``repro/core/faults.py``, whole: plain Python,
importing no ``torch``.

The paper's protocol assumes a cooperative constellation -- every chunk
lives exactly where placement put it and every ISL leg is up.  A
production LEO cache lives with churn: satellites reboot or die, optical
links drop, and the cache must keep serving (degraded) and re-replicate
(repair) without a request ever failing.  This module is the fault
*source*; the degraded-read / repair behavior lives in
``core.protocol.ConstellationKVC``.

Three pieces:

* ``FaultState`` -- the live fault view the data plane consults on every
  chunk op: which satellites are dead, which ISL links are down, and how
  a route from ``src`` to ``dst`` runs *around* them.  A killed ISL no
  longer fails ops whose greedy route crosses it: ``route_hops`` finds
  the cheapest detour on the torus and the op pays the extra hops --
  link outages grade latency instead of failing, and only a genuinely
  partitioned endpoint is unreachable.  Mutation is copy-on-write over
  frozensets so serving threads read without taking a lock.
* ``FaultPlan`` -- a deterministic schedule of kill/heal events with
  times *relative to arming*, on the fabric's virtual clock
  (``core.protocol.SimClock``).  ``seeded_churn`` builds a reproducible
  random outage schedule: the same seed always yields the same kills at
  the same virtual times.
* ``FaultInjector`` -- binds a plan to a ``ConstellationKVC``: ``arm()``
  anchors the plan at the current clock reading, and ``advance()``
  (called by the store at the top of every chunk op, so no extra thread
  is needed) applies every event whose time has passed.  Killing a
  satellite drops its chunk store AND its directory-stripe shard -- data
  and metadata are both fabric state and both die with their host.
  Degraded reads fall through to surviving chunk replicas, degraded
  *lookups* fall through to surviving directory-stripe replicas, and
  ``reconcile()`` rebuilds both from what survives (chunk re-replication
  plus inventory-driven metadata reconstruction).

Two drive modes: on the *clock* (above -- realtime serving), or *held*
(``hold()`` / ``manual=True``): the chunk-op tick becomes a no-op and
only an explicit ``advance_to(rel_s)`` applies events.  Held mode is how
``EngineCluster.serve_stream``'s deterministic pump-budget interleave
replays a chaos arc byte-identically: the fabric clock is wall-anchored
(nondeterministic), so the serve loop drives the injector on virtual
*arrival-time* crossings instead -- exactly like rotation --
interleaving fault events and rotations in virtual-time order.
"""
from __future__ import annotations

import heapq
import math
import random
import threading
from dataclasses import dataclass, field

from repro_torch.core.constellation import ConstellationSpec, Sat

Link = frozenset  # {Sat, Sat} -- ISL links are undirected


def link_key(a: Sat, b: Sat) -> frozenset:
    return frozenset((a, b))


class FaultState:
    """Current dead satellites / ISL links, readable without a lock.

    The sets are replaced wholesale on every mutation (copy-on-write),
    so a serving thread's membership check sees either the old or the
    new frozenset, never a half-updated one.  ``route_hops`` prices the
    route an op actually runs: the greedy +GRID path while it is clean,
    the cheapest detour around killed links otherwise -- so "the link on
    my route is down" grades the op's latency instead of failing it,
    and a per-state route cache keeps the search off the hot path.
    """

    def __init__(self) -> None:
        self.dead_sats: frozenset = frozenset()
        self.dead_links: frozenset = frozenset()
        self._route_cache: dict = {}

    @property
    def clean(self) -> bool:
        return not self.dead_sats and not self.dead_links

    # -- mutation (copy-on-write; callers serialize via the injector) ---
    def kill_sat(self, sat: Sat) -> None:
        self.dead_sats = self.dead_sats | {sat}
        self._route_cache = {}

    def heal_sat(self, sat: Sat) -> None:
        self.dead_sats = self.dead_sats - {sat}
        self._route_cache = {}

    def kill_link(self, a: Sat, b: Sat) -> None:
        self.dead_links = self.dead_links | {link_key(a, b)}
        self._route_cache = {}

    def heal_link(self, a: Sat, b: Sat) -> None:
        self.dead_links = self.dead_links - {link_key(a, b)}
        self._route_cache = {}

    # -- queries --------------------------------------------------------
    def sat_alive(self, sat: Sat) -> bool:
        return sat not in self.dead_sats

    def link_alive(self, a: Sat, b: Sat) -> bool:
        return link_key(a, b) not in self.dead_links

    def route_hops(
        self,
        spec: ConstellationSpec,
        src: Sat,
        dst: Sat,
        *,
        max_extra_hops: int | None = None,
    ) -> tuple[int, int] | None:
        """Hop composition ``(intra_plane, inter_plane)`` of the cheapest
        live route from ``src`` to ``dst`` under the current link faults.

        While no killed link sits on the greedy +GRID route this is just
        the Manhattan hop split the clean transport model prices.  When
        the greedy route crosses a dead link, a bounded uniform-cost
        search over the torus (edge weights = the spec's one-hop intra-/
        inter-plane latencies) finds the cheapest detour: the op still
        completes, at ``+extra_hops`` cost.  Returns ``None`` only when
        ``dst`` is partitioned from ``src`` -- every live path is cut (or
        longer than ``max_extra_hops`` beyond the Manhattan distance,
        when a bound is given).  Dead *satellites* do not block transit
        here: a dead node's links still carry detoured traffic in this
        model unless explicitly killed; endpoint death is ``reachable``'s
        concern (the data is gone, not the path).
        """
        src, dst = spec.wrap(src), spec.wrap(dst)
        dp, ds = spec.torus_delta(src, dst)
        base = (abs(ds), abs(dp))
        if not self.dead_links or src == dst:
            return base
        key = (src, dst, max_extra_hops)
        cache = self._route_cache
        if key in cache:
            return cache[key]
        path = spec.greedy_route(src, dst)
        if all(link_key(a, b) not in self.dead_links
               for a, b in zip(path, path[1:])):
            cache[key] = base
            return base
        li = spec.intra_plane_latency_s()
        le = spec.inter_plane_latency_s()
        budget = (None if max_extra_hops is None
                  else base[0] + base[1] + max_extra_hops)
        # uniform-cost search (Dijkstra) over the torus, skipping dead
        # links; the torus itself bounds the frontier at N*M nodes
        best_lat: dict[Sat, float] = {src: 0.0}
        frontier = [(0.0, 0, 0, src)]   # (latency, intra, inter, sat)
        found: tuple[int, int] | None = None
        while frontier:
            lat, ni, ne, cur = heapq.heappop(frontier)
            if cur == dst:
                found = (ni, ne)
                break
            if lat > best_lat.get(cur, math.inf):
                continue   # stale queue entry
            if budget is not None and ni + ne >= budget:
                continue
            for dpl, dsl, w, intra in (
                    (0, 1, li, 1), (0, -1, li, 1),
                    (1, 0, le, 0), (-1, 0, le, 0)):
                nxt = spec.wrap(Sat(cur.plane + dpl, cur.slot + dsl))
                if link_key(cur, nxt) in self.dead_links:
                    continue
                nlat = lat + w
                if nlat < best_lat.get(nxt, math.inf):
                    best_lat[nxt] = nlat
                    heapq.heappush(
                        frontier,
                        (nlat, ni + intra, ne + (1 - intra), nxt))
        cache[key] = found
        return found

    def extra_hops(self, spec: ConstellationSpec, src: Sat, dst: Sat) -> int:
        """Detour length beyond the clean Manhattan distance (0 when the
        greedy route is clean or the endpoint is partitioned)."""
        rh = self.route_hops(spec, src, dst)
        if rh is None:
            return 0
        return rh[0] + rh[1] - spec.hops(src, dst)

    def routed_latency_s(
        self, spec: ConstellationSpec, src: Sat, dst: Sat
    ) -> float | None:
        """One-way ISL latency of the cheapest live route (detours
        included), or ``None`` when ``dst`` is partitioned from ``src``.
        This is what ``IslTransport`` prices under link faults, so the
        estimate a router sees and the latency a fetch experiences are
        the same detoured path."""
        rh = self.route_hops(spec, src, dst)
        if rh is None:
            return None
        return (rh[0] * spec.intra_plane_latency_s()
                + rh[1] * spec.inter_plane_latency_s())

    def reachable(self, spec: ConstellationSpec, src: Sat, dst: Sat) -> bool:
        """Can a chunk op from ``src`` reach ``dst`` right now?

        The target must be alive and some live route must exist.  Killed
        ISL links no longer fail ops whose greedy route crosses them:
        ``route_hops`` detours around them at extra-hop cost, so a link
        outage only makes ``dst`` unreachable when it *partitions* the
        endpoint -- every path cut.  A dead satellite still blocks as an
        endpoint (its data is gone; that is what degraded reads fall
        through) but not as transit.  ``src`` itself is exempt: it is
        the op's origin (a serving replica's anchor or the ground host's
        uplink satellite), whose failure is the serving layer's problem,
        not the fabric's.
        """
        if dst in self.dead_sats:
            return False
        if not self.dead_links:
            return True
        return self.route_hops(spec, src, dst) is not None


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault transition, ``at_s`` relative to ``arm()``."""

    at_s: float
    action: str               # "kill" | "heal"
    sat: Sat | None = None
    link: tuple[Sat, Sat] | None = None

    def __post_init__(self) -> None:
        if self.action not in ("kill", "heal"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if (self.sat is None) == (self.link is None):
            raise ValueError("a fault event targets a sat XOR a link")


@dataclass
class FaultPlan:
    """A deterministic, time-ordered schedule of fault events."""

    events: list[FaultEvent] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.events = sorted(self.events, key=lambda e: e.at_s)

    @property
    def churn_span(self) -> tuple[float, float] | None:
        """``(first_kill_s, last_heal_s)`` -- the plan's churn phase
        boundaries, relative to arming.  ``None`` with no kills; with
        kills but no heals the churn never ends (``inf``), which also
        covers the end-of-run-drain idiom of heals parked at ``1e9``.
        The SLO timeline tags its goodput windows with these."""
        kills = [e.at_s for e in self.events if e.action == "kill"]
        if not kills:
            return None
        heals = [e.at_s for e in self.events if e.action == "heal"]
        return (min(kills), max(heals) if heals else math.inf)

    @classmethod
    def outages(
        cls,
        sats: list[Sat],
        *,
        kill_at_s: float = 0.0,
        stagger_s: float = 0.0,
        downtime_s: float | None = None,
    ) -> "FaultPlan":
        """Kill ``sats`` starting at ``kill_at_s`` (each ``stagger_s``
        after the previous), healing each ``downtime_s`` after its kill
        (``None`` = never)."""
        events = []
        for i, sat in enumerate(sats):
            t = kill_at_s + i * stagger_s
            events.append(FaultEvent(at_s=t, action="kill", sat=sat))
            if downtime_s is not None:
                events.append(
                    FaultEvent(at_s=t + downtime_s, action="heal", sat=sat))
        return cls(events)

    @classmethod
    def seeded_churn(
        cls,
        sats: list[Sat],
        *,
        seed: int,
        n_outages: int,
        start_s: float = 0.0,
        window_s: float = 1.0,
        downtime_s: float | None = None,
        links: list[tuple[Sat, Sat]] = (),
        n_link_outages: int = 0,
    ) -> "FaultPlan":
        """Reproducible random churn: ``n_outages`` distinct satellites
        from ``sats`` (and ``n_link_outages`` links from ``links``) are
        killed at seeded-uniform times in ``[start_s, start_s+window_s)``
        and healed ``downtime_s`` later.  Same seed, same schedule."""
        rng = random.Random(seed)
        events = []
        for sat in rng.sample(list(sats), min(n_outages, len(sats))):
            t = start_s + rng.random() * window_s
            events.append(FaultEvent(at_s=t, action="kill", sat=sat))
            if downtime_s is not None:
                events.append(
                    FaultEvent(at_s=t + downtime_s, action="heal", sat=sat))
        for link in rng.sample(list(links),
                               min(n_link_outages, len(links))):
            t = start_s + rng.random() * window_s
            events.append(FaultEvent(at_s=t, action="kill", link=link))
            if downtime_s is not None:
                events.append(
                    FaultEvent(at_s=t + downtime_s, action="heal", link=link))
        return cls(events)

    @classmethod
    def chaos_arc(
        cls,
        kvc,
        *,
        seed: int,
        churn_start_s: float,
        churn_window_s: float = 1.0,
        heal_s: float | None = None,
        n_sat_kills: int = 2,
        n_link_cuts: int = 0,
        dir_stripe_wipeout: bool = False,
        ground_pair_server: int | None = None,
    ) -> "FaultPlan":
        """A composite kill->degrade->heal arc over ``kvc``'s CURRENT
        geometry -- the replicated-kill, link-cut and directory-wipeout
        scenarios rolled into one seeded schedule meant to run *under
        live traffic*:

        * ``n_sat_kills`` survivable satellite kills (no data or
          directory home set completed, accounting for every other kill
          in this arc) -- degraded reads/lookups, never losses;
        * ``n_link_cuts`` ISL cuts, each severing the last greedy-route
          hop into a seeded chunk server's home -- ops detour, never
          fail;
        * ``dir_stripe_wipeout``: kill EVERY directory home of one
          seeded stripe -- its metadata is gone until heal + reconcile,
          so lookups for that stripe's blocks clean-miss and recompute;
        * ``ground_pair_server``: kill that server's ENTIRE replica home
          set -- its chunks lose every orbital copy, and Gets must fall
          through to an attached ground tier (or purge without one).

        Every kill lands at a seeded-uniform time in ``[churn_start_s,
        churn_start_s + churn_window_s)`` -- the *ordering* of the kills
        varies with the seed -- and every faulted element heals at
        ``heal_s`` (``None`` parks heals at 1e9: the end-of-run drain
        idiom).  Same ``(geometry, seed)``, same schedule."""
        rng = random.Random(seed)
        heal_at = 1e9 if heal_s is None else heal_s
        events: list[FaultEvent] = []
        killed: set[Sat] = set()

        def kill_heal_sat(sat: Sat) -> None:
            t = churn_start_s + rng.random() * churn_window_s
            events.append(FaultEvent(at_s=t, action="kill", sat=sat))
            events.append(FaultEvent(at_s=heal_at, action="heal", sat=sat))
            killed.add(sat)

        if ground_pair_server is not None:
            for r in range(kvc.replication):
                sat = kvc.replica_sat(ground_pair_server, r)
                if sat not in killed:
                    kill_heal_sat(sat)
        if dir_stripe_wipeout:
            kd = getattr(kvc, "dir_replication", kvc.replication)
            sid = rng.randrange(kvc.num_servers)
            for r in range(kd):
                sat = kvc.replica_sat(sid, r)
                if sat not in killed:
                    kill_heal_sat(sat)
        for sat in plan_survivable_kills(kvc, n_sat_kills,
                                         seed=rng.randrange(1 << 30),
                                         already_killed=killed):
            kill_heal_sat(sat)
        spec = kvc.spec
        for sid in rng.sample(range(kvc.num_servers),
                              min(n_link_cuts, kvc.num_servers)):
            path = spec.greedy_route(kvc.window.center,
                                     kvc.replica_sat(sid, 0))
            if len(path) < 2:
                continue
            link = (path[-2], path[-1])
            t = churn_start_s + rng.random() * churn_window_s
            events.append(FaultEvent(at_s=t, action="kill", link=link))
            events.append(FaultEvent(at_s=heal_at, action="heal", link=link))
        return cls(events)


@dataclass
class FaultInjectorStats:
    sat_kills: int = 0
    sat_heals: int = 0
    link_kills: int = 0
    link_heals: int = 0
    chunks_dropped: int = 0   # store entries destroyed by satellite deaths
    dir_entries_dropped: int = 0  # directory-shard entries destroyed

    @property
    def events_applied(self) -> int:
        return (self.sat_kills + self.sat_heals
                + self.link_kills + self.link_heals)


class FaultInjector:
    """Applies a ``FaultPlan`` to a ``ConstellationKVC`` on its clock.

    ``arm()`` anchors the plan's relative event times at the current
    clock reading; ``advance()`` -- called by the store at the top of
    every chunk op, and manually from tests -- applies every due event
    under one lock, so concurrent serving threads each see a consistent
    prefix of the plan.  With no clock (unclocked fabric) only events at
    ``at_s <= 0`` fire on advance; ``drain()`` force-applies the rest.

    ``hold()`` (or ``manual=True``) detaches the injector from the
    clock: the chunk-op tick no-ops and only ``advance_to(rel_s)``
    applies events -- the deterministic serve loop's drive, where
    "time" is the virtual arrival timeline, not the wall-anchored
    clock.
    """

    def __init__(self, kvc, plan: FaultPlan, *,
                 repair_on_heal: bool = False,
                 manual: bool = False) -> None:
        # views delegate storage to their base; faults live on the base
        self.kvc = getattr(kvc, "base", kvc)
        self.plan = plan
        self.repair_on_heal = repair_on_heal
        self.manual = manual
        self.state = FaultState()
        self.stats = FaultInjectorStats()
        self._idx = 0
        self._t0: float | None = None
        self._lock = threading.Lock()
        self.kvc.attach_faults(self)

    @property
    def clock(self):
        return self.kvc.transport.clock

    def _now(self) -> float:
        return 0.0 if self.clock is None else self.clock.now()

    def arm(self) -> None:
        """Anchor the plan at the current clock reading and rewind it."""
        with self._lock:
            self._t0 = self._now()
            self._idx = 0

    def hold(self) -> None:
        """Detach from the clock: the per-chunk-op ``advance()`` tick
        becomes a no-op and only ``advance_to`` applies events."""
        self.manual = True

    @property
    def next_event_at_s(self) -> float | None:
        """Relative time of the next unapplied event (None when the
        plan is exhausted) -- the deterministic serve loop peeks this to
        interleave fault crossings with rotation crossings in
        virtual-time order."""
        if self._idx >= len(self.plan.events):
            return None
        return self.plan.events[self._idx].at_s

    def advance(self) -> int:
        """Apply every event whose (relative) time has passed; returns
        how many fired.  No-op until ``arm()``, and always a no-op when
        held (``manual``): a clock read mid-pump must never fire events
        a deterministic replay expects at a virtual-time crossing."""
        if self.manual or self._t0 is None \
                or self._idx >= len(self.plan.events):
            return 0
        rel = self._now() - self._t0
        return self._apply_until(rel)

    def advance_to(self, rel_s: float) -> int:
        """Apply every event scheduled at or before ``rel_s`` (seconds
        relative to arming), regardless of the clock; returns how many
        fired.  Arms implicitly if needed.  This is the held-mode drive:
        the caller owns the timeline."""
        if self._t0 is None:
            self._t0 = self._now()
        return self._apply_until(rel_s)

    def drain(self) -> int:
        """Force-apply every remaining event (end-of-scenario settling:
        outstanding heals land regardless of the clock)."""
        if self._t0 is None:
            self._t0 = self._now()
        return self._apply_until(math.inf)

    def _apply_until(self, rel: float) -> int:
        fired = 0
        healed = False
        with self._lock:
            while (self._idx < len(self.plan.events)
                   and self.plan.events[self._idx].at_s <= rel):
                healed |= self._apply(self.plan.events[self._idx])
                self._idx += 1
                fired += 1
        if healed and self.repair_on_heal:
            # OUTSIDE the injector lock: repair purges unrecoverable
            # blocks, whose ``on_block_lost`` takes the serving-side
            # KVCManager lock -- while serving threads holding that lock
            # tick this injector from inside chunk ops.  Repairing under
            # ``self._lock`` would invert that order (ABBA deadlock).
            self.kvc.repair()
        return fired

    def _apply(self, ev: FaultEvent) -> bool:
        """Apply one event; returns True when it healed a satellite."""
        if ev.sat is not None:
            sat = self.kvc.spec.wrap(ev.sat)
            if ev.action == "kill":
                self.state.kill_sat(sat)
                self.stats.sat_kills += 1
                # shard size BEFORE the drop wipes it: the injector is
                # the fault source, so it attributes the metadata loss
                self.stats.dir_entries_dropped += self.kvc.dir_shard_len(sat)
                self.stats.chunks_dropped += self.kvc.drop_satellite(sat)
            else:
                self.state.heal_sat(sat)
                self.stats.sat_heals += 1
                return True
        else:
            a, b = ev.link
            a, b = self.kvc.spec.wrap(a), self.kvc.spec.wrap(b)
            if ev.action == "kill":
                self.state.kill_link(a, b)
                self.stats.link_kills += 1
            else:
                self.state.heal_link(a, b)
                self.stats.link_heals += 1
        return False


def plan_survivable_kills(kvc, n_kills: int, *, seed: int = 0,
                          already_killed: set[Sat] = frozenset()
                          ) -> list[Sat]:
    """Pick up to ``n_kills`` chunk-server satellites to kill such that,
    at the store's replication factor, no chunk loses its *entire*
    replica home set -- and no directory stripe loses its
    entire metadata home set either -- the benchmark's "replication
    survives this" schedule.  A factor of 1 (data or metadata) means
    nothing at that tier is survivable, so that tier's constraint is
    waived; that is the collapse baseline.  ``already_killed`` names
    satellites some other part of the schedule kills anyway (a composite
    chaos arc's deliberate home-pair / stripe wipeouts): the picks here
    must not complete a home set *in combination with them*, and are
    never drawn from them.  Seeded and deterministic for a given store
    geometry."""
    rng = random.Random(seed)
    home_sets: list[set[Sat]] = []
    if kvc.replication > 1:
        home_sets += [
            {kvc.replica_sat(sid, r) for r in range(kvc.replication)}
            for sid in range(kvc.num_servers)
        ]
    kd = getattr(kvc, "dir_replication", kvc.replication)
    if kd > 1:
        home_sets += [
            {kvc.replica_sat(sid, r) for r in range(kd)}
            for sid in range(kvc.num_servers)
        ]
    # home sets the deliberate kills already complete are lost either
    # way -- only constrain the ones still survivable
    killed: set[Sat] = set(already_killed)
    home_sets = [homes for homes in home_sets if not homes <= killed]
    cands = [s for s in dict.fromkeys(kvc.server_map) if s not in killed]
    rng.shuffle(cands)
    out: list[Sat] = []
    for sat in cands:
        if len(out) >= n_kills:
            break
        if home_sets and any(
                homes <= killed | {sat} for homes in home_sets):
            continue
        killed.add(sat)
        out.append(sat)
    return out
