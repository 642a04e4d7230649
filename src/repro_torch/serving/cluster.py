"""Scale-out serving: N Engine replicas over ONE shared constellation.

Ported from ``repro/serving/cluster.py``: the replicas are the port's
``Engine``s over one ``Model`` (which holds the weights) on one
``device``, ``"cuda"`` by default.  Every replica thread, every adapter
worker and the rotation ticker launch on the device's default stream.

``EngineCluster`` is the paper's "Scale Out" axis made concrete:

* one ``ConstellationKVC`` -- the orbital cache, its satellite stores,
  block directory and eviction policy -- shared by every replica;
* N ``Engine`` replicas, each *anchored* at a different satellite
  through ``ConstellationKVC.view`` (per-replica hop costs + transport
  stats on the fabric's ``SimClock``) and bound to the shared §3.10
  radix index through ``KVCManager.sibling`` (one prefix index, N entry
  points, one lock);
* a router (``serving.router``) in front: requests are scored per
  replica by prefix affinity, anchor-to-home-satellite hop latency, and
  load before any engine sees them.

Two serving surfaces share the machinery:

* ``serve`` -- the closed batch: routes a fixed request list up front,
  runs each replica's share on its own thread (replicas really do
  compute concurrently -- the shared fabric is lock-protected, and the
  ``SimClock`` makes every replica *experience* its anchor's fetch
  latency), and returns results in request order.
* ``submit`` / ``serve_stream`` -- the streaming tier: each request is
  routed at its *arrival time* on the fabric clock, handed to a
  long-lived engine worker loop, and its router load released the
  moment it finishes (per-request release -- the load tie-break
  compares true in-flight work).  ``serve_stream`` drives a seeded
  arrival stream (``serving.traffic``) through per-tenant SLO
  accounting and overload shedding (``serving.slo``), returning a
  ``StreamReport`` with goodput, attainment, and tail-ITL counters.

``rotate_every_s`` starts an orbital ticker for the rotation-during-
serving scenario: the constellation rotates on the same clock while
requests are in flight, migrating chunks and shifting prefix affinity
under the live cluster (deterministic streaming runs rotate on virtual
arrival-time crossings instead of a wall-clock thread).

Cluster-level reporting: ``merged_stats`` folds per-replica
``EngineStats`` (true cluster percentiles, not averaged ones), and
``fabric_stats`` aggregates per-view constellation hit/miss counters and
transport latency percentiles next to them.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Iterable

from repro_torch.core.chunking import PayloadCodec
from repro_torch.core.constellation import Sat
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.protocol import (
    CacheStats,
    ConstellationKVC,
    GroundStats,
    KVCManager,
    TransportStats,
)
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import GenerationResult, Request
from repro_torch.serving.router import (
    ReplicaHandle,
    RouteDecision,
    make_router,
)
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.slo import (
    SLO,
    AdmissionController,
    FaultPhases,
    SLOTracker,
)
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tokenizer import ByteTokenizer, truncate_prompt
from repro_torch.serving.traffic import Arrival


@dataclass
class StreamRecord:
    """One arrival's fate on the streaming path."""

    arrival: Arrival
    shed: bool = False
    decision: RouteDecision | None = None
    future: Future | None = None
    result: GenerationResult | None = None
    attained: bool = False


@dataclass
class StreamReport:
    """What ``serve_stream`` hands back: per-arrival records plus the
    SLO tracker's goodput/attainment counter block.  ``faults`` (only
    populated when a fault arc ran) holds the stream's OWN fault
    counters: fabric degradation deltas (``degraded_reads``,
    ``degraded_lookups``, ``ground_hits``, ``lost_blocks``,
    ``repaired_*``, ...) plus the injector's applied-event tallies --
    deltas over the stream, so a faulted warmup can't leak in."""

    records: list[StreamRecord] = field(default_factory=list)
    elapsed_s: float = 0.0
    slo: dict = field(default_factory=dict)
    rotations: int = 0
    faults: dict = field(default_factory=dict)

    def results(self) -> list[GenerationResult]:
        return [r.result for r in self.records if r.result is not None]

    def shed(self) -> list[StreamRecord]:
        return [r for r in self.records if r.shed]


def _raise_aggregated(errors: list[tuple[str, BaseException]]) -> None:
    """Surface EVERY failure, not just the first: a lone exception
    re-raises as itself; several aggregate into one RuntimeError whose
    message lists each (ExceptionGroup-style), chained to the first."""
    if not errors:
        return
    if len(errors) == 1:
        raise errors[0][1]
    msg = "; ".join(f"{label}: {type(e).__name__}: {e}"
                    for label, e in errors)
    raise RuntimeError(
        f"{len(errors)} replica failures: {msg}") from errors[0][1]


def spread_anchors(kvc: ConstellationKVC, n: int) -> list[Sat]:
    """Evenly spaced anchor satellites over the LOS window (row-major):
    replicas attach across the window instead of piling on the center,
    so their hop costs to the chunk servers genuinely differ."""
    sats = kvc.window.sats(kvc.spec)
    return [sats[(i * len(sats)) // n] for i in range(n)]


class EngineCluster:
    """Router -> N Engine replicas -> one shared constellation fabric."""

    def __init__(
        self,
        model: Model,
        kvc: ConstellationKVC,
        *,
        num_replicas: int = 2,
        policy: str = "prefix_affinity",
        router_seed: int = 0,
        rotate_every_s: float | None = None,
        block_size: int = 128,
        max_seq_len: int = 512,
        max_batch: int = 8,
        seed: int = 0,
        payload_codec: "PayloadCodec | str | None" = None,
        device="cuda",
        **engine_kwargs,
    ) -> None:
        device = resolve_device(device)
        if num_replicas < 1:
            raise ValueError("cluster needs at least one replica")
        self.kvc = kvc
        self.clock = kvc.transport.clock
        self.max_seq_len = max_seq_len
        self.rotate_every_s = rotate_every_s
        self.rotations = 0
        self.tokenizer = ByteTokenizer(model.cfg.vocab_size)
        # one codec for the whole cluster: the shared kvc_fn, every
        # replica's adapter, and the router's size model must agree on
        # what bytes a block payload is
        codec = PayloadCodec.parse(payload_codec, block_size)
        adapter = SkyKVCAdapter(model, codec=codec)
        # the shared fabric handle: one radix index + recency policy +
        # lock, adopted by the base store and every sibling below
        self.manager = KVCManager(
            self.tokenizer.encode, adapter.kvc_fn, kvc,
            block_size=block_size,
        )
        self.anchors = spread_anchors(kvc, num_replicas)
        self.views = [kvc.view(a, clock=self.clock) for a in self.anchors]
        self.engines = [
            Engine(model, manager=self.manager.sibling(view),
                   block_size=block_size, max_seq_len=max_seq_len,
                   max_batch=max_batch, seed=seed + i,
                   payload_codec=codec, device=device, **engine_kwargs)
            for i, view in enumerate(self.views)
        ]
        self.handles = [ReplicaHandle(i, view)
                        for i, view in enumerate(self.views)]
        self.router = make_router(
            policy, self.handles, manager=self.manager, seed=router_seed,
            bytes_per_token=adapter.payload_bytes_per_token(),
            delta_payloads=codec.delta)
        self.decisions: list[RouteDecision] = []   # last serve's verdicts

    @property
    def num_replicas(self) -> int:
        return len(self.engines)

    # ------------------------------------------------------------------
    def serve(self, requests: list[Request], *,
              parallel: bool = True) -> list[GenerationResult]:
        """Route the stream, run every replica's share, and return
        results in request order.  ``parallel=False`` runs replicas
        sequentially (deterministic -- the test mode)."""
        if not requests:
            return []
        self.decisions = []
        buckets: dict[int, list[tuple[int, Request]]] = {}
        for i, req in enumerate(requests):
            # route on the exact tokens the engine will serve (same
            # truncation rule as the schedulers), so the router's
            # affinity memory matches what gets cached
            toks = truncate_prompt(self.tokenizer.encode(req.prompt),
                                   self.max_seq_len)
            d = self.router.route(
                toks, est_new_tokens=req.sampling.max_new_tokens)
            self.decisions.append(d)
            buckets.setdefault(d.replica, []).append((i, req))

        results: list[GenerationResult | None] = [None] * len(requests)
        errors: list[tuple[str, BaseException]] = []

        def run_replica(ridx: int, items: list[tuple[int, Request]]) -> None:
            try:
                out = self.engines[ridx].generate([r for _, r in items])
                for (i, _), res in zip(items, out):
                    results[i] = res
            except BaseException as e:  # surfaced after join
                errors.append((f"replica {ridx}", e))

        ticker = self._start_rotation_ticker()
        try:
            if parallel and len(buckets) > 1:
                threads = [
                    threading.Thread(target=run_replica, args=(r, items),
                                     name=f"replica-{r}")
                    for r, items in buckets.items()
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            else:
                for r, items in sorted(buckets.items()):
                    run_replica(r, items)
        finally:
            if ticker is not None:
                ticker()
            # the batch is over (finished or failed): return its tokens
            # to the load accounting so the tie-break on later serves
            # compares in-flight work, not all-time totals
            for d in self.decisions:
                self.router.release(d.replica, d.committed_tokens)
        _raise_aggregated(errors)
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # streaming: per-request routing over long-lived engine workers
    # ------------------------------------------------------------------
    def start_workers(self) -> None:
        """Start every replica's long-lived worker loop (idempotent)."""
        for e in self.engines:
            e.start()

    def stop_workers(self, *, drain: bool = True) -> None:
        """Stop every replica's worker loop; ``drain=True`` finishes the
        backlog first."""
        errors: list[tuple[str, BaseException]] = []
        for i, e in enumerate(self.engines):
            try:
                e.stop(drain=drain)
            except BaseException as exc:
                errors.append((f"replica {i}", exc))
        _raise_aggregated(errors)

    def submit(self, request: Request, *,
               release: bool = True) -> tuple[Future, RouteDecision]:
        """Route ONE request now -- at its arrival, not as part of a
        batch -- and hand it to the winning replica's stream.  With
        ``release=True`` the router's committed tokens come back the
        moment this request finishes (per-request release: the load
        tie-break compares true in-flight work); ``release=False`` leaves
        them to the caller (the end-of-run baseline)."""
        toks = truncate_prompt(self.tokenizer.encode(request.prompt),
                               self.max_seq_len)
        d = self.router.route(
            toks, est_new_tokens=request.sampling.max_new_tokens)
        self.decisions.append(d)
        fut = self.engines[d.replica].submit(request)
        if release:
            fut.add_done_callback(
                lambda _f, d=d: self.router.release(d.replica,
                                                    d.committed_tokens))
        return fut, d

    # fabric counters whose stream-wide deltas a fault arc's report
    # carries: the degradation a request stream actually experienced
    _FAULT_STAT_KEYS = (
        "degraded_reads", "degraded_lookups", "ground_hits",
        "lost_blocks", "repaired_chunks", "repaired_from_ground",
        "dir_repaired_entries", "detoured_ops", "orphaned_chunks",
        "shortened_prefixes",
    )

    def serve_stream(
        self,
        arrivals: Iterable[Arrival],
        *,
        parallel: bool = True,
        slos: dict[str, SLO] | None = None,
        admission: AdmissionController | None = None,
        release_mode: str = "per_request",
        pump_steps_per_s: float = 200.0,
        faults: "FaultPlan | FaultInjector | None" = None,
        slo_window_s: float | None = None,
    ) -> StreamReport:
        """Serve an open arrival stream: route each request at its
        arrival time, shed under overload, and account goodput.

        ``parallel=True`` is the realtime mode: every replica runs its
        worker loop and the front door paces wall time to each arrival's
        virtual time by the fabric clock rate.  ``parallel=False`` is
        the deterministic mode: no threads -- elapsed virtual time buys
        ``pump`` rounds round-robined over the replicas (fractional
        budget carried across gaps) and rotation ticks on virtual
        arrival-time crossings, so the full interleave (and with greedy
        sampling, every output byte) is a pure function of the arrival
        stream.

        ``faults`` composes a chaos arc with the stream: a ``FaultPlan``
        (wrapped in a repairing injector here) or a prebuilt
        ``FaultInjector``, (re)armed at stream start so event times are
        relative to t=0 of the arrival timeline.  In realtime mode the
        injector advances on the fabric clock from inside chunk ops, as
        always; in deterministic mode it is *held* and driven on
        virtual-time crossings interleaved with rotation -- with
        ``reconcile()`` fired on satellite-heal crossings -- so a seeded
        kill->degrade->heal->repair arc replays byte-identically.  The
        report's ``faults`` block carries the stream's degradation
        deltas and the injector's event tallies.

        ``slo_window_s`` turns on the tracker's windowed goodput
        timeline (fixed virtual-time windows keyed by arrival ``t_s``,
        tagged pre_churn/churn/post_heal from the fault plan's
        ``churn_span``).

        ``release_mode``: ``"per_request"`` returns each request's
        committed tokens to the router when it finishes;
        ``"end_of_run"`` holds them to the end (the closed-batch-style
        baseline the benchmark compares against).
        """
        if release_mode not in ("per_request", "end_of_run"):
            raise ValueError(f"unknown release_mode: {release_mode!r}")
        per_request = release_mode == "per_request"
        injector: FaultInjector | None = None
        if isinstance(faults, FaultPlan):
            injector = FaultInjector(self.kvc, faults,
                                     repair_on_heal=True)
        elif faults is not None:
            injector = faults
        phases = None
        if injector is not None:
            span = injector.plan.churn_span
            if span is not None:
                phases = FaultPhases(*span)
        tracker = SLOTracker(slos, window_s=slo_window_s, phases=phases)
        records: list[StreamRecord] = []
        deferred: list[RouteDecision] = []
        self.decisions = []
        rate = self.clock.rate if self.clock is not None else 1.0
        stats_before = None
        if injector is not None:
            fabric = self.fabric_stats()
            stats_before = {k: fabric[k] for k in self._FAULT_STAT_KEYS}
            inj_before = dataclasses.asdict(injector.stats)

        def admit_and_submit(arr: Arrival) -> None:
            tracker.note_offered(arr.tenant, t_s=arr.t_s)
            if admission is not None and not admission.admit(
                    arr.request.priority, self.router.total_load()):
                tracker.note_shed(arr.tenant, t_s=arr.t_s)
                records.append(StreamRecord(arrival=arr, shed=True))
                return
            fut, d = self.submit(arr.request, release=per_request)
            if not per_request:
                deferred.append(d)
            records.append(StreamRecord(arrival=arr, decision=d,
                                        future=fut))

        t0 = time.perf_counter()
        try:
            if parallel:
                if injector is not None:
                    injector.arm()      # event times relative to now
                ticker = self._start_rotation_ticker()
                self.start_workers()
                try:
                    for arr in arrivals:
                        # pace wall time to the arrival's virtual time
                        # (direct sleep, not SimClock.wait_until: front-
                        # door pacing must not pollute transport wait
                        # accounting)
                        dt = arr.t_s / rate - (time.perf_counter() - t0)
                        if dt > 0:
                            time.sleep(dt)
                        admit_and_submit(arr)
                finally:
                    self.stop_workers(drain=True)
                    if ticker is not None:
                        ticker()
            else:
                if injector is not None:
                    injector.hold()     # crossings drive it, not the clock
                    injector.arm()
                self._serve_stream_deterministic(
                    arrivals, admit_and_submit, pump_steps_per_s,
                    injector=injector)
        finally:
            for d in deferred:     # end-of-run release (the baseline)
                self.router.release(d.replica, d.committed_tokens)
        elapsed = time.perf_counter() - t0

        errors: list[tuple[str, BaseException]] = []
        for rec in records:
            if rec.future is None:
                continue
            err = rec.future.exception()
            if err is not None:
                errors.append(
                    (f"request {rec.arrival.request.request_id}", err))
                continue
            rec.result = rec.future.result()
            rec.attained = tracker.observe(
                rec.arrival.tenant,
                ttft_s=rec.result.ttft_s,
                itl_samples_s=rec.result.itl_samples_s,
                new_tokens=len(rec.result.token_ids),
                t_s=rec.arrival.t_s)
        _raise_aggregated(errors)
        fault_block: dict = {}
        if injector is not None:
            fabric = self.fabric_stats()
            fault_block = {k: fabric[k] - stats_before[k]
                           for k in self._FAULT_STAT_KEYS}
            for k, v in dataclasses.asdict(injector.stats).items():
                fault_block[k] = v - inj_before[k]
        return StreamReport(records=records, elapsed_s=elapsed,
                            slo=tracker.report(elapsed),
                            rotations=self.rotations,
                            faults=fault_block)

    def _serve_stream_deterministic(self, arrivals, admit_and_submit,
                                    pump_steps_per_s: float,
                                    injector: FaultInjector | None = None,
                                    ) -> None:
        """The threadless interleave: walk the virtual timeline arrival
        by arrival, crossing every rotation tick AND fault event that
        falls in the gap in time order (each under the manager lock,
        with the pump budget up to the crossing spent first, so the
        fabric state a crossing mutates is exactly what a realtime run
        would have served by then), settle write-backs (so the shared
        index -- and with it every routing signal -- is in a
        schedule-independent state), then submit.

        The pump budget is an *accumulator*: elapsed virtual time times
        ``pump_steps_per_s``, spending whole rounds and carrying the
        fractional remainder across gaps -- service rate is a function
        of elapsed virtual time, never of how finely the arrival stream
        slices it.  A satellite-heal crossing triggers ``reconcile()``
        (via the injector's ``repair_on_heal``, or directly here when
        the caller's injector doesn't repair), so kill->degrade->heal->
        repair arcs replay byte-identically."""
        acc = 0.0
        prev_t = 0.0
        next_rot = self.rotate_every_s or math.inf

        def spend_until(t: float) -> None:
            nonlocal acc, prev_t
            acc += (t - prev_t) * pump_steps_per_s
            prev_t = t
            rounds = int(acc)
            acc -= rounds
            for _ in range(rounds):
                if not self._pump_all():
                    break       # idle rounds don't bank service

        def cross_until(t: float) -> None:
            nonlocal next_rot
            while True:
                ev_t = math.inf
                if injector is not None:
                    nxt = injector.next_event_at_s
                    if nxt is not None:
                        ev_t = nxt
                cross = min(next_rot, ev_t)
                if cross > t:
                    break
                spend_until(cross)
                # settle async write-backs BEFORE the crossing mutates
                # the fabric: whether a background write has landed by
                # now is thread-schedule noise, and a kill must drop a
                # schedule-independent store (same chunks_dropped every
                # replay), just as a rotation must migrate one
                self._settle_write_backs()
                if next_rot <= ev_t:
                    with self.manager.lock:
                        self.kvc.rotate(1)
                        self.rotations += 1
                    next_rot += self.rotate_every_s
                else:
                    with self.manager.lock:
                        heals = injector.stats.sat_heals
                        injector.advance_to(ev_t)
                        if (injector.stats.sat_heals > heals
                                and not injector.repair_on_heal):
                            self.kvc.reconcile()
            spend_until(t)

        for arr in arrivals:
            cross_until(arr.t_s)
            self._settle_write_backs()
            admit_and_submit(arr)
        while self._pump_all():
            pass
        self._settle_write_backs()

    def _pump_all(self) -> bool:
        busy = False
        for e in self.engines:
            busy |= e.pump()
        return busy

    def _settle_write_backs(self) -> None:
        for e in self.engines:
            if e.paged:
                e.kv.drain_write_back()

    def _start_rotation_ticker(self):
        """Orbital rotation on the serving clock: while requests are in
        flight the LOS window keeps drifting, chunks migrate, and prefix
        affinity shifts.  Returns a stop() callable (None if disabled)."""
        if not self.rotate_every_s:
            return None
        rate = self.clock.rate if self.clock is not None else 1.0
        stop = threading.Event()

        def tick() -> None:
            # deadline-based, not sleep-after-work: each rotation's wall
            # deadline advances by exactly one period regardless of how
            # long the rotate (or the wait for the manager lock) took,
            # so the realized period never drifts under load and a slow
            # tick catches up instead of rescheduling everything after
            # it.  This keeps the realtime rotation count aligned with
            # the deterministic mode's virtual-time crossings.
            period = self.rotate_every_s / rate
            next_deadline = time.perf_counter() + period
            while not stop.wait(max(0.0, next_deadline
                                    - time.perf_counter())):
                with self.manager.lock:
                    self.kvc.rotate(1)
                    self.rotations += 1
                next_deadline += period

        thread = threading.Thread(target=tick, name="orbital-rotation",
                                  daemon=True)
        thread.start()

        def stopper() -> None:
            stop.set()
            thread.join()

        return stopper

    # ------------------------------------------------------------------
    # cluster-level stats
    # ------------------------------------------------------------------
    def merged_stats(self) -> EngineStats:
        """One cluster-level EngineStats: counters summed, TTFT/ITL
        sample lists concatenated (percentiles over the union)."""
        return EngineStats.merged(e.stats for e in self.engines)

    def replica_stats(self) -> list[dict]:
        """Per-replica serving + constellation view of the last runs."""
        out = []
        for i, (eng, view) in enumerate(zip(self.engines, self.views)):
            s = eng.stats
            out.append({
                "replica": i,
                "anchor": (view.anchor.plane, view.anchor.slot),
                "requests": s.requests,
                "cached_tokens": s.cached_tokens,
                "prefilled_tokens": s.prefilled_tokens,
                "decoded_tokens": s.decoded_tokens,
                "l2_wait_s": s.l2_wait_s,
                "latency_percentiles": s.latency_percentiles(),
                "constellation": dataclasses.asdict(view.stats),
                "transport_latency_s":
                    view.transport.stats.latency_percentiles(),
            })
        return out

    def fabric_stats(self) -> dict:
        """Shared-fabric aggregates: view cache stats folded together,
        transport percentiles over every replica's ops, hit rates."""
        cache = CacheStats()
        for view in self.views:
            for f in dataclasses.fields(CacheStats):
                setattr(cache, f.name,
                        getattr(cache, f.name) + getattr(view.stats, f.name))
        merged = self.merged_stats()
        prefix_total = merged.cached_tokens + merged.prefilled_tokens
        # ops-weighted merge of the per-view latency reservoirs: each
        # view's reservoir stands for that view's TOTAL op count, so draw
        # quantile-spaced picks proportional to ops (concatenating raw
        # reservoirs would overweight idle anchors once any busy view's
        # reservoir saturates); the percentile rule itself is
        # TransportStats' -- one implementation, not a copy
        merged_t = TransportStats()
        total_ops = sum(v.transport.stats.ops for v in self.views)
        for view in self.views:
            st = view.transport.stats
            xs = sorted(st.op_latencies_s)
            if not xs or not total_ops:
                continue
            k = max(1, round(st.reservoir_size * st.ops / total_ops))
            if k == 1:
                merged_t.op_latencies_s.append(xs[len(xs) // 2])
            else:
                merged_t.op_latencies_s.extend(
                    xs[round(j * (len(xs) - 1) / (k - 1))]
                    for j in range(k))
        # fault counters fold in the BASE store's too: repair passes and
        # purge-at-loss run through the base, not any replica's view
        base = self.kvc.stats
        return {
            "block_hits": cache.block_hits,
            "block_misses": cache.block_misses,
            "blocks_set": cache.blocks_set,
            "block_hit_rate": cache.block_hits / max(
                cache.block_hits + cache.block_misses, 1),
            "prefix_hit_rate": merged.cached_tokens / max(prefix_total, 1),
            "rotations": self.rotations,
            "transport_latency_s": merged_t.latency_percentiles(),
            "l2_wait_s": merged.l2_wait_s,
            "l2_fetch_waits": merged.l2_fetch_waits,
            "degraded_reads": cache.degraded_reads + base.degraded_reads,
            "lost_blocks": cache.lost_blocks + base.lost_blocks,
            "repaired_chunks": cache.repaired_chunks + base.repaired_chunks,
            # graceful degradation: detours instead of failed ops, the
            # ground tier instead of losses (repair passes credit the
            # base store, data-plane fall-throughs the serving views)
            "detoured_ops": cache.detoured_ops + base.detoured_ops,
            "detour_hops": cache.detour_hops + base.detour_hops,
            "ground_hits": cache.ground_hits + base.ground_hits,
            "repaired_from_ground": (cache.repaired_from_ground
                                     + base.repaired_from_ground),
            # decentralized directory: priced metadata lookups, stripe
            # fall-throughs, reconcile's metadata rebuilds and orphan
            # sweeps, and prefixes the fabric served shorter than the
            # index promised (reconcile runs through the base; lookups
            # through the serving views)
            "dir_lookups": cache.dir_lookups + base.dir_lookups,
            "degraded_lookups": (cache.degraded_lookups
                                 + base.degraded_lookups),
            "dir_repaired_entries": (cache.dir_repaired_entries
                                     + base.dir_repaired_entries),
            "orphaned_chunks": cache.orphaned_chunks + base.orphaned_chunks,
            "shortened_prefixes": (cache.shortened_prefixes
                                   + base.shortened_prefixes),
            # payload codec: block bytes the fabric actually shipped vs
            # what they decode to (Set + served Get), and the dequantize
            # time hidden on the fetch-ahead worker
            "bytes_encoded": cache.bytes_encoded + base.bytes_encoded,
            "bytes_raw": cache.bytes_raw + base.bytes_raw,
            "compression_ratio": (
                (cache.bytes_raw + base.bytes_raw)
                / max(cache.bytes_encoded + base.bytes_encoded, 1)),
            "dequant_overlap_s": merged.dequant_overlap_s,
        }

    def reset_stats(self) -> None:
        """Fresh per-replica EngineStats + view cache/transport stats,
        the BASE store's CacheStats (fabric_stats folds its fault
        counters -- repair passes and loss purges land there, and a
        faulted warmup must not inflate the measured run), and router
        assignment state (benchmarks call this between the warmup and
        the timed run)."""
        for eng in self.engines:
            eng.stats = EngineStats()
        for view in self.views:
            view.stats = CacheStats()
            view.transport.stats = TransportStats()
        self.kvc.stats = CacheStats()
        if self.kvc.ground is not None:
            self.kvc.ground.stats = GroundStats()
        self.router.reset()
        self.rotations = 0
