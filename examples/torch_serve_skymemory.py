"""End-to-end scale-out demo: a replica cluster over one orbital cache.

The port of ``examples/serve_skymemory.py`` onto ``repro_torch``: it
imports no JAX.  Serves a TinyLlama-family model (the paper's §5 testbed
model, random weights from seed 0; reduced width and depth by
default, ``--full`` for the full 1.1B model) on the card, or on the CPU
with ``--device cpu``, from an
``EngineCluster``: router -> N Engine replicas -> ONE shared simulated
19x5 constellation.  The pieces on display:

* **Shared fabric** -- every replica is anchored at a different
  satellite of the same ``ConstellationKVC`` (one chunk store, one block
  directory, one §3.10 radix index), so a context cached by any replica
  is a prefix hit for all of them.
* **Hop-aware, prefix-affinity routing** -- requests are scored per
  replica by prefix affinity, anchor-to-home-satellite Get latency, and
  load before any engine sees them; duplicated contexts (the paper's
  RAG workload) land on the replica already holding their blocks.
* **Experienced ISL latency** -- a ``SimClock`` on the fabric gives
  every Get KVC a completion time; fetched prefixes are *in flight*
  until the clock passes it, decode steps overlap the flight, and the
  un-hidden remainder shows up as ``l2_wait_s``.
* **Rotation during serving** -- the constellation rotates on the same
  clock while requests are in flight: chunks migrate and prefix
  affinity shifts under the live cluster.
* **Fault tolerance** -- ``--replication k`` stores every chunk on k
  plane-diverse satellites, and ``--outages N`` arms a seeded
  ``FaultInjector`` that kills N chunk servers while requests are in
  flight: reads fall through the dead replicas (``degraded_reads``),
  unrecoverable blocks recompute instead of failing (``lost_blocks``),
  and the post-run repair pass re-replicates (``repaired_chunks``).
* **Graceful degradation** -- ``--degrade-links N`` severs ISLs on the
  greedy routes into N chunk servers for the whole run: ops complete
  over rerouted detours (``detoured_ops`` / ``detour_hops``) instead of
  failing.  ``--ground-stations N`` attaches the durable ground segment
  below the constellation: orbital losses fall through to ground
  (``ground_hits``) and the post-run repair re-replicates them back
  into orbit (``repaired_from_ground``) instead of purging.
* **Quantized payloads** -- ``--payload-codec int8`` (or ``int4``)
  ships every constellation payload quantized per-channel with
  per-block-chunk scale tables instead of raw f32 arrays: encoded
  bytes shrink ~4x (8x), the router prices the *encoded* sizes, and
  the dequantize leg runs on the fetch-ahead worker
  (``dequant_overlap_s``) overlapped with live decode steps.
* **Decentralized directory** -- block metadata is fabric state too:
  each entry lives on a hash-derived stripe, replicated
  ``--dir-replication`` times plane-diversely, and every lookup is a
  priced ISL op (``dir_lookups``).  Killing a stripe home degrades
  lookups onto the surviving copies (``degraded_lookups``); the final
  ``reconcile`` pass rebuilds wiped stripes from satellite inventories
  (``dir_repaired_entries``) and sweeps orphaned chunks.

* **Streaming serve** -- ``--stream`` replaces the closed batch with an
  open multi-tenant arrival process (``--tenants N`` seeded tenants
  mixing Poisson / bursty document-reuse / diurnal traffic at
  ``--arrival-rate`` requests per virtual second for ``--duration``
  virtual seconds): every request is routed at its arrival time into
  long-lived engine worker loops, router load releases per request, an
  admission controller sheds low-priority arrivals under overload, and
  the run reports *goodput* (SLO-attained tokens/s), per-tenant
  attainment, and the tail of per-request inter-token latency.  With
  ``--outages`` the stream composes the composite chaos arc
  (``FaultPlan.chaos_arc``): seeded kills open a churn window mid-run,
  heals trigger repair-on-heal, and the report prints a windowed
  goodput timeline tagged pre_churn / churn / post_heal plus the fault
  counters the stream experienced.

Run: PYTHONPATH=src python examples/torch_serve_skymemory.py
     [--device cpu]
     [--full] [--replicas N] [--requests N] [--policy random]
     [--replication K] [--dir-replication K] [--outages N]
     [--degrade-links N] [--ground-stations N]
     [--payload-codec {f32,int8,int4}]
     [--stream] [--arrival-rate R] [--duration S] [--tenants N]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ConstellationKVC,
    ConstellationSpec,
    FaultInjector,
    FaultPlan,
    GroundStationTier,
    IslTransport,
    LosWindow,
    Sat,
    SimClock,
    Strategy,
    plan_survivable_kills,
)
from repro_torch.core.faults import FaultEvent  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SLO,
    AdmissionController,
    EngineCluster,
    Request,
    SamplingParams,
    TrafficGenerator,
    standard_tenants,
)

CONTEXT = (
    "SkyMemory expands the scope of cache memory to include LEO "
    "constellations: highly distributed systems with thousands of "
    "satellites connected with free-space optics inter-satellite links, "
    "always only one hop from any point on earth. "
)


def main(argv=None) -> dict:
    """Serve, print the report, and return the fabric's final counters
    (``EngineCluster.fabric_stats``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full TinyLlama-1.1B dims (slow on CPU)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--policy", default="prefix_affinity",
                    choices=["prefix_affinity", "random"])
    ap.add_argument("--replication", type=int, default=2,
                    help="copies of every chunk (plane-diverse homes)")
    ap.add_argument("--dir-replication", type=int, default=None,
                    help="copies of every directory-stripe entry "
                         "(default: match --replication)")
    ap.add_argument("--outages", type=int, default=0,
                    help="chunk-server satellites killed mid-serve")
    ap.add_argument("--degrade-links", type=int, default=0,
                    help="chunk servers whose greedy-route ISL is cut "
                         "for the whole run (ops detour, never fail)")
    ap.add_argument("--ground-stations", type=int, default=0,
                    help="attach a durable ground segment of N stations "
                         "under the LOS window (0 = orbit only)")
    ap.add_argument("--payload-codec", default="f32",
                    choices=["f32", "int8", "int4"],
                    help="constellation payload encoding (f32 = raw "
                         "arrays; int8/int4 = per-channel quantized "
                         "with per-block scale tables)")
    ap.add_argument("--stream", action="store_true",
                    help="serve an open multi-tenant arrival stream "
                         "through the engine worker loops instead of "
                         "one closed batch")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="aggregate request rate across tenants, in "
                         "requests per virtual second (--stream)")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="length of the arrival stream in virtual "
                         "seconds (--stream)")
    ap.add_argument("--tenants", type=int, default=3,
                    help="number of seeded tenants: one protected "
                         "'pro' Poisson tenant plus alternating bursty "
                         "document-reuse and diurnal tenants (--stream)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("skymemory-tinyllama")
    if not args.full:
        cfg = cfg.replace(num_layers=4, d_model=512, num_heads=8,
                          num_kv_heads=4, head_dim=64, d_ff=1408)
    model = Model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.0f}M params)")

    spec = ConstellationSpec(num_planes=5, sats_per_plane=19,
                             altitude_km=550.0)  # paper's 19x5 testbed
    # the fabric clock: Get/Set KVC ops complete at a virtual time on it
    # (rate 10 = ten virtual seconds per wall second, so multi-hop ISL
    # flights are experienced without dominating a CPU demo)
    clock = SimClock(rate=10.0)
    # the ground segment: one durable tier under the LOS window (N
    # stations pool into one uplink-priced store; more stations = more
    # aggregate processing headroom, modeled as lower per-op time)
    ground = None
    if args.ground_stations > 0:
        ground = GroundStationTier(
            spec, processing_time_s=1e-3 / args.ground_stations)
    kvc = ConstellationKVC(
        spec, LosWindow(Sat(2, 9), 5, 5), Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024,
        replication=args.replication,
        dir_replication=args.dir_replication,
        transport=IslTransport(spec, clock=clock,
                               chunk_processing_time_s=2e-4,
                               probe_timeout_s=5e-3),
        ground=ground, ground_write="all" if ground else "none",
    )
    if ground is not None:
        print(f"ground segment: {args.ground_stations} station(s) under "
              f"the LOS window, write-through (uplink "
              f"{spec.uplink_latency_s()*1e3:.1f}ms one-way)")
    # block_size doubles as each replica's L0 page size, so blocks
    # fetched from the shared constellation drop straight into pool
    # pages; the orbital rotation ticker rotates the LOS window every 2
    # virtual seconds while requests are in flight.  With --outages the
    # ticker stays off: plan_survivable_kills guarantees "k=2 survives
    # this" against the *current* replica homes, and rotation would
    # migrate homes into never-healing dead satellites (dropping copies
    # in transit) out from under that guarantee -- one failure mode per
    # demo.
    cluster = EngineCluster(
        model, kvc, num_replicas=args.replicas,
        policy=args.policy, block_size=128, max_seq_len=512, max_batch=4,
        rotate_every_s=None if args.outages else 2.0,
        payload_codec=args.payload_codec, device=args.device,
    )
    print(f"cluster: {cluster.num_replicas} replicas anchored at "
          f"{[(a.plane, a.slot) for a in cluster.anchors]} | "
          f"routing={args.policy}")

    sp = SamplingParams(max_new_tokens=args.max_new)
    # a duplicated-prefix stream: two repeated contexts (distinct from
    # their first block, so each group has its own affinity home),
    # interleaved the way a shared front door would see them
    reqs = [
        Request(prompt=f"[document {i % 2}] " + CONTEXT * 2
                + f" Question {i % 2}: what is cached?",
                sampling=sp)
        for i in range(args.requests)
    ]
    events = []
    if args.outages and not args.stream:
        kills = plan_survivable_kills(kvc, args.outages, seed=5)
        events += FaultPlan.outages(
            kills, kill_at_s=0.5, stagger_s=0.5, downtime_s=1e9).events
        print(f"fault plan: killing {len(kills)} chunk servers "
              f"mid-serve at {[(s.plane, s.slot) for s in kills]}")
    if args.degrade_links:
        # sever the last greedy hop from the window center into the
        # first N chunk servers for the whole run: every op touching
        # them reroutes (one cut link each -- nothing partitions)
        cut = []
        for sid in range(min(args.degrade_links, kvc.num_servers)):
            path = spec.greedy_route(kvc.center, kvc.server_sat(sid))
            if len(path) >= 2:
                cut.append((path[-2], path[-1]))
        events += [FaultEvent(at_s=0.0, action="kill", link=link)
                   for link in cut]
        print(f"link degradation: {len(cut)} ISLs severed on the greedy "
              f"routes into servers 0..{len(cut) - 1} (sustained)")
    injector = None
    if events:
        injector = FaultInjector(kvc, FaultPlan(events))
        injector.arm()

    if args.stream:
        tenants = standard_tenants(args.tenants, args.arrival_rate,
                                   max_new_tokens=args.max_new)
        arrivals = list(TrafficGenerator(tenants, seed=0)
                        .until(args.duration))
        print(f"streaming: {len(arrivals)} arrivals over "
              f"{args.duration:.1f} virtual s from {len(tenants)} "
              f"tenant(s) ({', '.join(t.name for t in tenants)}) at "
              f"{args.arrival_rate:.1f} req/s aggregate")
        # warm up once (kernel libraries, allocator, library handles) so
        # the paced stream measures serving
        cluster.serve([Request(prompt="[warmup] " + CONTEXT,
                               sampling=SamplingParams(max_new_tokens=4))])
        cluster.reset_stats()
        admission = AdmissionController(
            capacity_tokens=args.replicas * 4 * 256, protect_priority=1)
        faults = window_s = None
        if args.outages:
            # with --stream, --outages arms the composite chaos arc
            # instead of the closed-batch outage plan: seeded satellite
            # kills open a churn window a third of the way into the
            # stream, the heals land at two thirds and trigger
            # repair-on-heal, and the goodput timeline below tags every
            # window pre_churn / churn / post_heal
            window_s = args.duration / 6.0
            faults = FaultPlan.chaos_arc(
                kvc, seed=5, churn_start_s=2 * window_s,
                churn_window_s=window_s, heal_s=4 * window_s,
                n_sat_kills=args.outages,
                n_link_cuts=1 if args.degrade_links else 0,
                dir_stripe_wipeout=True,
                ground_pair_server=0 if ground is not None else None)
            print(f"fault plan: chaos arc (seed 5) -- {args.outages} "
                  f"satellite kill(s) opening churn at "
                  f"t={2 * window_s:.1f}s, heals + repair-on-heal at "
                  f"t={4 * window_s:.1f}s")
        report = cluster.serve_stream(
            arrivals,
            slos={"pro": SLO(ttft_s=2.0, itl_p95_s=0.5)},
            default_slo=SLO(ttft_s=4.0, itl_p95_s=1.0),
            admission=admission,
            faults=faults, slo_window_s=window_s,
        )
        results = report.results()
        wall = report.elapsed_s
        for rec in report.records:
            a = rec.arrival
            if rec.shed:
                print(f"  t={a.t_s:5.2f}s {a.tenant:>9}: shed "
                      f"(over capacity, priority "
                      f"{a.request.priority})")
                continue
            r = rec.result
            print(f"  t={a.t_s:5.2f}s {a.tenant:>9} -> replica "
                  f"{rec.decision.replica}: prompt={r.prompt_tokens}tok "
                  f"cached={r.cached_tokens} -> {len(r.token_ids)} new "
                  f"| ttft={r.ttft_s*1e3:.0f}ms "
                  f"{'slo-ok' if rec.attained else 'slo-miss'}")
        s = report.slo
        tail = s["itl_tail_s"]
        print(f"\ngoodput: {s['goodput_tokens_per_s']:.1f} SLO-attained "
              f"tok/s of {s['tokens_per_s']:.1f} tok/s raw | attainment "
              f"{s['attainment']*100:.0f}% "
              f"({s['attained']}/{s['completed']} completed) | shed "
              f"{s['shed']} of {s['offered']} offered | itl tail "
              f"p95={tail['p95']*1e3:.1f}ms p99={tail['p99']*1e3:.1f}ms "
              f"| rotations={report.rotations}")
        for name, b in s["per_tenant"].items():
            print(f"  tenant {name:>9}: offered={b['offered']} "
                  f"shed={b['shed']} completed={b['completed']} "
                  f"attained={b['attained']} "
                  f"({b['attainment']*100:.0f}%)")
        if window_s is not None and s.get("windows"):
            print("\ngoodput timeline (fixed virtual-time windows):")
            for w in s["windows"]:
                print(f"  [{w['t0_s']:5.1f}s..{w['t1_s']:5.1f}s] "
                      f"{w['phase']:>9}: offered={w['offered']} "
                      f"shed={w['shed']} "
                      f"goodput={w['goodput_tokens_per_s']:.1f} tok/s")
            for ph, agg in s.get("phases", {}).items():
                print(f"  phase {ph:>9}: windows={agg['windows']} "
                      f"goodput={agg['goodput_tokens_per_s']:.1f} tok/s")
        if report.faults:
            f = report.faults
            print(f"fault arc: kills={f.get('sat_kills', 0)} "
                  f"heals={f.get('sat_heals', 0)} "
                  f"link_cuts={f.get('link_kills', 0)} | "
                  f"degraded_reads={f.get('degraded_reads', 0)} "
                  f"degraded_lookups={f.get('degraded_lookups', 0)} "
                  f"ground_hits={f.get('ground_hits', 0)} | "
                  f"repaired={f.get('repaired_chunks', 0)} "
                  f"(from ground {f.get('repaired_from_ground', 0)}) "
                  f"dir_repaired={f.get('dir_repaired_entries', 0)}")
    else:
        t0 = time.perf_counter()
        results = cluster.serve(reqs)
        wall = time.perf_counter() - t0

        for r, d in zip(results, cluster.decisions):
            hit = r.cached_tokens / max(r.prompt_tokens, 1) * 100
            print(f"req {r.request_id} -> replica {d.replica} "
                  f"(affinity={d.affinity_tokens}tok "
                  f"hop={d.hop_latency_s*1e3:.1f}ms): "
                  f"prompt={r.prompt_tokens}tok cached={r.cached_tokens} "
                  f"({hit:.0f}% hit) -> {len(r.token_ids)} new tok "
                  f"ttft={r.ttft_s*1e3:.0f}ms")

    print("\nper-replica:")
    for rs in cluster.replica_stats():
        pct = rs["latency_percentiles"]
        print(f"  replica {rs['replica']} @ sat{rs['anchor']}: "
              f"{rs['requests']} reqs | cached {rs['cached_tokens']} / "
              f"prefilled {rs['prefilled_tokens']} / decoded "
              f"{rs['decoded_tokens']} tok | "
              f"ttft p50={pct['ttft_s']['p50']*1e3:.0f}ms | "
              f"constellation hits={rs['constellation']['block_hits']} "
              f"misses={rs['constellation']['block_misses']} | "
              f"transport p95={rs['transport_latency_s']['p95']*1e3:.1f}ms "
              f"| l2_wait={rs['l2_wait_s']*1e3:.0f}ms")

    merged = cluster.merged_stats()
    fabric = cluster.fabric_stats()
    pct = merged.latency_percentiles()
    toks = sum(len(r.token_ids) for r in results)
    print(f"\nmerged: {merged.requests} requests, {toks} tokens in "
          f"{wall:.1f}s ({toks/wall:.1f} tok/s aggregate) | cached "
          f"{merged.cached_tokens} tok, prefilled {merged.prefilled_tokens}"
          f" tok | {merged.preemptions} preemptions")
    print(f"cluster latency: ttft p50={pct['ttft_s']['p50']*1e3:.0f}ms "
          f"p99={pct['ttft_s']['p99']*1e3:.0f}ms | inter-token "
          f"p50={pct['itl_s']['p50']*1e3:.1f}ms "
          f"p99={pct['itl_s']['p99']*1e3:.1f}ms")
    print(f"shared constellation: prefix_hit_rate="
          f"{fabric['prefix_hit_rate']*100:.0f}% "
          f"block_hits={fabric['block_hits']} "
          f"blocks_set={fabric['blocks_set']} | transport "
          f"p50={fabric['transport_latency_s']['p50']*1e3:.1f}ms "
          f"p99={fabric['transport_latency_s']['p99']*1e3:.1f}ms | "
          f"experienced l2 wait {fabric['l2_wait_s']*1e3:.0f}ms (virtual) "
          f"over {fabric['l2_fetch_waits']} fetches")
    print(f"orbital rotation: {fabric['rotations']} steps during serving, "
          f"{kvc.stats.migrations} server migrations "
          f"(hits survive chunk migration)")
    if injector is not None:
        injector.drain()            # outstanding heals land
        repaired = kvc.reconcile()  # rebuild metadata, then lost chunks
    else:
        repaired = 0
    fabric = cluster.fabric_stats()
    print(f"fault tolerance: replication={kvc.replication} | "
          f"kills={0 if injector is None else injector.stats.sat_kills} "
          f"(dropped {0 if injector is None else injector.stats.chunks_dropped}"
          f" chunks) | degraded_reads={fabric['degraded_reads']} "
          f"lost_blocks={fabric['lost_blocks']} "
          f"repaired_chunks={fabric['repaired_chunks']} total "
          f"(of which {repaired} by the final repair pass)")
    print(f"graceful degradation: "
          f"link_cuts={0 if injector is None else injector.stats.link_kills}"
          f" | detoured_ops={fabric['detoured_ops']} "
          f"(+{fabric['detour_hops']} hops) | "
          f"ground_hits={fabric['ground_hits']} "
          f"repaired_from_ground={fabric['repaired_from_ground']}"
          + (f" | ground tier holds {len(kvc.ground)} blocks"
             if kvc.ground is not None else " (no ground segment)"))
    print(f"payload codec: {args.payload_codec} | encoded "
          f"{fabric['bytes_encoded']/1e6:.1f}MB of "
          f"{fabric['bytes_raw']/1e6:.1f}MB raw "
          f"({fabric['compression_ratio']:.2f}x compression) | "
          f"dequant overlapped {fabric['dequant_overlap_s']*1e3:.0f}ms "
          f"on the fetch-ahead worker")
    print(f"striped directory: dir_replication={kvc.dir_replication} | "
          f"dir_lookups={fabric['dir_lookups']} "
          f"degraded_lookups={fabric['degraded_lookups']} | entries "
          f"dropped={0 if injector is None else injector.stats.dir_entries_dropped}"
          f" rebuilt={fabric['dir_repaired_entries']} | "
          f"orphaned_chunks={fabric['orphaned_chunks']} "
          f"shortened_prefixes={fabric['shortened_prefixes']}")
    return fabric


if __name__ == "__main__":
    main()
