"""The port's scale-out path (``EngineCluster``, its router, SLO and
admission accounting, and seeded traffic) against the reference's, on
the CPU.

The same seeds and the same converted weights go through both packages:

* ``TrafficGenerator`` arrivals for every process and the standard
  tenant mix; ``SLOTracker`` reports (with windows and fault phases),
  ``itl_tail`` and ``AdmissionController`` verdicts; ``spread_anchors``;
* router decisions (prefix affinity and the seeded random baseline)
  over each package's fabric, registered and size-modeled prices alike;
* ``EngineCluster.serve`` with 2 replicas on the TinyLlama smoke config
  under the f32, int8 and int4+delta codecs and both policies: greedy
  token ids, ``RouteDecision``s, per-replica counters and
  ``fabric_stats()`` (all but the wall-clock dequantize time);
* ``serve_stream`` in the deterministic pump-budget mode -- plain with
  rotation, under admission shedding, and through a chaos arc: the
  record stream, the shed set, the fault counters, the rotations and
  the SLO report's virtual-time fields.

Float latencies match to 1e-12.  The realtime modes (replica threads,
worker loops, the rotation ticker) run on the port alone: their
interleaving is the host's, so they are held to completion, order and
load accounting rather than to the reference.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from repro.configs import get_config, smoke_config
from repro.core import chunking as jchunking
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy

torch.set_num_threads(2)
LAT = dict(rel=0, abs=1e-12)


def _kvc(mod, clock=None, **kw):
    spec = mod.ConstellationSpec(15, 15, 550.0)
    return mod.ConstellationKVC(
        spec, mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=1024,
        transport=mod.IslTransport(spec, clock=clock,
                                   chunk_processing_time_s=1e-4), **kw)


def _decision(d):
    return (d.replica, d.affinity_tokens, d.cached_blocks, d.load_tokens,
            d.committed_tokens)


def _same_decisions(got, want):
    assert [_decision(d) for d in got] == [_decision(d) for d in want]
    assert [d.hop_latency_s for d in got] == pytest.approx(
        [d.hop_latency_s for d in want], **LAT)


def _arrival(a):
    r = a.request
    return (a.t_s, a.tenant, r.prompt, r.priority, r.tenant,
            r.sampling.max_new_tokens)


# ---------------------------------------------------------------------------
# traffic, SLO accounting, admission
# ---------------------------------------------------------------------------

TENANTS = {
    "poisson": dict(name="p", rate_rps=20.0, process="poisson"),
    "diurnal": dict(name="d", rate_rps=20.0, process="diurnal",
                    diurnal_period_s=2.0),
    "bursty": dict(name="b", rate_rps=20.0, process="bursty", burst_size=3,
                   prefix_reuse_p=0.6, num_documents=2, priority=1),
}


@pytest.mark.parametrize("mix", [*TENANTS, "standard", "sustained_mix"])
def test_traffic_matches_reference(mix):
    if mix == "standard":
        kw = dict(max_new_tokens=4, prompt_chars=(48, 96), prefix_reuse_p=0.5)
        jt, tt = (JS.standard_tenants(4, 4.0, **kw),
                  TS.standard_tenants(4, 4.0, **kw))
    elif mix == "sustained_mix":
        jt, tt = [], []
        for spec in TENANTS.values():
            jt.append(JS.TenantSpec(**spec, max_new_tokens=8))
            tt.append(TS.TenantSpec(**spec, max_new_tokens=8))
    else:
        jt, tt = [JS.TenantSpec(**TENANTS[mix])], [TS.TenantSpec(**TENANTS[mix])]
    for seed in (0, 11):
        want = JS.TrafficGenerator(jt, seed=seed).take(40)
        got = TS.TrafficGenerator(tt, seed=seed).take(40)
        assert [_arrival(a) for a in got] == [_arrival(a) for a in want]
        t_end = want[20].t_s
        assert ([_arrival(a) for a in TS.TrafficGenerator(tt, seed=seed)
                 .until(t_end)]
                == [_arrival(a) for a in JS.TrafficGenerator(jt, seed=seed)
                    .until(t_end)])
    for mod in (JS, TS):
        with pytest.raises(ValueError):
            mod.TenantSpec(name="x", rate_rps=0.0)


def test_slo_accounting_matches_reference():
    """The same offered / shed / observed stream into both trackers,
    windowed and phase-tagged; the same admission verdicts."""
    rng = np.random.default_rng(4)
    kw = dict(slos={"a": None}, window_s=0.5)
    trackers = []
    for mod in (JS, TS):
        slos = {"a": mod.SLO(ttft_s=0.2, itl_p95_s=0.05),
                "b": mod.SLO(ttft_s=0.1)}
        trackers.append(mod.SLOTracker(
            slos, default=mod.SLO(ttft_s=1.0), window_s=kw["window_s"],
            phases=mod.FaultPhases(churn_start_s=1.0, heal_s=2.0)))
    jt, tt = trackers
    jadm = JS.AdmissionController(capacity_tokens=300, protect_priority=1)
    tadm = TS.AdmissionController(capacity_tokens=300, protect_priority=1)
    for i in range(60):
        tenant = ("a", "b", "c")[int(rng.integers(3))]
        t_s = i * 0.05
        load = int(rng.integers(0, 600))
        prio = int(rng.integers(0, 2))
        assert tadm.admit(prio, load) == jadm.admit(prio, load)
        ttft = float(rng.uniform(0.0, 0.3))
        itl = [float(x) for x in rng.uniform(0.0, 0.08, int(rng.integers(0, 6)))]
        for tr in (jt, tt):
            tr.note_offered(tenant, t_s=t_s)
            if i % 7 == 3:
                tr.note_shed(tenant, t_s=t_s)
            else:
                tr.observe(tenant, ttft_s=ttft, itl_samples_s=itl,
                           new_tokens=len(itl) + 1, t_s=t_s)
        assert TS.itl_tail(itl) == JS.itl_tail(itl)
        assert TS.itl_tail(itl, 50.0) == JS.itl_tail(itl, 50.0)
    assert tadm.shed_count == jadm.shed_count > 0
    assert tt.report(2.5) == jt.report(2.5)
    assert tt.timeline() == jt.timeline()
    assert tt.phase_report() == jt.phase_report()
    assert ({p for p in ("pre_churn", "churn", "post_heal")}
            == {w["phase"] for w in jt.timeline()})


def test_spread_anchors_match_reference():
    for n in (1, 2, 3, 5, 8):
        want = JS.spread_anchors(_kvc(J), n)
        got = TS.spread_anchors(_kvc(T), n)
        assert ([(s.plane, s.slot) for s in got]
                == [(s.plane, s.slot) for s in want])


# ---------------------------------------------------------------------------
# routers over each package's fabric
# ---------------------------------------------------------------------------

BS = 8


def _tokenize(prompt):
    return [ord(c) % 96 for c in prompt]


def _fake_kvc_fn(chunking):
    def kvc_fn(tokens, past, past_len):
        return chunking.arrays_to_bytes(
            [np.cumsum(np.asarray(tokens, np.int64))])
    return kvc_fn


def _router_setup(mod, serving, chunking, policy, **kw):
    kvc = _kvc(mod)
    mgr = mod.KVCManager(_tokenize, _fake_kvc_fn(chunking), kvc,
                         block_size=BS)
    handles = [serving.ReplicaHandle(i, view=kvc.view(a))
               for i, a in enumerate(serving.spread_anchors(kvc, 3))]
    router = serving.make_router(policy, handles, manager=mgr, seed=7, **kw)
    return kvc, mgr, router


@pytest.mark.parametrize("policy,kw", [
    ("prefix_affinity", {}),
    ("prefix_affinity", {"bytes_per_token": 4.0}),
    ("prefix_affinity", {"bytes_per_token": 2.0, "delta_payloads": True}),
    ("random", {}),
], ids=["affinity", "affinity_size_model", "affinity_delta", "random"])
def test_router_decisions_match_reference(policy, kw):
    """Duplicated-document groups, constellation-cached prefixes (some
    with their registered size wiped, priced by the size model),
    releases and a reset: every decision, load and price equal."""
    rng = np.random.default_rng(9)
    docs = ["the first shared document is long enough to span blocks ",
            "a second document that other requests reuse again and again ",
            "third doc "]
    jk, jm, jr = _router_setup(J, JS, jchunking, policy, **kw)
    tk, tm, tr = _router_setup(T, TS, jchunking, policy, **kw)
    for i, d in enumerate(docs[:2]):
        toks = _tokenize(d * 2)
        assert tm.add_blocks_tokens(toks) == jm.add_blocks_tokens(toks) > 0
        if i == 1:        # priced by the size model, not registered bytes
            for m in (jm, tm):
                _, meta = m.index.longest_cached_prefix(
                    J.chain_hashes(toks, BS))
                meta.payload_bytes = 0
    for step in range(40):
        prompt = docs[int(rng.integers(3))] * int(rng.integers(1, 3)) + str(
            int(rng.integers(100)))
        toks = _tokenize(prompt)
        new = int(rng.integers(1, 9))
        want, got = jr.route(toks, est_new_tokens=new), tr.route(
            toks, est_new_tokens=new)
        _same_decisions([got], [want])
        if step % 3 == 2:
            jr.release(want.replica, want.committed_tokens)
            tr.release(got.replica, got.committed_tokens)
        assert tr.total_load() == jr.total_load(), step
        assert ([h.load_tokens for h in tr.handles]
                == [h.load_tokens for h in jr.handles]), step
    hashes = J.chain_hashes(_tokenize(docs[1] * 2), BS)
    if policy == "prefix_affinity":
        assert tr._cached_prefix(hashes)[:2] == jr._cached_prefix(hashes)[:2]
    jr.reset()
    tr.reset()
    assert tr.total_load() == jr.total_load() == 0
    with pytest.raises(ValueError, match="unknown routing policy"):
        TS.make_router("round_robin", tr.handles)


# ---------------------------------------------------------------------------
# EngineCluster over the TinyLlama smoke config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = smoke_config(get_config("skymemory-tinyllama")).replace(
        dtype="float32", num_kv_heads=2)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = tsmoke(tget("skymemory-tinyllama")).replace(
        dtype="float32", num_kv_heads=2)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


def _clusters(tiny, jkvc=None, tkvc=None, **kw):
    jm, params, tm = tiny
    kw = dict(dict(num_replicas=2, block_size=16, max_seq_len=256,
                   max_batch=2, router_seed=0), **kw)
    jc = JS.EngineCluster(jm, params, jkvc or _kvc(J), **kw)
    tc = TS.EngineCluster(tm, tkvc or _kvc(T), device="cpu", **kw)
    return jc, tc


WALL = ("dequant_overlap_s",)


def _same_fabric(tc, jc):
    tf, jf = tc.fabric_stats(), jc.fabric_stats()
    assert set(tf) == set(jf)
    for k, want in jf.items():
        if k in WALL:
            continue
        if k == "transport_latency_s":
            assert tf[k] == pytest.approx(want, **LAT)
        else:
            assert tf[k] == want, k
    for tr, jr in zip(tc.replica_stats(), jc.replica_stats()):
        for k in ("replica", "anchor", "requests", "cached_tokens",
                  "prefilled_tokens", "decoded_tokens", "constellation"):
            assert tr[k] == jr[k], k
        assert tr["transport_latency_s"] == pytest.approx(
            jr["transport_latency_s"], **LAT)


P = "SkyMemory stripes KV cache chunks across LEO satellites. "
PROMPTS = ([P * 2 + f"q{i}" for i in range(4)]
           + [f"another context {i} " * 3 for i in range(2)])


@pytest.mark.parametrize("policy,codec", [
    ("prefix_affinity", "f32"), ("prefix_affinity", "int8"),
    ("prefix_affinity", "int4+delta"), ("random", "int8")])
def test_cluster_serve_matches_reference(tiny, policy, codec):
    """Two closed-batch passes (the second hits what the first wrote
    back), sequential replicas: identical streams, routes, per-replica
    counters and fabric aggregates; ``reset_stats`` zeroes both."""
    jc, tc = _clusters(tiny, policy=policy, payload_codec=codec)
    assert tc.num_replicas == jc.num_replicas == 2
    assert ([(s.plane, s.slot) for s in tc.anchors]
            == [(s.plane, s.slot) for s in jc.anchors])
    for _ in range(2):
        jres = jc.serve([JS.Request(prompt=p, sampling=JS.SamplingParams(
            max_new_tokens=4)) for p in PROMPTS], parallel=False)
        tres = tc.serve([TS.Request(prompt=p, sampling=TS.SamplingParams(
            max_new_tokens=4)) for p in PROMPTS], parallel=False)
        assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
        assert ([r.cached_tokens for r in tres]
                == [r.cached_tokens for r in jres])
        _same_decisions(tc.decisions, jc.decisions)
        assert tc.router.total_load() == jc.router.total_load() == 0
    assert sum(r.cached_tokens for r in tres) > 0
    if policy == "prefix_affinity":
        assert len({d.replica for d in tc.decisions}) == 2
    _same_fabric(tc, jc)
    tm, jm = tc.merged_stats(), jc.merged_stats()
    for k in ("requests", "cached_tokens", "prefilled_tokens",
              "decoded_tokens", "decode_steps", "prefill_chunks"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert tc.fabric_stats()["block_hits"] > 0
    tc.reset_stats()
    jc.reset_stats()
    _same_fabric(tc, jc)
    assert tc.fabric_stats()["block_hits"] == tc.merged_stats().requests == 0


def _stream_fp(report):
    return [(r.arrival.tenant, r.shed,
             r.decision.replica if r.decision else None,
             tuple(r.result.token_ids) if r.result else None,
             r.result.cached_tokens if r.result else None)
            for r in report.records]


_VIRTUAL = ("offered", "shed", "completed", "attained", "attainment",
            "tokens", "per_tenant", "windows", "phases")


def _arrivals(mod, n, rate, max_new=4):
    tenants = mod.standard_tenants(2, rate, max_new_tokens=max_new,
                                   prompt_chars=(24, 48))
    return mod.TrafficGenerator(tenants, seed=11).take(n)


STREAMS = {
    "rotation": dict(n=6, rate=50.0, cluster={"rotate_every_s": 0.05}),
    "admission": dict(n=16, rate=50.0, cluster={"payload_codec": "int8"},
                      admission=30, pump_steps_per_s=50.0),
    "chaos": dict(n=8, rate=4.0, replication=2,
                  cluster={"rotate_every_s": 0.4, "payload_codec": "int8"},
                  arc=dict(seed=5, n_sat_kills=2, n_link_cuts=1)),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_serve_stream_deterministic_matches_reference(tiny, case):
    """``serve_stream(parallel=False)``: each arrival routed at its
    virtual time, pump rounds bought by elapsed virtual time, rotation
    and fault events crossed in order.  The same record stream, shed
    set, routes, fault counters, rotations and virtual-time SLO fields
    as the reference."""
    c = STREAMS[case]
    kvc_kw = {"replication": c["replication"]} if "replication" in c else {}
    jk, tk = _kvc(J, **kvc_kw), _kvc(T, **kvc_kw)
    jc, tc = _clusters(tiny, jk, tk, **c["cluster"])
    reports = []
    for mod, cluster, kvc in ((JS, jc, jk), (TS, tc, tk)):
        arrs = _arrivals(mod, c["n"], c["rate"])
        kw = {"pump_steps_per_s": c.get("pump_steps_per_s", 200.0)}
        if "admission" in c:
            kw["admission"] = mod.AdmissionController(
                capacity_tokens=c["admission"], protect_priority=1)
        if "arc" in c:
            core = J if mod is JS else T
            span = arrs[-1].t_s
            kw["faults"] = core.FaultPlan.chaos_arc(
                kvc, churn_start_s=span * 0.25, churn_window_s=span * 0.2,
                heal_s=span * 0.7, **c["arc"])
            kw["slo_window_s"] = span / 4
        reports.append(cluster.serve_stream(arrs, parallel=False, **kw))
    want, got = reports
    assert _stream_fp(got) == _stream_fp(want)
    _same_decisions([r.decision for r in got.records if r.decision],
                    [r.decision for r in want.records if r.decision])
    assert got.rotations == want.rotations
    assert got.faults == want.faults
    for k in _VIRTUAL:
        assert got.slo.get(k) == want.slo.get(k), k
    _same_fabric(tc, jc)
    assert tc.router.total_load() == jc.router.total_load() == 0
    done = got.results()
    assert done and all(len(r.token_ids) > 0 for r in done)
    if case == "rotation":
        assert got.rotations > 0
    if case == "admission":
        shed = got.shed()
        assert shed and all(r.arrival.request.priority == 0 for r in shed)
        assert got.slo["per_tenant"]["pro"]["shed"] == 0
    if case == "chaos":
        assert got.faults["sat_kills"] >= 2 and got.faults["sat_heals"] >= 2
        assert {w["phase"] for w in got.slo["windows"]} == {
            "pre_churn", "churn", "post_heal"}


# ---------------------------------------------------------------------------
# the realtime modes, on the port alone
# ---------------------------------------------------------------------------

def test_cluster_serve_parallel_in_request_order(tiny):
    """Replica threads on a clocked fabric with the rotation ticker on:
    every result comes back in request order with the streams of the
    sequential run, the fabric's flights are experienced, and the
    routers' loads are released."""
    _, _, tm = tiny
    reqs = [TS.Request(prompt=p, sampling=TS.SamplingParams(max_new_tokens=4))
            for p in PROMPTS]
    seq = TS.EngineCluster(tm, _kvc(T), num_replicas=2, block_size=16,
                           max_seq_len=256, max_batch=2, device="cpu")
    want = [r.token_ids for r in seq.serve(reqs, parallel=False)]
    kvc = _kvc(T, clock=T.SimClock(rate=50.0))
    par = TS.EngineCluster(tm, kvc, num_replicas=2, block_size=16,
                           max_seq_len=256, max_batch=2, device="cpu",
                           rotate_every_s=0.5)
    for _ in range(2):
        out = par.serve(reqs, parallel=True)
        assert [r.token_ids for r in out] == want
        assert [r.request_id for r in out] == [r.request_id for r in reqs]
    assert len({d.replica for d in par.decisions}) == 2
    assert par.router.total_load() == 0
    assert par.merged_stats().requests == 2 * len(reqs)
    assert par.fabric_stats()["block_hits"] > 0
    assert par.rotations >= 0


def test_serve_stream_realtime_releases_every_load(tiny):
    _, _, tm = tiny
    cluster = TS.EngineCluster(tm, _kvc(T), num_replicas=2, block_size=16,
                               max_seq_len=256, max_batch=2, device="cpu",
                               payload_codec="int8")
    arrs = _arrivals(TS, 6, 50.0)
    report = cluster.serve_stream(
        arrs, parallel=True, slos={"pro": TS.SLO(ttft_s=60.0)},
        admission=TS.AdmissionController(capacity_tokens=10**9))
    assert len(report.records) == 6 and not report.shed()
    assert report.slo["completed"] == 6
    assert all(len(r.token_ids) > 0 for r in report.results())
    assert not any(e.running for e in cluster.engines)
    deadline = time.perf_counter() + 2.0
    while cluster.router.total_load() and time.perf_counter() < deadline:
        time.sleep(0.01)                  # done-callbacks run on workers
    assert cluster.router.total_load() == 0


def test_replica_failures_are_aggregated(tiny):
    """A failed replica is never hidden: one failure re-raises as
    itself, several as one error naming each, in both serving modes."""
    _, _, tm = tiny
    cluster = TS.EngineCluster(tm, _kvc(T), num_replicas=2, block_size=16,
                               max_seq_len=256, max_batch=2, device="cpu",
                               policy="random")

    def boom(reqs, **kw):
        raise RuntimeError("replica exploded")

    originals = [e.generate for e in cluster.engines]
    for e in cluster.engines:
        e.generate = boom
    reqs = [TS.Request(prompt=f"doomed request {i} with its own prefix",
                       sampling=TS.SamplingParams(max_new_tokens=2))
            for i in range(6)]
    with pytest.raises(RuntimeError) as ei:
        cluster.serve(reqs, parallel=True)
    assert "2 replica failures" in str(ei.value)
    assert "replica 0" in str(ei.value) and "replica 1" in str(ei.value)
    assert isinstance(ei.value.__cause__, RuntimeError)
    cluster.engines[1].generate = originals[1]
    with pytest.raises(RuntimeError, match="^replica exploded$"):
        cluster.serve(reqs, parallel=True)
    assert cluster.router.total_load() == 0
    # a stream whose replica fails surfaces the request's error
    cluster.engines[0].generate = originals[0]
    target = cluster.engines[0].scheduler
    target.service = lambda: boom(None)
    with pytest.raises(RuntimeError, match="replica exploded"):
        cluster.serve_stream(_arrivals(TS, 6, 50.0), parallel=False)


def test_reported_dataclasses_are_the_reference_shape():
    for name in ("StreamRecord", "StreamReport"):
        assert ([f.name for f in dataclasses.fields(getattr(TS, name))]
                == [f.name for f in dataclasses.fields(getattr(JS, name))])
