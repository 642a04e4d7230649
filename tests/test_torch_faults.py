"""The port's fault model (``repro_torch.core.faults``) against the
reference (``repro.core.faults``), on the CPU.

The same seeds go through both packages:

* the plans: ``FaultPlan.outages``, ``seeded_churn`` and ``chaos_arc``
  (with link cuts, a directory-stripe wipeout and a replica-home-pair
  kill) give the same events, and ``plan_survivable_kills`` the same
  satellites;
* ``FaultState``'s routing under killed links and satellites: the same
  hop splits, detours, latencies and reachability;
* a seeded trace over each package's ``ConstellationKVC`` (replicated
  data and directory, a write-through ground tier) with a held
  ``FaultInjector`` driven through a chaos arc: every return value,
  every field of ``CacheStats``, ``GroundStats``, ``TransportStats`` and
  ``FaultInjectorStats``, the dead sets and the stored keys after each
  step.  Float latencies match to 1e-12.

Objects of the two packages never compare equal (each has its own
dataclasses), so satellites and events are compared as tuples.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core import chunking as jchunking
from repro.core import faults as jfaults
from repro_torch.core import faults as tfaults

LAT = dict(rel=0, abs=1e-12)


def _sat(s):
    return None if s is None else (s.plane, s.slot)


def _event(e):
    link = None if e.link is None else tuple(_sat(s) for s in e.link)
    return (e.at_s, e.action, _sat(e.sat), link)


def _norm(x):
    name = type(x).__name__
    if name == "Sat":
        return _sat(x)
    if name == "Move":
        return (x.server_id, _sat(x.src), _sat(x.dst))
    if name == "BlockMeta":
        return (x.n_chunks, x.payload_bytes, x.stored)
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _kvc(mod, *, replication=2, ground=True, chunk_bytes=64):
    spec = mod.ConstellationSpec(15, 15, 550.0)
    transport = mod.IslTransport(spec, chunk_processing_time_s=1e-4,
                                 probe_timeout_s=5e-3,
                                 stats=mod.TransportStats(reservoir_size=32))
    tier = (mod.GroundStationTier(spec, processing_time_s=1e-3)
            if ground else None)
    return mod.ConstellationKVC(
        spec, mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=chunk_bytes, replication=replication,
        dir_replication=replication, transport=transport, ground=tier,
        ground_write="all" if ground else "none")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

ARCS = {
    "kills": dict(seed=5, n_sat_kills=2),
    "kills_links": dict(seed=3, n_sat_kills=2, n_link_cuts=2),
    "full_arc": dict(seed=29, n_sat_kills=2, n_link_cuts=2,
                     dir_stripe_wipeout=True, ground_pair_server=4),
    "no_heal": dict(seed=7, n_sat_kills=3, heal_s=None),
}


@pytest.mark.parametrize("replication", [1, 2, 3])
@pytest.mark.parametrize("arc", list(ARCS))
def test_chaos_arc_matches(arc, replication):
    kw = dict(churn_start_s=1.5, churn_window_s=2.0, heal_s=6.0)
    kw.update(ARCS[arc])
    jp = J.FaultPlan.chaos_arc(_kvc(J, replication=replication), **kw)
    tp = T.FaultPlan.chaos_arc(_kvc(T, replication=replication), **kw)
    assert [_event(e) for e in tp.events] == [_event(e) for e in jp.events]
    assert tp.churn_span == jp.churn_span
    assert jp.events                      # the arc schedules something


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_outage_and_churn_plans_match(seed):
    rng = np.random.default_rng(seed)
    sats = [(int(p), int(s)) for p, s in rng.integers(0, 15, (12, 2))]
    links = [((p, s), (p, (s + 1) % 15)) for p, s in sats[:6]]
    for mod_sats in (sats[:4], sats):
        jp = J.FaultPlan.outages([J.Sat(*s) for s in mod_sats],
                                 kill_at_s=0.5, stagger_s=0.25,
                                 downtime_s=1.0 + seed)
        tp = T.FaultPlan.outages([T.Sat(*s) for s in mod_sats],
                                 kill_at_s=0.5, stagger_s=0.25,
                                 downtime_s=1.0 + seed)
        assert [_event(e) for e in tp.events] == [_event(e) for e in jp.events]
    for downtime in (None, 2.0):
        kw = dict(seed=seed, n_outages=5, start_s=1.0, window_s=3.0,
                  downtime_s=downtime, n_link_outages=3)
        jp = J.FaultPlan.seeded_churn(
            [J.Sat(*s) for s in sats],
            links=[(J.Sat(*a), J.Sat(*b)) for a, b in links], **kw)
        tp = T.FaultPlan.seeded_churn(
            [T.Sat(*s) for s in sats],
            links=[(T.Sat(*a), T.Sat(*b)) for a, b in links], **kw)
        assert [_event(e) for e in tp.events] == [_event(e) for e in jp.events]
        assert tp.churn_span == jp.churn_span
    for mod in (J, T):
        with pytest.raises(ValueError):
            mod.FaultEvent(at_s=0.0, action="explode", sat=mod.Sat(0, 0))
        with pytest.raises(ValueError):
            mod.FaultEvent(at_s=0.0, action="kill")


@pytest.mark.parametrize("replication", [1, 2, 3])
def test_survivable_kills_match(replication):
    jk, tk = _kvc(J, replication=replication), _kvc(T, replication=replication)
    for seed in range(6):
        for n in (1, 3, 8):
            already = {(3, 4), (7, 7)} if seed % 2 else set()
            want = J.plan_survivable_kills(
                jk, n, seed=seed, already_killed={J.Sat(*s) for s in already})
            got = T.plan_survivable_kills(
                tk, n, seed=seed, already_killed={T.Sat(*s) for s in already})
            assert [_sat(s) for s in got] == [_sat(s) for s in want]


def test_fault_state_routing_matches():
    rng = np.random.default_rng(11)
    js, ts = jfaults.FaultState(), tfaults.FaultState()
    jspec, tspec = J.ConstellationSpec(15, 15, 550.0), T.ConstellationSpec(
        15, 15, 550.0)
    for step in range(40):
        a = tuple(int(x) for x in rng.integers(0, 15, 2))
        op = int(rng.integers(4))
        if op == 0:
            b = (a[0], (a[1] + 1) % 15)
            js.kill_link(J.Sat(*a), J.Sat(*b))
            ts.kill_link(T.Sat(*a), T.Sat(*b))
        elif op == 1:
            js.kill_sat(J.Sat(*a))
            ts.kill_sat(T.Sat(*a))
        elif op == 2 and js.dead_sats:
            s = sorted(_sat(x) for x in js.dead_sats)[0]
            js.heal_sat(J.Sat(*s))
            ts.heal_sat(T.Sat(*s))
        assert ts.clean == js.clean
        assert ({_sat(s) for s in ts.dead_sats}
                == {_sat(s) for s in js.dead_sats})
        assert ({frozenset(_sat(s) for s in lk) for lk in ts.dead_links}
                == {frozenset(_sat(s) for s in lk) for lk in js.dead_links})
        for _ in range(6):
            src = tuple(int(x) for x in rng.integers(0, 15, 2))
            dst = tuple(int(x) for x in rng.integers(0, 15, 2))
            jsrc, jdst, tsrc, tdst = (J.Sat(*src), J.Sat(*dst), T.Sat(*src),
                                      T.Sat(*dst))
            assert (ts.route_hops(tspec, tsrc, tdst)
                    == js.route_hops(jspec, jsrc, jdst)), step
            assert (ts.route_hops(tspec, tsrc, tdst, max_extra_hops=2)
                    == js.route_hops(jspec, jsrc, jdst, max_extra_hops=2))
            assert (ts.extra_hops(tspec, tsrc, tdst)
                    == js.extra_hops(jspec, jsrc, jdst))
            assert (ts.reachable(tspec, tsrc, tdst)
                    == js.reachable(jspec, jsrc, jdst))
            want = js.routed_latency_s(jspec, jsrc, jdst)
            got = ts.routed_latency_s(tspec, tsrc, tdst)
            assert (got is None) == (want is None)
            if want is not None:
                assert got == pytest.approx(want, **LAT)
    assert js.dead_sats and js.dead_links       # the trace faulted both


# ---------------------------------------------------------------------------
# a held injector driven through a chaos arc over each package's fabric
# ---------------------------------------------------------------------------

def _transport_fields(ts):
    return {f.name: getattr(ts, f.name) for f in dataclasses.fields(ts)
            if f.name != "_rng"}


def _assert_same(tk, jk, tinj, jinj, step):
    assert dataclasses.asdict(tk.stats) == dataclasses.asdict(jk.stats), step
    assert (dataclasses.asdict(tinj.stats)
            == dataclasses.asdict(jinj.stats)), step
    assert ({_sat(s) for s in tinj.state.dead_sats}
            == {_sat(s) for s in jinj.state.dead_sats}), step
    assert len(tinj.state.dead_links) == len(jinj.state.dead_links), step
    assert tinj.next_event_at_s == jinj.next_event_at_s, step
    if jk.ground is not None:
        assert (dataclasses.asdict(tk.ground.stats)
                == dataclasses.asdict(jk.ground.stats)), step
        assert list(tk.ground._blocks) == list(jk.ground._blocks), step
    tt, jt = (_transport_fields(tk.transport.stats),
              _transport_fields(jk.transport.stats))
    for name, want in jt.items():
        if isinstance(want, (float, list)):
            assert tt[name] == pytest.approx(want, **LAT), (step, name)
        else:
            assert tt[name] == want, (step, name)
    assert ({_sat(s): st.keys() for s, st in tk._stores.items()}
            == {_sat(s): st.keys() for s, st in jk._stores.items()}), step
    assert _norm(tk.server_map) == _norm(jk.server_map), step


def _payloads(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 300, 24).tolist()
    chains, payload = [], {}
    for _ in range(8):
        cut = int(rng.integers(0, 24))
        toks = base[:cut] + rng.integers(0, 300,
                                         int(rng.integers(4, 20))).tolist()
        chains.append(J.chain_hashes(toks, 4))
    for ch in chains:
        for h in ch:
            if h not in payload:
                n = int(rng.integers(8, 120))
                payload[h] = jchunking.arrays_to_bytes(
                    [rng.standard_normal(n).astype(np.float32)])
    return rng, chains, payload


OPS = ("set", "set", "get", "get", "has", "lookup", "rotate", "repair",
       "reconcile", "estimate")


@pytest.mark.parametrize("seed,replication,ground,repair_on_heal", [
    (0, 2, True, True), (1, 2, False, False), (2, 1, True, True),
    (3, 3, False, True)],
    ids=["k2_ground_repair", "k2_orbit", "k1_ground", "k3_orbit_repair"])
def test_injector_trace_matches(seed, replication, ground, repair_on_heal):
    rng, chains, payload = _payloads(seed)
    hashes = list(payload)
    jk = _kvc(J, replication=replication, ground=ground)
    tk = _kvc(T, replication=replication, ground=ground)
    kw = dict(seed=29 + seed, churn_start_s=2.0, churn_window_s=3.0,
              heal_s=8.0, n_sat_kills=2, n_link_cuts=2,
              dir_stripe_wipeout=True,
              ground_pair_server=4 if ground else None)
    jinj = J.FaultInjector(jk, J.FaultPlan.chaos_arc(jk, **kw),
                           repair_on_heal=repair_on_heal)
    tinj = T.FaultInjector(tk, T.FaultPlan.chaos_arc(tk, **kw),
                           repair_on_heal=repair_on_heal)
    assert tk.injector is tinj and tk.faults is tinj.state
    for inj in (jinj, tinj):
        inj.hold()
        inj.arm()
    view_j, view_t = jk.view(J.Sat(5, 5)), tk.view(T.Sat(5, 5))
    seen = set()
    for step in range(240):
        t = step * 0.05
        assert tinj.advance_to(t) == jinj.advance_to(t), step
        assert tinj.advance() == jinj.advance() == 0     # held
        op = OPS[int(rng.integers(len(OPS)))]
        h = hashes[int(rng.integers(len(hashes)))]
        if op == "set":
            want, got = jk.set_block(h, payload[h]), tk.set_block(h, payload[h])
        elif op == "get":
            want, got = view_j.get_block(h), view_t.get_block(h)
        elif op == "has":
            want, got = jk.has_block(h), tk.has_block(h)
        elif op == "lookup":
            ch = chains[int(rng.integers(len(chains)))]
            want, got = jk.lookup_longest(ch), tk.lookup_longest(ch)
        elif op == "rotate":
            want, got = jk.rotate(1), tk.rotate(1)
        elif op == "repair":
            want, got = jk.repair(), tk.repair()
        elif op == "reconcile":
            want, got = jk.reconcile(), tk.reconcile()
        else:
            want = view_j.estimate_get_latency_s(
                payload_bytes=len(payload[h]), block_hash=h)
            got = view_t.estimate_get_latency_s(
                payload_bytes=len(payload[h]), block_hash=h)
            assert got == pytest.approx(want, **LAT), step
            want = got = None
        seen.add(op if not want else op + "+")
        assert _norm(got) == _norm(want), (step, op)
        _assert_same(tk, jk, tinj, jinj, (step, op))
        assert (dataclasses.asdict(view_t.stats)
                == dataclasses.asdict(view_j.stats)), step
    assert tinj.drain() == jinj.drain()
    _assert_same(tk, jk, tinj, jinj, "drain")
    # the arc ran: kills and heals applied, and reads were degraded
    s = jinj.stats
    assert s.sat_kills >= 2 and s.sat_heals >= 2 and s.link_kills >= 1
    assert {"set+", "get+", "lookup+"} <= seen
    if replication > 1:
        # a surviving replica answered: repaired copies and degraded reads
        # or directory lookups
        assert jk.stats.repaired_chunks > 0
        assert sum(st.degraded_reads + st.degraded_lookups
                   for st in (jk.stats, view_j.stats)) > 0
    if ground:
        assert jk.stats.ground_hits + view_j.stats.ground_hits > 0
