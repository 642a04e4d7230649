"""The port's streaming front door (``Engine.submit`` / ``pump`` /
``start`` / ``stop`` over ``serving/worker.py``) against the reference's,
on the CPU, for the paged engine (the TinyLlama smoke config) and for
the dense runtime's micro-batching inbox (the mamba2 smoke config).

Both packages serve the same prompts on the same converted weights,
greedy, f32:

* requests queued before the worker starts drain on ``stop()`` to the
  reference's greedy streams, and ``generate`` is refused while the
  worker runs;
* the threadless ``pump`` drives the same requests to the same streams;
* ``stop(drain=False)`` cancels what is queued, in both packages;
* submits from many threads at once all complete, each with the
  reference's stream for its prompt (one slot, so the batch a request
  rides in cannot change its numbers);
* a crash inside the worker fails every in-flight future with it, and
  ``submit`` is refused until the worker starts again.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(2)
FAMILIES = {"paged": ("skymemory-tinyllama", {"num_kv_heads": 2}),
            "dense": ("mamba2-1.3b", {})}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    name, kw = FAMILIES[request.param]
    cfg = smoke_config(get_config(name)).replace(dtype="float32", **kw)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = tsmoke(tget(name)).replace(dtype="float32", **kw)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return request.param, jm, params, tm


def _engines(family, **kw):
    kind, jm, params, tm = family
    kw = dict(dict(block_size=16, max_seq_len=256, max_batch=2), **kw)
    jeng, teng = JaxEngine(jm, params, **kw), Engine(tm, device="cpu", **kw)
    assert teng.paged == jeng.paged == (kind == "paged")
    return jeng, teng


def _requests(n, max_new=3, stem="stream request"):
    prompts = [f"{stem} {i}: " + "tokens " * (i % 3) for i in range(n)]
    return ([JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=max_new))
             for p in prompts],
            [Request(prompt=p, sampling=SamplingParams(max_new_tokens=max_new))
             for p in prompts])


def test_worker_drains_to_the_reference_streams(family):
    """Five requests queued, then the worker starts; ``stop(drain=True)``
    with requests still in flight finishes every one.  The streams are
    the reference's, and a stopped engine takes a closed batch again."""
    jeng, teng = _engines(family)
    jreqs, treqs = _requests(5)
    streams = []
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        futs = [eng.submit(r) for r in reqs]
        assert eng.backlog and not eng.running
        eng.start()
        assert eng.running
        with pytest.raises(RuntimeError, match="worker loop is running"):
            eng.generate([reqs[0]])
        eng.stop(drain=True)
        assert not eng.backlog and not eng.running
        res = [f.result(timeout=0) for f in futs]
        assert all(len(r.token_ids) == 3 for r in res)
        streams.append([r.token_ids for r in res])
        assert eng.stats.requests == 5
        assert len(eng.generate([reqs[1]])[0].token_ids) == 3
    assert streams[1] == streams[0]


def test_pump_serves_the_reference_streams(family):
    """The threadless drive: ``pump`` until the backlog is gone."""
    jeng, teng = _engines(family)
    jreqs, treqs = _requests(4, max_new=4, stem="pumped")
    streams, rounds = [], []
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        futs = [eng.submit(r) for r in reqs]
        n = 0
        while eng.pump():
            n += 1
        assert not eng.backlog
        streams.append([f.result(timeout=0).token_ids for f in futs])
        rounds.append(n)
    assert streams[1] == streams[0]
    assert rounds[1] == rounds[0]


def test_stop_without_drain_cancels_queued(family):
    """No worker running: ``stop(drain=False)`` cancels every queued
    request inline, in both packages."""
    jeng, teng = _engines(family)
    jreqs, treqs = _requests(3, max_new=4, stem="doomed")
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        futs = [eng.submit(r) for r in reqs]
        eng.stop(drain=False)
        assert all(f.cancelled() for f in futs)
        assert not eng.backlog
    # with the worker running, each future is either cancelled or done
    _, treqs = _requests(6, max_new=6, stem="racing")
    futs = [teng.submit(r) for r in treqs]
    teng.start()
    teng.stop(drain=False)
    assert not teng.running and not teng.backlog
    for f in futs:
        assert f.cancelled() or len(f.result(timeout=0).token_ids) == 6


def test_submit_concurrent_from_many_threads(family):
    """Eight threads submit at once to a running worker: every request
    completes with the reference's stream for its prompt.  One slot, so
    no request's numbers depend on the batch it rides in."""
    jeng, teng = _engines(family, max_batch=1)
    jreqs, treqs = _requests(8, max_new=2, stem="concurrent")
    want = {r.prompt: res.token_ids
            for r, res in zip(jreqs, jeng.generate(jreqs))}
    teng.start()
    futs, lock = {}, threading.Lock()
    barrier = threading.Barrier(len(treqs))

    def feed(req):
        barrier.wait(timeout=30)
        f = teng.submit(req)
        with lock:
            futs[req.prompt] = f

    threads = [threading.Thread(target=feed, args=(r,)) for r in treqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    teng.stop(drain=True)
    assert len(futs) == len(treqs)
    got = {p: f.result(timeout=0).token_ids for p, f in futs.items()}
    assert got == want
    assert teng.stats.requests == len(treqs)


def test_worker_crash_fails_every_future(family):
    """An exception inside the worker loop fails every in-flight future
    (no waiter hangs) with that exception, and ``submit`` is then
    refused until the worker is started again."""
    _, teng = _engines(family)
    _, treqs = _requests(3)

    def boom(*a, **k):
        raise RuntimeError("device fell over")

    target = teng.scheduler if teng.paged else teng._dense
    name = "service" if teng.paged else "generate"
    original = getattr(target, name)
    setattr(target, name, boom)
    futs = [teng.submit(r) for r in treqs]
    teng.start()
    for f in futs:
        assert isinstance(f.exception(timeout=30), RuntimeError)
        with pytest.raises(RuntimeError, match="device fell over"):
            f.result(timeout=0)
    teng.worker._thread.join(timeout=30)
    assert not teng.running
    with pytest.raises(RuntimeError, match="engine worker died"):
        teng.submit(treqs[0])
    setattr(target, name, original)
    teng.start()
    fut = teng.submit(treqs[0])
    teng.stop(drain=True)
    assert len(fut.result(timeout=0).token_ids) == 3
