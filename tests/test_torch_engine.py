"""The port's paged engine against ``repro.serving.Engine``.

Both engines serve the same prompts on the same weights (the
reference's ``Model.init``, converted with ``params_from_numpy``),
greedy, f32, on the CPU.  Greedy token streams must be identical:
chunked admission, stop-the-world admission, a free-list pool under
preemption with host-tier (L1) restores, and SkyMemory prefix hits over
each engine's own package's constellation, each over an f32 and an int8
KV page pool (the port's ``KVCManager`` and
``ConstellationKVC`` on the port's side).  The facade members the
reference's tests use (``page_size``, ``chunk_log``, ``_chunk_buf``)
behave as the reference's.  The payload bytes the port writes must be
the reference's.
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
import repro.core as J
import repro_torch.core as T
from repro.core import chunking as jchunking
from repro.models.model import Model as JaxModel
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving import sample as jax_sample
from repro.serving.skycache import SkyKVCAdapter as JaxAdapter
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import chunking as tchunking
from repro_torch.serving import Engine, Request, SamplingParams, sample
from repro_torch.serving.kv_manager import HostPageCache
from repro_torch.serving.sampler import sample_batch
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(2)
PROMPT = "SkyMemory stripes KV cache chunks across LEO satellites. "


def _models(**over):
    """The TinyLlama smoke config with 2 kv heads (GQA grouping), f32,
    in both packages on the reference's ``PRNGKey(0)`` weights."""
    cfg = smoke_config(get_config("skymemory-tinyllama")).replace(
        dtype="float32", num_kv_heads=2, **over)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = tsmoke(tget("skymemory-tinyllama")).replace(
        dtype="float32", num_kv_heads=2, **over)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def setup():
    return _models()


@pytest.fixture(scope="module")
def setup_int8():
    """The same models over an int8 KV page pool (``kvc_dtype``)."""
    return _models(kvc_dtype="int8")


@pytest.fixture(params=["f32_pool", "int8_pool"])
def pools(request):
    """Both fixtures: the engine tests that serve run over each pool."""
    return request.getfixturevalue(
        "setup" if request.param == "f32_pool" else "setup_int8")


def make_kvc(mod):
    """The same constellation, built from ``repro.core`` or
    ``repro_torch.core``."""
    return mod.ConstellationKVC(
        mod.ConstellationSpec(15, 15, 550.0),
        mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024,
    )


def _serve(setup, prompts, max_new, *, manager_passes=0, **kw):
    """Token streams (and the engines) of both engines on ``prompts``."""
    jm, params, tm = setup
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    jreqs = [JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=n))
             for p, n in zip(prompts, news)]
    treqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=n))
             for p, n in zip(prompts, news)]
    if manager_passes:
        # the port's side takes a port KVCManager the test builds, so the
        # ``manager=`` path stays covered (``kvc=``: test_torch_fabric.py)
        jeng = JaxEngine(jm, params, kvc=make_kvc(J), **kw)
        adapter = SkyKVCAdapter(tm)
        mgr = T.KVCManager(ByteTokenizer(tm.cfg.vocab_size).encode,
                           adapter.kvc_fn, make_kvc(T),
                           block_size=kw["block_size"])
        teng = Engine(tm, manager=mgr, device="cpu", **kw)
    else:
        jeng = JaxEngine(jm, params, **kw)
        teng = Engine(tm, device="cpu", **kw)
    for _ in range(manager_passes - 1):   # warm passes fill the fabric
        jeng.generate(jreqs)
        teng.generate(treqs)
    jres, tres = jeng.generate(jreqs), teng.generate(treqs)
    return ([r.token_ids for r in jres], [r.token_ids for r in tres],
            jres, tres, jeng, teng)


@pytest.mark.parametrize("chunk_tokens", [None, 0],
                         ids=["chunked", "stop_the_world"])
def test_admission_token_streams_identical(pools, chunk_tokens):
    """Three prompts on two slots: a cold admission wave, then a third
    request admitted mid-decode when the short one finishes (chunks
    riding decode steps, or a stop-the-world dense prefill)."""
    prompts = [PROMPT * 2 + "a", "short one", PROMPT + "tail " * 5]
    want, got, _, _, jeng, teng = _serve(
        pools, prompts, [8, 2, 6], block_size=16, max_seq_len=128, max_batch=2,
        chunk_tokens=chunk_tokens)
    assert got == want
    assert teng.chunked == jeng.chunked == (chunk_tokens is None)
    assert teng.stats.mid_decode_admissions == jeng.stats.mid_decode_admissions > 0
    assert teng.stats.prefill_chunks == jeng.stats.prefill_chunks
    assert teng.cache.free_pages == teng.cache.num_pages
    assert teng.cache.k_pool.dtype == _pool_dtype(pools)


def _pool_dtype(pools) -> torch.dtype:
    return torch.int8 if pools[2].cfg.kvc_dtype == "int8" else torch.float32


def test_preemption_with_l1_restore_identical(pools, monkeypatch):
    """An oversubscribed free-list pool: four short prompts co-admit
    lazily, growth exhausts the pool, and victims are offloaded to the
    host tier (in the pool's dtype) and restored bit-exact."""
    offloaded = []
    put = HostPageCache.put

    def spy(self, key, entry):
        offloaded.append((entry.k.dtype, entry.v.dtype))
        put(self, key, entry)

    monkeypatch.setattr(HostPageCache, "put", spy)
    prompts = [f"grow {i} " + "x" * 24 for i in range(4)]
    want, got, _, tres, jeng, teng = _serve(
        pools, prompts, 40, block_size=16, max_seq_len=128, max_batch=4,
        num_pages=1 + 8)
    assert got == want
    dt = _pool_dtype(pools)
    assert teng.cache.k_pool.dtype == dt
    assert offloaded and set(offloaded) == {(dt, dt)}
    s = teng.stats
    assert s.preemptions == jeng.stats.preemptions > 0
    assert s.restores == s.preemptions
    assert s.replayed_tokens == 0              # L1 restores are bit-exact
    assert sum(r.preemptions for r in tres) == s.preemptions
    assert teng.cache.free_pages == teng.cache.num_pages - 1
    assert len(offloaded) == s.preemptions


def test_constellation_prefix_hits_identical(pools):
    """Each engine over its own package's KVCManager + ConstellationKVC:
    the first pass writes back (through ``kvc_fn``), the second pass
    hits (quantized into an int8 pool by ``write_pages``)."""
    prompts = [PROMPT * 2 + f"q{i}" for i in range(3)]
    want, got, jres, tres, jeng, teng = _serve(
        pools, prompts, 5, manager_passes=2, block_size=16, max_seq_len=256,
        max_batch=2)
    assert got == want
    assert [r.cached_tokens for r in tres] == [r.cached_tokens for r in jres]
    assert all(r.cached_tokens > 0 for r in tres)
    assert teng.stats.cached_tokens == jeng.stats.cached_tokens
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert ts.block_hits == js.block_hits > 0
    assert ts.block_misses == js.block_misses
    assert ts.blocks_set == js.blocks_set > 0
    assert teng.cache.k_pool.dtype == _pool_dtype(pools)


def test_chunk_buf_is_bounded_and_sufficient(setup):
    """The chunk buffer of ``v`` valid tokens: the reference's length,
    at least ``v`` and at most the chunk budget."""
    jm, params, tm = setup
    kw = dict(block_size=16, max_seq_len=256, max_batch=2, chunk_tokens=64)
    jeng, teng = JaxEngine(jm, params, **kw), Engine(tm, device="cpu", **kw)
    assert teng.page_size == jeng.page_size == 16
    for v in (1, 2, 31, 32, 33, 63, 64):
        b = teng._chunk_buf(v)
        assert b == jeng._chunk_buf(v)
        assert v <= b <= 64


def _facade_engines(setup, **kw):
    """A reference and a port engine, each over its own constellation."""
    jm, params, tm = setup
    kw = dict(block_size=16, max_seq_len=256, max_batch=2, **kw)
    return (JaxEngine(jm, params, kvc=make_kvc(J), **kw),
            Engine(tm, kvc=make_kvc(T), device="cpu", **kw))


def test_whole_prompt_cached_replays_one_token(setup):
    """A whole-prompt hit keeps every restored block and recomputes one
    token through the paged chunk path, in both engines; the warm stream
    is the cold one."""
    jm, params, tm = setup
    prompt = "x" * 63                     # + bos = 64 tokens = 4 blocks
    sp = dict(max_new_tokens=6)
    results = []
    for eng, req, samp in zip(_facade_engines(setup),
                              (JaxRequest, Request),
                              (JaxSampling, SamplingParams)):
        eng.generate([req(prompt=prompt, sampling=samp(**sp))])
        eng.chunk_log = []
        rc = eng.generate([req(prompt=prompt, sampling=samp(**sp))])[0]
        assert rc.prompt_tokens == 64
        assert rc.cached_tokens == 63 and rc.prefill_tokens == 1
        assert eng.chunk_log == [(0, 63, 1)]  # the only chunk: 1-token replay
        results.append(rc.token_ids)
    cold = Engine(tm, device="cpu", max_seq_len=256, max_batch=2).generate(
        [Request(prompt=prompt, sampling=SamplingParams(**sp))])[0]
    assert results[1] == results[0] == cold.token_ids


def test_partial_prefix_hit_chunks_only_suffix(setup):
    """A partial hit restores its blocks into pages and chunks only the
    uncached suffix from the cached boundary: the reference's chunk log."""
    prompt = PROMPT * 3
    logs, cached = [], []
    for eng, req, samp in zip(_facade_engines(setup, chunk_tokens=32),
                              (JaxRequest, Request),
                              (JaxSampling, SamplingParams)):
        eng.generate([req(prompt=prompt, sampling=samp(max_new_tokens=4))])
        eng.chunk_log = []
        r = eng.generate([req(prompt=prompt + " more text afterwards",
                              sampling=samp(max_new_tokens=4))])[0]
        assert 0 < r.cached_tokens < r.prompt_tokens
        assert r.cached_tokens % 16 == 0
        assert eng.chunk_log[0][1] == r.cached_tokens
        assert sum(c[2] for c in eng.chunk_log) == r.prefill_tokens
        logs.append(list(eng.chunk_log))
        cached.append((r.cached_tokens, r.token_ids))
    assert logs[1] == logs[0]
    assert cached[1] == cached[0]


def test_payload_bytes_match_reference(setup):
    """Under the f32 codec ``pages_to_payload`` writes the reference's
    bytes exactly.  ``kvc_fn`` (cold, and resumed from a past payload)
    writes the same format, header and length; its K/V values agree at
    the model tolerance (the forward sums in another order than XLA's),
    and the prefix it copies through from the past payload is
    byte-identical."""
    jm, params, tm = setup
    ja, ta = JaxAdapter(jm, params), SkyKVCAdapter(tm)
    toks = ByteTokenizer(tm.cfg.vocab_size).encode(PROMPT)[:32]
    j16, t16 = ja.kvc_fn(toks[:16], None, 0), ta.kvc_fn(toks[:16], None, 0)
    # magic, version, count, then the first array's dtype tag, rank,
    # shape and byte length: everything before its data
    header = 4 + 6 + (1 + 3) + 1 + 8 * 4 + 8
    assert len(t16) == len(j16) and t16[:header] == j16[:header]
    got = tchunking.bytes_to_arrays(t16)
    want = jchunking.bytes_to_arrays(j16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-3)
    # resume from the reference's own past payload: bytes over the prefix
    # are copied through, so they match exactly
    t32, j32 = ta.kvc_fn(toks, j16, 16), ja.kvc_fn(toks, j16, 16)
    assert len(t32) == len(j32)
    gk, wk = tchunking.bytes_to_arrays(t32)[0], jchunking.bytes_to_arrays(j32)[0]
    np.testing.assert_array_equal(gk[:, :16], wk[:, :16])
    np.testing.assert_allclose(gk, wk, atol=1e-4, rtol=1e-3)
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 2, 16, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, 16, 2, 64)).astype(np.float32)
    tp = ta.pages_to_payload(torch.from_numpy(k), torch.from_numpy(v), 24)
    assert tp == ja.pages_to_payload(k, v, 24)
    k2, v2 = ta.payload_to_pages(tp, 16, 16)
    np.testing.assert_array_equal(k2.numpy(), k[:, :1])
    np.testing.assert_array_equal(v2.numpy(), v[:, :1])


def test_bf16_payload_round_trips_both_ways():
    """A bf16 payload is the raw 2-byte words under the tag ``bfloat16``:
    the port's bytes decode in the reference to the same bits, and the
    reference's bytes decode in the port straight to torch.bfloat16."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 2, 8)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    words = xb.view(torch.int16).numpy()
    jx = words.view(ml_dtypes.bfloat16)
    tbytes = tchunking.arrays_to_bytes([xb, x])
    jbytes = jchunking.arrays_to_bytes([jx, x.numpy()])
    assert tbytes == jbytes
    back = jchunking.bytes_to_arrays(tbytes)
    np.testing.assert_array_equal(back[0].view(np.int16), words)
    got = tchunking.bytes_to_arrays(jbytes)
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0].view(torch.int16), xb.view(torch.int16))
    np.testing.assert_array_equal(got[1], x.numpy())


def test_sampled_modes_stay_in_support():
    """top-k / top-p never emit a masked token; greedy rows are argmax."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 1.0, 0.7])
    top_k = torch.tensor([0, 5, 0, 3], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 0.5, 0.9])
    gen = torch.Generator().manual_seed(0)
    order = torch.argsort(logits, dim=-1, descending=True)
    probs = torch.softmax(logits, dim=-1)
    sorted_p = torch.gather(probs, 1, order)
    nucleus = int((torch.cumsum(sorted_p[2], 0) < 0.5).sum()) + 1
    allowed = {1: set(order[1, :5].tolist()),
               2: set(order[2, :nucleus].tolist()),
               3: set(order[3, :3].tolist())}
    seen = {1: set(), 2: set(), 3: set()}
    for _ in range(300):
        ids = sample_batch(logits, gen, temps, top_k, top_p)
        assert ids[0].item() == order[0, 0].item()
        for row in allowed:
            assert ids[row].item() in allowed[row]
            seen[row].add(ids[row].item())
    assert all(len(seen[r]) > 1 for r in seen)   # it does sample


def test_sample_against_reference():
    """``sample`` (one ``SamplingParams`` for the batch) against
    ``repro.serving.sample`` on the same seeded logits: greedy rows are
    equal; sampled rows stay inside the top-k / top-p support, as the
    reference's do (the two draw from different generators)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    logits = torch.from_numpy(x)
    greedy = sample(logits, torch.Generator().manual_seed(0),
                    SamplingParams())
    want = np.asarray(jax_sample(jax.numpy.asarray(x), jax.random.PRNGKey(0),
                                 JaxSampling()))
    assert greedy.dtype == torch.int32
    np.testing.assert_array_equal(greedy.numpy(), want)
    order = np.argsort(-x, axis=-1)
    probs = np.exp(x - x.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    sorted_p = np.take_along_axis(probs, order, -1)
    nucleus = (np.cumsum(sorted_p, -1) < 0.6).sum(-1) + 1
    gen = torch.Generator().manual_seed(1)
    for params, support in (
            (dict(top_k=4), [set(o[:4]) for o in order]),
            (dict(top_p=0.6), [set(o[:n]) for o, n in zip(order, nucleus)])):
        seen = [set() for _ in range(len(x))]
        for i in range(100):
            got = sample(logits, gen, SamplingParams(temperature=1.0,
                                                     **params)).tolist()
            ref = np.asarray(jax_sample(
                jax.numpy.asarray(x), jax.random.PRNGKey(i),
                JaxSampling(temperature=1.0, **params))).tolist()
            for row, (g, r) in enumerate(zip(got, ref)):
                assert g in support[row] and r in support[row]
                seen[row].add(g)
        assert all(len(s) > 1 for s in seen)     # it does sample


def test_engine_serves_sampled_requests(setup):
    """Mixed greedy / temperature / top-k / top-p requests all finish."""
    _, _, tm = setup
    eng = Engine(tm, block_size=16, max_seq_len=128, max_batch=2,
                 device="cpu", seed=3)
    sps = [SamplingParams(max_new_tokens=5),
           SamplingParams(temperature=0.8, max_new_tokens=5),
           SamplingParams(temperature=1.0, top_k=4, max_new_tokens=5),
           SamplingParams(temperature=1.0, top_p=0.6, max_new_tokens=5)]
    res = eng.generate([Request(prompt=PROMPT + str(i), sampling=sp)
                        for i, sp in enumerate(sps)])
    assert all(len(r.token_ids) == 5 or r.finish_reason == "eos"
               for r in res)
    assert all(0 <= t < tm.cfg.vocab_size for r in res for t in r.token_ids)

