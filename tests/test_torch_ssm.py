"""The port's SSM path (Mamba-2) against the reference, on the CPU in f32.

The same inputs, made from a numpy seed, and the same weights (the
reference's ``Model.init``, converted with ``params_from_numpy``) go
through ``repro`` and ``repro_torch``:

* the plain SSD scan against the Pallas kernel (interpret mode) and the
  jnp oracle, and the single-token recurrence;
* the arithmetic of the scan's bf16 tensor-core body (f32 factors split
  into bf16 hi + lo), replayed in plain torch, against the plain scan at
  the limits the card holds the kernel to;
* the smoke mamba2 model: forward logits and the collected snapshot, a
  resume from a snapshot, and the decode step;
* the serving engine: identical greedy streams cold, with partial
  SkyMemory snapshot hits (each engine over its own package's
  constellation, ``kvc=``), and across more requests than slots; payload
  bytes; and the invariant the reference breaks -- a prompt served from
  the cache gives the stream it gives cold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
import repro.core as J
import repro_torch.core as T
from repro.core import chunking as jchunking
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_chunk_scan
from repro.models.model import Model as JaxModel
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro.serving.skycache import SkyKVCAdapter as JaxAdapter
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import chunking as tchunking
from repro_torch.kernels import ops
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(2)
# the reference's kernel tolerance (tests/test_kernels.py): y, then state
Y_TOL = dict(atol=2e-5, rtol=2e-4)
STATE_TOL = dict(atol=1e-4, rtol=1e-3)
BASE = "SkyMemory stripes KV cache chunks across LEO satellites and more text. "


def _scan_inputs(seed, b, l, h, p, g, n, with_init):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = dict(
        x=rng.standard_normal((b, l, h, p)).astype(f32),
        dt=rng.uniform(0.01, 0.2, (b, l, h)).astype(f32),
        a=-rng.uniform(0.5, 2.0, (h,)).astype(f32),
        b_mat=rng.standard_normal((b, l, g, n)).astype(f32),
        c_mat=rng.standard_normal((b, l, g, n)).astype(f32),
    )
    init = (rng.standard_normal((b, h, p, n)).astype(f32) if with_init
            else None)
    return arrs, init


# (b, l, h, p, g, n, chunk): the shapes of the reference's kernel test,
# then chunk 1, a ragged single chunk (a 37-token prompt), and
# mamba2-1.3b's widths (heads of 64, state 128, chunk 128) at 8 heads
SCAN_SHAPES = [
    (2, 128, 4, 8, 2, 16, 32),
    (1, 64, 8, 16, 1, 32, 64),
    (2, 256, 2, 32, 2, 8, 128),
    (1, 96, 4, 64, 4, 128, 32),
    (1, 5, 4, 8, 2, 16, 1),
    (2, 37, 4, 16, 1, 16, 37),
    (1, 256, 8, 64, 1, 128, 128),
]


@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
@pytest.mark.parametrize("shape", SCAN_SHAPES,
                         ids=lambda s: "b{}l{}h{}p{}g{}n{}q{}".format(*s))
def test_ssd_scan_plain_matches_reference(shape, with_init):
    """The port's plain scan (what a CPU tensor takes, and what the card's
    kernel is held to) against the Pallas kernel in interpret mode and
    the reference's jnp oracle."""
    b, l, h, p, g, n, q = shape
    arrs, init = _scan_inputs(sum(shape), b, l, h, p, g, n, with_init)
    j_in = [jnp.asarray(arrs[k]) for k in ("x", "dt", "a", "b_mat", "c_mat")]
    t_in = [torch.from_numpy(arrs[k]) for k in ("x", "dt", "a", "b_mat",
                                                 "c_mat")]
    j_init = None if init is None else jnp.asarray(init)
    t_init = None if init is None else torch.from_numpy(init)
    yt, ft = ops.ssd_scan(*t_in, chunk_size=q, initial_state=t_init)
    for fn in (jref.ssd_scan_ref, ssd_chunk_scan):
        kw = {"interpret": True} if fn is ssd_chunk_scan else {}
        yw, fw = fn(*j_in, chunk_size=q, initial_state=j_init, **kw)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yw), **Y_TOL)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fw), **STATE_TOL)
    assert yt.dtype == torch.float32 and ft.shape == (b, h, p, n)


def _split(v: torch.Tensor):
    """An f32 tensor as bf16 hi + lo, as the tensor-core body splits it."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _round_once(v: torch.Tensor):
    """An f32 tensor rounded to bf16 once, with no lo part."""
    return v.to(torch.bfloat16).float(), torch.zeros_like(v)


def _tensor_core_replay(x, dt, a, b_mat, c_mat, chunk, init, split=_split):
    """The bf16 body of ``csrc/ssd_scan.cu`` in plain torch: per chunk,
    M' = C.B^T exp(seg_q - seg_t) dt_t selected on the causal triangle,
    then y = M'.x + exp(seg) C.S_in^T and S = exp(total) S + (x dt w)^T.B,
    with every f32 operand (M', S_in, x dt w) split into bf16 hi + lo by
    ``split`` against an exact bf16 side, f32 sums, and y rounded to bf16
    once."""
    bsz, seqlen, h, p = x.shape
    rep = h // b_mat.shape[2]
    y = torch.empty(x.shape, dtype=torch.bfloat16)
    fin = torch.empty(bsz, h, p, b_mat.shape[3])
    for bi in range(bsz):
        for hi in range(h):
            s = (init[bi, hi].clone() if init is not None
                 else torch.zeros(p, b_mat.shape[3]))
            for c0 in range(0, seqlen, chunk):
                rows = slice(c0, c0 + chunk)
                xs = x[bi, rows, hi].float()
                bm = b_mat[bi, rows, hi // rep].float()
                cm = c_mat[bi, rows, hi // rep].float()
                d = dt[bi, rows, hi]
                seg = torch.cumsum(a[hi] * d, 0)
                t = torch.arange(chunk)
                m = torch.where(t[None] <= t[:, None],
                                (cm @ bm.T) * torch.exp(seg[:, None]
                                                        - seg[None]) * d,
                                torch.zeros(()))
                m_hi, m_lo = split(m)
                s_hi, s_lo = split(s)
                yc = (m_hi @ xs + m_lo @ xs
                      + torch.exp(seg)[:, None] * (cm @ (s_hi + s_lo).T))
                y[bi, rows, hi] = yc.to(torch.bfloat16)
                xw_hi, xw_lo = split(xs * (d * torch.exp(seg[-1] - seg))[:, None])
                s = torch.exp(seg[-1]) * s + (xw_hi + xw_lo).T @ bm
            fin[bi, hi] = s
    return y, fin


@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
@pytest.mark.parametrize("shape", [(1, 384, 4, 64, 1, 128, 128),
                                   (1, 37, 4, 64, 1, 128, 37),
                                   (1, 3, 4, 64, 1, 128, 1),
                                   (2, 256, 4, 64, 2, 128, 64)],
                         ids=lambda s: "b{}l{}h{}p{}g{}n{}q{}".format(*s))
def test_ssd_tensor_core_arithmetic_meets_card_limits(shape, with_init):
    """The bf16 body's precision scheme (hi/lo splits of the f32 factors)
    against the plain scan on the same bf16 inputs, at mamba2-1.3b's
    widths, held to the limits ``chip_smoke.py`` holds the kernel to:
    y at atol/rtol 1e-2, the f32 final state at atol 1e-4 / rtol 1e-3.
    One bf16 rounding of those factors instead misses the y limit."""
    b, l, h, p, g, n, q = shape
    arrs, init = _scan_inputs(sum(shape), b, l, h, p, g, n, with_init)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("x", "b_mat", "c_mat"):
        t[k] = t[k].to(torch.bfloat16)
    t_init = None if init is None else torch.from_numpy(init)
    args = (t["x"], t["dt"], t["a"], t["b_mat"], t["c_mat"])
    yw, fw = ops.ssd_scan(*args, chunk_size=q, initial_state=t_init)
    yg, fg = _tensor_core_replay(*args, q, t_init)
    np.testing.assert_allclose(yg.float().numpy(), yw.float().numpy(),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(fg.numpy(), fw.numpy(), **STATE_TOL)


def test_ssd_single_bf16_rounding_misses_card_limits():
    """Why the tensor-core body splits its f32 factors: rounded to bf16
    once, the same arithmetic misses the y limit at mamba2-1.3b's
    widths."""
    b, l, h, p, g, n, q = 1, 384, 4, 64, 1, 128, 128
    arrs, _ = _scan_inputs(0, b, l, h, p, g, n, False)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    for k in ("x", "b_mat", "c_mat"):
        t[k] = t[k].to(torch.bfloat16)
    args = (t["x"], t["dt"], t["a"], t["b_mat"], t["c_mat"])
    yw, _ = ops.ssd_scan(*args, chunk_size=q)
    yg, _ = _tensor_core_replay(*args, q, None, split=_round_once)
    err = (yg.float() - yw.float()).abs()
    assert (err / (1e-2 + 1e-2 * yw.float().abs())).max() > 1.0


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    b, h, p, n = 3, 4, 8, 16
    arrs, init = _scan_inputs(7 + g, b, 1, h, p, g, n, True)
    args = [arrs["x"][:, 0], arrs["dt"][:, 0], arrs["a"],
            arrs["b_mat"][:, 0], arrs["c_mat"][:, 0], init]
    yw, sw = jref.ssd_decode_step_ref(*map(jnp.asarray, args))
    yt, st = ops.ssd_decode_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yw), **Y_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sw), **STATE_TOL)


def test_scan_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises; CPU tensors
    reach the plain version only through ``ops``."""
    from repro_torch.kernels.ssd_scan import ssd_chunk_scan as kernel

    arrs, _ = _scan_inputs(0, 1, 4, 2, 4, 1, 8, False)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    with pytest.raises(ValueError, match="CUDA"):
        kernel(t["x"], t["dt"], t["a"], t["b_mat"], t["c_mat"], chunk_size=4)
    ops.ssd_scan(t["x"], t["dt"], t["a"], t["b_mat"], t["c_mat"],
                 chunk_size=4)
    assert kernel.launches == 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """smoke mamba2 (2 layers, d 256, 32 heads of 16, state 16, chunk 16),
    f32, the reference's weights in both."""
    cfg = smoke_config(get_config("mamba2-1.3b")).replace(dtype="float32")
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = tsmoke(tget("mamba2-1.3b")).replace(dtype="float32")
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, shape)


def _close_state(got: dict, want: dict):
    for k in ("conv", "state"):
        np.testing.assert_allclose(got["ssm"][k].numpy(),
                                   np.asarray(want["ssm"][k]), **STATE_TOL)


def test_forward_logits_and_snapshot_match_reference(setup):
    """45 tokens: two whole chunks of 16 and a padded ragged third."""
    jm, params, tm = setup
    toks = _tokens(tm.cfg, 0, (2, 45))
    lw, _, sw = jm.forward(params, jnp.asarray(toks), collect_state=True)
    lt, st = tm.forward(torch.from_numpy(toks), collect_state=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **Y_TOL)
    assert st["ssm"]["conv"].shape == (2, 2, 3, 512 + 2 * 16)
    assert st["ssm"]["state"].dtype == torch.float32
    _close_state(st, sw)


def test_resume_from_snapshot_matches_reference(setup):
    """Forward over the first 32 tokens, then over the rest from the
    snapshot (``prefix_state``, ``q_offset=32``): the reference's result,
    and the uninterrupted forward's."""
    jm, params, tm = setup
    toks = _tokens(tm.cfg, 1, (1, 45))
    _, _, jsnap = jm.forward(params, jnp.asarray(toks[:, :32]),
                             collect_state=True)
    lw, _, sw = jm.forward(params, jnp.asarray(toks[:, 32:]), q_offset=32,
                           prefix_state=jsnap, collect_state=True)
    _, tsnap = tm.forward(torch.from_numpy(toks[:, :32]), collect_state=True)
    lt, st = tm.forward(torch.from_numpy(toks[:, 32:]), q_offset=32,
                        prefix_state=tsnap, collect_state=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **Y_TOL)
    _close_state(st, sw)
    full, fst = tm.forward(torch.from_numpy(toks), collect_state=True)
    np.testing.assert_allclose(lt.numpy(), full[:, 32:].numpy(), **Y_TOL)
    _close_state(st, {"ssm": {k: v.numpy() for k, v in fst["ssm"].items()}})


def test_prefill_scans_at_the_configured_chunk(setup, monkeypatch):
    """Every prefill scans at ``cfg.ssm_chunk``, padding a short or ragged
    sequence with dt = 0 (the reference takes ``min(chunk, seqlen)``):
    the card's scan rounds the final state by the chunk length, so a
    suffix resumed from a snapshot must run the full prefill's chunks to
    leave its state.  The logits and state still match the reference."""
    jm, params, tm = setup
    seen = []
    scan = ops.ssd_scan

    def recording_scan(*args, chunk_size, **kw):
        seen.append((args[0].shape[1], chunk_size))
        return scan(*args, chunk_size=chunk_size, **kw)

    monkeypatch.setattr(ops, "ssd_scan", recording_scan)
    toks = _tokens(tm.cfg, 3, (1, 37))
    _, snap = tm.forward(torch.from_numpy(toks[:, :32]), collect_state=True)
    lt, st = tm.forward(torch.from_numpy(toks[:, 32:]), q_offset=32,
                        prefix_state=snap, collect_state=True)
    q = tm.cfg.ssm_chunk
    assert q == 16 and seen and all(c == q and n % q == 0 for n, c in seen)
    assert {n for n, _ in seen} == {32, 16}       # 5 tokens padded to 16
    _, _, jsnap = jm.forward(params, jnp.asarray(toks[:, :32]),
                             collect_state=True)
    lw, _, sw = jm.forward(params, jnp.asarray(toks[:, 32:]), q_offset=32,
                           prefix_state=jsnap, collect_state=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **Y_TOL)
    _close_state(st, sw)


def test_decode_steps_match_reference_and_prefill(setup):
    """Decode steps from an empty cache: the reference's logits and
    cache, and the prefill logits of the same tokens (the chunked scan
    equals the token-by-token recurrence)."""
    jm, params, tm = setup
    toks = _tokens(tm.cfg, 2, (2, 6))
    jcache = jm.init_cache(2, 64)
    cache = tm.init_cache(2)
    full, _ = tm.forward(torch.from_numpy(toks))
    for t in range(toks.shape[1]):
        jl, jcache = jm.decode_step(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                                    t)
        lt = tm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(lt.numpy(), np.asarray(jl), **Y_TOL)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   **Y_TOL)
    _close_state(cache, jcache)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def make_kvc(mod):
    """The same constellation, built from ``repro.core`` or
    ``repro_torch.core``."""
    return mod.ConstellationKVC(
        mod.ConstellationSpec(15, 15, 550.0),
        mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024,
    )


def _engines(setup, *, cached: bool, **kw):
    """A reference engine and a port engine; with ``cached`` each builds
    its manager over its own package's ``ConstellationKVC``."""
    jm, params, tm = setup
    if not cached:
        return JaxEngine(jm, params, **kw), Engine(tm, device="cpu", **kw)
    return (JaxEngine(jm, params, kvc=make_kvc(J), **kw),
            Engine(tm, kvc=make_kvc(T), device="cpu", **kw))


def _run(eng, prompts, max_new, jax_side: bool):
    req, sp = ((JaxRequest, JaxSampling) if jax_side
               else (Request, SamplingParams))
    return eng.generate([req(prompt=p, sampling=sp(max_new_tokens=max_new))
                         for p in prompts])


ENGINE_KW = dict(block_size=16, max_seq_len=256, max_batch=2)


def test_engine_cold_streams_identical(setup):
    """Three prompts on two slots (two dense batches), no cache."""
    prompts = [BASE[:40], "short one", BASE * 2]
    jeng, teng = _engines(setup, cached=False, **ENGINE_KW)
    want = _run(jeng, prompts, 6, True)
    got = _run(teng, prompts, 6, False)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert teng.stats.decode_steps == jeng.stats.decode_steps > 0
    assert teng.stats.requests == 3 and not teng.paged


def test_engine_partial_snapshot_hits_identical(setup):
    """A first pass writes the snapshots back through ``kvc_fn``; on the
    second pass each prompt resumes from the longest cached block
    boundary, with at least K-1 tokens left to prefill (where the
    reference is right: see ROADMAP.md queue 3)."""
    prompts = [BASE[:69], BASE[:45] + " and a tail"]
    jeng, teng = _engines(setup, cached=True, **ENGINE_KW)
    for jax_side, eng in ((True, jeng), (False, teng)):
        _run(eng, prompts, 6, jax_side)
    want = _run(jeng, prompts, 6, True)
    got = _run(teng, prompts, 6, False)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.cached_tokens for r in got] == [r.cached_tokens for r in want]
    assert all(r.cached_tokens > 0 for r in got)
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert ts.block_hits == js.block_hits > 0
    assert ts.blocks_set == js.blocks_set > 0


def test_cached_prompt_gives_the_cold_stream(setup):
    """The invariant the reference states ("generations must be unchanged
    by the cache") for the prompts where it breaks it: a block-aligned
    prompt (64 tokens) whose every block is cached, and hits that leave
    one or two tokens to prefill (65, 66 tokens).  Served warm, each gives
    the port's own cold stream and the reference's cold stream."""
    prompts = [BASE[: n - 1] for n in (64, 65, 66)]   # + BOS
    jeng, cold = _engines(setup, cached=False, **ENGINE_KW)
    _, warm = _engines(setup, cached=True, **ENGINE_KW)
    want = [r.token_ids for r in _run(jeng, prompts, 6, True)]
    assert [r.token_ids for r in _run(cold, prompts, 6, False)] == want
    _run(warm, prompts, 6, False)
    res = _run(warm, prompts, 6, False)
    assert [r.token_ids for r in res] == want
    # the lookup leaves the last token out: 63 -> 48, 64 -> 64, 65 -> 64
    assert [r.cached_tokens for r in res] == [48, 64, 64]


def test_snapshot_payload_bytes_match_reference(setup):
    """The port encodes the reference's snapshot into the reference's
    bytes, decodes them back to the same arrays, and its ``kvc_fn``
    writes the same format with values at the state tolerance."""
    jm, params, tm = setup
    ja, ta = JaxAdapter(jm, params), SkyKVCAdapter(tm)
    toks = ByteTokenizer(tm.cfg.vocab_size).encode(BASE)[:32]
    _, _, jstate = jm.forward(params, jnp.asarray(toks)[None],
                              collect_state=True)
    jbytes = ja.state_to_payload(jstate, 32)
    tstate = {"ssm": {k: torch.from_numpy(np.array(v))
                      for k, v in jstate["ssm"].items()}}
    assert ta.state_to_payload(tstate, 32) == jbytes
    back = ta.payload_to_state(jbytes)["ssm"]
    for k in ("conv", "state"):
        np.testing.assert_array_equal(back[k].numpy(),
                                      np.asarray(jstate["ssm"][k]))
    j16, t16 = ja.kvc_fn(toks[:16], None, 0), ta.kvc_fn(toks[:16], None, 0)
    j32, t32 = ja.kvc_fn(toks, j16, 16), ta.kvc_fn(toks, j16, 16)
    for tb, jb in ((t16, j16), (t32, j32)):
        assert len(tb) == len(jb)
        for g, w in zip(tchunking.bytes_to_arrays(tb),
                        jchunking.bytes_to_arrays(jb)):
            np.testing.assert_allclose(g, w, **STATE_TOL)
    with pytest.raises(ValueError, match="not plain paged"):
        ta.payload_to_pages(jbytes, 16, 16)
