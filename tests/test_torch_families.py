"""The other paged families of the port against the reference: MoE
(granite-moe-3b-a800m), head dims 160 and 192 with LayerNorm and partial
rotary (stablelm-12b, nemotron-4-340b), the VLM backbone (llava-next-34b)
and the dense GQA configs (internlm2-1.8b, yi-9b).

Weights are the reference's ``Model.init(PRNGKey(seed))``, carried to
the port by ``params_from_numpy``; tokens, pools and activations come
from a numpy seed and feed both packages.  Every config runs its smoke
variant (2 layers, d 256, head_dim 64, 4 experts top-2), f32, on the
CPU.  Tolerances: logits f32 atol 1e-4 / rtol 1e-3, as
``test_torch_model.py`` (XLA and torch sum each matmul in another
order, through the layers); ``moe_forward``'s ``y`` and ``aux`` atol
2e-5 / rtol 2e-4, the kernels' limit (one layer of products); the
attention plain versions at the real head dims 160 and 192, the
rotary and the LayerNorm at full width, the same 2e-5 / 2e-4; the MLP
at full d_model 1e-4 / 1e-3 (a 5120- or 18432-long dot product).  The
kept-token set of capacity routing must be equal.
The granite smoke engine's greedy streams must be identical to the
reference engine's: cold, warm through each package's own
``ConstellationKVC``, and through a free-list pool that preempts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import get_config, smoke_config
from repro.kernels import ref as jref
from repro.models.model import Model as JaxModel
from repro.models.moe import moe_capacity as j_capacity
from repro.models.moe import moe_forward as j_moe
from repro.models.rope import apply_rope as j_rope
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSampling
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.models.moe import moe_capacity, moe_forward, moe_keep
from repro_torch.models.rope import apply_rope
from repro_torch.serving import Engine, Request, SamplingParams

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-3)
MOE_TOL = dict(atol=2e-5, rtol=2e-4)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-4)
NEW = ["internlm2-1.8b", "yi-9b", "stablelm-12b", "nemotron-4-340b",
       "granite-moe-3b-a800m", "llava-next-34b"]
GRANITE = "granite-moe-3b-a800m"


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _pair(name: str, seed: int = 0, **kw):
    """(reference model, its params, the port's model on them) for the
    smoke variant of ``name`` at f32, with config overrides ``kw``."""
    cfg = smoke_config(get_config(name)).replace(dtype="float32", **kw)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tcfg = tsmoke(tget(name)).replace(dtype="float32", **kw)
    tm = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def granite():
    return _pair(GRANITE)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_holds_the_new_configs():
    assert set(NEW) <= set(list_configs())
    # the paper's TinyLlama, mamba2-1.3b, the hybrid zamba2-1.2b, the
    # MLA deepseek-v3-671b and the encoder-decoder seamless-m4t-large-v2
    assert len(list_configs()) == len(NEW) + 5


@pytest.mark.parametrize("name", NEW[4:])
def test_new_families_build_on_cpu(name):
    """The MoE and VLM smoke variants build; a block of the MoE family
    holds ``moe`` in place of ``mlp``."""
    m = Model(tsmoke(tget(name)).replace(dtype="float32"), device="cpu")
    blk = m.blocks[0]
    assert hasattr(blk, "moe") != hasattr(blk, "mlp")
    assert hasattr(blk, "moe") == (name == GRANITE)


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------

def _ref_keep(params, x, cfg):
    """The reference's kept (group, token, expert) set, from its routing
    rules: f32 router, softmax, ``lax.top_k``, then the cumulative count
    of each expert in token order against the capacity."""
    b, s, d = x.shape
    t = b * s
    g = min(cfg.moe_group_size, t)
    pad = (-t) % g
    xt = jnp.pad(x.reshape(t, d), ((0, pad), (0, 0))).reshape(-1, g, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ params["router"], -1)
    _, top_i = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    member = jax.nn.one_hot(top_i, cfg.num_experts).sum(2)
    position = jnp.cumsum(member, axis=1) - 1.0
    keep = (position < j_capacity(cfg, g)) & (member > 0)
    return np.asarray(keep)


@pytest.mark.parametrize("case", [
    dict(shape=(2, 24)),                                    # smoke config
    dict(shape=(2, 64), cfg=dict(capacity_factor=0.25)),    # drops tokens
    dict(shape=(2, 50)),                                    # 100 % 64 != 0
    dict(shape=(1, 40), cfg=dict(num_shared_experts=1)),    # shared expert
    dict(shape=(8, 1), cfg=dict(num_experts=40, num_experts_per_tok=8,
                                moe_group_size=1024)),      # a decode step
], ids=["smoke", "drops", "ragged_group", "shared", "decode_rows"])
def test_moe_forward_matches_reference(case):
    jm, params, tm = _pair(GRANITE, seed=3, **case.get("cfg", {}))
    cfg = jm.cfg
    p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    x = np.random.default_rng(4).standard_normal(
        (*case["shape"], cfg.d_model)).astype(np.float32)
    jy, jaux = j_moe(p, jnp.asarray(x), cfg)
    ty, taux = moe_forward(tm.blocks[0].moe, torch.from_numpy(x), tm.cfg)
    _close(ty, jy, **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)
    want = _ref_keep(p, jnp.asarray(x), cfg)
    got = moe_keep(tm.blocks[0].moe, torch.from_numpy(x), tm.cfg)
    assert np.array_equal(got.numpy(), want)
    if "drops" in str(case):
        t = x.shape[0] * x.shape[1]
        assert want.sum() < t * cfg.num_experts_per_tok   # some dropped


def test_moe_capacity_matches_reference():
    cfg = smoke_config(get_config(GRANITE))
    tcfg = tsmoke(tget(GRANITE))
    full, tfull = get_config(GRANITE), tget(GRANITE)
    for g in (1, 8, 37, 64, 369, 1024):
        assert moe_capacity(tcfg, g) == j_capacity(cfg, g)
        assert moe_capacity(tfull, g) == j_capacity(full, g)
    assert moe_capacity(tfull, 8) == 4     # a decode step of 8 slots


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_forward_logits_match_reference(name):
    """Full-sequence logits and the collected K/V of each new config's
    smoke variant; llava-next prepends seeded image embeddings."""
    jm, params, tm = _pair(name, seed=1)
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    toks = rng.integers(3, cfg.vocab_size, (2, 24))
    jkw, tkw = {}, {}
    if cfg.arch_type == "vlm":
        img = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        jkw = dict(image_embeds=jnp.asarray(img))
        tkw = dict(image_embeds=torch.from_numpy(img))
    jl, _, js = jm.forward(params, jnp.asarray(toks), collect_state=True,
                           **jkw)
    tl, ts = tm.forward(torch.from_numpy(toks), collect_state=True, **tkw)
    assert tl.shape[1] == 24 + (cfg.num_image_tokens if jkw else 0)
    _close(tl, jl)
    _close(ts["kv"]["k"], js["kv"]["k"])
    _close(ts["kv"]["v"], js["kv"]["v"])


def _pools(cfg, n_pages, page, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, page, cfg.num_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_moe_prefill_chunk_paged(granite):
    """Two chunk rows (one mid-page) and an all-padding row: the padded
    tokens take part in the MoE group, as in the reference."""
    jm, params, tm = granite
    page = 8
    kp, vp = _pools(jm.cfg, 1 + 3 * 4, page, seed=2)
    toks = np.random.default_rng(3).integers(
        3, jm.cfg.vocab_size, (3, 16)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    offs = np.asarray([8, 5, 0], np.int32)
    valid = np.asarray([16, 11, 0], np.int32)
    jl, jk, jv = jm.prefill_chunk_paged(
        params, jnp.asarray(kp), jnp.asarray(vp), *map(jnp.asarray, (
            toks, bt, offs, valid)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl = tm.prefill_chunk_paged(tk, tv, *map(torch.from_numpy, (
        toks, bt, offs, valid)))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "free_list"])
def test_moe_decode_step_paged(granite, contiguous):
    """Every batch row, an idle one (length 0) included, is one token of
    the decode step's MoE group."""
    jm, params, tm = granite
    page, b = 8, 3
    toks = np.asarray([[7], [11], [13]], np.int32)
    lens = np.asarray([0, 9, 31], np.int32)
    if contiguous:
        kp, vp = _pools(jm.cfg, b * 4, page, seed=4)
        bt = None
    else:
        kp, vp = _pools(jm.cfg, 1 + b * 4, page, seed=5)
        bt = np.asarray([[0, 0, 0, 0], [3, 9, 0, 0], [2, 4, 6, 8]], np.int32)
    jl, jk, _ = jm.decode_step_paged(
        params, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(toks),
        None if bt is None else jnp.asarray(bt), jnp.asarray(lens),
        contiguous=contiguous)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl = tm.decode_step_paged(
        tk, tv, torch.from_numpy(toks),
        None if bt is None else torch.from_numpy(bt), torch.from_numpy(lens),
        contiguous=contiguous)
    _close(tl, jl)
    _close(tk, jk)


# ---------------------------------------------------------------------------
# the real head widths on the plain paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,hkv,d", [(8, 2, 160), (12, 1, 192)],
                         ids=["d160", "d192"])
def test_attention_plain_at_wide_heads(h, hkv, d):
    """Dense prefill, paged chunked prefill and paged decode at
    stablelm's and nemotron's head dims, against ``repro/kernels/ref.py``:
    the smoke configs run head_dim 64, so this is the CPU check of these
    widths."""
    rng = np.random.default_rng(d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    q, k, v = f(2, 20, h, d), f(2, 36, hkv, d), f(2, 36, hkv, d)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              q_offset=16)
    want = jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=True,
                              q_offset=16)
    _close(got, want, **KERNEL_TOL)
    page, n = 8, 12
    kp, vp = f(n, page, hkv, d), f(n, page, hkv, d)
    bt = rng.permutation(n)[:10].reshape(2, 5).astype(np.int32)
    offs, lens = np.asarray([5, 16], np.int32), np.asarray([25, 36], np.int32)
    qc = f(2, 20, h, d)
    got = ops.chunked_prefill_paged(*map(torch.from_numpy, (
        qc, kp, vp, lens, bt, offs)))
    want = jref.chunked_prefill_paged_ref(*map(jnp.asarray, (
        qc, kp, vp, lens, bt, offs)))
    _close(got, want, **KERNEL_TOL)
    qd = f(2, h, d)
    got = ops.paged_attention(*map(torch.from_numpy, (qd, kp, vp, lens)),
                              block_tables=torch.from_numpy(bt))
    want = jref.paged_attention_ref(*map(jnp.asarray, (qd, kp, vp, lens)),
                                    block_tables=jnp.asarray(bt))
    _close(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("name", ["stablelm-12b", "nemotron-4-340b"])
def test_norm_and_mlp_at_full_width(name):
    """LayerNorm at the full d_model (5120, 18432) and the MLP flavour
    (SwiGLU, squared ReLU) at the full d_model over a cut hidden width,
    against ``repro/models/layers.py``, on seeded scales and weights."""
    from repro.models.layers import apply_mlp as j_mlp
    from repro.models.layers import apply_norm as j_norm
    from repro_torch.models.layers import MLP, Norm
    cfg, tcfg = get_config(name), tget(name)
    d = cfg.d_model
    rng = np.random.default_rng(11)
    x = (3 * rng.standard_normal((2, 5, d)) + 1).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    norm = Norm(tcfg, "cpu")
    norm.scale.copy_(torch.from_numpy(scale))
    norm.bias.copy_(torch.from_numpy(bias))
    want = j_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                  jnp.asarray(x), cfg)
    _close(norm(torch.from_numpy(x)), want, **KERNEL_TOL)
    f = 256
    mlp = MLP(tcfg.replace(dtype="float32"), "cpu", d_ff=f)
    ws = {n: (rng.standard_normal(tuple(w.shape)) * w.shape[0] ** -0.5
              ).astype(np.float32) for n, w in mlp.named_parameters()}
    for n, w in mlp.named_parameters():
        w.copy_(torch.from_numpy(ws[n]))
    want = j_mlp({n: jnp.asarray(a) for n, a in ws.items()}, jnp.asarray(x),
                 cfg)
    _close(mlp(torch.from_numpy(x)), want, **TOL)


def test_stablelm_partial_rotary_at_full_width():
    """stablelm-12b rotates int(160 * 0.25) // 2 * 2 = 40 of its 160
    dims; the other 120 pass through."""
    cfg = tget("stablelm-12b")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 4, cfg.head_dim)).astype(np.float32)
    pos = np.arange(100, 107)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                     cfg.rope_theta, cfg.rotary_pct)
    want = j_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta,
                  cfg.rotary_pct)
    _close(got, want, **KERNEL_TOL)
    assert np.array_equal(got[..., 40:].numpy(), x[..., 40:])
    assert not np.allclose(got[..., :40].numpy(), x[..., :40])


# ---------------------------------------------------------------------------
# the engine on granite's smoke variant
# ---------------------------------------------------------------------------

PROMPT = "SkyMemory stripes KV cache chunks across LEO satellites. "


def _kvc(mod):
    return mod.ConstellationKVC(
        mod.ConstellationSpec(15, 15, 550.0),
        mod.LosWindow(mod.Sat(7, 7), 9, 9), mod.Strategy.ROTATION_HOP,
        num_servers=10, chunk_bytes=6 * 1024)


def _streams(granite, prompts, max_new, *, passes=1, kvc=False, **kw):
    """Both engines' greedy streams, pass by pass, and the engines."""
    jm, params, tm = granite
    jreqs = [JaxRequest(prompt=p, sampling=JaxSampling(max_new_tokens=max_new))
             for p in prompts]
    treqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=max_new))
             for p in prompts]
    jeng = JaxEngine(jm, params, kvc=_kvc(J) if kvc else None, **kw)
    teng = Engine(tm, kvc=_kvc(T) if kvc else None, device="cpu", **kw)
    assert not jeng.chunked and not teng.chunked   # MoE: stop-the-world
    out = []
    for _ in range(passes):
        jres, tres = jeng.generate(jreqs), teng.generate(treqs)
        out.append(([r.token_ids for r in jres], [r.token_ids for r in tres],
                    jres, tres))
    return out, jeng, teng


def test_moe_engine_cold_and_warm_streams_identical(granite):
    """Three prompts on two slots, each engine over its own package's
    constellation: the first pass is cold and writes back, the second
    restores the shared prefix and prefills only the suffix as one
    unpadded paged chunk."""
    prompts = [PROMPT * 2 + f"q{i}" for i in range(3)]
    (cold, warm), jeng, teng = _streams(
        granite, prompts, 6, passes=2, kvc=True, block_size=16,
        max_seq_len=256, max_batch=2)
    want, got, jres, tres = cold
    assert got == want
    assert all(r.cached_tokens == 0 for r in tres[:1])
    want, got, jres, tres = warm
    assert got == want
    assert [r.cached_tokens for r in tres] == [r.cached_tokens for r in jres]
    assert all(r.cached_tokens > 0 for r in tres)
    ts, js = teng.manager.cache.stats, jeng.manager.cache.stats
    assert ts.block_hits == js.block_hits > 0
    assert ts.blocks_set == js.blocks_set > 0


def test_moe_preemption_streams_identical(granite):
    """An oversubscribed free-list pool with the host cache nominally
    off: MoE offloads are pinned in the host tier, so every restore is
    bit-exact (nothing replayed) and the streams are the unconstrained
    engines' and the reference's."""
    prompts = [f"grow {i} " + "x" * 24 for i in range(4)]
    kw = dict(block_size=16, max_seq_len=256, max_batch=4)
    [(want, got, _, _)], _, _ = _streams(granite, prompts, 40, **kw)
    assert got == want
    [(jwant, tgot, _, _)], jeng, teng = _streams(
        granite, prompts, 40, num_pages=1 + 16, host_cache_pages=0, **kw)
    assert tgot == jwant == want
    assert teng.stats.preemptions == jeng.stats.preemptions > 0
    assert teng.stats.replayed_tokens == jeng.stats.replayed_tokens == 0
    assert teng.cache.free_pages == teng.cache.num_pages - 1
