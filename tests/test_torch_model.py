"""The port's dense model against the reference, on converted weights.

The reference ``Model.init(PRNGKey(s))`` weights go to the port through
``params_from_numpy``; tokens and page pools come from a numpy seed and
feed both.  Tolerance: atol 1e-4 / rtol 1e-3 at f32 -- looser than the
kernels' because XLA and torch sum each matmul in a different order,
and those differences accumulate through the layers to the logits.
Configs: the TinyLlama smoke config (2 layers, d 256, 4 query heads over
4 kv heads) and a ``num_kv_heads=2`` variant, which exercises GQA
grouping end to end.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models.model import Model as JaxModel
from repro_torch.convert import params_from_numpy

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-3)
KV_HEADS = [4, 2]


def _models(kv_heads: int, kvc_dtype: str = ""):
    cfg = smoke_config(get_config("skymemory-tinyllama")).replace(
        dtype="float32", num_kv_heads=kv_heads, kvc_dtype=kvc_dtype)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(kv_heads))
    tm = params_from_numpy(port_cfg(cfg), jax.tree.map(np.asarray, params),
                           device="cpu")
    return cfg, jm, params, tm


def port_cfg(cfg):
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import smoke_config as tsmoke
    return tsmoke(tget("skymemory-tinyllama")).replace(
        dtype=cfg.dtype, num_kv_heads=cfg.num_kv_heads,
        kvc_dtype=cfg.kvc_dtype)


@pytest.fixture(scope="module", params=KV_HEADS, ids=lambda k: f"kv{k}")
def models(request):
    return _models(request.param)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def test_port_config_matches_reference():
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import smoke_config as tsmoke
    ref = get_config("skymemory-tinyllama")
    assert asdict(tget("skymemory-tinyllama")) == asdict(ref)
    assert asdict(tsmoke(tget("skymemory-tinyllama"))) == \
        asdict(smoke_config(ref))


def test_forward_logits_and_state(models):
    cfg, jm, params, tm = models
    toks = np.random.default_rng(0).integers(3, cfg.vocab_size, (2, 24))
    jl, _, js = jm.forward(params, jnp.asarray(toks), collect_state=True)
    tl, ts = tm.forward(torch.from_numpy(toks), collect_state=True)
    _close(tl, jl)
    _close(ts["kv"]["k"], js["kv"]["k"])
    _close(ts["kv"]["v"], js["kv"]["v"])


def test_forward_with_prefix_state(models):
    """Resuming from a prefix state at ``q_offset`` (the write-back
    path's dense flash call with a non-zero offset) gives the reference's
    logits, and the same logits as the full-sequence forward."""
    cfg, jm, params, tm = models
    toks = np.random.default_rng(1).integers(3, cfg.vocab_size, (1, 40))
    _, _, js = jm.forward(params, jnp.asarray(toks[:, :16]),
                          collect_state=True)
    prefix = {"kv": {"k": torch.from_numpy(np.array(js["kv"]["k"])),
                     "v": torch.from_numpy(np.array(js["kv"]["v"]))}}
    jl, _, js2 = jm.forward(params, jnp.asarray(toks[:, 16:]), q_offset=16,
                            prefix_state=js, collect_state=True)
    tl, ts2 = tm.forward(torch.from_numpy(toks[:, 16:]), q_offset=16,
                         prefix_state=prefix, collect_state=True)
    _close(tl, jl)
    _close(ts2["kv"]["k"], js2["kv"]["k"])
    full, _ = tm.forward(torch.from_numpy(toks))
    _close(tl, full[:, 16:])


def _pools(cfg, n_pages, page, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, page, cfg.num_kv_heads, cfg.head_dim)
    if dtype == np.int8:
        return (rng.integers(-60, 60, shape).astype(np.int8),
                rng.integers(-60, 60, shape).astype(np.int8))
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _check_paged(jm, params, tm, kp, vp, call):
    """Run ``call`` on both models over copies of the same pools; compare
    outputs and the pools the step wrote."""
    jout = call("jax", jm, params, jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tout = call("torch", tm, None, tk, tv)
    jl, jk, jv = jout
    _close(tout, jl)
    if kp.dtype == np.int8:
        # a rounding step in quantization may differ by one code
        assert np.abs(tk.numpy().astype(int) - np.asarray(jk)).max() <= 1
        assert np.abs(tv.numpy().astype(int) - np.asarray(jv)).max() <= 1
    else:
        _close(tk, jk)
        _close(tv, jv)


def _prefill_call(toks, bt, offs, valid):
    def call(which, m, params, kp, vp):
        if which == "jax":
            return m.prefill_chunk_paged(
                params, kp, vp, jnp.asarray(toks), jnp.asarray(bt),
                jnp.asarray(offs), jnp.asarray(valid))
        return m.prefill_chunk_paged(
            kp, vp, torch.from_numpy(toks), torch.from_numpy(bt),
            torch.from_numpy(offs), torch.from_numpy(valid))
    return call


def test_prefill_chunk_paged(models):
    """Two chunk rows at runtime offsets (one mid-page) plus an
    all-padding row whose writes must be dropped."""
    cfg, jm, params, tm = models
    page, p_max = 8, 4
    kp, vp = _pools(cfg, 1 + 3 * p_max, page, seed=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(3, cfg.vocab_size, (3, 16)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    offs = np.asarray([8, 5, 0], np.int32)
    valid = np.asarray([16, 11, 0], np.int32)
    _check_paged(jm, params, tm, kp, vp, _prefill_call(toks, bt, offs, valid))


def _decode_call(toks, bt, lens, contiguous):
    def call(which, m, params, kp, vp):
        if which == "jax":
            return m.decode_step_paged(
                params, kp, vp, jnp.asarray(toks),
                None if bt is None else jnp.asarray(bt), jnp.asarray(lens),
                contiguous=contiguous)
        return m.decode_step_paged(
            kp, vp, torch.from_numpy(toks),
            None if bt is None else torch.from_numpy(bt),
            torch.from_numpy(lens), contiguous=contiguous)
    return call


@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "free_list"])
def test_decode_step_paged(models, contiguous):
    cfg, jm, params, tm = models
    page, p_max, b = 8, 4, 3
    toks = np.asarray([[7], [11], [13]], np.int32)
    lens = np.asarray([0, 9, 31], np.int32)
    if contiguous:
        kp, vp = _pools(cfg, b * p_max, page, seed=4)
        bt = None
    else:
        kp, vp = _pools(cfg, 1 + b * p_max, page, seed=5)
        bt = np.asarray([[0, 0, 0, 0], [3, 9, 0, 0], [2, 4, 6, 8]], np.int32)
    _check_paged(jm, params, tm, kp, vp,
                 _decode_call(toks, bt, lens, contiguous))


def test_int8_kvc_pool_paths():
    """An int8 pool quantizes on write (fixed 1/32 scale) and dequantizes
    the pool before attention, as the reference does."""
    cfg, jm, params, tm = _models(2, kvc_dtype="int8")
    page, p_max = 8, 3
    kp, vp = _pools(cfg, 1 + 2 * p_max, page, seed=6, dtype=np.int8)
    toks = np.asarray([[5], [9]], np.int32)
    bt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    lens = np.asarray([4, 20], np.int32)
    _check_paged(jm, params, tm, kp, vp, _decode_call(toks, bt, lens, False))
    ctoks = np.random.default_rng(7).integers(
        3, cfg.vocab_size, (2, 8)).astype(np.int32)
    _check_paged(jm, params, tm, kp, vp, _prefill_call(
        ctoks, bt, np.asarray([0, 10], np.int32),
        np.asarray([8, 6], np.int32)))


def test_init_draws_the_reference_distribution():
    """``Model.init`` draws truncated-normal fan-in weights: same support
    (+-2 std) and spread as the reference init, ones for norm scales."""
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import smoke_config as tsmoke
    from repro_torch.models.model import Model
    cfg = tsmoke(tget("skymemory-tinyllama")).replace(dtype="float32")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    w = m.blocks[0].mlp.wi_gate
    std = cfg.d_model ** -0.5
    assert w.abs().max().item() <= 2 * std + 1e-6
    assert abs(w.std().item() / std - 0.8796) < 0.02   # std of N cut at 2
    assert torch.equal(m.blocks[1].norm1.scale, torch.ones(cfg.d_model))
    m2 = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(m2.embed.tok, m.embed.tok)      # seeded: repeatable
