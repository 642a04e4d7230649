"""The int8 KV page pool against the reference's: ``quant_kvc``,
``dequant_kvc`` and ``PagedKVCache.write_pages`` of float blocks into an
int8 pool, bitwise.

The inputs hold exact ties (values on multiples of 1/64, half a
quantization step) and values beyond the int8 range (|x| > 127/32), so
both the round-half-to-even and the clamp are exercised.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke_config
from repro.models import cache as jcache
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.models import cache as tcache

torch.set_num_threads(2)
SHAPE = (2, 3, 16, 2, 64)          # [layers, pages, page, Hkv, hd]


def _kv(seed: int, shape=SHAPE) -> np.ndarray:
    """Seeded f32 K/V: a third on multiples of 1/64 (ties), a third
    normal, a third spread over +-8 (past the clamp)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    ties = rng.integers(-300, 301, n) / 64.0
    normal = rng.standard_normal(n)
    wide = rng.uniform(-8.0, 8.0, n)
    pick = rng.integers(0, 3, n)
    x = np.choose(pick, [ties, normal, wide]).astype(np.float32)
    return x.reshape(shape)


def test_inputs_hold_ties_and_clamped_values():
    x = _kv(0)
    q = x / tcache.KVC_INT8_SCALE
    assert np.sum(np.abs(q - np.trunc(q)) == 0.5) > 100     # exact ties
    assert np.sum(np.abs(x) > 127 / 32) > 100               # clamped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kvc_bitwise(dtype):
    x = _kv(1)
    if dtype == "bfloat16":
        jx = jnp.asarray(x.astype(ml_dtypes.bfloat16))
        tx = torch.from_numpy(x).to(torch.bfloat16)
        # the same bf16 values on both sides
        np.testing.assert_array_equal(
            np.asarray(jx).astype(np.float32), tx.float().numpy())
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jcache.quant_kvc(jx))
    got = tcache.quant_kvc(tx)
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min().item() == -127 and got.max().item() == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_kvc_bitwise(dtype):
    q = np.random.default_rng(2).integers(-127, 128, SHAPE).astype(np.int8)
    want = np.asarray(jcache.dequant_kvc(jnp.asarray(q), jnp.dtype(dtype)))
    got = tcache.dequant_kvc(torch.from_numpy(q),
                             getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def _pools(num_pages):
    cfg = smoke_config(get_config("skymemory-tinyllama")).replace(
        dtype="float32", num_kv_heads=2, num_layers=2, kvc_dtype="int8")
    tcfg = tsmoke(tget("skymemory-tinyllama")).replace(
        dtype="float32", num_kv_heads=2, num_layers=2, kvc_dtype="int8")
    assert (cfg.head_dim, cfg.num_kv_heads) == (SHAPE[4], SHAPE[3])
    kw = dict(num_slots=2, page_size=SHAPE[2], max_seq_len=64,
              num_pages=num_pages)
    return (jcache.PagedKVCache(cfg, **kw),
            tcache.PagedKVCache(tcfg, device=torch.device("cpu"), **kw))


@pytest.mark.parametrize("num_pages", [None, 9],
                         ids=["contiguous", "free_list"])
def test_write_pages_into_int8_pool_bitwise(num_pages):
    """Float blocks quantized into the pool by ``write_pages``, and int8
    blocks written raw: the pools equal the reference's bit for bit."""
    jp, tp = _pools(num_pages)
    assert tp.dtype == torch.int8 and jp.dtype == jnp.int8
    for pool in (jp, tp):
        pool.ensure_capacity(0, 3 * SHAPE[2])
        pool.ensure_capacity(1, 2 * SHAPE[2])
    k, v = _kv(3), _kv(4)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    raw = tcache.quant_kvc(torch.from_numpy(_kv(5)[:, :2]))
    jp.write_pages(0, 0, jnp.asarray(k), jnp.asarray(v))
    tp.write_pages(0, 0, torch.from_numpy(k), torch.from_numpy(v))
    jkb = jnp.asarray(kb.float().numpy().astype(ml_dtypes.bfloat16))
    jp.write_pages(1, 0, jkb[:, :2], jkb[:, 1:])
    tp.write_pages(1, 0, kb[:, :2], kb[:, 1:])
    jp.write_pages(0, 1, jnp.asarray(raw.numpy()), jnp.asarray(raw.numpy()))
    tp.write_pages(0, 1, raw, raw)
    for j, t in ((jp.k_pool, tp.k_pool), (jp.v_pool, tp.v_pool)):
        assert t.dtype == torch.int8
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tp.cursors == jp.cursors
    # export is write's exact inverse on the int8 pool
    ek, ev = tp.export_pages(0, 3)
    assert ek.dtype == torch.int8
    np.testing.assert_array_equal(ek[:, 1:].numpy(), raw.numpy())
    np.testing.assert_array_equal(
        ev[:, :1].numpy(), tcache.quant_kvc(torch.from_numpy(v[:, :1])).numpy())
