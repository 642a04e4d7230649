"""The sharded serve step on four gloo ranks against the port's unsharded
``decode_step`` and the reference's.

Four ranks are spawned once for the module (``torch.multiprocessing``
over a ``FileStore``, one thread each).  Each rank builds
``launch.specs.make_plan`` for a decode shape on a ``(data, model)``
mesh, fills ``plan.model`` with the reference's ``Model.init(PRNGKey(0))``
weights through ``convert``, lays a seeded cache out by ``cache_specs``
(``distribute_cache``) and takes four greedy serve steps through
``plan.fn``.  The meshes: ``(2, 2)`` at batch 4 (the sequence over
``model``), ``(2, 2)`` at batch 1 (the sequence over both axes: four
stripes) and ``(1, 4)`` at batch 2, for the smoke variants of six
families in f32 (dense TinyLlama, MoE granite, SSM mamba2, hybrid zamba2,
MLA deepseek-v3, encoder-decoder seamless).  Beside them: TinyLlama's
16-slot ring after it has wrapped, and an int8 K/V cache.  Every case's
positions leave later stripes empty for some rows.  Meanwhile this
process runs the reference's ``decode_step`` and the port's unsharded
one from the same cache.

Bars: logits within atol 2e-5 / rtol 2e-4 of both (f32, the stripes'
merge sums in another order), greedy tokens equal to both, every rank's
logits bitwise equal, and each rank's cache shard the unsharded cache's
block after the four steps: bitwise where no step wrote, at the logits'
tolerance where one did (an int8 row within one quantization step).

The prefill plan at ``(2, 2)`` for TinyLlama and mamba2 is held to the
unsharded ``forward`` at the same tolerance (last logits and every
collected state).
"""
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT_S = 400
STEPS = 4
SEQ = 32
TOL = dict(atol=2e-5, rtol=2e-4)
FAMILIES = ["skymemory-tinyllama", "granite-moe-3b-a800m", "mamba2-1.3b",
            "zamba2-1.2b", "deepseek-v3-671b", "seamless-m4t-large-v2"]
# (mesh, batch, positions of the first step): stripes of 16, 8 and 8
# tokens; each leaves the last stripes of some rows empty
MESHES = {"2x2-b4": ((2, 2), 4, (3, 10, 17, 27)),
          "2x2-b1": ((2, 2), 1, (5,)),
          "1x4-b2": ((1, 4), 2, (2, 20))}
# (case id, arch, config overrides, mesh id, seq_len)
CASES = [(f"{a}-{m}", a, {}, m, SEQ) for a in FAMILIES for m in MESHES]
# a 16-slot ring, past its wrap (positions % 16 cross the seam)
CASES += [("skymemory-tinyllama-ring-2x2-b4", "skymemory-tinyllama",
           {"sliding_window": 16}, "2x2-b4", 64),
          ("skymemory-tinyllama-ring-2x2-b1", "skymemory-tinyllama",
           {"sliding_window": 16}, "2x2-b1", 64),
          ("skymemory-tinyllama-int8-2x2-b4", "skymemory-tinyllama",
           {"kvc_dtype": "int8"}, "2x2-b4", SEQ)]
RING_POS = {"2x2-b4": (14, 30, 45, 21), "2x2-b1": (46,)}
PREFILL_ARCHS = ["skymemory-tinyllama", "mamba2-1.3b"]
SRC_LEN = 16                                   # seamless's source frames


def _case(case_id):
    return next(c for c in CASES if c[0] == case_id)


def _positions(case_id) -> np.ndarray:
    _, _, kw, m, _ = _case(case_id)
    pos = RING_POS[m] if "sliding_window" in kw else MESHES[m][2]
    return np.asarray(pos, np.int32)


def _port_cfg(arch: str, kw: dict):
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config(arch)).replace(dtype="float32", **kw)


def _ref_cfg(arch: str, kw: dict):
    from repro.configs import get_config, smoke_config

    return smoke_config(get_config(arch)).replace(dtype="float32", **kw)


def _cache0(cfg, batch: int, seq: int, seed: int) -> dict:
    """A seeded cache of ``init_cache``'s layout, numpy: K/V, latents and
    states drawn at random (int8 K/V as integers), conv tails too."""
    from repro_torch.models.cache import init_cache

    rng = np.random.default_rng(seed)
    src = SRC_LEN if cfg.is_encoder_decoder else None
    out = {}
    for part, leaves in init_cache(cfg, batch, seq, src_len=src,
                                   device="meta").items():
        out[part] = {}
        for name, t in leaves.items():
            if t.dtype == torch.int8:
                a = rng.integers(-40, 41, t.shape).astype(np.int8)
            else:
                a = (0.5 * rng.standard_normal(t.shape)).astype(np.float32)
            out[part][name] = a
    return out


def _first_tokens(cfg, batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)


def _torch_cache(cache: dict) -> dict:
    return {p: {n: torch.from_numpy(a.copy()) for n, a in leaves.items()}
            for p, leaves in cache.items()}


def _read_cache(path: str) -> dict:
    """A cache saved as ``{"part/name": array}``, as tensors."""
    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            part, name = key.split("/")
            out.setdefault(part, {})[name] = torch.from_numpy(f[key].copy())
    return out


def _load_model(model, weights: str):
    from repro_torch.convert import fill_from_numpy
    from repro_torch.training.checkpoint import _unflatten

    with np.load(weights) as f:
        return fill_from_numpy(model, _unflatten(dict(f)))


def _decode_shape(seq: int, batch: int):
    from repro_torch.configs import InputShape

    return InputShape("decode", seq, batch, "decode")


def _rank(rank: int, world: int, store_path: str, tmp: str) -> None:
    """One gloo rank: every serve case, then the prefill plans."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import InputShape
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_rules
    from repro_torch.launch.specs import make_plan

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        out = {}
        meshes = {m: init_device_mesh("cpu", m,
                                      mesh_dim_names=("data", "model"))
                  for m in {v[0] for v in MESHES.values()}}
        for case, arch, kw, m, seq in CASES:
            mshape, batch, _ = MESHES[m]
            cfg = _port_cfg(arch, kw)
            shape = _decode_shape(seq, batch)
            rules = make_rules(meshes[mshape], cfg, shape)
            plan = make_plan(cfg, shape, rules, device="cpu")
            _load_model(plan.model, os.path.join(tmp, f"{arch}.npz"))
            cache = _read_cache(os.path.join(tmp, f"{case}-cache.npz"))
            cache = S.distribute_cache(cache, rules, batch=batch)
            tokens = torch.from_numpy(_first_tokens(cfg, batch, 0))
            pos = torch.from_numpy(_positions(case))
            logits, toks = [], []
            for _ in range(STEPS):
                lg, cache = plan.fn(cache, tokens, pos)
                lg = S.whole(lg)
                logits.append(lg.numpy().copy())
                tokens = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
                toks.append(tokens.numpy().copy())
                pos = pos + 1
            out[f"{case}/logits"] = np.stack(logits)
            out[f"{case}/tokens"] = np.stack(toks)
            for p, leaves in cache.items():
                for n, t in leaves.items():
                    out[f"{case}/shard/{p}/{n}"] = t.to_local().numpy().copy()
                    out[f"{case}/placements/{p}/{n}"] = np.array(
                        [repr(pl) for pl in t.placements])
        for arch in PREFILL_ARCHS:
            cfg = _port_cfg(arch, {})
            shape = InputShape("prefill", 24, 4, "prefill")
            rules = make_rules(meshes[(2, 2)], cfg, shape)
            plan = make_plan(cfg, shape, rules, device="cpu")
            _load_model(plan.model, os.path.join(tmp, f"{arch}.npz"))
            tokens = torch.from_numpy(np.load(
                os.path.join(tmp, f"{arch}-prompt.npy")))
            last, state = plan.fn({"tokens": tokens})
            out[f"prefill/{arch}/last"] = S.whole(last).numpy()
            for p, leaves in state.items():
                for n, t in leaves.items():
                    out[f"prefill/{arch}/{p}/{n}"] = S.whole(t).numpy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _reference_steps(arch, kw, cache0, tokens0, pos0, tree):
    """Four greedy steps of the reference's ``decode_step``."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import Model as JaxModel

    model = JaxModel(_ref_cfg(arch, kw))
    step = jax.jit(model.decode_step)
    cache = jax.tree.map(jnp.asarray, cache0)
    tokens, pos = jnp.asarray(tokens0), jnp.asarray(pos0)
    logits, toks = [], []
    for _ in range(STEPS):
        lg, cache = step(tree, cache, tokens, pos)
        logits.append(np.asarray(lg))
        tokens = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tokens))
        pos = pos + 1
    return np.stack(logits), np.stack(toks)


def _port_steps(model, cache, tokens0, pos0):
    """Four greedy steps of the port's unsharded ``decode_step``; the
    cache is updated in place."""
    tokens, pos = torch.from_numpy(tokens0), torch.from_numpy(pos0)
    logits, toks = [], []
    for _ in range(STEPS):
        lg = model.decode_step(cache, tokens, pos)
        logits.append(lg.numpy().copy())
        tokens = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
        toks.append(tokens.numpy().copy())
        pos = pos + 1
    return np.stack(logits), np.stack(toks)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and this process's reference and unsharded
    port runs: ``(ranks, reference, unsharded, prefill)``."""
    import jax

    from repro.models.model import Model as JaxModel
    from repro_torch.convert import params_from_numpy
    from repro_torch.training.checkpoint import _flatten

    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("mesh_serve")
    trees = {}
    for arch in FAMILIES:
        tree = jax.tree.map(np.asarray, JaxModel(_ref_cfg(arch, {})).init(
            jax.random.PRNGKey(0)))
        trees[arch] = tree
        np.savez(tmp / f"{arch}.npz", **_flatten(tree))
    caches = {}
    for i, (case, arch, kw, m, seq) in enumerate(CASES):
        cfg = _port_cfg(arch, kw)
        caches[case] = _cache0(cfg, MESHES[m][1], seq, seed=i)
        np.savez(tmp / f"{case}-cache.npz",
                 **{f"{p}/{n}": a for p, leaves in caches[case].items()
                    for n, a in leaves.items()})
    prompts = {}
    for arch in PREFILL_ARCHS:
        prompts[arch] = np.random.default_rng(7).integers(
            0, _port_cfg(arch, {}).vocab_size, (4, 24)).astype(np.int32)
        np.save(tmp / f"{arch}-prompt.npy", prompts[arch])

    ctx = torch.multiprocessing.start_processes(
        _rank, args=(WORLD, str(tmp / "store"), str(tmp)), nprocs=WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        reference, unsharded, prefill = {}, {}, {}
        models = {}
        for case, arch, kw, m, seq in CASES:
            cfg = _port_cfg(arch, kw)
            tokens0 = _first_tokens(cfg, MESHES[m][1], 0)
            pos0 = _positions(case)
            reference[case] = _reference_steps(arch, kw, caches[case],
                                               tokens0, pos0, trees[arch])
            key = (arch, tuple(sorted(kw.items())))
            if key not in models:
                models[key] = params_from_numpy(cfg, trees[arch],
                                                device="cpu")
            cache = _torch_cache(caches[case])
            unsharded[case] = (*_port_steps(models[key], cache, tokens0,
                                            pos0), cache)
        for arch in PREFILL_ARCHS:
            model = params_from_numpy(_port_cfg(arch, {}), trees[arch],
                                      device="cpu")
            with torch.no_grad():
                logits, state = model.forward(
                    torch.from_numpy(prompts[arch]), collect_state=True)
            prefill[arch] = (logits[:, -1:].numpy(),
                             {(p, n): t.numpy() for p, leaves in state.items()
                              for n, t in leaves.items()})
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [np.load(tmp / f"rank{r}.npz") for r in range(WORLD)]
    return ranks, reference, unsharded, prefill


def _block(rank: int, mshape, placements: list, shape) -> tuple:
    """The slice of a global leaf that rank ``rank`` of a ``(data,
    model)`` mesh of ``mshape`` holds under ``placements`` (reprs, one per
    mesh axis; two axes on one dim split it data-major)."""
    coords = (rank // mshape[1], rank % mshape[1])
    index = [0] * len(shape)
    count = [1] * len(shape)
    for axis, pl in enumerate(placements):
        if pl.startswith("Shard"):
            d = int(pl.split("=")[1].rstrip(")"))
            index[d] = index[d] * mshape[axis] + coords[axis]
            count[d] *= mshape[axis]
    return tuple(slice(i * (n // c), (i + 1) * (n // c))
                 for i, c, n in zip(index, count, shape))


@pytest.mark.parametrize("case_id", [c[0] for c in CASES])
def test_sharded_serve_steps_equal_unsharded_and_reference(runs, case_id):
    ranks, reference, unsharded, _ = runs
    got = ranks[0][f"{case_id}/logits"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{case_id}/logits"], got)
        np.testing.assert_array_equal(r[f"{case_id}/tokens"],
                                      ranks[0][f"{case_id}/tokens"])
    t_logits, t_tokens, _ = unsharded[case_id]
    j_logits, j_tokens = reference[case_id]
    np.testing.assert_allclose(got, t_logits, **TOL)
    np.testing.assert_allclose(got, j_logits, **TOL)
    np.testing.assert_array_equal(ranks[0][f"{case_id}/tokens"], t_tokens)
    np.testing.assert_array_equal(ranks[0][f"{case_id}/tokens"], j_tokens)


def _written(case_id, part: str, shape) -> np.ndarray:
    """Where the four steps wrote into a global cache leaf: every slot a
    row's new K/V (or latent) landed in, and the whole SSM state and conv
    tail; nothing of the cross K/V."""
    _, _, kw, _, _ = _case(case_id)
    mask = np.zeros(shape, bool)
    if part == "ssm":
        mask[:] = True
    elif part != "cross":
        s = shape[2]
        for b, p0 in enumerate(_positions(case_id)):
            for t in range(STEPS):
                slot = (p0 + t) % s if "sliding_window" in kw else p0 + t
                if slot < s:
                    mask[:, b, slot] = True
    return mask


@pytest.mark.parametrize("case_id", [c[0] for c in CASES])
def test_each_rank_holds_its_block_of_the_unsharded_cache(runs, case_id):
    """After the steps, every rank's shard of every cache leaf is the
    unsharded cache's block at that rank's coordinates: bitwise wherever
    no step wrote, and within the logits' tolerance where one did (the
    K/V of layers past the first follow the merged attention output,
    which sums the stripes in another order), and the sequence of every
    K/V and latent leaf is striped."""
    ranks, _, unsharded, _ = runs
    _, _, _, m, _ = _case(case_id)
    mshape = MESHES[m][0]
    cache = unsharded[case_id][2]
    striped = 0
    for p, leaves in cache.items():
        for n, t in leaves.items():
            full = t.numpy()
            written = _written(case_id, p, full.shape)
            pls = list(ranks[0][f"{case_id}/placements/{p}/{n}"])
            striped += any(pl == "Shard(dim=2)" for pl in pls)
            for r, rk in enumerate(ranks):
                block = _block(r, mshape, pls, full.shape)
                got, want = rk[f"{case_id}/shard/{p}/{n}"], full[block]
                what = f"{case_id} rank {r} {p}/{n}"
                keep = ~written[block]
                np.testing.assert_array_equal(got[keep], want[keep],
                                              err_msg=what)
                np.testing.assert_allclose(got.astype(np.float32),
                                           want.astype(np.float32),
                                           err_msg=what,
                                           **(TOL if want.dtype != np.int8
                                              else dict(atol=1, rtol=0)))
    assert striped > 0 or "mamba2" in case_id


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_plan_equals_unsharded_forward(runs, arch):
    ranks, _, _, prefill = runs
    last, state = prefill[arch]
    for r in ranks:
        np.testing.assert_allclose(r[f"prefill/{arch}/last"], last, **TOL)
        for (p, n), want in state.items():
            np.testing.assert_allclose(r[f"prefill/{arch}/{p}/{n}"], want,
                                       **TOL)
