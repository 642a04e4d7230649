"""Sharded plans whose head count does not divide the mesh axes, on four
gloo ranks and on fake worlds.

The reference shards a projection's flat out-dim wherever it divides,
which cuts heads when the head count does not divide ``model`` (3 heads
of 64 over 2 ranks), and XLA reshards the head split.  The port's head
splits and merges (``sharding.split_heads`` / ``merge_heads``) gather
the axes that cut heads, in the forward and for the gradient.

Four ranks are spawned once for the module (``torch.multiprocessing``
over a ``FileStore``, one thread each) on a ``(data, model)`` mesh of
``(2, 2)``, where neither axis divides 3 heads:

* 3 AdamW steps of ``train(..., rules=make_rules(...))`` for the f32
  smoke variants of TinyLlama, granite-moe-3b-a800m, llava-next-34b and
  deepseek-v3-671b with 3 heads (1 K/V head) and of mamba2-1.3b with 3
  SSM heads (``ssm_head_dim`` 32, ``d_model`` 48), from the reference's
  ``Model.init(PRNGKey(0))`` weights, held to the port's unsharded run
  and the reference's ``train`` at ``test_torch_mesh_train.py``'s
  tolerances and AdamW element bound (that module's docstring);
* four greedy serve steps of deepseek-v3's and mamba2's ``make_plan``
  at batch 4 (the cache's sequence over ``model``), held to the
  unsharded and the reference's ``decode_step`` at
  ``test_torch_mesh_serve.py``'s tolerances, and deepseek-v3's prefill
  plan to the unsharded ``forward``;
* bf16 decode attention over a cache striped into 2 and 4 stripes: the
  kernel's partials come in f32 (``paged_attention(out_dtype=f32)``) and
  the merge rounds once, so the merged output is no further from an f32
  attention over the whole cache than a merge of bf16 partials.

A host test counts (``launch.specs.lower_plan`` on ``fake_world``) the
train step, the prefill plan and the serve step of one config of each
family at ``(2, 2)`` with 3 heads, all in one child process.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 400
MESH = (2, 2)
STEPS = 3
TOL = dict(atol=2e-5, rtol=2e-4)
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=STEPS)
DATA = dict(seq_len=32, batch_size=4, seed=1)
HEADS3 = {"num_heads": 3, "num_kv_heads": 1}
SSM3 = {"d_model": 48, "ssm_head_dim": 32}
# arch -> config overrides: 3 heads, or 3 SSM heads
MODELS = {"skymemory-tinyllama": HEADS3, "granite-moe-3b-a800m": HEADS3,
          "llava-next-34b": HEADS3, "deepseek-v3-671b": HEADS3,
          "mamba2-1.3b": SSM3}
SERVE_ARCHS = ["deepseek-v3-671b", "mamba2-1.3b"]
PREFILL_ARCHS = ["deepseek-v3-671b"]
SERVE_STEPS = 4
SERVE_SEQ = 32
SERVE_POS = (3, 10, 17, 27)        # stripes of 16: rows leave the last empty
PROMPT = (4, 24)
# the host counts: one config of each family
COUNT_MODELS = {**MODELS, "zamba2-1.2b": {**HEADS3, **SSM3},
                "seamless-m4t-large-v2": HEADS3}
COUNT_KINDS = ["train", "prefill", "decode"]
STRIPES = {2: ("model",), 4: ("data", "model")}


def _port_cfg(arch: str):
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config(arch)).replace(dtype="float32",
                                                  **MODELS[arch])


def _ref_cfg(arch: str):
    from repro.configs import get_config, smoke_config

    return smoke_config(get_config(arch)).replace(dtype="float32",
                                                  **MODELS[arch])


def _metrics(history) -> np.ndarray:
    keys = ("ce", "aux", "loss", "grad_norm", "lr")
    return np.array([[h[k] for k in keys] for h in history])


def _dataset(cfg):
    from repro_torch.training import DataConfig, make_dataset

    return make_dataset(DataConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        num_image_tokens=cfg.num_image_tokens,
        is_encoder_decoder=cfg.is_encoder_decoder,
        arch_type=cfg.arch_type, **DATA))


def _tree(weights: str):
    from repro_torch.training.checkpoint import _unflatten

    with np.load(weights) as f:
        return _unflatten(dict(f))


def _cache0(cfg, seed: int) -> dict:
    """A seeded f32 cache of ``init_cache``'s layout, numpy."""
    from repro_torch.models.cache import init_cache

    rng = np.random.default_rng(seed)
    return {part: {name: (0.5 * rng.standard_normal(t.shape)).astype(
        np.float32) for name, t in leaves.items()}
        for part, leaves in init_cache(cfg, len(SERVE_POS), SERVE_SEQ,
                                       device="meta").items()}


def _first_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (len(SERVE_POS), 1)).astype(np.int32)


def _prompt(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, PROMPT).astype(np.int32)


def _striped_attention(mesh) -> dict:
    """bf16 decode attention over a cache striped 2 and 4 ways: the
    merge of f32 partials (``attention._decode_attend``) and of bf16
    partials, and an f32 attention over the whole cache."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.decode import run_striped
    from repro_torch.kernels import ref
    from repro_torch.models import attention as A

    g = torch.Generator().manual_seed(3)
    b, s, h, hkv, d = 4, 256, 8, 2, 64
    q = torch.randn(b, 1, h, d, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, generator=g).to(torch.bfloat16)
    n_valid = torch.tensor([256, 200, 97, 33], dtype=torch.int32)
    whole = ref.paged_attention_ref(
        q[:, 0].float(), k.float()[:, None], v.float()[:, None], n_valid)
    out = {"whole": whole.numpy()}
    for count, axes in STRIPES.items():
        pls = [Shard(1) if n in axes else Replicate()
               for n in mesh.mesh_dim_names]
        kd, vd = (distribute_tensor(t, mesh, pls, src_data_rank=None)
                  for t in (k, v))
        qd = distribute_tensor(q, mesh, [Replicate()] * 2,
                               src_data_rank=None)

        def bf16_partials(st, ql, kl, vl):
            lengths = torch.clamp(n_valid - st.start, 0, kl.shape[1])
            return A._paged(ql[:, 0].contiguous(), kl, vl,
                            lengths.to(torch.int32), return_lse=True)

        out[f"f32/{count}"] = A._decode_attend(
            qd, kd, vd, n_valid).full_tensor().float().numpy()
        out[f"bf16/{count}"] = run_striped(
            bf16_partials, (qd,), (kd, vd)).full_tensor().float().numpy()
    return out


def _rank(rank: int, world: int, store_path: str, tmp: str) -> None:
    """One gloo rank: the train cases, the serve and prefill plans, the
    striped bf16 attention."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import INPUT_SHAPES, InputShape
    from repro_torch.convert import fill_from_numpy, params_from_numpy
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_rules
    from repro_torch.launch.specs import make_plan
    from repro_torch.training import AdamWConfig, TrainConfig, train

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        out = {}
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        for arch in MODELS:
            cfg = _port_cfg(arch)
            tree = _tree(os.path.join(tmp, f"{arch}.npz"))
            model = params_from_numpy(cfg, tree, device="cpu")
            rules = make_rules(mesh, cfg, INPUT_SHAPES["train_4k"])
            model, _, hist = train(
                model, _dataset(cfg),
                TrainConfig(opt=AdamWConfig(**OPT), log_every=1),
                num_steps=STEPS, rules=rules)
            out[f"train/{arch}/metrics"] = _metrics(hist)
            for name, p in model.named_parameters():
                full = S.whole(p).detach().numpy()
                if rank == 0:
                    out[f"train/{arch}/p/{name}"] = full
        for arch in SERVE_ARCHS:
            cfg = _port_cfg(arch)
            shape = InputShape("decode", SERVE_SEQ, len(SERVE_POS), "decode")
            rules = make_rules(mesh, cfg, shape)
            plan = make_plan(cfg, shape, rules, device="cpu")
            fill_from_numpy(plan.model, _tree(os.path.join(tmp,
                                                           f"{arch}.npz")))
            cache = {p: {n: torch.from_numpy(a.copy())
                         for n, a in leaves.items()}
                     for p, leaves in _cache0(cfg, 0).items()}
            cache = S.distribute_cache(cache, rules, batch=len(SERVE_POS))
            tokens = torch.from_numpy(_first_tokens(cfg))
            pos = torch.tensor(SERVE_POS, dtype=torch.int32)
            logits, toks = [], []
            for _ in range(SERVE_STEPS):
                lg, cache = plan.fn(cache, tokens, pos)
                lg = S.whole(lg)
                logits.append(lg.numpy().copy())
                tokens = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
                toks.append(tokens.numpy().copy())
                pos = pos + 1
            out[f"serve/{arch}/logits"] = np.stack(logits)
            out[f"serve/{arch}/tokens"] = np.stack(toks)
        for arch in PREFILL_ARCHS:
            cfg = _port_cfg(arch)
            shape = InputShape("prefill", PROMPT[1], PROMPT[0], "prefill")
            rules = make_rules(mesh, cfg, shape)
            plan = make_plan(cfg, shape, rules, device="cpu")
            fill_from_numpy(plan.model, _tree(os.path.join(tmp,
                                                           f"{arch}.npz")))
            last, state = plan.fn({"tokens": torch.from_numpy(_prompt(cfg))})
            out[f"prefill/{arch}/last"] = S.whole(last).numpy()
            for p, leaves in state.items():
                for n, t in leaves.items():
                    out[f"prefill/{arch}/{p}/{n}"] = S.whole(t).numpy()
        for key, a in _striped_attention(mesh).items():
            out[f"striped/{key}"] = a
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _reference_serve(arch, tree, cache0, tokens0):
    import jax
    import jax.numpy as jnp

    from repro.models.model import Model as JaxModel

    step = jax.jit(JaxModel(_ref_cfg(arch)).decode_step)
    cache = jax.tree.map(jnp.asarray, cache0)
    tokens = jnp.asarray(tokens0)
    pos = jnp.asarray(SERVE_POS, jnp.int32)
    logits, toks = [], []
    for _ in range(SERVE_STEPS):
        lg, cache = step(tree, cache, tokens, pos)
        logits.append(np.asarray(lg))
        tokens = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tokens))
        pos = pos + 1
    return np.stack(logits), np.stack(toks)


def _port_serve(model, cache0, tokens0):
    cache = {p: {n: torch.from_numpy(a.copy()) for n, a in leaves.items()}
             for p, leaves in cache0.items()}
    tokens = torch.from_numpy(tokens0)
    pos = torch.tensor(SERVE_POS, dtype=torch.int32)
    logits, toks = [], []
    for _ in range(SERVE_STEPS):
        lg = model.decode_step(cache, tokens, pos)
        logits.append(lg.numpy().copy())
        tokens = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
        toks.append(tokens.numpy().copy())
        pos = pos + 1
    return np.stack(logits), np.stack(toks)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and this process's reference and unsharded port
    runs: ``(ranks, reference, unsharded)``, each run keyed by
    ``(what, arch)``."""
    import jax

    from repro.models.model import Model as JaxModel
    from repro.training import data as jdata
    from repro.training import loop as jloop
    from repro.training import optimizer as jopt
    from repro_torch.convert import params_from_numpy
    from repro_torch.training import AdamWConfig, TrainConfig, train
    from repro_torch.training.checkpoint import _flatten

    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("mesh_uneven")
    trees = {}
    for arch in MODELS:
        trees[arch] = jax.tree.map(np.asarray, JaxModel(_ref_cfg(arch)).init(
            jax.random.PRNGKey(0)))
        np.savez(tmp / f"{arch}.npz", **_flatten(trees[arch]))

    ctx = torch.multiprocessing.start_processes(
        _rank, args=(WORLD, str(tmp / "store"), str(tmp)), nprocs=WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        reference, unsharded = {}, {}
        for arch, tree in trees.items():
            cfg = _ref_cfg(arch)
            dcfg = jdata.DataConfig(
                vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                num_image_tokens=cfg.num_image_tokens,
                is_encoder_decoder=cfg.is_encoder_decoder,
                arch_type=cfg.arch_type, **DATA)
            jp, _, jh = jloop.train(
                JaxModel(cfg), jdata.make_dataset(dcfg),
                jloop.TrainConfig(opt=jopt.AdamWConfig(**OPT), log_every=1),
                num_steps=STEPS, seed=0)
            reference["train", arch] = (_metrics(jh),
                                        jax.tree.map(np.asarray, jp))
            tcfg = _port_cfg(arch)
            model, _, th = train(
                params_from_numpy(tcfg, tree, device="cpu"), _dataset(tcfg),
                TrainConfig(opt=AdamWConfig(**OPT), log_every=1),
                num_steps=STEPS)
            unsharded["train", arch] = (_metrics(th), {
                n: p.detach().numpy().copy()
                for n, p in model.named_parameters()}, model)
        for arch in SERVE_ARCHS:
            cfg = _port_cfg(arch)
            cache0, tokens0 = _cache0(cfg, 0), _first_tokens(cfg)
            reference["serve", arch] = _reference_serve(arch, trees[arch],
                                                        cache0, tokens0)
            model = params_from_numpy(cfg, trees[arch], device="cpu")
            unsharded["serve", arch] = _port_serve(model, cache0, tokens0)
        for arch in PREFILL_ARCHS:
            cfg = _port_cfg(arch)
            model = params_from_numpy(cfg, trees[arch], device="cpu")
            with torch.no_grad():
                logits, state = model.forward(
                    torch.from_numpy(_prompt(cfg)), collect_state=True)
            unsharded["prefill", arch] = (
                logits[:, -1:].numpy(),
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
    return ranks, reference, unsharded


def _lr_sum() -> float:
    from repro_torch.training.optimizer import AdamWConfig, lr_at

    return sum(float(lr_at(AdamWConfig(**OPT), s))
               for s in range(1, STEPS + 1))


def _close_params(got: np.ndarray, want: np.ndarray, what) -> None:
    """``got`` equals ``want`` at ``TOL`` but for AdamW's near-zero
    gradient elements (``test_torch_mesh_train.py``'s docstring)."""
    diff = np.abs(got - want)
    off = diff > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert off.sum() <= 1e-3 * off.size + 2, (what, int(off.sum()))
    assert (diff <= 2 * _lr_sum()).all(), (what, float(diff.max()))
    assert (np.linalg.norm(got - want)
            <= 1e-3 * np.linalg.norm(want) + 1e-12), what


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", list(MODELS))
def test_uneven_heads_train_equal_unsharded_and_reference(runs, arch):
    from repro_torch.convert import locations

    ranks, reference, unsharded = runs
    got = ranks[0][f"train/{arch}/metrics"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"train/{arch}/metrics"], got)
    t_metrics, t_params, model = unsharded["train", arch]
    j_metrics, j_params = reference["train", arch]
    np.testing.assert_allclose(got, t_metrics, **TOL)
    np.testing.assert_allclose(got, j_metrics, **TOL)
    for name, (path, layer) in locations(model).items():
        p = ranks[0][f"train/{arch}/p/{name}"]
        _close_params(p, t_params[name], (arch, name, "port"))
        want = _leaf(j_params, path)
        _close_params(p, want if layer is None else want[layer],
                      (arch, name, "reference"))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_uneven_heads_serve_steps_equal_unsharded_and_reference(runs, arch):
    ranks, reference, unsharded = runs
    got = ranks[0][f"serve/{arch}/logits"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"serve/{arch}/logits"], got)
    t_logits, t_tokens = unsharded["serve", arch]
    j_logits, j_tokens = reference["serve", arch]
    np.testing.assert_allclose(got, t_logits, **TOL)
    np.testing.assert_allclose(got, j_logits, **TOL)
    np.testing.assert_array_equal(ranks[0][f"serve/{arch}/tokens"], t_tokens)
    np.testing.assert_array_equal(ranks[0][f"serve/{arch}/tokens"], j_tokens)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_uneven_heads_prefill_plan_equals_unsharded_forward(runs, arch):
    ranks, _, unsharded = runs
    last, state = unsharded["prefill", arch]
    for r in ranks:
        np.testing.assert_allclose(r[f"prefill/{arch}/last"], last, **TOL)
        for (p, n), want in state.items():
            np.testing.assert_allclose(r[f"prefill/{arch}/{p}/{n}"], want,
                                       **TOL)


@pytest.mark.parametrize("count", list(STRIPES))
def test_striped_bf16_merge_of_f32_partials_is_no_worse(runs, count):
    """Against an f32 attention over the whole cache, the merge of f32
    partials is within K1's bf16 limit (``chip_smoke.py``'s: the plain
    version in bf16 also rounds each score to bf16) and its largest and
    mean errors are at most those of the merge of bf16 partials; every
    rank holds the same merged output."""
    ranks = runs[0]
    whole = ranks[0]["striped/whole"]
    new = ranks[0][f"striped/f32/{count}"]
    old = ranks[0][f"striped/bf16/{count}"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"striped/f32/{count}"], new)
    err_new, err_old = np.abs(new - whole), np.abs(old - whole)
    print(f"{count} stripes: max {err_new.max():.3e} (bf16 partials "
          f"{err_old.max():.3e}), mean {err_new.mean():.3e} "
          f"({err_old.mean():.3e})")
    np.testing.assert_allclose(new, whole, atol=8e-3, rtol=1e-2)
    assert err_new.max() <= err_old.max()
    assert err_new.mean() <= err_old.mean()


COUNTS = """
import json, sys
from repro_torch.configs import InputShape, get_config, smoke_config
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_rules

models, kinds, mesh = json.loads(sys.argv[1])
out = {}
with S.fake_world(MeshShape(("data", "model"), tuple(mesh))) as world:
    for arch, kw in models.items():
        cfg = smoke_config(get_config(arch)).replace(**kw)
        for kind in kinds:
            shape = InputShape("t", 32, 4, kind)
            plan = S.make_plan(cfg, shape, make_rules(world, cfg, shape),
                               remat=None, device="meta")
            c = S.lower_plan(plan)
            out[f"{arch}/{kind}"] = {
                "flops": c.cost_analysis()["flops"],
                "args": c.memory_analysis().argument_size_in_bytes,
                "want_args": S.argument_bytes(plan),
                "colls": c.collectives}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    """Every host count of ``COUNT_MODELS`` x ``COUNT_KINDS`` at
    ``MESH``, from one child process (a fake world is the default process
    group, and this process opens none)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    got = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(COUNTS),
         json.dumps([COUNT_MODELS, COUNT_KINDS, MESH])],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-4000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", COUNT_KINDS)
@pytest.mark.parametrize("arch", list(COUNT_MODELS))
def test_uneven_heads_plans_count(counts, arch, kind):
    """Each plan counts on a ``(2, 2)`` fake world with 3 heads: FLOPs on
    rank 0, its argument bytes those of the plan's own layouts, and the
    collectives of a sharded step."""
    c = counts[f"{arch}/{kind}"]
    assert c["flops"] > 0
    assert c["args"] == c["want_args"]
    assert sum(c["colls"].values()) > 0
