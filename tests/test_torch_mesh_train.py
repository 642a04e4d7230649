"""Sharded training on four gloo ranks against the port's unsharded run
and the reference's ``train``.

Four ranks are spawned once for the module (``torch.multiprocessing``
over a ``FileStore``, one thread each).  Every rank starts from the
reference's ``Model.init(PRNGKey(0))`` weights carried across by
``params_from_numpy``, draws the same global batches and trains 3 AdamW
steps through ``train(..., rules=make_rules(mesh, ...))`` on a ``(data,
model)`` mesh of ``(2, 2)``, ``(4, 1)`` or ``(1, 4)``, for the smoke
variants of six families in f32 (dense TinyLlama, MoE granite, SSM
mamba2, hybrid zamba2, MLA deepseek-v3, encoder-decoder seamless), plus
TinyLlama with 2 K/V heads on ``(1, 4)`` (the reference shards ``wk`` /
``wv`` inside a head there), ``zero1`` on ``(4, 1)`` for two families and
``remat="dots"`` on ``(2, 2)``; the ZeRO-1 TinyLlama's checkpoint is
saved and read back into a sharded model.  Meanwhile this process runs the
reference's ``train`` and the port's unsharded ``train`` on the same
weights and batches.

Tolerances: losses and the other metrics atol 2e-5 / rtol 2e-4 (f32, the
same arithmetic in another order of sums); parameters at that tolerance
on all but a few elements per leaf, which are AdamW's own conditioning
(``test_torch_training.py``'s docstring): an element whose gradient is as
small as its rounding takes a first update of ``g / (|g| + eps)``, so
two correct runs part by up to the learning rate per step.  Each such
element stays within twice the sum of the learning rates, there are at
most 1e-3 of a leaf's elements plus 2 of them, and each leaf is within
1e-3 of the other in relative norm.  ``zero1`` is held to the same
bound against the run without it.  Local shard shapes equal the
reference's ``NamedSharding(mesh, spec).shard_shape``.  Every MoE route
agrees: capacity routing is done per group, and the port forms the same
groups sharded or not.
"""
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 400
STEPS = 3
TOL = dict(atol=2e-5, rtol=2e-4)
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=STEPS)
DATA = dict(seq_len=32, batch_size=4, seed=1)
FAMILIES = ["skymemory-tinyllama", "granite-moe-3b-a800m", "mamba2-1.3b",
            "zamba2-1.2b", "deepseek-v3-671b", "seamless-m4t-large-v2"]
MESHES = [(2, 2), (4, 1), (1, 4)]
# (case id, arch, config overrides, mesh, zero1, remat)
CASES = [(f"{a}-{m[0]}x{m[1]}", a, {}, m, False, None)
         for a in FAMILIES for m in MESHES]
CASES += [("skymemory-tinyllama-kv2-1x4", "skymemory-tinyllama",
           {"num_kv_heads": 2}, (1, 4), False, None),
          ("skymemory-tinyllama-4x1-zero1", "skymemory-tinyllama", {},
           (4, 1), True, None),
          ("mamba2-1.3b-4x1-zero1", "mamba2-1.3b", {}, (4, 1), True, None),
          ("zamba2-1.2b-2x2-remat-dots", "zamba2-1.2b", {}, (2, 2), False,
           "dots")]
# each unsharded run: (arch, config overrides)
MODELS = {(a, tuple(sorted(kw.items()))) for _, a, kw, *_ in CASES}
CKPT_CASE = "skymemory-tinyllama-4x1-zero1"


def _model_id(arch: str, kw) -> str:
    return arch + "".join(f"-{k}{v}" for k, v in kw)


def _metrics(history) -> np.ndarray:
    keys = ("ce", "aux", "loss", "grad_norm", "lr")
    return np.array([[h[k] for k in keys] for h in history])


def _port_cfg(arch: str, kw: dict):
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config(arch)).replace(dtype="float32", **kw)


def _dataset(cfg):
    from repro_torch.training import DataConfig, make_dataset

    return make_dataset(DataConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        num_image_tokens=cfg.num_image_tokens,
        is_encoder_decoder=cfg.is_encoder_decoder,
        arch_type=cfg.arch_type, **DATA))


def _load_model(cfg, weights: str):
    from repro_torch.convert import params_from_numpy
    from repro_torch.training.checkpoint import _unflatten

    with np.load(weights) as f:
        return params_from_numpy(cfg, _unflatten(dict(f)), device="cpu")


def _rank(rank: int, world: int, store_path: str, tmp: str) -> None:
    """One gloo rank: every case of ``CASES``; rank 0 keeps the gathered
    parameters, every rank its local shard shapes."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_rules
    from repro_torch.training import (
        AdamWConfig,
        TrainConfig,
        init_opt_state,
        load_checkpoint,
        save_checkpoint,
        train,
    )

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        out = {}
        meshes = {m: init_device_mesh("cpu", m,
                                      mesh_dim_names=("data", "model"))
                  for m in MESHES}
        for case, arch, kw, m, zero1, remat in CASES:
            cfg = _port_cfg(arch, kw)
            weights = os.path.join(
                tmp, f"{_model_id(arch, sorted(kw.items()))}.npz")
            model = _load_model(cfg, weights)
            rules = make_rules(meshes[m], cfg, INPUT_SHAPES["train_4k"])
            tcfg = TrainConfig(opt=AdamWConfig(**OPT), log_every=1,
                               zero1=zero1, remat=remat)
            model, state, hist = train(model, _dataset(cfg), tcfg,
                                       num_steps=STEPS, rules=rules)
            out[f"{case}/metrics"] = _metrics(hist)
            for name, p in model.named_parameters():
                full = S.whole(p).detach().numpy()
                if rank == 0:
                    out[f"{case}/p/{name}"] = full
                out[f"{case}/shape/{name}"] = np.array(p.to_local().shape)
            if zero1:
                for name, mom in state["m"].items():
                    out[f"{case}/mshape/{name}"] = np.array(
                        mom.to_local().shape)
            if case == CKPT_CASE:
                # saved gathered by rank 0, read back into a model and
                # moments laid out afresh (from the initial weights)
                path = os.path.join(tmp, "ckpt")
                save_checkpoint(path, model, state, step=STEPS)
                dist.barrier()
                other = S.distribute_model(_load_model(cfg, weights), rules)
                layouts = {n: list(t.placements)
                           for n, t in state["m"].items()}
                ostate = init_opt_state(dict(other.named_parameters()),
                                        layouts=layouts)
                load_checkpoint(path, other, ostate)
                same = [torch.equal(a.to_local(), b.to_local())
                        for a, b in zip(model.parameters(),
                                        other.parameters())]
                same += [torch.equal(state[k][n].to_local(),
                                     ostate[k][n].to_local())
                         for k in ("m", "v") for n in state[k]]
                out["ckpt/equal"] = np.array(all(same))
                out["ckpt/step"] = np.array(int(ostate["step"]))
        # maybe_shard: the act_btd layout where it divides, skipped where
        # it does not
        rules = make_rules(meshes[(2, 2)], _port_cfg("skymemory-tinyllama",
                                                     {}),
                           INPUT_SHAPES["train_4k"])
        with S.use_rules(rules):
            for b in (4, 3):
                x = distribute_tensor(torch.randn(b, 2, 8), meshes[(2, 2)],
                                      S.placements((), meshes[(2, 2)]),
                                      src_data_rank=None)
                y = S.maybe_shard(x, "act_btd")
                out[f"maybe_shard/{b}"] = np.array(
                    [repr(pl) for pl in y.placements])
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, and this process's reference and unsharded
    port runs: ``(ranks, reference, unsharded, directory)``."""
    import jax

    from repro.configs import get_config, smoke_config
    from repro.models.model import Model as JaxModel
    from repro.training import data as jdata
    from repro.training import loop as jloop
    from repro.training import optimizer as jopt
    from repro_torch.training import AdamWConfig, TrainConfig, train
    from repro_torch.training.checkpoint import _flatten

    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("mesh_train")
    trees = {}
    for arch, kw in sorted(MODELS):
        cfg = smoke_config(get_config(arch)).replace(dtype="float32",
                                                     **dict(kw))
        tree = jax.tree.map(np.asarray,
                            JaxModel(cfg).init(jax.random.PRNGKey(0)))
        trees[arch, kw] = (cfg, tree)
        np.savez(tmp / f"{_model_id(arch, kw)}.npz", **_flatten(tree))

    ctx = torch.multiprocessing.start_processes(
        _rank, args=(WORLD, str(tmp / "store"), str(tmp)), nprocs=WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        reference, unsharded = {}, {}
        for (arch, kw), (cfg, tree) in trees.items():
            dcfg = jdata.DataConfig(
                vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                num_image_tokens=cfg.num_image_tokens,
                is_encoder_decoder=cfg.is_encoder_decoder,
                arch_type=cfg.arch_type, **DATA)
            jp, _, jh = jloop.train(
                JaxModel(cfg), jdata.make_dataset(dcfg),
                jloop.TrainConfig(opt=jopt.AdamWConfig(**OPT), log_every=1),
                num_steps=STEPS, seed=0)
            reference[arch, kw] = (_metrics(jh), jax.tree.map(np.asarray, jp))
            tcfg = _port_cfg(arch, dict(kw))
            model, _, th = train(
                _load_model(tcfg, str(tmp / f"{_model_id(arch, kw)}.npz")),
                _dataset(tcfg),
                TrainConfig(opt=AdamWConfig(**OPT), log_every=1),
                num_steps=STEPS)
            unsharded[arch, kw] = (_metrics(th), {
                n: p.detach().numpy().copy()
                for n, p in model.named_parameters()}, model)
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [np.load(tmp / f"rank{r}.npz") for r in range(WORLD)]
    return ranks, reference, unsharded, tmp


def _lr_sum() -> float:
    from repro_torch.training.optimizer import AdamWConfig, lr_at

    return sum(float(lr_at(AdamWConfig(**OPT), s))
               for s in range(1, STEPS + 1))


def _close_params(got: np.ndarray, want: np.ndarray, what) -> None:
    """``got`` equals ``want`` at ``TOL`` but for AdamW's near-zero
    gradient elements (the module's docstring)."""
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


def _case(case_id):
    return next(c for c in CASES if c[0] == case_id)


@pytest.mark.parametrize("case_id", [c[0] for c in CASES])
def test_sharded_steps_equal_unsharded_and_reference(runs, case_id):
    from repro_torch.convert import locations

    ranks, reference, unsharded, _ = runs
    _, arch, kw, _, _, _ = _case(case_id)
    key = (arch, tuple(sorted(kw.items())))
    got = ranks[0][f"{case_id}/metrics"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{case_id}/metrics"], got)
    t_metrics, t_params, model = unsharded[key]
    j_metrics, j_params = reference[key]
    np.testing.assert_allclose(got, t_metrics, **TOL)
    np.testing.assert_allclose(got, j_metrics, **TOL)
    assert got[-1, 0] < got[0, 0]                      # ce fell
    for name, (path, layer) in locations(model).items():
        p = ranks[0][f"{case_id}/p/{name}"]
        _close_params(p, t_params[name], (case_id, name, "port"))
        want = _leaf(j_params, path)
        _close_params(p, want if layer is None else want[layer],
                      (case_id, name, "reference"))


@pytest.mark.parametrize("case_id", [c[0] for c in CASES])
def test_local_shards_are_the_reference_shard_shapes(runs, case_id):
    """Rank ``r`` holds the block of each parameter that device ``r`` of
    the reference's mesh holds under its ``param_specs``."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import INPUT_SHAPES, get_config, smoke_config
    from repro.distributed.sharding import param_specs
    from repro.launch.mesh import make_rules
    from repro.models.model import Model as JaxModel
    from repro_torch.convert import locations

    ranks, _, unsharded, _ = runs
    _, arch, kw, m, _, _ = _case(case_id)
    model = unsharded[arch, tuple(sorted(kw.items()))][2]
    cfg = smoke_config(get_config(arch)).replace(dtype="float32", **kw)
    mesh = AbstractMesh(m, ("data", "model"))
    shapes = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0))
    specs = param_specs(shapes, make_rules(mesh, cfg,
                                           INPUT_SHAPES["train_4k"]))
    sharded = 0
    for name, (path, layer) in locations(model).items():
        leaf = _leaf(shapes, path)
        want = NamedSharding(mesh, _leaf(specs, path)).shard_shape(
            leaf.shape)
        want = want if layer is None else want[1:]
        for r in ranks:
            assert tuple(r[f"{case_id}/shape/{name}"]) == tuple(want), (
                name, tuple(r[f"{case_id}/shape/{name}"]), want)
        sharded += tuple(want) != tuple(leaf.shape[layer is not None:])
    assert sharded > 0


@pytest.mark.parametrize("case_id", [c[0] for c in CASES if c[4]])
def test_zero1_changes_no_result(runs, case_id):
    """ZeRO-1 shards the moments of every replicated parameter over data
    (the 4-rank data axis here) and the run equals the one without it."""
    ranks, _, unsharded, _ = runs
    _, arch, kw, m, _, _ = _case(case_id)
    plain = case_id.removesuffix("-zero1")
    np.testing.assert_allclose(ranks[0][f"{case_id}/metrics"],
                               ranks[0][f"{plain}/metrics"], **TOL)
    model = unsharded[arch, tuple(sorted(kw.items()))][2]
    split = 0
    for name, p in model.named_parameters():
        _close_params(ranks[0][f"{case_id}/p/{name}"],
                      ranks[0][f"{plain}/p/{name}"], (case_id, name))
        mshape = tuple(ranks[0][f"{case_id}/mshape/{name}"])
        pshape = tuple(ranks[0][f"{case_id}/shape/{name}"])
        split += mshape != pshape
        if mshape != pshape:        # a replicated parameter's moments
            assert pshape == tuple(p.shape)
            assert np.prod(mshape) * m[0] == np.prod(pshape)
    assert split > 0


def test_maybe_shard_redistributes_or_skips(runs):
    ranks = runs[0]
    for r in ranks:
        assert list(r["maybe_shard/4"]) == ["Shard(dim=0)", "Replicate()"]
        assert list(r["maybe_shard/3"]) == ["Replicate()", "Replicate()"]


def test_sharded_checkpoint_round_trip(runs):
    """A sharded model's checkpoint is gathered and written once (rank 0),
    in the reference's layout; read back into a sharded model and ZeRO-1
    moments, every rank's shards are bitwise the saved run's."""
    from repro_torch.training.checkpoint import _flatten

    ranks, _, unsharded, tmp = runs
    for r in ranks:
        assert bool(r["ckpt/equal"]) and int(r["ckpt/step"]) == STEPS
    _, arch, kw, _, _, _ = _case(CKPT_CASE)
    model = unsharded[arch, tuple(sorted(kw.items()))][2]
    from repro_torch.convert import named_to_numpy

    want = _flatten(named_to_numpy(model, {
        n: torch.from_numpy(ranks[0][f"{CKPT_CASE}/p/{n}"])
        for n, _ in model.named_parameters()}))
    with np.load(tmp / "ckpt" / "params.npz") as f:
        assert sorted(f) == sorted(want)
        for k in f:
            np.testing.assert_array_equal(f[k], want[k])
