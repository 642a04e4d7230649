"""The port's torus placement math and shard migration
(``repro_torch.core.tpu_cache``) against the reference's
(``repro.core.tpu_cache``).

The host math must equal the reference's with the reference's link
constants passed in (the port carries none of its own).  The exchange
runs on gloo ranks here: four processes spawned by
``torch.multiprocessing`` over a ``FileStore``, each migrating the same
numpy input as the reference's ``migrate_shards`` over four forced CPU
devices (run in a subprocess, so ``XLA_FLAGS`` is set before JAX is
imported), and ``kvc_sharding``'s placements on a 2x2 mesh giving each
rank the block of the reference's ``NamedSharding``.
"""
import importlib
import inspect
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core.tpu_cache as T
from repro_torch.core.mapping import Strategy as TStrategy

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# the migrations compared: (mesh, axis, shift); "1d" is a 4-rank ring,
# "2x2" the data x model mesh
MIGRATIONS = [("1d", "data", 1), ("1d", "data", -1), ("1d", "data", 3),
              ("2x2", "data", 1), ("2x2", "model", -1)]
# paged KV caches [n_blocks, block, kv_heads, head_dim]
KVC_SHAPES = [(8, 16, 4, 8), (4, 128, 2, 64), (2, 1, 2, 1)]
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def J():
    """The reference module (it imports JAX), loaded only here so that the
    spawned ranks, which import this file, do not load JAX."""
    return importlib.import_module("repro.core.tpu_cache")


@pytest.fixture(scope="module")
def link(J):
    return T.LinkModel(J.ICI_HOP_LATENCY_S, J.ICI_LINK_BW_BYTES_S)


def test_no_link_constant_is_a_default():
    """The reference's ICI constants are a TPU's: the port takes the link
    model from its caller, always."""
    assert not [n for n in vars(T) if n.startswith("ICI_")]
    for fn in (T.gather_cost_s, T.strategy_cost_table):
        p = inspect.signature(fn).parameters["link"]
        assert p.default is inspect.Parameter.empty


@pytest.mark.parametrize("rows,cols", [(4, 6), (8, 8)])
def test_hops_over_every_pair(J, rows, cols):
    jg, tg = J.TorusGrid(rows, cols), T.TorusGrid(rows, cols)
    cells = [(r, c) for r in range(rows) for c in range(cols)]
    got = [tg.hops(a, b) for a in cells for b in cells]
    assert got == [jg.hops(a, b) for a in cells for b in cells]
    assert tg.size == jg.size == rows * cols


@pytest.mark.parametrize("strategy", ["rotation", "hop", "rotation_hop"])
@pytest.mark.parametrize("n", [1, 5, 16, 64])
@pytest.mark.parametrize("center", [(0, 0), (3, 5)])
def test_ring_layout_and_worst_hops(J, strategy, n, center):
    jg, tg = J.TorusGrid(8, 8), T.TorusGrid(8, 8)
    want = jg.ring_layout(n, center, J.Strategy(strategy))
    got = tg.ring_layout(n, center, TStrategy(strategy))
    assert got == want
    assert tg.worst_hops(got, center) == jg.worst_hops(want, center)


def test_ring_layout_refuses_more_shards_than_devices(J):
    for mod in (J, T):
        with pytest.raises(ValueError, match="more shards"):
            mod.TorusGrid(2, 2).ring_layout(5)
        with pytest.raises(ValueError, match="more shards"):
            mod.row_major_layout(mod.TorusGrid(2, 2), 5)


@pytest.mark.parametrize("n", [1, 5, 16, 64])
def test_row_major_layout(J, n):
    assert (T.row_major_layout(T.TorusGrid(8, 8), n)
            == J.row_major_layout(J.TorusGrid(8, 8), n))


@pytest.mark.parametrize("bytes_per_shard", [0, 4096, 1 << 20, int(50e9)])
def test_gather_cost_is_bitwise_the_reference(J, link, bytes_per_shard):
    jg, tg = J.TorusGrid(4, 6), T.TorusGrid(4, 6)
    for center in ((0, 0), (2, 3)):
        layout = jg.ring_layout(16, center)
        assert (T.gather_cost_s(tg, layout, center, bytes_per_shard, link)
                == J.gather_cost_s(jg, layout, center, bytes_per_shard))
    assert T.gather_cost_s(tg, [], (0, 0), bytes_per_shard, link) == 0.0


@pytest.mark.parametrize("rows,cols,n,center", [
    (16, 16, 64, None), (8, 8, 16, (1, 2)), (4, 6, 9, None)])
def test_strategy_cost_table_is_bitwise_the_reference(J, link, rows, cols,
                                                      n, center):
    want = J.strategy_cost_table(J.TorusGrid(rows, cols), n, 1 << 20,
                                 center)
    got = T.strategy_cost_table(T.TorusGrid(rows, cols), n, 1 << 20, link,
                                center)
    assert list(got.items()) == list(want.items())


@pytest.mark.parametrize("strategy", ["hop", "rotation_hop"])
@pytest.mark.parametrize("n,center", [(16, (4, 4)), (64, (0, 7)), (5, (7, 0))])
def test_shard_layout_permutation(J, strategy, n, center):
    want = J.shard_layout_permutation(J.TorusGrid(8, 8), n, center,
                                      J.Strategy(strategy))
    got = T.shard_layout_permutation(T.TorusGrid(8, 8), n, center,
                                     TStrategy(strategy))
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the exchange: gloo ranks against the reference's forced CPU devices
# ---------------------------------------------------------------------------

def _input() -> np.ndarray:
    return np.random.default_rng(7).standard_normal((8, 3, 2)).astype(
        np.float32)


def _mesh(kind: str, world: int):
    from torch.distributed.device_mesh import init_device_mesh

    if kind == "1d":
        return init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One gloo rank: every migration of ``MIGRATIONS``, gathered, and
    this rank's local block of every ``KVC_SHAPES`` cache under
    ``kvc_sharding``."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=60))
    try:
        out = {}
        x = torch.from_numpy(_input())
        for i, (kind, axis, shift) in enumerate(MIGRATIONS):
            mesh = _mesh(kind, world)
            placements = [Shard(0) if name == axis else Replicate()
                          for name in mesh.mesh_dim_names]
            y = T.migrate_shards(distribute_tensor(x, mesh, placements),
                                 mesh, axis=axis, shift=shift)
            out[f"migrate{i}"] = y.full_tensor().numpy()
        mesh = _mesh("2x2", world)
        g = T.device_grid_for_mesh(mesh)
        out["grid"] = np.array([g.rows, g.cols])
        placements = T.kvc_sharding(mesh)
        out["placements"] = np.array([repr(p) for p in placements])
        for i, shape in enumerate(KVC_SHAPES):
            g = torch.arange(int(np.prod(shape)),
                             dtype=torch.float32).reshape(shape)
            out[f"kvc{i}"] = distribute_tensor(g, mesh, placements).to_local(
                ).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core.tpu_cache import device_grid_for_mesh, kvc_sharding, migrate_shards
migrations, shapes, inp, outp = eval(sys.argv[1]), eval(sys.argv[2]), sys.argv[3], sys.argv[4]
devs = np.array(jax.devices()[:4])
assert len(devs) == 4, jax.devices()
meshes = {"1d": Mesh(devs, ("data",)),
          "2x2": Mesh(devs.reshape(2, 2), ("data", "model"))}
x = jnp.asarray(np.load(inp))
out = {}
for i, (kind, axis, shift) in enumerate(migrations):
    out[f"migrate{i}"] = np.asarray(
        migrate_shards(x, meshes[kind], axis=axis, shift=shift))
g = device_grid_for_mesh(meshes["2x2"])
out["grid"] = np.array([g.rows, g.cols])
sh = kvc_sharding(meshes["2x2"])
for i, shape in enumerate(shapes):
    g = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    out[f"shape{i}"] = np.array(sh.shard_shape(shape))
    idx = sh.devices_indices_map(shape)
    for r, d in enumerate(devs):
        out[f"kvc{i}_rank{r}"] = g[idx[d]]
np.savez(outp, **out)
"""


@pytest.fixture(scope="module")
def exchanged(tmp_path_factory):
    """The reference's results and each gloo rank's, from one run each."""
    tmp = tmp_path_factory.mktemp("torus")
    np.save(tmp / "x.npy", _input())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, repr(MIGRATIONS), repr(KVC_SHAPES),
         str(tmp / "x.npy"), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    ctx = torch.multiprocessing.start_processes(
        _rank, args=(WORLD, str(tmp / "store"), str(tmp)), nprocs=WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo ranks still running after "
                                   f"{TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    try:
        _, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        ref.kill()
    assert ref.returncode == 0, err
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return dict(np.load(tmp / "ref.npz")), ranks


@pytest.mark.parametrize("i", range(len(MIGRATIONS)),
                         ids=[f"{k}-{a}-shift{s}" for k, a, s in MIGRATIONS])
def test_migrate_shards_over_gloo_equals_the_reference(exchanged, i):
    want, ranks = exchanged
    x = _input()
    assert not np.array_equal(want[f"migrate{i}"], x)   # it moved
    for r in ranks:
        np.testing.assert_array_equal(r[f"migrate{i}"], want[f"migrate{i}"])


@pytest.mark.parametrize("i", range(len(KVC_SHAPES)),
                         ids=[str(s) for s in KVC_SHAPES])
def test_kvc_sharding_gives_each_rank_the_reference_block(exchanged, i):
    want, ranks = exchanged
    for rank, got in enumerate(ranks):
        assert got[f"kvc{i}"].shape == tuple(want[f"shape{i}"])
        np.testing.assert_array_equal(got[f"kvc{i}"],
                                      want[f"kvc{i}_rank{rank}"])
    for got in ranks:
        assert list(got["placements"]) == ["Shard(dim=0)", "Shard(dim=2)"]
        np.testing.assert_array_equal(got["grid"], want["grid"])


def test_migrate_shards_on_one_rank_returns_its_input(tmp_path):
    """The reference's ``test_migrate_shards_single_device_identity``: on
    a mesh of one the ring ``0 -> 0`` is the identity."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = _mesh("1d", 1)
        x = torch.arange(8.0).reshape(4, 2)
        y = T.migrate_shards(distribute_tensor(x, mesh, [Shard(0)]), mesh,
                             axis="data", shift=1)
        assert torch.equal(y.full_tensor(), x)
        with pytest.raises(ValueError, match="sharded over"):
            T.migrate_shards(distribute_tensor(x, mesh, [Shard(1)]), mesh)
    finally:
        dist.destroy_process_group()
