"""The port's axis rules (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``) against the reference's
(``repro.distributed.sharding``, ``repro.launch.mesh``), from mesh sizes
alone: every parameter's spec of the 11 configs at full size on the
production meshes ``(16, 16)`` and ``(2, 16, 16)`` (the reference over
``jax.sharding.AbstractMesh`` and ``jax.eval_shape(model.init)``, the
port over a model on the ``meta`` device), ``make_rules`` for the four
input shapes, and the logical activation table.  Also: specs as
``DTensor`` placements, ``maybe_shard`` without rules, a ``DTensor`` at a
kernel's entry point, and the reference's ``zero1`` fault (ROADMAP
section 3).  The sharded runs themselves are ``test_torch_mesh_train.py``.
"""
import functools
import itertools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config, smoke_config
from repro.distributed import sharding as J
from repro.launch.mesh import make_rules as j_make_rules
from repro.models.model import Model as JaxModel
from repro_torch.configs import INPUT_SHAPES as T_INPUT_SHAPES
from repro_torch.configs import get_config as tget
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.convert import locations
from repro_torch.distributed import sharding as T
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_rules as t_make_rules
from repro_torch.models.model import Model
from repro_torch.training.loop import zero1_layouts

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LEVERS = list(itertools.product([True, False], repeat=3))


@functools.cache
def _reference_shapes(arch: str):
    return jax.eval_shape(JaxModel(get_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.cache
def _meta_model(arch: str) -> Model:
    return Model(tget(arch), device="meta")


def _rules(kind: str, **kw):
    sizes, names = MESHES[kind]
    data = tuple(a for a in ("pod", "data") if a in names)
    return (J.AxisRules(mesh=AbstractMesh(sizes, names), data_axes=data,
                        **kw),
            T.AxisRules(mesh=T.MeshShape(names, sizes), data_axes=data,
                        **kw))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("fsdp,attn_tp,shard_kv_heads", LEVERS,
                         ids=[f"fsdp{int(a)}-tp{int(b)}-kv{int(c)}"
                              for a, b, c in LEVERS])
@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, kind, fsdp, attn_tp,
                                         shard_kv_heads):
    """Each parameter's spec is the reference's for its leaf, less the
    stacked layer dim; no weight is allocated on either side."""
    jr, tr = _rules(kind, fsdp=fsdp, attn_tp=attn_tp,
                    shard_kv_heads=shard_kv_heads)
    want = J.param_specs(_reference_shapes(arch), jr)
    model = _meta_model(arch)
    got = T.param_specs(model, tr)
    locs = locations(model)
    assert set(got) == set(locs)
    for name, (path, layer) in locs.items():
        spec = tuple(_leaf(want, path))
        if layer is not None:
            spec = spec[1:]
        assert got[name] == spec, (name, got[name], spec)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_make_rules_equals_the_reference(shape, kind):
    sizes, names = MESHES[kind]
    cfg = get_config("skymemory-tinyllama")
    want = j_make_rules(AbstractMesh(sizes, names), cfg, INPUT_SHAPES[shape])
    got = t_make_rules(T.MeshShape(names, sizes), tget("skymemory-tinyllama"),
                       T_INPUT_SHAPES[shape])
    for field in ("data_axes", "model_axis", "shard_kv_heads",
                  "seq_shard_cache", "fsdp", "attn_tp", "seq_parallel_acts"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.data == want.data
    assert vars(T_INPUT_SHAPES[shape]) == vars(INPUT_SHAPES[shape])


@pytest.mark.parametrize("seq_parallel_acts", [False, True])
@pytest.mark.parametrize("kind", MESHES)
def test_logical_activation_table_equals_the_reference(kind,
                                                       seq_parallel_acts):
    jr, tr = _rules(kind, seq_parallel_acts=seq_parallel_acts)
    assert set(T._LOGICAL_ACT) == set(J._LOGICAL_ACT)
    for name, fn in J._LOGICAL_ACT.items():
        assert T._LOGICAL_ACT[name](tr) == tuple(fn(jr)), name


def test_maybe_shard_without_rules_returns_its_input():
    x = torch.randn(2, 3, 4)
    assert T.active_rules() is None
    for name in T._LOGICAL_ACT:
        assert T.maybe_shard(x, name) is x
    _, tr = _rules("16x16")
    with T.use_rules(tr):
        assert T.active_rules() is tr
        assert T.maybe_shard(x, "act_btd") is x      # not a DTensor
    assert T.active_rules() is None


def test_specs_become_placements_major_axis_first():
    from torch.distributed.tensor import Replicate, Shard

    mesh = T.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert T.placements((("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert T.placements((None, "model", None), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert T.placements((), mesh) == [Replicate()] * 3
    _, tr = _rules("2x16x16")
    assert T.batch_spec(tr) == (("pod", "data"),)
    assert T.batch_spec(tr, batch_shardable=False) == (None,)


def test_a_dtensor_at_a_kernel_raises(tmp_path):
    """A ``DTensor`` reaches a kernel only through the layers'
    ``local_map``: at an entry point of ``kernels/ops.py`` it raises, with
    and without a graph."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))

        def d(*shape, grad=False):
            t = distribute_tensor(torch.randn(*shape), mesh,
                                  [Replicate(), Replicate()])
            return t.requires_grad_(grad)

        for grad in (False, True):
            q, k, v = (d(1, 8, 2, 16, grad=grad) for _ in range(3))
            with pytest.raises(TypeError, match="DTensor reached a kernel"):
                ops.flash_attention(q, k, v)
            x = d(1, 8, 2, 4, grad=grad)
            with pytest.raises(TypeError, match="DTensor reached a kernel"):
                ops.ssd_scan(x, d(1, 8, 2).abs(), -d(2).abs(), d(1, 8, 1, 4),
                             d(1, 8, 1, 4), chunk_size=4)
        with pytest.raises(TypeError, match="DTensor reached a kernel"):
            ops.paged_attention(d(1, 2, 16), d(1, 1, 8, 2, 16),
                                d(1, 1, 8, 2, 16),
                                torch.full((1,), 8, dtype=torch.int32))
    finally:
        dist.destroy_process_group()


def test_reference_zero1_shards_nothing_the_port_shards_the_replicated():
    """The reference shards a moment over data only when its parameter's
    spec ``== P()`` (``repro/training/loop.py:59-62``), but ``param_specs``
    pads every spec to the leaf's rank (``sharding.py:110``) and
    ``P(None, None) != P()``: no leaf of the smoke TinyLlama matches.  The
    port shards the moments of every parameter whose spec names no axis
    over data, on its first dim that divides."""
    arch = "skymemory-tinyllama"
    cfg = smoke_config(get_config(arch))
    jr, tr = _rules("16x16")
    jspecs = jax.tree.leaves(
        J.param_specs(jax.eval_shape(JaxModel(cfg).init,
                                     jax.random.PRNGKey(0)), jr),
        is_leaf=lambda s: isinstance(s, P))
    assert len(jspecs) == 12
    assert sum(s == P() for s in jspecs) == 0          # moment_spec's test
    replicated = [s for s in jspecs if all(a is None for a in s)]
    assert replicated                                  # yet some replicate

    model = Model(tsmoke(tget(arch)), device="meta")
    specs = T.param_specs(model, tr)
    layouts = zero1_layouts(model, tr)
    want = {n for n, s in specs.items()
            if all(a is None for a in s)
            and any(d % 16 == 0 for d in model.get_parameter(n).shape)}
    assert want and set(layouts) == want
    from torch.distributed.tensor import Replicate, Shard
    for name, pls in layouts.items():
        shape = model.get_parameter(name).shape
        first = next(i for i, d in enumerate(shape) if d % 16 == 0)
        assert pls == [Shard(first), Replicate()], name
