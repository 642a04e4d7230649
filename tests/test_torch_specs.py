"""The port's step plans (``repro_torch.launch.specs``) and what they are
built from -- ``configs.shape_variant``, ``models.cache.cache_bytes``,
``launch.mesh.make_production_mesh`` and ``sharding.cache_specs`` --
against the reference's, from shapes alone: the 11 configs at full size,
the four assigned input shapes and both production meshes (the reference
over ``jax.sharding.AbstractMesh``, the port over ``meta`` tensors and a
``MeshShape``).  Then the train plan with gradient accumulation on a
one-rank mesh, against itself without and against the reference's plan.
The sharded serve and prefill steps themselves are
``test_torch_mesh_serve.py``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.configs import shape_variant as j_shape_variant
from repro.distributed import sharding as J
from repro.launch import specs as JS
from repro.launch.mesh import make_rules as j_make_rules
from repro.models.cache import cache_bytes as j_cache_bytes
from repro.models.model import Model as JaxModel
from repro_torch.configs import INPUT_SHAPES as T_INPUT_SHAPES
from repro_torch.configs import get_config as tget
from repro_torch.configs import shape_variant as t_shape_variant
from repro_torch.convert import locations
from repro_torch.distributed import sharding as T
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.mesh import make_rules as t_make_rules
from repro_torch.models.cache import cache_bytes as t_cache_bytes
from repro_torch.models.cache import cache_len, init_cache

MESHES = {"16x16": False, "2x16x16": True}
DECODE = ["decode_32k", "long_500k"]
STEP_NAMES = {"train": "train_step", "prefill": "prefill_step",
              "decode": "serve_step"}


def _meshes(kind: str):
    tm = make_production_mesh(multi_pod=MESHES[kind])
    return AbstractMesh(tm.sizes, tm.axis_names), tm


def _configs(arch: str, shape: str):
    """The reference's and the port's config of ``arch`` at ``shape``,
    after ``shape_variant``."""
    return (j_shape_variant(get_config(arch), INPUT_SHAPES[shape]),
            t_shape_variant(tget(arch), T_INPUT_SHAPES[shape]))


def _padded(spec: P, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@functools.cache
def _reference_shapes(arch: str):
    return jax.eval_shape(JaxModel(get_config(arch)).init,
                          jax.random.PRNGKey(0))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("kind", MESHES)
def test_production_meshes_are_the_reference_shapes(kind):
    tm = make_production_mesh(multi_pod=MESHES[kind])
    want = ({"data": 16, "model": 16} if kind == "16x16"
            else {"pod": 2, "data": 16, "model": 16})
    assert T.mesh_sizes(tm) == want
    assert tm.axis_names == tuple(want)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape):
    jcfg, tcfg = _configs(arch, shape)
    want = JS.input_specs(jcfg, INPUT_SHAPES[shape])
    got = TS.input_specs(tcfg, T_INPUT_SHAPES[shape])
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == \
            jnp.dtype(want[k].dtype).name, k


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_variant_equals_the_reference(arch, shape):
    jcfg, tcfg = _configs(arch, shape)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if shape == "long_500k" and jcfg.arch_type != "ssm":
        assert tcfg.sliding_window == 32_768


def _reference_cache_sizes(jcfg, shape) -> list[int]:
    """Elements of each leaf of the reference's cache, as Python ints."""
    from repro.models.cache import init_cache as j_init_cache

    leaves = jax.tree.leaves(j_init_cache(jcfg, shape.global_batch,
                                          shape.seq_len, specs_only=True))
    return [(math.prod(t.shape), jnp.dtype(t.dtype).itemsize)
            for t in leaves]


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_bytes_equal_the_reference(arch, shape):
    """The bytes of the reference's cache leaves, counted exactly; and the
    reference's own ``cache_bytes`` where no leaf holds 2^31 elements or
    more (beyond, its int32 product wraps: ROADMAP.md section 3).  The
    encoder-decoder's cross K/V needs ``src_len`` in the port; the
    reference, given none, sizes it at the self cache's length
    (``seq_len``, or the ring's at ``long_500k``), which is what is passed
    here so that the counts can be compared."""
    jcfg, tcfg = _configs(arch, shape)
    s = INPUT_SHAPES[shape]
    src = (cache_len(tcfg, s.seq_len) if tcfg.is_encoder_decoder else None)
    got = t_cache_bytes(tcfg, s.global_batch, s.seq_len, src_len=src)
    sizes = _reference_cache_sizes(jcfg, s)
    assert got == sum(n * item for n, item in sizes)
    if all(n < 2 ** 31 for n, _ in sizes):
        assert got == j_cache_bytes(jcfg, s.global_batch, s.seq_len)


def test_reference_cache_bytes_wraps_the_port_counts_exactly():
    """``repro/models/cache.py:350`` multiplies a leaf's dims in int32
    (``jnp.prod(jnp.array(shape))``): llava-next-34b's K at
    ``prefill_32k`` (32 x 32,768 x 60 layers x 8 heads x 128 = 2^35 x
    1.875 elements) wraps to 0.  The port counts in Python ints."""
    jcfg, tcfg = _configs("llava-next-34b", "prefill_32k")
    s = INPUT_SHAPES["prefill_32k"]
    assert j_cache_bytes(jcfg, s.global_batch, s.seq_len) == 0
    assert t_cache_bytes(tcfg, s.global_batch, s.seq_len) == \
        2 * 2 * 60 * 32 * 32_768 * 8 * 128


def _cache_pair(arch: str, shape: str, kind: str):
    """The reference's and the port's cache specs of one decode shape,
    ``(reference specs, port specs, port cache)``."""
    jcfg, tcfg = _configs(arch, shape)
    s = INPUT_SHAPES[shape]
    jm, tm = _meshes(kind)
    b, n = s.global_batch, s.seq_len
    src = n // 2 if jcfg.is_encoder_decoder else None
    jshapes = JaxModel(jcfg).init_cache(b, n, specs_only=True, src_len=src)
    want = J.cache_specs(jshapes, j_make_rules(jm, jcfg, s), batch=b)
    cache = init_cache(tcfg, b, n, src_len=src, device="meta")
    got = T.cache_specs(cache, t_make_rules(tm, tcfg, T_INPUT_SHAPES[shape]),
                        batch=b)
    return jshapes, want, got, cache


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, shape, kind):
    jshapes, want, got, cache = _cache_pair(arch, shape, kind)
    assert {p: set(v) for p, v in got.items()} == \
        {p: set(v) for p, v in want.items()}
    striped = 0
    for p, leaves in got.items():
        for n, spec in leaves.items():
            assert tuple(cache[p][n].shape) == tuple(jshapes[p][n].shape)
            assert spec == _padded(want[p][n], len(spec)), (p, n, spec)
            striped += p != "ssm" and spec[2] is not None
    assert striped or tget(arch).arch_type == "ssm"


def _param_placements_want(model, arch: str, jrules, mesh) -> dict:
    """The reference's parameter specs as the port's placements, per
    ``named_parameters`` name (a stacked leaf less its layer entry)."""
    specs = J.param_specs(_reference_shapes(arch), jrules)
    out = {}
    for name, (path, layer) in locations(model).items():
        spec = tuple(_leaf(specs, path))
        out[name] = T.placements(spec if layer is None else spec[1:], mesh)
    return out


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_placements_equal_the_reference(arch, shape, kind):
    """``make_plan`` on ``meta``: its step, its parameters' placements
    (the reference's ``param_specs``), and for the serve step its cache's
    (the reference's ``cache_specs``) and its tokens' (over data only
    when the batch is at least the data size)."""
    jm, tm = _meshes(kind)
    s = T_INPUT_SHAPES[shape]
    jrules = j_make_rules(jm, get_config(arch), INPUT_SHAPES[shape])
    rules = t_make_rules(tm, tget(arch), s)
    plan = TS.make_plan(tget(arch), s, rules, device="meta")
    assert plan.name == STEP_NAMES[s.kind]
    assert plan.cfg == t_shape_variant(tget(arch), s)
    assert next(plan.model.parameters()).device.type == "meta"
    assert plan.param_placements == _param_placements_want(
        plan.model, arch, jrules, tm)
    if s.kind == "train":
        assert plan.in_placements[0]["m"] == plan.param_placements
        return
    if s.kind == "prefill":
        assert set(plan.args[0]) == set(TS.input_specs(plan.cfg, s)) - {
            "targets"}
        return
    _, want, _, cache = _cache_pair(arch, shape, kind)
    csh = plan.in_placements[0]
    for p, leaves in want.items():
        for n, spec in leaves.items():
            assert csh[p][n] == T.placements(
                _padded(spec, cache[p][n].dim()), tm), (p, n)
    dsize = jrules.axis_size(jrules.data_axes)
    want_tok = (jrules.data,) if s.global_batch >= dsize else ()
    assert plan.in_placements[1] == T.placements(want_tok, tm)
    assert tuple(plan.args[2].shape) == (s.global_batch,)


def _one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def test_train_plan_accumulates_gradients_as_the_reference(tmp_path):
    """``make_plan`` train with ``grad_accum=4`` equals ``grad_accum=1``
    and the reference's plan (``jax.jit(plan.fn)``) on the same batch and
    weights: the updated parameters at the reference's
    ``test_grad_accum_equivalent_params`` tolerance, ``grad_norm`` at
    its rtol, and the f32 first moments at its rtol beside an atol of
    1e-5 of their largest value (they are ~1e-4-2e-3, so a bare 5e-6
    would pass a wrong moment).

    Without warm-up the step runs at the full learning rate, so each
    parameter moves by far more than the tolerance.  Adam's ``eps`` is
    1e-6 in all three plans: at 1e-8 a first-step update g / (|g| + eps)
    of an element with |g| ~ 1e-9 moves by ~10% under the 1e-10
    rounding in g, a tenth of the learning rate."""
    import torch.distributed as dist

    from repro.configs import smoke_config
    from repro.models.config import InputShape as JShape
    from repro.training.optimizer import AdamWConfig as JAdamW
    from repro.training.optimizer import init_opt_state as j_init_opt
    from repro_torch.configs import InputShape
    from repro_torch.configs import smoke_config as tsmoke
    from repro_torch.convert import fill_from_numpy
    from repro_torch.training.loop import trainable
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.optimizer import init_opt_state

    torch.set_num_threads(2)
    tol = {"atol": 5e-6, "rtol": 1e-4}
    arch = "internlm2-1.8b"
    jcfg = smoke_config(get_config(arch)).replace(dtype="float32")
    tcfg = tsmoke(tget(arch)).replace(dtype="float32")
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jshape = JShape("t", 32, 4, "train")
    jrules = j_make_rules(jmesh, jcfg, jshape)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    with jmesh:
        jp = JS.make_plan(jcfg, jshape, jrules, remat=None, unroll=False,
                          opt=JAdamW(warmup_steps=0, eps=1e-6),
                          grad_accum=1)
        params = jp.model.init(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(tokens)}
        want, want_opt, want_metrics = jax.tree.map(np.asarray, jax.jit(
            jp.fn)(params, j_init_opt(params), batch))
    tree = jax.tree.map(np.asarray, params)

    mesh = _one_rank_mesh(tmp_path)
    try:
        shape = InputShape("t", 32, 4, "train")
        rules = t_make_rules(mesh, tcfg, shape)
        got, got_m, norms = {}, {}, {}
        for accum in (1, 4):
            plan = TS.make_plan(tcfg, shape, rules, remat=None,
                                opt=AdamWConfig(warmup_steps=0, eps=1e-6),
                                grad_accum=accum, device="cpu")
            model = fill_from_numpy(plan.model, tree)
            opt = init_opt_state(trainable(T.distribute_model(model, rules)))
            tb = {"tokens": torch.from_numpy(tokens),
                  "targets": torch.from_numpy(tokens)}
            metrics = plan.fn(opt, tb)
            assert np.isfinite(float(metrics["loss"]))
            norms[accum] = float(metrics["grad_norm"])
            got[accum] = {n: T.whole(p).detach().numpy().copy()
                          for n, p in model.named_parameters()}
            got_m[accum] = {n: T.whole(m).numpy().copy()
                            for n, m in opt["m"].items()}
        for accum in (1, 4):
            np.testing.assert_allclose(
                norms[accum], float(want_metrics["grad_norm"]),
                rtol=tol["rtol"])
        for name, (path, layer) in locations(model).items():
            ref, ref_m, init = (_leaf(want, path), _leaf(want_opt["m"], path),
                                _leaf(tree, path))
            if layer is not None:
                ref, ref_m, init = ref[layer], ref_m[layer], init[layer]
            assert np.abs(ref - init).max() > 10 * tol["atol"], name
            np.testing.assert_allclose(got[4][name], got[1][name],
                                       err_msg=name, **tol)
            for accum in (1, 4):
                np.testing.assert_allclose(got[accum][name], ref,
                                           err_msg=name, **tol)
                np.testing.assert_allclose(
                    got_m[accum][name], ref_m, rtol=tol["rtol"],
                    atol=1e-5 * np.abs(ref_m).max(), err_msg=name)
    finally:
        dist.destroy_process_group()
