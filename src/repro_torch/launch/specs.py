"""Input specs and the steps of every (arch x shape): the port's
``repro/launch/specs.py``.

``input_specs`` gives the model inputs of one assigned shape as ``meta``
tensors (the reference's ``ShapeDtypeStruct``s: shapes and dtypes, no
storage).  ``make_plan`` builds the model and one step -- train, prefill
or serve -- with the ``DTensor`` placements of its weights, arguments
and results on ``rules.mesh``.  The reference lowers its plans with
``jax.jit(...).lower().compile()``; the port's counterpart is
``lower_plan``, which runs the step once on fake tensors over a world of
fake ranks and counts what rank 0 does (``Counted``).

The model holds its weights, so a plan's ``fn`` takes no parameters: the
caller fills ``plan.model`` (``convert.params_from_numpy``, or
``Model.init`` from a seed) and calls ``fn``, which lays the weights out
by ``param_shardings`` on its first call (``distribute_model``; each rank
keeps its own shard of the same whole weights).  ``rules.mesh`` must then
be a live ``DeviceMesh``; a ``MeshShape`` (``make_production_mesh``)
serves for specs and placements alone, with the model on ``meta``.
"""
from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs import shape_variant
from repro_torch.distributed.sharding import (
    AxisRules,
    batch_spec,
    cache_shardings,
    distribute_cache,
    distribute_model,
    mesh_sizes,
    param_shardings,
    placements,
    rows_shardable,
    use_rules,
)
from repro_torch.models.cache import init_cache
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import Model
from repro_torch.training.loop import (
    TrainConfig,
    make_train_step,
    shard_batch,
    trainable,
)
from repro_torch.training.optimizer import AdamWConfig, init_opt_state


@dataclass
class StepPlan:
    """One step: ``fn(*args)``, the ``meta`` specs of its arguments, the
    placements of its arguments and results (None where the reference
    leaves a result's layout to the compiler), and the placements of the
    model's weights (the reference's first argument; here the model holds
    them).  ``lay_out(args)`` turns whole arguments on the model's device
    into what ``fn`` takes (the AdamW state beside the laid-out weights,
    the cache as ``DTensor``s); ``donate_argnums`` are the arguments
    ``fn`` updates in place, as the reference's."""

    name: str
    fn: Callable
    args: tuple                  # meta tensors (dicts of them)
    in_placements: Any
    out_placements: Any
    model: Model
    cfg: ModelConfig
    param_placements: dict
    rules: AxisRules | None = None
    lay_out: Callable = lambda args: args
    donate_argnums: tuple = ()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The model inputs of one assigned input shape, as ``meta`` tensors:
    ``tokens`` and ``targets`` [B, S] int32 for train and prefill (the
    encoder-decoder's halves beside ``frames`` [B, S/2, D]; the VLM's
    text beside ``image_embeds`` [B, N_img, D], in the model dtype), one
    token [B, 1] for decode."""
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            half = s // 2
            return {"tokens": _meta((b, half), i32),
                    "targets": _meta((b, half), i32),
                    "frames": _meta((b, half, cfg.d_model), dt)}
        if cfg.arch_type == "vlm":
            s_text = s - cfg.num_image_tokens
            return {"tokens": _meta((b, s_text), i32),
                    "targets": _meta((b, s_text), i32),
                    "image_embeds": _meta((b, cfg.num_image_tokens,
                                           cfg.d_model), dt)}
        return {"tokens": _meta((b, s), i32), "targets": _meta((b, s), i32)}
    return {"tokens": _meta((b, 1), i32)}


def _batch_placements(specs: dict, rules: AxisRules) -> dict:
    """Each input's placements: ``training.loop.shard_batch``'s layout."""
    spec = batch_spec(rules, batch_shardable=rows_shardable(
        specs["tokens"].shape[0], rules))
    return {k: placements(spec, rules.mesh) for k in specs}


def make_plan(cfg: ModelConfig, shape: InputShape, rules: AxisRules, *,
              remat: str | None = "dots", opt: AdamWConfig | None = None,
              unroll: bool = True, grad_accum: int = 1,
              device="cuda") -> StepPlan:
    """Build the (train | prefill | serve) step of an (arch x shape)
    combination, the model on ``device`` (``meta`` for specs alone).

    * train: ``fn(opt_state, batch) -> metrics``, one AdamW step of
      ``plan.model`` in place (``training.loop.make_train_step``); with
      ``grad_accum > 1`` the global batch is cut into that many
      microbatches whose f32 gradients, each divided by ``grad_accum``,
      are summed before the update (the metrics are the last
      microbatch's, with ``grad_norm`` and ``lr``);
    * prefill: ``fn(batch) -> (logits[:, -1:], state)``, ``forward`` with
      ``collect_state`` at ``cfg.sliding_window``;
    * serve: ``fn(cache, tokens, pos) -> (logits, cache)``, one
      ``decode_step`` over a cache laid out by ``cache_specs``
      (``sharding.distribute_cache``), updated in place; the tokens ride
      the data axes only when the batch is at least their size, and
      ``pos`` [B] is whole on every rank.

    ``unroll`` (the reference's layer-scan unrolling for XLA's cost
    analysis) means nothing here: the port's layers are a Python loop.
    """
    del unroll
    cfg = shape_variant(cfg, shape)
    model = Model(cfg, device=device)
    mesh = rules.mesh
    repl = placements((), mesh)
    psh = param_shardings(model, rules)
    specs = input_specs(cfg, shape)

    laid_out = []

    def distributed() -> Model:
        """The model with its weights laid out, on the first call only."""
        if not laid_out:
            laid_out.append(distribute_model(model, rules))
        return model

    if shape.kind == "train":
        opt = opt or AdamWConfig()
        tcfg = TrainConfig(opt=opt, remat=remat)
        mdt = torch_dtype(opt.moment_dtype)
        moments = {n: _meta(p.shape, mdt)
                   for n, p in model.named_parameters()}
        oshapes = {"m": moments, "v": dict(moments),
                   "step": _meta((), torch.int32)}
        osh = {"m": psh, "v": psh, "step": repl}
        steps = []

        def train_step(opt_state: dict, batch: dict) -> dict:
            if not steps:
                steps.append(make_train_step(model, tcfg, rules,
                                             grad_accum=grad_accum))
            return steps[0](opt_state, batch)

        def lay_out(args):
            opt_state = init_opt_state(trainable(distributed()),
                                       opt.moment_dtype)
            return opt_state, args[1]

        return StepPlan("train_step", train_step, (oshapes, specs),
                        (osh, _batch_placements(specs, rules)), (osh, None),
                        model, cfg, psh, rules, lay_out, (0,))

    if shape.kind == "prefill":
        specs_p = {k: v for k, v in specs.items() if k != "targets"}

        @torch.no_grad()
        def prefill_step(batch: dict):
            m = distributed()
            with use_rules(rules):
                b = shard_batch(batch, rules)
                logits, state = m.forward(
                    b["tokens"], image_embeds=b.get("image_embeds"),
                    frames=b.get("frames"), collect_state=True,
                    sliding_window=cfg.sliding_window or None)
            return logits[:, -1:], state

        return StepPlan("prefill_step", prefill_step, (specs_p,),
                        (_batch_placements(specs_p, rules),), None, model,
                        cfg, psh, rules)

    b, s = shape.global_batch, shape.seq_len
    src_len = s // 2 if cfg.is_encoder_decoder else None
    cache_shapes = init_cache(cfg, b, s, src_len=src_len, device="meta")
    csh = cache_shardings(cache_shapes, rules, batch=b)
    tok_pl = placements(batch_spec(rules, batch_shardable=b >= rules.axis_size(
        rules.data_axes) and rows_shardable(b, rules)), mesh)

    def serve_step(cache: dict, tokens: torch.Tensor, pos: torch.Tensor):
        from torch.distributed.tensor import distribute_tensor

        m = distributed()
        with use_rules(rules):
            tok = distribute_tensor(tokens, mesh, tok_pl, src_data_rank=None)
            logits = m.decode_step(cache, tok, pos)
        return logits, cache

    def lay_out(args):
        return (distribute_cache(args[0], rules, batch=b),) + tuple(args[1:])

    return StepPlan("serve_step", serve_step,
                    (cache_shapes, specs["tokens"], _meta((b,), torch.int32)),
                    (csh, tok_pl, repl), (None, csh), model, cfg, psh, rules,
                    lay_out, (0,))



# ---------------------------------------------------------------------------
# Counting a plan: the port's ``jit(...).lower().compile()``.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(mesh):
    """A world of ``prod(mesh.sizes)`` fake ranks, this process rank 0,
    yielding a ``DeviceMesh`` of ``mesh``'s (a ``MeshShape``) names and
    sizes over it.  Collectives send nothing and return tensors of the
    right shapes.  The fake world is the default process group: it
    refuses to open while another group is live, and is destroyed on
    exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is live: count a plan in a "
                           "process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.sizes))
    try:
        yield init_device_mesh("cpu", tuple(mesh.sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def local_shape(shape, pls, mesh) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` laid out by ``pls`` on
    ``mesh``: each ``Shard(d)`` over a mesh dim of size n leaves the
    first of ``torch.chunk``'s n pieces, ceil(size / n) rows."""
    out = list(shape)
    for n, pl in zip(mesh_sizes(mesh).values(), pls):
        if pl.is_shard():
            out[pl.dim] = -(-out[pl.dim] // n)
    return tuple(out)


def _pairs(tree, pls):
    """(tensor, placements) of every leaf of ``tree``, ``pls`` its
    mirror (a placements list at each leaf; None: replicated)."""
    if isinstance(tree, torch.Tensor):
        yield tree, pls
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, None if pls is None else pls[k])
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _pairs(v, None if pls is None else pls[i])


def _leaves(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def argument_bytes(plan: StepPlan) -> int:
    """Rank 0's bytes of the step's arguments, from the placements alone:
    the weights (the reference's first argument) and every argument of
    ``fn`` (AdamW state and batch, the batch, or the cache, tokens and
    positions)."""
    mesh = plan.rules.mesh
    params = dict(plan.model.named_parameters())
    total = sum(_nbytes(local_shape(params[n].shape, pls, mesh),
                        params[n].dtype)
                for n, pls in plan.param_placements.items())
    for t, pls in _pairs(plan.args, plan.in_placements):
        shape = t.shape if pls is None else local_shape(t.shape, pls, mesh)
        total += _nbytes(shape, t.dtype)
    return total


@dataclass
class MemoryAnalysis:
    """The reference's ``compiled.memory_analysis()`` fields, per device:
    peak = temp + argument + output - alias."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int


@dataclass
class Counted:
    """What ``lower_plan`` counted of one step on rank 0: read as the
    reference reads a compiled executable (``cost_analysis()``,
    ``memory_analysis()``).  ``collectives`` maps the reference's
    collective names to link bytes (``roofline.collective_traffic``),
    ``nvlink_bytes`` is their part whose groups lie within one host."""

    flops: float
    bytes_accessed: float
    collectives: dict
    nvlink_bytes: float
    memory: MemoryAnalysis

    def cost_analysis(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed}

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory


# Ops that move no bytes: allocations, views (``OpOverload.is_view``
# covers the rest) and the wait on a collective's result.
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view", "_reshape_alias", "wait_tensor"}


def _counter_mode(fake_mode):
    """A dispatch mode that counts rank 0's FLOPs and bytes.  It steps
    aside for ``DTensor`` ops (returns ``NotImplemented``), so it sees the
    ops ``DTensor`` runs on each rank's local shards; ops on tensors of
    another fake mode or on ``meta`` (``DTensor``'s sharding propagation
    on global shapes) are not counted."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    def ours(t) -> bool:
        return (isinstance(t, FakeTensor) and t.fake_mode is fake_mode
                and t.device.type != "meta")

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if not isinstance(func, torch._ops.OpOverload):
                return out
            outs = [t for t in _leaves(out) if ours(t)]
            if not outs:
                return out
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            name = packet.__name__
            if not func.is_view and name not in _NO_BYTES:
                ins = [t for t in _leaves((args, kwargs)) if ours(t)]
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
            return out

    return Counter()


def _comm_recorder():
    """A ``CommDebugMode`` that also keeps each collective's reference
    name, result bytes on this rank and group ranks in ``records``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.roofline import op_name

    def ranks_of(args) -> list:
        for a in args:
            if isinstance(a, dist.ProcessGroup):
                return dist.get_process_group_ranks(a)
        for a in reversed(args):
            if isinstance(a, str):
                return dist.get_process_group_ranks(_resolve_process_group(a))
        return list(range(dist.get_world_size()))

    class NoModules:
        """``CommDebugMode``'s per-module breakdown, left out: its module
        hooks fail on a module called twice in one step (the hybrid's
        shared attention block), and the records need no module."""

        name = "Global"
        is_bw = False
        activation_checkpointing = False
        module_parents_dict = {"Global": set()}

        def __enter__(self):
            return self

        def __exit__(self, *args):
            pass

    class CommRecorder(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.advanced_module_tracker = NoModules()
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not isinstance(
                    func, torch._ops.OpOverload):
                return out
            op = op_name(func._schema.name)
            if op is not None and func.namespace in (
                    "_c10d_functional", "c10d_functional", "c10d",
                    "_c10d_functional_autograd", "_dtensor"):
                result = sum(t.numel() * t.element_size()
                             for t in _leaves(out))
                self.records.append((op, result, ranks_of(args)))
            return out

    return CommRecorder()


# What ``_metadata_unfaked`` patches: (module, class or None, name).
_UNFAKED = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._decompositions", "DecompShardingStrategy",
     "propagate_strategy"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
)


def _patch_target(module: str, cls: str):
    """The class ``cls`` of ``module``; a torch without it raises, since
    the count would otherwise depend on the version."""
    import importlib

    try:
        return getattr(importlib.import_module(module), cls)
    except (ImportError, AttributeError) as e:
        raise RuntimeError(
            f"lower_plan: torch {torch.__version__} has no {module}.{cls}, "
            "which the count patches; a version whose DTensor differs "
            "would count another plan") from e


@contextlib.contextmanager
def _metadata_unfaked():
    """While a plan is counted, ``DTensor``'s own metadata work runs
    outside the counting fake mode, as it does outside any fake mode: its
    sharding propagation traces each op once at global shapes, and runs
    the decomposition of an op it has no rule for on global ``meta``
    tensors (both would reuse the active fake mode, and their
    global-shape ops would be counted and tracked as rank 0's, on the
    first counts of a process only), and a strided shard's local size is read
    back from a small index tensor (``tolist`` fails on a fake one).
    The strided shard's sizes are index arithmetic on real tensors of a
    dim's length (a million rows of tokens), asked again at every cost
    estimate: each answer is kept for the count.  And a change of
    sharded dim runs the all-to-all it runs on the card's NCCL mesh.
    Every target must exist in this torch (``_patch_target``): no
    version skips a patch unnoticed (``DTensor``'s own plan of a
    redistribution still differs between versions)."""
    import inspect
    import sys

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _collective_utils

    saved = []
    try:
        for module, cls_name, name in _UNFAKED:
            cls = _patch_target(module, cls_name)
            raw = inspect.getattr_static(cls, name, None)
            if raw is None:
                raise RuntimeError(f"lower_plan: torch {torch.__version__} "
                                   f"has no {cls_name}.{name} to patch")
            wrap = type(raw) if isinstance(raw, (staticmethod,
                                                 classmethod)) else None
            fn = raw.__func__ if wrap else raw
            memo = {} if cls_name == "_StridedShard" else None

            def unfaked(*a, _fn=fn, _memo=memo, **k):
                key = (a, tuple(sorted(k.items())))
                if _memo is not None and key in _memo:
                    return copy.deepcopy(_memo[key])
                with unset_fake_temporarily():
                    out = _fn(*a, **k)
                if _memo is not None:
                    _memo[key] = copy.deepcopy(out)
                return out

            setattr(cls, name, wrap(unfaked) if wrap else unfaked)
            saved.append((cls, name, raw))

        # The card's all-to-all for a change of sharded dim: on a CPU mesh
        # DTensor gathers the whole dim and keeps a chunk instead (gloo
        # has no all-to-all), n times the bytes and the memory.  The
        # function is replaced wherever a module of DTensor holds it.
        original = getattr(_collective_utils, "shard_dim_alltoall", None)
        if original is None:
            raise RuntimeError(f"lower_plan: torch {torch.__version__} has "
                               "no _collective_utils.shard_dim_alltoall to "
                               "patch")

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                mesh.get_group(mesh_dim).group_name)

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("torch.distributed")
                    and getattr(mod, "shard_dim_alltoall", None) is original):
                saved.append((mod, "shard_dim_alltoall", original))
                mod.shard_dim_alltoall = alltoall
        yield
    finally:
        for cls, name, raw in reversed(saved):
            setattr(cls, name, raw)


def _fake_model(model: Model, fake_mode) -> None:
    """Every parameter and buffer of a ``meta`` model replaced by an
    uninitialised fake tensor on the CPU (no storage)."""
    from torch import nn

    with fake_mode:
        for mod in model.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                if p.device.type == "meta":
                    mod.register_parameter(name, nn.Parameter(
                        torch.empty(p.shape, dtype=p.dtype),
                        requires_grad=p.requires_grad))
            for name, b in list(mod.named_buffers(recurse=False)):
                if b is not None and b.device.type == "meta":
                    mod.register_buffer(name, torch.empty(b.shape,
                                                          dtype=b.dtype))
    model.device = torch.device("cpu")


def _fake_args(tree, fake_mode):
    if isinstance(tree, torch.Tensor):
        with fake_mode:
            return torch.empty(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _fake_args(v, fake_mode) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fake_args(v, fake_mode) for v in tree)
    return tree


def lower_plan(plan: StepPlan) -> Counted:
    """Run ``plan.fn`` once on fake tensors and count rank 0's share: the
    port's ``jit(...).lower().compile()``.  The plan is built on
    ``device="meta"`` over a ``DeviceMesh`` of ``fake_world``, inside it
    (the plan's model is spent: its weights become fake tensors).

    * FLOPs: ``torch.utils.flop_counter``'s formulas on rank 0's local
      shapes, beneath ``DTensor`` (its own ``FlopCounterMode`` would count
      each ``DTensor`` op's global shapes).  The registry counts products
      and attention only; XLA's ``cost_analysis`` counts elementwise ops
      too, so the port's count is the lower.
    * Bytes accessed: every aten op's operand and result bytes at local
      shapes, views and allocations left out.  Nothing is fused, so this
      is an upper bound on a fused run of the same ops, where XLA's
      count is post-fusion; the plain versions' arithmetic makes it
      overcount a step on the card too (its time over the HBM rate is
      no bound on the step's).
    * Collectives: ``CommDebugMode``'s ops, each result on rank 0 priced
      by ``roofline.collective_traffic``.
    * Memory: ``argument_bytes`` from the placements, and
      ``MemTracker``'s peak rise over the weights and the donated
      arguments while the step runs (what it allocates on top of them).

    On fake CPU tensors the kernels' plain versions run
    (``kernels.ops``), so the arithmetic counted is theirs, as the
    reference counts its jnp code and not Pallas.  The layer loop is
    Python: every layer is counted, with no scan body counted once."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.roofline import collectives_from

    mesh = plan.rules.mesh if plan.rules is not None else None
    if mesh is None or not hasattr(mesh, "mesh_dim_names"):
        raise ValueError("lower_plan needs a plan built over a DeviceMesh "
                         "of fake_world(...)")
    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("lower_plan runs in a fake world only "
                           "(fake_world): another process group is live"
                           if dist.is_initialized() else
                           "lower_plan runs inside fake_world(...)")
    arg_bytes = argument_bytes(plan)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    _fake_model(plan.model, fake_mode)
    with _metadata_unfaked(), fake_mode:
        distribute_model(plan.model, plan.rules)
        args = plan.lay_out(_fake_args(plan.args, fake_mode))
        counter = _counter_mode(fake_mode)
        comm = _comm_recorder()
        mem = _mem_tracker(fake_mode)
        mem.track_external(plan.model,
                           [args[i] for i in plan.donate_argnums])
        held = _total(mem.get_tracker_snapshot("current"))
        with mem, comm, counter:
            out = plan.fn(*args)
        rise = _total(mem.get_tracker_snapshot("peak")) - held
    donated = {id(t) for i in plan.donate_argnums for t in _leaves(args[i])}
    outs = list(_leaves(out))
    out_bytes = sum(_local_nbytes(t) for t in outs)
    alias = sum(_local_nbytes(t) for t in outs if id(t) in donated)
    colls, nvlink = collectives_from(comm)
    return Counted(
        flops=float(counter.flops), bytes_accessed=float(counter.bytes),
        collectives=colls, nvlink_bytes=nvlink,
        memory=MemoryAnalysis(
            argument_size_in_bytes=arg_bytes,
            output_size_in_bytes=out_bytes,
            temp_size_in_bytes=max(rise - (out_bytes - alias), 0),
            alias_size_in_bytes=alias))


def _mem_tracker(fake_mode):
    """A ``MemTracker`` that keeps the step's total alone: its per-module
    breakdown (module hooks, and a walk over every module seen at each
    op, so a count's time grows with the square of the depth) is left
    out, and so are ops run under another fake mode than ``fake_mode``
    (``DTensor``'s metadata work, ``_metadata_unfaked``; some versions
    of ``MemTracker`` would track them).  The weights and the donated
    arguments are tracked as external state before the step; every op's
    result is tracked as it is made."""
    from torch.distributed._tools.mem_tracker import MemTracker

    fake_key = torch._C._TorchDispatchModeKey.FAKE

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if torch._C._get_dispatch_mode(fake_key) is not fake_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _pre_fw_hook(self, module, inputs) -> None:
            pass

        def _post_fw_hook(self, module, inputs, outputs) -> None:
            pass

        def _pre_bw_hook(self, module, args) -> None:
            pass

        def _post_bw_hook(self, module, args) -> None:
            pass

    return Tracker()


def _total(snapshot: dict) -> int:
    return sum(d.get("Total", 0) for d in snapshot.values())


def _local_nbytes(t: torch.Tensor) -> int:
    from repro_torch.distributed.sharding import local

    t = local(t)
    return t.numel() * t.element_size()
