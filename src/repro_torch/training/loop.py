"""The training loop, the port's counterpart of ``repro/training/
loop.py``: ``make_train_step`` returns one step (``Model.train_loss``,
its gradient by autograd, ``adamw_update``), and ``train`` runs it over
a dataset.

The model holds its weights: ``train`` takes a ``Model`` filled by
``init(generator)`` or ``convert.params_from_numpy`` (the reference
draws them from ``PRNGKey(seed)`` inside ``train``).  The moments are
kept in ``tcfg.opt.moment_dtype`` (the reference's ``train`` ignores
that field and keeps f32: ROADMAP section 3).  With ``rules`` the step
runs sharded over a ``torch.distributed`` device mesh
(``repro_torch.distributed``): parameters, moments and batch are
``DTensor``s, the kernels run on each rank's shards, and ``zero1``
shards the replicated parameters' moments over the data axes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    AxisRules,
    batch_spec,
    distribute_model,
    param_specs,
    placements,
    rows_shardable,
    use_rules,
    whole,
)
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
)


@dataclass
class TrainConfig:
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    remat: str | None = None
    log_every: int = 10
    zero1: bool = False      # shard optimizer moments over data


def trainable(model: Model) -> dict[str, torch.Tensor]:
    """The model's parameters by name, each set to require grad."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def to_device(batch: dict, device) -> dict:
    """A numpy batch (``training.data``) as tensors on ``device``, each in
    its numpy dtype (int32 token ids, f32 frontend embeddings)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def zero1_layouts(model: Model, rules: AxisRules) -> dict[str, list]:
    """ZeRO-1's moment layouts: each parameter whose spec names no mesh
    axis keeps its moments sharded over the data axes, on its first dim
    that divides them (a parameter with no such dim keeps them whole).
    The reference means this with ``TrainConfig.zero1`` but shards
    nothing (ROADMAP section 3)."""
    dsize = rules.axis_size(rules.data_axes)
    out = {}
    for name, spec in param_specs(model, rules).items():
        if any(axes is not None for axes in spec):
            continue
        shape = model.get_parameter(name).shape
        for d, n in enumerate(shape):
            if n % dsize == 0:
                out[name] = placements(
                    tuple(rules.data if i == d else None
                          for i in range(len(shape))), rules.mesh)
                break
    return out


def shard_batch(batch: dict, rules: AxisRules | None) -> dict:
    """The global ``batch`` (the same on every rank) as ``DTensor``s laid
    out by ``batch_spec``, each rank keeping its rows (every rank keeps
    them all where the batch does not divide the data axes); without
    rules, ``batch`` itself."""
    if rules is None:
        return batch
    from torch.distributed.tensor import distribute_tensor

    spec = batch_spec(rules, batch_shardable=rows_shardable(
        batch["tokens"].shape[0], rules))
    pls = placements(spec, rules.mesh)
    return {k: distribute_tensor(v, rules.mesh, pls, src_data_rank=None)
            for k, v in batch.items()}


def make_train_step(model: Model, tcfg: TrainConfig,
                    rules: AxisRules | None = None, *,
                    grad_accum: int = 1) -> Callable:
    """``step(opt_state, batch) -> metrics``: the loss and its gradient
    over ``batch`` (tensors on the model's device), then one AdamW update
    of the model's parameters and ``opt_state`` in place.  The metrics
    are f32 device scalars: ``ce``, ``aux``, ``loss``, ``grad_norm`` and
    ``lr``.

    With ``grad_accum > 1`` the batch is cut into that many microbatches
    of consecutive rows; their gradients, each cast to f32 and divided by
    ``grad_accum``, are summed before the update, as the reference's
    ``lax.scan`` accumulates them, and ``ce``, ``aux`` and ``loss`` are
    the last microbatch's.

    With ``rules`` the model's parameters become ``DTensor``s laid out by
    ``param_shardings`` (``distribute_model``), the step runs under the
    rules, each rank keeps its rows of the global batch (``shard_batch``)
    and the metrics come back whole on every rank."""
    if rules is not None:
        distribute_model(model, rules)
    params = trainable(model)

    def grad_of(batch: dict) -> dict:
        with use_rules(rules):
            loss, metrics = model.train_loss(shard_batch(batch, rules),
                                             remat=tcfg.remat)
            loss.backward()
        return metrics

    def step(opt_state: dict, batch: dict) -> dict:
        for p in params.values():
            p.grad = None
        if grad_accum <= 1:
            metrics = grad_of(batch)
            grads = {n: p.grad for n, p in params.items()}
        else:
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
            rows = batch["tokens"].shape[0] // grad_accum
            for i in range(grad_accum):
                metrics = grad_of({k: v[i * rows:(i + 1) * rows]
                                   for k, v in batch.items()})
                for n, p in params.items():
                    if p.grad is not None:
                        grads[n] = grads[n] + p.grad.float() / grad_accum
                    p.grad = None
        _, _, opt_metrics = adamw_update(tcfg.opt, params, grads, opt_state)
        for p in params.values():
            p.grad = None
        return {**{k: whole(v.detach()) for k, v in metrics.items()},
                **opt_metrics}

    return step


def train(model: Model, dataset, tcfg: TrainConfig, *, num_steps: int,
          rules: AxisRules | None = None,
          log_fn: Callable[[int, dict], None] | None = None):
    """``num_steps`` steps over ``dataset.batches()``; returns
    ``(model, opt_state, history)``.  ``history`` holds a row every
    ``log_every`` steps and at the last: the metrics as floats, ``step``
    and ``elapsed_s`` (host seconds since the first step began).  With
    ``rules`` every rank draws the same global batches and the model is
    trained sharded (``make_train_step``); ``tcfg.zero1`` then shards the
    moments of the replicated parameters over the data axes
    (``zero1_layouts``)."""
    step_fn = make_train_step(model, tcfg, rules)
    layouts = (zero1_layouts(model, rules)
               if rules is not None and tcfg.zero1 else None)
    opt_state = init_opt_state(trainable(model), tcfg.opt.moment_dtype,
                               layouts)
    it = dataset.batches()
    history = []
    t0 = time.perf_counter()
    for step in range(num_steps):
        batch = to_device(next(it), model.device)
        metrics = step_fn(opt_state, batch)
        if step % tcfg.log_every == 0 or step == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            if log_fn:
                log_fn(step, m)
    return model, opt_state, history
