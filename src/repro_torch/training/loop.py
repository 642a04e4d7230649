"""The training loop, the port's counterpart of ``repro/training/
loop.py``: ``make_train_step`` returns one step (``Model.train_loss``,
its gradient by autograd, ``adamw_update``), and ``train`` runs it over
a dataset.

The model holds its weights: ``train`` takes a ``Model`` filled by
``init(generator)`` or ``convert.params_from_numpy`` (the reference
draws them from ``PRNGKey(seed)`` inside ``train``).  The moments are
kept in ``tcfg.opt.moment_dtype`` (the reference's ``train`` ignores
that field and keeps f32: ROADMAP section 3).  No mesh: the reference's
``rules`` / ``zero1`` wait for the tools.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

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


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """``step(opt_state, batch) -> metrics``: the loss and its gradient
    over ``batch`` (tensors on the model's device), then one AdamW update
    of the model's parameters and ``opt_state`` in place.  The metrics
    are f32 device scalars: ``ce``, ``aux``, ``loss``, ``grad_norm`` and
    ``lr``."""
    params = trainable(model)

    def step(opt_state: dict, batch: dict) -> dict:
        for p in params.values():
            p.grad = None
        loss, metrics = model.train_loss(batch, remat=tcfg.remat)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        _, _, opt_metrics = adamw_update(tcfg.opt, params, grads, opt_state)
        for p in params.values():
            p.grad = None
        return {**{k: v.detach() for k, v in metrics.items()},
                **opt_metrics}

    return step


def train(model: Model, dataset, tcfg: TrainConfig, *, num_steps: int,
          log_fn: Callable[[int, dict], None] | None = None):
    """``num_steps`` steps over ``dataset.batches()``; returns
    ``(model, opt_state, history)``.  ``history`` holds a row every
    ``log_every`` steps and at the last: the metrics as floats, ``step``
    and ``elapsed_s`` (host seconds since the first step began)."""
    opt_state = init_opt_state(trainable(model), tcfg.opt.moment_dtype)
    step_fn = make_train_step(model, tcfg)
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
