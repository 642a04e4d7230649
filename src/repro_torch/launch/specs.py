"""Input specs and the steps of every (arch x shape): the port's
``repro/launch/specs.py``.

``input_specs`` gives the model inputs of one assigned shape as ``meta``
tensors (the reference's ``ShapeDtypeStruct``s: shapes and dtypes, no
storage).  ``make_plan`` builds the model and one step -- train, prefill
or serve -- with the ``DTensor`` placements of its weights, arguments
and results on ``rules.mesh``.  The reference lowers its plans with
``jax.jit(...).lower``; the port has no such twin, and what a plan is
lowered to waits for the dry-run tools (ROADMAP.md, queue 1).

The model holds its weights, so a plan's ``fn`` takes no parameters: the
caller fills ``plan.model`` (``convert.params_from_numpy``, or
``Model.init`` from a seed) and calls ``fn``, which lays the weights out
by ``param_shardings`` on its first call (``distribute_model``; each rank
keeps its own shard of the same whole weights).  ``rules.mesh`` must then
be a live ``DeviceMesh``; a ``MeshShape`` (``make_production_mesh``)
serves for specs and placements alone, with the model on ``meta``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs import shape_variant
from repro_torch.distributed.sharding import (
    AxisRules,
    batch_spec,
    cache_shardings,
    distribute_model,
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
)
from repro_torch.training.optimizer import AdamWConfig


@dataclass
class StepPlan:
    """One step: ``fn(*args)``, the ``meta`` specs of its arguments, the
    placements of its arguments and results (None where the reference
    leaves a result's layout to the compiler), and the placements of the
    model's weights (the reference's first argument; here the model holds
    them)."""

    name: str
    fn: Callable
    args: tuple                  # meta tensors (dicts of them)
    in_placements: Any
    out_placements: Any
    model: Model
    cfg: ModelConfig
    param_placements: dict


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

        return StepPlan("train_step", train_step, (oshapes, specs),
                        (osh, _batch_placements(specs, rules)), (osh, None),
                        model, cfg, psh)

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
                        cfg, psh)

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

    return StepPlan("serve_step", serve_step,
                    (cache_shapes, specs["tokens"], _meta((b,), torch.int32)),
                    (csh, tok_pl, repl), (None, csh), model, cfg, psh)

