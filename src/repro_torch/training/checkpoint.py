"""Checkpoints in the reference's file layout (``repro/training/
checkpoint.py``): ``params.npz`` and ``opt_state.npz`` keyed by the
``/``-joined path of each leaf in the reference's tree (``_flatten``),
and ``meta.json`` with the step and any metadata.

The port writes through ``convert.params_to_numpy`` (and the moments
through the same layout), so a reference checkpoint loads into the port
and a port checkpoint into the reference (``load_checkpoint(path,
params_template, opt_template)``).  bf16 arrays go as their raw 16-bit
words: the card's machine has no ``ml_dtypes``, and reading them back
into a bf16 tensor keeps every bit.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.convert import _tensor, copy_whole_into, fill_from_numpy
from repro_torch.convert import named_from_numpy
from repro_torch.convert import named_to_numpy
from repro_torch.distributed.sharding import whole
from repro_torch.models.model import Model


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}`` (the reference's keys: a
    dict's keys in sorted order, as ``jax.tree_util`` walks them)."""
    flat = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], dict):
            flat.update(_flatten(tree[key], path))
        else:
            flat[path] = np.asarray(tree[key])
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = a
    return tree


def save_checkpoint(path: str, model: Model, opt_state: dict | None = None,
                    *, step: int = 0, metadata: dict | None = None) -> None:
    """Write ``model``'s weights and, when given, the optimizer state
    (``m``, ``v``, ``step``) under ``path``.  A sharded model (``DTensor``
    parameters) is gathered tensor by tensor, a collective every rank
    calls, and only rank 0 writes.  One whole tensor at a time is on a
    device: rank 0 moves it to the host at once, and the others drop it."""
    writer = _writer()

    def gathered(tensors: dict) -> dict:
        out = {}
        for n, t in tensors.items():
            full = whole(t)
            if writer:
                out[n] = full.detach().cpu()
            del full
        return out

    params = gathered(dict(model.named_parameters()))
    moments = (None if opt_state is None else
               {part: gathered(opt_state[part]) for part in ("m", "v")})
    if not writer:
        return
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"),
             **_flatten(named_to_numpy(model, params)))
    if opt_state is not None:
        tree = {"m": named_to_numpy(model, moments["m"]),
                "v": named_to_numpy(model, moments["v"]),
                "step": np.asarray(int(opt_state["step"]), dtype=np.int32)}
        np.savez(os.path.join(path, "opt_state.npz"), **_flatten(tree))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, **(metadata or {})}, f)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the
    only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


@torch.no_grad()
def load_checkpoint(path: str, model: Model, opt_state: dict | None = None):
    """Read a checkpoint (the port's or the reference's) into ``model`` in
    place and, when ``opt_state`` is given and the file exists, into its
    moments and step in place.  Every rank reads the files; a sharded
    parameter or moment keeps its own shard.  Returns ``(model, opt_state, meta)``;
    ``opt_state`` is None when it was not given or not saved."""
    with np.load(os.path.join(path, "params.npz")) as f:
        fill_from_numpy(model, _unflatten(dict(f)))
    opt_file = os.path.join(path, "opt_state.npz")
    if opt_state is not None and os.path.exists(opt_file):
        with np.load(opt_file) as f:
            tree = _unflatten(dict(f))
        for part in ("m", "v"):
            arrays = named_from_numpy(model, tree[part])
            for name, t in opt_state[part].items():
                src = _tensor(arrays[name], t.dtype)
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{part}/{name}: shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(t.shape)}")
                copy_whole_into(t, src)
        opt_state["step"].fill_(int(tree["step"]))
    else:
        opt_state = None
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return model, opt_state, meta
