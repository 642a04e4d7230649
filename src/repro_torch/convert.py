"""The reference's parameter tree and the port's ``Model``, both ways.

``params_from_numpy`` takes the pytree ``repro.models.model.Model.init``
returns (dense, MoE, MLA, VLM, SSM, hybrid or encoder-decoder), already
mapped to numpy arrays by the caller (for instance ``jax.tree.map(
np.asarray, params)``), so this module needs no JAX.  The reference
stacks the layers of ``params["blocks"]`` along a leading axis
(``repro/models/model.py:514``); they are unstacked into
``Model.blocks``.  An MLA model with ``first_k_dense`` keeps its leading
dense layers in a second stack, ``params["blocks_dense"]``: layer ``l <
first_k_dense`` comes from there, the rest from ``params["blocks"]`` at
``l - first_k_dense``.  The hybrid's unstacked ``params["shared_attn"]``
fills ``Model.shared_attn``.  The encoder-decoder's ``params["encoder"]``
(stacked ``blocks`` and the ``norm``) fills ``Model.encoder`` and
``Model.encoder_norm``, and its stacked ``params["cross"]`` (``norm``,
``attn``) fills ``Model.cross``.  The MLA model's ``params["mtp"]``
(``proj`` [depth, 2d, d], the stacked ``blocks``, the ``norm``) fills
``Model.mtp``.  Weight layouts are the same (``[in, out]``).

``params_to_numpy`` is the exact inverse: the model's weights as the
reference's tree of numpy arrays, layers stacked again, so a checkpoint
reads both ways (``training/checkpoint.py``).  Both take any tensors
keyed by the model's parameter names in place of the weights (the
optimizer's moments).  numpy has no bfloat16 of its own, so a bf16
tensor goes out as its raw 16-bit words (``uint16``); a bf16 parameter
reads such words, or an ``ml_dtypes`` bfloat16 array as the reference's
tree holds it, unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _tensor(a, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a`` as a tensor; an ``ml_dtypes`` bfloat16 array, or 16-bit raw
    words read into a bf16 ``dtype``, moves its words unchanged."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (
            dtype == torch.bfloat16 and a.dtype.itemsize == 2
            and a.dtype.kind != "f"):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host; bf16 as its raw words (``uint16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def locations(model: Model) -> dict[str, tuple[tuple[str, ...], int | None]]:
    """Where each parameter of ``model`` (by its ``named_parameters``
    name) lives in the reference's tree: the path of keys and, for a
    stacked layer, its index along the leading axis (else None)."""
    cfg = model.cfg
    k = cfg.first_k_dense if cfg.use_mla else 0
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        top = parts[0]
        if top == "blocks":
            l = int(parts[1])
            stack = "blocks_dense" if l < k else "blocks"
            out[name] = ((stack, *parts[2:]), l - k if l >= k else l)
        elif top in ("encoder", "cross"):
            path = ("encoder", "blocks") if top == "encoder" else ("cross",)
            out[name] = ((*path, *parts[2:]), int(parts[1]))
        elif top == "encoder_norm":
            out[name] = (("encoder", "norm", *parts[1:]), None)
        elif top == "mtp" and parts[1] == "blocks":
            out[name] = (("mtp", "blocks", *parts[3:]), int(parts[2]))
        else:     # embed, shared_attn, final_norm, mtp.proj, mtp.norm
            out[name] = (tuple(parts), None)
    return out


def _node(tree: dict, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def named_from_numpy(model: Model, tree: dict) -> dict[str, np.ndarray]:
    """Each parameter name of ``model`` -> its array in ``tree`` (one
    layer of a stack); raises on a subtree the model has no place for."""
    locs = locations(model)
    unread = set(tree) - {path[0] for path, _ in locs.values()}
    if unread:
        raise ValueError(f"{model.cfg.name}: parameters the port does not "
                         f"read: {sorted(unread)}")
    out = {}
    for name, (path, i) in locs.items():
        a = _node(tree, path)
        out[name] = a if i is None else a[i]
    return out


def named_to_numpy(model: Model, tensors: dict[str, torch.Tensor]) -> dict:
    """The reference's tree of ``tensors`` (keyed by the model's
    parameter names), stacked layers on a leading axis again."""
    tree: dict = {}
    stacks: dict[tuple[str, ...], dict[int, np.ndarray]] = {}
    for name, (path, i) in locations(model).items():
        a = _numpy(tensors[name])
        if i is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = a
        else:
            stacks.setdefault(path, {})[i] = a
    for path, layers in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([layers[i] for i in range(len(layers))])
    return tree


@torch.no_grad()
def copy_whole_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole tensor ``src`` (the same on every rank) into
    ``dst``; a ``DTensor`` ``dst`` keeps its own shard of it."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    part = distribute_tensor(src.to(dst.to_local().device), dst.device_mesh,
                             list(dst.placements), src_data_rank=None)
    dst.to_local().copy_(part.to_local())


@torch.no_grad()
def fill_from_numpy(model: Model, tree: dict) -> Model:
    """Copy the weights of ``tree`` into ``model`` in place (a sharded
    parameter keeps its own shard); raises on a subtree the model has no
    place for and on a shape that differs from the model's."""
    arrays = named_from_numpy(model, tree)
    for name, param in model.named_parameters():
        t = _tensor(arrays[name], param.dtype)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(param.shape)}")
        copy_whole_into(param, t)
    return model


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> Model:
    """A ``Model`` on ``device`` holding the weights of ``tree``."""
    return fill_from_numpy(Model(cfg, device=device), tree)


def params_to_numpy(model: Model) -> dict:
    """The model's weights as the reference's parameter tree of numpy
    arrays (``repro.models.model.Model.init``'s layout), the exact inverse
    of ``params_from_numpy``."""
    return named_to_numpy(model, dict(model.named_parameters()))
