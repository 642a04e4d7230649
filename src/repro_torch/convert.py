"""Load the reference's parameter tree into the port's ``Model``.

``params_from_numpy`` takes the pytree ``repro.models.model.Model.init``
returns, already mapped to numpy arrays by the caller (for instance
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.  The
reference stacks the layers of ``params["blocks"]`` along a leading axis
(``repro/models/model.py:514``); they are unstacked into
``Model.blocks``.  Weight layouts are the same (``[in, out]``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: move the raw words
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> Model:
    """A ``Model`` on ``device`` holding the weights of ``tree``."""
    model = Model(cfg, device=device)

    def put(param: torch.Tensor, a) -> None:
        t = _tensor(a)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(param.shape)}")
        param.copy_(t)

    put(model.embed.tok, tree["embed"]["tok"])
    if not cfg.tie_embeddings:
        put(model.embed.unembed, tree["embed"]["unembed"])
    blocks = tree["blocks"]
    for l, blk in enumerate(model.blocks):
        for norm in ("norm1", "norm2"):
            for name, param in getattr(blk, norm).named_parameters():
                put(param, blocks[norm][name][l])
        for name, param in blk.attn.named_parameters():
            put(param, blocks["attn"][name][l])
        for name, param in blk.mlp.named_parameters():
            put(param, blocks["mlp"][name][l])
    for name, param in model.final_norm.named_parameters():
        put(param, tree["final_norm"][name])
    return model
