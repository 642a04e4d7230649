"""Load the reference's parameter tree into the port's ``Model``.

``params_from_numpy`` takes the pytree ``repro.models.model.Model.init``
returns (dense, MoE, MLA, VLM, SSM or hybrid), already mapped to numpy
arrays by the caller (for instance ``jax.tree.map(np.asarray, params)``),
so this module needs no JAX.  The reference stacks the layers of
``params["blocks"]`` along a leading axis (``repro/models/model.py:514``);
they are unstacked into ``Model.blocks``.  An MLA model with
``first_k_dense`` keeps its leading dense layers in a second stack,
``params["blocks_dense"]``: layer ``l < first_k_dense`` comes from
there, the rest from ``params["blocks"]`` at ``l - first_k_dense``.
The hybrid's unstacked ``params["shared_attn"]`` fills
``Model.shared_attn``.  The encoder-decoder's ``params["encoder"]``
(stacked ``blocks`` and the ``norm``) fills ``Model.encoder`` and
``Model.encoder_norm``, and its stacked ``params["cross"]`` (``norm``,
``attn``) fills ``Model.cross``.  Weight layouts are the same
(``[in, out]``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

# subtrees serving never reads: the multi-token-prediction head is
# training-only and comes with training (ROADMAP.md queue 1 item 10)
SKIPPED = ("mtp",)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: move the raw words
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> Model:
    """A ``Model`` on ``device`` holding the weights of ``tree``; raises
    on a subtree the model has no place for (``SKIPPED`` aside) and on a
    shape that differs from the model's."""
    model = Model(cfg, device=device)
    readable = {"embed", "blocks", "blocks_dense", "shared_attn",
                "final_norm", *SKIPPED}
    if cfg.is_encoder_decoder:
        readable |= {"encoder", "cross"}
    unread = set(tree) - readable
    if unread:
        raise ValueError(f"{cfg.name}: parameters the port does not read: "
                         f"{sorted(unread)}")

    def put(param: torch.Tensor, a) -> None:
        t = _tensor(a)
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(param.shape)}")
        param.copy_(t)

    def node(subtree: dict, name: str):
        for key in name.split("."):
            subtree = subtree[key]
        return subtree

    put(model.embed.tok, tree["embed"]["tok"])
    if not cfg.tie_embeddings:
        put(model.embed.unembed, tree["embed"]["unembed"])
    k = cfg.first_k_dense if cfg.use_mla else 0
    for l, blk in enumerate(model.blocks):
        # a block's parameters are named as the reference's subtrees:
        # norm1/attn/norm2/mlp (dense, VLM), norm1/attn/norm2/moe with
        # its nested ``shared`` (MoE), attn's MLA projections and norms
        # (MLA), or norm1/ssd (SSM, hybrid)
        stack, i = ((tree["blocks_dense"], l) if l < k
                    else (tree["blocks"], l - k))
        for name, param in blk.named_parameters():
            put(param, node(stack, name)[i])
    if model.shared_attn is not None:
        for name, param in model.shared_attn.named_parameters():
            put(param, node(tree["shared_attn"], name))
    if model.encoder is not None:
        enc = tree["encoder"]
        for i, blk in enumerate(model.encoder):
            for name, param in blk.named_parameters():
                put(param, node(enc["blocks"], name)[i])
        for name, param in model.encoder_norm.named_parameters():
            put(param, enc["norm"][name])
        for l, cb in enumerate(model.cross):
            for name, param in cb.named_parameters():
                put(param, node(tree["cross"], name)[l])
    for name, param in model.final_norm.named_parameters():
        put(param, tree["final_norm"][name])
    return model
