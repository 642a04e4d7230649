"""Model configs the port serves, and the reduced smoke variant.

The port's own copy of ``repro/configs/__init__.py``'s ``get_config`` and
``smoke_config``.  The registry holds the paper's own model,
``skymemory-tinyllama``; the reference's other architectures arrive with
the families that serve them (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "skymemory-tinyllama",   # the paper's own testbed model (§5)
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_configs() -> list[str]:
    return list(ARCH_IDS)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    heads = 4 if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, heads) or heads
    kw = dict(
        num_layers=2,
        d_model=d,
        num_heads=heads,
        num_kv_heads=max(1, kv if kv <= heads else heads),
        head_dim=d // heads if heads else 0,
        d_ff=2 * d,
        vocab_size=512,
        num_image_tokens=min(cfg.num_image_tokens, 16),
        moe_group_size=64,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=2 * d,
                  first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.use_mla:
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16, mtp_depth=cfg.mtp_depth)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.attn_layer_period:
        kw.update(attn_layer_period=1, num_layers=2)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=2)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCH_IDS", "get_config", "list_configs", "smoke_config"]
