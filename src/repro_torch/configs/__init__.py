"""Model configs the port serves, and the reduced smoke variant.

The port's own copy of ``repro/configs/__init__.py``'s ``get_config`` and
``smoke_config``.  The registry holds the paper's own model,
``skymemory-tinyllama``, the dense GQA, MoE and VLM families the paged
engine serves, and the attention-free ``mamba2-1.3b``, the hybrid
``zamba2-1.2b`` and the MLA ``deepseek-v3-671b`` the dense runtime
serves, and the encoder-decoder ``seamless-m4t-large-v2``, which runs
through ``Model.forward(frames=)`` and ``Model.decode_step`` (no engine
serves it, as in the reference).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = [
    "llava-next-34b",        # VLM: patch embeddings before the tokens
    "zamba2-1.2b",           # hybrid: SSD + a shared attention block
    "nemotron-4-340b",       # head_dim 192, squared ReLU, LayerNorm
    "yi-9b",
    "internlm2-1.8b",
    "mamba2-1.3b",           # attention-free SSD, the dense runtime
    "granite-moe-3b-a800m",  # MoE, stop-the-world admission
    "stablelm-12b",          # head_dim 160, partial rotary, LayerNorm
    "deepseek-v3-671b",      # MLA + MoE, the dense runtime
    "seamless-m4t-large-v2", # encoder-decoder: frames -> cross-attention
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


def shape_variant(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config tweaks: long-context decode needs sub-quadratic
    memory, so at ``long_500k`` every family but the SSM switches to a
    ring of 32,768 K/V slots (the hybrid's shared attention too); the
    SSM runs natively."""
    if shape.name == "long_500k" and cfg.arch_type != "ssm":
        return cfg.replace(sliding_window=32_768)
    return cfg


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "get_config", "list_configs", "shape_variant", "smoke_config"]
