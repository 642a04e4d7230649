"""Granite-3.0 MoE 3B-A800M: 40 experts top-8, 512-dim experts.

[hf:ibm-granite/granite-3.0-1b-a400m-base] -- assigned 3b-a800m dims:
32L, d=1536, 24H GQA kv=8, head_dim 64, vocab 49155 -- the same
dimensions as ``repro/configs/granite_moe_3b_a800m.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    num_experts=40,
    num_experts_per_tok=8,
    moe_d_ff=512,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
