"""Zamba2-1.2B: Mamba2 backbone + shared attention block [arXiv:2411.15242].

38 SSD layers, d=2048 (64 heads of 64, state 64); one shared attention
block (32 heads of 64, no GQA) after every 6th layer, then a 2-layer
tail -- the same dimensions as ``repro/configs/zamba2_1_2b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_groups=1,
    attn_layer_period=6,
    notes="Mamba2 blocks; one shared full-attention block every 6 layers",
    source="arXiv:2411.15242",
)
