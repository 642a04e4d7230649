"""Mamba2-1.3B: attention-free SSD (state-space duality) [arXiv:2405.21060].

48L, d=2048, d_inner 4096 = 64 heads of 64, state 128, one B/C group,
conv width 4, chunk 128, vocab 50280 -- the same dimensions as
``repro/configs/mamba2_1_3b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_groups=1,
    ssm_chunk=128,
    notes="attention-free; decode state is a fixed-size snapshot",
    source="arXiv:2405.21060",
)
