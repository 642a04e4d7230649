"""Yi-9B: llama-architecture dense GQA [arXiv:2403.04652].

48L, d=4096, 32H GQA kv=4, head_dim 128, ffn 11008, vocab 64000, rope
theta 5e6 -- the same dimensions as ``repro/configs/yi_9b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)
