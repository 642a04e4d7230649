"""InternLM2-1.8B: dense GQA [arXiv:2403.17297].

24L, d=2048, 16H GQA kv=8, head_dim 128, ffn 8192, vocab 92544, rope
theta 1e6 -- the same dimensions as ``repro/configs/internlm2_1_8b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
)
