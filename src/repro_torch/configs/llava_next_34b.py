"""LLaVA-NeXT 34B language backbone (anyres vision frontend stubbed).

[hf:llava-hf/llava-v1.6-mistral-7b-hf] -- assigned 34B-scale dims: 60L,
d=7168, 56H GQA kv=8, head_dim 128, ffn 20480, vocab 64000, up to 2880
precomputed patch embeddings prepended to the tokens -- the same
dimensions as ``repro/configs/llava_next_34b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=5_000_000.0,
    num_image_tokens=2880,
    frontend="vision",
    notes="anyres tiling; vision tower + projector stubbed per brief",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
