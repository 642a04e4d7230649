"""StableLM-2-12B: dense GQA, partial rotary [hf:stabilityai/stablelm-2-1_6b].

40L, d=5120, 32H GQA kv=8, head_dim 160 (rotary on the first 40 dims),
LayerNorm, ffn 13824, vocab 100352 -- the same dimensions as
``repro/configs/stablelm_12b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
    mlp_type="swiglu",
    norm_type="layernorm",
    rotary_pct=0.25,
    source="hf:stabilityai/stablelm-2-1_6b",
)
