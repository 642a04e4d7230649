"""The paper's own testbed model: TinyLlama-1.1B-Chat-v1.0 (§5, Table 3).

22L, d=2048, 32H GQA kv=4, ffn 5632, vocab 32000 -- the same dimensions as
``repro/configs/skymemory_tinyllama.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="skymemory-tinyllama",
    arch_type="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    source="hf:TinyLlama/TinyLlama-1.1B-Chat-v1.0 (paper §5)",
)
