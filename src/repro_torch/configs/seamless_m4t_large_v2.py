"""SeamlessM4T-large-v2: the encoder-decoder transformer backbone
[arXiv:2308.11596].

24 encoder and 24 decoder layers, d=1024 (16 heads of 64, no GQA),
d_ff 8192 with gelu, LayerNorm, a vocabulary of 256206 -- the same
dimensions as ``repro/configs/seamless_m4t_large_v2.py``.  The speech
frontend (mel features and the conformer feature extractor) is stubbed:
the encoder takes frame embeddings ``frames`` [B, S_src, d_model].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,             # decoder
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    mlp_type="gelu",
    norm_type="layernorm",
    is_encoder_decoder=True,
    frontend="audio",
    source="arXiv:2308.11596",
)
