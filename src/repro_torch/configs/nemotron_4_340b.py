"""Nemotron-4-340B: dense GQA with squared-ReLU MLP [arXiv:2402.16819].

96L, d=18432, 96H GQA kv=8, head_dim 192, LayerNorm, squared-ReLU ffn
73728, vocab 256000 -- the same dimensions as
``repro/configs/nemotron_4_340b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    mlp_type="squared_relu",
    norm_type="layernorm",
    rope_theta=10_000.0,
    notes="GQA kv=8; squared-ReLU MLP; LayerNorm",
    source="arXiv:2402.16819",
)
