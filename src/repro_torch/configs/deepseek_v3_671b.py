"""DeepSeek-V3 671B: MLA + 1 shared/256 routed top-8 MoE + MTP.

[arXiv:2412.19437] -- the MLA latent (c_kv || k_rope = 576 values per
token and layer) is the KVC payload SkyMemory chunks for this family --
the same dimensions as ``repro/configs/deepseek_v3_671b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,            # dense layers (first_k_dense)
    vocab_size=129280,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    moe_group_size=512,
    source="arXiv:2412.19437",
)
