"""A configuration file (``configs/<name>.json``, in the published
config's key names) as the port's ``ModelConfig``, and the model FLOPs
the benchmark counts from it."""
from __future__ import annotations


def port_fields(c: dict) -> dict:
    """The keyword arguments of ``repro_torch``'s ``ModelConfig`` for the
    configuration ``c``."""
    moe = bool(c.get("num_local_experts"))
    f = dict(
        name=c["name"],
        arch_type="moe" if moe else "dense",
        num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"],
        d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"],
        mlp_type={"silu": "swiglu"}[c["hidden_act"]],
        norm_type=c["norm"],
        norm_eps=c.get("layer_norm_eps", c.get("rms_norm_eps")),
        rope_theta=float(c["rope_theta"]),
        rotary_pct=c.get("partial_rotary_factor", 1.0),
        tie_embeddings=c["tie_word_embeddings"],
        dtype=c["torch_dtype"],
        source=c["source"],
    )
    if moe:
        f.update(num_experts=c["num_local_experts"],
                 num_experts_per_tok=c["num_experts_per_tok"],
                 moe_d_ff=c["intermediate_size"],
                 capacity_factor=c["capacity_factor"],
                 moe_group_size=c["moe_group_size"])
    return f


def port_config(c: dict):
    """The port's ``ModelConfig`` for ``c``."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**port_fields(c))


def matmul_params(c: dict) -> int:
    """Weights one token multiplies through: the projections, the MLP or
    the routed experts and the router, and the unembedding."""
    d, h, hkv, hd = (c["hidden_size"], c["num_attention_heads"],
                     c["num_key_value_heads"], c["head_dim"])
    ff = c["intermediate_size"]
    per_layer = d * h * hd + 2 * d * hkv * hd + h * hd * d
    if c.get("num_local_experts"):
        per_layer += d * c["num_local_experts"]
        per_layer += c["num_experts_per_tok"] * 3 * d * ff
    else:
        per_layer += 3 * d * ff
    return c["num_hidden_layers"] * per_layer + d * c["vocab_size"]


def token_flops(c: dict, n_tokens: int, visible_pairs: int) -> float:
    """Model FLOPs of ``n_tokens`` tokens whose queries see
    ``visible_pairs`` keys in all (causal pairs, each token seeing itself):
    2 per multiply-add of the matmuls, and 4 * heads * head_dim per pair and
    layer for QK^T and PV."""
    attn = (4 * c["num_attention_heads"] * c["head_dim"]
            * c["num_hidden_layers"])
    return 2.0 * matmul_params(c) * n_tokens + float(attn) * visible_pairs


def causal_pairs(offset: int, n: int) -> int:
    """Keys seen by ``n`` queries at positions ``offset .. offset+n-1``."""
    return n * offset + n * (n + 1) // 2
