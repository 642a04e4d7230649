"""Model configuration: the port's own copy of ``repro/models/config.py``'s
``ModelConfig`` (the same fields and accounting, no JAX)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0     # 0 -> MHA (== num_heads)
    head_dim: int = 0         # 0 -> d_model // num_heads

    # block flavor
    mlp_type: str = "swiglu"          # swiglu | squared_relu | gelu
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0           # stablelm: partial rotary
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert hidden (0 -> d_ff)
    first_k_dense: int = 0            # deepseek: leading dense layers
    router_aux_coef: float = 0.01
    moe_group_size: int = 1024        # dispatch group (capacity einsum)
    capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    attn_layer_period: int = 0        # hybrid: shared attn every k layers

    # MLA (DeepSeek-V3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0                # multi-token-prediction heads

    # encoder-decoder (audio)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # modality frontend stubs
    num_image_tokens: int = 0         # vlm: anyres patch-embedding count
    frontend: str = "none"            # none | vision | audio

    # decode variants
    sliding_window: int = 0           # 0 = full attention
    kvc_dtype: str = ""               # "" = model dtype; "int8" = quantized
                                      # KVC (paper §3.3/§5 8-bit trade-off)
    notes: str = ""
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.num_kv_heads == 0 and self.num_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def is_attn_layer(self, layer_idx: int) -> bool:
        """Hybrid (zamba2-style): a shared attention block fires every
        ``attn_layer_period`` layers; pure SSM never; others always."""
        if self.arch_type == "ssm":
            return False
        if self.arch_type == "hybrid":
            return self.attn_layer_period > 0 and (
                layer_idx % self.attn_layer_period == self.attn_layer_period - 1
            )
        return True

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.num_experts > 0 and layer_idx >= self.first_k_dense

    # -- parameter / cache accounting (used by roofline + docs) ----------
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for layer in range(self.num_layers):
            total += self._layer_params(layer)
        if self.arch_type == "hybrid" and self.attn_layer_period:
            total += self._attn_params()  # one shared block
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                total += self._attn_params() + self._mlp_params(self.d_ff)
            total += self.num_layers * self._attn_params()  # cross-attn
        if self.mtp_depth:
            total += self.mtp_depth * (
                self._layer_params(self.num_layers - 1) + 2 * d * d
            )
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed top-k + shared)."""
        if self.num_experts == 0:
            return self.param_count()
        d = self.d_model
        dense = self.param_count()
        moe_layers = sum(
            1 for i in range(self.num_layers) if self.is_moe_layer(i)
        )
        all_experts = moe_layers * self.num_experts * self._expert_params()
        active_experts = moe_layers * (
            (self.num_experts_per_tok + self.num_shared_experts)
            * self._expert_params()
        )
        return dense - all_experts + active_experts

    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            q = d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                self.qk_nope_head_dim + self.qk_rope_head_dim
            )
            kv = d * (self.kv_lora_rank + self.qk_rope_head_dim)
            kv += self.kv_lora_rank * self.num_heads * (
                self.qk_nope_head_dim + self.v_head_dim
            )
            o = self.num_heads * self.v_head_dim * d
            return q + kv + o
        h, hkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        return d * h * hd + 2 * d * hkv * hd + h * hd * d

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.mlp_type == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _expert_params(self) -> int:
        return self._mlp_params(self.expert_d_ff) // 1

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, n = self.ssm_groups, self.ssm_state
        h = self.ssm_heads
        in_proj = d * (2 * di + 2 * g * n + h)
        conv = (di + 2 * g * n) * self.ssm_conv
        return in_proj + conv + 2 * h + di + di * d  # A_log, D, norm, out

    def _layer_params(self, layer_idx: int) -> int:
        d = self.d_model
        total = 2 * d  # two norms
        if self.arch_type in ("ssm", "hybrid"):
            total += self._ssm_params()
        else:
            total += self._attn_params()
        if self.arch_type not in ("ssm", "hybrid"):
            if self.is_moe_layer(layer_idx):
                total += self.num_experts * self._expert_params()
                total += self.num_shared_experts * self._expert_params()
                total += d * self.num_experts  # router
            else:
                total += self._mlp_params(self.d_ff)
        return total

    def kv_cache_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """Per-token decode-state footprint (the object SkyMemory chunks)."""
        if self.arch_type == "ssm":
            return 0  # fixed-size state, not per-token
        if self.use_mla:
            per = self.kv_lora_rank + self.qk_rope_head_dim
            return self.num_layers * per * bytes_per_el
        n_attn = sum(
            1 for i in range(self.num_layers) if self.is_attn_layer(i)
        )
        return n_attn * 2 * self.num_kv_heads * self.head_dim * bytes_per_el

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
