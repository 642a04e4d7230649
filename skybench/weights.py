"""The weights, made from the run's seed on the device.

Each group of leaves (the embedding, the unembedding, each layer, the
final norm) is drawn in one call from a generator seeded by the run's
seed and the group's name, in the dtype it is served in: so the port is
loaded with them and the reference draws the very same values again,
group by group, once the port's state is gone.  Matrices are N(0,
1/fan_in); norm scales 1 + N(0, 0.05^2) and LayerNorm biases N(0,
0.05^2), so that a norm that drops its scale or bias shows.  The layout
is the port's (``[in, out]`` matrices, ``[E, in, out]`` experts), the
reference reads the same.
"""
from __future__ import annotations

import hashlib

import torch

NORM_SPREAD = 0.05


def _seed(seed: int, group: str) -> int:
    h = hashlib.sha256(f"{seed}/weights/{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def leaves(c: dict, group: str) -> list[tuple[str, tuple, str, float]]:
    """The leaves of ``group`` (``embed``, ``unembed``, ``layer<i>``,
    ``final``): (name, shape, kind, fan_in) with kind ``mat`` (model
    dtype), ``mat32`` (f32 matrix), ``scale`` or ``bias`` (f32)."""
    d, v = c["hidden_size"], c["vocab_size"]
    h, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    ff = c["intermediate_size"]
    ln = c["norm"] == "layernorm"

    def norm(prefix):
        out = [(f"{prefix}.scale", (d,), "scale", 0)]
        if ln:
            out.append((f"{prefix}.bias", (d,), "bias", 0))
        return out

    if group == "embed":
        return [("embed.tok", (v, d), "mat", d)]
    if group == "unembed":
        return [("embed.unembed", (d, v), "mat", d)]
    if group == "final":
        return norm("final_norm")
    out = norm("norm1") + norm("norm2") + [
        ("attn.wq", (d, h * hd), "mat", d),
        ("attn.wk", (d, hkv * hd), "mat", d),
        ("attn.wv", (d, hkv * hd), "mat", d),
        ("attn.wo", (h * hd, d), "mat", h * hd),
    ]
    e = c.get("num_local_experts")
    if e:
        out += [("moe.router", (d, e), "mat32", d),
                ("moe.wi_gate", (e, d, ff), "mat", d),
                ("moe.wi_up", (e, d, ff), "mat", d),
                ("moe.wo", (e, ff, d), "mat", ff)]
    else:
        out += [("mlp.wi_gate", (d, ff), "mat", d),
                ("mlp.wi_up", (d, ff), "mat", d),
                ("mlp.wo", (ff, d), "mat", ff)]
    return out


def groups(c: dict) -> list[str]:
    out = ["embed"] + [f"layer{i}" for i in range(c["num_hidden_layers"])]
    if not c["tie_word_embeddings"]:
        out.append("unembed")
    return out + ["final"]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def draw(c: dict, seed: int, group: str, device,
         dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """The leaves of one group as tensors on ``device``: one normal draw
    in ``dtype`` for its matrices and one in f32 for the rest."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, group))
    specs = leaves(c, group)
    out = {}
    for kinds, dt in ((("mat",), dtype), (("mat32", "scale", "bias"),
                                           torch.float32)):
        part = [s for s in specs if s[2] in kinds]
        if not part:
            continue
        flat = torch.randn(sum(_numel(s[1]) for s in part), generator=gen,
                           device=device, dtype=dt)
        off = 0
        for name, shape, kind, fan_in in part:
            n = _numel(shape)
            t = flat[off: off + n].view(shape)
            off += n
            if kind in ("mat", "mat32"):
                t.mul_(fan_in ** -0.5)
            elif kind == "scale":
                t.mul_(NORM_SPREAD).add_(1.0)
            else:
                t.mul_(NORM_SPREAD)
            out[name] = t
    return out


def _target(model, group: str, name: str) -> torch.Tensor:
    """The port's parameter for leaf ``name`` of ``group``."""
    if group.startswith("layer"):
        obj = model.blocks[int(group[5:])]
    else:
        obj = model
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


@torch.no_grad()
def load(model, c: dict, seed: int) -> None:
    """Fill the port's ``model`` with the seed's weights, group by group."""
    dtype = next(model.parameters()).dtype
    for group in groups(c):
        for name, t in draw(c, seed, group, model.device, dtype).items():
            _target(model, group, name).copy_(t)
