"""The plain reference: the decoder as the configurations run it, in
float32 with TF32 off, one sequence at a time and layer by layer.

Block: ``x + attn(norm1(x))`` then ``+ ffn(norm2(.))``.  Norms are
LayerNorm (biased variance, scale and bias) or RMSNorm; attention is
causal GQA with rotary embeddings on the first ``partial_rotary_factor``
of each head's dims, as interleaved pairs ``(x[2i], x[2i+1])`` at
frequencies ``theta^(-2i/rot)``, scaled by ``head_dim ** -0.5``; the
feed-forward is SwiGLU, or the top-k mixture of SwiGLU experts: f32
router softmax, the k largest probabilities renormalised, each token's
k experts' outputs summed by those weights.  A capacity that binds
(dropped tokens) depends on which tokens share a group, which a plain
reference cannot know, so it refuses a configuration whose capacity
factor lets any token drop.

Weights are drawn again from the run's seed, group by group
(``skybench.weights.draw``), and upcast to f32.  ``mm`` is the matrix
product of the projections: exact f32 for the reference, or a lower
precision for the control (``fp8_mm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from skybench import weights


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (its absolute max at 448), back in f32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's projection: activations rounded to fp8 per row,
    weights per output column, the product in f32."""
    return _fp8(x, -1) @ _fp8(w, -2)


def _norm(x, p, prefix, c):
    scale = p[f"{prefix}.scale"]
    if c["norm"] == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return ((x - mean) * torch.rsqrt(var + c["layer_norm_eps"]) * scale
                + p[f"{prefix}.bias"])
    ms = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + c["rms_norm_eps"]) * scale


def _rope(x: torch.Tensor, c: dict) -> torch.Tensor:
    """x [S, heads, hd] at positions 0..S-1."""
    hd = x.shape[-1]
    rot = int(hd * c.get("partial_rotary_factor", 1.0)) // 2 * 2
    if rot == 0:
        return x
    inv = 1.0 / (float(c["rope_theta"]) ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot))
    ang = torch.arange(x.shape[0], dtype=torch.float32,
                       device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    r = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([r.reshape(*x.shape[:-1], rot), x[..., rot:]], dim=-1)


def _attention(x, p, c, mm):
    s = x.shape[0]
    h, hkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["head_dim"])
    q = _rope(mm(x, p["attn.wq"]).view(s, h, hd), c)
    k = _rope(mm(x, p["attn.wk"]).view(s, hkv, hd), c)
    v = mm(x, p["attn.wv"]).view(s, hkv, hd)
    rep = h // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)
    return mm(out.reshape(s, h * hd), p["attn.wo"])


def _swiglu(x, wg, wu, wo, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wo)


def _moe(x, p, c, mm):
    e, k = c["num_local_experts"], c["num_experts_per_tok"]
    probs = torch.softmax(x @ p["moe.router"], dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for j in range(e):
        tok, slot = (top_i == j).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(x[tok], p["moe.wi_gate"][j], p["moe.wi_up"][j],
                      p["moe.wo"][j], mm)
        y.index_add_(0, tok, out * top_p[tok, slot][:, None])
    return y


def check_dropless(c: dict) -> None:
    """A capacity of ``capacity_factor * k / E`` of a group drops no token
    only when it reaches the whole group, at ``E / k`` or more."""
    e = c.get("num_local_experts")
    if e and c["capacity_factor"] * c["num_experts_per_tok"] < e:
        raise ValueError(
            f"{c['name']}: capacity_factor {c['capacity_factor']} can drop "
            "tokens; the plain reference routes without drops")


@torch.no_grad()
def scored_logits(c: dict, seed: int, seqs: list[list[int]],
                  starts: list[int], device, mm=f32_mm
                  ) -> list[torch.Tensor]:
    """For each token sequence ``seqs[i]``, the f32 logits [n_i, V] at
    positions ``starts[i] - 1 .. len - 2``: the predictions of its tokens
    from ``starts[i]`` on, each from the tokens before it."""
    check_dropless(c)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _scored_logits(c, seed, seqs, starts, device, mm)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _f32(group: dict) -> dict:
    return {n: t.float() for n, t in group.items()}


def _draw(c, seed, group, device) -> dict:
    """One group of the seed's weights in the dtype they are served in."""
    return weights.draw(c, seed, group, device,
                        getattr(torch, c["torch_dtype"]))


def _scored_logits(c, seed, seqs, starts, device, mm):
    emb = _draw(c, seed, "embed", device)["embed.tok"]
    hs = [emb[torch.as_tensor(s, device=device)].float() for s in seqs]
    del emb
    for layer in range(c["num_hidden_layers"]):
        p = _f32(_draw(c, seed, f"layer{layer}", device))
        for i, h in enumerate(hs):
            h = h + _attention(_norm(h, p, "norm1", c), p, c, mm)
            x = _norm(h, p, "norm2", c)
            if c.get("num_local_experts"):
                h = h + _moe(x, p, c, mm)
            else:
                h = h + _swiglu(x, p["mlp.wi_gate"], p["mlp.wi_up"],
                                p["mlp.wo"], mm)
            hs[i] = h
        del p
    fin = _f32(_draw(c, seed, "final", device))
    if c["tie_word_embeddings"]:
        un = _draw(c, seed, "embed", device)["embed.tok"].float().T
    else:
        un = _draw(c, seed, "unembed", device)["embed.unembed"].float()
    out = []
    for h, st in zip(hs, starts):
        x = _norm(h[st - 1: -1], fin, "final_norm", c)
        out.append(mm(x, un))
    return out
