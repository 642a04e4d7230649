"""Token sampling: greedy / temperature / top-k / top-p, ported from
``repro/serving/sampler.py``.

``sample_batch`` is vectorized over per-sequence parameters stacked into
[B] tensors, and never waits for the device: disabled filters are
identities rather than branches (``top_k == 0`` thresholds at the V-th
largest logit, ``top_p >= 1`` puts the cutoff past 1), and the draw is a
Gumbel-max over the masked logits, with noise from the caller's
``torch.Generator``.  Greedy rows are an exact argmax.  The reference
draws with ``jax.random``, so sampled streams differ between the two;
masked tokens are never drawn in either.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 -> greedy
    top_k: int = 0             # 0 -> disabled
    top_p: float = 1.0
    max_new_tokens: int = 32


def stack_sampling(params: list[SamplingParams], pad_to: int | None = None,
                   *, device="cpu"):
    """Stack per-sequence params into the [B] tensors ``sample_batch``
    takes; padding rows (inactive slots) are greedy."""
    n = pad_to if pad_to is not None else len(params)
    temps = [0.0] * n
    top_ks = [0] * n
    top_ps = [1.0] * n
    for i, p in enumerate(params):
        temps[i], top_ks[i], top_ps[i] = p.temperature, p.top_k, p.top_p
    return (
        torch.tensor(temps, dtype=torch.float32, device=device),
        torch.tensor(top_ks, dtype=torch.int32, device=device),
        torch.tensor(top_ps, dtype=torch.float32, device=device),
    )


def sample_batch(
    logits: torch.Tensor,           # [B, V]
    generator: torch.Generator,
    temperature: torch.Tensor,      # [B] float32; <= 0 -> greedy
    top_k: torch.Tensor,            # [B] int32;   0 -> disabled
    top_p: torch.Tensor,            # [B] float32; >= 1 -> disabled
) -> torch.Tensor:
    """Vectorized sampling with per-row parameters -> token ids [B] int32."""
    v = logits.shape[-1]
    lg32 = logits.float()
    greedy_ids = torch.argmax(lg32, dim=-1)

    is_greedy = temperature <= 0.0
    temp = torch.where(is_greedy, torch.ones_like(temperature), temperature)
    lg = lg32 / temp[:, None]

    # top-k: threshold at the k-th largest (k=0 -> V-th largest = min)
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, v),
                        torch.clamp(top_k, 1, v)).long()
    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])
    lg = torch.where(lg < kth, float("-inf"), lg)

    # top-p on the top-k-masked logits: keep the smallest prefix of the
    # sorted distribution whose cumulative probability reaches p
    ar = torch.arange(v, device=logits.device)[None, :]
    sorted_masked = torch.where(ar < k_eff[:, None], sorted_desc,
                                float("-inf"))
    csum = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    p_eff = torch.where(top_p >= 1.0, torch.full_like(top_p, 2.0), top_p)
    cutoff_idx = torch.clamp((csum < p_eff[:, None]).sum(-1, keepdim=True),
                             max=v - 1)
    cutoff = torch.gather(sorted_masked, 1, cutoff_idx)
    lg = torch.where(lg < cutoff, float("-inf"), lg)

    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(lg + gumbel, dim=-1)
    return torch.where(is_greedy, greedy_ids, sampled).to(torch.int32)
