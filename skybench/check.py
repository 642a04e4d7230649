"""How ``correct`` is decided for a served model.

Once the window has closed and the port's state is freed, a sample of
the requests it finished (16 drawn from the seed, the longest always in
it: some thousands of served tokens) is run through the plain reference
once, each prompt with the tokens the port served after it.  Many answers
rather than many tokens, because a random model's greedy answer soon
settles into a loop whose every token wins by a wide margin: the first
tokens of each answer are where a lower precision shows.  At every
served position the reference's best logit minus its logit of the
served token is that token's gap; the widest gap over the sample
(``logit_gap``), or the mean gap (``mean_gap``), whichever the cell's
limits name, is held to its limit.  Greedy decoding makes the served
token the port's own argmax, so a sound port only loses near-ties, by its bf16
rounding.  The prompt the port served is held to the request's text and
to the benchmark's token count of it (``prompts_off``, an exact
comparison; the port's token ids themselves are not exposed, and a
prompt that it tokenized otherwise would show in the gaps).

The control (``control_gaps``) is the reference with its projections in
fp8 (e4m3, per-row and per-column scales): at the same positions, the
gap of the token it puts first.  The harness judges its numbers by the
cell's own limits, as it judges the port's.
"""
from __future__ import annotations

import random

import torch

from skybench.reference import model as ref
from skybench.traffic import token_ids

SAMPLE_REQUESTS = 16


def sample(done: list, seed: int, n: int = SAMPLE_REQUESTS) -> list:
    """The longest finished request and others drawn from the seed, ``n``
    in all (every one, when fewer finished)."""
    ok = [d for d in done if d.result is not None and d.result.token_ids]
    if not ok:
        return []
    ok.sort(key=lambda d: d.req.index)
    longest = max(ok, key=lambda d: len(d.result.token_ids))
    rest = [d for d in ok if d is not longest]
    random.Random(f"{seed}/sample").shuffle(rest)
    return [longest] + rest[: n - 1]


def _sequences(picked):
    seqs, starts = [], []
    for d in picked:
        prompt = token_ids(d.req.text)
        seqs.append(prompt + list(d.result.token_ids))
        starts.append(len(prompt))
    return seqs, starts


def _gaps(logits, choose) -> list[float]:
    """Per scored position, the reference's best logit less its logit of
    the token ``choose`` names there."""
    out = []
    for lg, toks in zip(logits, choose):
        toks = torch.as_tensor(toks, device=lg.device).long()
        best = lg.max(-1).values
        out += (best - lg.gather(1, toks[:, None])[:, 0]).tolist()
    return out


def served_gaps(c: dict, seed: int, picked: list, device) -> dict:
    """The sample's gap numbers (``summary``) and how many served prompts
    differ from the request's text or from its count of token ids."""
    prompt_off = sum(d.result.prompt != d.req.text
                     or len(token_ids(d.req.text)) != d.result.prompt_tokens
                     for d in picked)
    seqs, starts = _sequences(picked)
    logits = ref.scored_logits(c, seed, seqs, starts, device)
    served = [s[st:] for s, st in zip(seqs, starts)]
    gaps = _gaps(logits, served)
    return dict(numbers=summary(gaps), served_tokens=len(gaps),
                prompts_off=prompt_off, logits=logits, seqs=seqs,
                starts=starts)


def summary(gaps: list[float]) -> dict:
    """The numbers a cell's limits may name: the widest gap
    (``logit_gap``), the mean gap (``mean_gap``), and the share of
    positions whose token is not the reference's first (``off_share``,
    read, never compared)."""
    return dict(logit_gap=max(gaps), mean_gap=sum(gaps) / len(gaps),
                off_share=sum(g > 0 for g in gaps) / len(gaps))


def control_gaps(c: dict, seed: int, checked: dict, device) -> dict:
    """The control's reading on the same prompts and served tokens: the
    gaps of the tokens that the fp8 reference puts first."""
    low = ref.scored_logits(c, seed, checked["seqs"], checked["starts"],
                            device, mm=ref.fp8_mm)
    firsts = [lg.argmax(-1).tolist() for lg in low]
    return summary(_gaps(checked["logits"], firsts))
