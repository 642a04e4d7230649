"""The one request generator: every traffic file under ``traffic/`` is
parameters for it.  Everything is drawn from the run's seed alone.

A request is a document of ``document_tokens`` tokens (BOS and printable
ASCII bytes) chosen by Zipf popularity among ``documents``, a unique
question of ``question_tokens`` tokens, and an answer length drawn
log-normal and clipped.  Every seed offers the same set of sizes: each
quantity is taken at the stratified quantiles ``(i + 0.5) / n`` of its
distribution and only their order, the texts and which document holds
which popularity rank come from the seed.  So two seeds ask the same
work in another order.

Arrivals: ``closed``, the only process a cell runs so far, has no
times: clients send their next request when the reply comes.

Token ids follow the byte tokenizer the configurations run (id 1 is BOS,
a byte ``b`` is ``3 + b``); ``token_ids`` is the benchmark's own copy of
that rule, which the check holds the served prompts to.
"""
from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from statistics import NormalDist

BOS_ID = 1
BYTE_OFFSET = 3
PRINTABLE = [chr(c) for c in range(32, 127)]


@dataclass(frozen=True)
class Req:
    """One generated request: its text, its document, its answer length."""

    index: int
    doc: int
    text: str
    max_new_tokens: int


def token_ids(text: str) -> list[int]:
    return [BOS_ID] + [BYTE_OFFSET + b for b in text.encode("ascii")]


def _rng(seed: int, *parts) -> random.Random:
    key = "/".join(str(p) for p in (seed, *parts))
    return random.Random(int.from_bytes(
        hashlib.sha256(key.encode()).digest()[:8], "little"))


def _text(rng: random.Random, n: int) -> str:
    return "".join(rng.choice(PRINTABLE) for _ in range(n))


def _quantiles(n: int) -> list[float]:
    return [(i + 0.5) / n for i in range(n)]


def _zipf_counts(n: int, docs: int, s: float) -> list[int]:
    """How many of ``n`` requests ask about each popularity rank: Zipf
    shares apportioned by largest remainder."""
    w = [1.0 / (r + 1) ** s for r in range(docs)]
    tot = sum(w)
    exact = [n * x / tot for x in w]
    counts = [int(x) for x in exact]
    order = sorted(range(docs), key=lambda r: exact[r] - counts[r],
                   reverse=True)
    for r in order[: n - sum(counts)]:
        counts[r] += 1
    return counts


class Mix:
    """The request mix of one traffic file under one seed."""

    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = seed
        n_docs = params["documents"]
        body = params["document_tokens"] - 1          # BOS is the first
        self.documents = [_text(_rng(seed, "doc", d), body)
                          for d in range(n_docs)]
        # which document holds popularity rank r
        ranks = list(range(n_docs))
        _rng(seed, "ranks").shuffle(ranks)
        self.doc_of_rank = ranks

    def _sizes(self, n: int, salt: str):
        """``n`` requests' (doc, question length, answer length), each
        taken at stratified quantiles and shuffled by the seed."""
        p = self.p
        q_lo, q_hi = p["question_tokens"]
        qlens = [q_lo + min(int(u * (q_hi - q_lo + 1)), q_hi - q_lo)
                 for u in _quantiles(n)]
        a = p["answer_tokens"]
        nd = NormalDist()
        alens = [min(a["max"], max(a["min"], round(
            a["median"] * math.exp(a["sigma"] * nd.inv_cdf(u)))))
            for u in _quantiles(n)]
        docs = [self.doc_of_rank[r] for r, c in enumerate(
            _zipf_counts(n, p["documents"], p["zipf_s"])) for _ in range(c)]
        out = []
        for vals in (docs, qlens, alens):
            vals = list(vals)
            _rng(self.seed, salt, "order", len(out)).shuffle(vals)
            out.append(vals)
        return list(zip(*out))

    def requests(self, n: int, salt: str) -> list[Req]:
        """``n`` requests of the stream named ``salt`` (the window's, the
        warm-up's...): the same sizes for every seed, in another order."""
        reqs = []
        for i, (doc, qlen, alen) in enumerate(self._sizes(n, salt)):
            q = _text(_rng(self.seed, salt, "question", i), qlen)
            reqs.append(Req(i, doc, self.documents[doc] + q, alen))
        return reqs
