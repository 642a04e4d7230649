"""Byte-level tokenizer (self-contained; no external vocab files).

Token ids: 0=pad, 1=bos, 2=eos, 3..258 = raw bytes.  Vocabularies smaller
than 259 wrap bytes modulo the available range (used only by reduced smoke
configs); larger vocabularies simply leave the tail unused -- the cache
protocol and engine only need a deterministic, prefix-stable mapping.

(A copy of ``repro/serving/tokenizer.py``.)
"""
from __future__ import annotations

from dataclasses import dataclass

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
_OFFSET = 3

# decode headroom reserved past the prompt when admitting a request
PROMPT_HEADROOM = 64


def truncate_prompt(tokens: list[int], max_seq_len: int) -> list[int]:
    """THE prompt-truncation rule, shared by the schedulers (paged and
    dense) and the cluster router: the router must hash exactly the
    token prefix the engine will serve and cache, or affinity memory
    keys on the wrong block chain."""
    return tokens[: max_seq_len - PROMPT_HEADROOM]


@dataclass(frozen=True)
class ByteTokenizer:
    vocab_size: int
    add_bos: bool = True

    def encode(self, text: str) -> list[int]:
        span = max(self.vocab_size - _OFFSET, 1)
        ids = [_OFFSET + (b % span) for b in text.encode("utf-8")]
        return ([BOS_ID] if self.add_bos else []) + ids

    def decode(self, ids: list[int]) -> str:
        bs = bytes(
            (i - _OFFSET) % 256 for i in ids if i >= _OFFSET
        )
        return bs.decode("utf-8", errors="replace")

    @property
    def eos_id(self) -> int:
        return EOS_ID
