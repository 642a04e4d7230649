"""Chained block hashing (paper §3.1, Set-KVC steps 1-2).

The port's own copy of ``repro/core/hashing.py``: the same bytes, so
placement and directory stripes agree with the reference.

The hash of token block ``i`` covers all blocks ``1..i``: it is
``H(prev_hash || tokens_i)`` with a null previous hash for the first block.
Longest-prefix lookup therefore reduces to finding the matching hash that is
furthest toward the end of the hash list.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

NULL_HASH = b"\x00" * 32


def split_token_blocks(
    tokens: Sequence[int], block_size: int, *, full_only: bool = True
) -> list[tuple[int, ...]]:
    """Split a token sequence into fixed-size blocks.

    Only full blocks participate in caching (a partial trailing block has no
    stable hash across prompts), mirroring vLLM prefix caching.
    """
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    n_full = len(tokens) // block_size
    blocks = [
        tuple(tokens[i * block_size : (i + 1) * block_size]) for i in range(n_full)
    ]
    if not full_only and len(tokens) % block_size:
        blocks.append(tuple(tokens[n_full * block_size :]))
    return blocks


def hash_block(prev_hash: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.sha256()
    h.update(prev_hash)
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


def chain_hashes(tokens: Sequence[int], block_size: int) -> list[bytes]:
    """Chained hashes for every full block of ``tokens`` (paper §3.1)."""
    prev = NULL_HASH
    out: list[bytes] = []
    for block in split_token_blocks(tokens, block_size):
        prev = hash_block(prev, block)
        out.append(prev)
    return out


def hex_id(block_hash: bytes) -> str:
    return block_hash.hex()[:16]
