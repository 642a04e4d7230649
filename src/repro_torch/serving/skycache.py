"""Adapter between the model's decode state and SkyMemory KVC payloads,
ported from ``repro/serving/skycache.py`` (dense, MLA, SSM and hybrid
families).

* dense: the per-layer K/V covering the cached prefix, ``[k [L, T, Hkv,
  hd], v [L, T, Hkv, hd]]``, cumulative: one block's payload
  reconstructs the whole prefix;
* MLA: the per-layer latents covering the prefix, ``[ckv [L, T, r], kr
  [L, T, dr]]`` (``r + dr`` = 576 values per token and layer at
  deepseek-v3's widths), always cumulative, as in the reference;
* SSM: the fixed-size snapshot at the block boundary, ``[conv [L, K-1,
  C], state [L, H, P, N]]``.  It is not token-sliceable: it is the state
  after the block's last token;
* hybrid: the SSM snapshot followed by the shared attention block's K/V
  of the prefix, ``[conv, state, k [n_attn, T, Hkv, hd], v]``, always
  cumulative (the snapshot half is not token-sliceable).

``kvc_fn`` plugs into a ``KVCManager``: it computes one block's payload
by resuming from the previous block's payload through ``Model.forward``
with ``prefix_state`` and ``q_offset`` -- never recomputing the cached
prefix.

``codec=`` (a ``core.chunking.PayloadCodec``, or its string spec) shapes
what the payload bytes are: f32 ships the arrays verbatim (the ``SKYM``
format the reference writes), int8/int4 quantize with per-block-chunk
scale tables, and ``+delta`` makes each dense cumulative block carry only
its own ``block_size`` tokens plus a back-pointer (the KVC manager
reassembles the chain on restore).  Decoding is codec-agnostic --
payloads are self-describing.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.chunking import (
    PayloadCodec,
    decode_payload_arrays,
    make_delta_payload,
)
from repro_torch.core.hashing import chain_hashes
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import Model


class SkyKVCAdapter:
    def __init__(self, model: Model, *,
                 codec: "PayloadCodec | str | None" = None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.codec = PayloadCodec.parse(codec)
        # delta chains concatenate along the token axis, which only the
        # dense cumulative K/V payload has end to end; an SSM snapshot
        # and the hybrid's snapshot half are not token-sliceable, and the
        # reference writes MLA latents cumulative too
        self._delta_ok = (not self.cfg.use_mla
                          and self.cfg.arch_type not in ("ssm", "hybrid"))
        self._executor = None    # lazy fetch-ahead worker (run_async)

    # -- codec-derived size model (the router's fallback price) -----------
    def payload_bytes_per_token(self) -> float | None:
        """Encoded payload bytes one cached token costs under this
        adapter's codec -- the size model the router falls back to when a
        block has no registered ``payload_bytes``.  None for families
        whose payload is not token-linear (SSM and hybrid snapshots)."""
        cfg = self.cfg
        if cfg.arch_type in ("ssm", "hybrid"):
            return None
        if cfg.use_mla:
            values = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        else:
            values = 2 * cfg.num_kv_heads * cfg.head_dim
        values *= cfg.num_layers
        itemsize = torch_dtype(cfg.dtype).itemsize
        return values * self.codec.bytes_per_value(itemsize)

    def _tensor(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))   # decoded views are read-only
        return a.to(self.device)

    # -- state <-> payload ------------------------------------------------
    def state_to_payload(self, state: dict, n_tokens: int, *,
                         past_len: int = 0,
                         prev_hash: bytes | None = None) -> bytes:
        """Serialize the decode state (batch dim of 1, dropped), in the
        reference's order: the SSM snapshot (the state after the last
        token ``forward`` saw), then the MLA latents or the K/V of the
        first ``n_tokens`` positions.

        Under a ``+delta`` codec, a dense block that extends a chain
        (``past_len > 0`` with ``prev_hash``) serializes only its own
        ``[past_len:n_tokens]`` token slice behind a back-pointer -- the
        O(1)-byte Set; everything else stays cumulative."""
        delta = (self.codec.delta and self._delta_ok
                 and past_len > 0 and prev_hash is not None)
        lo = past_len if delta else 0
        arrs = []
        if "ssm" in state:
            arrs += [state["ssm"]["conv"][:, 0], state["ssm"]["state"][:, 0]]
        if "mla" in state:
            arrs += [state["mla"]["ckv"][:, 0, :n_tokens],
                     state["mla"]["kr"][:, 0, :n_tokens]]
        if "kv" in state:
            arrs += [state["kv"]["k"][:, 0, lo:n_tokens],
                     state["kv"]["v"][:, 0, lo:n_tokens]]
        inner = self.codec.encode(arrs)
        if delta:
            return make_delta_payload(inner, prev_hash, past_len)
        return inner

    def payload_to_state(self, payload: bytes) -> dict:
        arrs = [self._tensor(a)[:, None] for a in decode_payload_arrays(payload)]
        state: dict = {}
        if self.cfg.arch_type in ("ssm", "hybrid"):
            state["ssm"] = {"conv": arrs[0], "state": arrs[1]}
            arrs = arrs[2:]
        if self.cfg.use_mla:
            state["mla"] = {"ckv": arrs[0], "kr": arrs[1]}
            arrs = arrs[2:]
        if arrs:
            state["kv"] = {"k": arrs[0], "v": arrs[1]}
        return state

    def payload_to_pages(self, payload: bytes, n_tokens: int,
                         page_size: int):
        """Payload -> page-shaped K/V ``[layers, n_tokens/page, page, Hkv,
        hd]`` on the model's device, ready for ``PagedKVCache.write_pages``.
        ``n_tokens`` must be page-aligned."""
        if self.cfg.use_mla or self.cfg.arch_type in ("ssm", "hybrid"):
            raise ValueError(f"{self.cfg.name}: payload is not plain paged K/V")
        if n_tokens % page_size:
            raise ValueError("cached prefix must be page-aligned")
        k, v = decode_payload_arrays(payload)[:2]
        k, v = self._tensor(k), self._tensor(v)
        la, _, hkv, hd = k.shape
        shape = (la, n_tokens // page_size, page_size, hkv, hd)
        return k[:, :n_tokens].reshape(shape), v[:, :n_tokens].reshape(shape)

    def pages_to_payload(self, k_blocks, v_blocks, n_tokens: int, *,
                         tokens: "Sequence[int] | None" = None) -> bytes:
        """Page-shaped K/V ``[layers, n_pages, page, Hkv, hd]`` (e.g. a
        preempted sequence's exported pages) -> the payload covering the
        first ``n_tokens`` positions: a reshape and an encode, no model
        recompute.  Under the f32 codec (and for integer pools under any
        codec) a later ``payload_to_pages`` returns the identical arrays.

        Under a ``+delta`` codec the caller passes the entry's
        ``tokens`` so the back-pointer hash of the preceding block can be
        recomputed from the chain: the payload for a block past the first
        then carries only its own token slice."""
        k, v = torch.as_tensor(k_blocks), torch.as_tensor(v_blocks)
        la, nb, page, hkv, hd = k.shape
        if n_tokens > nb * page:
            raise ValueError("n_tokens exceeds the exported pages")
        flat = (la, nb * page, hkv, hd)
        bt = self.codec.block_tokens
        lo = 0
        prev_hash = None
        if (self.codec.delta and self._delta_ok and tokens is not None
                and n_tokens > bt):
            lo = n_tokens - bt
            prev_hash = chain_hashes(list(tokens[:lo]), bt)[-1]
        inner = self.codec.encode([k.reshape(flat)[:, lo:n_tokens],
                                   v.reshape(flat)[:, lo:n_tokens]])
        if prev_hash is not None:
            return make_delta_payload(inner, prev_hash, lo)
        return inner

    def pages_async(self, payload: bytes, n_tokens: int, page_size: int):
        """Decode a payload into pages on the worker thread (a Future of
        ``payload_to_pages``'s result)."""
        return self.run_async(
            self.payload_to_pages, payload, n_tokens, page_size)

    def run_async(self, fn, *args):
        """Run ``fn(*args)`` on the adapter's single worker thread, which
        serializes payload decodes and Set KVC write-backs so a
        write-back lands before the next lookup that should hit it."""
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="skymem-fetch")
        return self._executor.submit(fn, *args)

    # -- the KVCManager hook ----------------------------------------------
    def kvc_fn(self, tokens: Sequence[int], past: bytes | None,
               past_len: int) -> bytes:
        """Payload for the block ending at ``len(tokens)``, resuming from
        ``past`` (a payload -- possibly a reassembled cat container --
        covering the first ``past_len`` tokens).  Under a ``+delta`` codec
        the payload carries only the new tokens plus a back-pointer
        recomputed from the token chain."""
        toks = torch.as_tensor(list(tokens), dtype=torch.int32,
                               device=self.device)[None]
        with torch.no_grad():
            if past is None or past_len == 0:
                _, state = self.model.forward(toks, collect_state=True)
            else:
                # the returned K/V and MLA latents already include the
                # prefix (attention concatenates it in front of the fresh
                # keys); an SSM state is cumulative by construction
                _, state = self.model.forward(
                    toks[:, past_len:], q_offset=past_len,
                    prefix_state=self.payload_to_state(past),
                    collect_state=True)
        prev_hash = None
        if self.codec.delta and self._delta_ok and past_len > 0:
            prev_hash = chain_hashes(
                list(tokens[:past_len]), self.codec.block_tokens)[-1]
        return self.state_to_payload(state, len(tokens), past_len=past_len,
                                     prev_hash=prev_hash)
