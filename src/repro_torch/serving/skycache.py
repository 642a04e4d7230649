"""Adapter between the dense model's decode state and SkyMemory KVC
payloads, ported from ``repro/serving/skycache.py`` (dense family).

A dense payload is the per-layer K/V covering the cached prefix,
``[k [L, T, Hkv, hd], v [L, T, Hkv, hd]]``, cumulative: one block's
payload reconstructs the whole prefix.  ``kvc_fn`` plugs into a
``KVCManager``: it computes one block's payload by resuming from the
previous block's payload through ``Model.forward`` with ``prefix_state``
and ``q_offset`` -- never recomputing the cached prefix.  Under the f32
codec the bytes are the ``SKYM`` format the reference writes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.chunking import PayloadCodec, decode_payload_arrays
from repro_torch.models.model import Model


class SkyKVCAdapter:
    def __init__(self, model: Model):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.codec = PayloadCodec()
        self._executor = None    # lazy fetch-ahead worker (run_async)

    def _tensor(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))   # decoded views are read-only
        return a.to(self.device)

    # -- state <-> payload ------------------------------------------------
    def state_to_payload(self, state: dict, n_tokens: int) -> bytes:
        """Serialize the K/V state (batch dim of 1, dropped) for the
        first ``n_tokens`` positions."""
        return self.codec.encode([state["kv"]["k"][:, 0, :n_tokens],
                                  state["kv"]["v"][:, 0, :n_tokens]])

    def payload_to_state(self, payload: bytes) -> dict:
        k, v = decode_payload_arrays(payload)
        return {"kv": {"k": self._tensor(k)[:, None],
                       "v": self._tensor(v)[:, None]}}

    def payload_to_pages(self, payload: bytes, n_tokens: int,
                         page_size: int):
        """Payload -> page-shaped K/V ``[layers, n_tokens/page, page, Hkv,
        hd]`` on the model's device, ready for ``PagedKVCache.write_pages``.
        ``n_tokens`` must be page-aligned."""
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
        recompute.  ``tokens`` is accepted for the reference's signature
        (the delta codecs need it)."""
        k, v = torch.as_tensor(k_blocks), torch.as_tensor(v_blocks)
        la, nb, page, hkv, hd = k.shape
        if n_tokens > nb * page:
            raise ValueError("n_tokens exceeds the exported pages")
        flat = (la, nb * page, hkv, hd)
        return self.codec.encode([k.reshape(flat)[:, :n_tokens],
                                  v.reshape(flat)[:, :n_tokens]])

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
        ``past`` (a payload covering the first ``past_len`` tokens)."""
        toks = torch.as_tensor(list(tokens), dtype=torch.int32,
                               device=self.device)[None]
        if past is None or past_len == 0:
            _, state = self.model.forward(toks, collect_state=True)
        else:
            # the returned K/V already include the prefix: attention
            # concatenates it in front of the fresh keys
            _, state = self.model.forward(
                toks[:, past_len:], q_offset=past_len,
                prefix_state=self.payload_to_state(past), collect_state=True)
        return self.state_to_payload(state, len(tokens))
