"""The serving engine's device-resident K/V page pool (dense-attention
families), ported from ``repro/models/cache.py``.

``PagedKVCache`` holds ``k_pool`` / ``v_pool`` of shape
``[layers, num_pages, page_size, kv_heads, head_dim]`` on the engine's
device, and host-side int32 ``block_tables`` [slots, pages_per_seq].
Pages are ``page_size`` tokens (= the SkyMemory block size).  Two
allocation modes, as in the reference:

* **contiguous** (default): slot ``s`` owns pages ``[s*P, (s+1)*P)``, so
  per layer the pool *is* ``[slots, P, page, Hkv, hd]`` by reshape;
* **free-list** (explicit ``num_pages``): pages come from a shared free
  list; page 0 is a scratch page idle slots' rows point at.

The pools are updated **in place** -- by the model's paged steps and by
``write_pages`` -- where the reference returned new arrays and relied on
XLA donation to avoid the copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype

KVC_INT8_SCALE = 1.0 / 32.0  # symmetric int8 KVC quantization step


def quant_kvc(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / KVC_INT8_SCALE),
                       -127, 127).to(torch.int8)


def dequant_kvc(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (x.float() * KVC_INT8_SCALE).to(dtype)


def supports_paged_decode(cfg: ModelConfig) -> bool:
    """True for the families whose decode state is plain per-token K/V."""
    return (
        cfg.arch_type not in ("ssm", "hybrid")
        and not cfg.use_mla
        and not cfg.is_encoder_decoder
        and not cfg.sliding_window
    )


class PagedKVCache:
    """Shared K/V page pool + per-slot block tables (dense-attn families)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        num_slots: int,
        page_size: int,
        max_seq_len: int,
        num_pages: int | None = None,
        device: torch.device,
    ) -> None:
        if not supports_paged_decode(cfg):
            raise ValueError(f"{cfg.name}: family has no paged decode layout")
        self.cfg = cfg
        self.device = device
        self.page_size = page_size
        self.num_slots = num_slots
        self.pages_per_seq = -(-max_seq_len // page_size)
        self.contiguous = num_pages is None
        if self.contiguous:
            self.num_pages = num_slots * self.pages_per_seq
        else:
            self.num_pages = num_pages
            if self.num_pages < 1 + self.pages_per_seq:
                raise ValueError("pool smaller than one sequence")
        self.dtype = torch_dtype(cfg.kvc_dtype or cfg.dtype)
        shape = (cfg.num_layers, self.num_pages, page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=self.dtype, device=device)
        p = self.pages_per_seq
        if self.contiguous:
            self._free = []
            self.block_tables = np.asarray(
                [[s * p + j for j in range(p)] for s in range(num_slots)],
                np.int32)
            self._slot_pages = [list(row) for row in self.block_tables]
            self._slot_free = [True] * num_slots
        else:
            # page 0 reserved as scratch -- never on the free list
            self._free = list(range(self.num_pages - 1, 0, -1))
            self.block_tables = np.zeros((num_slots, p), np.int32)
            self._slot_pages = [[] for _ in range(num_slots)]
        # partial-prefill write cursor per slot (see note_span)
        self.cursors = [0] * num_slots

    # -- allocator ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        if self.contiguous:
            return sum(self._slot_free) * self.pages_per_seq
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        """Enough free pages (and, contiguous, a free slot region) for
        ``n_tokens`` tokens."""
        if self.contiguous:
            return (any(self._slot_free)
                    and self.pages_for(n_tokens) <= self.pages_per_seq)
        return len(self._free) >= self.pages_for(n_tokens)

    def ensure_capacity(self, slot: int, n_tokens: int) -> bool:
        """Allocate pages until ``slot`` can hold ``n_tokens`` tokens.
        Returns True when the block table changed."""
        need = self.pages_for(n_tokens)
        if need > self.pages_per_seq:
            raise RuntimeError(
                f"slot {slot}: {n_tokens} tokens exceeds "
                f"{self.pages_per_seq} pages per sequence")
        if self.contiguous:
            self._slot_free[slot] = False
            return False                 # fixed region: table never changes
        pages = self._slot_pages[slot]
        changed = False
        while len(pages) < need:
            if not self._free:
                raise RuntimeError("KV page pool exhausted")
            pid = self._free.pop()
            self.block_tables[slot, len(pages)] = pid
            pages.append(pid)
            changed = True
        return changed

    def pages_allocated(self, slot: int) -> int:
        if self.contiguous:
            return self.pages_per_seq
        return len(self._slot_pages[slot])

    def export_pages(self, slot: int, n_pages: int):
        """The slot's first ``n_pages`` pages as host tensors
        ``[layers, n_pages, page_size, kv_heads, head_dim]`` in the pool's
        dtype: one gathered device read per pool, then one copy to the
        host.  ``write_pages`` is the exact inverse."""
        ids = self._slot_pages[slot][:n_pages]
        if len(ids) != n_pages:
            raise RuntimeError(
                f"slot {slot}: export of {n_pages} pages exceeds "
                f"{len(ids)} allocated")
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return self.k_pool[:, idx].cpu(), self.v_pool[:, idx].cpu()

    def free_slot(self, slot: int) -> None:
        """Return the slot's pages to the pool (free-list mode repoints
        the slot at the scratch page)."""
        self.cursors[slot] = 0
        if self.contiguous:
            self._slot_free[slot] = True
            return
        self._free.extend(reversed(self._slot_pages[slot]))
        self._slot_pages[slot] = []
        self.block_tables[slot, :] = 0

    # -- partial-prefill write cursors ----------------------------------
    def table_row(self, slot: int) -> np.ndarray:
        return self.block_tables[slot]

    def note_span(self, slot: int, start: int, n_tokens: int) -> None:
        """Record that tokens ``[start, start + n_tokens)`` of the slot's
        sequence are (being) written to its pages; a gap past the cursor
        is a scheduler bug and raises before the pool is corrupted."""
        if start > self.cursors[slot]:
            raise RuntimeError(
                f"slot {slot}: span start {start} leaves a gap past write "
                f"cursor {self.cursors[slot]}")
        end = start + n_tokens
        if self.pages_for(end) > len(self._slot_pages[slot]):
            raise RuntimeError(
                f"slot {slot}: span end {end} beyond allocated pages")
        self.cursors[slot] = max(self.cursors[slot], end)

    # -- page writes (in place, between steps) --------------------------
    def write_pages(self, slot: int, first_page: int, k_blocks, v_blocks):
        """Drop whole pages ``[layers, n_pages, page, Hkv, hd]`` (host or
        device tensors, any float dtype, or int8 for an int8 pool) into
        the slot's pages, in place."""
        n = k_blocks.shape[1]
        ids = self._slot_pages[slot][first_page:first_page + n]
        if len(ids) != n:
            raise RuntimeError("write_pages beyond allocated pages")
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        self.k_pool[:, idx] = self._cast(k_blocks)
        self.v_pool[:, idx] = self._cast(v_blocks)
        self.cursors[slot] = max(self.cursors[slot],
                                 (first_page + n) * self.page_size)

    def write_token_span(self, slot: int, start: int, k, v):
        """Write ``k``/``v`` ``[layers, n_tokens, kv_heads, head_dim]`` at
        page-aligned token offset ``start``; the tail is zero-padded to a
        page boundary and masked by the sequence length."""
        if start % self.page_size:
            raise ValueError("span start must be page-aligned")
        la, n, hkv, hd = k.shape
        pad = (-n) % self.page_size
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        nb = k.shape[1] // self.page_size
        shape = (la, nb, self.page_size, hkv, hd)
        self.write_pages(slot, start // self.page_size,
                         k.reshape(shape), v.reshape(shape))
        self.cursors[slot] = start + n   # the padded tail is not real data

    def _cast(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device)
        if self.dtype == torch.int8 and x.dtype != torch.int8:
            return quant_kvc(x)
        return x.to(self.dtype)
