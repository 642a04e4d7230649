"""PagedExecutor: every device program the paged serving stack launches,
ported from ``repro/serving/executor.py``.

The fused decode step, the mixed decode+chunk step, the cold-start chunk
wave, the dense prefill of stop-the-world admission, and the sampler,
plus the generator and the buffer-shape policies (chunk buffers, length
buckets).  PyTorch runs eagerly, so there is nothing to compile: each
program is a plain call.  The K/V pools of the ``PagedKVCache`` are
updated in place (the reference donated them to XLA).  The scheduler
never touches device tensors directly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.sampler import SamplingParams, sample_batch, stack_sampling


class PagedExecutor:
    """Mixed decode/prefill steps, sampling, and device state."""

    def __init__(self, model, pool, *, chunk_tokens: int, max_seq_len: int,
                 seed: int = 0) -> None:
        self.model = model
        self.pool = pool
        self.cfg = model.cfg
        self.device = model.device
        self.chunk_tokens = chunk_tokens
        self.max_seq_len = max_seq_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def to_device(self, a, dtype=torch.int32) -> torch.Tensor:
        """A host array as a device tensor (copied, so later host edits of
        ``a`` never reach a step in flight)."""
        return torch.as_tensor(np.array(a), dtype=dtype, device=self.device)

    # -- the fused device programs --------------------------------------
    def _decode_sample(self, block_tables, lengths, tokens, temps, top_ks,
                       top_ps, mode):
        """Decode every slot and sample its next token.  ``mode`` is
        decided host-side from the active slots' sampling params:
        ``greedy`` is a pure argmax, otherwise the general sampler."""
        logits = self.model.decode_step_paged(
            self.pool.k_pool, self.pool.v_pool, tokens[:, None],
            block_tables, lengths, contiguous=self.pool.contiguous)
        lg = logits[:, 0]
        if mode == "greedy":
            return torch.argmax(lg, dim=-1).to(torch.int32)
        return sample_batch(lg, self.generator, temps, top_ks, top_ps)

    def step(self, bt_d, len_d, tok_d, temps, tks, tps, mode,
             chunk_ops=None):
        """One fused step; returns the device token vector (the caller's
        host read is the step's single sync).

        With ``chunk_ops`` a prefill chunk (``c_toks`` [1, C] at offset
        ``c_off`` with ``c_valid`` real tokens) rides the decode step: it
        writes its K/V into pool pages and attends over everything cached
        so far, then every slot decodes as in the plain step.  Its first
        output token is sampled from the last valid chunk logit and
        returned as row ``B`` of the token vector."""
        if chunk_ops is None:
            return self._decode_sample(bt_d, len_d, tok_d, temps, tks, tps,
                                       mode)
        c_toks, c_bt, c_off, c_valid, c_temp, c_tk, c_tp = chunk_ops
        c_logits = self.model.prefill_chunk_paged(
            self.pool.k_pool, self.pool.v_pool, c_toks, c_bt, c_off, c_valid)
        c_tid = sample_batch(c_logits, self.generator, c_temp, c_tk, c_tp)
        nxt = self._decode_sample(bt_d, len_d, tok_d, temps, tks, tps, mode)
        return torch.cat([nxt, c_tid])

    def chunk_wave(self, buf, bts, offs, valids):
        """One lockstep batched chunk step (cold-start admission wave);
        returns each row's last-valid-position logits [R, V]."""
        return self.model.prefill_chunk_paged(
            self.pool.k_pool, self.pool.v_pool, self.to_device(buf),
            self.to_device(bts), self.to_device(offs),
            self.to_device(valids))

    def prefill_chunk_eager(self, tokens_row, bt_row, start: int, v: int):
        """A single chunk over the pool (stop-the-world suffix prefill and
        restore-tail replay); returns its last valid logits [V]."""
        lg = self.model.prefill_chunk_paged(
            self.pool.k_pool, self.pool.v_pool, self.to_device(tokens_row),
            self.to_device(bt_row), self.to_device([start]),
            self.to_device([v]))
        return lg[0]

    def prefill_dense(self, toks):
        """Batched bucketed dense prefill (stop-the-world misses):
        ``(logits, state)`` of ``Model.forward``."""
        return self.model.forward(self.to_device(toks), collect_state=True)

    def sample_first(self, logits_rows, samplings) -> np.ndarray:
        """First tokens for an admission wave: one call, one host sync."""
        t_arr, tk_arr, tp_arr = stack_sampling(samplings, device=self.device)
        return sample_batch(torch.stack(logits_rows), self.generator, t_arr,
                            tk_arr, tp_arr).cpu().numpy()

    # -- buffer-shape policy --------------------------------------------
    @staticmethod
    def sampler_mode(samp: list[SamplingParams]) -> str:
        if any(p.temperature > 0.0 for p in samp):
            return "full"
        return "greedy"

    def chunk_buf(self, v: int) -> int:
        """Chunk-buffer length for ``v`` valid tokens: the next power of
        two (floor 32), capped at the chunk budget."""
        b = 32
        while b < v:
            b *= 2
        return min(b, max(self.chunk_tokens, v))

    def bucket(self, n: int) -> int:
        """Prefill length bucket for stop-the-world admission (next power
        of two, floor 32, capped at max_seq_len)."""
        b = 32
        while b < n:
            b *= 2
        return min(b, max(n, self.max_seq_len))
