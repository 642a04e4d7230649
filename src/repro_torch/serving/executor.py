"""The serving runtimes' device programs, ported from
``repro/serving/executor.py``: ``PagedExecutor`` for the paged families
and ``DenseRuntime`` for the non-paged ones.

``PagedExecutor`` holds every device program the paged serving stack
launches: the fused decode step, the mixed decode+chunk step, the
cold-start chunk wave, the dense prefill of stop-the-world admission, and
the sampler, plus the generator and the buffer-shape policies (chunk
buffers, length buckets).  PyTorch runs eagerly, so there is nothing to compile: each
program is a plain call.  The K/V pools of the ``PagedKVCache`` are
updated in place (the reference donated them to XLA).  The scheduler
never touches device tensors directly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.cache import quant_kvc
from repro_torch.serving.request import (
    Seq,
    SeqState,
    seq_finished,
    seq_result,
)
from repro_torch.serving.sampler import SamplingParams, sample_batch, stack_sampling
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tokenizer import truncate_prompt


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
        with torch.no_grad():
            return self.model.forward(self.to_device(toks),
                                      collect_state=True)

    def prefill_exact(self, tokens: list[int]):
        """Unpadded, per-sequence prefill (MoE families, where padding
        would perturb capacity-based routing of real tokens).  Returns
        ``(last_logits, state)``."""
        with torch.no_grad():
            lg, state = self.model.forward(self.to_device(tokens)[None],
                                           collect_state=True)
        return lg[0, len(tokens) - 1], state

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


class DenseRuntime:
    """Non-paged serving loop, ported from ``repro/serving/executor.py``
    (the SSM, hybrid and MLA families, and GQA models with a sliding
    window):
    each request prefills alone through ``Model.forward`` (resuming from
    a SkyMemory snapshot on a hit), the batch's states are stacked into
    one dense cache, and every decode step samples all rows with the
    vectorized sampler and one host sync.  Shares the SkyMemory manager
    with the paged path, not the page pool."""

    def __init__(self, model, tokenizer, adapter, manager, *,
                 max_seq_len: int, max_batch: int, write_back: bool,
                 seed: int = 0) -> None:
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.tokenizer = tokenizer
        self.adapter = adapter
        self.manager = manager
        self.max_seq_len = max_seq_len
        self.max_batch = max_batch
        self.write_back = write_back
        self.stats = EngineStats()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def generate(self, requests) -> list:
        results = []
        for lo in range(0, len(requests), self.max_batch):
            results.extend(self._run_batch(requests[lo: lo + self.max_batch]))
        return results

    def _prefill_one(self, req) -> Seq:
        t0 = time.perf_counter()
        tokens = truncate_prompt(self.tokenizer.encode(req.prompt),
                                 self.max_seq_len)
        s = Seq(request=req, tokens=tokens, enqueue_t=t0)
        cached = 0
        prefix_state = None
        if self.manager is not None:
            # The prompt is looked up without its last token, so a hit
            # never covers it and that token is prefilled exactly once,
            # from a snapshot that does not yet hold it.  The reference
            # looks up the whole prompt and, on a hit that covers it,
            # replays the last token from the snapshot taken after it: an
            # SSM state then applies that token twice, and a block-aligned
            # prompt served warm gives another stream than served cold.
            payload, cached = self.manager.get_cache_tokens(tokens[:-1])
            if payload is not None:
                prefix_state = self.adapter.payload_to_state(payload)
        toks = torch.as_tensor(tokens, dtype=torch.int32,
                               device=self.device)[None]
        with torch.no_grad():
            if cached:
                lg, state = self.model.forward(
                    toks[:, cached:], q_offset=cached,
                    prefix_state=prefix_state, collect_state=True)
            else:
                lg, state = self.model.forward(toks, collect_state=True)
        self.stats.prefill_time_s += time.perf_counter() - t0
        self.stats.cached_tokens += cached
        self.stats.prefilled_tokens += len(tokens) - cached
        if self.write_back and self.manager is not None:
            self.manager.add_blocks_tokens(tokens)
        s.cached = cached
        s.dense_state = state
        s.last_logits = lg[0, -1]
        s.state = SeqState.RUNNING
        return s

    def _stack_dense_caches(self, seqs: list[Seq]) -> dict:
        """Prefill -> decode handoff: the per-sequence SSM states and the
        K/V or MLA latents of each sequence's ``n`` prompt tokens (into
        slots ``[0, n)``) are copied into one batched cache of
        ``max_seq_len`` tokens, or of the sliding window's ring.  A
        prompt longer than the ring cannot be stacked (nor can it in the
        reference)."""
        cache = self.model.init_cache(len(seqs), self.max_seq_len)
        for i, s in enumerate(seqs):
            st = s.dense_state
            if "ssm" in st:
                cache["ssm"]["conv"][:, i] = st["ssm"]["conv"][:, 0]
                cache["ssm"]["state"][:, i] = st["ssm"]["state"][:, 0]
            for part in ("kv", "mla"):
                if part not in st:
                    continue
                n = len(s.tokens)
                dsts = cache[part]
                ring = next(iter(dsts.values())).shape[2]
                if n > ring:
                    raise ValueError(
                        f"a {n}-token prompt does not fit the {ring}-slot "
                        "decode cache (the sliding window's ring)")
                for key, dst in dsts.items():
                    src = st[part][key][:, 0, :n]
                    if dst.dtype == torch.int8:
                        src = quant_kvc(src)
                    dst[:, i, :n] = src
            s.dense_state = None   # the per-request copy is no longer read
        return cache

    def _sample(self, logits, samplings, temps, tks, tps) -> torch.Tensor:
        if PagedExecutor.sampler_mode(samplings) == "greedy":
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_batch(logits, self.generator, temps, tks, tps)

    def _run_batch(self, requests) -> list:
        t_start = time.perf_counter()
        seqs = [self._prefill_one(r) for r in requests]
        cache = self._stack_dense_caches(seqs)
        pos = torch.as_tensor([len(s.tokens) for s in seqs],
                              dtype=torch.int32, device=self.device)
        # first token of each sequence from its prefill logits
        logits = torch.stack([s.last_logits for s in seqs])
        samplings = [s.request.sampling for s in seqs]
        temps, tks, tps = stack_sampling(samplings, device=self.device)

        max_new = max(p.max_new_tokens for p in samplings)
        t_dec = time.perf_counter()
        first = True
        last_tok_t = [0.0] * len(seqs)
        for _ in range(max_new):
            nxt = self._sample(logits, samplings, temps, tks, tps)
            nxt_h = nxt.cpu().numpy()          # the step's single host sync
            now = time.perf_counter()
            for i, s in enumerate(seqs):
                if s.done:
                    continue
                tid = int(nxt_h[i])
                s.out_ids.append(tid)
                if first:
                    s.ttft_s = now - s.enqueue_t
                    self.stats.ttft_s.append(s.ttft_s)
                else:
                    self.stats.itl_s.append(now - last_tok_t[i])
                    s.itl.append(now - last_tok_t[i])
                last_tok_t[i] = now
                seq_finished(s, tid, eos_id=self.tokenizer.eos_id,
                             max_seq_len=self.max_seq_len)
            first = False
            self.stats.decoded_tokens += sum(0 if s.done else 1 for s in seqs)
            if all(s.done for s in seqs):
                break
            logits = self.model.decode_step(cache, nxt[:, None], pos)[:, 0]
            self.stats.decode_steps += 1
            pos = pos + 1
        self.stats.decode_time_s += time.perf_counter() - t_dec

        out = []
        wall = time.perf_counter() - t_start
        for s in seqs:
            self.stats.requests += 1
            s.state = SeqState.FINISHED
            s.wall_s = wall
            out.append(seq_result(s, self.tokenizer))
        return out
