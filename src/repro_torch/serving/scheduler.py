"""Scheduler: admission, chunk budgeting, and preemption policy, ported
from ``repro/serving/scheduler.py`` (the same host-side state machine;
its device hand-offs are ``PagedExecutor.to_device`` copies, and the
step's single host sync is the read of the sampled token vector).

This is the paged runtime's host-side brain.  It owns the request
lifecycle (QUEUED -> PREFILLING -> RUNNING -> FINISHED, with PREEMPTED
as the swap detour), the per-slot lane state the jitted steps consume
(lengths / input tokens / sampling params), and three policies:

* **Admission** is continuous and *lazy*: a request needs a free slot
  and pages for its prompt plus one decode write -- not its worst-case
  footprint.  The pool can therefore run more live sequences than it
  could hold at their maximum lengths.
* **Chunk budgeting**: prompts prefill in page-aligned chunks of at most
  ``chunk_tokens`` that ride the decode step (see ``chunk_spans``);
  cold-start waves prefill together as lockstep batched chunk steps.
* **Preemption-by-offload**: when a running sequence needs a page and
  the pool has none (growth pressure), or a strictly higher-priority
  request is queued behind a full machine (priority pressure), the
  lowest-priority sequence -- ties broken against the most recently
  admitted -- is offloaded through the ``TieredKVManager`` (device ->
  host -> constellation) and requeued at the front.  It resumes via
  ``restore``: a host-tier hit imports bit-identical pages (nothing
  replayed); a miss restores the longest block-aligned prefix the
  constellation holds and replays only the unaligned tail through the
  chunked-prefill path, with the already-sampled next token carried
  across the swap so outputs are unchanged.  Admission refusal and pool
  exhaustion are no longer failure modes.

The scheduler never touches device arrays: the ``PagedExecutor`` runs
the programs, the ``TieredKVManager`` moves K/V between tiers.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from repro_torch.serving.executor import PagedExecutor
from repro_torch.serving.kv_manager import TieredKVManager
from repro_torch.serving.request import (
    GenerationResult,
    Request,
    Seq,
    SeqState,
    seq_finished,
    seq_result,
)
from repro_torch.serving.sampler import SamplingParams, stack_sampling
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tokenizer import truncate_prompt


def head_span(n_tokens: int, cursor: int, budget: int) -> tuple[int, int]:
    """The next chunk for a prompt of ``n_tokens`` prefilled up to
    ``cursor``: ``(start, length)`` with length at most ``budget``.  The
    scheduler consumes exactly this, one span per step."""
    return cursor, min(budget, n_tokens - cursor)


def chunk_spans(n_tokens: int, start: int, budget: int
                ) -> list[tuple[int, int]]:
    """The full chunk plan for a prompt of ``n_tokens`` whose pages are
    already valid up to ``start`` (a restored SkyMemory prefix, or the
    replay point of a whole-prompt hit): the ``head_span`` sequence,
    covering ``[start, n_tokens)`` in order.  Only the final span may be
    ragged, so every split lands on a page boundary whenever ``start``
    and ``budget`` are page-aligned."""
    spans = []
    cursor = start
    while cursor < n_tokens:
        s, v = head_span(n_tokens, cursor, budget)
        spans.append((s, v))
        cursor = s + v
    return spans


class Scheduler:
    """Continuous-batching scheduler over one executor + KV fabric."""

    def __init__(
        self,
        executor: PagedExecutor,
        kv: TieredKVManager,
        tokenizer,
        *,
        max_batch: int,
        max_seq_len: int,
        chunk_tokens: int,
    ) -> None:
        self.ex = executor
        self.kv = kv
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.chunk_tokens = chunk_tokens
        self.chunked = bool(chunk_tokens)
        self.stats = EngineStats()
        self.chunk_log: list[tuple[int, int, int]] = []  # (slot, start, n)
        self._admit_counter = 0
        self._reset_stream()

    def _reset_stream(self) -> None:
        """(Re)initialize the persistent streaming machine state.  The
        scheduler is long-lived now: ``submit``/``service`` operate on
        this state across an open-ended stream, and ``run`` is a closed
        batch riding the same machinery."""
        b = self.max_batch
        # submit() appends here from any thread; the servicing thread
        # drains it into _pending (deque append/popleft are atomic, and
        # _pending stays single-threaded for the preemption requeues)
        self._inbox: deque[Seq] = deque()
        self._pending: deque[Seq] = deque()
        self._active: dict[int, Seq] = {}
        self._prefilling: dict[int, Seq] = {}  # insertion order == FIFO
        self._free_slots = list(range(b - 1, -1, -1))
        self._lengths = np.zeros(b, np.int32)
        self._tokens = np.zeros(b, np.int32)
        self._samp = [SamplingParams() for _ in range(b)]
        self._last_tok_t = [0.0] * b
        self._samp_dirty = self._bt_dirty = True
        self._admit_stall = False  # a stop-the-world wave ran under decodes

    # ------------------------------------------------------------------
    # streaming entry points
    # ------------------------------------------------------------------
    @property
    def backlog(self) -> bool:
        """Anything submitted but not yet finished/failed."""
        return bool(self._inbox or self._pending
                    or self._active or self._prefilling)

    def submit(self, request: Request) -> Future:
        """Enqueue one request; the returned future resolves to its
        ``GenerationResult`` when it finishes (or raises if it can never
        be admitted).  Thread-safe: the worker loop (or ``run``) does the
        actual stepping."""
        s = self._make_seq(request)
        s.future = Future()
        self._inbox.append(s)
        return s.future

    def service(self) -> bool:
        """One scheduling round: drain the inbox, grow/admit, and run one
        fused device step if anything is live.  Returns whether backlog
        remains.  Single-threaded: only the worker loop or ``run`` may
        call this."""
        self._drain_inbox()
        # -- growth: running sequences claim next-write pages first -----
        if self._active:
            self._grow_active()
        # -- admission: fill freed slots from the queue ------------------
        self._admit()
        if self._active or self._prefilling:
            self._step_once()
        elif self._pending:
            # the machine is idle (every slot free, nothing to preempt)
            # and the head still cannot admit: its footprint can never
            # fit.  Fail that request alone; the stream continues.
            s = self._pending.popleft()
            self._fail_seq(s, RuntimeError(
                "cannot admit request: KV page pool too small for "
                f"a {self._need_tokens(s)}-token "
                "footprint even with every slot preempted"))
        return self.backlog

    def _drain_inbox(self) -> None:
        while self._inbox:
            self._pending.append(self._inbox.popleft())

    def cancel_queued(self) -> int:
        """Cancel every submitted-but-unstarted request (fresh QUEUED
        seqs; preempted ones are mid-request and keep their claim).
        Returns how many were cancelled -- the ``stop(drain=False)``
        path."""
        self._drain_inbox()
        kept: deque[Seq] = deque()
        n = 0
        for s in self._pending:
            if (s.state is SeqState.QUEUED and s.future is not None
                    and s.future.cancel()):
                n += 1
            else:
                kept.append(s)
        self._pending = kept
        return n

    def fail_all(self, exc: BaseException) -> None:
        """A worker-loop crash: fail every in-flight future so no waiter
        hangs, release their slots/pages, and reset the machine."""
        self._drain_inbox()
        seqs = list(self._pending)
        for slot, s in (list(self._active.items())
                        + list(self._prefilling.items())):
            self.kv.release(slot)
            seqs.append(s)
        for s in seqs:
            if s.future is not None:
                try:
                    s.future.set_exception(exc)
                except InvalidStateError:
                    pass
        self._reset_stream()

    # ------------------------------------------------------------------
    def run(self, requests: list[Request]) -> list[GenerationResult]:
        """Closed-batch serve: a thin wrapper over the streaming path.
        Submits everything, services until the stream drains, and returns
        results in request order with the legacy batch-wall stamping."""
        t_start = time.perf_counter()
        self.chunk_log = []
        futs = [self.submit(r) for r in requests]
        while self.service():
            pass

        self.kv.drain_write_back()   # settle Set KVC before handing back
        wall = time.perf_counter() - t_start
        out = []
        first_err: BaseException | None = None
        for fut in futs:
            err = fut.exception()
            if err is not None:
                first_err = first_err or err
                continue
            res = fut.result()
            res.wall_time_s = wall
            out.append(res)
        if first_err is not None:
            raise first_err
        return out

    # ------------------------------------------------------------------
    # one fused device step + host bookkeeping
    # ------------------------------------------------------------------
    def _step_once(self) -> None:
        b = self.max_batch
        chunk = self._plan_chunk()

        if self._samp_dirty:
            self._samp_dev = stack_sampling(self._samp, device=self.ex.device)
            self._mode = self.ex.sampler_mode(self._samp)
            self._samp_dirty = False
        if self._bt_dirty:
            # contiguous slot regions need no table on device; free-list
            # pools upload the table only when admission/release/growth
            # changed it
            self._bt_dev = (None if self.kv.pool.contiguous
                            else self.ex.to_device(self.kv.pool.block_tables))
            self._bt_dirty = False
        len_d = self.ex.to_device(self._lengths)
        tok_d = self.ex.to_device(self._tokens)

        # -- one fused device step; ONE host sync (the token read) ------
        t0 = time.perf_counter()
        temps_d, tks_d, tps_d = self._samp_dev
        ops_c = None if chunk is None else chunk[4]
        nxt = self.ex.step(self._bt_dev, len_d, tok_d, temps_d, tks_d,
                           tps_d, self._mode, chunk_ops=ops_c)
        nxt_h = nxt.cpu().numpy()             # the step's single host sync
        now = time.perf_counter()
        self.stats.decode_time_s += now - t0
        self.stats.decode_steps += 1

        # -- host-side scheduling on the synced token ids ---------------
        in_admission = bool(self._prefilling) or self._admit_stall
        self._admit_stall = False
        for slot, s in list(self._active.items()):
            tid = int(nxt_h[slot])
            s.out_ids.append(tid)
            self.stats.decoded_tokens += 1
            itl = now - self._last_tok_t[slot]
            self.stats.itl_s.append(itl)
            s.itl.append(itl)
            if in_admission:
                self.stats.itl_admission_s.append(itl)
            self._last_tok_t[slot] = now
            self._lengths[slot] += 1
            if seq_finished(s, tid, eos_id=self.tokenizer.eos_id,
                            max_seq_len=self.max_seq_len):
                self._active.pop(slot)
                self._release(s, slot)
            else:
                self._tokens[slot] = tid

        # -- chunk retirement -------------------------------------------
        if chunk is not None:
            s_c, slot_c, start_c, v_c, _ = chunk
            self.stats.prefill_chunks += 1
            s_c.cursor = start_c + v_c
            if s_c.cursor >= len(s_c.prefill_tokens):
                # last chunk landed: its first token was sampled in-step
                # (row b of the synced vector); a resumed sequence's next
                # token is already known, so that sample is discarded
                self._prefilling.pop(slot_c)
                # (Set KVC for this sequence was already submitted at
                # lookup time by _lookup_and_prefetch, so any duplicate
                # context's later lookup drains it and hits)
                self._finish_prefill(s_c, slot_c, int(nxt_h[b]), now)
                if s_c.done:
                    self._release(s_c, slot_c)
                elif slot_c not in self._active:
                    self._active[slot_c] = s_c
                    self._last_tok_t[slot_c] = now
                self._samp_dirty = self._bt_dirty = True

    # ------------------------------------------------------------------
    # admission / restore
    # ------------------------------------------------------------------
    def _admit(self) -> None:
        admitted: list[tuple[Seq, int]] = []
        while self._pending:
            s = self._pending[0]
            if self._free_slots and self.kv.can_admit_tokens(
                    self._need_tokens(s)):
                self._pending.popleft()
                admitted.append(self._admit_seq(s))
                continue
            # priority pressure: a strictly higher-priority queued request
            # evicts the lowest-priority victim (equal priorities never
            # preempt each other, so plain FIFO streams cannot thrash)
            victim = self._pick_victim()
            if (victim is not None
                    and victim[1].request.priority < s.request.priority):
                # requeue the victim BEHIND the head that evicted it
                self._preempt(victim, requeue_pos=1)
                continue
            break
        # best-effort FIFO: a preempted head waiting for its (larger)
        # restore footprint must not idle free slots -- fresh requests
        # behind it may admit into pages it cannot use yet.  The head
        # regains first claim at the top of every admission round, so it
        # resumes the moment its pages fit and cannot starve.
        if (self._pending and self._free_slots
                and self._pending[0].state is SeqState.PREEMPTED):
            i = 1
            while i < len(self._pending) and self._free_slots:
                s = self._pending[i]
                if (s.state is not SeqState.PREEMPTED
                        and self.kv.can_admit_tokens(self._need_tokens(s))):
                    del self._pending[i]
                    admitted.append(self._admit_seq(s))
                else:
                    i += 1
        if not admitted:
            return
        self._bt_dirty = True

        # fully-restored sequences (host-tier hit: every page back,
        # including the unaligned tail) resume decoding immediately
        live: list[tuple[Seq, int]] = []
        now = time.perf_counter()
        for s, slot in admitted:
            if (s.replay_next is not None
                    and s.cursor >= len(s.prefill_tokens)):
                self._resume_active(s, slot, now)
            else:
                live.append((s, slot))
        if not live:
            return

        if self.chunked and (self._active or self._prefilling):
            # decode is live: chunks ride the decode steps so no running
            # sequence stalls for this admission
            for s, slot in live:
                s.state = SeqState.PREFILLING
                self._prefilling[slot] = s
                # park the slot's decode lane on its last reservable
                # position: the idle lane's unconditional write lands
                # where no chunk data lives (free-list rows point unbacked
                # logical pages at the scratch page) and where any real
                # decode write would overwrite it anyway
                self._lengths[slot] = s.reserve - 1
                self._tokens[slot] = 0
        else:
            # nothing is decoding, so nothing can starve: prefill the
            # whole wave now (as batched chunk steps when chunked, else
            # the bucketed stop-the-world wave)
            self._admit_stall = bool(self._active)
            if self.chunked:
                self._admit_wave_chunked(live)
            else:
                self._admit_wave(live)
            self._samp_dirty = True

    def _admit_seq(self, s: Seq) -> tuple[Seq, int]:
        """Slot + page bookkeeping for one admission (fresh or restore)."""
        slot = self._free_slots.pop()
        # allocate NOW so can_admit for the rest of the wave sees the
        # shrunken free list (free-list pools)
        s.reserve = self._reserve_tokens(s)
        self._bt_dirty |= self.kv.reserve(slot, self._need_tokens(s))
        self._admit_counter += 1
        s.admit_seq = self._admit_counter
        if self._active or self._prefilling:
            self.stats.mid_decode_admissions += 1
        if s.state is SeqState.PREEMPTED:
            self._restore(s, slot)
        return s, slot

    def _restore(self, s: Seq, slot: int) -> None:
        """Bring a preempted sequence's K/V back into pool pages; leaves
        ``s.cursor`` at the covered-token boundary (the tail past it
        replays through the chunk path)."""
        goal = len(s.replay_tokens)
        cached = self.kv.restore(s.request.request_id, slot,
                                 s.replay_tokens)
        self.stats.restores += 1
        if cached < goal:
            self.stats.replayed_tokens += goal - cached
        s.cursor = cached
        s.looked_up = True
        s.pages_future = None
        s.fetch_ready_at = None
        s.dev_ops = None

    def _resume_active(self, s: Seq, slot: int, now: float) -> None:
        """A restored sequence re-enters decode exactly where it left
        off: lane length is its covered-token count and the lane input is
        the token that was already sampled before the swap -- nothing is
        sampled twice, so outputs are unchanged."""
        self._lengths[slot] = len(s.replay_tokens)
        self._tokens[slot] = s.replay_next
        self._samp[slot] = s.request.sampling
        s.state = SeqState.RUNNING
        s.replay_tokens = None
        s.replay_next = None
        self._active[slot] = s
        self._last_tok_t[slot] = now
        self._samp_dirty = self._bt_dirty = True

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------
    def _pick_victim(self) -> tuple[int, Seq, str] | None:
        """Lowest-priority in-flight sequence; ties broken against the
        most recently admitted (LIFO, so long-running work survives)."""
        cands = [(slot, s, "run") for slot, s in self._active.items()]
        cands += [(slot, s, "pre") for slot, s in self._prefilling.items()]
        if not cands:
            return None
        return min(cands,
                   key=lambda c: (c[1].request.priority, -c[1].admit_seq))

    def _grow_active(self) -> None:
        """Every running slot claims the page its next decode write needs;
        on pool exhaustion, preempt victims until it fits (or the grower
        itself is the victim and leaves the machine)."""
        for slot in list(self._active.keys()):
            if slot not in self._active:
                continue          # offloaded by an earlier victim pick
            need = int(self._lengths[slot]) + 1
            while True:
                ok, changed = self.kv.try_grow(slot, need)
                if ok:
                    self._bt_dirty |= changed
                    break
                victim = self._pick_victim()
                vslot = self._preempt(victim)
                if vslot == slot:
                    break         # the grower was the cheapest victim

    def _preempt(self, victim: tuple[int, Seq, str], *,
                 requeue_pos: int = 0) -> int:
        """Offload a victim through the tier hierarchy and requeue it.

        RUNNING victims record their exact replay state (covered tokens +
        the already-sampled next token) and export every covered page.
        PREFILLING victims export what their retired chunks covered and
        go back to QUEUED (no token was emitted yet, so a fresh admission
        -- seeded by the host-tier pages -- reproduces them exactly).
        """
        slot, s, kind = victim
        if kind == "run":
            valid = int(self._lengths[slot])
            s.replay_tokens = (s.tokens + s.out_ids)[:valid]
            s.replay_next = int(self._tokens[slot])
            self.kv.offload(s.request.request_id, slot, s.replay_tokens)
            self._active.pop(slot)
            s.state = SeqState.PREEMPTED
        else:
            if s.pages_future is not None:
                # a fetched prefix is still in flight: land it first so
                # the export below covers everything the cursor claims
                self.kv.wait_fetch(s.fetch_ready_at)
                s.fetch_ready_at = None
                k_blocks, v_blocks = s.pages_future.result()
                s.pages_future = None
                self.kv.pool.write_pages(slot, 0, k_blocks, v_blocks)
            if s.cursor > 0:
                self.kv.offload(s.request.request_id, slot,
                                s.prefill_tokens[: s.cursor])
            self._prefilling.pop(slot)
            s.cursor = 0
            s.looked_up = False
            s.fetch_ready_at = None
            s.dev_ops = None
            # a resumed sequence caught mid-replay keeps its PREEMPTED
            # identity (replay state intact); a fresh prefill re-queues
            s.state = (SeqState.PREEMPTED if s.replay_next is not None
                       else SeqState.QUEUED)
        s.preempt_count += 1
        self.stats.preemptions += 1
        self.kv.release(slot)
        self._lengths[slot] = 0
        self._tokens[slot] = 0
        self._samp[slot] = SamplingParams()
        self._free_slots.append(slot)
        self._samp_dirty = self._bt_dirty = True
        if requeue_pos == 0 or not self._pending:
            self._pending.appendleft(s)
        else:
            self._pending.insert(requeue_pos, s)
        return slot

    # ------------------------------------------------------------------
    # chunked prefill
    # ------------------------------------------------------------------
    def _plan_chunk(self):
        """Pick the next prefill chunk (FIFO over prefilling sequences).

        The head sequence's SkyMemory lookup happens lazily here -- after
        any earlier sequence's write-back, so duplicate contexts queued
        together still hit -- and its payload->pages decode runs on the
        adapter's fetch-ahead thread alongside any simulated ISL flight:
        while the head's fetch is pending and other sequences are
        decoding, its chunk is deferred so the flight/deserialization
        overlaps device compute, and the *next* prefilling sequence's
        chunks run instead of head-of-line blocking behind the flight.
        Returns ``(seq, slot, start, n_valid, device_operands)`` or None.
        """
        if not self.chunked or not self._prefilling:
            return None
        # FIFO over prefilling sequences, but a head whose fetched prefix
        # is still pending (payload decoding, or ISL flight on the fabric
        # clock) must not head-of-line-block the others for the whole
        # flight: skip past it and plan the first ready sequence.  Later
        # candidates are only looked up inside such a window, so in the
        # common (no-pending-head) case lookup order stays strictly FIFO.
        deferred: tuple[int, Seq] | None = None
        chosen: tuple[int, Seq] | None = None
        saw_flight = False
        for slot, s in list(self._prefilling.items()):
            if not s.looked_up:
                t0 = time.perf_counter()
                self._lookup_and_prefetch(s)
                self.stats.prefill_time_s += time.perf_counter() - t0
            if s.pages_future is not None and (
                    self.kv.fetch_pending(s.fetch_ready_at)
                    or not s.pages_future.done()):
                saw_flight |= self.kv.fetch_pending(s.fetch_ready_at)
                if deferred is None:
                    deferred = (slot, s)
                continue
            chosen = (slot, s)
            break
        if chosen is None:
            if self._active or deferred is None:
                # every candidate is in flight: this step's chunk slot is
                # spent overlapping the flight(s); the chunks retry next
                # step
                if saw_flight:
                    self.stats.l2_deferred_chunks += 1
                return None
            # nothing is decoding and nothing is ready: experience the
            # first pending sequence's remaining flight
            chosen = deferred
        slot, s = chosen
        if s.pages_future is not None:
            self.kv.wait_fetch(s.fetch_ready_at)
            s.fetch_ready_at = None
            k_blocks, v_blocks = s.pages_future.result()
            s.pages_future = None
            self.kv.pool.write_pages(slot, 0, k_blocks, v_blocks)
        toks = s.prefill_tokens
        n = len(toks)
        start, v = head_span(n, s.cursor, self.chunk_tokens)
        self.kv.pool.note_span(slot, start, v)
        self.chunk_log.append((slot, start, v))
        if s.dev_ops is None:
            # per-sequence invariants, uploaded once per admission: the
            # block-table row is frozen (pages for the whole prompt were
            # allocated at admission) and sampling never changes per
            # request
            s.dev_ops = (
                self.ex.to_device(self.kv.pool.table_row(slot)[None]),
                *stack_sampling([s.request.sampling], device=self.ex.device),
            )
        buf = np.zeros((1, self.ex.chunk_buf(v)), np.int32)
        buf[0, :v] = toks[start:start + v]
        bt_row, c_temp, c_tk, c_tp = s.dev_ops
        ops_c = (
            self.ex.to_device(buf), bt_row,
            self.ex.to_device([start]), self.ex.to_device([v]),
            c_temp, c_tk, c_tp,
        )
        return s, slot, start, v, ops_c

    def _admit_wave_chunked(self, admitted: list[tuple[Seq, int]]) -> None:
        """Cold-start admission wave, chunked flavor: nothing is decoding,
        so the wave's prompts prefill *together* as lockstep batched chunk
        steps over the page pool.

        Phase 1 walks the wave in order: SkyMemory lookup, fetch-ahead
        payload decode (submitted per sequence, resolved after the loop so
        deserialization overlaps the later members' lookups/write-backs),
        and Set KVC write-back -- before the NEXT member's lookup, so
        duplicate contexts within one wave still hit.  Phase 2 runs
        batched chunk steps until every prompt (or restore-replay tail)
        is covered; fresh sequences' final-chunk logits are kept and
        their first tokens sampled in one call with one host sync, while
        resumed sequences re-enter decode with their carried next token.
        """
        t0 = time.perf_counter()
        for s, slot in admitted:
            s.state = SeqState.PREFILLING
            if s.replay_next is not None:
                continue          # restore already repopulated its pages
            # lookup submits this member's Set KVC too, so the NEXT
            # member's lookup drains it and same-wave duplicates hit
            self._lookup_and_prefetch(s)
        for s, slot in admitted:
            if s.pages_future is not None:
                # cold start: nothing is decoding, so the fetch flights
                # cannot hide -- wait them out (clock is monotone, so the
                # wave's total wait is the max remaining flight)
                self.kv.wait_fetch(s.fetch_ready_at)
                s.fetch_ready_at = None
                k_blocks, v_blocks = s.pages_future.result()
                s.pages_future = None
                self.kv.pool.write_pages(slot, 0, k_blocks, v_blocks)

        last_logits: dict[int, torch.Tensor] = {}
        live = [(s, slot) for s, slot in admitted]
        while live:
            c_b = self.ex.chunk_buf(max(
                min(self.chunk_tokens, len(s.prefill_tokens) - s.cursor)
                for s, _ in live))
            rows = 1
            while rows < len(live):          # pad batch rows to a power
                rows *= 2                    # of two: O(log max_batch)
            buf = np.zeros((rows, c_b), np.int32)
            offs = np.zeros(rows, np.int32)
            valids = np.zeros(rows, np.int32)   # padding rows are no-ops
            bts = np.zeros((rows, self.kv.pool.pages_per_seq), np.int32)
            for i, (s, slot) in enumerate(live):
                toks = s.prefill_tokens
                start = s.cursor
                v = min(c_b, len(toks) - start)
                buf[i, :v] = toks[start:start + v]
                offs[i], valids[i] = start, v
                bts[i] = self.kv.pool.table_row(slot)
                self.kv.pool.note_span(slot, start, v)
                self.chunk_log.append((slot, start, v))
            lg = self.ex.chunk_wave(buf, bts, offs, valids)
            self.stats.prefill_chunks += 1
            nxt_live = []
            for i, (s, slot) in enumerate(live):
                s.cursor = int(offs[i] + valids[i])
                if s.cursor >= len(s.prefill_tokens):
                    if s.replay_next is None:
                        last_logits[id(s)] = lg[i]
                else:
                    nxt_live.append((s, slot))
            live = nxt_live

        self.stats.prefill_time_s += time.perf_counter() - t0
        now = time.perf_counter()
        fresh = [(s, slot) for s, slot in admitted
                 if s.replay_next is None]
        for s, slot in admitted:
            if s.replay_next is not None:
                self._resume_active(s, slot, now)
        if not fresh:
            return
        # first tokens for the wave: one sample call, one host sync
        tids = self.ex.sample_first(
            [last_logits[id(s)] for s, _ in fresh],
            [s.request.sampling for s, _ in fresh])
        now = time.perf_counter()
        for (s, slot), tid in zip(fresh, tids):
            self._finish_prefill(s, slot, int(tid), now)
            if s.done:
                self._release(s, slot)
            else:
                self._active[slot] = s
                self._last_tok_t[slot] = now

    # ------------------------------------------------------------------
    # stop-the-world admission (``chunk_tokens=0``)
    # ------------------------------------------------------------------
    def _admit_wave(self, admitted: list[tuple[Seq, int]]) -> None:
        """Stop-the-world admission: SkyMemory hits restore blocks
        straight into pages and prefill only their suffix (per sequence);
        misses prefill as ONE batched, bucketed forward.  Resumed
        sequences replay their unaligned tail as one paged chunk (logits
        discarded -- the next token is already known).  First tokens for
        the wave's fresh members are sampled in one call with one host
        sync."""
        t0 = time.perf_counter()
        last_logits: list = []
        fresh: list[tuple[Seq, int]] = []
        sampled: list[tuple[Seq, int]] = []
        resumed: list[tuple[Seq, int]] = []
        for s, slot in admitted:
            if s.replay_next is not None:
                if s.cursor < len(s.prefill_tokens):
                    self._replay_tail(s, slot)
                resumed.append((s, slot))
                continue
            # (pages were already allocated in the admission loop)
            self._lookup_and_prefetch(s)
            if s.pages_future is not None:
                last_logits.append(self._prefill_suffix_paged(s, slot))
                sampled.append((s, slot))
            else:
                s.cached = 0
                fresh.append((s, slot))
                last_logits.append(None)
                sampled.append((s, slot))
            # (Set KVC was submitted inside _lookup_and_prefetch, before
            # the NEXT wave member's lookup drains it, so duplicate
            # contexts within one admission wave still hit -- the
            # paper's repeated-context workload)

        if fresh:
            # one batched forward per length bucket; causal masking makes
            # the zero padding past each row's length invisible
            by_bucket: dict[int, list[int]] = {}
            for i, (s, _) in enumerate(fresh):
                by_bucket.setdefault(
                    self.ex.bucket(len(s.tokens)), []).append(i)
            fresh_logits: dict[int, torch.Tensor] = {}
            for bucket, idxs in by_bucket.items():
                rows = 1
                while rows < len(idxs):      # pad batch dim to a power of
                    rows *= 2                # two: O(log^2) compilations
                toks = np.zeros((rows, bucket), np.int32)
                for row, i in enumerate(idxs):
                    toks[row, : len(fresh[i][0].tokens)] = fresh[i][0].tokens
                lg, state = self.ex.prefill_dense(toks)
                for row, i in enumerate(idxs):
                    s, slot = fresh[i]
                    n = len(s.tokens)
                    self.kv.pool.write_token_span(
                        slot, 0,
                        state["kv"]["k"][:, row, :n],
                        state["kv"]["v"][:, row, :n],
                    )
                    fresh_logits[i] = lg[row, n - 1]
            fi = 0
            for j, lgt in enumerate(last_logits):
                if lgt is None:
                    last_logits[j] = fresh_logits[fi]
                    fi += 1

        self.stats.prefill_time_s += time.perf_counter() - t0
        now = time.perf_counter()
        for s, slot in resumed:
            self._resume_active(s, slot, now)
        if not sampled:
            return
        # first tokens for the wave from the prefill logits: one sample
        # call, one host sync (at admission, not in the decode loop)
        tids = self.ex.sample_first(
            last_logits, [s.request.sampling for s, _ in sampled])
        now = time.perf_counter()
        for (s, slot), tid in zip(sampled, tids):
            self._finish_prefill(s, slot, int(tid), now)
            if s.done:
                self._release(s, slot)
            else:
                self._active[slot] = s
                self._last_tok_t[slot] = now

    def _prefill_suffix_paged(self, s: Seq, slot: int):
        """SkyMemory hit under stop-the-world admission (the sequence's
        lookup already ran): fetched blocks drop straight into pool pages
        and the uncached suffix runs as ONE paged chunk attending over
        them *in place* -- no dense ``prefix_state`` restaging anywhere
        in the paged families.  A whole-prompt hit keeps every restored
        block and replays only the final token (the chunk machinery
        handles the one-token, unaligned-start span)."""
        n = len(s.tokens)
        self.kv.wait_fetch(s.fetch_ready_at)
        s.fetch_ready_at = None
        k_blocks, v_blocks = s.pages_future.result()
        s.pages_future = None
        self.kv.pool.write_pages(slot, 0, k_blocks, v_blocks)
        start = s.cursor
        v = n - start
        self.kv.pool.note_span(slot, start, v)
        self.chunk_log.append((slot, start, v))
        toks = np.asarray(s.tokens[start:], np.int32)[None]
        bt_row = np.asarray(self.kv.pool.table_row(slot)[None], np.int32)
        return self.ex.prefill_chunk_eager(toks, bt_row, start, v)

    def _replay_tail(self, s: Seq, slot: int) -> None:
        """Restore replay, stop-the-world flavor: the tokens past the
        restored prefix run as one paged chunk purely to rebuild their
        K/V (their output tokens exist already; the logits are
        discarded)."""
        toks = s.prefill_tokens
        start = s.cursor
        v = len(toks) - start
        self.kv.pool.note_span(slot, start, v)
        self.chunk_log.append((slot, start, v))
        buf = np.asarray(toks[start:], np.int32)[None]
        bt_row = np.asarray(self.kv.pool.table_row(slot)[None], np.int32)
        self.ex.prefill_chunk_eager(buf, bt_row, start, v)
        self.stats.prefill_chunks += 1
        s.cursor = len(toks)

    # ------------------------------------------------------------------
    # shared helpers
    # ------------------------------------------------------------------
    def _lookup_and_prefetch(self, s: Seq) -> None:
        """Prefix sources for a fresh admission, best tier first: the
        host page cache may hold this request's pages from a prefill-time
        preemption (bit-exact, possibly mid-page); otherwise SkyMemory's
        longest-prefix lookup -- on a hit, start at the cached boundary
        (a whole-prompt hit keeps every restored block and replays only
        the final token as a one-token chunk) and submit the
        payload->pages decode to the adapter's fetch-ahead thread.  Any
        in-flight Set KVC write-back is drained first, and this
        sequence's OWN write-back is submitted here -- at lookup time,
        not at prefill completion -- so a duplicate context looked up any
        time after this one (even while this one is still prefilling, as
        the skip-ahead chunk planner allows) drains it and hits."""
        s.looked_up = True
        entry = self.kv.take_host(s.request.request_id)
        if entry is not None:
            s.cursor = min(entry.n_tokens, len(s.tokens) - 1)
            fut = Future()
            fut.set_result((entry.k, entry.v))
            s.pages_future = fut
        else:
            payload, cached, ready_at = self.kv.lookup_prefix(s.tokens)
            if payload is not None and cached:
                restore = cached
                if cached >= len(s.tokens):
                    cached = len(s.tokens) - 1
                s.cached = cached
                s.cursor = cached
                s.fetch_ready_at = ready_at
                s.pages_future = self.kv.pages_async(payload, restore)
        if self.kv.write_back and self.kv.manager is not None:
            # Set KVC for uncached blocks on the worker thread (a no-op
            # radix probe when the lookup fully hit)
            self.kv.write_back_async(s.tokens)

    def _finish_prefill(self, s: Seq, slot: int, tid: int,
                        now: float) -> None:
        """A sequence's last chunk landed.  Fresh admission: book its
        first token.  Resumed sequence: the sampled id is discarded and
        the carried next token re-enters decode instead."""
        if s.replay_next is not None:
            self._resume_active(s, slot, now)
            return
        s.out_ids.append(tid)
        s.ttft_s = now - s.enqueue_t
        self.stats.ttft_s.append(s.ttft_s)
        self.stats.decoded_tokens += 1
        self.stats.cached_tokens += s.cached
        self.stats.prefilled_tokens += len(s.tokens) - s.cached
        s.state = SeqState.RUNNING
        if not seq_finished(s, tid, eos_id=self.tokenizer.eos_id,
                            max_seq_len=self.max_seq_len):
            self._lengths[slot] = len(s.tokens)
            self._tokens[slot] = tid
            self._samp[slot] = s.request.sampling

    def _make_seq(self, req: Request) -> Seq:
        tokens = truncate_prompt(self.tokenizer.encode(req.prompt),
                                 self.max_seq_len)
        return Seq(request=req, tokens=tokens,
                   enqueue_t=time.perf_counter())

    def _reserve_tokens(self, s: Seq) -> int:
        """Worst-case token footprint (prompt + max_new_tokens, capped at
        max_seq_len) -- no longer *reserved* in pages, but still the park
        position for an admitted sequence's idle decode lane."""
        return min(len(s.tokens) + s.request.sampling.max_new_tokens,
                   self.max_seq_len)

    def _need_tokens(self, s: Seq) -> int:
        """Pages a sequence needs AT admission: its prompt (or restored
        span) plus one decode write.  Growth past this is lazy,
        page-by-page, with preemption as the pressure valve."""
        if s.state is SeqState.PREEMPTED:
            return min(len(s.replay_tokens) + 1, self.max_seq_len)
        return min(len(s.tokens) + 1, self._reserve_tokens(s))

    def _release(self, s: Seq, slot: int) -> None:
        s.state = SeqState.FINISHED
        self.kv.release(slot)
        self._lengths[slot] = 0
        self._tokens[slot] = 0
        self._samp[slot] = SamplingParams()
        self._free_slots.append(slot)
        self._samp_dirty = self._bt_dirty = True
        self.stats.requests += 1
        self._finalize(s)

    def _finalize(self, s: Seq) -> None:
        """Resolve a finished sequence's future with its result.  The
        per-request wall clock ends here (a closed batch overwrites it
        with the batch wall afterwards, the legacy contract); future
        callbacks -- e.g. the cluster router's per-request load release
        -- run inline on the servicing thread."""
        s.wall_s = time.perf_counter() - s.enqueue_t
        if s.future is None:
            return
        try:
            s.future.set_result(seq_result(s, self.tokenizer))
        except InvalidStateError:
            pass                      # cancelled while finishing

    def _fail_seq(self, s: Seq, exc: BaseException) -> None:
        if s.future is None:
            raise exc
        try:
            s.future.set_exception(exc)
        except InvalidStateError:
            pass
