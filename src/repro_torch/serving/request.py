"""Serving request/response types and scheduler states (a copy of
``repro/serving/request.py``)."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field

from repro_torch.serving.sampler import SamplingParams

_ids = itertools.count()


class SeqState(enum.Enum):
    """Lifecycle of a request inside the continuous-batching scheduler."""

    QUEUED = "queued"            # waiting for a free slot + pages
    PREFILLING = "prefilling"    # owns a slot; prompt chunks ride the
    #                              decode step until the last one lands
    RUNNING = "running"          # decoded every step
    PREEMPTED = "preempted"      # pages offloaded to the host/constellation
    #                              tiers; requeued at the front, resumes
    #                              via restore + tail replay
    FINISHED = "finished"        # slot and pages released


class FinishReason(enum.Enum):
    EOS = "eos"
    MAX_NEW_TOKENS = "max_new_tokens"
    MAX_SEQ_LEN = "max_seq_len"


@dataclass
class Request:
    prompt: str
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # preemption policy input: when the pool or the slots oversubscribe,
    # the scheduler offloads the lowest-priority running sequence first
    # (ties broken against the most recently admitted)
    priority: int = 0
    # multi-tenant streams: which tenant's SLO this request counts
    # against (empty for single-tenant callers -- nothing downstream
    # requires it)
    tenant: str = ""
    request_id: int = field(default_factory=lambda: next(_ids))


@dataclass
class GenerationResult:
    request_id: int
    prompt: str
    text: str
    token_ids: list[int]
    prompt_tokens: int
    cached_tokens: int          # tokens restored from SkyMemory (prefix hit)
    prefill_tokens: int         # tokens actually prefilled
    wall_time_s: float = 0.0
    ttft_s: float = 0.0         # queue-entry -> first token latency
    finish_reason: str = FinishReason.MAX_NEW_TOKENS.value
    preemptions: int = 0        # times this sequence was swapped out
    tenant: str = ""            # copied from the request (SLO accounting)
    # this request's own inter-token gaps (streaming SLO attainment
    # judges each request's ITL tail, not the engine-wide distribution)
    itl_samples_s: list[float] = field(default_factory=list)


@dataclass
class Seq:
    """Scheduler-side state of one in-flight request (all host data)."""

    request: Request
    tokens: list[int]
    state: SeqState = SeqState.QUEUED
    cached: int = 0
    out_ids: list[int] = field(default_factory=list)
    done: bool = False
    finish_reason: str = FinishReason.MAX_NEW_TOKENS.value
    enqueue_t: float = 0.0
    ttft_s: float = 0.0
    wall_s: float = 0.0
    # chunked-prefill state machine:
    reserve: int = 0                  # worst-case token footprint (park pos)
    cursor: int = 0                   # next prompt token to prefill
    looked_up: bool = False           # SkyMemory lookup done for this seq
    pages_future: object | None = None   # in-flight payload -> pages decode
    # clocked fabric: virtual completion time of this seq's L2 Get -- the
    # fetched payload may not be consumed before the clock passes it
    fetch_ready_at: float | None = None
    dev_ops: tuple | None = None      # per-admission device operands
    admit_seq: int = 0                # admission order (preemption tiebreak)
    # preemption/restore state: while PREEMPTED, ``replay_tokens`` is the
    # exact token sequence whose K/V the pool held (prompt + emitted
    # tokens up to the offload point) and ``replay_next`` the already-
    # sampled token the next decode step feeds -- restore rebuilds pages
    # for replay_tokens (host tier: bit-exact import; constellation /
    # recompute: block prefix + chunked tail replay) and resumes without
    # sampling anything again
    replay_tokens: list[int] | None = None
    replay_next: int | None = None
    preempt_count: int = 0
    # streaming: the submit()-returned future this seq resolves on
    # finish (None on the closed-batch path until run() attaches one),
    # and this seq's own inter-token gaps for per-request ITL tails
    future: object | None = None
    itl: list[float] = field(default_factory=list)
    # dense runtime (non-paged families): the prefill's decode state and
    # the logits of the prompt's last position, until the batch's states
    # are stacked into one cache
    dense_state: dict | None = None
    last_logits: object | None = None

    @property
    def prefill_tokens(self) -> list[int]:
        """The token sequence the chunk planner must cover with pages:
        the prompt for a fresh admission, the offloaded-KV token span for
        a restore replay."""
        return self.tokens if self.replay_tokens is None else self.replay_tokens


def seq_finished(s: Seq, tid: int, *, eos_id: int, max_seq_len: int) -> bool:
    """Finish-reason bookkeeping shared by the paged and dense runtimes."""
    if tid == eos_id:
        s.done, s.finish_reason = True, FinishReason.EOS.value
    elif len(s.out_ids) >= s.request.sampling.max_new_tokens:
        s.done = True
        s.finish_reason = FinishReason.MAX_NEW_TOKENS.value
    elif len(s.tokens) + len(s.out_ids) >= max_seq_len:
        s.done = True
        s.finish_reason = FinishReason.MAX_SEQ_LEN.value
    return s.done


def seq_result(s: Seq, tokenizer) -> GenerationResult:
    return GenerationResult(
        request_id=s.request.request_id,
        prompt=s.request.prompt,
        text=tokenizer.decode(s.out_ids),
        token_ids=s.out_ids,
        prompt_tokens=len(s.tokens),
        cached_tokens=s.cached,
        prefill_tokens=len(s.tokens) - s.cached,
        wall_time_s=s.wall_s,
        ttft_s=s.ttft_s,
        finish_reason=s.finish_reason,
        preemptions=s.preempt_count,
        tenant=s.request.tenant,
        itl_samples_s=list(s.itl),
    )
