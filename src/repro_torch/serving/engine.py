"""Engine: the orchestration facade over the three serving layers, ported
from ``repro/serving/engine.py``.

* ``repro_torch.serving.scheduler``  -- admission, chunk budgeting and
  the preemption-by-offload policy (host-side state machine);
* ``repro_torch.serving.executor``   -- the device programs and sampling;
* ``repro_torch.serving.kv_manager`` -- the ``TieredKVManager``: L0
  device page pool -> L1 host-RAM page cache -> L2 KVC manager.

Per request: tokenize -> SkyMemory longest-prefix lookup (with ``kvc``
or a ``manager``) -> fetched 128-token blocks drop straight into KV pages ->
the uncached suffix prefills in page-aligned chunks that ride the decode
step -> continuous-batching decode, with preemption-by-offload absorbing
pool pressure.  A model without paged decode (the SSM and hybrid
families, and a GQA model with a sliding window) is served by the
executor's ``DenseRuntime`` instead: per-request prefill (resuming from
a SkyMemory snapshot on a hit) and batched decode over a dense cache.

``payload_codec`` (``"f32"``, ``"int8"``, ``"int4"``, optionally
``+delta``) chooses the bytes of every block payload the engine writes;
any payload decodes.  Besides the closed batch (``generate``) the engine
streams: ``submit`` returns a ``Future`` that ``pump`` (inline) or the
worker loop (``start`` / ``stop``, ``serving/worker.py``) resolves.  The
MoE family always admits stop-the-world (``chunk_tokens`` is forced to 0).
The encoder-decoder family is refused, as the reference's engine cannot
serve it either: its prefill needs ``frames`` and its dense caches have
no place for the cross K/V (ROADMAP.md section 3).
"""
from __future__ import annotations

from concurrent.futures import Future

from repro_torch.core.chunking import PayloadCodec
from repro_torch.core.protocol import ConstellationKVC, KVCManager
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.executor import DenseRuntime, PagedExecutor
from repro_torch.serving.kv_manager import TieredKVManager
from repro_torch.serving.request import GenerationResult, Request
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.serving.worker import StreamWorker


class Engine:
    """Continuous-batching engine over ``model`` on ``device``: paged for
    the GQA families (dense, MoE, VLM), the dense runtime for the SSM
    and hybrid families and for a GQA model with a sliding window.

    With ``kvc`` (a ``ConstellationKVC``, or a view of one) the engine
    builds its own ``KVCManager`` over the constellation and this
    engine's ``adapter.kvc_fn``.  A ``manager`` built elsewhere (a
    sibling over a shared radix index, or any object with
    ``KVCManager``'s interface over an equivalent ``kvc_fn``) takes
    precedence over ``kvc``.  ``device`` defaults to ``"cuda"`` and must
    be the model's device."""

    def __init__(
        self,
        model: Model,
        *,
        kvc: ConstellationKVC | None = None,
        manager: KVCManager | None = None,
        block_size: int = 128,
        max_seq_len: int = 512,
        max_batch: int = 8,
        write_back: bool = True,
        seed: int = 0,
        num_pages: int | None = None,
        chunk_tokens: int | None = None,
        host_cache_pages: int | None = None,
        payload_codec: "PayloadCodec | str | None" = None,
        device="cuda",
    ) -> None:
        if model.cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{model.cfg.name}: no engine serves the encoder-decoder "
                "family; drive Model.forward(frames=) and "
                "Model.decode_step (ROADMAP.md section 3)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = ByteTokenizer(self.cfg.vocab_size)
        self.max_seq_len = max_seq_len
        self.max_batch = max_batch
        self.block_size = block_size
        # the codec's scale-table chunk (and delta block) is the engine's
        # block size, so per-chunk scales align with constellation blocks
        self.adapter = SkyKVCAdapter(
            model, codec=PayloadCodec.parse(payload_codec, block_size))
        if manager is not None:
            if manager.block_size != block_size:
                raise ValueError(
                    f"manager block_size {manager.block_size} != engine "
                    f"block_size {block_size}")
            self.manager = manager
        elif kvc is not None:
            self.manager = KVCManager(
                self.tokenizer.encode, self.adapter.kvc_fn, kvc,
                block_size=block_size)
        else:
            self.manager = None
        self.paged = model.supports_paged_decode
        if self.paged:
            self.page_size = block_size
            # page size == SkyMemory block size: fetched blocks are pages
            self.cache = model.init_paged_cache(
                num_slots=max_batch, page_size=block_size,
                max_seq_len=max_seq_len, num_pages=num_pages)
            # chunk budget: prompt tokens prefilled per step, fused with
            # decode; page-aligned; 0 is stop-the-world admission.  MoE
            # families always take the stop-the-world path: capacity
            # routing depends on the group's composition, so chunk splits
            # would change real tokens' routing (the same reason their
            # prefill is never padded)
            if chunk_tokens is None:
                chunk_tokens = 2 * block_size
            if chunk_tokens and self.cfg.num_experts > 0:
                chunk_tokens = 0
            if chunk_tokens:
                chunk_tokens = min(chunk_tokens,
                                   self.cache.pages_per_seq * block_size)
                if chunk_tokens % block_size:
                    raise ValueError("chunk_tokens must be a multiple of "
                                     "the page/block size")
            self.chunk_tokens = chunk_tokens
            self.chunked = bool(chunk_tokens)
            self.kv = TieredKVManager(
                self.cache, self.adapter, self.manager,
                host_cache_pages=host_cache_pages, write_back=write_back)
            self.executor = PagedExecutor(
                model, self.cache, chunk_tokens=chunk_tokens,
                max_seq_len=max_seq_len, seed=seed)
            self.scheduler = Scheduler(
                self.executor, self.kv, self.tokenizer,
                max_batch=max_batch, max_seq_len=max_seq_len,
                chunk_tokens=chunk_tokens)
            self._dense = None
        else:
            self.cache = self.kv = self.executor = self.scheduler = None
            self._dense = DenseRuntime(
                model, self.tokenizer, self.adapter, self.manager,
                max_seq_len=max_seq_len, max_batch=max_batch,
                write_back=write_back, seed=seed)
        self.stats = EngineStats()
        # streaming front door (worker thread started on demand)
        self.worker = StreamWorker(self)

    def generate(self, requests: list[Request]) -> list[GenerationResult]:
        if not requests:
            return []
        if self.running:
            raise RuntimeError(
                "engine worker loop is running; submit() requests instead "
                "of calling generate(), or stop() the worker first")
        if self.paged:
            return self.scheduler.run(requests)
        return self._dense.generate(requests)

    # streaming, delegated to the StreamWorker (serving/worker.py)
    @property
    def running(self) -> bool:
        return self.worker.running

    @property
    def backlog(self) -> bool:
        return self.worker.backlog

    def submit(self, request: Request) -> Future:
        return self.worker.submit(request)

    def pump(self) -> bool:
        return self.worker.pump()

    def start(self) -> None:
        self.worker.start()

    def stop(self, *, drain: bool = True) -> None:
        self.worker.stop(drain=drain)

    # one stats / chunk-log / write-back view across the layers
    @property
    def stats(self) -> EngineStats:
        return self._stats

    @stats.setter
    def stats(self, value: EngineStats) -> None:
        self._stats = value
        if self.paged:
            self.scheduler.stats = value
            self.kv.stats = value
        else:
            self._dense.stats = value

    @property
    def chunk_log(self) -> list[tuple[int, int, int]]:
        return self.scheduler.chunk_log

    @chunk_log.setter
    def chunk_log(self, value) -> None:
        self.scheduler.chunk_log = value

    @property
    def write_back(self) -> bool:
        return self.kv.write_back if self.paged else self._dense.write_back

    @write_back.setter
    def write_back(self, value: bool) -> None:
        if self.paged:
            self.kv.write_back = value
        else:
            self._dense.write_back = value

    def _chunk_buf(self, v: int) -> int:
        return self.executor.chunk_buf(v)
