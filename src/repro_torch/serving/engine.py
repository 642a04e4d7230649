"""Engine: the orchestration facade over the three serving layers, ported
from ``repro/serving/engine.py`` (the paged families).

* ``repro_torch.serving.scheduler``  -- admission, chunk budgeting and
  the preemption-by-offload policy (host-side state machine);
* ``repro_torch.serving.executor``   -- the device programs and sampling;
* ``repro_torch.serving.kv_manager`` -- the ``TieredKVManager``: L0
  device page pool -> L1 host-RAM page cache -> L2 KVC manager.

Per request: tokenize -> SkyMemory longest-prefix lookup (with a
``manager``) -> fetched 128-token blocks drop straight into KV pages ->
the uncached suffix prefills in page-aligned chunks that ride the decode
step -> continuous-batching decode, with preemption-by-offload absorbing
pool pressure.

Not in this slice (see ROADMAP.md queue 1): ``kvc=`` (building the
manager needs the port's own copy of the constellation fabric),
``payload_codec=`` (payloads are f32 ``SKYM`` until a second codec is
ported), the streaming worker (``submit`` / ``start`` / ``stop``), and
the non-paged families.
"""
from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.executor import PagedExecutor
from repro_torch.serving.kv_manager import TieredKVManager
from repro_torch.serving.request import GenerationResult, Request
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.tokenizer import ByteTokenizer


class Engine:
    """Paged continuous-batching engine over ``model`` on ``device``.

    ``manager`` is any object with ``KVCManager``'s interface
    (``get_cache_tokens``, ``add_blocks_tokens``,
    ``add_precomputed_blocks``, ``block_size``, ``policy``, ``cache``),
    built over this engine's ``adapter.kvc_fn`` or an equivalent one.
    ``device`` defaults to ``"cuda"`` and must be the model's device."""

    def __init__(
        self,
        model: Model,
        *,
        manager=None,
        block_size: int = 128,
        max_seq_len: int = 512,
        max_batch: int = 8,
        write_back: bool = True,
        seed: int = 0,
        num_pages: int | None = None,
        chunk_tokens: int | None = None,
        host_cache_pages: int | None = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        if not model.supports_paged_decode:
            raise NotImplementedError(
                f"{model.cfg.name}: only the paged families are ported")
        if manager is not None and manager.block_size != block_size:
            raise ValueError(
                f"manager block_size {manager.block_size} != engine "
                f"block_size {block_size}")
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = ByteTokenizer(self.cfg.vocab_size)
        self.max_seq_len = max_seq_len
        self.max_batch = max_batch
        self.block_size = block_size
        self.adapter = SkyKVCAdapter(model)
        self.manager = manager
        # page size == SkyMemory block size: fetched blocks are pages
        self.cache = model.init_paged_cache(
            num_slots=max_batch, page_size=block_size,
            max_seq_len=max_seq_len, num_pages=num_pages)
        # chunk budget: prompt tokens prefilled per step, fused with
        # decode; page-aligned; 0 is stop-the-world admission
        if chunk_tokens is None:
            chunk_tokens = 2 * block_size
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
        self.stats = EngineStats()

    def generate(self, requests: list[Request]) -> list[GenerationResult]:
        if not requests:
            return []
        return self.scheduler.run(requests)

    # one stats / chunk-log / write-back view across the layers
    @property
    def stats(self) -> EngineStats:
        return self._stats

    @stats.setter
    def stats(self, value: EngineStats) -> None:
        self._stats = value
        self.scheduler.stats = value
        self.kv.stats = value

    @property
    def chunk_log(self) -> list[tuple[int, int, int]]:
        return self.scheduler.chunk_log

    @property
    def write_back(self) -> bool:
        return self.kv.write_back

    @write_back.setter
    def write_back(self, value: bool) -> None:
        self.kv.write_back = value
