"""The SkyMemory serving stack: the paged engine (scheduler, executor,
tiered KV), the dense runtime, the streaming worker, and scale-out
serving (``EngineCluster`` with its router, SLO accounting, admission
control and seeded traffic)."""
from repro_torch.serving.cluster import (
    EngineCluster,
    StreamRecord,
    StreamReport,
    spread_anchors,
)
from repro_torch.serving.engine import Engine
from repro_torch.serving.executor import DenseRuntime, PagedExecutor
from repro_torch.serving.kv_manager import HostPageCache, TieredKVManager
from repro_torch.serving.request import (
    FinishReason,
    GenerationResult,
    Request,
    SeqState,
)
from repro_torch.serving.router import (
    PrefixAffinityRouter,
    RandomRouter,
    ReplicaHandle,
    RouteDecision,
    Router,
    make_router,
)
from repro_torch.serving.sampler import (
    SamplingParams,
    sample_batch,
    stack_sampling,
)
from repro_torch.serving.scheduler import Scheduler, chunk_spans, head_span
from repro_torch.serving.skycache import SkyKVCAdapter
from repro_torch.serving.slo import (
    SLO,
    AdmissionController,
    FaultPhases,
    SLOTracker,
    itl_tail,
)
from repro_torch.serving.stats import EngineStats, SampleReservoir
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.serving.traffic import (
    Arrival,
    TenantSpec,
    TrafficGenerator,
    standard_tenants,
)
from repro_torch.serving.worker import StreamWorker

__all__ = [
    "AdmissionController",
    "Arrival",
    "ByteTokenizer",
    "DenseRuntime",
    "Engine",
    "EngineCluster",
    "EngineStats",
    "FaultPhases",
    "FinishReason",
    "GenerationResult",
    "HostPageCache",
    "PagedExecutor",
    "PrefixAffinityRouter",
    "RandomRouter",
    "ReplicaHandle",
    "Request",
    "RouteDecision",
    "Router",
    "SLO",
    "SLOTracker",
    "SampleReservoir",
    "SamplingParams",
    "Scheduler",
    "SeqState",
    "SkyKVCAdapter",
    "StreamRecord",
    "StreamReport",
    "StreamWorker",
    "TenantSpec",
    "TieredKVManager",
    "TrafficGenerator",
    "chunk_spans",
    "head_span",
    "itl_tail",
    "make_router",
    "sample_batch",
    "spread_anchors",
    "stack_sampling",
    "standard_tenants",
]
