"""The paged SkyMemory serving engine (scheduler, executor, tiered KV)."""
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import (
    FinishReason,
    GenerationResult,
    Request,
    SeqState,
)
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.stats import EngineStats

__all__ = ["Engine", "EngineStats", "FinishReason", "GenerationResult",
           "Request", "SamplingParams", "SeqState"]
