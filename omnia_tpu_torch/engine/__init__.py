from omnia_tpu_torch.engine.engine import InferenceEngine
from omnia_tpu_torch.engine.types import (
    EngineConfig,
    FinishReason,
    RequestHandle,
    SamplingParams,
    StreamEvent,
)

__all__ = [
    "EngineConfig",
    "FinishReason",
    "InferenceEngine",
    "RequestHandle",
    "SamplingParams",
    "StreamEvent",
]
