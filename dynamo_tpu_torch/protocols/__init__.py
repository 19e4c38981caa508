from .llm import (
    CANARY_GENERATE_PAYLOAD,
    DISAGG_ANNOTATION,
    DRAIN_ABORT,
    DRAIN_REJECT,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from .model_card import ModelDeploymentCard, deregister_model, register_model

__all__ = [
    "CANARY_GENERATE_PAYLOAD",
    "DISAGG_ANNOTATION",
    "DRAIN_ABORT",
    "DRAIN_REJECT",
    "FinishReason",
    "LLMEngineOutput",
    "ModelDeploymentCard",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
    "deregister_model",
    "register_model",
]
