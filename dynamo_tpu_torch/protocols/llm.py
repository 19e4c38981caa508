"""Engine-facing request/response protocol.

A copy of the request and output types, the drain markers, the disagg
annotation and the canary payload of dynamo_tpu/protocols/llm.py
(the port imports nothing of the JAX package).  `PreprocessedRequest` is
what the frontend's preprocessor emits and every engine consumes;
`LLMEngineOutput` is the per-step stream item flowing back.  Both
round-trip via to_dict/from_dict with wire-safe values only, exactly as
the originals do, so either engine can sit behind the same frontend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

FinishReason = str  # "stop" | "length" | "eos" | "cancelled" | "error"

# a request carrying this annotation is a disaggregated prefill hop: the
# engine prefills, parks the KV for the decode worker's pull and answers
# with one frame carrying kv_transfer_params (engine/core.py)
DISAGG_ANNOTATION = "disagg_prefill"

# graceful-drain error markers (engine/worker.py drain()): the frontend
# classifies a stream error as migratable by the "worker draining"
# prefix, so the text is byte-identical to the JAX package's
DRAIN_REJECT = "worker draining: request rejected before admission"
DRAIN_ABORT = "worker draining: in-flight request migrating"

# minimal liveness probe riding the real generate path (the canary of
# runtime/health_check.py): 2-token prompt, 1 greedy token out
CANARY_GENERATE_PAYLOAD: Dict[str, Any] = {
    "token_ids": [1, 2],
    "stop": {"max_tokens": 1, "ignore_eos": True},
    "annotations": ["canary"],
}


@dataclass
class SamplingOptions:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: Optional[int] = None
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # guided decoding: constrain output to a JSON document conforming to
    # this schema; None = unconstrained
    guided_json: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "temperature": self.temperature,
            "top_p": self.top_p,
            "top_k": self.top_k,
            "seed": self.seed,
            "frequency_penalty": self.frequency_penalty,
            "presence_penalty": self.presence_penalty,
            "guided_json": self.guided_json,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SamplingOptions":
        return SamplingOptions(
            temperature=d.get("temperature", 1.0),
            top_p=d.get("top_p", 1.0),
            top_k=d.get("top_k", 0),
            seed=d.get("seed"),
            frequency_penalty=d.get("frequency_penalty", 0.0),
            guided_json=d.get("guided_json"),
            presence_penalty=d.get("presence_penalty", 0.0),
        )


@dataclass
class StopConditions:
    max_tokens: int = 16
    stop: List[str] = field(default_factory=list)
    stop_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "max_tokens": self.max_tokens,
            "stop": self.stop,
            "stop_token_ids": self.stop_token_ids,
            "ignore_eos": self.ignore_eos,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "StopConditions":
        return StopConditions(
            max_tokens=d.get("max_tokens", 16),
            stop=d.get("stop", []),
            stop_token_ids=d.get("stop_token_ids", []),
            ignore_eos=d.get("ignore_eos", False),
        )


@dataclass
class PreprocessedRequest:
    """Tokenized request, ready for an engine."""

    token_ids: List[int]
    model: str = ""
    request_id: str = ""
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    lora_name: Optional[str] = None
    session_id: Optional[str] = None
    session_final: bool = False
    disaggregated_params: Optional[Dict[str, Any]] = None
    annotations: List[str] = field(default_factory=list)
    dp_rank: int = 0
    multimodal: Optional[List[Dict[str, Any]]] = None

    @property
    def media_hashes(self) -> List[str]:
        return [m["media_hash"] for m in self.multimodal or []
                if m.get("media_hash")]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "token_ids": list(self.token_ids),
            "model": self.model,
            "request_id": self.request_id,
            "sampling": self.sampling.to_dict(),
            "stop": self.stop.to_dict(),
            "lora_name": self.lora_name,
            "session_id": self.session_id,
            "session_final": self.session_final,
            "disaggregated_params": self.disaggregated_params,
            "annotations": self.annotations,
            "dp_rank": self.dp_rank,
            "multimodal": self.multimodal,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PreprocessedRequest":
        return PreprocessedRequest(
            token_ids=list(d.get("token_ids", [])),
            model=d.get("model", ""),
            request_id=d.get("request_id", ""),
            sampling=SamplingOptions.from_dict(d.get("sampling", {})),
            stop=StopConditions.from_dict(d.get("stop", {})),
            lora_name=d.get("lora_name"),
            session_id=d.get("session_id"),
            session_final=bool(d.get("session_final", False)),
            disaggregated_params=d.get("disaggregated_params"),
            annotations=d.get("annotations", []),
            dp_rank=int(d.get("dp_rank", 0)),
            multimodal=d.get("multimodal"),
        )


@dataclass
class LLMEngineOutput:
    """One stream item from an engine: a batch of new tokens (usually 1)."""

    token_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    cum_log_prob: Optional[float] = None
    kv_transfer_params: Optional[Dict[str, Any]] = None
    metrics: Optional[Dict[str, Any]] = None
    # set when finish_reason == "error": what failed
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"token_ids": list(self.token_ids)}
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason
        if self.cum_log_prob is not None:
            d["cum_log_prob"] = self.cum_log_prob
        if self.kv_transfer_params is not None:
            d["kv_transfer_params"] = self.kv_transfer_params
        if self.metrics is not None:
            d["metrics"] = self.metrics
        if self.error is not None:
            d["error"] = self.error
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LLMEngineOutput":
        return LLMEngineOutput(
            token_ids=list(d.get("token_ids", [])),
            finish_reason=d.get("finish_reason"),
            cum_log_prob=d.get("cum_log_prob"),
            kv_transfer_params=d.get("kv_transfer_params"),
            metrics=d.get("metrics"),
            error=d.get("error"),
        )
