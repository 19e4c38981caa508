"""Frontend-side disaggregation: prefill orchestration + conditional bypass.

A copy of dynamo_tpu/disagg/prefill_router.py on the port's runtime: the
port's ModelWatcher attaches it to a model's pipeline when a worker card
with `role: prefill` appears (frontend/service.py).

Ref: lib/llm/src/kv_router/prefill_router/mod.rs:137 (PrefillRouter) and
lib/kv-router/src/conditional_disagg.rs:11-18.  The orchestrator sits between
the preprocessor and the decode router: it sends the request to a prefill
worker (annotated `disagg_prefill`), receives `kv_transfer_params`, and
attaches them to the decode request.  The conditional-disagg policy bypasses
the remote hop when the *effective* prefill (tokens not already cached on
the decode fleet) is too small to be worth a transfer.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import Optional

from ..protocols import LLMEngineOutput, PreprocessedRequest
from ..protocols.llm import DISAGG_ANNOTATION
from ..runtime import Client

logger = logging.getLogger(__name__)


@dataclass
class ConditionalDisaggConfig:
    """Thresholds from the reference (conditional_disagg.rs): remote prefill
    only if effective ISL >= min_effective_isl AND effective/total >= ratio."""

    min_effective_isl: int = 2048
    min_effective_ratio: float = 0.7
    always_remote: bool = False  # force remote (benchmarks/tests)


class PrefillOrchestrator:
    def __init__(self, prefill_client: Client,
                 config: Optional[ConditionalDisaggConfig] = None,
                 prefill_route=None,
                 decode_overlap_fn=None):
        """prefill_route: optional KvRouter over the prefill fleet.
        decode_overlap_fn(request) -> cached blocks on the likely decode
        target (for effective-ISL computation)."""
        self.client = prefill_client
        self.config = config or ConditionalDisaggConfig()
        self.prefill_route = prefill_route
        self.decode_overlap_fn = decode_overlap_fn

    def should_disagg(self, request: PreprocessedRequest,
                      overlap_tokens: int) -> bool:
        if self.config.always_remote:
            return True
        isl = len(request.token_ids)
        effective = max(0, isl - overlap_tokens)
        if effective < self.config.min_effective_isl:
            return False
        if isl > 0 and effective / isl < self.config.min_effective_ratio:
            return False
        return True

    async def maybe_prefill(
        self, request: PreprocessedRequest, token=None
    ) -> PreprocessedRequest:
        """Run the remote-prefill hop; returns the request to hand to the
        decode router (with disaggregated_params on success)."""
        overlap_tokens = 0
        if self.decode_overlap_fn is not None:
            overlap_tokens = await self.decode_overlap_fn(request)
        if not self.should_disagg(request, overlap_tokens):
            return request

        prefill_req = replace(
            request,
            annotations=list(request.annotations) + [DISAGG_ANNOTATION],
        )
        instance_id = None
        if self.prefill_route is not None:
            instance_id = await self.prefill_route(prefill_req, avoid=None)
        try:
            params = None
            forensic = None
            async for item in self.client.generate(
                prefill_req.to_dict(), instance_id=instance_id, token=token
            ):
                out = LLMEngineOutput.from_dict(item)
                if out.kv_transfer_params is not None:
                    params = out.kv_transfer_params
                if out.metrics and "forensic" in out.metrics:
                    # the prefill worker's stamp (realized prefix reuse,
                    # queue position — obs/forensics.py): ride it on the
                    # transfer params so the frontend's prefill_done hop
                    # carries the hop's own facts (the decode worker's
                    # stream only ever stamps the decode side)
                    forensic = out.metrics["forensic"]
            if params is not None and forensic is not None:
                params = {**params, "prefill_forensic": forensic}
            if params is None:
                logger.warning(
                    "prefill worker returned no kv_transfer_params for %s; "
                    "falling back to local prefill", request.request_id)
                return request
            return replace(request, disaggregated_params=params)
        except Exception:
            # remote prefill is an optimization; decode-local prefill is the
            # always-correct fallback (ref: admission bypass)
            logger.warning("remote prefill failed for %s; local fallback",
                           request.request_id, exc_info=True)
            return request
        finally:
            if self.prefill_route is not None and hasattr(
                self.prefill_route, "complete"
            ):
                self.prefill_route.complete(prefill_req.request_id)

    async def close(self) -> None:
        if self.prefill_route is not None and hasattr(self.prefill_route, "close"):
            await self.prefill_route.close()
        await self.client.close()
