"""Per-model request pipeline: routing + migration + detokenization.

A copy of dynamo_tpu/frontend/pipeline.py: a pipeline may hold the
model's encoder hop (multimodal/hop.py) and prefill orchestrator
(disagg/prefill_router.py), which the ModelWatcher attaches as the
fleets' cards appear.

Ref: lib/llm/src/entrypoint/input/common.rs:499-522 — the assembled chain
SegmentSource → OpenAIPreprocessor → Migration → Backend(detok) → router →
worker, with backward edges doing incremental detokenization.  Here the chain
is an async-generator composition per request.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, replace
from typing import AsyncIterator, Optional

from .. import obs
from ..protocols import LLMEngineOutput, ModelDeploymentCard, PreprocessedRequest
from ..runtime import CancellationToken, Client, EngineError
from ..runtime.aio import StreamIdleTimeout, iter_with_idle_timeout
from ..runtime.retry import MIGRATION_POLICY, Backoff
from .preprocessor import OpenAIPreprocessor

logger = logging.getLogger(__name__)

MIGRATABLE_MARKERS = ("connection lost", "no handler", "worker draining",
                      "not found", "worker engine error", "worker stalled")


def _route_attr(route, name: str):
    """Resolve an optional hook on the route or its wrapped inner
    router (SessionAffinityRouter wraps the KvRouter as `.inner`)."""
    fn = getattr(route, name, None)
    if fn is None:
        fn = getattr(getattr(route, "inner", None), name, None)
    return fn


def is_migratable(err: Exception) -> bool:
    """Worker-death errors are retryable on another instance; user
    cancellations and model errors are not (ref: migration.rs:60-75).
    'not found' covers the pick-vs-lease-expiry race (instance vanished
    between routing and dispatch).  A transport-level OSError (dial
    refused to a just-died worker, connection reset mid-stream) is an
    instance failure by construction — the e2e drain scenario hits it
    when a replay races the discovery watch."""
    if isinstance(err, OSError):
        return True
    msg = str(err).lower()
    return any(m in msg for m in MIGRATABLE_MARKERS)


class MigrationOperator:
    """Replays accumulated tokens to a new worker on migratable errors.

    Ref: lib/llm/src/migration.rs:70.  The retried request's prompt is the
    original prompt plus every token already generated, so the new worker
    continues exactly where the dead one stopped (KV rebuilt via prefill,
    ideally mostly from prefix cache).
    """

    def __init__(self, client: Client, migration_limit: int = 0,
                 route=None, retry_policy=None,
                 stream_idle_s: Optional[float] = None):
        self.client = client
        self.migration_limit = migration_limit
        # route(request, token) -> (instance_id | None); KV router plugs in here
        self.route = route
        # unified backoff between replay attempts (runtime/retry.py):
        # full jitter decorrelates a fleet of frontends replaying after
        # the same worker death
        self.retry_policy = retry_policy or MIGRATION_POLICY
        # wedged-worker detector: a stream that goes silent for this
        # long fails with a migratable "worker stalled" error and
        # replays elsewhere (the canary withdraws the lease, but only
        # this bound can rescue the request already in flight there).
        # 0/None disables; default from DYN_STREAM_IDLE_S.
        if stream_idle_s is None:
            stream_idle_s = float(os.environ.get("DYN_STREAM_IDLE_S", "0"))
        self.stream_idle_s = stream_idle_s or None

    async def generate(
        self, request: PreprocessedRequest,
        token: Optional[CancellationToken] = None,
        tracker=None,
    ) -> AsyncIterator[LLMEngineOutput]:
        attempts = 0
        emitted: list[int] = []
        avoid: set[int] = set()
        route = self.route
        backoff = Backoff(self.retry_policy)
        try:
            while True:
                req = request
                if emitted:
                    req = replace(
                        request,
                        token_ids=list(request.token_ids) + emitted,
                        stop=replace(request.stop,
                                     max_tokens=request.stop.max_tokens - len(emitted)),
                    )
                instance_id = None
                decision = None
                if route is not None:
                    live = self.client.instance_ids
                    if avoid and all(i in avoid for i in live):
                        # every live instance is on the avoid list — a
                        # fleet-wide blip would otherwise permanently
                        # exhaust routing candidates for this request;
                        # instances that stayed dead are gone from
                        # discovery anyway, so forgiving the set only
                        # re-admits workers that recovered
                        logger.warning(
                            "request %s: avoid set %s excludes every live "
                            "instance; relaxing", request.request_id,
                            sorted(avoid))
                        avoid.clear()
                    instance_id = await route(req, avoid=avoid)
                    # forensics: the decision's WHY (per-candidate cost
                    # scores, predicted overlap, best rejected, regret)
                    # rides the routed hop, and is held for this attempt
                    # so the worker's realized-reuse stamp can close the
                    # predicted-vs-realized loop on the router
                    pop = _route_attr(route, "pop_decision")
                    if pop is not None:
                        decision = pop(request.request_id)
                    if tracker is not None:
                        tracker.on_routed(instance_id, decision)
                try:
                    first = True
                    stamped = False
                    picked: list = []

                    def on_pick(iid, _picked=picked):
                        _picked.append(iid)
                        if tracker is not None:
                            tracker.on_dispatch(iid)

                    stream = self.client.generate(
                        req.to_dict(), instance_id=instance_id, token=token,
                        on_pick=on_pick, avoid=avoid,
                    )
                    if self.stream_idle_s:
                        stream = iter_with_idle_timeout(
                            stream, self.stream_idle_s)
                    async for item in stream:
                        out = LLMEngineOutput.from_dict(item)
                        stamp = (out.metrics or {}).get("forensic")
                        if stamp is not None:
                            if tracker is not None:
                                tracker.on_worker_stamp(
                                    stamp, attempt=attempts + 1)
                            if not stamped and decision is not None:
                                # realized prefix reuse vs THIS
                                # attempt's prediction: the indexer-
                                # staleness feedback signal
                                # (router/kv_router.py on_realized)
                                stamped = True
                                feed = _route_attr(route, "on_realized")
                                if feed is not None:
                                    feed(decision,
                                         stamp.get("cached_tokens"))
                        if out.finish_reason == "error":
                            # not a completion: surface as an error (HTTP
                            # 5xx / SSE error upstream).  Worker-side
                            # failures carry the "worker engine error"
                            # marker and migrate; request errors don't.
                            raise EngineError(
                                out.error or "worker engine error for "
                                f"request {request.request_id}"
                            )
                        if first and out.token_ids:
                            first = False
                            if hasattr(route, "mark_prefill_completed"):
                                route.mark_prefill_completed(request.request_id)
                        emitted.extend(out.token_ids)
                        yield out
                    return
                except (EngineError, RuntimeError, OSError,
                        StreamIdleTimeout) as e:
                    if (token is not None and token.is_stopped()):
                        raise
                    if attempts >= self.migration_limit or not is_migratable(e):
                        raise
                    attempts += 1
                    # flight recorder: the ring holds the timeline that
                    # led to this worker failure — dump before replaying
                    obs.flight_dump("migration")
                    if instance_id is not None:
                        avoid.add(instance_id)
                    elif picked:
                        # the client's own router chose: avoid what it
                        # picked, so a replay doesn't land back on the
                        # instance that just failed
                        avoid.add(picked[-1])
                    logger.warning(
                        "migrating request %s (attempt %d/%d) after: %s",
                        request.request_id, attempts, self.migration_limit, e,
                    )
                    if not await backoff.sleep(token=token):
                        raise
        finally:
            if hasattr(route, "complete"):
                route.complete(request.request_id)


@dataclass
class ChatDelta:
    text: str = ""
    finish_reason: Optional[str] = None
    token_count: int = 0
    # the stop string that ended the stream, when finish_reason=="stop"
    # came from a stop-sequence match rather than EOS (Anthropic's
    # stop_reason/stop_sequence distinction needs this)
    stop_trigger: Optional[str] = None


class ModelPipeline:
    """Everything the HTTP layer needs to serve one model."""

    def __init__(self, mdc: ModelDeploymentCard, client: Client,
                 route=None, prefill=None, encoder=None):
        self.mdc = mdc
        self.preprocessor = OpenAIPreprocessor(mdc)
        self.client = client
        self.migration = MigrationOperator(
            client, migration_limit=mdc.migration_limit, route=route
        )
        # disaggregation: PrefillOrchestrator when a prefill fleet exists
        self.prefill = prefill
        # multimodal: EncoderHop when an encoder fleet exists
        self.encoder = encoder
        # /v1/embeddings: lazily-created client on the fleet's `embed`
        # endpoint (HttpService.h_embeddings); the lock serializes the
        # first-call creation so racers don't leak clients
        self.embed_client = None
        self.embed_lock = asyncio.Lock()

    async def generate_deltas(
        self, request: PreprocessedRequest,
        token: Optional[CancellationToken] = None,
        tracker=None,
    ) -> AsyncIterator[ChatDelta]:
        """Engine stream → detokenized text deltas with stop-string handling."""
        unencoded = any("data_uri" in m for m in request.multimodal or [])
        if unencoded:
            # (already-resolved items pass through: the HTTP layer encodes
            # before usage accounting; this hop covers direct callers)
            if self.encoder is None:
                raise EngineError(
                    "request has unencoded multimodal items but no encoder "
                    "fleet is attached for this model")
            # encode BEFORE the prefill hop: placeholder tokens must be in
            # token_ids when conditional disagg measures prompt length
            request = await self.encoder.encode_and_attach(request,
                                                           token=token)
        if self.prefill is not None:
            t_hop = time.monotonic()
            request = await self.prefill.maybe_prefill(request, token=token)
            if request.disaggregated_params:
                # the prefill worker's forensic stamp rode the transfer
                # params (prefill_router.py); popped HERE so it lands on
                # the prefill_done hop instead of riding the wire to the
                # decode worker, which has its own stamp
                prefill_stamp = request.disaggregated_params.pop(
                    "prefill_forensic", None)
            if tracker is not None and request.disaggregated_params:
                # a remote prefill actually ran: IT was the first
                # worker dispatch, so queue time ends where the hop
                # began (backdated — stamping after would absorb the
                # whole prefill as phantom admission wait).  A request
                # conditional disagg kept local stamps via on_dispatch,
                # keeping the decode routing wait in queue_ms.  The
                # forensics hops bracket the hop itself: open backdated
                # to the dispatch, done now — the partition's `prefill`
                # phase is exactly this interval, and first_token after
                # the decode dispatch reads as `transfer`.
                tracker.hop("prefill_open", at=t_hop,
                            **({"worker": request.disaggregated_params
                                .get("instance_id")}
                               if request.disaggregated_params
                               .get("instance_id") else {}))
                tracker.hop("prefill_done", **(prefill_stamp or {}))
                tracker.mark_dispatching(at=t_hop)
                if request.disaggregated_params.get("instance_id"):
                    tracker.on_prefill_worker(
                        request.disaggregated_params["instance_id"])
        detok = self.preprocessor.tokenizer.make_detokenizer()
        stops = request.stop.stop or []
        pending = ""  # holdback buffer for partial stop-string matches
        # request-scoped trace id for the per-delta spans: in a
        # multi-process fleet the frontend ring never sees worker
        # spans, so the forensics breach pin (obs/forensics.py) joins
        # on the frontend's OWN detok/frame_egress spans — they must
        # carry the trace_id to be pinnable
        tid_obs = getattr(tracker, "trace_id", None) if obs.enabled() \
            else None
        async for out in self.migration.generate(request, token=token,
                                                 tracker=tracker):
            t_obs = obs.begin()
            delta = detok.push(out.token_ids)
            obs.end("detok", t_obs, tokens=len(out.token_ids),
                    trace_id=tid_obs)
            finish = out.finish_reason
            if stops:
                pending += delta
                cut, matched = self._find_stop(pending, stops)
                if cut is not None:
                    yield ChatDelta(text=pending[:cut], finish_reason="stop",
                                    token_count=len(out.token_ids),
                                    stop_trigger=matched)
                    return
                if finish is not None:
                    # stream over: flush the held-back text, it wasn't a stop
                    emit, pending = pending, ""
                else:
                    hold = self._max_partial_suffix(pending, stops)
                    emit = pending[: len(pending) - hold]
                    pending = pending[len(pending) - hold:]
                yield ChatDelta(text=emit, finish_reason=finish,
                                token_count=len(out.token_ids))
            else:
                yield ChatDelta(text=delta, finish_reason=finish,
                                token_count=len(out.token_ids))
            if finish is not None:
                return

    @staticmethod
    def _find_stop(text: str, stops: list[str]):
        """Earliest stop-string match: (cut_index, matched_stop) or
        (None, None)."""
        best, which = None, None
        for s in stops:
            i = text.find(s)
            if i >= 0 and (best is None or i < best):
                best, which = i, s
        return best, which

    @staticmethod
    def _max_partial_suffix(text: str, stops: list[str]) -> int:
        """Longest suffix of text that is a proper prefix of any stop string."""
        best = 0
        for s in stops:
            for k in range(min(len(s) - 1, len(text)), 0, -1):
                if text.endswith(s[:k]):
                    best = max(best, k)
                    break
        return best
