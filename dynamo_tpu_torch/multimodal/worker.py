"""EncoderWorker: the encode side of encoder/decoder disaggregation.

A copy of dynamo_tpu/multimodal/worker.py on the port's runtime: a
dedicated worker owning the vision tower, serving encode requests from
the frontend, caching embeddings by media hash, and publishing load
metrics like every other fleet member (so the planner can scale encoder
fleets independently of prefill/decode).

Endpoint contract (`encode`, request plane):
    request:  {"request_id": str,
               "items": [{"media_hash": str, "data_uri": str}, ...]}
    stream:   one frame per item:
              {"media_hash", "n_tokens", "shape", "dtype",
               "embedding": bytes, "cached": bool}

The MDC registers with runtime_config.role = "encoder", which the JAX
frontend's ModelWatcher turns into an EncoderHop on the model pipeline
(the hop routes each request to an instance by media hash).  A frame
carries the tower's own dtype and bytes, as JAX's does: a bf16 tower's
are "bfloat16" and its raw bits (see `embedding_bytes`).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional, Tuple

import torch

from ..protocols.model_card import (
    ModelDeploymentCard,
    deregister_model,
    register_model,
)
from .encoder import (
    EmbeddingCache,
    MockVisionEncoder,
    decode_data_uri,
    pixels_from_payload,
)

logger = logging.getLogger(__name__)

LOAD_SUBJECT_PREFIX = "load_metrics"


def embedding_bytes(emb) -> Tuple[str, bytes]:
    """(dtype name, raw bytes) of an embedding, numpy (the mock's) or a
    CPU tensor (VitEncoder's), as JAX's worker sends `str(emb.dtype)` and
    `emb.tobytes()`: a bfloat16 tensor goes as its 16-bit patterns."""
    if isinstance(emb, torch.Tensor):
        if emb.dtype == torch.bfloat16:
            return "bfloat16", emb.view(torch.int16).numpy().tobytes()
        emb = emb.numpy()
    return str(emb.dtype), emb.tobytes()


class EncoderWorker:
    def __init__(self, runtime, model_name: str, encoder=None,
                 namespace: str = "dynamo", component: str = "encoder",
                 cache_capacity: int = 32, image_token_id: int = 0):
        self.runtime = runtime
        self.model_name = model_name
        self.encoder = encoder or MockVisionEncoder()
        self.namespace = namespace
        self.component = component
        self.image_token_id = image_token_id
        self.cache = EmbeddingCache(cache_capacity)
        self.served = None
        self.card: Optional[ModelDeploymentCard] = None
        self._load_task: Optional[asyncio.Task] = None
        self.metrics = {"requests": 0, "items": 0, "cache_hits": 0,
                        "prompt_tokens": 0}
        self._active = 0

    async def start(self) -> "EncoderWorker":
        rt = self.runtime

        async def encode_handler(payload, ctx):
            self.metrics["requests"] += 1
            self._active += 1
            try:
                for item in payload.get("items", []):
                    yield await self._encode_item(item)
            finally:
                self._active -= 1

        comp = rt.namespace(self.namespace).component(self.component)
        self.served = await comp.endpoint("encode").serve_endpoint(
            encode_handler)
        self.card = ModelDeploymentCard(
            name=self.model_name,
            namespace=self.namespace,
            component=self.component,
            endpoint="encode",
            runtime_config={"role": "encoder",
                            "image_token_id": self.image_token_id},
        )
        await register_model(rt, self.card, self.served.instance_id)
        self._load_task = asyncio.create_task(self._load_loop())
        logger.info("encoder worker %d serving model %s (%s)",
                    self.served.instance_id, self.model_name,
                    type(self.encoder).__name__)
        return self

    async def _encode_item(self, item: dict) -> dict:
        key = item["media_hash"]
        emb = self.cache.get(key)
        cached = emb is not None
        if cached:
            self.metrics["cache_hits"] += 1
        else:
            data, mime = decode_data_uri(item["data_uri"])
            if isinstance(self.encoder, MockVisionEncoder):
                emb = self.encoder.encode_bytes(data)
            else:
                # the tower is blocking device compute: run it off the
                # event loop so other streams and the load heartbeat
                # stay live
                def run_tower():
                    pixels = pixels_from_payload(
                        data, mime, self.encoder.cfg.image_size)
                    return self.encoder.encode(pixels[None])[0]

                emb = await asyncio.to_thread(run_tower)
            self.cache.put(key, emb)
        self.metrics["items"] += 1
        self.metrics["prompt_tokens"] += int(emb.shape[0])
        dtype, data = embedding_bytes(emb)
        return {
            "media_hash": key,
            "n_tokens": int(emb.shape[0]),
            "shape": list(emb.shape),
            "dtype": dtype,
            "embedding": data,
            "cached": cached,
        }

    # uniform worker surface for the planner's LoadObserver
    @property
    def engine(self):
        return self

    @property
    def num_active_seqs(self) -> int:
        return self._active

    def kv_usage(self) -> float:
        return 0.0

    itl_ema_s = 0.0

    async def _load_loop(self) -> None:
        subject = f"{LOAD_SUBJECT_PREFIX}.{self.namespace}.{self.component}"
        while True:
            await asyncio.sleep(0.5)
            if self.served is None:
                continue
            await self.runtime.event_plane.publish(subject, {
                "worker_id": self.served.instance_id,
                "active_seqs": self._active,
                "kv_usage": 0.0,
                "requests_total": self.metrics["requests"],
                # for an encoder fleet, "prompt tokens" = embedding tokens
                # produced (the unit of encode work the planner rates)
                "prompt_tokens_total": self.metrics["prompt_tokens"],
                "itl_ema_s": 0.0,
            })

    async def close(self) -> None:
        if self._load_task is not None:
            self._load_task.cancel()
            await asyncio.gather(self._load_task, return_exceptions=True)
            self._load_task = None
        if self.served is not None and self.card is not None:
            await deregister_model(self.runtime, self.card,
                                   self.served.instance_id)
            await self.served.shutdown()
            self.served = None
