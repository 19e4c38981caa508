"""EncoderHop: the frontend's encode step for multimodal requests.

A copy of dynamo_tpu/multimodal/hop.py: the port's ModelWatcher attaches
it to a model's pipeline when a worker card with `role: encoder` appears
(frontend/service.py).

Ref: encoder_router.rs — encode requests route by MEDIA HASH so repeated
media (multi-turn vision chats, shared images) land on the encoder whose
embedding cache already holds them.  Here that is rendezvous hashing over
the live instance set: stable under fleet changes, no coordination.

The hop runs between preprocessing and generation (frontend/pipeline.py):
descriptors in `request.multimodal` are encoded (one call per unique
media item), `n_tokens` placeholder tokens per item are spliced into
`token_ids` at the recorded insert positions, and the items are replaced
with their embedding payloads for the engine.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import replace
from typing import Dict, List, Optional

from ..protocols import PreprocessedRequest

logger = logging.getLogger(__name__)


def rendezvous_pick(instance_ids: List[int], key: str) -> Optional[int]:
    """Highest-random-weight choice: each (instance, key) pair scores
    independently, so fleet changes only remap the keys that scored
    highest on the departed instance."""
    best, best_score = None, b""
    for iid in instance_ids:
        score = hashlib.blake2b(
            f"{iid}:{key}".encode(), digest_size=8).digest()
        if best is None or score > best_score:
            best, best_score = iid, score
    return best


class EncoderHop:
    def __init__(self, client, image_token_id: int = 0):
        self.client = client  # `encode` endpoint client
        self.image_token_id = image_token_id

    async def encode_and_attach(
        self, request: PreprocessedRequest, token=None
    ) -> PreprocessedRequest:
        items = request.multimodal or []
        todo = [m for m in items if "data_uri" in m]
        if not todo:
            return request
        # one encode call per unique media item, routed for cache affinity
        # by the FIRST item's hash (a request's media usually shares a
        # session; per-item routing would fan one request across the fleet)
        uniq: Dict[str, dict] = {}
        for m in todo:
            uniq.setdefault(m["media_hash"], m)
        instance_id = rendezvous_pick(
            self.client.instance_ids, next(iter(uniq)))
        results: Dict[str, dict] = {}
        async for frame in self.client.generate(
            {"request_id": request.request_id,
             "items": [{"media_hash": h, "data_uri": m["data_uri"]}
                       for h, m in uniq.items()]},
            instance_id=instance_id, token=token,
        ):
            results[frame["media_hash"]] = frame
        missing = set(uniq) - set(results)
        if missing:
            raise RuntimeError(
                f"encoder returned no embedding for media {sorted(missing)}")

        # splice placeholders front-to-back with a running offset:
        # adjacent images sharing an insert_pos keep their user order
        # (a back-to-front splice would reverse them)
        token_ids = list(request.token_ids)
        resolved: List[dict] = []
        offset = 0
        for m in sorted(items, key=lambda m: m.get("insert_pos", 0)):
            r = results[m["media_hash"]]
            pos = min(m.get("insert_pos", len(token_ids)) + offset,
                      len(token_ids))
            token_ids[pos:pos] = [self.image_token_id] * r["n_tokens"]
            offset += r["n_tokens"]
            resolved.append({
                "media_hash": r["media_hash"],
                "n_tokens": r["n_tokens"],
                "shape": r["shape"],
                "dtype": r["dtype"],
                "embedding": r["embedding"],
            })
        return replace(request, token_ids=token_ids, multimodal=resolved)
