"""Multimodal encoder disaggregation: the encode fleet.

The port of dynamo_tpu/multimodal/'s worker side: EncoderWorker serves
an `encode` endpoint on the request plane (media in, embeddings out,
LRU-cached by media hash; multimodal/worker.py) with the ViT tower or a
mock (multimodal/encoder.py).  The JAX frontend's EncoderHop routes
encode requests to it by media hash and splices the placeholder tokens;
the port has no frontend, so the hop stays in the JAX package, and the
port's engine still refuses multimodal requests (ROADMAP.md).
`python -m dynamo_tpu_torch.multimodal` runs one worker.
"""

from .encoder import (
    EmbeddingCache,
    MockVisionEncoder,
    VisionConfig,
    VitEncoder,
    media_hash,
)
from .worker import EncoderWorker

__all__ = [
    "EmbeddingCache",
    "EncoderWorker",
    "MockVisionEncoder",
    "VisionConfig",
    "VitEncoder",
    "media_hash",
]
