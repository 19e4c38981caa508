"""Multimodal encoder disaggregation: the encode fleet.

The port of dynamo_tpu/multimodal/'s worker side: EncoderWorker serves
an `encode` endpoint on the request plane (media in, embeddings out,
LRU-cached by media hash; multimodal/worker.py) with the ViT tower or a
mock (multimodal/encoder.py).  The frontend's EncoderHop
(multimodal/hop.py) routes encode requests to it by media hash and
splices the placeholder tokens; the port's engine still refuses
requests that carry resolved embeddings (ROADMAP.md, Queue 3 item 9).
`python -m dynamo_tpu_torch.multimodal` runs one worker.
"""

from .encoder import (
    EmbeddingCache,
    MockVisionEncoder,
    VisionConfig,
    VitEncoder,
    media_hash,
)
from .hop import EncoderHop
from .worker import EncoderWorker

__all__ = [
    "EmbeddingCache",
    "EncoderHop",
    "EncoderWorker",
    "MockVisionEncoder",
    "VisionConfig",
    "VitEncoder",
    "media_hash",
]
