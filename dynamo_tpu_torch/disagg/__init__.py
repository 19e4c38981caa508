"""Disaggregated prefill/decode: the KV transfer protocol (transfer.py)
and the in-process broker (broker.py), copies of dynamo_tpu/disagg/.
The frontend's PrefillOrchestrator stays the JAX package's."""

from .transfer import (
    DEFAULT_CHUNK_BYTES,
    KvLayout,
    PullSource,
    RequestPlanePullSource,
    decode_chunk_frame,
    encode_chunk_frame,
    make_header,
    make_transfer_params,
)

__all__ = [
    "DEFAULT_CHUNK_BYTES",
    "KvLayout",
    "PullSource",
    "RequestPlanePullSource",
    "decode_chunk_frame",
    "encode_chunk_frame",
    "make_header",
    "make_transfer_params",
]
