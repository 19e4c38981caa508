"""Disaggregated prefill/decode: the KV transfer protocol (transfer.py),
the in-process broker (broker.py) and the frontend's
PrefillOrchestrator (prefill_router.py), copies of dynamo_tpu/disagg/."""

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
