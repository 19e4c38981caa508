"""In-process engine broker: tier-1 device-resident KV pulls.

A copy of dynamo_tpu/disagg/broker.py.  When the prefill and decode
engines live in ONE process (two workers sharing a card), the transfer
needs no transport: the receiver injects the sender's gathered chunk,
which never leaves the device, into its own cache.

The broker is a process-global registry: workers register their engine
under their instance_id at startup; a decode worker's pull first checks
the registry and only falls back to the request plane on a miss.  The
registry is the port's own, so a JAX engine in the same process is never
found in it (nor a torch engine in the JAX package's): a cross-framework
pair takes the request-plane tier.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

_ENGINES: Dict[int, Any] = {}


def register_engine(instance_id: int, engine) -> None:
    _ENGINES[int(instance_id)] = engine


def deregister_engine(instance_id: int) -> None:
    _ENGINES.pop(int(instance_id), None)


def lookup_engine(instance_id: int):
    return _ENGINES.get(int(instance_id))


class LocalEnginePullSource:
    """Tier 1: chunks stay on the device end to end.

    chunk() returns the sender's gathered tensors; the receiving engine
    injects them in its own scheduler op.  Each gather is one scheduler
    op on the SENDER, so its decode keeps stepping during the
    extraction."""

    # chunks are device tensors: the receiver may use device-sized chunks
    # (no host frame bound) and pipeline gathers against injects
    device_resident = True

    def __init__(self, src_engine, request_id: str):
        self.src = src_engine
        self.request_id = request_id

    async def open(self) -> Dict[str, Any]:
        from .transfer import make_header

        n_blocks, prompt_len = await self.src.parked_info(self.request_id)
        lo = self.src.kv_wire_layout(n_blocks)
        return make_header(prompt_len, lo)

    async def chunk(self, b0: int, n: int) -> Tuple[Any, ...]:
        # (kb, vb) — plus (ksb, vsb) scale planes when the sender's cache
        # is int8 (the payload moves quantized, never dequantized)
        return await self.src.extract_parked_chunk(
            self.request_id, b0, n, to_host=False)

    async def close(self) -> None:
        try:
            await self.src.release_parked(self.request_id)
        except Exception:
            pass
