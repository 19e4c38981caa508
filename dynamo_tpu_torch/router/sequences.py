"""Active-sequence slot tracking across workers.

A copy of dynamo_tpu/router/sequences.py.

Ref: lib/kv-router/src/sequences/ (ActiveSequencesMultiWorker) and
router-design.md:166-180.  The router tracks which requests it has in flight
on which worker and how many KV blocks each potentially holds, giving the
selector its decode-load signal without waiting for worker metrics to catch
up.  `mark_prefill_completed` moves a request from prefill-weighted to
decode-weighted accounting; replica synchronization (multi-router) publishes
these transitions on the event plane (router/replica_sync in the reference).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional


PREFILL_WEIGHT = 2.0  # pending prefill work loads a worker harder than
                      # holding KV for decode (it monopolizes step time)


@dataclass
class _ActiveReq:
    worker_id: int
    blocks: int           # potential blocks (prompt + expected output)
    overlap_blocks: int
    prefill_done: bool = False
    added_t: float = field(default_factory=time.monotonic)

    @property
    def prefill_charge(self) -> int:
        return max(0, self.blocks - self.overlap_blocks)


class ActiveSequences:
    def __init__(self, stale_after_s: float = 600.0):
        self._reqs: Dict[str, _ActiveReq] = {}
        self._decode_blocks: Dict[int, float] = {}   # KV held, whole lifetime
        self._prefill_blocks: Dict[int, float] = {}  # pending prefill compute
        self.stale_after_s = stale_after_s

    def add_request(self, request_id: str, worker_id: int, blocks: int,
                    overlap_blocks: int) -> None:
        self.free(request_id)
        req = _ActiveReq(worker_id, blocks, overlap_blocks)
        self._reqs[request_id] = req
        self._decode_blocks[worker_id] = (
            self._decode_blocks.get(worker_id, 0.0) + blocks
        )
        self._prefill_blocks[worker_id] = (
            self._prefill_blocks.get(worker_id, 0.0) + req.prefill_charge
        )

    def mark_prefill_completed(self, request_id: str) -> None:
        """First token arrived: the prefill burden is off the worker."""
        req = self._reqs.get(request_id)
        if req is not None and not req.prefill_done:
            req.prefill_done = True
            w = req.worker_id
            self._prefill_blocks[w] = max(
                0.0, self._prefill_blocks.get(w, 0.0) - req.prefill_charge
            )

    def free(self, request_id: str) -> Optional[int]:
        req = self._reqs.pop(request_id, None)
        if req is None:
            return None
        w = req.worker_id
        self._decode_blocks[w] = max(
            0.0, self._decode_blocks.get(w, 0.0) - req.blocks
        )
        if not req.prefill_done:
            self._prefill_blocks[w] = max(
                0.0, self._prefill_blocks.get(w, 0.0) - req.prefill_charge
            )
        return w

    def remove_worker(self, worker_id: int) -> None:
        self._decode_blocks.pop(worker_id, None)
        self._prefill_blocks.pop(worker_id, None)
        for rid in [r for r, q in self._reqs.items()
                    if q.worker_id == worker_id]:
            del self._reqs[rid]

    def active_blocks(self, worker_id: int) -> float:
        """Load estimate for the selector: held KV + weighted pending
        prefill (ref: selector.rs prefill/decode cost split)."""
        return (
            self._decode_blocks.get(worker_id, 0.0)
            + PREFILL_WEIGHT * self._prefill_blocks.get(worker_id, 0.0)
        )

    def overlap_of(self, request_id: str) -> int:
        """Cached-block overlap recorded at pick time (0 if unknown)."""
        req = self._reqs.get(request_id)
        return req.overlap_blocks if req is not None else 0

    def active_requests(self, worker_id: Optional[int] = None) -> int:
        if worker_id is None:
            return len(self._reqs)
        return sum(1 for r in self._reqs.values() if r.worker_id == worker_id)

    def reap_stale(self) -> int:
        """Drop bookkeeping for requests that never freed (crashed clients)."""
        now = time.monotonic()
        stale = [rid for rid, r in self._reqs.items()
                 if now - r.added_t > self.stale_after_s]
        for rid in stale:
            self.free(rid)
        return len(stale)
