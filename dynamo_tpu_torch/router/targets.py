"""Routing targets: (worker instance, dp_rank) pairs as first-class ids.

A copy of dynamo_tpu/router/targets.py: target ids key every router
table, so they are equal bit for bit to the JAX router's.

Ref: lib/kv-router/src/scheduling/selector.rs:33 WorkerWithDpRank — an
engine running data-parallel ranks exposes EACH rank as a distinct
routing target with its own KV index, slot accounting, and cost, because
the ranks hold disjoint KV caches (routing to "the worker" would erase
exactly the locality the KV router exists to exploit).

Target ids stay plain ints so the indexer (including the C++ one), the
slot manager, and the selector are rank-agnostic: rank 0 IS the worker's
instance id (the common dp=1 case costs nothing), other ranks get a
deterministic 63-bit id derived from (worker, rank) — deterministic so
every router replica derives the same id without coordination."""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

__all__ = ["TargetMap", "target_id"]


def target_id(worker_id: int, dp_rank: int) -> int:
    if dp_rank == 0:
        return worker_id
    h = hashlib.blake2b(f"{worker_id}:{dp_rank}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") & 0x7FFFFFFFFFFFFFFF


class TargetMap:
    """Registry of observed targets (from KV events and load metrics)."""

    def __init__(self):
        self._by_tid: Dict[int, Tuple[int, int]] = {}
        self._by_worker: Dict[int, Dict[int, int]] = {}  # w -> {rank: tid}

    def observe(self, worker_id: int, dp_rank: int = 0) -> int:
        tid = target_id(worker_id, dp_rank)
        if tid not in self._by_tid:
            self._by_tid[tid] = (worker_id, dp_rank)
            self._by_worker.setdefault(worker_id, {})[dp_rank] = tid
        return tid

    def resolve(self, tid: int) -> Tuple[int, int]:
        """(worker_id, dp_rank); unknown tids are rank 0 of themselves."""
        return self._by_tid.get(tid, (tid, 0))

    def targets_of(self, worker_id: int) -> List[int]:
        """All known targets of a worker (at least rank 0)."""
        ranks = self._by_worker.get(worker_id)
        if not ranks:
            return [worker_id]
        return [ranks[r] for r in sorted(ranks)]

    def remove_worker(self, worker_id: int) -> List[int]:
        """Drop a dead worker's targets; returns them for index purges."""
        ranks = self._by_worker.pop(worker_id, None)
        if not ranks:
            return [worker_id]
        tids = [ranks[r] for r in sorted(ranks)]
        for t in tids:
            self._by_tid.pop(t, None)
        return tids
