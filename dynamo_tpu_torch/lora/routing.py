"""LoRA-aware worker selection: rendezvous (HRW) replica sets.

A copy of dynamo_tpu/lora/routing.py (the KV router builds it).

Ref: lib/llm/src/lora/routing/{hrw.rs,table.rs} + filter.rs.  Each
adapter is served by a small replica set of workers so its bank slots and
prefix caches stay warm there, instead of every worker paying load+HBM
for every adapter.  Highest-random-weight hashing makes the set a pure
function of (adapter, live workers): every frontend computes the same
placement with no coordinator, and worker churn moves only the adapters
whose top-k ranking actually changed (the HRW minimal-disruption
property).  The reference's min-cost-flow allocator (mcf_allocator.rs)
is a load-balancing refinement over the same contract; HRW is its
default and is what this redesign keeps.

Workers lazily load an adapter from the shared source dir on first
request (engine/core.py), so placement needs no load/unload RPCs —
falling out of a replica set just means the slot goes cold and is
eventually evicted LRU.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence


def _weight(lora_name: str, worker_id: int) -> int:
    h = hashlib.blake2b(f"{lora_name}|{worker_id}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def rendezvous_ranking(lora_name: str,
                       workers: Sequence[int]) -> List[int]:
    """Workers ordered by preference for hosting `lora_name`."""
    return sorted(workers, key=lambda w: _weight(lora_name, w),
                  reverse=True)


class LoraReplicaSelector:
    """Restrict routing candidates to an adapter's replica set."""

    def __init__(self, replica_factor: int = 2):
        self.replica_factor = max(1, replica_factor)

    def replica_set(self, lora_name: str,
                    workers: Sequence[int]) -> List[int]:
        return rendezvous_ranking(lora_name,
                                  workers)[: self.replica_factor]

    def filter(self, lora_name: Optional[str],
               workers: Sequence[int],
               avoid: Optional[set] = None) -> List[int]:
        """Candidate workers for a request.  Falls back to the full fleet
        when the replica set is entirely avoided/dead — serving beats
        placement purity (ref filter.rs fallback)."""
        workers = list(workers)
        if not lora_name or len(workers) <= self.replica_factor:
            return workers
        replicas = self.replica_set(lora_name, workers)
        if avoid:
            usable = [w for w in replicas if w not in avoid]
            if not usable:
                return workers
            return usable
        return replicas
