"""Instance selection policies for the request plane egress, a copy of
dynamo_tpu/runtime/push_router.py.

KV-aware routing is a separate layer (dynamo_tpu_torch.router) that
resolves an instance id first and then routes DIRECT.
"""

from __future__ import annotations

import enum
import random
from collections import defaultdict
from typing import Dict, List, Sequence

from .discovery import Instance


class RouterMode(str, enum.Enum):
    RANDOM = "random"
    ROUND_ROBIN = "round_robin"
    DIRECT = "direct"
    LEAST_LOADED = "least_loaded"
    P2C = "p2c"  # power of two choices on in-flight load
    KV = "kv"  # resolved upstream by the KV router


class PushRouter:
    def __init__(self, mode: RouterMode = RouterMode.ROUND_ROBIN):
        self.mode = mode
        self._rr = 0
        self.inflight: Dict[int, int] = defaultdict(int)

    def pick(self, instances: Sequence[Instance]) -> Instance:
        if not instances:
            raise RuntimeError("no instances available")
        mode = self.mode
        if mode in (RouterMode.RANDOM, RouterMode.KV, RouterMode.DIRECT):
            # KV/DIRECT with no explicit instance fall back to random
            return random.choice(list(instances))
        if mode == RouterMode.ROUND_ROBIN:
            inst = sorted(instances, key=lambda i: i.instance_id)[
                self._rr % len(instances)
            ]
            self._rr += 1
            return inst
        if mode == RouterMode.LEAST_LOADED:
            return min(instances, key=lambda i: self.inflight[i.instance_id])
        if mode == RouterMode.P2C:
            pool: List[Instance] = list(instances)
            a, b = random.sample(pool, 2) if len(pool) >= 2 else (pool[0], pool[0])
            return min((a, b), key=lambda i: self.inflight[i.instance_id])
        raise ValueError(f"unknown router mode {mode}")

    def on_dispatch(self, instance_id: int) -> None:
        self.inflight[instance_id] += 1

    def on_complete(self, instance_id: int) -> None:
        n = self.inflight.get(instance_id, 0)
        if n <= 1:
            self.inflight.pop(instance_id, None)
        else:
            self.inflight[instance_id] = n - 1
