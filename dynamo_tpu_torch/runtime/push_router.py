"""Instance selection for the request plane egress, a copy of
dynamo_tpu/runtime/push_router.py cut to its round-robin mode: the only
client in the port sends to one worker, and KV-aware routing is the
frontend's (its KV router resolves an instance id first).
"""

from __future__ import annotations

from typing import Sequence

from .discovery import Instance


class PushRouter:
    """Round robin over the instances, in instance-id order."""

    def __init__(self) -> None:
        self._rr = 0

    def pick(self, instances: Sequence[Instance]) -> Instance:
        if not instances:
            raise RuntimeError("no instances available")
        inst = sorted(instances, key=lambda i: i.instance_id)[
            self._rr % len(instances)
        ]
        self._rr += 1
        return inst
