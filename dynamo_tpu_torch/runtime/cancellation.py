"""Hierarchical cancellation, a copy of dynamo_tpu/runtime/cancellation.py.

`stop()` is graceful — in-flight generation should finish the current step and
stop issuing new ones.  `kill()` is immediate — abandon the stream.  Children
inherit cancellation from their parent but can be cancelled independently.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional


class CancellationToken:
    def __init__(self, parent: Optional["CancellationToken"] = None):
        self._stop = asyncio.Event()
        self._kill = asyncio.Event()
        self._children: List[CancellationToken] = []
        self._parent = parent
        if parent is not None:
            parent._children.append(self)
            if parent.is_stopped():
                self._stop.set()
            if parent.is_killed():
                self._kill.set()

    def child(self) -> "CancellationToken":
        return CancellationToken(parent=self)

    @property
    def stopped_event(self) -> asyncio.Event:
        """The underlying stop event (for queue-vs-cancel races, aio.py)."""
        return self._stop

    def stop(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            for c in self._children:
                c.stop()

    def kill(self) -> None:
        self.stop()
        if not self._kill.is_set():
            self._kill.set()
            for c in self._children:
                c.kill()

    # cancel == stop, for familiarity
    cancel = stop

    def is_stopped(self) -> bool:
        return self._stop.is_set()

    def is_killed(self) -> bool:
        return self._kill.is_set()

    is_cancelled = is_stopped

    async def wait_stopped(self) -> None:
        await self._stop.wait()

    async def wait_killed(self) -> None:
        await self._kill.wait()

    def detach(self) -> None:
        """Unlink from parent (e.g. when a request completes normally)."""
        if self._parent is not None:
            try:
                self._parent._children.remove(self)
            except ValueError:
                pass
            self._parent = None
