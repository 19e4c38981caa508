"""Deadline-bounded G4 I/O, a copy of dynamo_tpu/kvbm/object_io.py: the
scheduler never touches the shared FS.

Every ObjectStorePool operation the serving path needs (get / put /
contains / count) is submitted to ONE daemon worker thread and awaited
with a deadline:

- the scheduler waits at most `deadline_s` per op: a hung NFS mount is a
  bounded timeout, never a wedged scheduler.  The op itself keeps running
  on the worker thread; if it completes after the caller gave up, its
  result is discarded (a put's blob still lands, unadvertised: a later
  spill re-advertises it or the TTL sweep reaps it, both safe because G4
  is content-addressed);
- a wedged worker thread starves the queue, so every later op times out
  at ITS deadline without running: the consecutive-failure signal the
  tier breaker (breaker.py) trips on;
- BlockIntegrityError surfaces as status "corrupt" (the pool already
  quarantined the blob), every other error as "error".

Statuses: get -> hit|miss|timeout|corrupt|error; put -> stored|exists|
timeout|error; contains -> hit|miss|timeout|error; count -> ok|timeout|
error.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Optional, Tuple

from .pools import Block, BlockIntegrityError

logger = logging.getLogger(__name__)


class _Op:
    __slots__ = ("kind", "h", "arrays", "done", "status", "result",
                 "error")

    def __init__(self, kind: str, h: int = 0, arrays: tuple = ()):
        self.kind = kind
        self.h = h
        self.arrays = arrays
        self.done = threading.Event()
        self.status = "timeout"  # until the worker says otherwise
        self.result: Any = None
        self.error: Optional[str] = None


class ObjectIO:
    """Single worker thread serializing all G4 ops with per-op await
    deadlines.  One thread is deliberate: the shared mount is the
    bottleneck, and serialized ops make 'the thread is stuck' and 'the
    tier is down' the same observable."""

    def __init__(self, pool, deadline_s: float = 0.25,
                 max_pending: int = 512):
        self.pool = pool
        self.deadline_s = float(deadline_s)
        self._q: "queue.Queue[Optional[_Op]]" = queue.Queue(
            maxsize=max_pending)
        # last successful keys() count — occupancy fallback while the
        # tier is slow/dark (updated by the worker even when the caller
        # already timed out)
        self.last_count = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="kvbm-g4-io")
        self._thread.start()

    # -- worker ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            op = self._q.get()
            if op is None:
                return
            try:
                if op.kind == "get":
                    op.result = self.pool.get(op.h)
                    op.status = "hit" if op.result is not None else "miss"
                elif op.kind == "put":
                    op.status = ("stored"
                                 if self.pool.put(op.h, *op.arrays)
                                 else "exists")
                elif op.kind == "contains":
                    op.status = "hit" if op.h in self.pool else "miss"
                elif op.kind == "count":
                    op.result = sum(1 for _ in self.pool.keys())
                    self.last_count = op.result
                    op.status = "ok"
            except BlockIntegrityError as e:
                op.status = "corrupt"
                op.error = str(e)
            except Exception as e:  # OSError, ...
                op.status = "error"
                op.error = f"{type(e).__name__}: {e}"
            finally:
                op.done.set()

    # -- bounded calls ---------------------------------------------------

    def _call(self, op: _Op,
              deadline_s: Optional[float]) -> Tuple[str, Any]:
        """Submit + await; a full queue counts as a timeout (the tier is
        already backed up — queueing more just defers the same answer)."""
        try:
            self._q.put_nowait(op)
        except queue.Full:
            return "timeout", None
        if not op.done.wait(deadline_s if deadline_s is not None
                            else self.deadline_s):
            return "timeout", None
        return op.status, op.result

    def get(self, h: int,
            deadline_s: Optional[float] = None) -> Tuple[str,
                                                         Optional[Block]]:
        return self._call(_Op("get", h=h), deadline_s)

    def put(self, h: int, arrays: Block,
            deadline_s: Optional[float] = None) -> str:
        st, _ = self._call(_Op("put", h=h, arrays=tuple(arrays)),
                           deadline_s)
        return st

    def contains(self, h: int,
                 deadline_s: Optional[float] = None) -> str:
        st, _ = self._call(_Op("contains", h=h), deadline_s)
        return st

    def count(self, deadline_s: Optional[float] = None) -> int:
        """Blob count, degraded: on timeout/error returns the last
        successfully-observed count instead of blocking occupancy."""
        st, n = self._call(_Op("count"), deadline_s)
        return int(n) if st == "ok" else int(self.last_count)

    def close(self) -> None:
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass  # daemon thread; dies with the process
        self._thread.join(timeout=1.0)
