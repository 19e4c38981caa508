"""Small asyncio helpers, copied from dynamo_tpu/runtime/aio.py (the
frontend's idle-timeout iterator is left out: the port has no frontend)."""

from __future__ import annotations

import asyncio
import logging
import signal as _signal
from typing import Any, AsyncIterator, Callable, Optional

logger = logging.getLogger(__name__)

CANCELLED = object()


def install_drain_handler(
    drain: Callable[[], "asyncio.Future | Any"],
    signals: tuple = (_signal.SIGTERM, _signal.SIGINT),
) -> None:
    """SIGTERM/SIGINT → graceful drain.

    The FIRST signal starts `drain` (an async callable, run once on the
    current loop).  Any signal after that restores the default
    disposition and re-delivers itself, terminating the process: a drain
    stuck on a dead discovery backend must still be killable by a second
    TERM/^C (engine/worker.py drain(): withdraw the lease, finish
    in-flight requests, abort the rest with the migratable marker)."""
    loop = asyncio.get_running_loop()
    state: dict = {"task": None}

    def _on_signal(sig: int) -> None:
        if state["task"] is not None:
            logger.warning("signal %s during/after drain: exiting",
                           _signal.Signals(sig).name)
            loop.remove_signal_handler(sig)
            _signal.raise_signal(sig)
            return
        logger.warning("signal %s: draining", _signal.Signals(sig).name)
        state["task"] = loop.create_task(drain())
        # a drain that dies must be loud: this dict holds its only
        # reference, so its exception would otherwise never be retrieved
        state["task"].add_done_callback(
            lambda t: (not t.cancelled() and t.exception() is not None
                       and logger.error("drain failed",
                                        exc_info=t.exception())))

    for sig in signals:
        loop.add_signal_handler(sig, _on_signal, sig)


def spawn_retained(aw, owner: set) -> "asyncio.Future":
    """Fire-and-forget, done right: schedule `aw` and park the task in
    `owner` until it finishes (the event loop holds only a weak reference
    to tasks, so a bare ensure_future could be garbage-collected
    mid-flight)."""
    t = asyncio.ensure_future(aw)
    owner.add(t)
    t.add_done_callback(owner.discard)
    return t


async def next_or_cancel(q: asyncio.Queue, cancel: Optional[asyncio.Event]) -> Any:
    """Await the next queue item, or return the CANCELLED sentinel if the
    cancel event fires first.  Pending futures are always cleaned up."""
    if cancel is None:
        return await q.get()
    if cancel.is_set():
        return CANCELLED
    get = asyncio.ensure_future(q.get())
    cw = asyncio.ensure_future(cancel.wait())
    try:
        done, _ = await asyncio.wait({get, cw},
                                     return_when=asyncio.FIRST_COMPLETED)
    finally:
        for f in (get, cw):
            if not f.done():
                f.cancel()
    if get in done:
        return get.result()
    return CANCELLED


async def iter_queue(
    q: asyncio.Queue, cancel: Optional[asyncio.Event]
) -> AsyncIterator[Any]:
    """Yield queue items until the cancel event fires."""
    while cancel is None or not cancel.is_set():
        item = await next_or_cancel(q, cancel)
        if item is CANCELLED:
            return
        yield item
