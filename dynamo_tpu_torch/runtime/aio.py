"""Small asyncio helpers, copied from dynamo_tpu/runtime/aio.py."""

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


class StreamIdleTimeout(Exception):
    """No item arrived within the idle window (wedged producer)."""


async def iter_with_idle_timeout(
    ait: AsyncIterator[Any], idle_s: float
) -> AsyncIterator[Any]:
    """Re-yield `ait`, raising StreamIdleTimeout if the gap between
    items (or before the first item) exceeds `idle_s`.  This is the
    frontend's wedged-worker detector: a stream from an alive-but-stuck
    worker produces no error on its own — lease withdrawal stops NEW
    routing, but only an idle bound can fail the in-flight stream so
    migration replays it elsewhere."""
    it = ait.__aiter__()
    try:
        while True:
            nxt = asyncio.ensure_future(it.__anext__())
            try:
                item = await asyncio.wait_for(asyncio.shield(nxt), idle_s)
            except asyncio.TimeoutError:
                if nxt.done() and not nxt.cancelled():
                    # not an idle gap: the future resolved in the same
                    # cycle the deadline fired (wait_for reports timeout
                    # even when the shielded future already holds an
                    # outcome) — use the stream's REAL outcome, whether
                    # that is a frame that must not be dropped, a clean
                    # end, or the stream's own error (surfaced as-is,
                    # not misreported as a stall that never elapsed)
                    exc = nxt.exception()
                    if exc is None:
                                        item = nxt.result()
                    elif isinstance(exc, StopAsyncIteration):
                        return
                    else:
                        raise exc
                else:
                    nxt.cancel()
                    try:
                        await nxt
                    except (asyncio.CancelledError, StopAsyncIteration,
                            Exception):
                        pass
                    raise StreamIdleTimeout(
                        f"worker stalled: no stream frame for "
                        f"{idle_s:.1f}s") from None
            except StopAsyncIteration:
                return
            except asyncio.CancelledError:
                nxt.cancel()
                raise
            yield item
    finally:
        # propagate closure to the inner stream promptly: a consumer that
        # abandons this wrapper (migration raising past the async-for)
        # must release the underlying client stream NOW — its finally is
        # what tells the worker to stop generating for a dead consumer —
        # not whenever the GC finalizes an orphaned async generator
        aclose = getattr(it, "aclose", None)
        if aclose is not None:
            try:
                await aclose()
            except Exception:
                pass


async def iter_queue(
    q: asyncio.Queue, cancel: Optional[asyncio.Event]
) -> AsyncIterator[Any]:
    """Yield queue items until the cancel event fires."""
    while cancel is None or not cancel.is_set():
        item = await next_or_cancel(q, cancel)
        if item is CANCELLED:
            return
        yield item
