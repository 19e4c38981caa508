"""Structured logging, copied from dynamo_tpu/runtime/logging.py: one
JSON object per line when DYN_LOG_JSON is truthy, human-readable
otherwise; DYN_LOG_LEVEL sets the level.  `extra={...}` fields on a log
call land as top-level JSON keys, and every record emitted inside a
bound trace-id context (obs.bind_trace_id) carries it as `trace_id`."""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional

from .config import env_truthy

_STD_KEYS = frozenset(logging.LogRecord(
    "", 0, "", 0, "", (), None).__dict__) | {"message", "asctime",
                                             "taskName"}


class TraceIdFilter(logging.Filter):
    """Log<->trace correlation: stamp the context-bound trace_id
    (obs.bind_trace_id; workers bind it per generate() stream) onto every
    record, so a request's log lines are greppable by the same id that
    joins its timeline spans.  Explicit `extra={"trace_id": ...}` on a
    call wins over the ambient context."""

    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "trace_id"):
            from .. import obs

            tid = obs.current_trace_id()
            if tid is not None:
                record.trace_id = tid
        return True


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for k, v in record.__dict__.items():
            if k not in _STD_KEYS and not k.startswith("_"):
                try:
                    json.dumps(v)
                    out[k] = v
                except (TypeError, ValueError):
                    out[k] = repr(v)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup_logging(level: Optional[int] = None,
                  json_lines: Optional[bool] = None) -> None:
    """Configure the root logger once (idempotent)."""
    if json_lines is None:
        json_lines = env_truthy("DYN_LOG_JSON")
    if level is None:
        level = getattr(logging, os.environ.get("DYN_LOG_LEVEL", "INFO")
                        .upper(), logging.INFO)
    root = logging.getLogger()
    root.setLevel(level)

    def formatter() -> logging.Formatter:
        return JsonFormatter() if json_lines else logging.Formatter(
            "%(levelname)s:%(name)s:%(message)s")

    if root.handlers:
        # re-invocation: keep the handlers, swap formatters if the mode
        # changed
        for h in root.handlers:
            if json_lines != isinstance(h.formatter, JsonFormatter):
                h.setFormatter(formatter())
            if not any(isinstance(f, TraceIdFilter) for f in h.filters):
                h.addFilter(TraceIdFilter())
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(formatter())
    handler.addFilter(TraceIdFilter())
    root.addHandler(handler)
