"""Load generation + trace replay, a copy of dynamo_tpu/loadgen/ (host
only; it drives whatever serves the worker `generate` contract).

trace.py  — mooncake-style JSONL trace rows (schema-compatible with the
            reference's MooncakeRow, lib/data-gen/src/mooncake.rs:37-64),
            synthetic generators, token materialization with hash_ids
            prefix sharing.
replay.py — open-loop replayer driving any async token-stream client at
            trace timestamps; per-request TTFT/ITL capture; percentile +
            goodput report (the metrics of docs/benchmarks/*.mdx).

`python -m dynamo_tpu_torch.loadgen` replays a trace (or synthesizes one)
against a live cluster over the request plane and prints the report.
"""

from .replay import Report, replay
from .trace import (TraceRow, load_trace, materialize_tokens, save_trace,
                    synthesize, synthesize_diurnal)

__all__ = [
    "Report",
    "TraceRow",
    "load_trace",
    "materialize_tokens",
    "replay",
    "save_trace",
    "synthesize",
    "synthesize_diurnal",
]
