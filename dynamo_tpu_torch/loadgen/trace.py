"""Mooncake-style replay traces, a copy of dynamo_tpu/loadgen/trace.py:
the same seed gives the same rows and the same token ids.

One JSONL row per request arrival.  Field names (and the upstream aliases
accepted on load) follow the reference's trace schema
(lib/data-gen/src/mooncake.rs:37-64) so traces produced for the reference's
replay tooling load here unchanged:

    {"request_id": "r1", "timestamp": 120.0, "input_length": 4096,
     "output_length": 128, "hash_ids": [7, 8, 9]}

* `timestamp` — absolute arrival offset in MILLISECONDS (alias
  `created_time`); rows without one are assigned the previous row's.
* `input_length`/`output_length` — token counts (aliases `input_tokens`/
  `output_tokens`).
* `hash_ids` — optional prefix-block identities: rows sharing a prefix of
  equal hash_ids share a token-level prefix of whole blocks, which is what
  exercises KV reuse end to end (each hash id expands to one
  deterministically-generated block of tokens).
* `session_id`/`delay` — closed-loop turns: a row with a session_id and no
  timestamp arrives `delay` ms after the previous turn of that session
  COMPLETES.
"""

from __future__ import annotations

import json
import random
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

_ALIASES = {
    "input_tokens": "input_length",
    "output_tokens": "output_length",
    "created_time": "timestamp",
    "delay_ms": "delay",
}


@dataclass
class TraceRow:
    request_id: str = ""
    session_id: Optional[str] = None
    input_length: int = 0
    output_length: int = 16
    hash_ids: Optional[List[int]] = None
    timestamp: Optional[float] = None   # ms, absolute arrival
    delay: Optional[float] = None       # ms after previous session turn
    priority: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRow":
        # canonical key wins over its aliases when a row carries both
        # (otherwise JSON key order would decide, nondeterministically)
        norm: dict = {}
        for k, v in d.items():
            canon = _ALIASES.get(k, k)
            if canon not in norm or canon == k:
                norm[canon] = v
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in norm.items() if k in known})

    def to_dict(self) -> dict:
        out = {"request_id": self.request_id,
               "input_length": self.input_length,
               "output_length": self.output_length}
        for k in ("session_id", "hash_ids", "timestamp", "delay",
                  "priority"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


def load_trace(path: str) -> List[TraceRow]:
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rows.append(TraceRow.from_dict(json.loads(line)))
            if not rows[-1].request_id:
                rows[-1].request_id = f"row-{ln}"
    # fill missing timestamps forward (reference semantics: rows without
    # one arrive with the previous row)
    t = 0.0
    for r in rows:
        if r.timestamp is None and r.session_id is None:
            r.timestamp = t
        elif r.timestamp is not None:
            t = r.timestamp
    return rows


def save_trace(path: str, rows: Sequence[TraceRow]) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r.to_dict()) + "\n")


def materialize_tokens(row: TraceRow, block_size: int,
                       vocab_size: int = 32000) -> List[int]:
    """Expand a row into concrete prompt token ids.

    Each hash id expands to one deterministic block of tokens (same id →
    same tokens, so equal hash_ids prefixes become equal PLH chains and
    the router/engine see real prefix overlap).  Tokens beyond
    len(hash_ids)*block_size are drawn from a per-request stream, unique
    to the row."""
    toks: List[int] = []
    for h in row.hash_ids or []:
        rng = random.Random(0xA5A5 ^ int(h))
        toks.extend(rng.randrange(3, vocab_size) for _ in range(block_size))
    if len(toks) > row.input_length:
        toks = toks[: row.input_length]
    # stable digest (builtin hash() is salted per process and would make
    # the same trace materialize different tokens across runs)
    rng = random.Random(zlib.crc32(row.request_id.encode()))
    while len(toks) < row.input_length:
        toks.append(rng.randrange(3, vocab_size))
    return toks


def _sample_row_shape(rng: random.Random, input_len: int, output_len: int,
                      prefix_groups: int, prefix_blocks: int):
    """One row's (hash_ids, input_length, output_length) draw — shared
    by synthesize() and synthesize_diurnal() so prefix-group encoding
    and length sampling cannot drift between the trace generators (A/B
    runs across them must differ only in arrival process)."""
    hash_ids = None
    if prefix_groups > 0:
        g = rng.randrange(prefix_groups)
        hash_ids = [g * 1000 + j for j in range(prefix_blocks)]
    isl = max(1, int(rng.gauss(input_len, input_len / 8)))
    osl = max(1, int(rng.gauss(output_len, output_len / 8)))
    return hash_ids, isl, osl


def synthesize(
    n_requests: int,
    *,
    rate_rps: float = 4.0,
    input_len: int = 256,
    output_len: int = 32,
    block_size: int = 16,
    prefix_groups: int = 0,
    prefix_blocks: int = 4,
    session_turns: int = 1,
    seed: int = 0,
) -> List[TraceRow]:
    """Synthetic mooncake-style trace: Poisson arrivals at `rate_rps`;
    `prefix_groups` > 0 assigns each request to a group sharing
    `prefix_blocks` hash_ids (system-prompt-style reuse); `session_turns`
    > 1 emits closed-loop follow-up turns per request."""
    rng = random.Random(seed)
    rows: List[TraceRow] = []
    t = 0.0
    for i in range(n_requests):
        t += rng.expovariate(rate_rps) * 1000.0
        hash_ids, isl, osl = _sample_row_shape(
            rng, input_len, output_len, prefix_groups, prefix_blocks)
        rows.append(TraceRow(
            request_id=f"req-{i}", input_length=isl, output_length=osl,
            hash_ids=hash_ids, timestamp=round(t, 3),
            session_id=f"sess-{i}" if session_turns > 1 else None,
        ))
        for turn in range(1, session_turns):
            rows.append(TraceRow(
                request_id=f"req-{i}-t{turn}", session_id=f"sess-{i}",
                input_length=max(1, isl // 4), output_length=osl,
                hash_ids=hash_ids, delay=rng.uniform(50.0, 200.0),
            ))
    return rows


def synthesize_diurnal(
    duration_s: float,
    *,
    rate_low_rps: float = 0.5,
    rate_high_rps: float = 5.0,
    period_s: Optional[float] = None,
    input_len: int = 256,
    output_len: int = 32,
    prefix_groups: int = 0,
    prefix_blocks: int = 4,
    seed: int = 0,
) -> List[TraceRow]:
    """Diurnal-swing trace: a non-homogeneous Poisson process whose
    rate sweeps sinusoidally between ``rate_low_rps`` (the trough) and
    ``rate_high_rps`` (the peak) over ``period_s`` (default: one full
    cycle across the duration, starting AND ending at the trough so a
    replay exercises scale-up into the peak and scale-down out of it).
    ``rate_high_rps / rate_low_rps`` is the swing the autoscaling bench
    provisions against (bench_planner_loop.py replays a 10× swing).

    Arrivals come from Lewis–Shedler thinning against the peak rate, so
    the instantaneous rate tracks the target curve exactly in
    expectation."""
    import math as _math

    rng = random.Random(seed)
    period = period_s or duration_s
    peak = max(rate_high_rps, 1e-9)

    def rate_at(t: float) -> float:
        # trough at t=0 and t=period; peak at period/2
        phase = (1.0 - _math.cos(2.0 * _math.pi * t / period)) / 2.0
        return rate_low_rps + (rate_high_rps - rate_low_rps) * phase

    rows: List[TraceRow] = []
    t = 0.0
    i = 0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            break
        if rng.random() >= rate_at(t) / peak:
            continue  # thinned: rate(t) below the envelope
        hash_ids, isl, osl = _sample_row_shape(
            rng, input_len, output_len, prefix_groups, prefix_blocks)
        rows.append(TraceRow(
            request_id=f"diurnal-{i}", input_length=isl, output_length=osl,
            hash_ids=hash_ids, timestamp=round(t * 1000.0, 3),
        ))
        i += 1
    return rows
