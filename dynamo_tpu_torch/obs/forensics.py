"""The request hop timeline's vocabulary and its exact phase partition.

A copy of the taxonomy half of dynamo_tpu/obs/forensics.py: the port's
RequestTracker (frontend/request_trace.py) records the same hops
(received, routed, dispatched, prefill_open, prefill_done, worker_stamp,
first_token, decode_stall, finish) and folds them into the same six
phases (queue, route, prefill, transfer, decode, stall) on each
`request_end` record.  The tail-exemplar reservoir (`ForensicsPlane`) and
its `/debug/requests` dump are not ported yet (ROADMAP, Queue 1): the
port's frontend refuses `DYN_FORENSICS=1` rather than run without it.

Env vocabulary::

    DYN_FORENSICS=0          no hop timeline (default: recorded)
    DYN_STALL_THRESHOLD_S=0.25   decode-stall hop threshold
"""

from __future__ import annotations

import os
from typing import Dict, List

HOP_KINDS = frozenset({
    "received",
    "routed",
    "dispatched",
    "prefill_open",
    "prefill_done",
    "worker_stamp",
    "first_token",
    "decode_stall",
    "finish",
})

# the partition vocabulary, in render order
PHASES = ("queue", "route", "prefill", "transfer", "decode", "stall")

# hop kinds that act as phase BOUNDARIES in the partition sweep
# (worker_stamp/decode_stall/finish carry attrs, not boundaries)
_BOUNDARY_KINDS = ("routed", "dispatched", "prefill_open", "prefill_done",
                   "first_token")


def forensics_enabled() -> bool:
    """Hop timelines on by default; DYN_FORENSICS=0 turns them off."""
    return os.environ.get("DYN_FORENSICS", "1").lower() not in (
        "0", "false", "no", "off")


def reservoir_requested() -> bool:
    """DYN_FORENSICS set on explicitly: the caller asks for the JAX
    frontend's tail-exemplar reservoir, which the port has not yet."""
    return os.environ.get("DYN_FORENSICS", "").lower() in (
        "1", "true", "yes", "on")


def stall_threshold_s() -> float:
    try:
        return float(os.environ.get("DYN_STALL_THRESHOLD_S", "0.25"))
    except ValueError:
        return 0.25


# ---------------------------------------------------------------------------
# exact phase partition
# ---------------------------------------------------------------------------


def phase_partition(hops: List[dict], total_ms: float,
                    stall_ms: float = 0.0) -> Dict[str, float]:
    """Partition ``[0, total_ms]`` into PHASES *exactly* (telescoping
    over boundary hops, so the six values sum to total_ms by
    construction, modulo float rounding):

      received→routed          route   (preprocess + routing decision)
      routed→dispatched        queue   (admission / dispatch wait)
      received→prefill_open    queue   (disagg: the hop IS the first
                                        dispatch, so the wait before it
                                        is admission)
      prefill_open→prefill_done prefill (the remote prefill itself)
      dispatched→first_token   prefill (local path: worker queue +
                                        prefill compute) or transfer
                                        (disagg: KV pull + first decode)
      first_token→finish       decode, with the accumulated stall time
                               carved out as stall

    Only the FIRST occurrence of each boundary kind partitions (a
    migration's second dispatched hop restarts nothing — its wait is
    part of the decode/stall story the stall hops already tell)."""
    t: Dict[str, float] = {}
    for h in hops:
        k = h.get("hop")
        if k in _BOUNDARY_KINDS and k not in t:
            t[k] = float(h.get("t_ms", 0.0))
    out = {p: 0.0 for p in PHASES}
    prev = 0.0
    disagg = False        # a remote prefill completed
    dispatched = False
    for tv, k in sorted((v, k) for k, v in t.items()):
        seg = tv - prev
        if seg > 0.0:
            if k == "routed":
                out["route"] += seg
            elif k in ("dispatched", "prefill_open"):
                out["queue"] += seg
            elif k == "prefill_done":
                out["prefill"] += seg
            elif k == "first_token":
                out["transfer" if disagg
                    else ("prefill" if dispatched else "queue")] += seg
            prev = tv
        if k == "prefill_done":
            disagg = True
        elif k in ("dispatched", "prefill_open"):
            dispatched = True
    tail = total_ms - prev
    if tail > 0.0:
        if "first_token" in t:
            st = min(max(stall_ms, 0.0), tail)
            out["stall"] += st
            out["decode"] += tail - st
        else:
            # never produced a token: the terminal interval belongs to
            # whatever phase the request died in
            out["transfer" if disagg
                else ("prefill" if dispatched else "queue")] += tail
    return out
