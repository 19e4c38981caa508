"""Chaos plane: deterministic, seeded fault injection for the runtime.

A copy of dynamo_tpu/chaos/__init__.py: the same actions, the same seam
registry and the same per-rule `random.Random` derived from (seed,
seam, action), so one seed and one call order inject identically in
both packages.  The fault-tolerance mechanisms of the port (the
frontend's token-replay migration, drain, the KV-pull local-prefill
fallback, the KV ledger's auditor, the planner's connector governor,
the global router's degradation) each work in isolation; this module
proves they COMPOSE, against the port's mocker and `TorchEngine`.

Design:

  * **Named seams.**  Production code declares injection points by name
    (`SEAMS` below documents the registry).  A seam call is a single
    module-global ``None`` check when chaos is disabled — zero overhead
    on every hot path, no test hooks leaking into production flow.

  * **Deterministic from a seed.**  A :class:`ChaosPlane` is constructed
    with a seed; every probabilistic decision draws from a per-rule
    ``random.Random`` derived from (seed, seam, action), and
    count-based rules (``after=N, times=M``) are pure counters.  Two
    runs with the same seed and the same call order inject identically
    — which is what lets the chaos suite assert token-identical output
    against a fault-free run.

  * **Typed faults.**  Injected failures raise :class:`ChaosError`
    whose message carries the real failure marker the fault simulates
    (``"connection lost"``, ``"worker draining"``, …), so the existing
    migratable-error classification (frontend/pipeline.py) sees exactly
    what a genuine fault would produce.

Usage (tests):

    plane = ChaosPlane(seed=7)
    plane.rule("request_plane.frame", "truncate", after=3, times=1)
    with plane:                       # install / uninstall
        ... drive requests ...
    assert plane.injections           # what actually fired

Seam registry (name — wired at — supported actions):

  request_plane.dispatch   Client.generate, before the stream opens
                           (fail, delay)
  request_plane.frame      RequestPlaneServer._run_handler, per response
                           frame (drop, delay, truncate ≙ connection
                           lost mid-stream, fail)
  discovery.op             discovery backend put/delete/get_prefix
                           (fail = transient outage, delay)
  discovery.lease          lease keepalive/heartbeat (fail = miss the
                           refresh → lease expiry)
  disagg.pull.chunk        engine _stream_pull, per chunk op — covers
                           broker, transfer-server and host-staged
                           tiers (fail = pull failure partway through
                           the sequence, delay = slow peer)
  kvbm.remote_pull         RemoteKvbmPuller.fetch_run, per peer pull
                           (fail, delay, corrupt = flip a byte in the
                           frame payload before decode — the wire
                           checksum must catch it and mark the source
                           suspect)
  kvbm.object_io           ObjectStorePool get/put (kvbm/object_store.py,
                           on the G4 I/O thread) and SimObjectStore
                           lookups (mocker/kv_cache_sim.py), per op.
                           corrupt = payload bytes differ from the
                           committed crc32 → quarantine; stall = hung
                           shared mount → the caller's deadline +
                           tier breaker; fail = I/O error
  engine.step              TorchEngine._sched_step / MockEngine._step,
                           per scheduler step (fail = crash on step N,
                           wedge = stop stepping)
  engine.kv_account        BlockAllocator free/allocate, per violation
                           class (drop = seed the named accounting
                           fault: key carries leak / double_free /
                           orphan / refcount_drift — the kv-ledger
                           auditor must catch each, obs/kv_ledger.py)
  planner.scale            Planner tick EXECUTE, before the connector
                           call (fail = actuation failure the loop must
                           survive, delay = slow connector)
  connector.spawn          SubprocessConnector / CallbackConnector, per
                           replica spawn (fail = spawn failure — what
                           the backoff/circuit-breaker governor must
                           absorb instead of respawning every tick)
  worker.drain             TorchEngineWorker.drain / MockerWorker.drain
                           entry (wedge = a worker that IGNORES drain,
                           forcing the connector's bounded-wait →
                           stop escalation; fail = drain raising)
  grouter.classify         GlobalRouterService pool classification,
                           per request (fail = classifier fault — the
                           global router must degrade to round-robin
                           over pools, never drop the request; delay)
  router_sync.snapshot     RouterReplicaSync snapshot-on-subscribe
                           answer, per joining peer (fail = snapshot
                           build fault — the recv loop must drop the
                           frame and stay alive, the joiner's retry
                           re-requests it; delay)
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# actions a rule may carry; "drop"/"truncate" are interpreted by the
# call site (only the frame seam understands them), and so are
# "corrupt" (the site tampers the bytes it just read, so the integrity
# checksum — not the injector — is what catches the fault) and "stall"
# (the site decides between really sleeping on its I/O thread and
# charging its deadline, so an event-loop site never blocks the loop);
# the rest are executed by hit()/ahit() themselves
ACTIONS = ("fail", "delay", "wedge", "drop", "truncate", "corrupt",
           "stall")

# THE canonical seam registry: every hit()/ahit() call site names one of
# these, and ChaosPlane.rule() rejects anything else.  A typo'd seam in
# a scenario would be a rule that silently never fires — the scenario
# "passing" by injecting nothing; it is a loud ValueError at rule()
# time instead.  Keep this set, the docstring registry above, and the
# wired call sites in lockstep when adding a seam.
SEAMS = frozenset({
    "request_plane.dispatch",
    "request_plane.frame",
    "discovery.op",
    "discovery.lease",
    "disagg.pull.chunk",
    "kvbm.remote_pull",
    "kvbm.object_io",
    "engine.step",
    "engine.kv_account",
    "planner.scale",
    "connector.spawn",
    "worker.drain",
    "grouter.classify",
    "router_sync.snapshot",
})

# how long a "wedge" blocks when no delay_s is given: effectively
# forever at test/canary timescales, finite so a wedged thread can
# still unwind on interpreter shutdown
WEDGE_DEFAULT_S = 3600.0


class ChaosError(RuntimeError):
    """An injected fault.  A RuntimeError subclass whose message carries
    the marker of the real failure mode being simulated, so downstream
    handling (is_migratable classification, the migration operator's
    except clauses, pull fallbacks) sees exactly what a genuine fault
    would produce."""


@dataclass
class Rule:
    seam: str
    action: str
    p: float = 1.0          # injection probability per eligible hit
    after: int = 0          # skip the first `after` eligible hits
    times: Optional[int] = None  # max injections (None = unlimited)
    delay_s: float = 0.0    # for delay (and optionally wedge)
    error: str = ""         # ChaosError message for fail/truncate
    match: str = ""         # substring the hit key must contain
    # internal state
    hits: int = 0           # eligible hits seen (post-match)
    fired: int = 0          # injections performed
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def message(self) -> str:
        if self.error:
            return self.error
        if self.action == "truncate":
            # a truncated stream is what a worker death looks like from
            # the client: classify like the real thing
            return f"connection lost (chaos: {self.seam} truncated)"
        return f"chaos injected fault at seam {self.seam!r}"


@dataclass(frozen=True)
class Injection:
    """One fired injection, for post-run assertions."""

    seam: str
    key: Optional[str]
    action: str
    n: int  # 1-based injection ordinal for its rule


class ChaosPlane:
    """A seeded set of injection rules.  Install process-globally with
    ``with plane:`` (or install()/uninstall()); seams are no-ops while
    no plane is installed."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: List[Rule] = []
        self.injections: List[Injection] = []
        # seams fire from both the event loop and the engine's scheduler
        # thread; the decision path must be consistent under that
        self._lock = threading.Lock()

    def rule(self, seam: str, action: str, *, p: float = 1.0,
             after: int = 0, times: Optional[int] = None,
             delay_s: float = 0.0, error: str = "",
             match: str = "") -> "ChaosPlane":
        if action not in ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}")
        if seam not in SEAMS:
            raise ValueError(
                f"unknown chaos seam {seam!r}: a rule on an unregistered "
                f"seam would silently never fire; known seams: "
                f"{sorted(SEAMS)}")
        r = Rule(seam=seam, action=action, p=p, after=after, times=times,
                 delay_s=delay_s, error=error, match=match)
        # deterministic per-rule stream: seed ⊕ rule identity.  The
        # insertion index is part of the identity so two otherwise
        # identical rules draw independent streams — which also means a
        # scenario reproduces only if rules are added in the same order
        # (fine: scenarios are code, and replays rerun the same code)
        ident = f"{seam}|{action}|{match}|{len(self.rules)}"
        r.rng.seed(self.seed ^ zlib.crc32(ident.encode()))
        self.rules.append(r)
        return self

    # -- decision ---------------------------------------------------------
    def decide(self, seam: str, key: Optional[str] = None) -> Optional[Rule]:
        """The rule that fires for this hit, or None.  Counts the hit on
        every matching rule (so `after=N` means "the N+1th hit")."""
        with self._lock:
            for r in self.rules:
                if r.seam != seam:
                    continue
                if r.match and (key is None or r.match not in key):
                    continue
                r.hits += 1
                if r.hits <= r.after:
                    continue
                if r.times is not None and r.fired >= r.times:
                    continue
                if r.p < 1.0 and r.rng.random() >= r.p:
                    continue
                r.fired += 1
                inj = Injection(seam=seam, key=key, action=r.action,
                                n=r.fired)
                self.injections.append(inj)
                logger.warning("chaos: %s action=%s key=%s (#%d)",
                               seam, r.action, key, r.fired)
                return r
        return None

    def fired(self, seam: Optional[str] = None) -> int:
        return sum(1 for i in self.injections
                   if seam is None or i.seam == seam)

    # -- install ----------------------------------------------------------
    def install(self) -> "ChaosPlane":
        global _PLANE
        _PLANE = self
        return self

    def uninstall(self) -> None:
        global _PLANE
        if _PLANE is self:
            _PLANE = None

    def __enter__(self) -> "ChaosPlane":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


_PLANE: Optional[ChaosPlane] = None


def _flight_dump(seam: str) -> None:
    """An injection fired: snapshot the timeline tracer's ring (obs/)
    so the post-mortem has the spans that led up to the fault.  No-op
    when tracing is off; never lets observability break an injection."""
    try:
        from .. import obs

        obs.flight_dump(f"chaos.{seam}")
    except Exception:  # pragma: no cover
        logger.warning("chaos flight dump failed", exc_info=True)


def active() -> Optional[ChaosPlane]:
    return _PLANE


def hit(seam: str, key: Optional[str] = None) -> Optional[str]:
    """Synchronous seam (scheduler-thread sites).  Raises ChaosError on
    "fail"/"truncate"; blocks the calling thread on "delay"/"wedge";
    returns the action name for caller-interpreted actions, else None.
    No-op (one global check) when chaos is disabled."""
    if _PLANE is None:
        return None
    r = _PLANE.decide(seam, key)
    if r is None:
        return None
    _flight_dump(seam)
    if r.action in ("fail", "truncate"):
        raise ChaosError(r.message())
    if r.action == "delay":
        time.sleep(r.delay_s)
    elif r.action == "wedge":
        time.sleep(r.delay_s or WEDGE_DEFAULT_S)
    return r.action


async def ahit(seam: str, key: Optional[str] = None) -> Optional[str]:
    """Async seam (event-loop sites).  Same contract as hit(), with
    cooperative sleeps."""
    if _PLANE is None:
        return None
    r = _PLANE.decide(seam, key)
    if r is None:
        return None
    _flight_dump(seam)
    if r.action in ("fail", "truncate"):
        raise ChaosError(r.message())
    if r.action == "delay":
        await asyncio.sleep(r.delay_s)
    elif r.action == "wedge":
        await asyncio.sleep(r.delay_s or WEDGE_DEFAULT_S)
    return r.action


__all__ = [
    "ACTIONS",
    "SEAMS",
    "ChaosError",
    "ChaosPlane",
    "Injection",
    "Rule",
    "active",
    "ahit",
    "hit",
]
