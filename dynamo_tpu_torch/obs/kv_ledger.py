"""KV ledger: block-lifecycle accounting + leak/double-free auditing.

A copy of dynamo_tpu/obs/kv_ledger.py (standard library only), so a
torch worker's ledger, its audits and its `/debug/kv` dump are the JAX
worker's and the JAX fleet tools (obs/report.py `kv_ledger_docs`,
obs/fleet.py `reduce_kv_ledgers`) read them unchanged.  The mocker's
capacity sim (mocker/kv_cache_sim.py) feeds the same ledger, hash-keyed,
with its anonymous (unhashed) blocks as per-sequence counts (`partial`),
and `audit_sim` reconciles the books against it.

This module is a second, independent set of books beside the block
allocator's (engine/block_allocator.py):

  * **The ledger** records every G1 block transition at its definition
    site (the allocator calls in, one ``if ledger is None`` pointer
    compare when off: the zero-cost-off contract, gated by
    ``DYN_KV_LEDGER=0`` or ``EngineConfig.kv_ledger=False``), every KVBM
    G2-G4 stage/evict (via the engine's per-tier event batches), and
    disagg park/unpark handoffs, each op stamped with seq_id, tier,
    lineage hash and the request's trace_id where one was propagated,
    onto a bounded event tape.

  * **The invariant auditor** reconciles the ledger's mirror against
    the allocator's ``_block_ref``/free list, the scheduler's live slot
    view and the KVBM pool manifests: on the step after a request
    finishes, on an idle-tick cadence and on demand (``/debug/kv``).
    Violations are classified::

        leak            a block the allocator holds that no live owner
                        accounts for (capacity silently lost), or a
                        tier pool holding an unledgered block
        double-free     a block id on the free list twice, or freed
                        while a live sequence still owns it
        orphan          the ledger references a block the allocator
                        already freed (books point at a ghost), or a
                        tier entry whose pool copy is gone
        refcount-drift  ledger refcount != allocator refcount, the
                        precursor state every other class grows from

    counted into ``dynamo_kv_ledger_violations_total{kind,tier}`` and
    snapshotting the flight recorder on each kind's first occurrence.

  * **Attribution**: per-tier occupancy broken down by state (active /
    prefix-cached / pinned-by-transfer / orphaned) plus lineage
    fragmentation: cached blocks whose parent block is gone can never
    be prefix-hit again (prefix matching walks leading runs only), so
    they are dead capacity the plain used/free split cannot see.

The ledger's accuracy contract is that every mutation of the
allocator's refcount/free-list state goes through the defining module.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

logger = logging.getLogger(__name__)

# THE canonical ledger-op taxonomy (the DYN006/SPAN_KINDS registry
# pattern): every record the ledger tapes names one of these; extend the
# set and the docstring table together when adding an op.
#
#   alloc       a free/evicted block pinned to a sequence (rc=1)
#   pin         prefix-cache hit: an owner added to a resident block
#   unpin       an owner released while others remain (rc stays > 0)
#   cache       last owner released; block retained prefix-cached (rc=0)
#   commit      a full block's lineage hash registered (with its parent)
#   evict       a cached block's registration destroyed (reuse/clear)
#   release     a block returned to the free list
#   park        a sequence's blocks pinned-by-transfer (disagg prefill
#               awaiting pull)
#   unpark      the parked handoff completed/expired
#   partial     the mocker's anonymous (unhashed) block count delta
#   stage       a block stored into a KVBM tier (g2/g3/g4)
#   tier_evict  a block dropped from a KVBM tier
#   onboard     a block's payload served back INTO G1 from a lower tier
#               (tape/counter only — the allocator's commit and the
#               fetch promotion's stage already move the membership
#               books; this mark is what lets the auditor and the
#               fleet-prefix-cache bench attribute reuse to its source
#               tier)
#   clear       whole-cache clear (clear_kv_blocks)
LEDGER_OPS = frozenset({
    "alloc", "pin", "unpin", "cache", "commit", "evict", "release",
    "park", "unpark", "partial", "stage", "tier_evict", "onboard",
    "clear", "quarantine",
})

# `corrupt` differs from the reconciliation kinds: it is recorded at
# the consume site the moment a checksum fails (corruption()), not
# derived by an audit sweep — an audit can't see a flipped bit, only a
# read can
VIOLATION_KINDS = ("leak", "double-free", "orphan", "refcount-drift",
                   "corrupt")

DEFAULT_RING = 4096

# bounded lineage-parent / recent-touch maps feeding the G4 residency
# policy (kvbm/residency.py): oldest entries age out FIFO, which only
# degrades a verdict to the TTL fallback, never to a wrong "dead"
LINEAGE_CAP = 65536


def ledger_enabled(override: Optional[bool] = None) -> bool:
    """The plane's on/off switch: an explicit config override wins,
    else ``DYN_KV_LEDGER`` (always-on by default, ``0`` disables)."""
    if override is not None:
        return bool(override)
    return os.environ.get("DYN_KV_LEDGER", "1").lower() not in (
        "0", "false", "no", "off")


class _Entry:
    """One tracked G1 block: refcount, lineage hash + parent, owners."""

    __slots__ = ("rc", "h", "parent", "owners")

    def __init__(self) -> None:
        self.rc = 0
        self.h: Optional[int] = None
        self.parent: Optional[int] = None
        self.owners: Dict[str, int] = {}


class KvLedger:
    """Independent block-lifecycle books + the reconciliation auditor.

    Keys are physical block ids for the torch engine and PLHs for the
    mocker sim (whose blocks have no physical identity): the audit entry
    points differ, everything else is shared.  Thread-safe: the engine
    records from the scheduler thread while ``/debug/kv`` reads from the
    event loop."""

    def __init__(self, ring: Optional[int] = None):
        if ring is None:
            try:
                ring = int(os.environ.get("DYN_KV_LEDGER_RING",
                                          str(DEFAULT_RING)))
            except ValueError:
                ring = DEFAULT_RING
        self._lock = threading.Lock()
        self._blk: Dict[int, _Entry] = {}
        self._tiers: Dict[str, Set[int]] = {}
        self._partials: Dict[str, int] = {}      # mocker: seq -> count
        self._parked_seqs: Set[str] = set()
        self._seq_trace: Dict[str, str] = {}
        # lineage + liveness surfaces for the G4 residency policy
        # (kvbm/residency.py): hash -> parent hash (from commit), and
        # hash -> last touch time (pin/commit/stage/onboard).  Both
        # FIFO-bounded at LINEAGE_CAP.
        from collections import OrderedDict

        self._lineage: "OrderedDict[int, Optional[int]]" = OrderedDict()
        self._touch: "OrderedDict[int, float]" = OrderedDict()
        self._onboards: Dict[str, int] = {}  # tier -> blocks onboarded
        # the event tape: (t, op, tier, key, h, seq, trace_id)
        self.events: "deque[tuple]" = deque(maxlen=max(64, ring))
        self.counts: Dict[str, int] = {}
        # (kind, tier) -> total, monotonic across audits
        self.violations_total: Dict[Tuple[str, str], int] = {}
        self.last_audit: Optional[dict] = None
        self._audit_t = 0.0
        self._finish_dirty = False

    # -- recording --------------------------------------------------------
    def _note(self, op: str, tier: str, key: Optional[int],
              h: Optional[int], seq: Optional[str]) -> None:
        # callers hold self._lock
        self.counts[op] = self.counts.get(op, 0) + 1
        self.events.append((time.monotonic(), op, tier, key, h, seq,
                            self._seq_trace.get(seq) if seq else None))

    def _touch_h(self, h: Optional[int]) -> None:
        # callers hold self._lock
        if h is None:
            return
        self._touch[h] = time.monotonic()
        self._touch.move_to_end(h)
        while len(self._touch) > LINEAGE_CAP:
            self._touch.popitem(last=False)

    def bind_seq(self, seq: str, trace_id: Optional[str]) -> None:
        """Associate a request's propagated trace_id with its seq_id so
        the tape's entries for that sequence are trace-joinable."""
        if trace_id is None:
            return
        with self._lock:
            self._seq_trace[seq] = trace_id

    def alloc(self, key: int, seq: str, h: Optional[int] = None) -> None:
        with self._lock:
            ent = self._blk.get(key)
            if ent is None:
                ent = self._blk[key] = _Entry()
            ent.rc += 1
            ent.owners[seq] = ent.owners.get(seq, 0) + 1
            if h is not None:
                ent.h = h
            self._note("alloc", "g1", key, ent.h, seq)

    def pin(self, key: int, seq: str) -> None:
        with self._lock:
            ent = self._blk.get(key)
            if ent is None:
                ent = self._blk[key] = _Entry()
            ent.rc += 1
            ent.owners[seq] = ent.owners.get(seq, 0) + 1
            self._touch_h(ent.h)
            self._note("pin", "g1", key, ent.h, seq)

    def unpin(self, key: int, seq: str) -> None:
        with self._lock:
            ent = self._blk.get(key)
            if ent is None:
                # recorded so the audit (not a crash) reports the drift
                self._note("unpin", "g1", key, None, seq)
                return
            ent.rc = max(0, ent.rc - 1)
            n = ent.owners.get(seq, 0) - 1
            if n > 0:
                ent.owners[seq] = n
            else:
                ent.owners.pop(seq, None)
            self._note("unpin", "g1", key, ent.h, seq)

    def cache(self, key: int, seq: Optional[str] = None) -> None:
        """Last owner released; the block stays resident prefix-cached."""
        with self._lock:
            ent = self._blk.get(key)
            if ent is not None:
                ent.rc = 0
                ent.owners.clear()
            self._note("cache", "g1", key,
                       ent.h if ent is not None else None, seq)

    def commit(self, key: int, h: int,
               parent: Optional[int] = None,
               seq: Optional[str] = None) -> None:
        with self._lock:
            ent = self._blk.get(key)
            if ent is not None:
                ent.h = h
                ent.parent = parent
            self._lineage[h] = parent
            self._lineage.move_to_end(h)
            while len(self._lineage) > LINEAGE_CAP:
                self._lineage.popitem(last=False)
            self._touch_h(h)
            self._note("commit", "g1", key, h, seq)

    def evict(self, key: int, h: Optional[int] = None) -> None:
        """A cached block's registration destroyed (the block is about
        to be reused or freed — an `alloc`/`release` follows)."""
        with self._lock:
            ent = self._blk.pop(key, None)
            self._note("evict", "g1", key,
                       h if h is not None
                       else (ent.h if ent is not None else None), None)

    def release(self, key: int, seq: Optional[str] = None) -> None:
        with self._lock:
            ent = self._blk.pop(key, None)
            self._note("release", "g1", key,
                       ent.h if ent is not None else None, seq)

    def seq_freed(self, seq: str) -> None:
        """A sequence fully released its holdings: arms the
        finish-cadence audit and drops the trace binding."""
        with self._lock:
            self._seq_trace.pop(seq, None)
            self._partials.pop(seq, None)
            self._finish_dirty = True

    def park(self, seq: str) -> None:
        with self._lock:
            self._parked_seqs.add(seq)
            self._note("park", "g1", None, None, seq)

    def unpark(self, seq: str) -> None:
        with self._lock:
            self._parked_seqs.discard(seq)
            self._note("unpark", "g1", None, None, seq)

    def partial(self, seq: str, delta: int) -> None:
        """The mocker's unhashed (partial) blocks have no identity: they
        are tracked as per-sequence counts."""
        with self._lock:
            n = self._partials.get(seq, 0) + delta
            if n > 0:
                self._partials[seq] = n
            else:
                self._partials.pop(seq, None)
            self._note("partial", "g1", None, None, seq)

    def tier_batch(self, stored: Sequence[int], removed: Sequence[int],
                   tier: str) -> None:
        """One KVBM tier's mutation batch (the engine's pre-consolidator
        per-tier events): membership sets the audit reconciles against
        the pool manifests.  G4 records onto the tape/counters only —
        the shared object store is swept by OTHER workers' TTL passes
        which fire no local events, so a per-worker membership set
        would grow monotonically forever (and the auditor deliberately
        excludes G4 for the same reason, see audit_kvbm)."""
        with self._lock:
            s = (self._tiers.setdefault(tier, set())
                 if tier != "g4" else None)
            for h in removed:
                if s is not None:
                    s.discard(h)
                self._note("tier_evict", tier, None, h, None)
            for h in stored:
                if s is not None:
                    s.add(h)
                self._touch_h(h)
                self._note("stage", tier, None, h, None)

    def onboard(self, h: int, tier: str, seq: Optional[str] = None) -> None:
        """One block served back into G1 from `tier` (tape/counter only;
        the membership books move via commit + the fetch promotion's
        stage).  Touches the hash — onboarded lineages are live by
        definition, which is what keeps them G4-resident."""
        with self._lock:
            self._onboards[tier] = self._onboards.get(tier, 0) + 1
            self._touch_h(h)
            self._note("onboard", tier, None, h, seq)

    def onboard_counts(self) -> Dict[str, int]:
        """Per-tier onboard totals (exported as
        dynamo_engine_kv_onboard_total{tier})."""
        with self._lock:
            return dict(self._onboards)

    def corruption(self, tier: str, h: Optional[int] = None,
                   detail: str = "") -> None:
        """One checksum-failed consume, attributed at the read site
        (kind=corrupt — see VIOLATION_KINDS).  The blob/frame is already
        quarantined by the caller; this is the forensic record: the
        monotonic (corrupt, tier) counter, a `quarantine` tape entry,
        and a flight-recorder snapshot on each tier's FIRST corruption
        (the context that poisoned a tier is exactly what post-incident
        forensics needs and exactly what a counter loses)."""
        from .. import obs

        with self._lock:
            key = ("corrupt", tier)
            first = key not in self.violations_total
            self.violations_total[key] = \
                self.violations_total.get(key, 0) + 1
            self._note("quarantine", tier, None, h, None)
        logger.error(
            "KV integrity: corrupt block %s in tier %s quarantined%s",
            f"{h:x}" if h is not None else "?", tier,
            f" ({detail})" if detail else "")
        if first:
            obs.flight_dump(f"kv_ledger.corrupt.{tier}")

    def clear(self) -> None:
        with self._lock:
            self._blk.clear()
            self._tiers.clear()
            self._partials.clear()
            self._note("clear", "g1", None, None, None)

    # -- residency surfaces (kvbm/residency.py reads these) ---------------
    def lineage_parent(self, h: int):
        """(known, parent): known=False when the commit that would have
        recorded the parent aged out of the bounded map (or never ran on
        this worker) — the residency policy must fall back to TTL, not
        guess."""
        with self._lock:
            if h in self._lineage:
                return True, self._lineage[h]
            return False, None

    def touched_within(self, h: int, window_s: float,
                       now: Optional[float] = None) -> bool:
        now = now if now is not None else time.monotonic()
        with self._lock:
            t = self._touch.get(h)
        return t is not None and (now - t) <= window_s

    def resident_hashes(self) -> Set[int]:
        """Every hash this worker's books currently account for, across
        G1 and the KVBM tiers — the liveness set lineage verdicts check
        parents against."""
        with self._lock:
            out = {e.h for e in self._blk.values() if e.h is not None}
            for s in self._tiers.values():
                out |= s
            return out

    # -- audit cadence ----------------------------------------------------
    def audit_due(self, idle_interval_s: Optional[float] = None) -> bool:
        """True when the reconciliation sweep should run: a request
        finished since the last audit (the step-end cadence), or —
        when the caller passes the idle-tick interval — that much time
        elapsed since the last sweep.  The interval applies on IDLE
        engines only; a busy engine audits per finish, so the
        O(num_blocks) scan never interleaves a steady decode stretch."""
        with self._lock:
            if self._finish_dirty:
                return True
        if idle_interval_s is None:
            return False
        return time.monotonic() - self._audit_t > idle_interval_s

    # -- auditor ----------------------------------------------------------
    @staticmethod
    def _v(kind: str, tier: str, detail: str, key=None, h=None,
           seq=None) -> dict:
        out = {"kind": kind, "tier": tier, "detail": detail}
        if key is not None:
            out["block"] = key
        if h is not None:
            out["hash"] = f"{int(h):x}"
        if seq is not None:
            out["seq_id"] = seq
        return out

    def audit_allocator(self, allocator, live_seqs: Iterable[str],
                        parked_seqs: Iterable[str] = ()) -> List[dict]:
        """Reconcile against a BlockAllocator: its free list and
        ``_block_ref`` are the ground truth the ledger's mirror must
        agree with, and every owner the ledger records must still exist
        in the scheduler's slot view (``live_seqs``) or the parked-
        transfer set."""
        live = set(live_seqs) | set(parked_seqs)
        viol: List[dict] = []
        # reads only: every mutation belongs to the allocator itself
        free_list = list(allocator._free)
        block_ref = dict(allocator._block_ref)
        seq_blocks = {s: list(b) for s, b in allocator._seq_blocks.items()}
        with self._lock:
            mirror = {k: (e.rc, dict(e.owners), e.h)
                      for k, e in self._blk.items()}
        free_set = set(free_list)
        if len(free_list) != len(free_set):
            seen: Set[int] = set()
            for bid in free_list:
                if bid in seen:
                    viol.append(self._v(
                        "double-free", "g1",
                        "block id appears on the free list more than "
                        "once", key=bid))
                seen.add(bid)
        owned = {bid for bids in seq_blocks.values() for bid in bids}
        for bid in owned & free_set:
            seq = next((s for s, bids in seq_blocks.items()
                        if bid in bids), None)
            viol.append(self._v(
                "double-free", "g1",
                "block freed while a sequence still holds it",
                key=bid, seq=seq))
        # unsorted iteration throughout: the sweep runs on the finish
        # cadence with the engine's step lock held, and the clean case
        # (the overwhelmingly common one) must not pay O(n log n) for
        # deterministic ordering of violations that don't exist —
        # finish_audit sorts the (rare, small) findings instead
        in_use = {bid for bid in range(1, allocator.num_blocks)
                  if bid not in free_set}
        for bid in in_use:
            ent = mirror.get(bid)
            if ent is None:
                viol.append(self._v(
                    "leak", "g1",
                    "allocated block has no ledger owner (capacity "
                    "silently lost)", key=bid))
                continue
            rc, owners, h = ent
            alloc_rc = block_ref.get(bid, 0)
            if rc != alloc_rc:
                viol.append(self._v(
                    "refcount-drift", "g1",
                    f"ledger rc={rc} but allocator rc={alloc_rc}",
                    key=bid, h=h))
            dead = [s for s in owners if s not in live]
            for seq in dead:
                viol.append(self._v(
                    "leak", "g1",
                    "owner sequence no longer exists (block never "
                    "freed)", key=bid, h=h, seq=seq))
        for bid in set(mirror) - in_use:
            rc, owners, h = mirror[bid]
            seq = next(iter(owners), None)
            viol.append(self._v(
                "orphan", "g1",
                "ledger references a block the allocator freed",
                key=bid, h=h, seq=seq))
        return viol

    def audit_kvbm(self, kvbm) -> List[dict]:
        """Reconcile the ledger's tier membership against the KVBM pool
        manifests (G2 host / G3 disk; G4 is the shared object store —
        listed by other workers' sweeps, so it is deliberately out of
        per-worker audit scope)."""
        if kvbm is None:
            return []
        viol: List[dict] = []
        manifest = kvbm.manifest()
        with self._lock:
            mine = {t: set(s) for t, s in self._tiers.items()}
        for tier, pool in manifest.items():
            led = mine.get(tier, set())
            for h in pool - led:
                viol.append(self._v(
                    "leak", tier,
                    "pool holds a block the ledger never saw staged",
                    h=h))
            for h in led - pool:
                viol.append(self._v(
                    "orphan", tier,
                    "ledger says staged but the pool no longer holds "
                    "it", h=h))
        return viol

    def audit_sim(self, sim, live_seqs: Iterable[str]) -> List[dict]:
        """Reconcile against the mocker's KvCacheSim (hash-keyed; the
        free-block COUNTER stands in for a free list, so double-free
        surfaces as the counter running ahead of the books)."""
        live = set(live_seqs)
        viol: List[dict] = []
        ref = dict(sim._ref)
        with self._lock:
            mirror = {k: (e.rc, dict(e.owners)) for k, e in
                      self._blk.items()}
            partial_total = sum(self._partials.values())
        for h in set(ref) - set(mirror):
            viol.append(self._v(
                "leak", "g1",
                "sim caches a block the ledger never saw", h=h))
        for h in set(mirror) - set(ref):
            rc, owners = mirror[h]
            viol.append(self._v(
                "orphan", "g1",
                "ledger references a block the sim dropped", h=h,
                seq=next(iter(owners), None)))
        for h in set(ref) & set(mirror):
            rc, owners = mirror[h]
            if rc != ref[h]:
                viol.append(self._v(
                    "refcount-drift", "g1",
                    f"ledger rc={rc} but sim rc={ref[h]}", h=h))
            for seq in owners:
                if seq not in live:
                    viol.append(self._v(
                        "leak", "g1",
                        "owner sequence no longer exists", h=h,
                        seq=seq))
        expected_used = len(mirror) + partial_total
        if sim.used_blocks < expected_used:
            viol.append(self._v(
                "double-free", "g1",
                f"sim counts {sim.used_blocks} used but the books hold "
                f"{expected_used} (free counter ran ahead)"))
        elif sim.used_blocks > expected_used:
            viol.append(self._v(
                "leak", "g1",
                f"sim counts {sim.used_blocks} used but the books hold "
                f"only {expected_used}"))
        return viol

    def finish_audit(self, violations: List[dict],
                     where: str = "") -> dict:
        """Fold one sweep's findings into the monotonic counters, the
        flight recorder (first occurrence per kind), and `last_audit`
        (what /debug/kv serves).  Returns the audit report."""
        from .. import obs

        # deterministic report order, paid only when something is wrong
        violations = sorted(
            violations,
            key=lambda v: (v["kind"], v["tier"], v.get("block", -1),
                           v.get("hash", "")))
        new_kinds = []
        with self._lock:
            prior = {k for (k, _t) in self.violations_total}
            for v in violations:
                key = (v["kind"], v["tier"])
                self.violations_total[key] = \
                    self.violations_total.get(key, 0) + 1
                if v["kind"] not in prior:
                    prior.add(v["kind"])
                    new_kinds.append(v["kind"])
            report = {
                "ts_unix": time.time(),
                "where": where,
                "clean": not violations,
                "violations": violations[:32],
                "violation_count": len(violations),
            }
            self.last_audit = report
            self._finish_dirty = False
        self._audit_t = time.monotonic()
        for kind in new_kinds:
            # first occurrence of this class in the process's lifetime:
            # the timeline that led here is the post-mortem
            obs.flight_dump(f"kv_ledger.{kind}")
        if violations:
            logger.error(
                "kv ledger audit (%s): %d violation(s), first: %r",
                where or "sweep", len(violations), violations[0])
        return report

    # -- attribution ------------------------------------------------------
    def attribution(self) -> dict:
        """Per-tier occupancy broken down by state, plus lineage
        fragmentation: a prefix-cached block whose parent block is no
        longer resident can never be prefix-hit again (matching walks
        leading runs), so it is dead capacity `used/free` cannot see."""
        with self._lock:
            active = cached = parked = 0
            dead_cached = 0
            resident_hashes = {e.h for e in self._blk.values()
                               if e.h is not None}
            for ent in self._blk.values():
                if ent.owners and any(s in self._parked_seqs
                                      for s in ent.owners):
                    parked += 1
                elif ent.rc > 0:
                    active += 1
                else:
                    cached += 1
                    if ent.parent is not None \
                            and ent.parent not in resident_hashes:
                        dead_cached += 1
            partial = sum(self._partials.values())
            out = {"g1": {
                "active": active,
                "prefix_cached": cached,
                "pinned_by_transfer": parked,
                "partial": partial,
                "tracked": len(self._blk) + partial,
                "orphaned": sum(
                    1 for v in (self.last_audit or {}).get(
                        "violations", ())
                    if v["kind"] == "orphan" and v["tier"] == "g1"),
                "fragmentation": {
                    "dead_cached": dead_cached,
                    "dead_frac": (round(dead_cached / cached, 4)
                                  if cached else 0.0),
                },
            }}
            for tier, s in self._tiers.items():
                out[tier] = {"blocks": len(s)}
            return out

    def violations_by_kind(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for (kind, tier), n in self.violations_total.items():
                out.setdefault(kind, {})[tier] = n
            return out

    # -- export -----------------------------------------------------------
    def dump(self, tail: int = 64) -> dict:
        """The /debug/kv payload (and the obs.report KV-accounting
        input): attribution, op counts, violation totals, the last
        audit report, and the event tape's tail."""
        with self._lock:
            events = list(self.events)[-max(0, tail):]
            counts = dict(self.counts)
            parked = sorted(self._parked_seqs)
            last = self.last_audit
        now = time.monotonic()
        return {
            "schema": "dynamo.kv_ledger.v1",
            "enabled": True,
            "counts": counts,
            "onboards_by_tier": self.onboard_counts(),
            "attribution": self.attribution(),
            "violations_total": self.violations_by_kind(),
            "last_audit": last,
            "parked_seqs": parked,
            "events_tail": [
                {"age_s": round(now - t, 4), "op": op, "tier": tier,
                 **({"block": key} if key is not None else {}),
                 **({"hash": f"{int(h):x}"} if h is not None else {}),
                 **({"seq_id": seq} if seq else {}),
                 **({"trace_id": tid} if tid else {})}
                for t, op, tier, key, h, seq, tid in events
            ],
        }


class MergedLedgers:
    """Gauge-surface adapter summing several ledgers (a worker running
    one independent engine and ledger per rank exports ONE /metrics
    surface, the same summing its load gauges do)."""

    def __init__(self, ledgers: Iterable[Optional[KvLedger]]):
        self.ledgers = [led for led in ledgers if led is not None]

    def __bool__(self) -> bool:
        return bool(self.ledgers)

    def violations_by_kind(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for led in self.ledgers:
            for kind, tiers in led.violations_by_kind().items():
                dst = out.setdefault(kind, {})
                for tier, n in tiers.items():
                    dst[tier] = dst.get(tier, 0) + n
        return out

    def attribution(self) -> dict:
        out: Dict[str, Dict[str, int]] = {}
        for led in self.ledgers:
            for tier, states in led.attribution().items():
                dst = out.setdefault(tier, {})
                for state, v in states.items():
                    if isinstance(v, (int, float)):
                        dst[state] = dst.get(state, 0) + v
        return out

    def onboard_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for led in self.ledgers:
            for tier, n in led.onboard_counts().items():
                out[tier] = out.get(tier, 0) + n
        return out


__all__ = [
    "DEFAULT_RING",
    "KvLedger",
    "LEDGER_OPS",
    "MergedLedgers",
    "VIOLATION_KINDS",
    "ledger_enabled",
]
