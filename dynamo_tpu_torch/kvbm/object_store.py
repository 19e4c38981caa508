"""G4 object-store KV tier: cluster-shared, content-addressed block blobs.

A copy of dynamo_tpu/kvbm/object_store.py (its chaos seam left out).
Unlike G2/G3, which are instance-owned caches with capacity eviction, G4
is a shared namespace: blocks are immutable blobs keyed by content (a
PLH commits to the full token prefix, so two engines writing the same
hash wrote the same bytes; last-write-wins is a no-op).  Any worker may
onboard any worker's demotions, a JAX worker's included: the blob is
the pools.py `.npz` both packages write.

Backend: a filesystem directory (a shared FS or a FUSE-mounted bucket).
Puts are atomic (tmp + rename), reads tolerate concurrent GC, and GC is
TTL-by-mtime so any number of clients can run it without coordination.
"""

from __future__ import annotations

import logging
import os
import secrets
import time
import zipfile
from typing import Iterable, List, Optional

import torch

from .pools import (
    Block,
    BlockIntegrityError,
    _save_block,
    read_block_file,
    verify_block,
)

logger = logging.getLogger(__name__)

# orphaned-tmp grace when the pool has no TTL: a *.tmp blob older than
# this was abandoned mid-put (a crashed writer) and is reaped by sweep()
_TMP_TTL_S = 3600.0


class ObjectStorePool:
    """Content-addressed blob directory; no instance ownership."""

    def __init__(self, directory: str, ttl_s: Optional[float] = None):
        self.dir = directory
        self.ttl_s = ttl_s
        os.makedirs(directory, exist_ok=True)
        # startup GC: reap expired and legacy-named blobs once (any number
        # of clients may do this concurrently; unlink races are benign)
        try:
            self.sweep()
        except OSError:
            logger.warning("G4 startup sweep failed", exc_info=True)

    def _path(self, h: int) -> str:
        # the full 128-bit PLH in the blob name: a truncated key could
        # alias two lineages and serve another prefix's KV bytes
        hx = f"{h:032x}"
        # two-level fanout: shared directories degrade with flat millions
        return os.path.join(self.dir, hx[:2], hx)

    def __contains__(self, h: int) -> bool:
        return os.path.isfile(self._path(h))

    def put(self, h: int, *arrays: torch.Tensor) -> bool:
        """Atomic write; returns False if the blob already existed (same
        content by construction: PLH keys commit to the payload)."""
        p = self._path(h)
        if os.path.isfile(p):
            return False
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = f"{p}.tmp{secrets.token_hex(4)}"
        try:
            with open(tmp, "wb") as f:
                _save_block(f, arrays)
            os.replace(tmp, p)
        except OSError:
            logger.warning("G4 put failed for %032x", h, exc_info=True)
            self._reap_tmp(tmp)
            return False
        except BaseException:
            # any other failure (a bad payload, an interrupt) must still
            # reap the tmp blob: an orphan on the shared volume is every
            # client's problem, and sweep() ages them out only after a TTL
            self._reap_tmp(tmp)
            raise
        return True

    def _reap_tmp(self, tmp: str) -> None:
        try:
            os.unlink(tmp)
        except OSError:
            pass

    def get(self, h: int) -> Optional[Block]:
        """One verified read.  Returns the block or None (miss).  A blob
        whose payload fails its crc32 footer is deleted (quarantined at
        the source, fleet-wide) before BlockIntegrityError is raised: the
        caller attributes the event and degrades to a miss.  A legacy
        blob without a footer is read once and re-stamped in place, or
        reaped when the re-stamp cannot land."""
        p = self._path(h)
        try:
            blk, crc = read_block_file(p)
        except (OSError, KeyError, ValueError, TypeError, AttributeError,
                zipfile.BadZipFile):
            return None  # concurrent GC or a torn write: a miss
        try:
            verify_block(blk, crc)
        except BlockIntegrityError:
            self.quarantine(h)
            raise BlockIntegrityError(
                f"G4 blob {int(h):032x} failed its crc32 footer; "
                "quarantined")
        if crc is None:
            self._restamp(h, blk)
        return blk

    def quarantine(self, h: int) -> bool:
        """Delete a blob that failed verification: the shared namespace
        must never serve it again (a fresh spill from any worker
        re-creates it clean)."""
        try:
            os.unlink(self._path(h))
            return True
        except OSError:
            return False

    def _restamp(self, h: int, blk: Block) -> None:
        """Rewrite a legacy blob with the checksum footer (atomic, the
        same tmp+rename as put).  If the rewrite cannot land, reap the
        blob: one that can never be verified must not stay shared."""
        p = self._path(h)
        tmp = f"{p}.tmp{secrets.token_hex(4)}"
        try:
            with open(tmp, "wb") as f:
                _save_block(f, blk)
            os.replace(tmp, p)
            logger.info("G4 re-stamped legacy blob %032x", int(h))
        except Exception:
            self._reap_tmp(tmp)
            self.quarantine(h)
            logger.warning("G4 legacy blob %032x could not be re-stamped;"
                           " reaped", int(h))

    def sweep(self, now: Optional[float] = None,
              residency=None) -> List[int]:
        """GC; returns the reaped hashes (so the caller can publish
        ``removed(tier="g4")``: the sweeper need not be the spiller).

        TTL-by-mtime (when a TTL is set) plus reaping of legacy blobs
        named by 64-bit keys.  `residency` (kvbm/residency.py) upgrades
        the verdict per blob: a callable hash -> "hot" | "dead" | None;
        "hot" blobs get their mtime touched (the TTL clock restarts),
        "dead" ones are reaped at once, None leaves the TTL to decide.
        Safe to run from any client concurrently (unlink and utime races
        are benign)."""
        now = now if now is not None else time.time()
        tmp_ttl = self.ttl_s if self.ttl_s is not None else _TMP_TTL_S
        removed: List[int] = []
        for sub in self._listdir(self.dir):
            d = os.path.join(self.dir, sub)
            if not os.path.isdir(d):
                continue
            for name in self._listdir(d):
                p = os.path.join(d, name)
                if ".tmp" in name:
                    # an abandoned mid-put tmp blob: a live put renames
                    # within milliseconds, so age is the signal
                    try:
                        if now - os.path.getmtime(p) > tmp_ttl:
                            os.unlink(p)
                    except OSError:
                        pass
                    continue
                legacy = False
                h: Optional[int] = None
                try:
                    if len(name) == 16:
                        int(name, 16)  # only reap actual legacy keys
                        legacy = True
                    elif len(name) == 32:
                        h = int(name, 16)
                except ValueError:
                    pass
                verdict = (residency(h) if residency is not None
                           and h is not None else None)
                try:
                    if legacy or verdict == "dead" or (
                            verdict is None
                            and self.ttl_s is not None
                            and now - os.path.getmtime(p) > self.ttl_s):
                        os.unlink(p)
                        if h is not None:
                            removed.append(h)
                    elif verdict == "hot":
                        os.utime(p)  # lease renewal
                except OSError:
                    continue
        return removed

    @staticmethod
    def _listdir(d: str) -> List[str]:
        """One directory listing, degraded: a concurrently removed fanout
        dir or an unmounted volume yields an empty listing (a partial
        sweep or manifest) instead of raising out of every caller."""
        try:
            return os.listdir(d)
        except OSError:
            logger.warning("G4 listing failed for %s (partial view)", d)
            return []

    def keys(self) -> Iterable[int]:
        for sub in self._listdir(self.dir):
            d = os.path.join(self.dir, sub)
            if not os.path.isdir(d):
                continue
            for name in self._listdir(d):
                # legacy 16-char blobs are invisible here; sweep() reaps
                # them
                if len(name) == 32 and ".tmp" not in name:
                    try:
                        yield int(name, 16)
                    except ValueError:
                        continue
