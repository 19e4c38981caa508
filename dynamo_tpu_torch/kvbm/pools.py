"""Physical block pools for the G2 (host memory) and G3 (disk) KV tiers.

A copy of dynamo_tpu/kvbm/pools.py whose blocks are CPU torch tensors.
Block payloads use the universal per-block layout: K and V
[n_layers, block_size, n_kv_heads, head_dim], plus the fp32 scale planes
(k_scale, v_scale) [n_layers, block_size, n_kv_heads] of an int8 cache
(quant/kv.py), half the host and disk bytes of a bf16 block.  The same
layout the disagg transfer path and ops/kv_transfer.py speak, so a block
moves device -> host -> disk -> object store -> device, or across
workers, without reinterpretation.  On CUDA each G2 block is its own
pinned tensor (engine/core.py `_maybe_offload`).

The on-disk blob is the JAX package's `.npz`: each member's bytes as a
uint8 array (a view of the tensor's bytes, last dimension scaled by the
element size), its dtype name (numpy's, "bfloat16" among them) and a
crc32 footer over the lot.  numpy has no bfloat16 without `ml_dtypes`,
which the port does not import, so the port writes and reads byte views
of torch tensors: a blob written by either package reads in the other,
with an equal footer.

Pools are plain LRU maps keyed by PLH.  They run on the engine's
scheduler thread only, so no locking.
"""

from __future__ import annotations

import fcntl
import logging
import os
import re
import zipfile
import zlib
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..disagg.transfer import dtype_name, torch_dtype

logger = logging.getLogger(__name__)

# (k, v) each [L, bs, nkv, hd], plus (k_scale, v_scale) for int8 blocks
Block = Tuple[torch.Tensor, ...]

# npz member names for the payload tuple, in order (scales optional)
_MEMBERS = ("k", "v", "ks", "vs")

# the names a G3 pool gives its own block files
_OWN_FILE = re.compile(r"^[0-9a-f]{32}\.npz$")


class BlockIntegrityError(ValueError):
    """A persisted or transferred block's payload failed its crc32 footer.

    Subclasses ValueError so catch lists that predate the checksum still
    treat a corrupt blob as unreadable, while the consume sites that care
    (G4 quarantine, remote-pull suspect marking) catch it specifically and
    attribute the corruption before degrading to a miss."""


def block_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a uint8 numpy array of its shape, the last
    dimension scaled by the element size (numpy's `.view(np.uint8)`)."""
    return t.detach().contiguous().view(torch.uint8).numpy()


def _header(name: str, t: torch.Tensor) -> bytes:
    # numpy's rendering of dtype and shape: "bfloat16", "(32, 128, 8, 128)"
    return f"{name}:{dtype_name(t.dtype)}:{tuple(t.shape)}".encode()


def block_crc(arrays: Sequence[torch.Tensor]) -> int:
    """crc32 over the payload tuple's bytes, chained per member.

    Each member contributes its ``name:dtype:shape`` header before its
    bytes, so the checksum commits to dtype and shape too: a blob whose
    dtype member was rewritten (or whose bytes were re-viewed at the
    wrong width) fails verification exactly like a flipped bit."""
    crc = 0
    for name, t in zip(_MEMBERS, arrays):
        crc = zlib.crc32(_header(name, t), crc)
        crc = zlib.crc32(block_bytes(t).reshape(-1), crc)
    return crc & 0xFFFFFFFF


def _save_block(path_or_file, arrays: Sequence[torch.Tensor]) -> None:
    """Persist byte views plus dtype names, and a ``crc`` footer
    (block_crc) that _load_block verifies at every tier-crossing
    consume."""
    payload = {}
    for name, t in zip(_MEMBERS, arrays):
        payload[name] = block_bytes(t)
        payload[name + "d"] = dtype_name(t.dtype)
    payload["crc"] = np.uint32(block_crc(arrays))
    np.savez(path_or_file, **payload)


def has_checksum(z) -> bool:
    """True when a loaded npz carries the crc footer (False = a legacy
    blob from a pre-checksum writer: read once, then re-stamp or reap)."""
    return "crc" in getattr(z, "files", z)


def _member(raw: np.ndarray, name: str) -> torch.Tensor:
    """A stored byte view back as a tensor of dtype `name`."""
    dt = torch_dtype(name)
    t = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.uint8))
    if t.dim() == 0 or t.shape[-1] % dt.itemsize:
        raise ValueError(f"{tuple(t.shape)} bytes do not view as {name}")
    return t.view(dt)


def _load_block(z, verify: bool = True) -> Block:
    files = getattr(z, "files", z)
    blk = tuple(_member(z[name], str(z[name + "d"].item()))
                for name in _MEMBERS if name in files)
    if verify and has_checksum(z) and block_crc(blk) != int(z["crc"]):
        raise BlockIntegrityError(
            "KV block payload failed its crc32 footer")
    return blk


def read_block_file(path: str) -> Tuple[Block, Optional[int]]:
    """Load one persisted block file WITHOUT verifying; returns
    ``(block, stored_crc)``, stored_crc None for a legacy blob.  Callers
    verify through verify_block."""
    with np.load(path) as z:
        blk = _load_block(z, verify=False)
        crc = int(z["crc"]) if has_checksum(z) else None
    return blk, crc


def verify_block(blk: Sequence[torch.Tensor], crc: Optional[int]) -> None:
    """Raise BlockIntegrityError when `blk` does not match its stored
    crc; a None crc (legacy blob) passes: the caller re-stamps it."""
    if crc is not None and block_crc(blk) != crc:
        raise BlockIntegrityError(
            "KV block payload failed its crc32 footer")


class HostBlockPool:
    """G2: host-memory KV block cache with LRU eviction."""

    tier = "g2"

    def __init__(self, capacity_blocks: int):
        self.capacity = capacity_blocks
        self._blocks: "OrderedDict[int, Block]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._blocks)

    def __contains__(self, h: int) -> bool:
        return h in self._blocks

    def put(self, h: int, *arrays: torch.Tensor) -> List[Tuple[int, Block]]:
        """Insert a block ((k, v) or (k, v, ks, vs)); returns LRU-evicted
        (hash, block) pairs."""
        if h in self._blocks:
            self._blocks.move_to_end(h)
            return []
        self._blocks[h] = tuple(arrays)
        evicted: List[Tuple[int, Block]] = []
        while len(self._blocks) > self.capacity:
            evicted.append(self._blocks.popitem(last=False))
        return evicted

    def get(self, h: int) -> Optional[Block]:
        blk = self._blocks.get(h)
        if blk is not None:
            self._blocks.move_to_end(h)
        return blk

    def keys(self) -> List[int]:
        """Resident hashes (the pool manifest the KV ledger's auditor
        reconciles against, kvbm/manager.py manifest)."""
        return list(self._blocks)

    def nbytes(self) -> int:
        """Payload bytes the pool holds (pinned host memory on CUDA)."""
        return sum(t.numel() * t.element_size()
                   for blk in self._blocks.values() for t in blk)

    def drop(self, h: int) -> bool:
        return self._blocks.pop(h, None) is not None

    def clear(self) -> List[int]:
        hashes = list(self._blocks)
        self._blocks.clear()
        return hashes


class DiskBlockPool:
    """G3: disk-backed KV block cache (one .npz per block, LRU by insert)."""

    tier = "g3"

    def __init__(self, directory: str, capacity_blocks: int):
        self.dir = directory
        self.capacity = capacity_blocks
        os.makedirs(directory, exist_ok=True)
        self._order: "OrderedDict[int, None]" = OrderedDict()
        # integrity and degradation hooks (set by TieredKvManager): fired
        # on a checksum-failed read (the blob already quarantined) and on
        # a raw I/O failure (feeds the g3 circuit breaker)
        self.on_corruption: Optional[Callable[[int], None]] = None
        self.on_io_error: Optional[Callable[[], None]] = None
        # exclusive ownership: two engines given the same disk_cache_dir
        # would silently destroy each other's live blocks (the wipe below,
        # plus LRU evictions); hold an flock for the pool's lifetime and
        # fail loudly instead
        self._lock_file = open(os.path.join(directory, ".lock"), "w")
        try:
            fcntl.flock(self._lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_file.close()
            raise RuntimeError(
                f"disk cache dir {directory!r} is owned by another engine "
                "(flock held); give each engine its own disk_cache_dir")
        # a fresh pool owns its block files: stale ones from a previous run
        # are untracked (no router saw stored events for them) and would
        # only leak disk.  Only the pool's own strict 32-hex-char names;
        # anything else in the directory is not ours.
        stale = [f for f in os.listdir(directory) if _OWN_FILE.match(f)]
        for f in stale:
            try:
                os.unlink(os.path.join(directory, f))
            except OSError:
                pass
        if stale:
            logger.info("G3 pool wiped %d stale block files in %s",
                        len(stale), directory)

    def _path(self, h: int) -> str:
        return os.path.join(self.dir, f"{int(h):032x}.npz")

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, h: int) -> bool:
        return h in self._order

    def put(self, h: int, *arrays: torch.Tensor) -> List[int]:
        """Persist a block; returns hashes evicted to make room.  A write
        failure (disk full, dying device) drops the block instead of
        raising into the scheduler loop."""
        if h in self._order:
            self._order.move_to_end(h)
            return []
        if not self._write(h, arrays):
            return []
        self._order[h] = None
        evicted: List[int] = []
        while len(self._order) > self.capacity:
            old, _ = self._order.popitem(last=False)
            self._unlink(old)
            evicted.append(old)
        return evicted

    def put_with_victims(
            self, h: int,
            *arrays: torch.Tensor) -> List[Tuple[int, Optional[Block]]]:
        """Like put(), but each victim's payload is read back before its
        file is deleted: the G4 spill path needs the bytes (one extra disk
        read per eviction, paid only when G4 is configured)."""
        if h in self._order:
            self._order.move_to_end(h)
            return []
        if not self._write(h, arrays):
            return []
        self._order[h] = None
        evicted: List[Tuple[int, Optional[Block]]] = []
        while len(self._order) > self.capacity:
            old = next(iter(self._order))
            blk = self.get(old)  # may drop `old` itself if unreadable
            if self._order.pop(old, None) is not None:
                self._unlink(old)
            evicted.append((old, blk))
        return evicted

    def _write(self, h: int, arrays: Sequence[torch.Tensor]) -> bool:
        try:
            _save_block(self._path(h), arrays)
        except OSError:
            logger.warning("G3 put failed for %x; dropping block", h,
                           exc_info=True)
            self._unlink(h)  # no partial file may linger
            if self.on_io_error is not None:
                self.on_io_error()
            return False
        return True

    def get(self, h: int) -> Optional[Block]:
        """Returns the block, or None.  An unreadable file is dropped from
        the pool: callers that saw `h in pool` beforehand must treat a None
        here as a G3 removal (and emit the removed event).  A checksum
        failure also unlinks the file (quarantine) and fires on_corruption,
        so the event is attributed, not just absorbed."""
        if h not in self._order:
            return None
        try:
            with np.load(self._path(h)) as z:
                blk = _load_block(z)
        except BlockIntegrityError:
            logger.warning("G3 block %x failed checksum; quarantined", h)
            self._order.pop(h, None)
            self._unlink(h)
            if self.on_corruption is not None:
                self.on_corruption(h)
            return None
        except (OSError, KeyError, ValueError, TypeError, AttributeError,
                zipfile.BadZipFile) as e:
            # BadZipFile (a torn or truncated npz) subclasses Exception
            # directly, so the ValueError family would let it escape into
            # the scheduler
            logger.warning("G3 block %x unreadable; dropping", h)
            self._order.pop(h, None)
            if isinstance(e, OSError) and self.on_io_error is not None:
                self.on_io_error()
            return None
        self._order.move_to_end(h)
        return blk

    def drop(self, h: int) -> bool:
        if self._order.pop(h, None) is None:
            return False
        self._unlink(h)
        return True

    def keys(self) -> List[int]:
        """Resident hashes (the pool manifest the KV ledger's auditor
        reconciles against, kvbm/manager.py manifest)."""
        return list(self._order)

    def _unlink(self, h: int) -> None:
        try:
            os.unlink(self._path(h))
        except OSError:
            pass

    def clear(self) -> List[int]:
        hashes = list(self._order)
        for h in hashes:
            self._unlink(h)
        self._order.clear()
        return hashes

    def close(self) -> None:
        """Release directory ownership (the flock dies with the fd)."""
        if self._lock_file is not None:
            self._lock_file.close()
            self._lock_file = None
