"""Canonical block-identity hashing: the PositionalLineageHash (PLH) contract.

A copy of dynamo_tpu/tokens/hashing.py, kept byte-for-byte in behaviour:
the port's block hashes must equal the JAX package's so KV events and
router overlap scores mean the same thing for either engine
(tests/test_torch_engine.py checks it).

This is the single source of truth for mapping a token sequence to KV-block
identities, shared by the engine (paged cache registration), the KV router
(radix indexer), the mocker (prefix-cache simulation) and the KV block manager
(dedup registry).  Keeping one implementation used by every subsystem is the
lesson the reference learned the hard way (its kvbm-consolidator exists to
reconcile divergent hash streams) — see reference lib/kv-hashing/src/lib.rs:2-8
and lib/tokens/src/lib.rs:539.

Definition (128-bit, lineage-carrying, position-dependent):

    plh[0]  = H(salt || lora_hash || tokens[0:B])
    plh[i]  = H(plh[i-1] || tokens[i*B:(i+1)*B])

where H is BLAKE2b-128 and B is the block size.  Because each hash chains its
parent, equality of plh[i] implies equality of the *entire* token prefix up to
block i, so a flat hash-set lookup is equivalent to a radix-tree prefix walk —
the property the router indexer relies on.

Only FULL blocks get a PLH; a trailing partial block is identified by a UUID
(see blocks.UniqueBlock) and never shared across requests.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Sequence

DEFAULT_BLOCK_SIZE = 64

# A PLH is represented as a Python int in [0, 2**128).
PositionalLineageHash = int

_HASH_BYTES = 16


def _h(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=_HASH_BYTES).digest(), "little"
    )


def _tokens_to_bytes(tokens: Sequence[int]) -> bytes:
    # uint32 little-endian, matching the wire encoding of token ids.
    return b"".join(int(t).to_bytes(4, "little", signed=False) for t in tokens)


def local_block_hash(tokens: Sequence[int]) -> int:
    """Content-only (lineage-free) hash of one block's tokens.

    Used where block *content* identity matters irrespective of position
    (ref: lib/kv-router LocalBlockHash).
    """
    return _h(b"lbh\x00" + _tokens_to_bytes(tokens))


def compute_block_hashes(
    tokens: Sequence[int],
    block_size: int = DEFAULT_BLOCK_SIZE,
    *,
    parent: Optional[PositionalLineageHash] = None,
    salt: bytes = b"",
) -> list[PositionalLineageHash]:
    """PLHs for every *full* block of ``tokens``.

    ``parent`` continues an existing lineage (e.g. hashing a continuation of
    an already-hashed prefix).  The trailing partial block (len < block_size)
    is ignored.
    """
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    out: list[PositionalLineageHash] = []
    prev = parent
    n_full = len(tokens) // block_size
    for i in range(n_full):
        chunk = tokens[i * block_size : (i + 1) * block_size]
        if prev is None:
            data = b"plh\x00" + salt + b"\x00" + _tokens_to_bytes(chunk)
        else:
            data = prev.to_bytes(_HASH_BYTES, "little") + _tokens_to_bytes(chunk)
        prev = _h(data)
        out.append(prev)
    return out


def request_salt(lora_name: Optional[str] = None,
                 media_hashes: Optional[Sequence[str]] = None) -> bytes:
    """THE canonical hashing salt for a request: LoRA adapter + multimodal
    media hashes.  Every component that derives block hashes (engines,
    router, frontend overlap probe) must build its salt here, or identical
    placeholder tokens with different adapters/media would alias in the
    prefix cache."""
    parts = [lora_name or ""]
    if media_hashes:
        parts.extend(media_hashes)
    if len(parts) == 1 and not parts[0]:
        return b""
    # length-prefix each component so the salt is injective in its
    # inputs: adapter "a|b" must never alias adapter "a" + media "b"
    out = bytearray()
    for p in parts:
        enc = p.encode()
        out += len(enc).to_bytes(4, "little") + enc
    return bytes(out)


def compute_block_hashes_for_request(
    token_ids: Sequence[int],
    block_size: int = DEFAULT_BLOCK_SIZE,
    *,
    lora_name: Optional[str] = None,
    media_hashes: Optional[Sequence[str]] = None,
) -> list[PositionalLineageHash]:
    """The Request→Vec<PLH> contract (ref: lib/kv-hashing/src/lib.rs:2-14).

    Pure computation, no I/O.  ``lora_name`` and ``media_hashes`` namespace
    the lineage so KV from different adapters/media never aliases.
    """
    return compute_block_hashes(
        token_ids, block_size,
        salt=request_salt(lora_name, media_hashes))


def prefix_overlap_blocks(
    request_hashes: Sequence[PositionalLineageHash],
    have: Iterable[PositionalLineageHash] | set,
) -> int:
    """Longest prefix (in blocks) of ``request_hashes`` contained in ``have``.

    Because PLHs chain their lineage, membership of hash i implies the whole
    prefix matches; we still walk front-to-back so a missing early block stops
    the count (evictions can leave holes in an index).
    """
    have_set = have if isinstance(have, (set, frozenset, dict)) else set(have)
    n = 0
    for h in request_hashes:
        if h in have_set:
            n += 1
        else:
            break
    return n
