"""Token-block sequence bookkeeping (ref: lib/tokens/src/blocks.rs:10-23).

A copy of dynamo_tpu/tokens/blocks.py (the port imports nothing of the
JAX package).

A request's token stream is partitioned into fixed-size blocks.  Full blocks
carry a PositionalLineageHash and are shareable; the trailing partial block is
identified by a UUID and private to its request.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

from .hashing import (
    DEFAULT_BLOCK_SIZE,
    PositionalLineageHash,
    compute_block_hashes,
)


@dataclass(frozen=True)
class UniqueBlock:
    """Identity of one KV block: full (PLH) or partial (UUID)."""

    hash: Optional[PositionalLineageHash] = None
    uid: Optional[str] = None

    @staticmethod
    def full(h: PositionalLineageHash) -> "UniqueBlock":
        return UniqueBlock(hash=h)

    @staticmethod
    def partial() -> "UniqueBlock":
        return UniqueBlock(uid=uuid.uuid4().hex)

    @property
    def is_full(self) -> bool:
        return self.hash is not None

    def key(self) -> Union[int, str]:
        return self.hash if self.hash is not None else self.uid  # type: ignore


@dataclass
class TokenBlock:
    tokens: List[int]
    ident: UniqueBlock

    @property
    def is_full(self) -> bool:
        return self.ident.is_full


class TokenBlockSequence:
    """Incrementally maintains blocks + PLHs as tokens are appended.

    Appending is O(1) amortized: the lineage hash chains from the last full
    block, so completing a block hashes only that block's tokens.
    """

    def __init__(
        self,
        tokens: Sequence[int] = (),
        block_size: int = DEFAULT_BLOCK_SIZE,
        salt: bytes = b"",
    ):
        self.block_size = block_size
        self.salt = salt
        self._tokens: List[int] = []
        self._hashes: List[PositionalLineageHash] = []
        self.extend(tokens)

    # -- mutation ---------------------------------------------------------
    def append(self, token: int) -> Optional[PositionalLineageHash]:
        """Append one token; returns the PLH of a block it completed, if any."""
        self._tokens.append(int(token))
        if len(self._tokens) % self.block_size == 0:
            start = len(self._tokens) - self.block_size
            parent = self._hashes[-1] if self._hashes else None
            (h,) = compute_block_hashes(
                self._tokens[start:], self.block_size, parent=parent, salt=self.salt
            )
            self._hashes.append(h)
            return h
        return None

    def extend(self, tokens: Sequence[int]) -> List[PositionalLineageHash]:
        completed = []
        for t in tokens:
            h = self.append(t)
            if h is not None:
                completed.append(h)
        return completed

    # -- views ------------------------------------------------------------
    @property
    def tokens(self) -> List[int]:
        return self._tokens

    @property
    def block_hashes(self) -> List[PositionalLineageHash]:
        """PLHs of all full blocks, in order."""
        return self._hashes

    @property
    def num_full_blocks(self) -> int:
        return len(self._hashes)

    @property
    def num_blocks(self) -> int:
        """Total blocks incl. trailing partial."""
        return (len(self._tokens) + self.block_size - 1) // self.block_size

    def partial_len(self) -> int:
        return len(self._tokens) % self.block_size

    def __len__(self) -> int:
        return len(self._tokens)
