from .hashing import (
    DEFAULT_BLOCK_SIZE,
    PositionalLineageHash,
    compute_block_hashes,
    compute_block_hashes_for_request,
    request_salt,
    local_block_hash,
)
from .blocks import TokenBlock, TokenBlockSequence, UniqueBlock

__all__ = [
    "DEFAULT_BLOCK_SIZE",
    "PositionalLineageHash",
    "compute_block_hashes",
    "compute_block_hashes_for_request",
    "request_salt",
    "local_block_hash",
    "TokenBlock",
    "TokenBlockSequence",
    "UniqueBlock",
]
