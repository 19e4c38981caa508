"""KVBM: multi-tier KV block management, a copy of dynamo_tpu/kvbm/.

Tier model:
  G1 = device memory  (the engine's paged cache, engine/block_allocator.py)
  G2 = host memory    (pools.HostBlockPool; pinned on CUDA)
  G3 = local disk     (pools.DiskBlockPool)
  G4 = shared object store (object_store.ObjectStorePool)

Blocks are keyed by PositionalLineageHash, the identity the engine,
router and events already share.  The engine offloads cold evictable G1
blocks to G2 (one batched device-to-host gather per scheduler step),
demotes G2 to G3 (and spills to G4) under pressure, and onboards G2/G3/G4
prefix hits back into device memory at admission instead of recomputing
them; kvbm/remote.py pulls a prompt's missing blocks from a peer's host
tiers.

Event consistency across tiers goes through KvEventConsolidator: routers
see one net stored/removed stream per tier.
"""

from .consolidator import KvEventConsolidator
from .manager import TieredKvManager
from .pools import DiskBlockPool, HostBlockPool

__all__ = [
    "DiskBlockPool",
    "HostBlockPool",
    "KvEventConsolidator",
    "TieredKvManager",
]
