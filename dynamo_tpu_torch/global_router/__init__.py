"""Global router: the pool-level request plane above the frontends, a
copy of dynamo_tpu/global_router/ (host only; no device).  A pool is one
namespace running its own workers + frontend tier (agg or disagg); the
global router discovers pools from
the same discovery plane everything else uses, classifies each request
by (ISL, predicted TTFT) / (context length, ITL load) with the
conditional-disagg thresholds, and forwards to the chosen pool's
frontend tier.  See pools.py (discovery), policy.py (classification),
service.py (the HTTP proxy process, on the port's asyncio HTTP
server and client).
"""

from .policy import Decision, GlobalRouterConfig, PoolClassifier
from .pools import FrontendView, PoolDirectory, PoolView
from .service import GlobalRouterService

__all__ = [
    "Decision", "GlobalRouterConfig", "PoolClassifier",
    "FrontendView", "PoolDirectory", "PoolView",
    "GlobalRouterService",
]
