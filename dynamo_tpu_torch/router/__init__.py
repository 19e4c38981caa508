"""The KV router: KV event publication (the worker's half) and the
frontend's KV-aware instance selection, copies of dynamo_tpu/router/."""

from .events import KvCacheEvent, KvEventPublisher, kv_event_subject
from .indexer import PyKvIndexer, make_indexer
from .kv_router import KvRouter, make_kv_route_factory
from .selector import DefaultWorkerSelector, KvRouterConfig, WorkerState
from .sequences import ActiveSequences

__all__ = [
    "ActiveSequences",
    "DefaultWorkerSelector",
    "KvCacheEvent",
    "KvEventPublisher",
    "KvRouter",
    "KvRouterConfig",
    "PyKvIndexer",
    "WorkerState",
    "kv_event_subject",
    "make_indexer",
    "make_kv_route_factory",
]
