"""The mocker: a simulated engine and its worker, a copy of
dynamo_tpu/mocker/ (host only; no device, no kernel)."""

from .engine import MockEngine, MockEngineArgs
from .worker import MockerWorker

__all__ = ["MockEngine", "MockEngineArgs", "MockerWorker"]
