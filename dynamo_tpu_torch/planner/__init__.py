"""Planner: load-driven autoscaling of worker fleets, a copy of
dynamo_tpu/planner/.

The control loop is OBSERVE (windowed load metrics off the event plane,
metrics.py) → PREDICT (next-window load, predictor.py) → PROPOSE
(replica counts from per-replica capacity targets, or the SLA inversion
of a profiled perf model, perf_model.py) → RECONCILE (bounds, cooldown,
step clamp, straggler quarantine; planner.py) → EXECUTE (a connector
that changes the fleet, connectors.py: in-process TorchEngineWorkers for
tests, `python -m dynamo_tpu_torch.engine` subprocesses on one host, a
Kubernetes Deployment).  `python -m dynamo_tpu_torch.planner` runs it.
"""

from .connectors import (CallbackConnector, Connector, SpawnGovernor,
                         SubprocessConnector)
from .metrics import LoadObserver
from .perf_model import PerfModel
from .planner import Planner, PlannerConfig, StragglerQuarantine
from .predictor import make_predictor

__all__ = [
    "CallbackConnector",
    "Connector",
    "LoadObserver",
    "PerfModel",
    "Planner",
    "PlannerConfig",
    "SpawnGovernor",
    "StragglerQuarantine",
    "SubprocessConnector",
    "make_predictor",
]
