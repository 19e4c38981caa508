"""The profiler: `profile.py` sweeps an engine's (ISL, concurrency) grid
into the PerfProfile the SLA planner plans against (planner/
perf_model.py); `python -m dynamo_tpu_torch.profiler` runs it on the
port's TorchEngine.  A copy of dynamo_tpu/profiler/."""

from .profile import PerfPoint, PerfProfile, profile_engine

__all__ = ["PerfPoint", "PerfProfile", "profile_engine"]
