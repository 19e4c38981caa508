"""The profiler toggles and the CUDA graph replays exclude each other.

On the H100, /debug/profile hung with torch.profiler's stop on the event
loop and a decode program's graph.replay() on the scheduler thread both
stuck (CUPTI deadlocks a profiler toggle against a concurrent graph
launch).  device.PROFILER_GRAPH_LOCK is held around the status server's
profiler start and stop (runtime/system_status.py _capture_trace) and
around every replay of the decode, packed-prefill and guided programs
(engine/graphs.py).  On the CPU no graph is captured, so the replays are
played by stand-ins installed where the captured graphs would be.
"""

import asyncio
from pathlib import Path

import torch

from dynamo_tpu_torch.device import PROFILER_GRAPH_LOCK
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.runtime import system_status


class _Graph:
    """A captured graph's stand-in: records whether the lock was held
    while it replayed."""

    def __init__(self, seen: list):
        self.seen = seen

    def replay(self):
        self.seen.append(PROFILER_GRAPH_LOCK.locked())


def test_every_graph_replay_holds_the_lock():
    eng = TorchEngine(EngineConfig(model="tiny", block_size=16,
                                   num_blocks=64, max_blocks_per_seq=8,
                                   max_num_seqs=2, prefill_buckets=(16, 32)),
                      device="cpu")
    eng.warmup_decode()
    seen: list = []
    for progs, key in ((eng.graphs, (True, 1)), (eng.prefill_graphs, 16),
                       (eng.guided_graphs, eng.GUIDED_TOPM)):
        assert key in progs.counts  # built by warm-up, eagerly
        progs._graphs[key] = _Graph(seen)
        progs._graph_launches[key] = []
        args = key if isinstance(key, tuple) else (key,)
        progs.run(*args)
    assert seen == [True, True, True]
    assert not PROFILER_GRAPH_LOCK.locked()


async def test_profiler_starts_and_stops_under_the_lock(monkeypatch,
                                                       tmp_path):
    calls = []

    class _Profile:
        def __init__(self, activities):
            pass

        def start(self):
            calls.append(("start", PROFILER_GRAPH_LOCK.locked()))

        def stop(self):
            calls.append(("stop", PROFILER_GRAPH_LOCK.locked()))

        def export_chrome_trace(self, path):
            Path(path).write_text("{}")

    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = asyncio.create_task(
        system_status._capture_trace(str(tmp_path), 0.2))
    await asyncio.sleep(0.1)
    # inside the capture window replays are free to run
    calls.append(("window", PROFILER_GRAPH_LOCK.locked()))
    backend, path = await task
    assert backend == "cpu" and path.endswith("trace.json")
    assert calls == [("start", True), ("window", False), ("stop", True)]
    assert not PROFILER_GRAPH_LOCK.locked()
