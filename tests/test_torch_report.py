"""The port's trace report (`dynamo_tpu_torch.obs.report`) against the
JAX package's (CPU).

Exact equality is the tolerance: the report is host arithmetic over
JSON documents, so one set of dumps must reduce to the same document
through both packages.  The dumps are a port trace (TorchEngine serving
with the tracer on), a JAX trace (JaxEngine, the same requests), a KV
ledger dump of the port's engine, a forensics dump of the port's plane
and a planner debug-state dump of the port's planner whose spawns fail
under the chaos plane.  Each goes through both `report_paths` alone and
all together, and through both CLIs with the roofline peaks; random
nested span sets go through both self-time sweeps; a live mocker run's
trace meets the report's 95% bar.
"""

import asyncio
import contextlib
import io
import json
import subprocess
import sys
import uuid

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import dynamo_tpu.obs.report as jax_report
import dynamo_tpu_torch.obs.report as port_report
from dynamo_tpu import obs as jax_obs
from dynamo_tpu_torch import obs

PEAKS = ["--peak-tflops", "989", "--peak-hbm-gbps", "3350"]


async def _planner_dump():
    """A port planner whose spawns fail (connector.spawn): its
    debug_state carries decisions and the governor's breaker."""
    from dynamo_tpu_torch import chaos
    from dynamo_tpu_torch.planner import (
        CallbackConnector,
        Planner,
        PlannerConfig,
        SpawnGovernor,
    )
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    try:
        async def spawn():
            raise AssertionError("unreachable: chaos fails first")

        async def stop(w):
            pass

        conn = CallbackConnector(spawn, stop, governor=SpawnGovernor(
            backoff_base_s=0.01, backoff_max_s=0.02, breaker_threshold=3,
            breaker_reset_s=30.0))
        pl = Planner(rt, "dynamo", "mocker", conn,
                     config=PlannerConfig(min_replicas=2, max_replicas=4,
                                          cooldown_s=0.0, quarantine=False))
        await pl.observer.start()
        with chaos.ChaosPlane(seed=2).rule("connector.spawn", "fail"):
            for _ in range(6):
                await pl.tick()
                await asyncio.sleep(0.03)
        state = pl.debug_state()
        await pl.close()
        await conn.close()
        return state
    finally:
        await rt.shutdown()


async def _serve(eng, jax_side, tag, n=16):
    """The four prompts sent at once: a busy engine, as the report's bar
    assumes (a parked scheduler between arrivals is idle)."""
    from test_torch_overlap import PROMPTS, SAMPLING, _collect, _req

    try:
        return await asyncio.gather(*[
            _collect(eng, _req(jax_side, p, f"{tag}{i}", n, s))
            for i, (p, s) in enumerate(zip(PROMPTS, SAMPLING))])
    finally:
        await eng.close()


async def _make_dumps(root):
    from test_torch_forensics import STUB, _records
    from test_torch_overlap import jax_engine, torch_engine

    from dynamo_tpu_torch.obs.forensics import ForensicsPlane

    paths = {}
    for name, mod, make, jax_side in (("jax_trace", jax_obs, jax_engine,
                                       True),
                                      ("port_trace", obs, torch_engine,
                                       False)):
        tr = mod.Tracer(out_path=str(root / f"{name}.json")).install()
        eng = make()
        if not jax_side:
            ledger = eng.kv_ledger
        try:
            await _serve(eng, jax_side, name)
        finally:
            tr.uninstall()
        paths[name] = tr.dump()
    ledger.finish_audit(ledger.audit_allocator(eng.allocator, []),
                        where="test")
    paths["kv_ledger"] = str(root / "kv.json")
    with open(paths["kv_ledger"], "w") as f:
        json.dump(ledger.dump(), f)
    plane = ForensicsPlane(k=3)
    for rec in _records(5):
        plane.observe_finish(STUB, rec)
    paths["forensics"] = str(root / "forensics.json")
    with open(paths["forensics"], "w") as f:
        json.dump(plane.dump(), f)
    paths["planner"] = str(root / "planner.json")
    with open(paths["planner"], "w") as f:
        json.dump(await _planner_dump(), f)
    return paths


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    return asyncio.run(_make_dumps(tmp_path_factory.mktemp("dumps")))


@pytest.mark.parametrize("which", ["jax_trace", "port_trace", "kv_ledger",
                                   "forensics", "planner", "all"])
def test_report_paths_equal_jax(dumps, which):
    paths = list(dumps.values()) if which == "all" else [dumps[which]]
    ours = port_report.report_paths(paths, 989.0, 3350.0)
    assert ours == jax_report.report_paths(paths, 989.0, 3350.0)
    section = {"kv_ledger": "kv", "forensics": "tail",
               "planner": "actuation"}.get(which)
    if section is not None:
        assert ours[section]
    if which == "all":
        assert {"gap", "roofline", "kv", "tail", "actuation"} <= set(ours)


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_cli_output_equal_jax(dumps):
    argv = [*dumps.values(), *PEAKS, "--indent", "0"]
    ours = _cli(port_report.main, argv)
    assert ours == _cli(jax_report.main, argv)
    rep = json.loads(ours)
    assert rep["actuation"]["spawn"]["breaker_open"] is True


def test_module_runs_as_a_script(dumps):
    """`python -m dynamo_tpu_torch.obs.report` imports no JAX and prints
    the same document."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv[0] = 'report'; "
         "runpy.run_module('dynamo_tpu_torch.obs.report', "
         "run_name='__main__'); ",
         dumps["port_trace"], *PEAKS, "--indent", "0"],
        capture_output=True, text=True, timeout=60, check=False)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == jax_report.report_paths(
        [dumps["port_trace"]], 989.0, 3350.0)
    check = subprocess.run(
        [sys.executable, "-c",
         "import sys, dynamo_tpu_torch.obs.report; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'dynamo_tpu')))"],
        capture_output=True, text=True, timeout=60, check=True)
    assert check.stdout.strip() == "[]"


def test_port_trace_partition_and_roofline(dumps, tmp_path):
    """The port's report on the port's own recordings: the attributed
    phases of a live mocker run (steps on the event loop, as JAX's
    test_obs_trace.py runs it) explain at least 95% of the engine's wall
    time, the bar the report documents; the TorchEngine trace's
    partition sums to its wall, and its roofline has a prefill row and a
    costed decode row with MFU and MBU (a prefill dispatch is costed
    only where a device sync landed in its gap, which one packed
    dispatch of four prompts need not have)."""
    from dynamo_tpu_torch.mocker import MockEngine, MockEngineArgs
    from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions

    async def live():
        eng = MockEngine(MockEngineArgs(model_name="m", block_size=4,
                                        base_step_s=0.002))
        reqs = [PreprocessedRequest(
            token_ids=list(range(30 + i)), request_id=f"r{i}",
            stop=StopConditions(max_tokens=20, ignore_eos=True))
            for i in range(3)]

        async def drive(req):
            async for _ in eng.generate(req):
                pass

        await asyncio.gather(*(drive(r) for r in reqs))
        await eng.close()

    tr = obs.Tracer(out_path=str(tmp_path / "live.json")).install()
    try:
        asyncio.run(live())
        path = tr.dump()
    finally:
        tr.uninstall()
    fr = port_report.report_paths([path])["gap"]["wall_fractions"]
    assert abs(sum(fr.values()) - 1.0) < 0.01
    assert sum(v for k, v in fr.items() if k != "idle") >= 0.95, fr
    rep = port_report.report_paths([dumps["port_trace"]], 989.0, 3350.0)
    assert abs(sum(rep["gap"]["wall_fractions"].values()) - 1.0) < 0.01
    phases = rep["roofline"]["phases"]
    assert phases["prefill"]["dispatches"] > 0, phases
    row = phases["decode"]
    assert row["dispatches"] >= row["costed_dispatches"] > 0, row
    assert row["mfu"] > 0 and row["mbu"] > 0, row
    compiles = rep["roofline"]["compiles"]
    assert compiles and all(c["flops"] > 0 for c in compiles.values())


_SPAN = st.tuples(st.integers(0, 2), st.floats(0, 100), st.floats(0, 40),
                  st.sampled_from(["step", "sched", "decode_dispatch",
                                   "device_wait"]))


@settings(max_examples=80, deadline=None)
@given(spans=st.lists(_SPAN, max_size=12))
def test_self_times_and_report_equal_jax(spans):
    """Any span set, nested or jittered, gets the same self times and
    the same report from both packages."""
    events = [{"name": name, "track": f"svc:1/sched:{t}", "ts": ts,
               "dur": dur, "args": {}} for t, ts, dur, name in spans]
    assert port_report._self_times(events) == \
        jax_report._self_times(events)
    assert port_report.report(events, 1.0, 1.0) == \
        jax_report.report(events, 1.0, 1.0)
