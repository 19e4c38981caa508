"""The port's planner against the JAX package's (CPU).

Decisions: the same inputs go to both packages and must give the same
outputs, case by case (parametrized):

* the three predictors on the same series;
* `Planner.tick` scenarios on scripted load, SLO, fleet and profile
  inputs (bounds, cooldown and down-hysteresis, KV pressure, the hold
  under telemetry loss, scale to zero, SLA proposals from one profile,
  burn actuation by phase, the quarantine's hold on scale-down, the
  spawn governor's diag and breaker, an EXECUTE that moves nothing):
  every tick's result, diag, decision and connector call;
* `SpawnGovernor` backoff and breaker on a fake clock;
* `StragglerQuarantine` mark, hold, probe and readmit on each package's
  MemDiscovery: actions, withdrawn keys and markers;
* the observers' aggregates on the same published samples.

Then live: the port's planner with a `CallbackConnector` over tiny fp32
TorchEngineWorkers scales a CPU fleet from 1 to 2 under a closed loop
of requests (the new worker takes requests), and its drain-gated
scale-down during live streams keeps every stream token-identical to
the fault-free run (the victim's streams migrate by token replay, its
drain grace 0); `KubernetesConnector` sends the JAX connector's
requests to a loopback fake API server; the CLI takes JAX's flags.
"""

import asyncio
import importlib
import json
import time
import uuid

import pytest
import torch

import dynamo_tpu.planner as jax_planner
import dynamo_tpu.planner.metrics as jax_metrics
import dynamo_tpu.profiler as jax_profiler
import dynamo_tpu.runtime.discovery as jax_discovery
import dynamo_tpu_torch.planner as port_planner
import dynamo_tpu_torch.planner.metrics as port_metrics
import dynamo_tpu_torch.profiler as port_profiler
import dynamo_tpu_torch.runtime.discovery as port_discovery
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.frontend.service import ModelManager, ModelWatcher
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

# the live cycle runs CPU forwards inside the event loop
pytestmark = pytest.mark.allow_slow_callbacks

SIDES = {
    "jax": (jax_planner, jax_metrics, jax_profiler, jax_discovery),
    "port": (port_planner, port_metrics, port_profiler, port_discovery),
}
WAIT_S = 60.0


# ----------------------------- predictors --------------------------------

SERIES = {
    "ramp": [1.0, 2.0, 3.0, 4.0, 5.0],
    "spike": [0.0, 0.0, 8.0, 0.0, 0.0, 0.0],
    "noise": [3.0, 5.0, 2.0, 7.0, 4.0, 6.0, 1.0, 9.0, 3.0, 3.0, 3.0],
    "single": [5.0],
    "empty": [],
}


@pytest.mark.parametrize("window", [3, 8])
@pytest.mark.parametrize("name", ["constant", "ema", "linear"])
@pytest.mark.parametrize("series", sorted(SERIES))
def test_predictors_equal_jax(series, name, window):
    preds = {side: mods[0].make_predictor(name, window=window)
             for side, mods in SIDES.items()}
    got = {side: [p.predict()] for side, p in preds.items()}
    for v in SERIES[series]:
        for side, p in preds.items():
            p.observe(v)
            got[side].append(p.predict())
    assert got["port"] == got["jax"]
    with pytest.raises(ValueError) as port_err:
        port_planner.make_predictor("prophet")
    with pytest.raises(ValueError) as jax_err:
        jax_planner.make_predictor("prophet")
    assert str(port_err.value) == str(jax_err.value)


# ----------------------------- tick scenarios -----------------------------


class _Conn:
    """A connector that applies what it is asked (or, `stuck`, nothing),
    recording every call; `governor` is the side's SpawnGovernor."""

    def __init__(self, replicas, governor=None, stuck=False):
        self.replicas = replicas
        self.calls = []
        self.stuck = stuck
        if governor is not None:
            self.governor = governor

    async def current_replicas(self):
        return self.replicas

    async def scale(self, n):
        self.calls.append(("scale", n))
        if not self.stuck:
            self.replicas = n
        return self.replicas

    async def drain(self, n):
        self.calls.append(("drain", n))
        if not self.stuck:
            self.replicas = n
        return self.replicas


class _Fixed:
    """An observer, SLO plane or fleet whose next answer the script sets."""

    def __init__(self):
        self.value = None

    def aggregate(self):
        return self.value

    def summary(self):
        return self.value


class _Held:
    """A quarantine that holds `held` workers and acts on nothing."""

    def __init__(self, held):
        self.held = dict.fromkeys(held)

    async def reconcile(self, fs):
        return []


def _profile(mods, kv="bf16"):
    prof = mods[2].PerfProfile(model_name="synth",
                               meta={"kv_cache_dtype": kv})
    for isl in (128, 512):
        for c in (1, 2, 4, 8, 16):
            itl = 0.002 + 0.001 * c
            ttft = (0.002 + 0.00002 * isl) * (1 + 0.3 * (c - 1))
            prof.points.append(mods[2].PerfPoint(
                isl=isl, osl=32, concurrency=c, ttft_p50_s=ttft * 0.9,
                ttft_p95_s=ttft, itl_mean_s=itl * 0.95, itl_p95_s=itl,
                req_per_s=c / (ttft + 32 * itl),
                output_tok_per_s=32 * c / (ttft + 32 * itl)))
    return prof


def _load(w=0, a=0, kv=0.0, **kw):
    return dict(workers=w, active_seqs=a, mean_kv_usage=kv, **kw)


BURN_HOT = {"goodput": 0.4, "max_burn": 30.0, "burn_by_phase": {"ttft": 30.0}}
BURN_QUIET = {"goodput": 0.995, "max_burn": 0.5,
              "burn_by_phase": {"ttft": 0.5}}
FLEET = {"imbalance": 1.7, "straggler_count": 1, "kv_headroom_min": 0.25,
         "unreachable": 1, "draining": 0, "live": 3, "stragglers": [9]}

# name: (config, initial replicas, [tick inputs], options)
SCENARIOS = {
    "reconcile": (dict(min_replicas=1, max_replicas=4,
                       target_active_per_replica=2.0, max_step=2,
                       down_stable_ticks=2), 1,
                  [dict(load=_load(1, 12, 0.2))] * 3
                  + [dict(load=_load(4, 0))] * 4, {}),
    "cooldown": (dict(max_replicas=8, target_active_per_replica=2.0,
                      cooldown_s=3600.0), 1,
                 [dict(load=_load(1, 12))] * 3, {}),
    "ema_ramp": (dict(max_replicas=8, predictor="ema", predictor_window=3,
                      down_stable_ticks=1), 1,
                 [dict(load=_load(2, a)) for a in
                  (1, 3, 6, 10, 14, 6, 2, 0, 0, 0, 0)], {}),
    "linear_ramp": (dict(max_replicas=8, predictor="linear",
                         predictor_window=4, max_step=3), 1,
                    [dict(load=_load(2, a)) for a in (2, 4, 6, 8, 10)], {}),
    "kv_pressure": (dict(max_replicas=4, target_active_per_replica=4.0,
                         kv_pressure_threshold=0.8), 1,
                    [dict(load=_load(1, 2, 0.92))], {}),
    "telemetry_loss": (dict(max_replicas=4, down_stable_ticks=1), 3,
                       [dict(load=_load())] * 5, {}),
    "scale_to_zero": (dict(min_replicas=0, max_replicas=4,
                           down_stable_ticks=1, max_step=4), 2,
                      [dict(load=_load(2, 0))], {}),
    "sla_itl_ramp": (dict(mode="sla", itl_target_s=0.007, max_replicas=8,
                          max_step=8, down_stable_ticks=1), 1,
                     [dict(load=_load(2, a, 0.2, mean_isl=128))
                      for a in (4, 10, 22, 38)]
                     + [dict(load=_load(8, 0))] * 8, {"profile": "bf16"}),
    "sla_ttft_rate": (dict(mode="sla", itl_target_s=0.02,
                           ttft_target_s=0.004, max_replicas=16,
                           max_step=16), 1,
                      [dict(load=_load(1, 2, 0.1, req_per_s=r,
                                       mean_isl=128))
                       for r in (50.0, 400.0, 900.0)], {"profile": "bf16"}),
    "sla_kv_mismatch": (dict(mode="sla", itl_target_s=0.007,
                             max_replicas=8), 1,
                        [dict(load=_load(1, 9, 0.3, mean_isl=300,
                                          mean_itl_s=0.02,
                                          kv_dtypes=("int8",)))] * 2,
                        {"profile": "bf16"}),
    "burn_prefill": (dict(max_replicas=4, phase="prefill"), 1,
                     [dict(load=_load(1, 2, 0.1), slo=BURN_HOT)], {}),
    "burn_decode": (dict(max_replicas=4, phase="decode"), 1,
                    [dict(load=_load(1, 2, 0.1), slo=BURN_HOT)], {}),
    "burn_any": (dict(max_replicas=4), 1,
                 [dict(load=_load(1, 2, 0.1), slo=BURN_HOT)], {}),
    "burn_quiet": (dict(max_replicas=4, phase="prefill"), 1,
                   [dict(load=_load(1, 2, 0.1), slo=BURN_QUIET)], {}),
    "burn_at_max": (dict(max_replicas=2), 2,
                    [dict(load=_load(2, 2, 0.1),
                          slo={"goodput": 0.0, "max_burn": 99.0,
                               "burn_by_phase": {"itl": 99.0}})], {}),
    "fleet_diag": (dict(max_replicas=4), 1,
                   [dict(load=_load(1, 9), fleet=FLEET)], {}),
    "quarantine_holds_down": (dict(max_replicas=4, down_stable_ticks=1), 3,
                              [dict(load=_load(3, 0), fleet=FLEET)] * 2,
                              {"held": [7]}),
    "governor_breaker": (dict(max_replicas=4), 1,
                         [dict(load=_load(1, 12))] * 2,
                         {"governor_failures": 3}),
    "execute_moves_nothing": (dict(max_replicas=4), 1,
                              [dict(load=_load(1, 12))] * 2,
                              {"stuck": True}),
}


async def _run_scenario(mods, name):
    cfg_kw, replicas, ticks, opts = SCENARIOS[name]
    planner_mod, metrics_mod = mods[0], mods[1]
    cfg = planner_mod.PlannerConfig(**{"cooldown_s": 0.0,
                                       "predictor": "constant", **cfg_kw})
    gov = None
    if "governor_failures" in opts:
        gov = planner_mod.SpawnGovernor(breaker_threshold=3)
        for _ in range(opts["governor_failures"]):
            gov.record_failure(now=0.0)
    conn = _Conn(replicas, governor=gov, stuck=opts.get("stuck", False))
    pm = None
    if "profile" in opts:
        pm = planner_mod.PerfModel(_profile(mods, opts["profile"]))
    p = planner_mod.Planner(None, "dynamo", "backend", conn, config=cfg,
                            perf_model=pm)
    p.observer, p.slo, p.fleet = _Fixed(), _Fixed(), _Fixed()
    if "held" in opts:
        p.quarantine = _Held(opts["held"])
    out = []
    for tick in ticks:
        p.observer.value = metrics_mod.AggregateLoad(**tick["load"])
        p.slo.value = tick.get("slo")
        p.fleet.value = tick.get("fleet")
        applied = await p.tick()
        out.append((applied, dict(p.last_diag), list(conn.calls)))
    decisions = [{k: v for k, v in d.items() if k != "t"}
                 for d in p.decisions]
    return out, decisions, (pm.itl_correction if pm else None)


class _LongUptimeClock:
    """`time` as the planner and connector modules read it, on a host up
    for a million seconds: both planners start with `_last_action_t =
    0.0` and the governor scenario records its failures at 0.0, so on a
    host up for less than `cooldown_s` (or the breaker's reset) the real
    `time.monotonic()` would decide the scenario.  Everything else is
    the real `time`."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def monotonic():
        return time.monotonic() + 1e6


@pytest.mark.parametrize("name", sorted(SCENARIOS))
async def test_tick_decisions_equal_jax(name, monkeypatch):
    # only the two modules' own `time` (the asyncio loop keeps the real
    # monotonic clock)
    for mods in SIDES.values():
        for sub in ("planner", "connectors"):
            monkeypatch.setattr(importlib.import_module(
                f"{mods[0].__name__}.{sub}"), "time", _LongUptimeClock())
    jax_out = await _run_scenario(SIDES["jax"], name)
    port_out = await _run_scenario(SIDES["port"], name)
    assert port_out == jax_out
    applied = [a for a, _, _ in port_out[0]]
    assert applied != [None] * len(applied) or name in (
        "telemetry_loss", "burn_decode", "burn_quiet", "burn_at_max",
        "quarantine_holds_down", "execute_moves_nothing")


def test_sla_mode_requires_a_perf_model_alike():
    for mods in SIDES.values():
        with pytest.raises(ValueError, match="perf model"):
            mods[0].Planner(None, "ns", "c", _Conn(1), mods[0].PlannerConfig(
                mode="sla", itl_target_s=0.01))
        with pytest.raises(ValueError, match="phase"):
            mods[0].Planner(None, "ns", "c", _Conn(1),
                            mods[0].PlannerConfig(phase="both"))


# --------------------------- spawn governor -------------------------------

GOVERNOR_SCRIPTS = {
    # (op, t) steps: fail / ok / ask
    "backoff_then_breaker": [("ask", 100.0), ("fail", 100.0),
                             ("ask", 100.0), ("ask", 101.1),
                             ("fail", 101.1), ("ask", 102.0),
                             ("ask", 103.2), ("fail", 103.2),
                             ("ask", 104.0), ("ask", 113.0),
                             ("ask", 113.3), ("fail", 113.3), ("ok", 0.0),
                             ("ask", 113.4)],
    "capped_backoff": [("fail", float(t)) for t in range(8)]
    + [("ask", 7.5), ("ask", 200.0)],
    "success_resets": [("fail", 1.0), ("fail", 2.0), ("ok", 0.0),
                       ("fail", 3.0), ("ask", 3.5), ("ask", 4.1)],
}


@pytest.mark.parametrize("script", sorted(GOVERNOR_SCRIPTS))
def test_spawn_governor_equal_jax(script):
    out = {}
    for side, mods in SIDES.items():
        g = mods[0].SpawnGovernor(backoff_base_s=1.0, backoff_max_s=8.0,
                                  breaker_threshold=3, breaker_reset_s=10.0)
        seen = []
        for op, t in GOVERNOR_SCRIPTS[script]:
            if op == "fail":
                seen.append(g.record_failure(t))
            elif op == "ok":
                g.record_success()
            else:
                seen.append((g.allow(t), g.why_blocked(t)))
            seen.append((g.failures, g.failures_total, g.successes_total,
                         g.breaker_opens_total, g.not_before,
                         g.breaker_open_until))
        out[side] = seen
    assert out["port"] == out["jax"]


# ----------------------------- quarantine ---------------------------------


def _instance(iid: int, addr: str = "") -> dict:
    return {"namespace": "dynamo", "component": "backend",
            "endpoint": "generate", "instance_id": iid,
            "address": f"127.0.0.1:{iid}",
            "metadata": {"system_addr": addr} if addr else {}}


# each step: (fleet summary, seconds from the start, probe verdict)
QUARANTINE_STEPS = {
    "hold_then_readmit": [({"live": 3, "stragglers": [11]}, 0.0, None),
                          ({"live": 2, "stragglers": []}, 10.0, None),
                          ({"live": 2, "stragglers": []}, 31.0, None)],
    "probe_fails_then_passes": [({"live": 3, "stragglers": [11]}, 0.0, None),
                                ({"live": 2, "stragglers": []}, 31.0, False),
                                ({"live": 2, "stragglers": []}, 70.0, False),
                                ({"live": 2, "stragglers": []}, 95.0, False),
                                ({"live": 2, "stragglers": []}, 220.0, True)],
    "flap_doubles_hold": [({"live": 3, "stragglers": [11]}, 0.0, None),
                          ({"live": 2, "stragglers": []}, 31.0, True),
                          ({"live": 3, "stragglers": [11]}, 32.0, None),
                          ({"live": 2, "stragglers": []}, 80.0, None),
                          ({"live": 2, "stragglers": []}, 93.0, None)],
    "cap_and_last_worker": [({"live": 3, "stragglers": [11, 12]}, 0.0, None),
                            ({"live": 1, "stragglers": [13]}, 1.0, None)],
    "gone_instance": [({"live": 3, "stragglers": [99, None]}, 0.0, None)],
}


async def _quarantine_run(mods, steps):
    disc = mods[3].MemDiscovery(cluster_id=uuid.uuid4().hex)
    await disc.start()
    for iid in (11, 12, 13):
        await disc.put(f"v1/instances/dynamo/backend/generate/{iid}",
                       _instance(iid, f"127.0.0.1:{iid + 1000}"))
        await disc.put(f"v1/mdc/dynamo/m/{iid}", {"name": "m"})
    q = mods[0].StragglerQuarantine(disc, namespace="dynamo",
                                    component="backend", hold_s=30.0)
    verdict = [None]

    async def reprobe(iid):
        return verdict[0]

    q._reprobe = reprobe
    out = []
    try:
        for fs, t, ok in steps:
            verdict[0] = ok
            actions = await q.reconcile(fs, now=1000.0 + t)
            out.append((actions, sorted(await disc.get_prefix("v1/instances")),
                        sorted(await disc.get_prefix("v1/mdc")),
                        sorted((k, {f: v[f] for f in v if f != "since_unix"})
                               for k, v in (await disc.get_prefix(
                                   "v1/quarantine")).items()),
                        sorted(q.held), dict(q.strikes)))
        await q.release_all()
        out.append((sorted(await disc.get_prefix("v1")), sorted(q.held)))
    finally:
        await disc.close()
    return out


@pytest.mark.parametrize("case", sorted(QUARANTINE_STEPS))
async def test_quarantine_equal_jax(case):
    steps = QUARANTINE_STEPS[case]
    jax_out = await _quarantine_run(SIDES["jax"], steps)
    port_out = await _quarantine_run(SIDES["port"], steps)
    assert port_out == jax_out
    kinds = [a["kind"] for acts, *_ in port_out[:-1] for a in acts]
    if case == "hold_then_readmit":
        assert kinds == ["quarantine", "readmit"]
    elif case == "probe_fails_then_passes":
        assert kinds == ["quarantine", "requarantine", "requarantine",
                         "readmit"]


# ------------------------------ observers ---------------------------------


async def _observe(mods, cluster):
    runtime_mod = __import__(mods[0].__name__.split(".")[0] + ".runtime",
                             fromlist=["DistributedRuntime"])
    rt = await runtime_mod.DistributedRuntime(
        config=runtime_mod.RuntimeConfig(discovery_backend="mem",
                                         event_plane="inproc"),
        cluster_id=cluster).start()
    load = await mods[1].LoadObserver(rt, "dynamo", "backend").start()
    slo = await mods[1].SloObserver(rt, "dynamo").start()
    fpm = await mods[1].FpmObserver(rt, "dynamo", "backend").start()
    try:
        for _ in range(200):
            for w, (act, req) in {1: (3, 10), 2: (1, 4)}.items():
                await rt.event_plane.publish("load_metrics.dynamo.backend", {
                    "worker_id": w, "active_seqs": act, "kv_usage": 0.25 * w,
                    "itl_ema_s": 0.01 * w, "kv_cache_dtype": "bf16",
                    "requests_total": req, "prompt_tokens_total": 100 * req})
                await rt.event_plane.publish("load_metrics.dynamo.backend2", {
                    "worker_id": 9, "active_seqs": 50})
            for fid, phases in ((1, {"ttft": 5.0}),
                                (2, {"ttft": 2.0, "itl": 7.0})):
                await rt.event_plane.publish("slo_metrics.dynamo", {
                    "frontend_id": fid, "goodput": 0.5 * fid,
                    "burn": {"60s": max(phases.values())},
                    "burn_by_phase": phases, "requests": 10 * fid})
            await rt.event_plane.publish("fpm.dynamo.backend", {
                "worker_id": 1, "steps": [
                    {"kind": "decode", "gap_s": 0.02, "k": 4, "lanes": 2},
                    {"kind": "spec_verify", "proposed": 8, "accepted": 6}]})
            await asyncio.sleep(0.01)
            if len(load.samples) == 2 and len(slo.samples) == 2 \
                    and fpm._steps:
                break
        agg = load.aggregate()
        return ((agg.workers, agg.active_seqs, agg.mean_kv_usage,
                 agg.mean_itl_s, agg.kv_dtypes),
                slo.aggregate(), fpm.spec_acceptance())
    finally:
        for o in (load, slo, fpm):
            await o.close()
        await rt.shutdown()


async def test_observers_aggregate_alike():
    jax_out = await _observe(SIDES["jax"], uuid.uuid4().hex)
    port_out = await _observe(SIDES["port"], uuid.uuid4().hex)
    assert port_out == jax_out
    assert port_out[0][:2] == (2, 4) and port_out[0][4] == ("bf16",)
    assert port_out[1]["burn_by_phase"] == {"ttft": 5.0, "itl": 7.0}
    assert port_out[2] == 0.75


# ------------------------------ live cycle --------------------------------

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
ENGINE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7,
              overlap_scheduling=False, decode_fused_steps=1)
TOK = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
MODEL = "planner-model"
NEW_TOKENS = 48


def _greedy(rid: str, i: int) -> PreprocessedRequest:
    return PreprocessedRequest(
        token_ids=[5 + i, 6, 7, 8 + i, 9], request_id=rid,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=NEW_TOKENS, ignore_eos=True))


async def _collect(pipeline, req) -> list:
    tokens = []
    async for out in pipeline.migration.generate(req):
        assert out.finish_reason != "error", out.error
        tokens.extend(out.token_ids)
    return tokens


async def _until(pred, what: str) -> None:
    loop = asyncio.get_running_loop()
    end = loop.time() + WAIT_S
    while not pred():
        if loop.time() > end:
            raise AssertionError(f"{what} never came within {WAIT_S:.0f} s")
        await asyncio.sleep(0.02)


async def test_live_scale_up_then_drain_gated_scale_down_token_identical():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    cfg = EngineConfig(model_config=LlamaConfig(dtype=torch.float32,
                                                **SHAPES),
                       model_name=MODEL, **ENGINE)
    conn = port_planner.CallbackConnector(
        spawn=lambda: TorchEngineWorker(rt, cfg, tokenizer_cfg=TOK,
                                        device="cpu").start(),
        stop=lambda w: w.close(),
        drain=lambda w, d: w.drain(deadline_s=d),
        drain_deadline_s=0.0, drain_escalate_margin_s=5.0)
    planner = port_planner.Planner(
        rt, "dynamo", "backend", conn,
        config=port_planner.PlannerConfig(
            min_replicas=1, max_replicas=2, cooldown_s=0.0,
            down_stable_ticks=1, target_active_per_replica=1.0,
            predictor="constant"))
    manager = ModelManager()
    watcher = None
    try:
        await conn.scale(1)
        watcher = await ModelWatcher(rt, manager).start()
        await _until(lambda: manager.get(MODEL) is not None
                     and len(manager.get(MODEL).client.instances) == 1,
                     "the first worker in the frontend")
        pipeline = manager.get(MODEL)
        baseline = [await _collect(pipeline, _greedy(f"ff-{i}", i))
                    for i in range(4)]
        await planner.observer.start()  # manual ticks

        # a closed loop of three concurrent requests until the fleet grows
        grown = asyncio.Event()

        async def closed_loop(c: int) -> None:
            j = 0
            while not grown.is_set():
                await _collect(pipeline, _greedy(f"load-{c}-{j}", c))
                j += 1

        load = [asyncio.create_task(closed_loop(c)) for c in range(3)]
        end = asyncio.get_running_loop().time() + WAIT_S
        while await planner.tick() != 2:
            assert asyncio.get_running_loop().time() < end, \
                f"no scale-up within {WAIT_S:.0f} s: {planner.last_diag}"
            await asyncio.sleep(0.05)
        grown.set()
        await asyncio.gather(*load)
        assert planner.decisions[-1]["applied"] == 2
        await _until(lambda: len(pipeline.client.instances) == 2,
                     "the new worker in the frontend")
        new = conn.handles[-1]
        for i in range(4):
            await _collect(pipeline, _greedy(f"after-{i}", i))
        assert new.engine.metrics["decode_steps"] > 0, \
            "the new worker took no request"

        # scale-down with streams in flight: a low-load target, then drain
        planner.config.target_active_per_replica = 8.0
        await _until(lambda: planner.observer.aggregate().workers == 2,
                     "both workers' load samples")
        victim, survivor = conn.handles[-1], conn.handles[0]
        prompts, emitted = [], {}

        def spy(worker, note_prompts: bool) -> None:
            gen = worker.engine.generate

            async def spied(request, *a, **kw):
                if note_prompts:
                    prompts.append((request.request_id,
                                    len(request.token_ids)))
                out_ids = emitted.setdefault(
                    (id(worker), request.request_id), [])
                async for out in gen(request, *a, **kw):
                    out_ids.extend(out.token_ids)
                    yield out

            worker.engine.generate = spied

        spy(victim, False)
        spy(survivor, True)
        tasks = [asyncio.create_task(_collect(pipeline, _greedy(f"ch-{i}", i)))
                 for i in range(4)]
        await _until(lambda: any(w == id(victim) and len(ids) >= 4
                                 for (w, _), ids in emitted.items()),
                     "a stream four tokens into the newest worker")
        key = victim.served.instance.key()
        assert await planner.tick() == 1, planner.last_diag
        results = await asyncio.gather(*tasks)
        assert results == baseline
        assert key not in await rt.discovery.get_prefix("v1/instances")
        assert len(conn.handles) == 1 and conn.drain_escalations == 0
        # the drain's zero grace aborted the victim's streams: they
        # reached the survivor with their tokens so far (token replay)
        assert any(rid.startswith("ch-") and n > 5 for rid, n in prompts), \
            prompts
        kinds = [d["applied"] for d in planner.decisions]
        assert kinds == [2, 1]
    finally:
        await planner.close()
        if watcher is not None:
            await watcher.close()
        await conn.close()
        await rt.shutdown()
        torch.set_num_threads(n)


# ------------------------------ kubernetes --------------------------------


class _FakeKube:
    """A loopback API server for a Deployment's scale subresource: it
    records each request (method, path, content type, authorization,
    JSON body) and answers with the replicas last patched."""

    def __init__(self):
        self.seen = []
        self.replicas = 1

    async def start(self):
        self.server = await asyncio.start_server(self._serve, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.sockets[0].getsockname()[1]}"
        return self

    async def _serve(self, reader, writer):
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
        lines = head.split("\r\n")
        method, path, _ = lines[0].split(" ", 2)
        headers = {k.strip().lower(): v.strip() for k, v in
                   (ln.split(":", 1) for ln in lines[1:] if ":" in ln)}
        n = int(headers.get("content-length", 0))
        body = json.loads(await reader.readexactly(n)) if n else None
        self.seen.append((method, path, headers.get("content-type"),
                          headers.get("authorization"), body))
        if body is not None:
            self.replicas = body["spec"]["replicas"]
        data = json.dumps({"spec": {"replicas": self.replicas}}).encode()
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                     b"Content-Length: " + str(len(data)).encode()
                     + b"\r\nConnection: close\r\n\r\n" + data)
        await writer.drain()
        writer.close()

    async def close(self):
        self.server.close()
        await self.server.wait_closed()


async def test_kubernetes_connector_sends_jax_requests():
    from dynamo_tpu.planner.connectors import \
        KubernetesConnector as JaxKube
    from dynamo_tpu_torch.planner.connectors import KubernetesConnector

    seen = {}
    for side, cls in (("jax", JaxKube), ("port", KubernetesConnector)):
        fake = await _FakeKube().start()
        conn = cls("worker", namespace="serving", api_url=fake.url,
                   token="tok")
        try:
            got = [await conn.current_replicas(), await conn.scale(3),
                   await conn.current_replicas(), await conn.drain(2)]
        finally:
            await conn.close()
            await fake.close()
        seen[side] = (got, fake.seen)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [1, 3, 3, 2]
    assert seen["port"][1][1] == (
        "PATCH", "/apis/apps/v1/namespaces/serving/deployments/worker/scale",
        "application/merge-patch+json", "Bearer tok",
        {"spec": {"replicas": 3}})


def test_cli_takes_every_jax_flag():
    from dynamo_tpu.planner.__main__ import build_args as jax_args
    from dynamo_tpu_torch.planner.__main__ import build_args

    ours = {a.dest: (a.default, tuple(a.choices or ()))
            for a in build_args()._actions}
    theirs = {a.dest: (a.default, tuple(a.choices or ()))
              for a in jax_args()._actions}
    assert ours == theirs
