"""The port's forensics plane against the JAX package's (CPU).

* `ForensicsPlane` fed the same finishes (seeded records: TTFT, ITL,
  outcomes, models, worker stamps, SLO targets) gives JAX's rankings
  (slowest K by TTFT and by ITL, the fastest evicted first), counts,
  breaches, realized overlap, `worst` and `dump` (times aside); window
  rotation evicts the oldest window alike; a breach pins the flight
  recorder's spans of its own trace; `/debug/state`'s tail line and the
  `dynamo_frontend_realized_overlap_ratio` gauge follow.
* The port's `HttpService` keeps the plane by default and registers its
  dump as the `frontend:{id}` source of `/debug/requests` (served by the
  runtime's status server, token-gated), unregistering it at close;
  `DYN_FORENSICS=0` turns off both the plane and the hop timeline.
"""

import time
import types
import uuid

import aiohttp
import numpy as np
import pytest

from dynamo_tpu import obs as jax_obs
from dynamo_tpu.obs.forensics import ForensicsPlane as JaxPlane
from dynamo_tpu.obs.slo import SloConfig as JaxSloConfig
from dynamo_tpu.runtime.metrics import MetricsHierarchy as JaxMetrics
from dynamo_tpu_torch import obs
from dynamo_tpu_torch.obs.forensics import SCHEMA, ForensicsPlane
from dynamo_tpu_torch.obs.slo import SloConfig
from dynamo_tpu_torch.runtime.metrics import MetricsHierarchy

STUB = types.SimpleNamespace(trace_id=None)


def mk_record(rid, ttft=10.0, itl=None, e2e=100.0, outcome="ok",
              model="m", cached=None, input_tokens=10):
    req = {"request_id": rid, "model": model, "outcome": outcome,
           "total_time_ms": e2e, "input_tokens": input_tokens}
    if ttft is not None:
        req["ttft_ms"] = ttft
    if itl is not None:
        req["avg_itl_ms"] = itl
    timeline = {"hops": [{"hop": "received", "t_ms": 0.0},
                         {"hop": "dispatched", "t_ms": 1.0},
                         {"hop": "first_token", "t_ms": ttft or 1.0}],
                "stall_ms": 0.0}
    if cached is not None:
        timeline["worker"] = {"cached_tokens": cached}
    return {"schema": "dynamo.request.trace.v1", "request": req,
            "timeline": timeline}


def _records(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        outcome = rng.choice(["ok"] * 8 + ["error", "no_first_token"])
        ttft = None if outcome == "no_first_token" else \
            float(np.round(rng.uniform(1, 400), 3))
        itl = None if rng.random() < 0.2 else \
            float(np.round(rng.uniform(0.5, 40), 3))
        cached = None if rng.random() < 0.3 else int(rng.integers(0, 64))
        out.append(mk_record(f"r{i}", ttft=ttft, itl=itl,
                             e2e=float(np.round(rng.uniform(100, 900), 3)),
                             outcome=str(outcome),
                             model=str(rng.choice(["m", "n"])),
                             cached=cached,
                             input_tokens=int(rng.integers(8, 128))))
    return out


def _untimed(d):
    if isinstance(d, dict):
        return {k: _untimed(v) for k, v in d.items() if k != "ts_unix"}
    if isinstance(d, list):
        return [_untimed(v) for v in d]
    return d


def _gauge(metrics, name):
    for line in metrics.render().decode().splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_plane_matches_jax_on_the_same_finishes(seed, k):
    pm = MetricsHierarchy().scoped(component="frontend")
    jm = JaxMetrics().scoped(component="frontend")
    ours = ForensicsPlane(pm, slo_config=SloConfig(ttft_ms=200.0,
                                                   itl_ms=20.0), k=k)
    theirs = JaxPlane(jm, slo_config=JaxSloConfig(ttft_ms=200.0,
                                                  itl_ms=20.0), k=k)
    for rec in _records(seed):
        ours.observe_finish(STUB, rec)
        theirs.observe_finish(STUB, rec)
    assert _untimed(ours.dump()) == _untimed(theirs.dump())
    assert ours.dump()["schema"] == SCHEMA == "dynamo.forensics.v1"
    assert ours.counts() == theirs.counts()
    assert ours.realized_overlap() == theirs.realized_overlap()
    for key in ("ttft", "itl"):
        for model in (None, "m", "n"):
            a, b = ours.worst(key, model), theirs.worst(key, model)
            assert (a is None) == (b is None)
            if a is not None:
                assert _untimed(a.to_dict()) == _untimed(b.to_dict())
    ratio = _gauge(pm, "dynamo_frontend_realized_overlap_ratio")
    assert ratio == pytest.approx(_gauge(
        jm, "dynamo_frontend_realized_overlap_ratio"), abs=1e-9)
    ro = ours.realized_overlap()
    assert ratio == pytest.approx(ro["realized_tokens"] / ro["input_tokens"],
                                  abs=1e-9)


def test_slowest_k_kept_fastest_evicted():
    plane = ForensicsPlane(k=3, window_s=600.0)
    for rid, ttft in (("a", 10.0), ("b", 30.0), ("c", 20.0),
                      ("d", 40.0), ("e", 5.0)):
        plane.observe_finish(STUB, mk_record(rid, ttft=ttft, itl=ttft / 10))
    (w,) = plane._windows.values()
    assert [e.request_id for e in w["m"]["ttft"]] == ["d", "b", "c"]
    plane.observe_finish(STUB, mk_record("f", ttft=25.0))
    assert [e.request_id for e in w["m"]["ttft"]] == ["d", "b", "f"]
    assert plane.counts() == {"exemplars": 4, "breaches": 0}


def test_window_rotation_evicts_the_oldest_alike():
    planes = [ForensicsPlane(k=2, window_s=0.05, max_windows=2),
              JaxPlane(k=2, window_s=0.05, max_windows=2)]
    firsts = []
    for plane in planes:
        plane.observe_finish(STUB, mk_record("w0", ttft=10.0))
        firsts.append(next(iter(plane._windows)))
    for rid in ("w1", "w2"):
        time.sleep(0.06)
        for plane in planes:
            plane.observe_finish(STUB, mk_record(rid, ttft=10.0))
    for plane, first in zip(planes, firsts):
        assert len(plane._windows) == 2 and first not in plane._windows
    assert [e["request_id"] for w in planes[0].dump()["models"]["m"]
            for e in w["ttft"]] == ["w1", "w2"]


def test_breach_pins_its_own_trace_spans_alike():
    tid = "ab" * 16
    got = []
    for plane, o in ((ForensicsPlane(slo_config=SloConfig(ttft_ms=1.0)),
                      obs),
                     (JaxPlane(slo_config=JaxSloConfig(ttft_ms=1.0)),
                      jax_obs)):
        with o.Tracer(ring=256):
            t0 = o.begin()
            o.end("worker_request", t0, trace_id=tid, request_id="b1")
            t0 = o.begin()
            o.end("request", t0, trace_id="ff" * 16)
            plane.observe_finish(types.SimpleNamespace(trace_id=tid),
                                 mk_record("b1", ttft=500.0))
        (w,) = plane._windows.values()
        (b,) = list(w["m"]["breach"])
        got.append((b.breach, [s["kind"] for s in b.spans]))
    assert got[0] == got[1] == ("ttft", ["worker_request"])


async def test_service_keeps_the_plane_and_serves_debug_requests(
        monkeypatch):
    from dynamo_tpu_torch.frontend.request_trace import RequestTracker
    from dynamo_tpu_torch.frontend.service import HttpService, ModelManager
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    token = "forensics-token"
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc", system_port=-1,
        admin_token=token), cluster_id=uuid.uuid4().hex).start()
    try:
        svc = await HttpService(rt, ModelManager(), host="127.0.0.1",
                                port=0).start()
        name = f"frontend:{svc._fleet_instance_id}"
        assert svc.forensics is not None and name in rt.forensics_sources
        # one finished request through the tracker feeds the plane
        tr = RequestTracker(request_id="q1", model="m",
                            forensics=svc.forensics, slo=svc.slo_plane)
        tr.on_dispatch(1)
        tr.on_tokens(2)
        tr.finish(finish_reason="stop")
        state = svc.debug_state()
        assert state["tail"]["exemplars"] == 1
        url = f"http://{rt.system_address}/debug/requests"
        async with aiohttp.ClientSession() as s:
            async with s.get(url) as r:
                assert r.status in (401, 403)
            async with s.get(url, headers={"X-Dyn-Admin-Token": token}) as r:
                assert r.status == 200
                body = await r.json()
        dump = body["sources"][name]
        assert dump["schema"] == SCHEMA and dump["exemplars"] == 1
        ex = dump["models"]["m"][0]["ttft"][0]
        assert ex["request_id"] == "q1"
        assert [h["hop"] for h in ex["record"]["timeline"]["hops"]][0] \
            == "received"
        await svc.close()
        assert name not in rt.forensics_sources
        monkeypatch.setenv("DYN_FORENSICS", "0")
        off = HttpService(rt, ModelManager(), host="127.0.0.1", port=0)
        assert off.forensics is None
        tr = RequestTracker(request_id="q2", model="m",
                            timeline_on=off.forensics is not None)
        rec = tr.finish(finish_reason="stop")
        assert "timeline" not in rec
    finally:
        await rt.shutdown()
