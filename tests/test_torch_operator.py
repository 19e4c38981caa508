"""The port's graph operator (`dynamo_tpu_torch.operator`) against the
JAX package's (CPU).

* Rendering: one graph spec through both packages gives equal
  Deployment manifests once the port's deliberate divergences are
  mapped — module names (`dynamo_tpu.*` -> `dynamo_tpu_torch.*`), the
  accelerator (`tpu: n` / `google.com/tpu` -> `gpu: n` /
  `nvidia.com/gpu`) and the CPU switch (JAX's `JAX_PLATFORMS=cpu`
  environment for every component without a TPU; the port's
  `--device cpu` flag for a model-running component without a GPU).
  The spec hashes differ by construction (they hash what is rendered),
  so the hash annotation is compared for presence only.  Validation
  refuses the same specs with the same messages.
* Reconciling: both operators against tests/fake_kube.py's server pass
  JAX's tests/test_operator.py cases (create, a no-op pass, a drift
  patch that rolls and scales, a delete; a planner scale write kept
  across an unrelated pass and overridden by a spec edit; a broken spec
  that reaps nothing; a bad graph beside a good one under the run
  loop), each with the same sequence of API calls as JAX's operator
  and equal stats.
* The CLI: `python -m dynamo_tpu_torch.operator --once` converges the
  fake as the library does.
"""

import asyncio
import copy
import sys

import pytest
from fake_kube import FakeKubeApiServer

import dynamo_tpu.operator as jax_operator
import dynamo_tpu.operator.spec as jax_spec
import dynamo_tpu_torch.operator as port_operator
import dynamo_tpu_torch.operator.spec as port_spec

SIDES = {"jax": jax_operator, "port": port_operator}

# JAX's tests/test_operator.py spec, plus a CPU worker, a mocker, a
# router and an encoder so every kind and the CPU switch render
SPEC = {
    "name": "llama-fleet",
    "image": "reg/dynamo-tpu:v1",
    "model": {"name": "llama-3b", "path": "/models/llama-3b"},
    "components": {
        "frontend": {"kind": "frontend", "replicas": 2, "port": 8000},
        "decode": {"kind": "worker", "role": "decode", "replicas": 3,
                   "tpu": 1},
        "prefill": {"kind": "worker", "role": "prefill", "replicas": 2,
                    "tpu": 1},
        "planner": {"kind": "planner", "replicas": 1,
                    "args": ["--mode", "sla"]},
    },
}
EXTRA = {
    "cpu-worker": {"kind": "worker", "replicas": 1,
                   "args": ["--model", "tiny"], "env": {"DYN_X": "1"}},
    "sim": {"kind": "mocker", "replicas": 2},
    "kv-router": {"kind": "router", "replicas": 1,
                  "args": ["--block-size", "16"]},
    "encoder": {"kind": "multimodal", "replicas": 1, "tpu": 2},
}


def port_form(spec):
    """The spec as the port reads it: `gpu` where JAX's says `tpu`."""
    spec = copy.deepcopy(spec)
    for c in spec["components"].values():
        if "tpu" in c:
            c["gpu"] = c.pop("tpu")
    return spec


def spec_for(side, spec):
    return port_form(spec) if side == "port" else copy.deepcopy(spec)


def normalize(manifest, side):
    """A manifest with the divergences mapped to one form and the spec
    hash replaced by its presence."""
    m = copy.deepcopy(manifest)
    ann = m["metadata"]["annotations"]
    ann[jax_spec.HASH_ANN] = bool(ann[jax_spec.HASH_ANN])
    cont = m["spec"]["template"]["spec"]["containers"][0]
    cmd = cont["command"]
    if side == "jax":
        cmd[2] = cmd[2].replace("dynamo_tpu.", "dynamo_tpu_torch.", 1)
        cont["env"] = [e for e in cont["env"]
                       if e["name"] != "JAX_PLATFORMS"]
        limits = (cont.get("resources") or {}).get("limits") or {}
        if "google.com/tpu" in limits:
            limits["nvidia.com/gpu"] = limits.pop("google.com/tpu")
    elif "--device" in cmd:
        i = cmd.index("--device")
        assert cmd[i + 1] == "cpu"
        del cmd[i:i + 2]
    return m


def test_render_equals_jax_up_to_the_divergences():
    spec = copy.deepcopy(SPEC)
    spec["components"].update(EXTRA)
    got = {side: SIDES[side].render_deployments(
        SIDES[side].GraphSpec.parse(spec_for(side, spec)))
        for side in SIDES}
    assert set(got["port"]) == set(got["jax"]) == {
        f"llama-fleet-{c}" for c in spec["components"]}
    for name in got["port"]:
        assert normalize(got["port"][name], "port") == \
            normalize(got["jax"][name], "jax"), name
    # the divergences themselves
    cont = {n: d["spec"]["template"]["spec"]["containers"][0]
            for n, d in got["port"].items()}
    assert cont["llama-fleet-decode"]["resources"]["limits"] == {
        "nvidia.com/gpu": "1"}
    assert cont["llama-fleet-encoder"]["resources"]["limits"] == {
        "nvidia.com/gpu": "2"}
    assert cont["llama-fleet-cpu-worker"]["command"] == [
        "python", "-m", "dynamo_tpu_torch.engine", "--model-path",
        "/models/llama-3b", "--device", "cpu", "--model", "tiny"]
    assert cont["llama-fleet-kv-router"]["command"] == [
        "python", "-m", "dynamo_tpu_torch.router", "--block-size", "16"]
    assert cont["llama-fleet-frontend"]["command"][:3] == [
        "python", "-m", "dynamo_tpu_torch.frontend"]
    assert "--device" not in cont["llama-fleet-decode"]["command"]
    assert not any(e["name"] == "JAX_PLATFORMS"
                   for c in cont.values() for e in c["env"])
    # the hashes differ: they hash the rendered (diverging) templates
    ann = jax_spec.HASH_ANN
    assert got["port"]["llama-fleet-frontend"]["metadata"]["annotations"][
        ann] != got["jax"]["llama-fleet-frontend"]["metadata"][
        "annotations"][ann]
    assert port_spec.HASH_ANN == ann
    assert port_spec.REPLICAS_ANN == jax_spec.REPLICAS_ANN
    assert port_spec.GRAPH_LABEL == jax_spec.GRAPH_LABEL


@pytest.mark.parametrize("doc", [
    {"image": "x", "components": {"a": {}}},
    {"name": "g", "components": {"a": {}}},
    {"name": "g", "image": "x", "components": {"a": {"kind": "nope"}}},
    {"name": "g", "image": "x", "components": {}},
    {"name": "g", "image": "x", "components": {"a": 3}},
    [1, 2],
])
def test_spec_validation_equals_jax(doc):
    msgs = {}
    for side, mod in SIDES.items():
        with pytest.raises(ValueError) as ei:
            mod.GraphSpec.parse(copy.deepcopy(doc))
        msgs[side] = str(ei.value)
    assert msgs["port"] == msgs["jax"]


class RecordingKube(FakeKubeApiServer):
    """The fake API server, recording (method, route, query) per call."""

    def __init__(self):
        super().__init__()
        self.calls = []
        for name in ("h_dep_list", "h_dep_create", "h_dep_get",
                     "h_dep_patch", "h_dep_delete", "h_cm_list"):
            setattr(self, name, self._recording(getattr(self, name)))

    def _recording(self, handler):
        async def wrapped(request):
            self.calls.append((request.method, request.path,
                               dict(request.query),
                               request.headers.get("Content-Type", "")
                               if request.method == "PATCH" else ""))
            return await handler(request)

        return wrapped


async def _with_operator(side, body, **op_kw):
    fake = await RecordingKube().start()
    op = SIDES[side].GraphOperator(api_url=fake.endpoint, namespace="ns",
                                   **op_kw)
    try:
        out = await body(fake, op, side)
    finally:
        await op.close()
        await fake.close()
    deps = {n: normalize(d, side) for n, d in fake.deployments.items()}
    for d in deps.values():
        d["metadata"].pop("resourceVersion", None)
    return out, fake.calls, dict(op.stats), deps


async def _both(body, **op_kw):
    return {side: await _with_operator(side, body, **op_kw)
            for side in SIDES}


def _assert_equal(got):
    out, calls, stats, deps = got["port"]
    assert calls == got["jax"][1]
    assert stats == got["jax"][2]
    assert deps == got["jax"][3]
    assert out == got["jax"][0]
    return out, calls, stats, deps


async def _create_update_delete(fake, op, side):
    fake.set_graph_spec("llama-fleet", spec_for(side, SPEC))
    await op.reconcile_once()
    created = (sorted(fake.deployments), dict(op.stats))
    await op.reconcile_once()  # converged: nothing patched
    noop = dict(op.stats)
    spec2 = copy.deepcopy(SPEC)
    spec2["image"] = "reg/dynamo-tpu:v2"
    spec2["components"]["decode"]["replicas"] = 5
    del spec2["components"]["prefill"]
    fake.set_graph_spec("llama-fleet", spec_for(side, spec2))
    await op.reconcile_once()
    dec = fake.deployments["llama-fleet-decode"]
    return created, noop, dec["spec"]["replicas"], \
        dec["spec"]["template"]["spec"]["containers"][0]["image"], \
        "llama-fleet-prefill" in fake.deployments


async def test_reconcile_create_update_delete_equals_jax():
    got = await _both(_create_update_delete, interval_s=0.05)
    (created, noop, replicas, image, prefill_left), calls, stats, _ = \
        _assert_equal(got)
    assert created[0] == ["llama-fleet-decode", "llama-fleet-frontend",
                          "llama-fleet-planner", "llama-fleet-prefill"]
    assert created[1]["created"] == 4 and noop["patched"] == 0
    assert (replicas, image, prefill_left) == (5, "reg/dynamo-tpu:v2",
                                               False)
    assert stats["deleted"] == 1
    assert [c[0] for c in calls].count("POST") == 4
    assert ("PATCH", "/apis/apps/v1/namespaces/ns/deployments/"
            "llama-fleet-decode", {}, "application/merge-patch+json") \
        in calls


async def _planner_scale(fake, op, side):
    fake.set_graph_spec("llama-fleet", spec_for(side, SPEC))
    await op.reconcile_once()
    # the planner scales decode 3 -> 7 out of band
    fake.deployments["llama-fleet-decode"]["spec"]["replicas"] = 7
    await op.reconcile_once()
    kept = fake.deployments["llama-fleet-decode"]["spec"]["replicas"]
    spec2 = copy.deepcopy(SPEC)
    spec2["components"]["decode"]["replicas"] = 4
    fake.set_graph_spec("llama-fleet", spec_for(side, spec2))
    await op.reconcile_once()
    return kept, fake.deployments["llama-fleet-decode"]["spec"]["replicas"]


async def test_planner_scale_survives_reconcile_equals_jax():
    out, _, _, _ = _assert_equal(await _both(_planner_scale))
    assert out == (7, 4)


async def _broken_spec(fake, op, side):
    fake.set_graph_spec("llama-fleet", spec_for(side, SPEC))
    await op.reconcile_once()
    bad = spec_for(side, SPEC)
    del bad["image"]
    fake.set_graph_spec("llama-fleet", bad)
    await op.reconcile_once()
    seen = [len(fake.deployments)]
    fake.configmaps["llama-fleet"]["data"]["spec"] = "{nope"
    await op.reconcile_once()
    seen.append(len(fake.deployments))
    fake.set_graph_spec("llama-fleet", spec_for(side, SPEC))
    await op.reconcile_once()
    return seen + [len(fake.deployments), op.stats["deleted"]]


async def test_broken_spec_never_reaps_running_fleet_equals_jax():
    out, _, stats, _ = _assert_equal(await _both(_broken_spec))
    assert out == [4, 4, 4, 0] and stats["errors"] == 2


async def _bad_beside_good(fake, op, side):
    fake.set_graph_spec("bad", {"name": "bad"})  # no image/components
    fake.set_graph_spec("llama-fleet", spec_for(side, SPEC))
    task = asyncio.create_task(op.run())
    deadline = asyncio.get_running_loop().time() + 10
    while len(fake.deployments) < 4:
        assert asyncio.get_running_loop().time() < deadline, \
            "the run loop never created the good graph's Deployments"
        await asyncio.sleep(0.02)
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    return len(fake.deployments), op.stats["errors"] >= 1


async def test_bad_spec_skipped_and_loop_runs():
    got = {side: (await _with_operator(side, _bad_beside_good,
                                       interval_s=0.02))[0]
           for side in SIDES}
    assert got["port"] == (4, True) == got["jax"]


async def test_cli_once_converges_the_fake():
    fake = await RecordingKube().start()
    try:
        fake.set_graph_spec("llama-fleet", port_form(SPEC))
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch.operator", "--once",
            "--api-url", fake.endpoint, "--namespace", "ns",
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        _, err = await asyncio.wait_for(proc.communicate(), timeout=60)
        assert proc.returncode == 0, err.decode()[-2000:]
        assert sorted(fake.deployments) == [
            "llama-fleet-decode", "llama-fleet-frontend",
            "llama-fleet-planner", "llama-fleet-prefill"]
        assert [c[0] for c in fake.calls] == ["GET", "GET"] + ["POST"] * 4
    finally:
        await fake.close()
