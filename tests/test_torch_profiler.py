"""The port's profiler against the JAX package's (CPU).

* A PerfProfile's JSON written by either package loads in the other and
  writes the same bytes again; PerfModels built from it in each answer
  the same.
* `profile_engine` on a recording wrapper around a tiny fp32 TorchEngine
  and around a JaxEngine on the same weights: both sweeps issue the same
  request ids, prompt token ids, stop conditions and sampling, every
  request gets OSL tokens (the two engines' greedy streams equal), and
  the profiles have the same grid and tags.
* The CLI: `--engine mock` sweeps the port's simulator with the grid of
  JAX's mock profile; `--device cpu --model tiny` writes a profile the
  JAX package loads.
"""

import asyncio
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.planner.perf_model import PerfModel as JaxPerfModel
from dynamo_tpu.profiler import PerfPoint as JaxPoint
from dynamo_tpu.profiler import PerfProfile as JaxProfile
from dynamo_tpu.profiler import profile_engine as jax_profile_engine
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.planner.perf_model import PerfModel
from dynamo_tpu_torch.profiler import PerfPoint, PerfProfile, profile_engine
from dynamo_tpu_torch.profiler.__main__ import run

# the sweeps run model work inside the async bodies (JAX compiles, CPU
# forwards), so the slow-callback gate cannot hold here
pytestmark = pytest.mark.allow_slow_callbacks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the profiler's prompts use token ids up to 30002
SHAPES = dict(name="tiny32", vocab_size=30016, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=16,
              max_num_seqs=4, prefill_buckets=(8, 16, 32), seed=7)
GRID = dict(isls=(8, 16), concurrencies=(1, 2), osl=3, rounds=1)


def _profile(cls_profile, cls_point, kv="bf16", n=3) -> object:
    prof = cls_profile(model_name="synth", meta={
        "osl": 32, "rounds": 2, "kv_cache_dtype": kv})
    for isl in (128, 512):
        for c in range(1, n + 1):
            itl = 0.002 + 0.001 * c
            ttft = (0.002 + 2e-5 * isl) * (1 + 0.3 * (c - 1))
            prof.points.append(cls_point(
                isl=isl, osl=32, concurrency=c, ttft_p50_s=ttft * 0.9,
                ttft_p95_s=ttft, itl_mean_s=itl * 0.95, itl_p95_s=itl,
                req_per_s=c / (ttft + 32 * itl),
                output_tok_per_s=32 * c / (ttft + 32 * itl)))
    return prof


PROFILES = {
    "grid": dict(),
    "int8": dict(kv="int8"),
    "one_point": dict(n=1),
}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", sorted(PROFILES))
def test_profile_json_crosses_packages(case, direction, tmp_path):
    if direction == "jax_to_port":
        src = _profile(JaxProfile, JaxPoint, **PROFILES[case])
        dst_cls, models = PerfProfile, (JaxPerfModel, PerfModel)
    else:
        src = _profile(PerfProfile, PerfPoint, **PROFILES[case])
        dst_cls, models = JaxProfile, (PerfModel, JaxPerfModel)
    path = tmp_path / "profile.json"
    src.save(str(path))
    written = path.read_bytes()
    back = dst_cls.load(str(path))
    back.save(str(path))
    assert path.read_bytes() == written
    assert back.to_json() == src.to_json()
    a, b = models[0](src), models[1](back)
    assert a.kv_cache_dtype == b.kv_cache_dtype == PROFILES[case].get(
        "kv", "bf16")
    for isl in (100, 128, 300, 600):
        for c in (0.5, 1, 2.5, 9):
            assert a.itl(c, isl) == b.itl(c, isl)
            assert a.ttft(isl, c) == b.ttft(isl, c)
        assert a.max_rps_for_ttft(isl, 0.01) == b.max_rps_for_ttft(isl, 0.01)
    for t in (0.001, 0.004, 0.006):
        assert a.max_active_for_itl(t) == b.max_active_for_itl(t)
    assert a.check_kv_dtype(["bf16", "int8", ""]) \
        == b.check_kv_dtype(["bf16", "int8", ""])


class _Recorder:
    """An engine wrapper that records each request the sweep sends and
    the tokens it gets back."""

    def __init__(self, engine):
        self.engine = engine
        self.kv_dtype = engine.kv_dtype
        self.seen = []

    async def generate(self, req):
        rec = {"request_id": req.request_id,
               "token_ids": list(req.token_ids),
               "stop": vars(req.stop).copy(),
               "sampling": vars(req.sampling).copy(), "out": []}
        self.seen.append(rec)
        async for out in self.engine.generate(req):
            rec["out"].extend(out.token_ids)
            yield out


def _engines():
    je = JaxEngine(JaxEngineConfig(
        model_config=JaxLlamaConfig(dtype=jnp.float32, **SHAPES), **COMMON))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    cfg = LlamaConfig(dtype=torch.float32, **SHAPES)
    te = TorchEngine(EngineConfig(model_config=cfg, **COMMON),
                     params=params_from_numpy(tree, cfg, device="cpu"),
                     device="cpu")
    return je, te


async def test_sweep_requests_equal_jax():
    je, te = _engines()
    jrec, trec = _Recorder(je), _Recorder(te)
    try:
        jprof = await jax_profile_engine(jrec, model_name="t", **GRID)
        tprof = await profile_engine(trec, model_name="t", **GRID)
    finally:
        await je.close()
        await te.close()

    def requests(rec):
        return sorted(({k: v for k, v in r.items() if k != "out"}
                       for r in rec.seen), key=lambda r: r["request_id"])

    # the warm-up point (osl 4) and 2 ISLs x (1 + 2) requests
    assert len(trec.seen) == 1 + 2 * 3
    assert requests(trec) == requests(jrec)
    by_id = {r["request_id"]: r["out"] for r in jrec.seen}
    for r in trec.seen:
        assert len(r["out"]) == r["stop"]["max_tokens"], r["request_id"]
        assert r["out"] == by_id[r["request_id"]], r["request_id"]
    assert tprof.meta == jprof.meta
    assert (tprof.meta["osl"], tprof.meta["rounds"]) == (3, 1)
    assert [(p.isl, p.osl, p.concurrency) for p in tprof.points] \
        == [(p.isl, p.osl, p.concurrency) for p in jprof.points] \
        == [(8, 3, 1), (8, 3, 2), (16, 3, 1), (16, 3, 2)]
    assert all(p.req_per_s > 0 and p.ttft_p95_s > 0 and p.itl_mean_s > 0
               for p in tprof.points)
    # the profile plans in JAX's planner
    assert JaxPerfModel(JaxProfile.from_json(tprof.to_json())) \
        .max_active_for_itl(1e3) > 0


MOCK_ARGV = ["--engine", "mock", "--isls", "16,64", "--concurrencies", "1,2",
             "--osl", "3", "--rounds", "1"]


@pytest.mark.parametrize("argv,rc", [(MOCK_ARGV, 0)])
def test_cli_refuses_the_mock_engine(argv, rc, tmp_path, capsys):
    """(Named when the CLI refused `--engine mock`; the simulator is
    ported now.)  `--engine mock` sweeps the port's MockEngine: the
    profile has the grid JAX's mock profile has from the same flags, and
    finite, positive latencies and rates at every point."""
    out = tmp_path / "mock.json"
    assert run([*argv, "--out", str(out)]) == rc
    assert "wrote 4 grid points" in capsys.readouterr().out
    prof = PerfProfile.load(str(out))

    async def jax_mock():
        from dynamo_tpu.mocker import MockEngine, MockEngineArgs

        eng = MockEngine(MockEngineArgs(speedup_ratio=1.0))
        try:
            return await jax_profile_engine(
                eng, model_name="mock", isls=[16, 64], osl=3,
                concurrencies=[1, 2], rounds=1)
        finally:
            await eng.close()

    jprof = asyncio.run(jax_mock())
    grid = [(p.isl, p.osl, p.concurrency) for p in prof.points]
    assert grid == [(p.isl, p.osl, p.concurrency) for p in jprof.points]
    assert grid == [(16, 3, 1), (16, 3, 2), (64, 3, 1), (64, 3, 2)]
    assert prof.model_name == jprof.model_name == "mock"
    for p in prof.points:
        vals = [p.ttft_p50_s, p.ttft_p95_s, p.itl_mean_s, p.itl_p95_s,
                p.req_per_s, p.output_tok_per_s]
        assert all(np.isfinite(v) and v > 0 for v in vals), p


def test_cli_writes_a_profile_jax_loads(tmp_path):
    out = tmp_path / "profile.json"
    env = dict(os.environ, PYTHONPATH=REPO, DYN_LOG_LEVEL="WARNING",
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.profiler", "--device",
         "cpu", "--model", "tiny", "--out", str(out), "--isls", "16",
         "--concurrencies", "1,2", "--osl", "2", "--rounds", "1",
         "--block-size", "16", "--num-blocks", "32",
         "--max-blocks-per-seq", "4", "--max-num-seqs", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote 2 grid points" in proc.stdout
    prof = JaxProfile.load(str(out))
    assert [(p.isl, p.concurrency) for p in prof.points] == [(16, 1), (16, 2)]
    assert prof.meta["kv_cache_dtype"] == "bf16"
    assert json.loads(out.read_text())["model_name"] == "tiny"
