"""Speculative decoding through the port's worker (CPU).

* The MDC's runtime_config carries the JAX worker's `"speculative":
  {"proposer", "k"}` entry only when the engine speculates.
* The unchanged JAX planner's FpmObserver.spec_acceptance reads the port
  worker's published spec_verify records (file discovery, zmq event
  plane, a JAX runtime beside the port's) to the rate the engine's own
  counters give.
* `python -m dynamo_tpu_torch.engine --spec-decode ngram --device cpu`
  parses its flags as the JAX CLI does, advertises the entry and serves
  one request over the request plane.
"""

import asyncio
import json
import subprocess
import sys

import pytest

from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from test_torch_spec import COMMON, FP32, REPEAT_PROMPT, _torch_params
from test_torch_worker import REPO, _env, _readline

pytestmark = pytest.mark.allow_slow_callbacks

TOKENIZER = {"type": "mock", "vocab_size": 256}


def _request(rid: str, n: int) -> PreprocessedRequest:
    return PreprocessedRequest(
        token_ids=list(REPEAT_PROMPT), request_id=rid,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=n, ignore_eos=True))


async def test_mdc_advertises_speculation_only_when_on():
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc")).start()
    cards = {}
    try:
        for mode in ("off", "ngram", "draft"):
            extra = {"spec_draft_config": FP32} if mode == "draft" else {}
            w = TorchEngineWorker(
                rt, EngineConfig(model_config=FP32, model_name=f"m-{mode}",
                                 spec_decode=mode, **extra, **COMMON),
                component=f"c-{mode}", tokenizer_cfg=TOKENIZER,
                params=_torch_params(), device="cpu")
            await w.start()
            cards[mode] = w.card.runtime_config
            await w.close()
    finally:
        await rt.shutdown()
    assert "speculative" not in cards["off"]
    assert cards["ngram"]["speculative"] == {"proposer": "ngram", "k": 4}
    assert cards["draft"]["speculative"] == {"proposer": "draft", "k": 4}


async def test_jax_fpm_observer_reads_port_spec_acceptance(tmp_path):
    from dynamo_tpu.planner.metrics import FpmObserver
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    w = TorchEngineWorker(prt, EngineConfig(
        model_config=FP32, spec_decode="ngram", **COMMON),
        component="specw", tokenizer_cfg=TOKENIZER, params=_torch_params(),
        device="cpu")
    obs = None
    try:
        await w.start()
        obs = await FpmObserver(jrt, "dynamo", "specw").start()
        await asyncio.sleep(0.5)  # the subscription reaches the publisher
        async for _ in w.engine.generate(_request("fpm", 96)):
            pass
        m = w.engine.metrics
        want = m["spec_accepted"] / m["spec_proposed"]
        assert 0.0 < want < 1.0
        for _ in range(200):
            if obs.spec_acceptance() == pytest.approx(want):
                break
            await asyncio.sleep(0.05)
        assert obs.spec_acceptance() == pytest.approx(want)
    finally:
        if obs is not None:
            await obs.close()
        await w.close()
        await prt.shutdown()
        await jrt.shutdown()


def test_engine_cli_spec_flags_equal_jax():
    from dynamo_tpu.engine.__main__ import build_args as jax_args
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

    names = ("spec_decode", "spec_k", "spec_draft_model",
             "spec_draft_model_path")
    for argv in ([], ["--spec-decode", "draft", "--spec-k", "3",
                      "--spec-draft-model", "llama-1b",
                      "--spec-draft-model-path", "/ck"]):
        args, jargs = build_args().parse_args(argv), \
            jax_args().parse_args(argv)
        assert [getattr(args, n) for n in names] \
            == [getattr(jargs, n) for n in names]
        cfg = engine_config(args)
        assert [getattr(cfg, n) for n in names] \
            == [getattr(args, n) for n in names]
    choices = [a.choices for p in (jax_args(), build_args())
               for a in p._actions if a.dest == "spec_decode"]
    assert choices[0] == choices[1]
    with pytest.raises(SystemExit):
        build_args().parse_args(["--spec-decode", "medusa"])


def test_engine_cli_serves_with_ngram_speculation(tmp_path):
    disc = tmp_path / "cluster"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.engine", "--device", "cpu",
         "--model", "tiny", "--block-size", "16", "--num-blocks", "64",
         "--max-blocks-per-seq", "8", "--max-num-seqs", "2",
         "--spec-decode", "ngram", "--spec-k", "3"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=str(disc)))
    try:
        line = _readline(proc, timeout=60.0)
        assert line.startswith("ready instance_id="), proc.stderr.read()
        iid = line.strip().split("=", 1)[1]
        mdc = disc / "v1" / "mdc" / "dynamo" / "tiny" / f"{iid}.json"
        card = json.loads(mdc.read_text())
        assert card["runtime_config"]["speculative"] == {
            "proposer": "ngram", "k": 3}
        toks, finish = asyncio.run(_one_request(disc))
        assert len(toks) == 12 and finish == "length"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


async def _one_request(disc):
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=str(disc),
        event_plane="zmq")).start()
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    toks, finish = [], None
    try:
        await client.wait_for_instances()
        async for out in client.generate(_request("cli", 12).to_dict()):
            toks.extend(out.get("token_ids", []))
            finish = out.get("finish_reason")
    finally:
        await client.close()
        await rt.shutdown()
    return toks, finish
