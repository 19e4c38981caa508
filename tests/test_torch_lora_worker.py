"""LoRA, guided decoding and the SLO feed through the port's worker (CPU).

* The unchanged JAX frontend (file discovery, zmq event plane, a JAX
  runtime beside the port's) serves an adapter alias (model=<adapter>,
  resolved from DYN_LORA_PATH to the base model with lora_name set) and
  a response_format json_schema request through a TorchEngineWorker:
  the adapter stream equals the engine's own stream for that adapter,
  and the content is a schema-valid document.
* The worker installs the guided codec from its MDC's tokenizer entry,
  and falls back to the byte mock where it cannot build one.
* A burn published on `slo_metrics.{ns}` reaches TorchEngine.set_slo_burn
  (the worst window), a malformed payload does not stop the feed, and
  close() ends the subscription.
* `python -m dynamo_tpu_torch.engine --lora-dir D --device cpu` takes the
  JAX CLI's LoRA flags (the bank only with a directory) and serves one
  adapter request over the request plane.
"""

import asyncio
import json
import subprocess
import sys

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
from dynamo_tpu_torch.guided import JsonSchemaGuide
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.models.llama import PRESETS
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from test_lora import write_peft_adapter
from test_torch_worker import REPO, _discover, _env, _ready_line, _wait

pytestmark = pytest.mark.allow_slow_callbacks

SHAPES = dict(name="tiny32", vocab_size=300, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JCFG = jl.LlamaConfig(dtype=jnp.float32, **SHAPES)
TCFG = tl.LlamaConfig(dtype=torch.float32, **SHAPES)
COMMON = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32,
              max_num_seqs=4, prefill_buckets=(8, 16, 32, 64), seed=7)
TOKENIZER = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
SCHEMA = {"type": "object", "properties": {"city": {"type": "string"},
                                           "unit": {"enum": ["c", "f"]}}}


def _params():
    return params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jl.init_params(JCFG, jax.random.PRNGKey(7))), TCFG, "cpu")


async def _chat(session, url, body):
    async with session.post(f"{url}/v1/chat/completions", json=body) as r:
        assert r.status == 200, await r.text()
        return await r.json()


async def test_jax_frontend_serves_adapter_alias_and_response_format(
        tmp_path, monkeypatch):
    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    lora_dir = tmp_path / "adapters"
    write_peft_adapter(str(lora_dir), "style-a", JCFG, rank=4, alpha=8,
                       seed=5, base="lw-model")
    monkeypatch.setenv("DYN_LORA_PATH", str(lora_dir))
    disc = dict(discovery_backend="file",
                discovery_path=str(tmp_path / "cluster"), event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    tw = TorchEngineWorker(prt, EngineConfig(
        model_config=TCFG, model_name="lw-model", lora_max_adapters=2,
        lora_rank=8, lora_dir=str(lora_dir), **COMMON),
        component="loraw", tokenizer_cfg=TOKENIZER, params=_params(),
        device="cpu")
    manager = ModelManager()
    watcher = service = None
    try:
        await tw.start()
        # every user request the engine serves: (request, its token ids),
        # and each request's frames' token ids
        seen, frames = [], {}
        inner = tw.engine.generate

        async def generate(request, token=None):
            toks = []
            if not request.request_id.startswith("canary"):
                seen.append((request, toks))
            async for out in inner(request, token=token):
                toks.extend(out.token_ids)
                frames.setdefault(request.request_id, []).append(
                    list(out.token_ids))
                yield out

        tw.engine.generate = generate
        watcher = await ModelWatcher(jrt, manager).start()
        service = await HttpService(jrt, manager, host="127.0.0.1",
                                    port=0).start()
        url = f"http://127.0.0.1:{service._runner.addresses[0][1]}"
        await _wait(lambda: manager.get("lw-model"), "the model")
        msgs = [{"role": "user", "content": "hi"}]
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{url}/v1/models") as r:
                ids = {m["id"]: m for m in (await r.json())["data"]}
            assert ids["style-a"]["parent"] == "lw-model"
            out = {}
            for model in ("lw-model", "style-a"):
                out[model] = await _chat(s, url, {
                    "model": model, "messages": msgs, "max_tokens": 6,
                    "temperature": 0.0, "ignore_eos": True})
                assert out[model]["model"] == model
            fmt = await _chat(s, url, {
                "model": "lw-model", "messages": msgs, "max_tokens": 64,
                "response_format": {"type": "json_schema",
                                    "json_schema": {"schema": SCHEMA}}})
        assert [r.lora_name for r, _ in seen] == [None, "style-a", None]
        assert seen[2][0].sampling.guided_json == SCHEMA
        (_, base), (req, adapter), (_, guided) = seen
        assert len(base) == len(adapter) == 6 and base != adapter
        assert tw.engine._lora_slots == {"style-a": 1}
        # the adapter stream is the engine's own for that adapter
        direct = []
        async for o in inner(PreprocessedRequest(
                token_ids=list(req.token_ids), request_id="direct",
                lora_name="style-a",
                sampling=SamplingOptions(temperature=0.0),
                stop=StopConditions(max_tokens=6, ignore_eos=True))):
            direct.extend(o.token_ids)
        assert direct == adapter
        content = fmt["choices"][0]["message"]["content"]
        assert JsonSchemaGuide(SCHEMA).done(content.strip()), content
        assert set(json.loads(content)) == {"city", "unit"}
        # the content is the guided stream's frames as the JAX frontend
        # renders them (frontend/pipeline.py: one incremental detokenizer
        # pushed frame by frame; a byte run cut by a word token renders
        # otherwise than a one-shot decode, on some sampled streams)
        from dynamo_tpu.frontend.tokenizer import MockTokenizer as JaxMock

        det = JaxMock(300).make_detokenizer()
        rendered = "".join(det.push(f)
                           for f in frames[seen[2][0].request_id])
        assert sum(frames[seen[2][0].request_id], []) == guided
        assert rendered.strip() == content.strip()
    finally:
        if service is not None:
            await service.close()
        if watcher is not None:
            await watcher.close()
        await tw.close()
        await prt.shutdown()
        await jrt.shutdown()


@pytest.mark.parametrize("tok", ["mock", "broken-hf"])
async def test_worker_installs_the_guided_codec_from_its_mdc(tok):
    cfg = TOKENIZER if tok == "mock" else {"type": "hf", "json": "{"}
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc")).start()
    w = TorchEngineWorker(rt, EngineConfig(model_config=TCFG, **COMMON),
                          tokenizer_cfg=cfg, params=_params(), device="cpu")
    try:
        await w.start()
        codec = w.engine.guided_codec
        if tok == "mock":
            assert isinstance(codec, MockTokenizer)
            assert codec.vocab_size == SHAPES["vocab_size"]
        else:
            # the warning's byte fallback, built on first use
            assert codec is None
            assert isinstance(w.engine._guided_codec(), MockTokenizer)
        toks = []
        async for o in w.engine.generate(PreprocessedRequest(
                token_ids=list(range(7, 19)), request_id="g",
                sampling=SamplingOptions(temperature=0.0,
                                         guided_json=SCHEMA),
                stop=StopConditions(max_tokens=40))):
            assert o.finish_reason != "error", o.error
            toks.extend(o.token_ids)
        text = MockTokenizer(300).decode(toks)
        assert JsonSchemaGuide(SCHEMA).done(text.strip()), text
    finally:
        await w.close()
        await rt.shutdown()


async def test_slo_feed_reaches_the_engine():
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc")).start()
    w = TorchEngineWorker(rt, EngineConfig(model_config=TCFG, **COMMON),
                          namespace="ns1", tokenizer_cfg=TOKENIZER,
                          params=_params(), device="cpu")
    try:
        await w.start()
        eng = w.engine
        assert eng._effective_slo_burn() == 0.0
        plane = rt.event_plane
        await _wait(lambda: any(p.startswith("slo_metrics")
                                for p, _ in plane._bus.subs),
                    "the SLO subscription")
        await plane.publish("slo_metrics.ns1",
                            {"burn": {"5m": 2.5, "1h": 0.75}})
        await _wait(lambda: eng._slo_burn == 2.5, "the burn")
        assert eng._effective_slo_burn() == 2.5
        # another namespace's summary and malformed payloads are ignored
        await plane.publish("slo_metrics.other", {"burn": {"5m": 9.0}})
        await plane.publish("slo_metrics.ns1", "garbage")
        await plane.publish("slo_metrics.ns1", {"burn": "x"})
        await _wait(lambda: eng._slo_burn == 0.0, "the 'no burns' reading")
        await plane.publish("slo_metrics.ns1", {"burn": {"5m": 1.5}})
        await _wait(lambda: eng._slo_burn == 1.5, "the feed after garbage")
        task = w._slo_task
    finally:
        await w.close()
        await rt.shutdown()
    assert task.done() and w._slo_task is None


def test_engine_cli_lora_flags_equal_jax(monkeypatch):
    from dynamo_tpu.engine.__main__ import build_args as jax_args
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

    monkeypatch.delenv("DYN_LORA_PATH", raising=False)
    names = ("lora_dir", "lora_max_adapters", "lora_rank")
    for argv in ([], ["--lora-dir", "/d", "--lora-max-adapters", "3",
                      "--lora-rank", "8"]):
        args, jargs = build_args().parse_args(argv), \
            jax_args().parse_args(argv)
        assert [getattr(args, n) for n in names] \
            == [getattr(jargs, n) for n in names]
    cfg = engine_config(build_args().parse_args(["--lora-max-adapters",
                                                 "3"]))
    assert (cfg.lora_dir, cfg.lora_max_adapters) == (None, 0)
    cfg = engine_config(build_args().parse_args(
        ["--lora-dir", "/d", "--lora-max-adapters", "3", "--lora-rank",
         "8"]))
    assert (cfg.lora_dir, cfg.lora_max_adapters, cfg.lora_rank) == \
        ("/d", 3, 8)
    monkeypatch.setenv("DYN_LORA_PATH", "/env")
    assert build_args().parse_args([]).lora_dir == "/env"


def test_engine_cli_serves_an_adapter_request(tmp_path):
    lora_dir = tmp_path / "adapters"
    write_peft_adapter(str(lora_dir), "ad", PRESETS["tiny"], rank=4,
                       alpha=8, seed=3, base="tiny")
    disc = tmp_path / "cluster"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.engine", "--device", "cpu",
         "--model", "tiny", "--block-size", "16", "--num-blocks", "64",
         "--max-blocks-per-seq", "8", "--max-num-seqs", "2",
         "--lora-dir", str(lora_dir), "--lora-max-adapters", "2",
         "--lora-rank", "8"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=str(disc)))
    try:
        line = _ready_line(proc)
        assert line.startswith("ready instance_id="), line
        res = asyncio.run(_adapter_requests(disc))
        (base, fb), (ad, fa), (err, fe) = res
        assert fb == fa == "length" and len(base) == len(ad) == 8
        assert base != ad
        assert fe == "error" and "nope" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


async def _adapter_requests(disc):
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=str(disc),
        event_plane="zmq")).start()
    client = await rt.namespace("dynamo").component("backend").endpoint(
        "generate").client().start()
    out = []
    try:
        await _discover(client)
        for lora in (None, "ad", "nope"):
            toks, finish, err = [], None, ""
            async for o in client.generate(PreprocessedRequest(
                    token_ids=list(range(10, 30)), request_id=f"r-{lora}",
                    lora_name=lora,
                    sampling=SamplingOptions(temperature=0.0),
                    stop=StopConditions(max_tokens=8,
                                        ignore_eos=True)).to_dict()):
                toks.extend(o.get("token_ids", []))
                finish = o.get("finish_reason")
                err = o.get("error") or err
            out.append((err if finish == "error" else toks, finish))
    finally:
        await client.close()
        await rt.shutdown()
    return out
