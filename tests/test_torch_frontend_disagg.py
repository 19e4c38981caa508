"""The port's disaggregated and multimodal hops against the JAX package's
(CPU).

* `ConditionalDisaggConfig.should_disagg` over a table of (isl, overlap,
  config); the `PrefillOrchestrator` passing the prefill worker's
  params through (its forensic stamp added), and falling back to local
  prefill when none come back or the hop raises; `rendezvous_pick` and
  the `EncoderHop` splice (placeholders at `insert_pos` with running
  offsets, one encode call per unique media): all equal to JAX's.
* One fleet for the module: a port prefill worker (role prefill) and a
  decode worker (role decode), lockstep and tiny fp32, and a port
  encoder worker (mock tower), behind both frontends in kv mode over
  file discovery and the zmq event plane (tests/torch_fleet.py), each
  watcher with always-remote disaggregation.  Bodies and SSE events are
  equal, ids and timestamps aside, and equal to the decode worker's
  aggregated serving; the decode worker prefills no token; the hop
  timelines in the forensics planes are equal.  Conditional decisions
  follow the router's index (the decode worker's pulled blocks appear
  there).  An image chat reaches the encoder (then its cache) through
  both frontends and ends in the worker's named refusal alike.  A failed
  prefill hop, and a prefill card that goes away (after an MDC update
  that keeps the orchestrator), fall back to local prefill alike.
* Pool scoping: a watcher given `namespaces` serves only their cards.
"""

import asyncio
import dataclasses
import uuid

import numpy as np
import pytest
import torch

from dynamo_tpu.disagg.prefill_router import \
    ConditionalDisaggConfig as JaxDisaggConfig
from dynamo_tpu.disagg.prefill_router import \
    PrefillOrchestrator as JaxOrchestrator
from dynamo_tpu.multimodal.hop import EncoderHop as JaxHop
from dynamo_tpu.multimodal.hop import rendezvous_pick as jax_pick
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.disagg.prefill_router import (
    ConditionalDisaggConfig,
    PrefillOrchestrator,
)
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.multimodal import EncoderWorker, MockVisionEncoder
from dynamo_tpu_torch.multimodal.hop import EncoderHop, rendezvous_pick
from dynamo_tpu_torch.protocols import (
    LLMEngineOutput,
    ModelDeploymentCard,
    PreprocessedRequest,
)
from dynamo_tpu_torch.protocols.model_card import register_model
from torch_fleet import Frontends, LoopThread, wait_for

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
FP32 = LlamaConfig(dtype=torch.float32, **SHAPES)
# lockstep decode, one token a frame: both frontends see the same frames
LOCKSTEP = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32,
                max_num_seqs=4, prefill_buckets=(8, 16, 32, 64, 128),
                seed=7, overlap_scheduling=False, decode_fused_steps=1)
TOK = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
IMAGE_TOKEN = 7


# ---------------------------------------------------------------------------
# the policy, the orchestrator and the hop against JAX's
# ---------------------------------------------------------------------------

DISAGG_TABLE = [
    # (isl, overlap tokens, config kwargs)
    (4000, 0, {}),
    (2048, 0, {}),
    (2047, 0, {}),
    (4000, 2000, {}),
    (4000, 1200, {}),
    (4000, 1201, {}),
    (100, 0, {"min_effective_isl": 100}),
    (100, 31, {"min_effective_isl": 50, "min_effective_ratio": 0.7}),
    (100, 30, {"min_effective_isl": 50, "min_effective_ratio": 0.7}),
    (10, 500, {"min_effective_isl": 8}),
    (0, 0, {"min_effective_isl": 0}),
    (5, 5, {"always_remote": True}),
    (1224, 1024, {"min_effective_isl": 1024, "min_effective_ratio": 0.7}),
    (1800, 0, {"min_effective_isl": 1024, "min_effective_ratio": 0.7}),
]


@pytest.mark.parametrize("isl,overlap,cfg", DISAGG_TABLE)
def test_should_disagg_matches_jax(isl, overlap, cfg):
    ours = PrefillOrchestrator(None, ConditionalDisaggConfig(**cfg))
    theirs = JaxOrchestrator(None, JaxDisaggConfig(**cfg))
    toks = list(range(isl))
    assert ours.should_disagg(PreprocessedRequest(token_ids=toks),
                              overlap) == theirs.should_disagg(
        JaxRequest(token_ids=toks), overlap)


class _ScriptedPrefill:
    """A prefill endpoint client answering from a script: frames, or an
    exception."""

    instance_ids = [1]

    def __init__(self, frames=(), error=None):
        self.frames, self.error, self.payloads = list(frames), error, []

    async def generate(self, payload, instance_id=None, token=None):
        self.payloads.append(payload)
        for f in self.frames:
            yield f
        if self.error is not None:
            raise self.error

    async def close(self):
        pass


PARAMS = {"engine": "jax", "request_id": "r", "first_token": 5,
          "prompt_len": 9, "component": "prefill", "instance_id": 4}
ORCH_SCRIPTS = {
    "params": ([LLMEngineOutput(token_ids=[5], finish_reason="stop",
                                kv_transfer_params=PARAMS,
                                metrics={"forensic": {"cached_tokens": 4}}
                                ).to_dict()], None),
    "params_no_stamp": ([LLMEngineOutput(
        token_ids=[5], finish_reason="stop",
        kv_transfer_params=PARAMS).to_dict()], None),
    "no_params": ([LLMEngineOutput(token_ids=[5],
                                   finish_reason="stop").to_dict()], None),
    "raises": ([], RuntimeError("prefill worker died")),
}


@pytest.mark.parametrize("script", sorted(ORCH_SCRIPTS))
async def test_orchestrator_passes_params_through_or_falls_back(script):
    frames, error = ORCH_SCRIPTS[script]
    got = []
    for Orch, Cfg, Req in ((PrefillOrchestrator, ConditionalDisaggConfig,
                            PreprocessedRequest),
                           (JaxOrchestrator, JaxDisaggConfig, JaxRequest)):
        client = _ScriptedPrefill(frames, error)
        req = Req(token_ids=list(range(9)), request_id="r")
        out = await Orch(client, Cfg(always_remote=True)).maybe_prefill(req)
        assert client.payloads[0]["annotations"] == ["disagg_prefill"]
        got.append((out.disaggregated_params, out.token_ids,
                    out.annotations))
    assert got[0] == got[1]
    if script.startswith("params"):
        want = dict(PARAMS)
        if script == "params":
            want["prefill_forensic"] = {"cached_tokens": 4}
        assert got[0][0] == want
    else:
        assert got[0][0] is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rendezvous_pick_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ids = [int(x) for x in rng.integers(1, 2 ** 62, 6)]
    for key in (f"k{seed}", "a" * 64, ""):
        assert rendezvous_pick(ids, key) == jax_pick(ids, key)
        assert rendezvous_pick(ids[1:], key) == jax_pick(ids[1:], key)
    assert rendezvous_pick([], "x") is None and jax_pick([], "x") is None


class _FakeEncoder:
    """An `encode` client: n_tokens per media hash from a table; counts
    its calls and the items of each."""

    def __init__(self, n_tokens):
        self.n_tokens, self.calls = n_tokens, []
        self.instance_ids = [11, 12, 13]

    async def generate(self, payload, instance_id=None, token=None):
        self.calls.append((instance_id, [it["media_hash"]
                                         for it in payload["items"]]))
        for it in payload["items"]:
            n = self.n_tokens[it["media_hash"]]
            yield {"media_hash": it["media_hash"], "n_tokens": n,
                   "shape": [n, 2], "dtype": "float32",
                   "embedding": bytes(range(n * 8))}


HOP_CASES = {
    # name: (token ids, [(media hash, insert_pos)], n_tokens per hash)
    "adjacent": ([10, 11], [("A", 1), ("B", 1)], {"A": 2, "B": 3}),
    "spread": ([1, 2, 3, 4, 5], [("A", 0), ("B", 3), ("C", 5)],
               {"A": 1, "B": 4, "C": 2}),
    "repeated": ([1, 2, 3], [("A", 1), ("B", 2), ("A", 3)],
                 {"A": 3, "B": 1}),
    "out_of_order": ([1, 2, 3, 4], [("B", 4), ("A", 0)], {"A": 2, "B": 2}),
}


@pytest.mark.parametrize("case", sorted(HOP_CASES))
async def test_encoder_hop_splices_like_jax(case):
    toks, items, n_tokens = HOP_CASES[case]
    got = []
    for Hop, Req in ((EncoderHop, PreprocessedRequest), (JaxHop, JaxRequest)):
        enc = _FakeEncoder(n_tokens)
        req = Req(token_ids=list(toks), request_id="r", multimodal=[
            {"media_hash": h, "data_uri": "data:x,", "insert_pos": p}
            for h, p in items])
        out = await Hop(enc, image_token_id=99).encode_and_attach(req)
        got.append((out.token_ids, out.multimodal, enc.calls))
        # one encode call, one item per unique media
        assert len(enc.calls) == 1
        assert sorted(enc.calls[0][1]) == sorted(set(h for h, _ in items))
    assert got[0] == got[1]
    assert len(got[0][0]) == len(toks) + sum(n_tokens[h] for h, _ in items)


# ---------------------------------------------------------------------------
# the fleet: both frontends over one prefill/decode pair and an encoder
# ---------------------------------------------------------------------------


class _Fleet:
    async def start(self, cluster_dir):
        self.fe = await Frontends().start(
            cluster_dir,
            jax_watch={"disagg_config": JaxDisaggConfig(always_remote=True)},
            port_watch={"disagg_config": ConditionalDisaggConfig(
                always_remote=True)})
        prt = self.fe.prt
        self.workers, self.closed = {}, set()
        for role, comp in (("prefill", "prefill"), ("decode", "backend")):
            self.workers[role] = await TorchEngineWorker(
                prt, EngineConfig(model_config=FP32, model_name="m",
                                  role=role, **LOCKSTEP),
                component=comp, tokenizer_cfg=TOK, device="cpu").start()
        self.encoder = await EncoderWorker(
            prt, "m", encoder=MockVisionEncoder(n_tokens=4, out_dim=16),
            image_token_id=IMAGE_TOKEN).start()
        await self.fe.wait_model("m", pred=lambda p: (
            p.prefill is not None and p.prefill.client.instance_ids
            and p.encoder is not None and p.encoder.client.instance_ids))
        return self

    @property
    def pw(self):
        return self.workers["prefill"]

    @property
    def dw(self):
        return self.workers["decode"]

    async def clear(self):
        for r, w in self.workers.items():
            if r not in self.closed:
                await w.engine.clear_kv_blocks()

    async def both(self, path, body):
        """The body through the JAX frontend, then the port's, each from
        cleared prefix caches: [(status, body)], and the decode and
        prefill workers' prefill-token deltas of each."""
        got, deltas = [], []
        for url in self.fe.urls:
            await self.clear()
            before = {r: w.engine.metrics["prefill_tokens"]
                      for r, w in self.workers.items()
                      if r not in self.closed}
            got.append(await self.fe.post(url, path, body))
            deltas.append({r: w.engine.metrics["prefill_tokens"] - n
                           for r, n in before.items()
                           for w in [self.workers[r]]})
        return got, deltas

    async def close_worker(self, role):
        self.closed.add(role)
        await self.workers[role].close()

    async def close(self):
        await self.fe.close()
        for r, w in self.workers.items():
            if r not in self.closed:
                await w.close()
        await self.encoder.close()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    n = torch.get_num_threads()
    # the CPU workers' forwards gain nothing from intra-op threads, and
    # that spinning pool starves the discovery and event-plane threads
    torch.set_num_threads(1)
    loop = LoopThread()
    f = loop.run(_Fleet().start(tmp_path_factory.mktemp("cluster")))
    f.run = loop.run
    try:
        yield f
    finally:
        try:
            loop.run(f.close())
        finally:
            loop.close()
            torch.set_num_threads(n)


PROMPT = "the quick brown fox jumps over the lazy dog"
GREEDY = {"model": "m", "max_tokens": 6, "temperature": 0.0,
          "ignore_eos": True}
BODIES = {
    "completion": ("/v1/completions", dict(GREEDY, prompt=PROMPT)),
    "completion_stream": ("/v1/completions", dict(
        GREEDY, prompt=PROMPT, stream=True,
        stream_options={"include_usage": True})),
    "chat": ("/v1/chat/completions", dict(
        GREEDY, messages=[{"role": "user", "content": PROMPT}])),
    "chat_stream": ("/v1/chat/completions", dict(
        GREEDY, stream=True, messages=[{"role": "user", "content": PROMPT}])),
}


def _pipelines(fleet):
    return [m.get("m") for m in fleet.fe.managers]


@pytest.mark.parametrize("case", sorted(BODIES))
def test_always_disagg_equal_bodies_no_decode_prefill(fleet, case):
    path, body = BODIES[case]

    async def run():
        got, deltas = await fleet.both(path, body)
        # the decode worker's own prefill: the port pipeline with its
        # orchestrator detached for one request
        pipe = fleet.fe.pmanager.get("m")
        orch, pipe.prefill = pipe.prefill, None
        try:
            await fleet.clear()
            local = await fleet.fe.post(fleet.fe.urls[1], path, body)
        finally:
            pipe.prefill = orch
        return got, deltas, local

    got, deltas, local = fleet.run(run())
    assert got[0] == got[1], case
    assert got[0][0] == 200
    assert got[1] == local
    for d in deltas:
        assert d["decode"] == 0 and d["prefill"] > 0, deltas


def _exemplar(service, rid):
    for windows in service.forensics.dump()["models"].values():
        for w in windows:
            for e in w["ttft"] + w["itl"]:
                if e["record"]["request"]["request_id"] == rid:
                    return e
    return None


def test_disagg_hop_timelines_equal(fleet):
    body = dict(BODIES["completion_stream"][1], request_id="timeline")

    async def run():
        await fleet.both("/v1/completions", body)
        return [_exemplar(s, "timeline") for s in fleet.fe.services]

    got = fleet.run(run())
    kinds = [[h["hop"] for h in e["record"]["timeline"]["hops"]]
             for e in got]
    assert kinds[0] == kinds[1]
    assert "prefill_open" in kinds[1] and "prefill_done" in kinds[1]
    assert kinds[1].index("prefill_done") < kinds[1].index("first_token")
    assert sorted(got[0]["partition"]) == sorted(got[1]["partition"])
    for e in got:
        assert e["record"]["request"]["worker"]["prefill_worker_id"] == \
            fleet.pw.served.instance_id


def test_conditional_decisions_follow_the_router_index(fleet):
    bs = LOCKSTEP["block_size"]
    a = "".join(chr(c) for c in np.random.default_rng(3).integers(
        97, 123, 40))
    texts = [a, "a short one", a[:32] + "tail of eleven"]

    async def run():
        out = []
        for mgr, url in zip(fleet.fe.managers, fleet.fe.urls):
            pipe = mgr.get("m")
            orch = pipe.prefill
            saved = orch.config
            orch.config = type(saved)(min_effective_isl=24,
                                      min_effective_ratio=0.7)
            seen = []
            decide = orch.should_disagg

            def recorded(req, overlap, _decide=decide, _seen=seen):
                d = _decide(req, overlap)
                _seen.append((len(req.token_ids), overlap, d))
                return d

            orch.should_disagg = recorded
            route = pipe.migration.route
            iid = fleet.dw.served.instance_id
            try:
                await fleet.clear()
                await wait_for(
                    lambda: route.indexer.worker_block_count(iid) == 0,
                    "a cleared decode worker in the index")
                for i, t in enumerate(texts):
                    st, _ = await fleet.fe.post(url, "/v1/completions", dict(
                        GREEDY, prompt=t))
                    assert st == 200
                    if i == 0:
                        await wait_for(
                            lambda: route.indexer.worker_block_count(iid)
                            >= len(a) // bs,
                            "the pulled blocks in the router's index")
            finally:
                orch.should_disagg = decide
                orch.config = saved
            out.append(seen)
        return out

    jax_seen, port_seen = fleet.run(run())
    assert jax_seen == port_seen
    shared = 32
    assert [d for _, _, d in port_seen] == [True, False, False]
    assert port_seen[2][1] == shared and port_seen[0][1] == 0


def test_image_request_reaches_the_encoder_and_ends_alike(fleet):
    import base64

    uri = "data:application/octet-stream;base64," + base64.b64encode(
        bytes(range(64))).decode()
    body = dict(GREEDY, messages=[{"role": "user", "content": [
        {"type": "text", "text": "what is in "},
        {"type": "image_url", "image_url": {"url": uri}}]}])

    async def run():
        m0 = dict(fleet.encoder.metrics)
        got, _ = await fleet.both("/v1/chat/completions", body)
        return got, {k: fleet.encoder.metrics[k] - m0.get(k, 0)
                     for k in fleet.encoder.metrics}

    got, enc = fleet.run(run())
    assert got[0] == got[1]
    status, err = got[1]
    # the worker's named refusal of resolved embeddings (ROADMAP, Queue
    # 3 item 9), reached after the encode and the splice
    assert status == 500 and "multimodal inputs" in err["error"]["message"]
    # one encode request a frontend, the second served from the cache
    assert enc["requests"] == 2 and enc["cache_hits"] == 1, enc


def test_failed_prefill_hop_falls_back_alike(fleet):
    async def run():
        saved = []
        for pipe in _pipelines(fleet):
            client = pipe.prefill.client
            saved.append((client, client.generate))

            async def broken(*a, **kw):
                raise RuntimeError("prefill worker unreachable")
                yield  # an async generator, as the client's

            client.generate = broken
        try:
            return await fleet.both(*BODIES["completion"])
        finally:
            for client, gen in saved:
                client.generate = gen

    got, deltas = fleet.run(run())
    assert got[0] == got[1] and got[0][0] == 200
    for d in deltas:
        assert d["prefill"] == 0 and d["decode"] > 0, deltas


def test_prefill_card_removed_mid_run_falls_back_alike(fleet):
    """An MDC update of the decode card keeps the orchestrator; the
    prefill worker's exit takes it away, and requests prefill on the
    decode worker alike (this test runs last: it closes the prefill
    worker)."""

    async def run():
        before = _pipelines(fleet)
        card = dataclasses.replace(fleet.dw.card, migration_limit=1)
        await register_model(fleet.fe.prt, card, instance_id=12345)
        await fleet.fe.wait_model("m", pred=lambda p: p.mdc.migration_limit
                                  == 1)
        kept = [(p is not b, p.prefill is b.prefill)
                for p, b in zip(_pipelines(fleet), before)]
        await fleet.close_worker("prefill")
        await fleet.fe.wait_model("m", pred=lambda p: p.prefill is None)
        got = await fleet.both(*BODIES["chat_stream"])
        return kept, got

    kept, (got, deltas) = fleet.run(run())
    assert kept == [(True, True), (True, True)]
    assert got[0] == got[1] and got[0][0] == 200
    assert all(d["decode"] > 0 for d in deltas), deltas


# ---------------------------------------------------------------------------
# pool scoping
# ---------------------------------------------------------------------------


async def test_pool_scoped_watchers_serve_only_their_namespaces():
    from dynamo_tpu.frontend import ModelManager as JaxManager
    from dynamo_tpu.frontend import ModelWatcher as JaxWatcher
    from dynamo_tpu.protocols import ModelDeploymentCard as JaxCard
    from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
    from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig

    from dynamo_tpu_torch.frontend.service import ModelManager, ModelWatcher
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    kw = dict(discovery_backend="mem", event_plane="inproc")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**kw),
                           cluster_id=uuid.uuid4().hex).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**kw),
                                   cluster_id=uuid.uuid4().hex).start()

    async def gen(payload, ctx):
        yield LLMEngineOutput(token_ids=[65], finish_reason="length"
                              ).to_dict()

    watchers = []
    try:
        for rt, Card in ((jrt, JaxCard), (prt, ModelDeploymentCard)):
            for ns, name in (("pool-a", "ma"), ("pool-b", "mb")):
                await rt.namespace(ns).component("backend").endpoint(
                    "generate").serve_endpoint(gen, instance_id=7)
                await rt.discovery.put(
                    Card(name=name, namespace=ns).key(7),
                    Card(name=name, namespace=ns).to_dict())
        managers = [JaxManager(), ModelManager(),
                    JaxManager(), ModelManager()]
        for rt, W, mgr, ns in ((jrt, JaxWatcher, managers[0], {"pool-a"}),
                               (prt, ModelWatcher, managers[1], {"pool-a"}),
                               (jrt, JaxWatcher, managers[2], None),
                               (prt, ModelWatcher, managers[3], None)):
            watchers.append(await W(rt, mgr, namespaces=ns).start())
        for mgr in managers[2:]:
            await wait_for(lambda: len(mgr.models) == 2, "both pools' models")
        for mgr in managers[:2]:
            await wait_for(lambda: "ma" in mgr.models, "pool-a's model")
        await asyncio.sleep(0.2)
        assert [sorted(m.models) for m in managers] == [
            ["ma"], ["ma"], ["ma", "mb"], ["ma", "mb"]]
    finally:
        for w in watchers:
            await w.close()
        await prt.shutdown()
        await jrt.shutdown()
