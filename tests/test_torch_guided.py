"""The port's guided JSON decoding and SLO input (CPU) against the JAX
package's.

* guided/json_prefix.py (a copy): JsonSchemaGuide's ok/done/complete
  equal JAX's on the cases of tests/test_guided.py.
* frontend/tokenizer.py (a copy): the byte mock encodes and decodes (and
  detokenizes incrementally) as JAX's does.
* TorchEngine against JaxEngine with the same config (tests/test_guided.py's
  FP32 model): greedy and seeded guided streams, the guided counters and
  the final chunk's forced-close metrics; the seed-determinism test of
  tests/test_guided.py, mirrored; a guided request beside an n-gram
  speculating one (guided slots never speculate); a guided request
  through a disagg pair (the decode side rewinds to the last prompt
  position and re-derives the first token under the constraint).
* set_slo_burn: the same slo_yield_steps and prefill chunk sizes as
  JAX's under a reported burn, and the signal goes stale after
  slo_burn_stale_s.
"""

import asyncio
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import JaxEngine
from dynamo_tpu.frontend.tokenizer import MockTokenizer as JaxMock
from dynamo_tpu.guided import JsonSchemaGuide as JaxGuide
from dynamo_tpu.models import llama as jl
from dynamo_tpu.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.protocols import SamplingOptions as JaxSampling
from dynamo_tpu.protocols import StopConditions as JaxStop
from dynamo_tpu.protocols.llm import DISAGG_ANNOTATION as JAX_DISAGG
from dynamo_tpu_torch.disagg import broker
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
from dynamo_tpu_torch.guided import JsonSchemaGuide
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_numpy
from dynamo_tpu_torch.protocols import (
    DISAGG_ANNOTATION,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

pytestmark = pytest.mark.allow_slow_callbacks

WEATHER = {"type": "object", "properties": {
    "city": {"type": "string"}, "unit": {"enum": ["c", "f"]},
    "days": {"type": "integer"}}}
NESTED = {"type": "object", "properties": {
    "tags": {"type": "array", "items": {"type": "string"}},
    "loc": {"type": "object", "properties": {
        "lat": {"type": "number"}, "lon": {"type": "number"}}},
    "ok": {"type": "boolean"}}}
BOOL = {"type": "object", "properties": {"ok": {"type": "boolean"}}}


def _prefixes(doc):
    return [doc[:cut] for cut in range(len(doc) + 1)]


# the texts tests/test_guided.py's four guide tests put to each schema
GUIDE_CASES = {
    "prefix-walk": (WEATHER, _prefixes(
        '{"city": "Paris", "unit": "c", "days": 3}') + [
        '{"unit"', '{"city": 3', '{"city": "x", "unit": "k"',
        '{"city": "Paris", "unit": "c", "days": 3}x', "["]),
    "completion": (WEATHER, ['{"city": "Par"', '{"nope"'] + _prefixes(
        '{"city": "Paris", "unit": "f", "days": 12}')),
    "nested": (NESTED, _prefixes(
        '{"tags": ["a\\n", "b\\u00e9"], '
        '"loc": {"lat": -1.5e2, "lon": 0.25}, "ok": true}') + [
        '{"tags": ["x\\', '{"tags": [], "loc": {"lat": -',
        '{"tags": ["a", ']),
    "untyped": ({}, ['{"anything": [1, {"x": null}, "s"]}', '{"a": 1}',
                     "nope", '{"a": [1,']),
}


def _verdicts(guide, text):
    try:
        completion = guide.complete(text)
    except ValueError as e:
        completion = ("ValueError", str(e))
    return guide.ok(text), guide.done(text), completion


@pytest.mark.parametrize("case", sorted(GUIDE_CASES))
def test_guide_verdicts_equal_jax(case):
    schema, texts = GUIDE_CASES[case]
    ours, theirs = JsonSchemaGuide(schema), JaxGuide(schema)
    for text in texts:
        assert _verdicts(ours, text) == _verdicts(theirs, text), text


def test_mock_tokenizer_equals_jax():
    text = 'héllo {"k": [1, 2]} ✓\n'
    for vocab in (300, 32000):
        ours, theirs = MockTokenizer(vocab), JaxMock(vocab)
        assert ours.encode(text) == theirs.encode(text)
        ids = [2, 0, 1, 299, 3, 258, 259, 1000] + theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
        a, b = ours.make_detokenizer(), theirs.make_detokenizer()
        assert [a.push([i]) for i in ids] == [b.push([i]) for i in ids]


# ------------------------------ the engine -----------------------------------

SHAPES = dict(name="tiny32", vocab_size=300, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
JCFG = jl.LlamaConfig(dtype=jnp.float32, **SHAPES)
TCFG = tl.LlamaConfig(dtype=torch.float32, **SHAPES)
# tests/test_guided.py's engine config
ENGINE = dict(block_size=4, num_blocks=128, max_blocks_per_seq=32,
              max_num_seqs=2, prefill_buckets=(8, 16), seed=3)
PROMPT = list(range(7, 19))
_WEIGHTS = {}


def _weights():
    if "w" not in _WEIGHTS:
        _WEIGHTS["w"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32),
            jl.init_params(JCFG, jax.random.PRNGKey(3)))
    return _WEIGHTS["w"]


def engines(**over):
    kw = {**ENGINE, **over}
    je = JaxEngine(JaxEngineConfig(model_config=JCFG, **kw),
                   params=jax.tree_util.tree_map(jnp.asarray, _weights()))
    te = TorchEngine(EngineConfig(model_config=TCFG, **kw),
                     params=params_from_numpy(_weights(), TCFG, "cpu"),
                     device="cpu")
    return je, te


def _req(jax_side, rid, schema, n, temp=0.0, seed=None, tokens=PROMPT,
         ignore_eos=False, annotations=()):
    R, S, T = ((JaxRequest, JaxSampling, JaxStop) if jax_side
               else (PreprocessedRequest, SamplingOptions, StopConditions))
    return R(token_ids=list(tokens), request_id=rid,
             sampling=S(temperature=temp, seed=seed, guided_json=schema),
             stop=T(max_tokens=n, ignore_eos=ignore_eos),
             annotations=list(annotations))


async def _run(eng, req):
    """(token ids, the final chunk's guided metrics)."""
    ids, last = [], None
    async for out in eng.generate(req):
        assert out.finish_reason != "error", out.error
        ids.extend(out.token_ids)
        last = out
    return ids, {k: v for k, v in (last.metrics or {}).items()
                 if k.startswith("guided")}


def _guided_counters(eng):
    return {k: v for k, v in eng.metrics.items() if k.startswith("guided")}


# (temperature, seed, max_tokens): greedy, seeded samples, and a budget
# that runs out mid-document (a forced close)
GUIDED_REQS = ((0.0, None, 48), (1.2, 1, 48), (1.2, 2, 48), (0.8, 5, 6))


async def test_guided_streams_counters_and_close_metrics_match_jax():
    """Each guided request alone, then all four at once beside an
    unguided one: streams, final-chunk metrics and the engine counters
    equal JAX's; every output is a schema-valid document."""
    je, te = engines()
    out = {}
    for name, eng, side in (("jax", je, True), ("torch", te, False)):
        try:
            alone = [await _run(eng, _req(side, f"g{i}", WEATHER, n, t, s))
                     for i, (t, s, n) in enumerate(GUIDED_REQS)]
            together = await asyncio.gather(
                *[_run(eng, _req(side, f"h{i}", WEATHER, n, t, s))
                  for i, (t, s, n) in enumerate(GUIDED_REQS)],
                _run(eng, _req(side, "u", None, 16, ignore_eos=True)))
            out[name] = (alone, list(together), _guided_counters(eng))
        finally:
            await eng.close()
    assert out["torch"] == out["jax"]
    alone, together, counters = out["torch"]
    assert counters.get("guided_forced_closes", 0) >= 1
    assert counters.get("guided_widened_retries", 0) >= 1
    assert alone[-1][1]["guided_forced_close_tokens"] > 0
    codec = MockTokenizer(SHAPES["vocab_size"])
    for ids, _ in alone + together[:-1]:
        text = codec.decode(ids)
        assert JsonSchemaGuide(WEATHER).done(text.strip()), text
        assert set(json.loads(text)) == {"city", "unit", "days"}
    assert [r[0] for r in together[:-1]] == [r[0] for r in alone]
    assert len(together[-1][0]) == 16


async def test_engine_guided_deterministic_by_seed_and_unguided_unchanged():
    """tests/test_guided.py's test on the port (and equal to JAX's)."""
    je, te = engines()
    out = {}
    for name, eng, side in (("jax", je, True), ("torch", te, False)):
        try:
            a = await _run(eng, _req(side, "a", BOOL, 24, 0.8, 5))
            b = await _run(eng, _req(side, "b", BOOL, 24, 0.8, 5))
            u = await _run(eng, _req(side, "u", None, 24, 0.8, 5,
                                     ignore_eos=True))
            out[name] = (a, b, u)
        finally:
            await eng.close()
    a, b, u = out["torch"]
    assert a == b, "guided sampling not deterministic by seed"
    assert len(u[0]) == 24
    assert out["torch"] == out["jax"]


async def test_guided_slot_never_speculates():
    """An n-gram speculating engine serves a guided request beside a
    repetition prompt: the guided stream equals the spec-off engine's,
    spec rounds ran for the other request only, and both equal JAX's."""
    rep = [5, 9, 13, 2] * 6
    res = {}
    for spec in ("off", "ngram"):
        je, te = engines(spec_decode=spec, spec_k=3)
        for name, eng, side in (("jax", je, True), ("torch", te, False)):
            try:
                res[spec, name] = (await asyncio.gather(
                    _run(eng, _req(side, "g", WEATHER, 32, 0.0)),
                    _run(eng, _req(side, "r", None, 48, tokens=rep,
                                   ignore_eos=True))),
                    eng.metrics.get("spec_steps", 0))
            finally:
                await eng.close()
    assert res["ngram", "torch"] == res["ngram", "jax"]
    assert res["ngram", "torch"][0][0] == res["off", "torch"][0][0]
    assert res["ngram", "torch"][1] > 0


async def test_guided_request_through_a_disagg_pair():
    """A guided request's prefill hop parks its KV with an unconstrained
    first token; the decode side rewinds to the last prompt position
    and its guided step re-derives the first token: the stream equals
    the aggregated engine's guided stream, on a torch pair and on a JAX
    pair."""
    streams = {}
    for side in ("torch", "jax"):
        jax_side = side == "jax"
        je, te = engines()
        agg = je if jax_side else te
        try:
            streams[side, "agg"] = await _run(
                agg, _req(jax_side, "a", WEATHER, 24))
        finally:
            await je.close()
            await te.close()
        pairs = [engines(role=r) for r in ("prefill", "decode")]
        src, dst = (p[0] if jax_side else p[1] for p in pairs)
        for other in (p[1] if jax_side else p[0] for p in pairs):
            await other.close()
        try:
            out = None
            async for o in src.generate(_req(
                    jax_side, "d", WEATHER, 24,
                    annotations=[JAX_DISAGG if jax_side
                                 else DISAGG_ANNOTATION])):
                out = o
            assert out.finish_reason == "stop" and len(out.token_ids) == 1

            async def pull_fn(dp, src=src):
                if jax_side:
                    from dynamo_tpu.disagg.broker import (
                        LocalEnginePullSource,
                    )

                    return LocalEnginePullSource(src, dp["request_id"])
                return broker.LocalEnginePullSource(src, dp["request_id"])

            dst.kv_pull_fn = pull_fn
            dis = _req(jax_side, "d", WEATHER, 24)
            dis.disaggregated_params = out.kv_transfer_params
            streams[side, "pair"] = await _run(dst, dis)
            assert dst.metrics["prefill_tokens"] == 0
        finally:
            await src.close()
            await dst.close()
    assert streams["torch", "pair"] == streams["torch", "agg"] \
        == streams["jax", "pair"] == streams["jax", "agg"]


# ------------------------------ the SLO input --------------------------------


async def test_slo_burn_yields_prefill_budget_like_jax():
    """A reported burn of 4 (threshold 1) while a request decodes: the
    other request's prompt prefills in chunks scaled to a quarter of the
    budget; slo_yield_steps, the prefill dispatches' token counts and the
    streams equal JAX's, and equal the unthrottled streams.  A burn older
    than slo_burn_stale_s reads as 0."""
    long_prompt = list(range(3, 103))
    res = {}
    for burn in (0.0, 4.0):
        je, te = engines(max_batch_tokens=64)
        for name, eng, side in (("jax", je, True), ("torch", te, False)):
            eng.set_slo_burn(burn)
            try:
                streams = await asyncio.gather(
                    _run(eng, _req(side, "s", None, 24, tokens=[5, 6, 7],
                                   ignore_eos=True)),
                    _run(eng, _req(side, "l", None, 4, tokens=long_prompt,
                                   ignore_eos=True)))
                res[burn, name] = (
                    streams, eng.metrics.get("slo_yield_steps", 0),
                    [r["tokens"] for r in eng.fpm if r["kind"] == "prefill"])
            finally:
                await eng.close()
    assert res[4.0, "torch"] == res[4.0, "jax"]
    assert res[0.0, "torch"] == res[0.0, "jax"]
    assert res[4.0, "torch"][1] > 0 and res[0.0, "torch"][1] == 0
    assert max(res[4.0, "torch"][2][1:]) <= 16 < max(res[0.0, "torch"][2])
    assert res[4.0, "torch"][0] == res[0.0, "torch"][0]
    _, te = engines(slo_burn_stale_s=0.2)
    te.set_slo_burn(3.0)
    assert te._effective_slo_burn() == 3.0
    time.sleep(0.3)
    assert te._effective_slo_burn() == 0.0
