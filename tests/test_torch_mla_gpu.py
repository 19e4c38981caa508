"""The DeepSeek MLA family on a card (models/deepseek.py inside the
captured decode programs, engine/graphs.py PaddedPrefillPrograms).

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_mla_gpu.py

The config is the `tiny-mla-moe` preset in bf16 (shared experts, a dense
first layer, dense dispatch; the absorbed decode is plain torch, so any
width runs).  The absorbed decode must stay capturable: a replayed
burst equals its eager body bit for bit, and a graphed engine streams
what an eager engine streams on the same weights.  Its prefill takes
the padded programs: warm-up runs every padded shape, serving builds
nothing more, and no packed or verify program exists.
"""

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

COMMON = dict(model="tiny-mla-moe", block_size=128, num_blocks=64,
              max_blocks_per_seq=8, max_num_seqs=4, seed=3)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the test holds CUDA graphs)")


def _engine(params=None, graphs=True):
    return TorchEngine(EngineConfig(**COMMON), params=params, device="cuda",
                       cuda_graphs=graphs)


@pytest.mark.gpu
def test_mla_decode_burst_replay_equals_eager_on_gpu():
    """A k = 8 greedy burst at 4 lanes (one padding lane) over the
    absorbed MLA decode: the replayed graph's tokens and latent writes
    equal its eager body's."""
    _cuda()
    eng = _engine()
    eng.warmup_decode()
    g = eng.graphs
    a = g.host_descriptor()
    a["tokens"][:3] = (7, 90, 200)
    a["positions"][:3] = a["ctx_lens"][:3] = (40, 100, 3)
    a["tables"][:3, :2] = ((1, 2), (3, 4), (5, 6))
    a["steps"][:] = 1
    a["valid"][:3] = True
    blocks = torch.arange(1, 7, device="cuda")
    before = [t[:, :, blocks].clone() for t in eng.kv]
    snap = g.snapshot()
    g.upload(a)
    eager = g.run_eager(True, 8).clone()
    written = [t[:, :, blocks].clone() for t in eng.kv]
    for t, b in zip(eng.kv, before):
        t[:, :, blocks] = b
    g.restore(snap)
    g.upload(a)
    replay = torch.from_numpy(g.run(True, 8).wait().copy())
    assert torch.equal(eager.cpu(), replay)
    for t, w in zip(eng.kv, written):
        assert torch.equal(t[:, :, blocks], w)
    assert g.counts == {(gr, k): 1 for gr in (True, False)
                        for k in eng._fuse_ladder()}


def _requests():
    rng = np.random.default_rng(2)
    return [PreprocessedRequest(
        token_ids=rng.integers(0, 256, n).tolist(), request_id=f"m{i}",
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=12, ignore_eos=True))
        for i, n in enumerate((300, 40, 129))]


async def _serve(eng):
    async def one(req):
        toks = []
        async for out in eng.generate(req):
            toks.extend(out.token_ids)
        return toks

    try:
        return await asyncio.gather(*(one(r) for r in _requests()))
    finally:
        await eng.close()


@pytest.mark.gpu
def test_mla_engine_streams_equal_eager_engine_on_gpu():
    """Three concurrent requests through the graphed engine (warmed up)
    and through an eager engine on the same weights: identical greedy
    streams; warm-up built every padded shape and serving nothing more;
    no packed or verify program exists."""
    _cuda()
    eng = _engine()
    eng.warmup_decode()
    built = dict(eng.graphs.counts)
    padded = dict(eng.padded_prefill.counts)
    assert set(padded) == set(eng._padded_shapes())
    got = asyncio.run(_serve(eng))
    ref = asyncio.run(_serve(_engine(eng.params, graphs=False)))
    assert got == ref and all(len(t) == 12 for t in got)
    assert eng.graphs.counts == built
    assert eng.padded_prefill.counts == padded
    assert eng.prefill_graphs is None and eng.verify_graphs is None
