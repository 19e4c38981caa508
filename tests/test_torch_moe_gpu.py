"""The MoE family on a card (models/llama.py routing and dispatch inside
the captured programs, engine/graphs.py PaddedPrefillPrograms).

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_moe_gpu.py

The config is the `tiny` preset's widths (head_dim 64, which kernels K1
and K3 take; `tiny-moe`'s 16 they do not) with 4 experts, top 2, in
bf16.  Routing on a card must stay capturable: a replayed decode burst
equals its eager body bit for bit in both dispatches, and a graphed
engine streams what an eager engine streams on the same weights.  Under
capacity dispatch the packed programs are never built: warm-up runs the
padded shapes, and serving builds nothing more.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models.llama import PRESETS
from dynamo_tpu_torch.protocols import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

CFG = dataclasses.replace(PRESETS["tiny"], name="tiny-moe-gpu", n_layers=2,
                          n_experts=4, experts_per_token=2)
COMMON = dict(block_size=128, num_blocks=64, max_blocks_per_seq=8,
              max_num_seqs=4, seed=3)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _engine(dispatch, params=None, graphs=True):
    cfg = dataclasses.replace(CFG, moe_dispatch=dispatch)
    return TorchEngine(EngineConfig(model_config=cfg, **COMMON),
                       params=params, device="cuda", cuda_graphs=graphs)


@pytest.mark.gpu
@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_decode_burst_replay_equals_eager_on_gpu(dispatch):
    """A k = 8 greedy burst at 4 lanes (one padding lane) over a MoE
    trunk: the replayed graph's tokens equal its eager body's."""
    _cuda()
    eng = _engine(dispatch)
    eng.warmup_decode()
    g = eng.graphs
    a = g.host_descriptor()
    a["tokens"][:3] = (7, 900, 31000)
    a["positions"][:3] = a["ctx_lens"][:3] = (40, 100, 3)
    a["tables"][:3, :2] = ((1, 2), (3, 4), (5, 6))
    a["steps"][:] = 1
    a["valid"][:3] = True
    snap = g.snapshot()
    g.upload(a)
    eager = g.run_eager(True, 8).clone()
    g.restore(snap)
    g.upload(a)
    replay = torch.from_numpy(g.run(True, 8).wait().copy())
    assert torch.equal(eager.cpu(), replay)
    assert g.counts == {(gr, k): 1 for gr in (True, False)
                        for k in eng._fuse_ladder()}


def _requests():
    rng = np.random.default_rng(2)
    return [PreprocessedRequest(
        token_ids=rng.integers(0, 32000, n).tolist(), request_id=f"m{i}",
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
@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_engine_streams_equal_eager_engine_on_gpu(dispatch):
    """Three concurrent requests through the graphed engine (warmed up)
    and through an eager engine on the same weights: identical greedy
    streams; nothing is built while serving; capacity dispatch never
    builds a packed program."""
    _cuda()
    eng = _engine(dispatch)
    eng.warmup_decode()
    built = (dict(eng.graphs.counts), dict(eng.prefill_graphs.counts))
    padded = (dict(eng.padded_prefill.counts)
              if eng.padded_prefill is not None else None)
    got = asyncio.run(_serve(eng))
    ref = asyncio.run(_serve(_engine(dispatch, eng.params, graphs=False)))
    assert got == ref and all(len(t) == 12 for t in got)
    assert (eng.graphs.counts, eng.prefill_graphs.counts) == built
    if dispatch == "capacity":
        assert eng.prefill_graphs.counts == {}
        assert eng.padded_prefill.counts == padded
    else:
        assert eng.padded_prefill is None
        assert set(eng.prefill_graphs.counts) == set(
            eng.prefill_graphs.buckets)
