"""LoRA serving and the guided top-M programs on a card.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_lora_gpu.py

* Base requests on an engine with an adapter bank stream exactly what
  the bank-less engine streams (slot 0 adds an exact zero), greedy and
  sampled, while an adapter request shares their bursts.
* A replayed decode burst with the `lidx` lane (lanes on slots 0, 1, 2)
  writes what its eager body writes, tokens and K/V bit for bit; so does
  a replayed guided top-M program (M = 32 and 256): ids and values.
* Serving adapter and guided requests captures no program: warm-up
  built every decode, prefill and guided program once.
* An adapter load that arrives while warm-up is capturing waits for it
  (the bank write is a scheduler op): every capture succeeds and the
  adapter request streams what a fresh engine streams.
"""

import asyncio
import json
import os
import struct

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

SCHEMA = {"type": "object", "properties": {"city": {"type": "string"},
                                           "unit": {"enum": ["c", "f"]}}}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _write_adapter(root, name, rank, seed, scale=0.5):
    """A PEFT adapter for the tiny preset (all four attention targets,
    fp32, alpha = 2 rank), written with the standard library."""
    cfg = PRESETS["tiny"]
    gen = torch.Generator().manual_seed(seed)
    dims = {"q": (cfg.d_model, cfg.q_dim), "k": (cfg.d_model, cfg.kv_dim),
            "v": (cfg.d_model, cfg.kv_dim), "o": (cfg.q_dim, cfg.d_model)}
    tensors = {}
    for li in range(cfg.n_layers):
        for t, (d_in, d_out) in dims.items():
            p = f"base_model.model.model.layers.{li}.self_attn.{t}_proj"
            tensors[f"{p}.lora_A.weight"] = scale * torch.randn(
                rank, d_in, generator=gen) / d_in ** 0.5
            tensors[f"{p}.lora_B.weight"] = scale * torch.randn(
                d_out, rank, generator=gen) / rank ** 0.5
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": 2 * rank,
                   "base_model_name_or_path": "tiny"}, f)
    header, off = {}, 0
    for k, t in tensors.items():
        header[k] = {"dtype": "F32", "shape": list(t.shape),
                     "data_offsets": [off, off + t.numel() * 4]}
        off += t.numel() * 4
    hb = json.dumps(header).encode()
    hb += b" " * ((-(8 + len(hb))) % 8)
    with open(os.path.join(d, "adapter_model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(hb)) + hb)
        for t in tensors.values():
            f.write(t.contiguous().numpy().tobytes())


def _engine(lora_dir=None, **over):
    kw = dict(model="tiny", block_size=128, num_blocks=96,
              max_blocks_per_seq=16, max_num_seqs=4)
    if lora_dir is not None:
        kw.update(lora_max_adapters=2, lora_rank=8, lora_dir=str(lora_dir))
    kw.update(over)
    return TorchEngine(EngineConfig(**kw), device="cuda")


def _req(rid, n=16, lora=None, temp=0.0, seed=None, schema=None,
         prompt_len=200, prompt_seed=0):
    toks = np.random.default_rng(prompt_seed).integers(
        3, 32000, prompt_len).tolist()
    return PreprocessedRequest(
        token_ids=toks, request_id=rid, lora_name=lora,
        sampling=SamplingOptions(temperature=temp, seed=seed,
                                 guided_json=schema),
        stop=StopConditions(max_tokens=n, ignore_eos=schema is None))


async def _collect(eng, req):
    toks = []
    async for out in eng.generate(req):
        assert out.finish_reason != "error", out.error
        toks.extend(out.token_ids)
    return toks


def _serve(eng, reqs):
    async def run():
        try:
            return list(await asyncio.gather(*[_collect(eng, r)
                                               for r in reqs]))
        finally:
            await eng.close()

    return asyncio.run(run())


def _counts(eng):
    return (dict(eng.graphs.counts), dict(eng.prefill_graphs.counts),
            dict(eng.guided_graphs.counts))


@pytest.mark.gpu
def test_base_streams_on_lora_engine_equal_bankless_on_gpu(tmp_path):
    _needs_card()
    _write_adapter(tmp_path, "ad1", 8, seed=1)
    base = [_req("g0", prompt_seed=0),
            _req("s1", temp=0.8, seed=7, prompt_seed=1),
            _req("g2", prompt_len=37, prompt_seed=2)]
    plain = _engine()
    plain.warmup_decode()
    want = _serve(plain, base)
    lora = _engine(tmp_path)
    lora.warmup_decode()
    built = _counts(lora)
    got = _serve(lora, base + [_req("a", lora="ad1", prompt_seed=3)])
    assert got[:3] == want
    assert lora._lora_slots == {"ad1": 1}
    assert _counts(lora) == built


@pytest.mark.gpu
def test_lora_burst_and_topm_replays_equal_eager_on_gpu(tmp_path):
    _needs_card()
    for i, name in enumerate(("ad1", "ad2")):
        _write_adapter(tmp_path, name, 4 + 4 * i, seed=i + 1)
    eng = _engine(tmp_path)
    eng.warmup_decode()
    _serve(eng, [_req("a1", 2, lora="ad1"), _req("a2", 2, lora="ad2")])
    g, k = eng.graphs, 4
    a = g.host_descriptor()
    lens = [700, 300, 129, 37]
    gen = torch.Generator(device="cuda").manual_seed(5)
    nxt = 1
    for b, n in enumerate(lens):
        need = -(-(n + k) // 128)
        a["tables"][b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    blocks = torch.arange(1, nxt, device="cuda")
    for t in eng.kv:
        t[:, :, blocks] = torch.randn(
            (t.shape[0], t.shape[1], len(blocks), *t.shape[3:]),
            generator=gen, device="cuda").to(t.dtype)
    a["tokens"][:] = [11, 22, 33, 44]
    a["positions"][:] = a["ctx_lens"][:] = lens
    a["steps"][:] = 1
    a["valid"][:] = True
    a["lidx"][:] = [0, 1, 2, 1]
    saved = [t[:, :, blocks].clone() for t in eng.kv]
    snap = g.snapshot()
    g.upload(a)
    eager = g.run_eager(True, k).clone()
    written = [t[:, :, blocks].clone() for t in eng.kv]
    for t, s in zip(eng.kv, saved):
        t[:, :, blocks] = s
    g.restore(snap)
    g.upload(a)
    replay = torch.from_numpy(g.run(True, k).wait()).cuda()
    assert torch.equal(replay, eager)
    for t, w in zip(eng.kv, written):
        assert torch.equal(t[:, :, blocks], w)
    # the guided programs: lane 1 over its 300-token context
    gg = eng.guided_graphs
    d = gg.host_descriptor()
    d["tokens"][1] = 9
    d["positions"][1] = d["ctx_lens"][1] = 300
    d["tables"][1] = a["tables"][1]
    d["valid"][1] = True
    for m in gg.ms:
        gg.upload(d)
        ids_e, vals_e = (t.clone() for t in gg.run_eager(m))
        gg.upload(d)
        ids_r, vals_r = (torch.from_numpy(b.wait()) for b in gg.run(m))
        assert torch.equal(ids_r, ids_e.cpu())
        assert torch.equal(vals_r, vals_e.cpu())
        assert ids_r.shape == (4, m)
    assert gg.counts == {32: 1, 256: 1}


@pytest.mark.gpu
def test_no_capture_while_serving_lora_and_guided_on_gpu(tmp_path):
    _needs_card()
    _write_adapter(tmp_path, "ad1", 8, seed=1)
    _write_adapter(tmp_path, "ad2", 4, seed=2)
    eng = _engine(tmp_path)
    eng.warmup_decode()
    built = _counts(eng)
    assert built[2] == {32: 1, 256: 1}
    out = _serve(eng, [
        _req("b", 24, prompt_seed=0), _req("a1", 24, lora="ad1",
                                            prompt_seed=1),
        _req("a2", 24, lora="ad2", prompt_seed=2),
        _req("g", 40, temp=0.7, seed=3, schema=SCHEMA, prompt_seed=3)])
    assert [len(t) for t in out[:3]] == [24, 24, 24]
    from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
    from dynamo_tpu_torch.guided import JsonSchemaGuide

    text = MockTokenizer(32000).decode(out[3])
    assert JsonSchemaGuide(SCHEMA).done(text.strip()), text
    assert _counts(eng) == built


@pytest.mark.gpu
def test_bank_write_during_warmup_capture_on_gpu(tmp_path):
    """Warm-up runs on a worker thread (as TorchEngineWorker.start runs
    it), holding the step lock across its captures; an adapter request
    arrives meanwhile.  Its bank write waits for the lock, no capture
    fails, and its stream equals the same request's on a fresh
    engine."""
    _needs_card()
    _write_adapter(tmp_path, "ad1", 8, seed=1)
    req = _req("a", 12, lora="ad1")
    eng = _engine(tmp_path)

    async def run():
        warm = asyncio.ensure_future(asyncio.to_thread(eng.warmup_decode))
        # once the first prefill bucket is captured, the rest follow
        while not eng.prefill_graphs.counts:
            await asyncio.sleep(0.001)
        try:
            toks = await _collect(eng, req)
        finally:
            await warm
            await eng.close()
        return toks

    got = asyncio.run(run())
    ladder = eng._fuse_ladder()
    assert eng.graphs.counts == {(gr, k): 1 for gr in (True, False)
                                 for k in ladder}
    assert eng.guided_graphs.counts == {32: 1, 256: 1}
    fresh = _engine(tmp_path)
    fresh.warmup_decode()
    assert _serve(fresh, [req]) == [got]
