"""The port's encoder worker against the JAX package's (CPU).

* media_hash, decode_data_uri, pixels_from_payload (the .npy path, a
  grayscale payload, the nearest-neighbour resize) and EmbeddingCache
  equal JAX's.
* VitEncoder, its weights carried across by models/convert.py
  vit_from_numpy, equals JAX's VitEncoder within 1e-5 on fp32 tiny
  configs with non-symmetric pixels; a swapped patchify (height and
  width transposed) reads far off, so the comparison would see one.
* EncoderWorker streams the same frames, counts the same cache hits and
  keeps the same metrics as JAX's, for the mock and for the ViT (fp32 at
  1e-5; bf16 frames as JAX's: dtype "bfloat16", the same shape and byte
  count, the tower's own bits, rows within chip_smoke.ENCODER_TOL of
  JAX's); its MDC
  is JAX's, and the unchanged JAX frontend's EncoderHop encodes through
  it for a JAX mocker fleet (file discovery).
* `python -m dynamo_tpu_torch.multimodal` registers and deregisters on
  SIGTERM with --device cpu, and exits non-zero without CUDA.
* chip_smoke.py's encoder phase at a tiny width on the CPU.
"""

import asyncio
import base64
import dataclasses
import io
import os
import signal
import subprocess
import sys
import time
import uuid

import aiohttp
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_rehearsal
import chip_smoke
from dynamo_tpu.multimodal import encoder as jenc
from dynamo_tpu.multimodal import EncoderWorker as JaxEncoderWorker
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu_torch.models.convert import vit_from_numpy
from dynamo_tpu_torch.multimodal import (
    EmbeddingCache,
    EncoderWorker,
    MockVisionEncoder,
    VisionConfig,
    VitEncoder,
    media_hash,
)
from dynamo_tpu_torch.multimodal import encoder as tenc
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

pytestmark = pytest.mark.allow_slow_callbacks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VIT_CASES = [dict(image_size=32, patch_size=8, d_model=32, n_layers=2,
                  n_heads=4, out_dim=48),
             dict(image_size=28, patch_size=14, d_model=64, n_layers=3,
                  n_heads=2, out_dim=40)]


def npy_uri(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return ("data:application/x-npy;base64,"
            + base64.b64encode(buf.getvalue()).decode())


def _pixels(n, size, seed=0):
    """Non-symmetric pixels: a ramp along the height on top of noise, so
    a patchify that swaps height and width changes the input."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 1, size, dtype=np.float32)[None, :, None, None]
    return (0.5 * rng.random((n, size, size, 3), dtype=np.float32)
            + 0.5 * ramp).astype(np.float32)


def _vit_pair(case, seed=1, bf16=False):
    """A JAX tower and the port's with its weights (bf16: both in
    bfloat16; the fp32 numpy tree holds the bf16 weights exactly)."""
    jcfg = jenc.VisionConfig(**case, **(
        {"dtype": jnp.bfloat16} if bf16 else {}))
    je = jenc.VitEncoder(jcfg, seed=seed)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  je.params)
    tcfg = VisionConfig(**case, dtype=torch.bfloat16 if bf16 else
                        torch.float32)
    return je, vit_from_numpy(tree, tcfg, device="cpu")


def _frame_array(frame) -> np.ndarray:
    dtype = ml_dtypes.bfloat16 if frame["dtype"] == "bfloat16" \
        else frame["dtype"]
    return np.frombuffer(frame["embedding"], dtype).astype(
        np.float32).reshape(frame["shape"])


# ---------------------------------------------------------------------------
# payloads and the cache
# ---------------------------------------------------------------------------


def test_media_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for arr in (rng.random((9, 13, 3), dtype=np.float32),   # resized
                rng.random((16, 16), dtype=np.float32),     # grayscale
                rng.random((16, 16, 4), dtype=np.float32)):  # alpha dropped
        uri = npy_uri(arr)
        data, mime = tenc.decode_data_uri(uri)
        assert (data, mime) == jenc.decode_data_uri(uri)
        assert mime == "application/x-npy"
        assert tenc.media_hash(data) == jenc.media_hash(data)
        got = tenc.pixels_from_payload(data, mime, 16)
        np.testing.assert_array_equal(
            got, jenc.pixels_from_payload(data, mime, 16))
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
    for mod in (tenc, jenc):
        with pytest.raises(ValueError, match="only data: URIs"):
            mod.decode_data_uri("http://example/x.png")


def test_embedding_cache_lru_equals_jax():
    ops = [("put", "a"), ("put", "b"), ("get", "a"), ("put", "c"),
           ("get", "b"), ("get", "c"), ("get", "a"), ("put", "d"),
           ("get", "c")]
    caches = (EmbeddingCache(capacity=2), jenc.EmbeddingCache(capacity=2))
    for cache in caches:
        cache.trace = [
            (cache.put(k, np.full(2, ord(k), np.float32)) if op == "put"
             else (None if (v := cache.get(k)) is None else int(v[0])))
            for op, k in ops]
    assert caches[0].trace == caches[1].trace
    assert (caches[0].hits, caches[0].misses) == \
        (caches[1].hits, caches[1].misses) == (3, 2)


def test_mock_encoder_equals_jax():
    data = b"some media bytes"
    np.testing.assert_array_equal(
        MockVisionEncoder(3, 8).encode_bytes(data),
        jenc.MockVisionEncoder(3, 8).encode_bytes(data))


# ---------------------------------------------------------------------------
# the ViT tower
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", VIT_CASES, ids=["p8", "p14"])
def test_vit_encoder_matches_jax(case):
    je, te = _vit_pair(case)
    px = _pixels(2, case["image_size"])
    want = je.encode(px)
    got = te.encode(px).numpy()
    assert got.shape == want.shape == (
        2, (case["image_size"] // case["patch_size"]) ** 2, case["out_dim"])
    assert te.n_tokens == je.n_tokens
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a patchify that swapped height and width would read far off
    swapped = te.encode(np.ascontiguousarray(px.transpose(0, 2, 1, 3)))
    assert np.abs(swapped.numpy() - want).max() > 100 * 1e-5


def test_vit_module_layout_and_generator_init():
    cfg = VisionConfig(**VIT_CASES[0])
    a = VitEncoder(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    b = VitEncoder(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k])
                                        for k in sa)
    assert sa["layers.0.w1"].shape == (cfg.d_model, 4 * cfg.d_model)
    assert sa["final_norm"].dtype == torch.float32
    assert not any(p.requires_grad for p in a.parameters())
    bf = VitEncoder(dataclasses.replace(cfg, dtype=torch.bfloat16),
                    device="cpu")
    out = bf.encode(_pixels(1, cfg.image_size))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    # no generator: one seeded with 0
    sd = VitEncoder(cfg, device="cpu").state_dict()
    s0 = VitEncoder(cfg, device="cpu", generator=torch.Generator()
                    .manual_seed(0)).state_dict()
    assert all(torch.equal(sd[k], s0[k]) for k in sd)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            VitEncoder(cfg)  # the default device is CUDA


# ---------------------------------------------------------------------------
# the worker against JAX's
# ---------------------------------------------------------------------------


def _fresh(pkg):
    if pkg == "jax":
        return JaxRuntime(config=JaxRuntimeConfig(
            discovery_backend="mem", event_plane="inproc"),
            cluster_id=uuid.uuid4().hex)
    return DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc"),
        cluster_id=uuid.uuid4().hex)


async def _drive(rt, worker, requests):
    """Every frame of `requests` sent one after another."""
    await worker.start()
    client = await (rt.namespace("dynamo").component("encoder")
                    .endpoint("encode").client()).start()
    await client.wait_for_instances()
    frames = []
    for req in requests:
        frames.append([f async for f in client.generate(req)])
    card = (await rt.discovery.get_prefix(
        worker.card.key(worker.served.instance_id)))
    await client.close()
    metrics = dict(worker.metrics)
    hits = (worker.cache.hits, worker.cache.misses)
    await worker.close()
    await rt.shutdown()
    return frames, metrics, hits, list(card.values())


@pytest.mark.parametrize("kind", ["mock", "vit", "vit-bf16"])
async def test_encoder_worker_frames_and_metrics_equal_jax(kind):
    size = VIT_CASES[1]["image_size"]
    imgs = _pixels(3, size, seed=2)
    uris = [npy_uri(i) for i in imgs]
    items = [{"media_hash": media_hash(u.partition(",")[2].encode()),
              "data_uri": u} for u in uris]
    requests = [{"request_id": "a", "items": items[:2]},
                {"request_id": "b", "items": [items[1], items[2]]},
                {"request_id": "c", "items": [items[0], items[0]]}]
    if kind == "mock":
        encs = (MockVisionEncoder(5, 8), jenc.MockVisionEncoder(5, 8))
    else:
        je, te = _vit_pair(VIT_CASES[1], bf16=kind == "vit-bf16")
        encs = (te, je)
    out = {}
    for pkg, enc, cls in (("port", encs[0], EncoderWorker),
                          ("jax", encs[1], JaxEncoderWorker)):
        rt = await _fresh(pkg).start()
        worker = cls(rt, "mm-model", encoder=enc, cache_capacity=2,
                     image_token_id=7)
        out[pkg] = await _drive(rt, worker, requests)
    (pf, pm, ph, pc), (jf, jm, jh, jc) = out["port"], out["jax"]
    assert pm == jm and ph == jh and pc == jc
    assert pc[0]["runtime_config"] == {"role": "encoder",
                                       "image_token_id": 7}
    for p_req, j_req in zip(pf, jf):
        assert len(p_req) == len(j_req)
        for p, j in zip(p_req, j_req):
            assert {k: p[k] for k in p if k != "embedding"} == \
                {k: j[k] for k in j if k != "embedding"}
            assert len(p["embedding"]) == len(j["embedding"])
            a, b = _frame_array(p), _frame_array(j)
            if kind == "vit-bf16":
                # two bf16 towers round apart; each row stays close
                rel = (np.linalg.norm(a - b, axis=-1)
                       / np.linalg.norm(b, axis=-1))
                assert rel.max() <= chip_smoke.ENCODER_TOL
            else:
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert [f["cached"] for r in pf for f in r] == \
        [False, False, True, False, False, True]
    if kind == "vit-bf16":
        # the frame carries the port tower's own bf16 bits
        own = encs[0].encode(imgs[:1])[0]
        assert pf[0][0]["embedding"] == \
            own.view(torch.int16).numpy().tobytes()


async def test_jax_frontend_hop_encodes_through_the_port_worker(tmp_path):
    from dynamo_tpu.frontend import HttpService, ModelManager, ModelWatcher
    from dynamo_tpu.mocker import MockEngineArgs, MockerWorker

    disc = dict(discovery_backend="file", discovery_path=str(tmp_path),
                event_plane="zmq")
    jrt = await JaxRuntime(config=JaxRuntimeConfig(**disc)).start()
    prt = await DistributedRuntime(config=RuntimeConfig(**disc)).start()
    worker = await MockerWorker(jrt, MockEngineArgs(
        model_name="mm-model", block_size=4, base_step_s=0.0005,
        prefill_s_per_token=0.0, decode_s_per_seq=0.0)).start()
    _, te = _vit_pair(VIT_CASES[1])
    enc = await EncoderWorker(prt, "mm-model", encoder=te).start()
    manager = ModelManager()
    watcher = await ModelWatcher(jrt, manager).start()
    service = await HttpService(jrt, manager, host="127.0.0.1",
                                port=0).start()
    try:
        port = service._runner.addresses[0][1]
        for _ in range(500):
            p = manager.get("mm-model")
            if p is not None and p.encoder is not None \
                    and p.encoder.client.instance_ids:
                break
            await asyncio.sleep(0.02)
        uri = npy_uri(_pixels(1, 28, seed=3)[0])
        body = {"model": "mm-model", "max_tokens": 4, "ignore_eos": True,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "what is in "},
                    {"type": "image_url", "image_url": {"url": uri}}]}]}
        text_only = dict(body, messages=[{"role": "user",
                                          "content": "what is in "}])
        async with aiohttp.ClientSession() as s:
            url = f"http://127.0.0.1:{port}/v1/chat/completions"
            async with s.post(url, json=body) as r:
                assert r.status == 200, await r.text()
                data = await r.json()
            async with s.post(url, json=text_only) as r:
                base = (await r.json())["usage"]["prompt_tokens"]
        # the tower's 4 patch tokens spliced in as placeholders
        assert data["usage"]["prompt_tokens"] == base + te.n_tokens
        assert enc.metrics["items"] == 1 and enc.metrics["prompt_tokens"] == 4
    finally:
        await service.close()
        await watcher.close()
        await enc.close()
        await worker.close()
        await prt.shutdown()
        await jrt.shutdown()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without CUDA")
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.multimodal",
         "--model-name", "m"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 2 and "cuda" in out.stderr


def test_cli_registers_and_sigterm_deregisters(tmp_path):
    env = dict(os.environ, DYN_DISCOVERY_BACKEND="file",
               DYN_DISCOVERY_PATH=str(tmp_path), DYN_EVENT_PLANE="inproc")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.multimodal",
         "--model-name", "mm-cli", "--encoder", "vit", "--image-size", "32",
         "--vision-dim", "32", "--out-dim", "16", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("ready instance_id="), proc.stderr.read()
        mdc = list(tmp_path.rglob("*.json"))
        assert any("mm-cli" in str(p) for p in mdc)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert list(tmp_path.rglob("*.json")) == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# chip_smoke.py's encoder phase on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_encoder_phase_at_tiny_width(monkeypatch):
    chip_rehearsal.rehearse(monkeypatch)
    cfg = VisionConfig(image_size=56, patch_size=14, d_model=64, n_layers=2,
                       n_heads=4, out_dim=256, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    out = chip_smoke.check_encoder(torch.device("cpu"), "cpu", cfg)
    assert time.perf_counter() - t0 < 60
    assert out["err"] <= chip_smoke.ENCODER_TOL < out["fault"]
    assert set(out["launches"].values()) == {0}
    flops = chip_smoke.vit_flops(VisionConfig(**chip_smoke.VIT_L))
    # ViT-L/14-336: 576 patches, ~0.35 TFLOP of products an image
    assert VisionConfig(**chip_smoke.VIT_L).n_patches == 576
    assert 0.3e12 < flops[0] < 0.4e12
