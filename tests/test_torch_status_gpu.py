"""The worker's status plane on a card: the system-status server, the
roofline gauges of a captured engine and /debug/profile naming K1.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_status_gpu.py

* A TorchEngineWorker (the tiny preset, warm-up captures every program)
  on a runtime serving the status server on an ephemeral port: /live and
  /health answer 200, /debug/state is token-gated; after a few requests
  /metrics carries dynamo_engine_mbu{phase="decode"} and
  dynamo_engine_mfu{phase="prefill"} in (0, 1] against the card's peaks,
  one compile sample per captured program and no capture while serving.
* /debug/profile taken while four streams decode returns status "ok", a
  Chrome trace whose device events name K1's kernel (inside CUDA graph
  replays) and a device-memory snapshot.
"""

import asyncio
import json
import uuid

import pytest
import torch

from chip_smoke import _http
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

TOKEN = "gpu-test-admin"


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _gauge(text, name, phase):
    for line in text.splitlines():
        if line.startswith(name + "{") and f'phase="{phase}"' in line:
            return float(line.rsplit(" ", 1)[1])
    return None


async def _run():
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="mem", event_plane="inproc", tcp_host="127.0.0.1",
        system_port=-1, admin_token=TOKEN),
        cluster_id=uuid.uuid4().hex).start()
    cfg = EngineConfig(model="tiny", block_size=128, num_blocks=96,
                       max_blocks_per_seq=16, max_num_seqs=4, warmup=True,
                       peak_tflops=989.0, peak_hbm_gbps=3350.0)
    worker = await TorchEngineWorker(rt, cfg, device="cuda").start()
    addr = rt.system_address
    out = {"live": (await _http(addr, "/live"))[0],
           "health": (await _http(addr, "/health"))[0],
           "denied": (await _http(addr, "/debug/state"))[0]}
    try:
        async def one(i, n):
            req = PreprocessedRequest(
                token_ids=list(range(5 + i, 300 + 37 * i)),
                request_id=f"g{i}-{n}",
                stop=StopConditions(max_tokens=n, ignore_eos=True))
            async for _ in worker.engine.generate(req):
                pass

        # two waves, so a second prefill dispatch lands inside the first
        # wave's decode: a prefill rate needs two dispatches under 1 s
        first = [asyncio.create_task(one(i, 48)) for i in range(2)]
        await asyncio.sleep(0.2)
        await asyncio.gather(*first, *(one(i, 48) for i in range(2, 4)))
        await asyncio.sleep(1.1)
        st, body = await _http(addr, "/metrics")
        text = body.decode()
        out["mbu"] = _gauge(text, "dynamo_engine_mbu", "decode")
        out["mfu"] = _gauge(text, "dynamo_engine_mfu", "prefill")
        out["compiles"] = sum(
            float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("dynamo_engine_compile_seconds_count"))
        out["built"] = sum(len(p.counts)
                           for p in worker.engine._program_families())
        out["serving"] = "dynamo_engine_serving_compiles_total{" in text
        runs = [asyncio.create_task(one(i, 400)) for i in range(4)]
        await asyncio.sleep(0.3)
        st, body = await _http(addr, "/debug/profile?duration_s=0.5",
                               "POST", token=TOKEN)
        await asyncio.gather(*runs)
        prof = json.loads(body)
        out["profile"] = prof
        if prof.get("status") == "ok":
            trace = json.load(open(prof["trace_file"]))
            out["k1"] = sum(1 for e in trace["traceEvents"]
                            if e.get("cat") == "kernel"
                            and "paged_decode_kernel" in e.get("name", ""))
        return out
    finally:
        await worker.close()
        await rt.shutdown()


@pytest.mark.gpu
def test_status_plane_on_gpu():
    _needs_card()
    out = asyncio.run(_run())
    assert (out["live"], out["health"], out["denied"]) == (200, 200, 401)
    assert 0.0 < out["mbu"] <= 1.0 and 0.0 < out["mfu"] <= 1.0, out
    assert out["compiles"] == out["built"] > 0 and not out["serving"]
    prof = out["profile"]
    assert prof["status"] == "ok" and prof["backend"] == "cuda", prof
    assert out["k1"] > 0
    snap = json.load(open(prof["memory_profile"]))
    assert snap["mem_get_info"]["total"] > snap["mem_get_info"]["free"] > 0
