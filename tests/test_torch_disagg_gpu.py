"""Disagg across two processes on one card: the device tier over CUDA IPC.

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_disagg_gpu.py

A prefill worker process (`python -m dynamo_tpu_torch.engine --role
prefill`, the tiny preset, random weights from the engine's seed) and a
decode TorchEngineWorker in the test process (the same weights: the
same seed on the same card), both opted in with DYN_KV_TRANSFER_SERVER=1,
on file discovery with the in-process event plane:

* a pull negotiates CUDA IPC and moves device chunks only; the decode
  stream equals an aggregated engine's and the decode side prefills
  nothing;
* the same prompt pulled again with the opt-in taken away from the test
  process lands host-staged frames (crc32-checked sender bytes) that are
  bit-equal, over the prompt's positions, to what the IPC pull landed;
* the prefill process's drain finds no staged chunk left (every pull's
  close released its buffer), and it exits 0 on SIGTERM.
"""

import asyncio
import dataclasses
import os
import re
import select
import signal
import subprocess
import sys
import time
import uuid
from pathlib import Path

import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, TorchEngineWorker
from dynamo_tpu_torch.ops.kv_transfer import gather_universal
from dynamo_tpu_torch.protocols import (
    DISAGG_ANNOTATION,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

CFG = dict(model="tiny", block_size=128, num_blocks=64, max_blocks_per_seq=8,
           max_num_seqs=4)
# 5 blocks, the last one partial
PROMPT = [(7 * i + 3) % 32000 for i in range(600)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _req(rid, annotations=()):
    return PreprocessedRequest(
        token_ids=list(PROMPT), request_id=rid,
        sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=16, ignore_eos=True),
        annotations=list(annotations))


def _start_prefill_process(disc: str, log_path: str):
    env = dict(os.environ, DYN_KV_TRANSFER_SERVER="1",
               DYN_DISCOVERY_BACKEND="file", DYN_DISCOVERY_PATH=disc,
               DYN_EVENT_PLANE="inproc", DYN_LOG_JSON="0",
               DYN_LOG_LEVEL="INFO")
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.engine", "--role",
           "prefill", "--component", "prefill", "--model", CFG["model"],
           "--block-size", str(CFG["block_size"]),
           "--num-blocks", str(CFG["num_blocks"]),
           "--max-blocks-per-seq", str(CFG["max_blocks_per_seq"]),
           "--max-num-seqs", str(CFG["max_num_seqs"])]
    with open(log_path, "w") as err:
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True,
                                cwd=Path(__file__).resolve().parent.parent)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        if select.select([proc.stdout], [], [], 1.0)[0]:
            line = proc.stdout.readline()
            if line.startswith("ready instance_id="):
                return proc
            if not line and proc.poll() is not None:
                break
    proc.kill()
    proc.wait()
    pytest.fail("the prefill worker process did not get ready:\n"
                + Path(log_path).read_text()[-3000:])


async def _aggregated():
    eng = TorchEngine(EngineConfig(**CFG), device="cuda")
    await asyncio.to_thread(eng.warmup_decode)
    try:
        toks = []
        async for out in eng.generate(_req("agg")):
            toks.extend(out.token_ids)
        return toks
    finally:
        await eng.close()


async def _pulls(disc: str, monkeypatch):
    """Two pulls of PROMPT from the prefill process: over CUDA IPC, then
    host-staged.  Returns [(tokens, pull stats, landed blocks)]."""
    monkeypatch.setenv("DYN_KV_TRANSFER_SERVER", "1")
    rt = await DistributedRuntime(config=RuntimeConfig(
        discovery_backend="file", discovery_path=disc, event_plane="inproc",
        tcp_host="127.0.0.1"), cluster_id=uuid.uuid4().hex).start()
    dw = await TorchEngineWorker(rt, EngineConfig(**CFG, role="decode"),
                                 device="cuda").start()
    clients = []
    for comp, ep in (("prefill", "generate"), ("backend", "generate"),
                     ("prefill", "clear_kv_blocks")):
        c = await rt.namespace("dynamo").component(comp).endpoint(
            ep).client().start()
        await c.wait_for_instances()
        clients.append(c)
    pclient, dclient, pclear = clients
    landed = {}
    inject = dw.engine._inject_pulled_chunk

    def recorded(slot, b0, n, arrs):
        inject(slot, b0, n, arrs)
        ids = dw.engine.allocator.seq_block_ids(
            slot.request.request_id)[b0:b0 + n]
        landed[b0] = gather_universal(dw.engine.kv, ids)

    dw.engine._inject_pulled_chunk = recorded
    out = []
    try:
        for opt_in in ("1", "0"):
            monkeypatch.setenv("DYN_KV_TRANSFER_SERVER", opt_in)
            await dw.engine.clear_kv_blocks()
            async for _ in pclear.generate({}):
                pass
            landed.clear()
            m0 = dict(dw.engine.metrics)
            hop = [o async for o in pclient.generate(
                _req("p", [DISAGG_ANNOTATION]).to_dict())]
            req = dataclasses.replace(
                _req("p"), disaggregated_params=hop[0]["kv_transfer_params"])
            toks = [t async for o in dclient.generate(req.to_dict())
                    for t in o.get("token_ids", [])]
            assert dw.engine.metrics["prefill_tokens"] \
                == m0["prefill_tokens"]
            assert dw.engine.metrics["pull_blocks"] \
                - m0.get("pull_blocks", 0) == 5
            out.append((toks, dict(dw.pull_stats["p"]), dict(landed)))
    finally:
        for c in clients:
            await c.close()
        await dw.close()
        await rt.shutdown()
    return out


def _prompt_rows(t, b0):
    bs = CFG["block_size"]
    keep = min(t.shape[1] * bs, len(PROMPT) - b0 * bs)
    return t.reshape(t.shape[0], t.shape[1] * bs, *t.shape[3:])[:, :keep]


@pytest.mark.gpu
def test_cross_process_pull_over_cuda_ipc_on_gpu(tmp_path, monkeypatch):
    _needs_card()
    want = asyncio.run(_aggregated())
    disc, log_path = str(tmp_path / "discovery"), str(tmp_path / "pw.log")
    proc = _start_prefill_process(disc, log_path)
    try:
        (ipc_toks, ipc, ipc_blocks), (host_toks, host, host_blocks) = \
            asyncio.run(_pulls(disc, monkeypatch))
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    log = Path(log_path).read_text()
    assert len(want) == 16
    assert ipc_toks == want and host_toks == want
    assert ipc.get("device_chunks", 0) >= 1
    assert not ipc.get("host_bytes") and not ipc.get("fallbacks")
    assert host.get("host_chunks", 0) >= 1 and not host.get("device_chunks")
    assert sorted(ipc_blocks) == sorted(host_blocks)
    for b0 in ipc_blocks:
        for a, b in zip(ipc_blocks[b0], host_blocks[b0]):
            assert torch.equal(_prompt_rows(a, b0).contiguous()
                               .view(torch.uint8),
                               _prompt_rows(b, b0).contiguous()
                               .view(torch.uint8))
    assert rc == 0, log[-3000:]
    assert re.findall(r"drain: dropped (\d+) staged", log) == ["0"], \
        log[-3000:]
