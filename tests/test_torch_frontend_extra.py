"""The port's Anthropic, Responses, Files and Batches routes against the
JAX frontend's (CPU).

One fleet for the module (tests/torch_fleet.py): a lockstep tiny fp32
TorchEngineWorker behind both frontends in kv mode, each with its own
file store.  Every case sends the same request to both, from a cleared
prefix cache, and compares status and body (or SSE events: name and
data), ids and timestamps aside:

* `/v1/messages` unary and streamed (system prompts, stop sequences,
  tools), its errors, and `/v1/messages/count_tokens`; the message's
  text equals `/v1/chat/completions`' for the same prompt;
* `/v1/responses` unary and streamed, chained by `previous_response_id`,
  GET and DELETE;
* `/v1/files` multipart and JSON uploads, list, get, content, delete,
  path traversal, and 413 past the store's cap with no staged file left;
* `/v1/batches` run to `completed` (its output file's bodies equal to
  the same requests sent directly), listed, cancelled and validated;
* the port's server around them: a slow upload does not hold up other
  connections, a dropped upload leaves no staged file, and
  `HttpService.close` ends a running batch.
"""

import asyncio
import json
import os

import aiohttp
import pytest
import torch

from dynamo_tpu.frontend.openai_extra import FileStore as JaxFileStore
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.frontend.openai_extra import FileStore
from dynamo_tpu_torch.models.llama import LlamaConfig
from torch_fleet import WAIT_S, Frontends, LoopThread, read, wait_for

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
# 256-token context: a chained response replays its history
LOCKSTEP = dict(block_size=4, num_blocks=128, max_blocks_per_seq=64,
                max_num_seqs=4, prefill_buckets=(8, 16, 32, 64, 128),
                seed=7, overlap_scheduling=False, decode_fused_steps=1)
TOK = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
TOOLS = [{"name": "get_weather", "description": "weather by city",
          "input_schema": {"type": "object",
                           "properties": {"city": {"type": "string"}}}}]


class _Fleet:
    async def start(self, root):
        self.fe = await Frontends().start(root / "cluster")
        self.worker = await TorchEngineWorker(
            self.fe.prt, EngineConfig(model_config=LlamaConfig(
                dtype=torch.float32, **SHAPES), model_name="m", **LOCKSTEP),
            tokenizer_cfg=TOK, device="cpu").start()
        self.stores = [JaxFileStore(str(root / "files-jax")),
                       FileStore(str(root / "files-port"))]
        for svc, store in zip(self.fe.services, self.stores):
            svc.extra.files = store
        await self.fe.wait_model("m")
        return self

    async def both(self, path, body=None, method="POST", **kw):
        got = []
        for url in self.fe.urls:
            await self.worker.engine.clear_kv_blocks()
            if method == "POST":
                got.append(await self.fe.post(url, path, body, **kw))
            else:
                got.append(await self.fe.get(url, path, method))
        return got

    async def close(self):
        await self.fe.close()
        await self.worker.close()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    loop = LoopThread()
    f = loop.run(_Fleet().start(tmp_path_factory.mktemp("extra")))
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
MSG = {"model": "m", "max_tokens": 6, "temperature": 0.0,
       "ignore_eos": True,
       "messages": [{"role": "user", "content": PROMPT}]}
MESSAGES = {
    "unary": MSG,
    "stream": dict(MSG, stream=True),
    "system_blocks": dict(MSG, system=[{"type": "text", "text": "be brief"}],
                          messages=[{"role": "user", "content": [
                              {"type": "text", "text": PROMPT}]}]),
    "tools": dict(MSG, tools=TOOLS),
    "tools_stream": dict(MSG, tools=TOOLS, stream=True),
    "tool_round_trip": dict(MSG, messages=[
        {"role": "user", "content": "weather?"},
        {"role": "assistant", "content": [
            {"type": "tool_use", "id": "toolu_1", "name": "get_weather",
             "input": {"city": "Paris"}}]},
        {"role": "user", "content": [
            {"type": "tool_result", "tool_use_id": "toolu_1",
             "content": [{"type": "text", "text": "sunny"}]},
            {"type": "text", "text": "and tomorrow?"}]}]),
    "no_max_tokens": {"model": "m", "messages": [
        {"role": "user", "content": "x"}]},
    "unknown_model": dict(MSG, model="nope"),
    "bad_messages": dict(MSG, messages="x"),
    "bad_block": dict(MSG, messages=[{"role": "user", "content": [
        {"type": "audio"}]}]),
}


@pytest.mark.parametrize("case", sorted(MESSAGES))
def test_messages_equal_jax(fleet, case):
    got = fleet.run(fleet.both("/v1/messages", MESSAGES[case]))
    assert got[0] == got[1], case


def test_messages_stop_sequence_and_chat_ids(fleet):
    """A stop sequence taken from the greedy text ends the stream with
    stop_reason stop_sequence alike; the message's text is the chat
    completion's content for the same prompt."""

    async def run():
        url = fleet.fe.urls[1]
        await fleet.worker.engine.clear_kv_blocks()
        _, msg = await fleet.fe.post(url, "/v1/messages", MSG)
        await fleet.worker.engine.clear_kv_blocks()
        _, chat = await fleet.fe.post(url, "/v1/chat/completions", MSG)
        text = msg["content"][0]["text"]
        stop = text[2:4]
        out = []
        for stream in (False, True):
            out.append(await fleet.both("/v1/messages", dict(
                MSG, stop_sequences=[stop], stream=stream)))
        return msg, chat, stop, out

    msg, chat, stop, out = fleet.run(run())
    assert msg["content"][0]["text"] == \
        chat["choices"][0]["message"]["content"]
    assert msg["stop_reason"] == "max_tokens"
    for got in out:
        assert got[0] == got[1]
    assert out[0][1][1]["stop_reason"] == "stop_sequence"
    assert out[0][1][1]["stop_sequence"] == stop
    names = [n for n, _ in out[1][1][1]]
    assert names[0] == "message_start" and names[-1] == "message_stop"


@pytest.mark.parametrize("body", [
    MSG, dict(MSG, system="be brief", tools=TOOLS), dict(MSG, model="nope"),
    {"model": "m", "messages": "bad"}])
def test_count_tokens_equal_jax(fleet, body):
    got = fleet.run(fleet.both("/v1/messages/count_tokens", body))
    assert got[0] == got[1]


def test_responses_chain_get_and_delete_equal_jax(fleet):
    async def run():
        out, rids = [], []
        for url in fleet.fe.urls:
            await fleet.worker.engine.clear_kv_blocks()
            seq = []
            st, first = await _raw_post(fleet, url, "/v1/responses", {
                "model": "m", "input": "hello there",
                "instructions": "be brief", "max_output_tokens": 5,
                "temperature": 0.0})
            seq.append((st, first))
            rid = first["id"]
            rids.append(rid)
            await fleet.worker.engine.clear_kv_blocks()
            seq.append(await fleet.fe.post(url, "/v1/responses", {
                "model": "m", "input": [{"type": "message", "role": "user",
                                         "content": [{"type": "input_text",
                                                      "text": "and then?"}]}],
                "previous_response_id": rid, "max_output_tokens": 5,
                "temperature": 0.0}))
            seq.append(await fleet.fe.get(url, f"/v1/responses/{rid}"))
            seq.append(await fleet.fe.get(url, f"/v1/responses/{rid}",
                                          "DELETE"))
            seq.append(await fleet.fe.get(url, f"/v1/responses/{rid}"))
            seq.append(await fleet.fe.post(url, "/v1/responses", {
                "model": "m", "input": "x", "previous_response_id": rid}))
            seq.append(await fleet.fe.post(url, "/v1/responses", {
                "model": "m"}))
            # the 404 names the (per-frontend) response id
            out.append(json.loads(json.dumps(seq).replace(rid, "<rid>")))
        return out, rids

    (jax_seq, port_seq), rids = fleet.run(run())
    from torch_fleet import scrub

    assert scrub(jax_seq) == scrub(port_seq)
    assert port_seq[0][0] == port_seq[1][0] == 200
    assert port_seq[1][1]["usage"]["input_tokens"] > \
        port_seq[0][1]["usage"]["input_tokens"]
    assert [s for s, _ in port_seq[2:]] == [200, 200, 404, 404, 400]
    assert "<rid>" in port_seq[5][1]["error"]["message"]
    assert all(r.startswith("resp_") for r in rids)


async def _raw_post(fleet, url, path, body):
    async with fleet.fe.session.post(url + path, json=body) as r:
        return r.status, await r.json()


def test_responses_stream_events_equal_jax(fleet):
    body = {"model": "m", "input": PROMPT, "max_output_tokens": 5,
            "temperature": 0.0, "stream": True}
    got = fleet.run(fleet.both("/v1/responses", body))
    assert got[0] == got[1]
    names = [n for n, _ in got[1][1]]
    assert names[0] == "response.created"
    assert names[-2:] == ["response.output_text.done", "response.completed"]


def _form(parts):
    form = aiohttp.FormData()
    for name, value, filename in parts:
        if filename is None:
            form.add_field(name, value)
        else:
            form.add_field(name, value, filename=filename)
    return form


def test_files_multipart_and_json_round_trip_equal_jax(fleet):
    async def run():
        out = []
        for url in fleet.fe.urls:
            seq = []
            st, meta = await _raw_form(fleet, url, [
                ("purpose", "batch", None),
                ("file", b"line1\nline2\n", "data.jsonl")])
            seq.append((st, meta))
            fid = meta["id"]
            st, meta2 = await _raw_post(fleet, url, "/v1/files", {
                "purpose": "batch", "filename": "j.jsonl",
                "content": "a\n"})
            seq.append((st, meta2))
            async with fleet.fe.session.get(url + "/v1/files") as r:
                seq.append(sorted((f["filename"], f["bytes"])
                                  for f in (await r.json())["data"]))
            seq.append(await fleet.fe.get(url, f"/v1/files/{fid}"))
            async with fleet.fe.session.get(
                    url + f"/v1/files/{fid}/content") as r:
                seq.append((r.status, await r.read()))
            seq.append(await fleet.fe.get(url, f"/v1/files/{fid}", "DELETE"))
            seq.append(await fleet.fe.get(url, f"/v1/files/{fid}"))
            seq.append(await fleet.fe.get(url, f"/v1/files/{fid}", "DELETE"))
            seq.append(await fleet.fe.get(url, "/v1/files/..%2F..%2Fetc"))
            seq.append(await fleet.fe.get(url, f"/v1/files/{meta2['id']}",
                                          "DELETE"))
            seq.append(await _raw_form_scrubbed(fleet, url, [
                ("file", b"x", "f.bin")]))
            seq.append(await fleet.fe.post(url, "/v1/files", {
                "purpose": "batch"}))
            out.append(seq)
        return out

    jax_seq, port_seq = fleet.run(run())
    from torch_fleet import scrub

    assert scrub(jax_seq) == scrub(port_seq)
    assert port_seq[0][1]["bytes"] == 12
    assert port_seq[0][1]["filename"] == "data.jsonl"
    assert port_seq[4] == (200, b"line1\nline2\n")
    assert [s[0] for s in port_seq[5:]] == [200, 404, 404, 404, 200, 400,
                                            400]


async def _raw_form(fleet, url, parts):
    async with fleet.fe.session.post(url + "/v1/files",
                                     data=_form(parts)) as r:
        return r.status, await r.json()


async def _raw_form_scrubbed(fleet, url, parts):
    async with fleet.fe.session.post(url + "/v1/files",
                                     data=_form(parts)) as r:
        return await read(r)


@pytest.mark.parametrize("shape", ["multipart", "json"])
def test_upload_past_the_cap_is_413_and_leaves_nothing(fleet, shape):
    async def run():
        got = []
        for url, store in zip(fleet.fe.urls, fleet.stores):
            cap, store.max_upload_bytes = store.max_upload_bytes, 1024
            try:
                if shape == "multipart":
                    async with fleet.fe.session.post(
                            url + "/v1/files", data=_form([
                                ("purpose", "batch", None),
                                ("file", b"x" * 4096, "big.bin")])) as r:
                        got.append(await read(r))
                else:
                    got.append(await fleet.fe.post(url, "/v1/files", {
                        "purpose": "batch", "content": "y" * 4096}))
                # under the cap, the same store takes it
                async with fleet.fe.session.post(url + "/v1/files", data=_form(
                        [("purpose", "batch", None),
                         ("file", b"z" * 600, "ok.bin")])) as r:
                    meta = await r.json()
                async with fleet.fe.session.get(
                        url + f"/v1/files/{meta['id']}/content") as r:
                    ok = await r.read() == b"z" * 600
                await fleet.fe.get(url, f"/v1/files/{meta['id']}", "DELETE")
                got.append(ok)
            finally:
                store.max_upload_bytes = cap
        return got

    got = fleet.run(run())
    assert got[0] == got[2] and got[0][0] == 413
    assert got[1] is True and got[3] is True
    assert got[2][1]["error"]["type"] == "request_too_large"
    for store in fleet.stores:
        assert not [n for n in os.listdir(store.root) if n.endswith(".tmp")]
        assert not [f for f in store.list()
                    if f["filename"] in ("big.bin", "ok.bin")]


def _batch_lines():
    lines = [json.dumps({
        "custom_id": f"req-{i}", "method": "POST",
        "url": "/v1/chat/completions",
        "body": {"model": "m", "max_tokens": 4, "temperature": 0.0,
                 "ignore_eos": True, "messages": [
                     {"role": "user", "content": f"item {i} {PROMPT}"}]}})
        for i in range(2)]
    lines.append(json.dumps({
        "custom_id": "req-bad", "method": "POST",
        "url": "/v1/chat/completions",
        "body": {"model": "nope", "messages": [
            {"role": "user", "content": "x"}]}}))
    return lines


async def _poll_batch(fleet, url, bid, until=("completed",)):
    for _ in range(int(WAIT_S / 0.05)):
        async with fleet.fe.session.get(url + f"/v1/batches/{bid}") as r:
            batch = await r.json()
        if batch["status"] in until:
            return batch
        await asyncio.sleep(0.05)
    raise AssertionError(f"batch {bid} stayed {batch['status']}")


def test_batches_run_to_completed_equal_direct_and_jax(fleet):
    lines = _batch_lines()

    async def run():
        out = []
        for url in fleet.fe.urls:
            await fleet.worker.engine.clear_kv_blocks()
            st, meta = await _raw_form(fleet, url, [
                ("purpose", "batch", None),
                ("file", ("\n".join(lines) + "\n").encode(), "in.jsonl")])
            assert st == 200
            st, batch = await _raw_post(fleet, url, "/v1/batches", {
                "input_file_id": meta["id"],
                "endpoint": "/v1/chat/completions",
                "completion_window": "24h"})
            assert st == 200 and batch["status"] in ("validating",
                                                     "in_progress")
            done = await _poll_batch(fleet, url, batch["id"])
            async with fleet.fe.session.get(
                    url + f"/v1/files/{done['output_file_id']}/content") as r:
                results = [json.loads(x) for x in
                           (await r.read()).decode().splitlines()]
            async with fleet.fe.session.get(url + "/v1/batches") as r:
                listed = [b["id"] for b in (await r.json())["data"]]
            direct = []
            for ln in lines:
                await fleet.worker.engine.clear_kv_blocks()
                direct.append(await fleet.fe.post(
                    url, "/v1/chat/completions", json.loads(ln)["body"]))
            out.append((done, results, batch["id"] in listed, direct))
        return out

    from torch_fleet import scrub

    (jdone, jres, jlisted, jdirect), (done, res, listed, direct) = \
        fleet.run(run())
    assert listed and jlisted
    assert scrub(done) == scrub(jdone)
    assert done["status"] == "completed"
    assert done["request_counts"] == {"total": 3, "completed": 2,
                                      "failed": 1}
    by_cid = {r["custom_id"]: r for r in res}
    jby_cid = {r["custom_id"]: r for r in jres}
    assert scrub(by_cid) == scrub(jby_cid)
    for ln, (status, body) in zip(lines, direct):
        r = by_cid[json.loads(ln)["custom_id"]]["response"]
        assert (r["status_code"], scrub(r["body"])) == (status, body)
    assert direct == jdirect


def test_batch_cancel_and_validation_equal_jax(fleet):
    many = "\n".join(json.dumps({
        "custom_id": f"c{i}", "url": "/v1/chat/completions",
        "body": {"model": "m", "max_tokens": 64, "ignore_eos": True,
                 "messages": [{"role": "user", "content": "x"}]}})
        for i in range(30))

    async def run():
        out = []
        for url in fleet.fe.urls:
            seq = [await fleet.fe.post(url, "/v1/batches", {
                "input_file_id": "file-x", "endpoint": "/v1/nope"}),
                await fleet.fe.post(url, "/v1/batches", {
                    "input_file_id": "file-missing",
                    "endpoint": "/v1/chat/completions"}),
                await fleet.fe.get(url, "/v1/batches/batch_none"),
                await fleet.fe.post(url, "/v1/batches/batch_none/cancel")]
            _, meta = await _raw_post(fleet, url, "/v1/files", {
                "purpose": "batch", "filename": "big.jsonl",
                "content": many})
            _, batch = await _raw_post(fleet, url, "/v1/batches", {
                "input_file_id": meta["id"],
                "endpoint": "/v1/chat/completions"})
            st, cancelled = await _raw_post(
                fleet, url, f"/v1/batches/{batch['id']}/cancel", {})
            seq.append((st, cancelled["status"]))
            done = await _poll_batch(fleet, url, batch["id"],
                                     ("cancelled", "completed"))
            seq.append(done["status"])
            out.append(seq)
        return out

    jax_seq, port_seq = fleet.run(run())
    assert jax_seq == port_seq
    assert [s for s, _ in port_seq[:4]] == [400, 404, 404, 404]
    assert port_seq[4] == (200, "cancelling") and port_seq[5] == "cancelled"


# ---------------------------------------------------------------------------
# the port's server under uploads, and close()
# ---------------------------------------------------------------------------

BOUNDARY = b"smokeboundary"


def _multipart_head(total: int) -> bytes:
    return (b"POST /v1/files HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: multipart/form-data; boundary=" + BOUNDARY
            + b"\r\nContent-Length: %d\r\n\r\n" % total)


def _multipart_parts(payload: bytes, filename: bytes) -> tuple:
    head = (b"--" + BOUNDARY + b"\r\nContent-Disposition: form-data; "
            b"name=\"purpose\"\r\n\r\nbatch\r\n--" + BOUNDARY
            + b"\r\nContent-Disposition: form-data; name=\"file\"; "
            b"filename=\"" + filename + b"\"\r\n\r\n")
    tail = b"\r\n--" + BOUNDARY + b"--\r\n"
    return head, payload, tail


def test_slow_upload_leaves_other_connections_served(fleet):
    async def run():
        url = fleet.fe.urls[1]
        port = int(url.rsplit(":", 1)[1])
        head, payload, tail = _multipart_parts(b"q" * 200_000,
                                             b"slow.jsonl")
        total = len(head) + len(payload) + len(tail)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(_multipart_head(total) + head + payload[:1000])
        await writer.drain()
        # the part streams to disk as it arrives
        await wait_for(lambda: any(n.endswith(".tmp") for n in os.listdir(
            fleet.stores[1].root)), "the upload's staged file")
        # the upload stalls mid-part: other connections are served
        loop = asyncio.get_running_loop()
        t = loop.time()
        async with fleet.fe.session.get(url + "/v1/models") as r:
            models = await r.json()
        served_s = loop.time() - t
        staged = [n for n in os.listdir(fleet.stores[1].root)
                  if n.endswith(".tmp")]
        writer.write(payload[1000:] + tail)
        await writer.drain()
        raw = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), WAIT_S)
        n = int(next(ln.split(b":")[1] for ln in raw.split(b"\r\n")
                     if ln.lower().startswith(b"content-length")))
        meta = json.loads(await reader.readexactly(n))
        writer.close()
        await fleet.fe.get(url, f"/v1/files/{meta['id']}", "DELETE")
        return models, served_s, staged, raw, meta

    models, served_s, staged, raw, meta = fleet.run(run())
    assert [m["id"] for m in models["data"]] == ["m"]
    assert served_s < 5.0
    assert len(staged) == 1
    assert raw.startswith(b"HTTP/1.1 200")
    assert meta["bytes"] == 200_000 and meta["filename"] == "slow.jsonl"


def test_dropped_upload_leaves_no_staged_file_alike(fleet):
    async def run():
        left = []
        for url, store in zip(fleet.fe.urls, fleet.stores):
            port = int(url.rsplit(":", 1)[1])
            head, payload, tail = _multipart_parts(b"d" * 100_000,
                                                 b"dropped.jsonl")
            total = len(head) + len(payload) + len(tail)
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(_multipart_head(total) + head + payload[:50_000])
            await writer.drain()
            await wait_for(lambda: any(n.endswith(".tmp")
                                       for n in os.listdir(store.root)),
                           "the upload's staged file")
            writer.transport.abort()
            await wait_for(lambda: not any(n.endswith(".tmp")
                                           for n in os.listdir(store.root)),
                           "the staged file removed")
            left.append([f for f in store.list()
                         if f["filename"] == "dropped.jsonl"])
        return left

    assert fleet.run(run()) == [[], []]


def test_service_close_ends_a_running_batch(fleet):
    from dynamo_tpu_torch.frontend.service import HttpService

    many = "\n".join(json.dumps({
        "custom_id": f"c{i}", "url": "/v1/completions",
        "body": {"model": "m", "max_tokens": 200, "ignore_eos": True,
                 "prompt": "x"}}) for i in range(20))

    async def run():
        svc = await HttpService(fleet.fe.prt, fleet.fe.pmanager,
                                host="127.0.0.1", port=0).start()
        svc.extra.files = fleet.stores[1]
        url = f"http://127.0.0.1:{svc.bound_port}"
        _, meta = await _raw_post(fleet, url, "/v1/files", {
            "purpose": "batch", "filename": "long.jsonl", "content": many})
        _, batch = await _raw_post(fleet, url, "/v1/batches", {
            "input_file_id": meta["id"], "endpoint": "/v1/completions"})
        b = svc.extra.batches[batch["id"]]
        await wait_for(lambda: b.status == "in_progress", "the batch running")
        await svc.close()
        fleet.stores[1].delete(meta["id"])
        await wait_for(lambda: fleet.worker.engine.num_active_seqs == 0,
                       "the batch's requests ended at the worker")
        return b.task.done(), b.status

    assert fleet.run(run()) == (True, "cancelled")
