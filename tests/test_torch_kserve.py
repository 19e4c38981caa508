"""The port's KServe v2 gRPC service against the JAX package's (CPU).

One fleet for the module (tests/torch_fleet.py): a lockstep tiny fp32
TorchEngineWorker behind both frontends in kv mode, a KServe service on
each frontend's ModelManager (with its HTTP service's resolver, as the
CLIs wire them), and one gRPC channel to each.  Every case sends the same
request to both services from a cleared prefix cache and compares what
comes back:

* ModelInfer's response and ModelStreamInfer's response sequence (texts,
  finish reasons, ids) on greedy prompts, and the stream's joined deltas
  equal to the unary text;
* `raw_input_contents` framing (a length-prefixed element, a short
  buffer, bytes_contents first);
* the request `_build_request` makes from the parameters;
* NOT_FOUND and INVALID_ARGUMENT (codes and details) and the stream's
  per-request error messages;
* liveness, readiness and metadata;
* a client's cancel of ModelStreamInfer: the worker's stream stops
  early under both services alike.

The CLI serving KServe on a free `--grpc-port` is in
tests/test_torch_frontend.py.
"""

import asyncio

import grpc
import grpc.aio
import pytest
import torch

from dynamo_tpu.frontend.kserve import KserveGrpcService as JaxKserve
from dynamo_tpu_torch.engine import EngineConfig, TorchEngineWorker
from dynamo_tpu_torch.frontend import kserve_pb2 as pb
from dynamo_tpu_torch.frontend.kserve import SERVICE, KserveGrpcService
from dynamo_tpu_torch.models.llama import LlamaConfig
from torch_fleet import WAIT_S, Frontends, LoopThread, wait_for

SHAPES = dict(name="tiny32", vocab_size=256, d_model=64, n_layers=2,
              n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128)
LOCKSTEP = dict(block_size=4, num_blocks=128, max_blocks_per_seq=64,
                max_num_seqs=4, prefill_buckets=(8, 16, 32, 64, 128),
                seed=7, overlap_scheduling=False, decode_fused_steps=1)
TOK = {"type": "mock", "vocab_size": SHAPES["vocab_size"]}
MODEL = "m"
# a cancelled stream's max_tokens: far more than a cancel lets through
CANCEL_MAX_TOKENS = 400


def _ser(m):
    return m.SerializeToString()


class _Fleet:
    async def start(self, root):
        self.fe = await Frontends().start(root / "cluster")
        self.worker = await TorchEngineWorker(
            self.fe.prt, EngineConfig(model_config=LlamaConfig(
                dtype=torch.float32, **SHAPES), model_name=MODEL,
                **LOCKSTEP),
            tokenizer_cfg=TOK, device="cpu").start()
        self.streams = {}
        gen = self.worker.engine.generate

        async def spied(request, *a, **kw):
            ids = self.streams.setdefault(request.request_id, [])
            async for out in gen(request, *a, **kw):
                ids.extend(out.token_ids)
                yield out

        self.worker.engine.generate = spied
        jsvc, psvc = self.fe.services
        self.services = [
            await JaxKserve(self.fe.jrt, self.fe.jmanager, host="127.0.0.1",
                            port=0,
                            resolver=jsvc._resolve_pipeline).start(),
            await KserveGrpcService(self.fe.prt, self.fe.pmanager,
                                    host="127.0.0.1", port=0,
                                    resolver=psvc._resolve_pipeline).start()]
        self.channels = [grpc.aio.insecure_channel(f"127.0.0.1:{s.bound_port}")
                         for s in self.services]
        await self.fe.wait_model(MODEL)
        return self

    def rpc(self, ch, name: str, resp_cls, stream: bool = False):
        make = ch.stream_stream if stream else ch.unary_unary
        return make(f"/{SERVICE}/{name}", request_serializer=_ser,
                    response_deserializer=resp_cls.FromString)

    async def both(self, call):
        """call(channel) on the JAX service's channel, then the port's,
        each from a cleared prefix cache."""
        got = []
        for ch in self.channels:
            await self.worker.engine.clear_kv_blocks()
            got.append(await call(ch))
        return got

    async def close(self):
        for ch in self.channels:
            await ch.close()
        for s in self.services:
            await s.close()
        await self.fe.close()
        await self.worker.close()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    loop = LoopThread()
    f = loop.run(_Fleet().start(tmp_path_factory.mktemp("kserve")))
    f.run = loop.run
    try:
        yield f
    finally:
        try:
            loop.run(f.close())
        finally:
            loop.close()
            torch.set_num_threads(n)


def infer_request(prompt: str, rid: str = "req-1", max_tokens: int = 6,
                  model: str = MODEL, **params) -> "pb.ModelInferRequest":
    req = pb.ModelInferRequest(model_name=model, id=rid)
    t = req.inputs.add()
    t.name, t.datatype = "text_input", "BYTES"
    t.shape.append(1)
    t.contents.bytes_contents.append(prompt.encode())
    set_params(req, max_tokens=max_tokens, ignore_eos=True, **params)
    return req


def set_params(req, **params) -> None:
    """Each parameter in the oneof member its Python type picks."""
    for k, v in params.items():
        if isinstance(v, bool):
            req.parameters[k].bool_param = v
        elif isinstance(v, int):
            req.parameters[k].int64_param = v
        elif isinstance(v, float):
            req.parameters[k].double_param = v
        else:
            req.parameters[k].string_param = v


def raw_request(raw: list, bytes_contents=None, rid: str = "raw",
                names=("text_input",)) -> "pb.ModelInferRequest":
    req = pb.ModelInferRequest(model_name=MODEL, id=rid)
    for name in names:
        t = req.inputs.add()
        t.name, t.datatype = name, "BYTES"
        t.shape.append(1)
        if bytes_contents is not None and name == "text_input":
            t.contents.bytes_contents.append(bytes_contents)
    req.raw_input_contents.extend(raw)
    req.parameters["max_tokens"].int64_param = 4
    req.parameters["ignore_eos"].bool_param = True
    return req


def _framed(text: str) -> bytes:
    data = text.encode()
    return len(data).to_bytes(4, "little") + data


def _stream_view(responses) -> list:
    """A ModelStreamInfer answer as comparable tuples: each response's
    error, model, id, text and parameters."""
    out = []
    for r in responses:
        ir = r.infer_response
        out.append((r.error_message, ir.model_name, ir.id,
                    [o.contents.bytes_contents[0].decode()
                     for o in ir.outputs],
                    sorted((k, str(v)) for k, v in ir.parameters.items())))
    return out


async def _stream(fleet, ch, requests) -> list:
    call = fleet.rpc(ch, "ModelStreamInfer", pb.ModelStreamInferResponse,
                     stream=True)()
    for req in requests:
        await call.write(req)
    await call.done_writing()
    return [r async for r in call]


async def _unary(fleet, ch, name, req, resp_cls):
    """(response or None, status code name, details)."""
    try:
        resp = await fleet.rpc(ch, name, resp_cls)(req)
        return resp, "OK", ""
    except grpc.aio.AioRpcError as e:
        return None, e.code().name, e.details()


PROMPTS = {
    "short": ("hi", 6),
    "sentence": ("the quick brown fox jumps over the lazy dog", 8),
    "long": ("tell me a story about " * 6, 12),
    "one_token": ("x", 1),
}


@pytest.mark.parametrize("case", sorted(PROMPTS))
def test_infer_and_stream_equal_jax(fleet, case):
    prompt, n = PROMPTS[case]
    req = infer_request(prompt, rid=f"k-{case}", max_tokens=n)

    async def unary(ch):
        return await fleet.rpc(ch, "ModelInfer", pb.ModelInferResponse)(req)

    async def stream(ch):
        return await _stream(fleet, ch, [req])

    unaries = fleet.run(fleet.both(unary))
    streams = fleet.run(fleet.both(stream))
    assert unaries[0] == unaries[1], case
    assert _stream_view(streams[0]) == _stream_view(streams[1]), case
    resp = unaries[1]
    text = resp.outputs[0].contents.bytes_contents[0].decode()
    assert resp.model_name == MODEL and resp.id == f"k-{case}"
    assert resp.parameters["finish_reason"].string_param == "length"
    assert resp.parameters["triton_final_response"].bool_param
    view = _stream_view(streams[1])
    assert "".join(t for _, _, _, ts, _ in view for t in ts) == text
    finals = [r for r in streams[1]
              if r.infer_response.parameters["triton_final_response"]
              .bool_param]
    assert finals == [streams[1][-1]]
    assert finals[0].infer_response.parameters["finish_reason"] \
        .string_param == "length"
    # the worker served the request four times (two services, two RPCs)
    assert len(fleet.streams[f"k-{case}"]) == 4 * n


def test_stream_of_several_requests_equal_jax(fleet):
    """Three requests on one bidirectional stream (one unknown model
    among them) answer in order, alike."""
    reqs = [infer_request("first", rid="s-1", max_tokens=3),
            infer_request("second", rid="s-2", model="nope"),
            infer_request("third one", rid="s-3", max_tokens=4)]
    got = fleet.run(fleet.both(lambda ch: _stream(fleet, ch, reqs)))
    assert _stream_view(got[0]) == _stream_view(got[1])
    errs = [r.error_message for r in got[1] if r.error_message]
    assert errs == ["model 'nope' not found"]
    assert [r.infer_response.id for r in got[1]
            if not r.error_message][0] == "s-1"


RAW = {
    "framed": lambda: raw_request([_framed("raw framed prompt")]),
    "framed_with_tail": lambda: raw_request(
        [_framed("abc") + b"ignored tail"]),
    "bytes_contents_first": lambda: raw_request(
        [_framed("raw loses")], bytes_contents=b"contents win"),
    "short_buffer": lambda: raw_request([b"\x01\x00"]),
    "no_raw": lambda: raw_request([]),
    "second_input": lambda: raw_request(
        [_framed("for the other"), _framed("for text_input")],
        names=("other", "text_input")),
    "index_past_raw": lambda: raw_request(
        [_framed("only one")], names=("other", "text_input")),
    "bad_utf8": lambda: raw_request([b"\x02\x00\x00\x00\xff\xfe"]),
}


@pytest.mark.parametrize("case", sorted(RAW))
def test_raw_input_framing_equal_jax(fleet, case):
    req = RAW[case]()

    async def call(ch):
        resp, code, details = await _unary(fleet, ch, "ModelInfer", req,
                                           pb.ModelInferResponse)
        return resp, code, details

    got = fleet.run(fleet.both(call))
    assert got[0] == got[1], case
    want_ok = case in ("framed", "framed_with_tail", "bytes_contents_first",
                       "second_input")
    assert (got[1][1] == "OK") == want_ok, got[1]


PARAMS = {
    "defaults": dict(),
    "temperature": dict(temperature=0.7),
    "ignore_eos_false": dict(ignore_eos=False),
    "max_tokens_double": dict(max_tokens=5.0),
    "max_tokens_string": dict(max_tokens="7"),
    "no_id": dict(rid=""),
    "extra_param": dict(top_p=0.5, stream=True),
}


@pytest.mark.parametrize("case", sorted(PARAMS))
def test_build_request_equal_jax(fleet, case):
    """The PreprocessedRequest each service builds from the same gRPC
    request (the request id aside where none is given: each preprocessor
    draws its own)."""
    kw = dict(PARAMS[case])
    rid = kw.pop("rid", "b-1")
    req = infer_request("build me a request", rid=rid)
    set_params(req, **kw)
    if case == "defaults":
        del req.parameters["max_tokens"]
        del req.parameters["ignore_eos"]

    async def build():
        out = []
        for svc in fleet.services:
            _, r = svc._build_request(req)
            d = r.to_dict()
            if not rid:
                d.pop("request_id")
            out.append(d)
        return out

    jax_req, port_req = fleet.run(build())
    assert jax_req == port_req, case


ERRORS = {
    "infer_unknown_model": ("ModelInfer",
                            lambda: infer_request("x", model="nope")),
    "infer_missing_tensor": ("ModelInfer",
                             lambda: raw_request([], names=("other",))),
    "infer_bad_max_tokens": ("ModelInfer",
                             lambda: infer_request("x", max_tokens="many")),
    "infer_bad_temperature": ("ModelInfer",
                              lambda: infer_request("x", temperature="hot")),
    "metadata_unknown_model": (
        "ModelMetadata", lambda: pb.ModelMetadataRequest(name="nope")),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_equal_jax(fleet, case):
    name, make = ERRORS[case]
    req = make()
    resp_cls = (pb.ModelInferResponse if name == "ModelInfer"
                else pb.ModelMetadataResponse)

    async def call(ch):
        return await _unary(fleet, ch, name, req, resp_cls)

    got = fleet.run(fleet.both(call))
    assert got[0] == got[1], case
    assert got[1][1] == ("NOT_FOUND" if "unknown" in case
                         else "INVALID_ARGUMENT"), got[1]


STATUS = {
    "live": ("ServerLive", pb.ServerLiveRequest(), pb.ServerLiveResponse),
    "ready": ("ServerReady", pb.ServerReadyRequest(),
              pb.ServerReadyResponse),
    "model_ready": ("ModelReady", pb.ModelReadyRequest(name=MODEL),
                    pb.ModelReadyResponse),
    "model_not_ready": ("ModelReady", pb.ModelReadyRequest(name="nope"),
                        pb.ModelReadyResponse),
    "metadata": ("ModelMetadata", pb.ModelMetadataRequest(name=MODEL),
                 pb.ModelMetadataResponse),
}


@pytest.mark.parametrize("case", sorted(STATUS))
def test_status_and_metadata_equal_jax(fleet, case):
    name, req, resp_cls = STATUS[case]

    async def call(ch):
        return await _unary(fleet, ch, name, req, resp_cls)

    got = fleet.run(fleet.both(call))
    assert got[0] == got[1], case
    resp = got[1][0]
    if case == "metadata":
        assert resp.platform == "dynamo_tpu" and list(resp.versions) == ["1"]
        assert [(t.name, t.datatype) for t in resp.inputs] == [
            ("text_input", "BYTES")]
    elif case == "model_not_ready":
        assert not resp.ready
    else:
        assert resp.ListFields()[0][1] is True


def test_stream_cancel_stops_the_request_alike(fleet):
    """A client that cancels ModelStreamInfer after its first response:
    under either service the worker's stream for that request stops well
    short of max_tokens and the engine frees the slot (the handler's
    token is only detached, but cancelling the RPC closes the pipeline's
    generator, and the request plane cancels the worker's stream)."""

    async def cancel(ch):
        rid = f"cancel-{id(ch)}"
        call = fleet.rpc(ch, "ModelStreamInfer", pb.ModelStreamInferResponse,
                         stream=True)()
        await call.write(infer_request("cancel me", rid=rid,
                                       max_tokens=CANCEL_MAX_TOKENS))
        first = await asyncio.wait_for(call.read(), WAIT_S)
        assert not first.error_message, first.error_message
        call.cancel()
        eng = fleet.worker.engine
        await wait_for(lambda: eng.num_active_seqs == 0,
                       "the cancelled request's slot freed")
        return len(fleet.streams[rid])

    emitted = fleet.run(fleet.both(cancel))
    assert all(0 < n < CANCEL_MAX_TOKENS for n in emitted), emitted


def test_grpc_loads_only_with_the_kserve_module():
    """Importing the port's frontend (its CLI included), planner,
    profiler and fleet observer loads no grpc: only frontend/kserve.py,
    which the CLI imports when `--grpc-port` is set, does."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "for m in ('dynamo_tpu_torch', 'dynamo_tpu_torch.frontend.__main__',"
        " 'dynamo_tpu_torch.frontend.service', 'dynamo_tpu_torch.planner',"
        " 'dynamo_tpu_torch.planner.__main__', 'dynamo_tpu_torch.profiler',"
        " 'dynamo_tpu_torch.obs.fleet'):\n"
        "    __import__(m)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'grpc']\n"
        "import dynamo_tpu_torch.frontend.kserve\n"
        "assert 'grpc' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
