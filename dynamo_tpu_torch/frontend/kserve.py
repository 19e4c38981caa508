"""KServe v2 gRPC inference service over the model pipelines.

A copy of dynamo_tpu/frontend/kserve.py on the port's ModelManager: the
Open Inference Protocol in front of the same pipelines the OpenAI
routes serve, so Triton-ecosystem clients (and the KServe data plane)
call the port without the OpenAI HTTP shapes.  `text_input` BYTES
tensor in, `text_output` BYTES tensor out, sampling knobs in request
parameters, ModelStreamInfer for token streaming.

Handlers are registered with grpc's generic-handler API against the
protoc-generated message classes (kserve_pb2.py, a byte-identical copy
of the JAX package's: both register `kserve.proto` in protobuf's default
pool, so an edited copy would collide with it in a process that imports
both).  `python -m dynamo_tpu_torch.frontend --grpc-port N` is the only
importer; nothing else of the package loads grpc.

A client that cancels ModelStreamInfer (or ModelInfer) detaches the
request's child token, as JAX's does, without killing it: the pipeline's
generator is closed with the RPC, and the worker's stream ends when the
request plane sees its consumer go.
"""

from __future__ import annotations

import logging
from typing import Optional

import grpc
import grpc.aio

from . import kserve_pb2 as pb

logger = logging.getLogger(__name__)

SERVICE = "inference.GRPCInferenceService"
# ModelMetadata's platform is part of the wire contract clients match
# on: the JAX service's value, kept
PLATFORM = "dynamo_tpu"


def _param(req, name: str, default=None):
    if name not in req.parameters:  # map .get/[] would auto-insert
        return default
    p = req.parameters[name]
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else default


def _text_input(req: "pb.ModelInferRequest") -> Optional[str]:
    for i, t in enumerate(req.inputs):
        if t.name == "text_input":
            if t.contents.bytes_contents:
                return t.contents.bytes_contents[0].decode()
            if len(req.raw_input_contents) > i:
                raw = req.raw_input_contents[i]
                # raw tensor framing: 4-byte LE length prefix per element
                if len(raw) >= 4:
                    n = int.from_bytes(raw[:4], "little")
                    return raw[4:4 + n].decode()
    return None


def _text_response(model: str, rid: str, text: str,
                   finish: Optional[str] = None) -> "pb.ModelInferResponse":
    out = pb.ModelInferResponse(model_name=model, id=rid)
    t = out.outputs.add()
    t.name = "text_output"
    t.datatype = "BYTES"
    t.shape.append(1)
    t.contents.bytes_contents.append(text.encode())
    if finish:
        out.parameters["triton_final_response"].bool_param = True
        out.parameters["finish_reason"].string_param = finish
    return out


class KserveGrpcService:
    """GRPCInferenceService bridging to ModelManager pipelines."""

    def __init__(self, runtime, manager, host: str = "0.0.0.0",
                 port: int = 8787, resolver=None):
        self.runtime = runtime
        self.manager = manager
        self.host = host
        self.port = port
        # resolver(model) -> (pipeline, lora_name): the HTTP service's
        # LoRA-adapter-aware resolution when given
        self.resolver = resolver or (
            lambda model: (manager.get(model), None))
        self.bound_port: Optional[int] = None
        self._server: Optional[grpc.aio.Server] = None

    # -- RPC implementations ---------------------------------------------
    async def ServerLive(self, request, context):
        return pb.ServerLiveResponse(live=True)

    async def ServerReady(self, request, context):
        return pb.ServerReadyResponse(ready=bool(self.manager.models))

    async def ModelReady(self, request, context):
        return pb.ModelReadyResponse(
            ready=self.resolver(request.name)[0] is not None)

    async def ModelMetadata(self, request, context):
        p, _ = self.resolver(request.name)
        if p is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"model {request.name!r} not found")
        resp = pb.ModelMetadataResponse(name=request.name, platform=PLATFORM)
        resp.versions.append("1")
        i = resp.inputs.add()
        i.name, i.datatype = "text_input", "BYTES"
        i.shape.append(1)
        o = resp.outputs.add()
        o.name, o.datatype = "text_output", "BYTES"
        o.shape.append(1)
        return resp

    def _build_request(self, request):
        """(pipeline, req); raises ValueError for caller errors (missing
        tensor, bad params, over-length prompt), so both RPC shapes can
        map them to per-request errors instead of stream teardown."""
        pipeline, lora_name = self.resolver(request.model_name)
        if pipeline is None:
            return None, None
        prompt = _text_input(request)
        if prompt is None:
            raise ValueError("missing text_input BYTES tensor")
        body = {
            "model": request.model_name,
            "prompt": prompt,
            "max_tokens": int(_param(request, "max_tokens", 16)),
            "temperature": float(_param(request, "temperature", 0.0)),
        }
        if _param(request, "ignore_eos"):
            body["ignore_eos"] = True
        req = pipeline.preprocessor.preprocess_completion(body)
        if lora_name is not None:
            req.lora_name = lora_name
        if request.id:
            req.request_id = request.id
        return pipeline, req

    async def ModelInfer(self, request, context):
        try:
            pipeline, req = self._build_request(request)
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        if pipeline is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"model {request.model_name!r} not found")
        token = self.runtime.root_token.child()
        parts, finish = [], None
        try:
            async for d in pipeline.generate_deltas(req, token=token):
                parts.append(d.text)
                if d.finish_reason:
                    finish = d.finish_reason
        except Exception as e:
            logger.exception("kserve infer failed")
            await context.abort(grpc.StatusCode.INTERNAL, str(e))
        finally:
            token.detach()
        return _text_response(request.model_name, request.id,
                              "".join(parts), finish or "stop")

    async def ModelStreamInfer(self, request_iterator, context):
        """Bidirectional stream: each incoming request yields a stream of
        delta responses, the last marked triton_final_response."""
        async for request in request_iterator:
            try:
                pipeline, req = self._build_request(request)
            except (ValueError, TypeError, UnicodeDecodeError) as e:
                yield pb.ModelStreamInferResponse(error_message=str(e))
                continue
            if pipeline is None:
                yield pb.ModelStreamInferResponse(
                    error_message=f"model {request.model_name!r} not found")
                continue
            token = self.runtime.root_token.child()
            try:
                async for d in pipeline.generate_deltas(req, token=token):
                    yield pb.ModelStreamInferResponse(
                        infer_response=_text_response(
                            request.model_name, request.id, d.text,
                            d.finish_reason))
            except Exception as e:
                logger.exception("kserve stream failed")
                yield pb.ModelStreamInferResponse(error_message=str(e))
            finally:
                token.detach()

    # -- server lifecycle -------------------------------------------------
    def _handlers(self) -> grpc.GenericRpcHandler:
        def unary(fn, req_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString())

        rpcs = {
            "ServerLive": unary(self.ServerLive, pb.ServerLiveRequest),
            "ServerReady": unary(self.ServerReady, pb.ServerReadyRequest),
            "ModelReady": unary(self.ModelReady, pb.ModelReadyRequest),
            "ModelMetadata": unary(self.ModelMetadata,
                                   pb.ModelMetadataRequest),
            "ModelInfer": unary(self.ModelInfer, pb.ModelInferRequest),
            "ModelStreamInfer": grpc.stream_stream_rpc_method_handler(
                self.ModelStreamInfer,
                request_deserializer=pb.ModelInferRequest.FromString,
                response_serializer=lambda m: m.SerializeToString()),
        }
        return grpc.method_handlers_generic_handler(SERVICE, rpcs)

    async def start(self) -> "KserveGrpcService":
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((self._handlers(),))
        self.bound_port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        if self.bound_port == 0:
            raise OSError(
                f"KServe gRPC port {self.host}:{self.port} failed to bind")
        await self._server.start()
        logger.info("KServe gRPC service on %s:%d", self.host,
                    self.bound_port)
        return self

    async def close(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None
