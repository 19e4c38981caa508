"""OpenAI route families beyond chat/completions/embeddings: the
Responses API, Files, and Batches.

Ref: lib/llm/src/http/service/openai.rs:2297 (responses family), :3112
(batches/files families) — the reference treats /v1/responses as a
first-class citizen beside chat, and batches/files as the offline-jobs
pair.  Redesigned for this stack:

  * /v1/responses maps onto the SAME per-model chat pipeline the chat
    route uses (one preprocessor, one router, one engine contract);
    conversation state for `previous_response_id` chaining is kept in a
    bounded in-memory store (the reference stores responses server-side
    the same way; durable storage is a deployment concern).
  * /v1/files is a directory-backed object store (DYN_FILES_PATH, or a
    per-process temp dir): upload once, reference from batches.
  * /v1/batches executes a JSONL file of chat/completions/embeddings
    requests through the service's own handlers with bounded
    concurrency — the offline counterpart of loadgen's trace replay —
    and writes an output JSONL file back into the file store.

Mounted by HttpService the same way the Anthropic family is.

A copy of dynamo_tpu/frontend/openai_extra.py on the port's HTTP server
(runtime/http_server.py): `_InlineRequest` and `_response_payload` stand
in for its `Request` and read its `Response`, and the multipart upload
route streams its body (`add_post(..., stream=True)`) through the
server's multipart reader.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import secrets
import tempfile
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..runtime.http_server import (
    HttpServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)

logger = logging.getLogger(__name__)

_ID_RE = re.compile(r"^[A-Za-z0-9_\-]{1,128}$")


class _InlineRequest:
    """Duck-typed stand-in for the server's Request, for running a route
    handler internally (batch items, responses->chat mapping) without a
    network hop.  Carries exactly what _handle_inference touches."""

    def __init__(self, body: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None):
        self._body = body
        self.headers = headers or {}

    async def json(self):
        return self._body


async def _response_payload(resp) -> Tuple[int, Any]:
    if not isinstance(resp, Response):
        # a StreamResponse has no body to read (Response is the whole-
        # body kind) — an inline handler must never stream
        raise TypeError("inline handlers must not stream")
    try:
        return resp.status, json.loads(bytes(resp.body))
    except (TypeError, ValueError):
        return resp.status, {"error": {"message": "non-JSON response"}}


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


class UploadTooLarge(Exception):
    """A streamed upload crossed the store's size cap (HTTP 413)."""

    def __init__(self, cap: int):
        super().__init__(f"upload exceeds the {cap}-byte limit")
        self.cap = cap


class FileStore:
    """Directory-backed /v1/files objects: bytes + a JSON metadata
    sidecar, ids are `file-<hex>`.  Safe ids only — names never leave the
    store directory.  Uploads are size-capped (DYN_FILES_MAX_BYTES,
    default 256 MiB) and multipart payloads stream to disk in bounded
    chunks — a multi-GB body must never buffer in process memory."""

    UPLOAD_CHUNK = 64 * 1024

    def __init__(self, root: Optional[str] = None,
                 max_upload_bytes: Optional[int] = None):
        self.root = root or os.environ.get("DYN_FILES_PATH") or \
            os.path.join(tempfile.gettempdir(),
                         f"dyn-files-{os.getpid()}")
        self.max_upload_bytes = max_upload_bytes if max_upload_bytes \
            is not None else int(os.environ.get(
                "DYN_FILES_MAX_BYTES", str(256 * 1024 * 1024)))
        os.makedirs(self.root, exist_ok=True)

    async def stage_part(self, part) -> Tuple[str, int]:
        """Stream one multipart body part into a temp file inside the
        store directory (same filesystem as its final home, so adoption
        is a rename).  Raises UploadTooLarge past the cap, removing the
        partial file.  Disk writes run in the default executor so a
        cap-sized upload onto a slow disk never stalls the event loop's
        other coroutines (in-flight generate streams, health checks)."""
        tmp = os.path.join(self.root, f".upload-{secrets.token_hex(8)}.tmp")
        loop = asyncio.get_running_loop()
        n = 0
        try:
            # open/close join the writes in the executor: creating (and
            # flushing, on close) a file on a slow disk is sync I/O the
            # event loop must not absorb either (DYN004)
            f = await loop.run_in_executor(None, open, tmp, "wb")
            try:
                while True:
                    chunk = await part.read_chunk(self.UPLOAD_CHUNK)
                    if not chunk:
                        break
                    n += len(chunk)
                    if n > self.max_upload_bytes:
                        raise UploadTooLarge(self.max_upload_bytes)
                    await loop.run_in_executor(None, f.write, chunk)
            finally:
                await loop.run_in_executor(None, f.close)
        except BaseException:
            self.discard_staged(tmp)
            raise
        return tmp, n

    def discard_staged(self, tmp_path: str) -> None:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass

    def put_staged(self, tmp_path: str, nbytes: int, filename: str,
                   purpose: str) -> Dict:
        """Adopt a staged payload: rename into place + metadata sidecar."""
        file_id = f"file-{secrets.token_hex(12)}"
        bin_p, meta_p = self._paths(file_id)
        meta = {
            "id": file_id, "object": "file", "bytes": nbytes,
            "created_at": int(time.time()), "filename": filename,
            "purpose": purpose,
        }
        os.replace(tmp_path, bin_p)
        with open(meta_p, "w") as f:
            json.dump(meta, f)
        return meta

    def _paths(self, file_id: str) -> Tuple[str, str]:
        if not _ID_RE.match(file_id):
            raise KeyError(file_id)
        base = os.path.join(self.root, file_id)
        return base + ".bin", base + ".json"

    def put(self, data: bytes, filename: str, purpose: str) -> Dict:
        file_id = f"file-{secrets.token_hex(12)}"
        bin_p, meta_p = self._paths(file_id)
        meta = {
            "id": file_id, "object": "file", "bytes": len(data),
            "created_at": int(time.time()), "filename": filename,
            "purpose": purpose,
        }
        with open(bin_p, "wb") as f:
            f.write(data)
        with open(meta_p, "w") as f:
            json.dump(meta, f)
        return meta

    def meta(self, file_id: str) -> Optional[Dict]:
        try:
            _, meta_p = self._paths(file_id)
            with open(meta_p) as f:
                return json.load(f)
        except (KeyError, OSError, ValueError):
            return None

    def content(self, file_id: str) -> Optional[bytes]:
        try:
            bin_p, _ = self._paths(file_id)
            with open(bin_p, "rb") as f:
                return f.read()
        except (KeyError, OSError):
            return None

    def delete(self, file_id: str) -> bool:
        try:
            bin_p, meta_p = self._paths(file_id)
        except KeyError:
            return False
        found = False
        for p in (bin_p, meta_p):
            try:
                os.unlink(p)
                found = True
            except OSError:
                pass
        return found

    def list(self) -> List[Dict]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".json"):
                m = self.meta(name[:-5])
                if m is not None:
                    out.append(m)
        return out


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------


class ResponseStore:
    """Bounded in-memory store of completed responses; holds both the
    API objects (GET /v1/responses/{id}) and the message transcripts that
    `previous_response_id` chaining replays."""

    def __init__(self, cap: int = 1024):
        self.cap = cap
        self._items: "OrderedDict[str, Dict]" = OrderedDict()

    def put(self, response: Dict, messages: List[Dict]) -> None:
        self._items[response["id"]] = {"response": response,
                                       "messages": messages}
        while len(self._items) > self.cap:
            self._items.popitem(last=False)

    def get(self, rid: str) -> Optional[Dict]:
        item = self._items.get(rid)
        return item["response"] if item else None

    def messages(self, rid: str) -> Optional[List[Dict]]:
        item = self._items.get(rid)
        return item["messages"] if item else None

    def delete(self, rid: str) -> bool:
        return self._items.pop(rid, None) is not None


def _input_to_messages(payload: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Responses `input` (string | list of items) + `instructions` ->
    chat messages."""
    messages: List[Dict[str, Any]] = []
    instructions = payload.get("instructions")
    if instructions:
        messages.append({"role": "system", "content": str(instructions)})
    raw = payload.get("input")
    if raw is None:
        raise ValueError("'input' is required")
    if isinstance(raw, str):
        messages.append({"role": "user", "content": raw})
        return messages
    if not isinstance(raw, list):
        raise ValueError("'input' must be a string or a list of items")
    for item in raw:
        if not isinstance(item, dict):
            raise ValueError("input items must be objects")
        itype = item.get("type", "message")
        if itype != "message":
            raise ValueError(f"unsupported input item type {itype!r}")
        role = item.get("role", "user")
        content = item.get("content", "")
        if isinstance(content, list):
            # content parts: input_text / output_text carry text
            parts = []
            for part in content:
                if isinstance(part, dict) and part.get("type") in (
                        "input_text", "output_text", "text"):
                    parts.append(str(part.get("text", "")))
                else:
                    raise ValueError(
                        "unsupported content part in input item")
            content = "".join(parts)
        messages.append({"role": role, "content": str(content)})
    return messages


def _response_object(rid: str, model: str, text: str, usage: Dict,
                     status: str = "completed") -> Dict[str, Any]:
    return {
        "id": rid,
        "object": "response",
        "created_at": int(time.time()),
        "status": status,
        "model": model,
        "output": [{
            "type": "message", "id": f"msg_{rid[5:]}",
            "status": "completed", "role": "assistant",
            "content": [{"type": "output_text", "text": text,
                         "annotations": []}],
        }],
        "output_text": text,
        "usage": usage,
    }


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

_BATCH_ENDPOINTS = ("/v1/chat/completions", "/v1/completions",
                    "/v1/embeddings")


class Batch:
    def __init__(self, batch_id: str, input_file_id: str, endpoint: str,
                 completion_window: str, metadata: Optional[Dict]):
        now = int(time.time())
        self.id = batch_id
        self.input_file_id = input_file_id
        self.endpoint = endpoint
        self.completion_window = completion_window
        self.metadata = metadata
        self.status = "validating"
        self.created_at = now
        self.output_file_id: Optional[str] = None
        self.error_file_id: Optional[str] = None
        self.counts = {"total": 0, "completed": 0, "failed": 0}
        self.errors: List[Dict] = []
        self.completed_at: Optional[int] = None
        self.cancelled = False
        self.task: Optional[asyncio.Task] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id, "object": "batch",
            "endpoint": self.endpoint,
            "input_file_id": self.input_file_id,
            "completion_window": self.completion_window,
            "status": self.status,
            "output_file_id": self.output_file_id,
            "error_file_id": self.error_file_id,
            "created_at": self.created_at,
            "completed_at": self.completed_at,
            "request_counts": dict(self.counts),
            "errors": ({"object": "list", "data": self.errors[:10]}
                       if self.errors else None),
            "metadata": self.metadata,
        }


class ExtraRoutes:
    """Mounts /v1/responses, /v1/files, /v1/batches on the HttpService."""

    BATCH_CONCURRENCY = 8
    MAX_BATCHES = 512

    def __init__(self, service):
        self.service = service
        self.files = FileStore()
        self.responses = ResponseStore()
        self.batches: Dict[str, Batch] = {}

    def mount(self, server: HttpServer) -> None:
        r = server
        r.add_post("/v1/responses", self.h_responses)
        r.add_get("/v1/responses/{rid}", self.h_get_response)
        r.add_delete("/v1/responses/{rid}", self.h_delete_response)
        # the upload streams its body: a multipart part goes to disk in
        # bounded chunks as it arrives (FileStore.stage_part)
        r.add_post("/v1/files", self.h_upload_file, stream=True)
        r.add_get("/v1/files", self.h_list_files)
        r.add_get("/v1/files/{fid}", self.h_get_file)
        r.add_get("/v1/files/{fid}/content", self.h_file_content)
        r.add_delete("/v1/files/{fid}", self.h_delete_file)
        r.add_post("/v1/batches", self.h_create_batch)
        r.add_get("/v1/batches", self.h_list_batches)
        r.add_get("/v1/batches/{bid}", self.h_get_batch)
        r.add_post("/v1/batches/{bid}/cancel", self.h_cancel_batch)

    # -- responses --------------------------------------------------------

    async def h_responses(self, request: Request) -> StreamResponse:
        svc = self.service
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            return svc._error(400, "invalid JSON body")
        model = payload.get("model", "")
        try:
            messages = _input_to_messages(payload)
        except ValueError as e:
            return svc._error(400, str(e))
        prev = payload.get("previous_response_id")
        if prev:
            history = self.responses.messages(prev)
            if history is None:
                return svc._error(
                    404, f"previous response {prev!r} not found",
                    "not_found_error")
            messages = history + messages
        chat_body: Dict[str, Any] = {"model": model, "messages": messages}
        for src, dst in (("max_output_tokens", "max_tokens"),
                         ("temperature", "temperature"),
                         ("top_p", "top_p"), ("tools", "tools"),
                         ("tool_choice", "tool_choice")):
            if payload.get(src) is not None:
                chat_body[dst] = payload[src]
        rid = f"resp_{secrets.token_hex(12)}"
        store = payload.get("store", True)

        if payload.get("stream"):
            return await self._stream_responses(
                request, payload, chat_body, messages, rid, model, store)

        status, data = await _response_payload(
            await svc._handle_inference(_InlineRequest(chat_body),
                                        chat=True))
        if status != 200:
            return json_response(data, status=status)
        choice = data["choices"][0]
        text = choice["message"].get("content") or ""
        usage = {
            "input_tokens": data["usage"]["prompt_tokens"],
            "output_tokens": data["usage"]["completion_tokens"],
            "total_tokens": data["usage"]["total_tokens"],
        }
        obj = _response_object(rid, model, text, usage)
        if choice["message"].get("tool_calls"):
            obj["output"] = [
                {"type": "function_call",
                 "id": f"fc_{secrets.token_hex(8)}",
                 "call_id": tc.get("id", ""),
                 "name": tc["function"]["name"],
                 "arguments": tc["function"]["arguments"],
                 "status": "completed"}
                for tc in choice["message"]["tool_calls"]
            ] + obj["output"]
        if store:
            self.responses.put(
                obj, messages + [{"role": "assistant", "content": text}])
        return json_response(obj)

    async def _stream_responses(self, request, payload, chat_body,
                                messages, rid, model,
                                store) -> StreamResponse:
        """Responses-API SSE: typed events over the same token stream
        (response.created / output_text.delta / completed)."""
        svc = self.service
        pipeline, lora_name = svc._resolve_pipeline(model)
        if pipeline is None:
            return svc._error(
                404, f"model {model!r} not found", "not_found_error")
        try:
            req = pipeline.preprocessor.preprocess_chat(chat_body)
        except Exception as e:
            return svc._error(400, f"preprocessing failed: {e}")
        if lora_name is not None:
            req.lora_name = lora_name

        resp = StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        seq = 0

        async def emit(event: str, obj: Dict) -> None:
            nonlocal seq
            obj = {"type": event, "sequence_number": seq, **obj}
            seq += 1
            await resp.write(f"event: {event}\ndata: "
                             f"{json.dumps(obj)}\n\n".encode())

        skeleton = _response_object(rid, model, "", usage={},
                                    status="in_progress")
        skeleton.pop("output_text")
        skeleton["output"] = []
        await emit("response.created", {"response": skeleton})
        parts: List[str] = []
        ntok = 0
        token = svc.runtime.root_token.child()
        svc._inflight_delta(+1)
        try:
            async for d in pipeline.generate_deltas(req, token=token):
                if d.text:
                    parts.append(d.text)
                    await emit("response.output_text.delta", {
                        "item_id": f"msg_{rid[5:]}", "output_index": 0,
                        "content_index": 0, "delta": d.text})
                ntok += d.token_count
        except asyncio.CancelledError:
            token.kill()
            raise
        except Exception as e:
            logger.exception("responses stream failed")
            await emit("error", {"message": str(e)})
            await resp.write_eof()
            return resp
        finally:
            svc._inflight_delta(-1)
            token.detach()
        text = "".join(parts)
        await emit("response.output_text.done", {
            "item_id": f"msg_{rid[5:]}", "output_index": 0,
            "content_index": 0, "text": text})
        usage = {"input_tokens": len(req.token_ids),
                 "output_tokens": ntok,
                 "total_tokens": len(req.token_ids) + ntok}
        final = _response_object(rid, model, text, usage)
        await emit("response.completed", {"response": final})
        await resp.write_eof()
        if store:
            self.responses.put(
                final, messages + [{"role": "assistant", "content": text}])
        return resp

    async def h_get_response(self, request: Request) -> Response:
        obj = self.responses.get(request.match_info["rid"])
        if obj is None:
            return self.service._error(404, "response not found",
                                       "not_found_error")
        return json_response(obj)

    async def h_delete_response(self, request: Request) -> Response:
        rid = request.match_info["rid"]
        if not self.responses.delete(rid):
            return self.service._error(404, "response not found",
                                       "not_found_error")
        return json_response(
            {"id": rid, "object": "response", "deleted": True})

    # -- files ------------------------------------------------------------

    async def h_upload_file(self, request: Request) -> Response:
        staged = []  # tmp paths of streamed multipart parts
        try:
            return await self._upload_file(request, staged.append)
        except BaseException:
            # the multipart stream failed (client abort, malformed
            # boundary) AFTER the 'file' part was staged — drop the
            # orphans before unwinding, or aborted uploads accumulate
            # cap-sized .tmp files in the store root (adopted/discarded
            # paths unlink as a no-op)
            for tmp in staged:
                self.files.discard_staged(tmp)
            raise

    async def _upload_file(self, request: Request,
                           track) -> Response:
        purpose, filename, data = "", "upload", None
        staged = None  # (tmp_path, nbytes) of a streamed multipart part
        ctype = request.content_type or ""
        if ctype.startswith("multipart/"):
            reader = await request.multipart()
            async for part in reader:
                if part.name == "purpose":
                    # bounded read: part.text() would buffer an
                    # arbitrarily large part in memory, the same hole
                    # stage_part closes for the file part
                    raw = b""
                    while len(raw) <= 4096:
                        chunk = await part.read_chunk(4096)
                        if not chunk:
                            break
                        raw += chunk
                    else:
                        if staged is not None:
                            self.files.discard_staged(staged[0])
                        return self.service._error(
                            400, "'purpose' part too large")
                    purpose = raw.decode(errors="replace").strip()
                elif part.name == "file":
                    filename = part.filename or "upload"
                    if staged is not None:  # duplicate 'file' part
                        self.files.discard_staged(staged[0])
                    # stream to disk in bounded chunks with a hard size
                    # cap — part.read() would buffer an unbounded body
                    # in memory
                    try:
                        staged = await self.files.stage_part(part)
                        track(staged[0])
                    except UploadTooLarge as e:
                        return self.service._error(
                            413, str(e), "request_too_large")
        else:
            # JSON convenience shape: {"purpose": ..., "filename": ...,
            # "content": "<jsonl text>"} — curl-able without multipart
            try:
                body = await request.json()
            except json.JSONDecodeError:
                return self.service._error(
                    400, "expected multipart/form-data or JSON body")
            purpose = body.get("purpose", "")
            filename = body.get("filename", "upload")
            content = body.get("content")
            data = content.encode() if isinstance(content, str) else None
            if data is not None and len(data) > self.files.max_upload_bytes:
                return self.service._error(
                    413, str(UploadTooLarge(self.files.max_upload_bytes)),
                    "request_too_large")
        if staged is None and data is None:
            return self.service._error(400, "no file content provided")
        if not purpose:
            if staged is not None:
                self.files.discard_staged(staged[0])
            return self.service._error(400, "'purpose' is required")
        if staged is not None:
            meta = self.files.put_staged(staged[0], staged[1], filename,
                                         purpose)
        else:
            meta = self.files.put(data, filename, purpose)
        return json_response(meta)

    async def h_list_files(self, request: Request) -> Response:
        return json_response(
            {"object": "list", "data": self.files.list()})

    async def h_get_file(self, request: Request) -> Response:
        meta = self.files.meta(request.match_info["fid"])
        if meta is None:
            return self.service._error(404, "file not found",
                                       "not_found_error")
        return json_response(meta)

    async def h_file_content(self, request: Request) -> Response:
        data = self.files.content(request.match_info["fid"])
        if data is None:
            return self.service._error(404, "file not found",
                                       "not_found_error")
        return Response(body=data,
                            content_type="application/octet-stream")

    async def h_delete_file(self, request: Request) -> Response:
        fid = request.match_info["fid"]
        if not self.files.delete(fid):
            return self.service._error(404, "file not found",
                                       "not_found_error")
        return json_response(
            {"id": fid, "object": "file", "deleted": True})

    # -- batches ----------------------------------------------------------

    async def h_create_batch(self, request: Request) -> Response:
        svc = self.service
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return svc._error(400, "invalid JSON body")
        input_file_id = body.get("input_file_id", "")
        endpoint = body.get("endpoint", "")
        if endpoint not in _BATCH_ENDPOINTS:
            return svc._error(
                400, f"endpoint must be one of {_BATCH_ENDPOINTS}")
        if self.files.content(input_file_id) is None:
            return svc._error(404, f"file {input_file_id!r} not found",
                              "not_found_error")
        batch = Batch(
            f"batch_{secrets.token_hex(12)}", input_file_id, endpoint,
            body.get("completion_window", "24h"), body.get("metadata"))
        self.batches[batch.id] = batch
        # bounded history: evict the oldest FINISHED batches (running
        # jobs stay; their output files live in the FileStore regardless)
        done = [b for b in self.batches.values()
                if b.status in ("completed", "cancelled", "failed")]
        for old in done[:max(0, len(self.batches) - self.MAX_BATCHES)]:
            self.batches.pop(old.id, None)
        batch.task = asyncio.create_task(self._run_batch(batch))
        return json_response(batch.to_dict())

    async def _run_batch(self, batch: Batch) -> None:
        svc = self.service
        data = self.files.content(batch.input_file_id) or b""
        lines = [ln for ln in data.decode("utf-8", "replace").splitlines()
                 if ln.strip()]
        batch.counts["total"] = len(lines)
        batch.status = "in_progress"
        sem = asyncio.Semaphore(self.BATCH_CONCURRENCY)
        results: List[Optional[Dict]] = [None] * len(lines)

        async def one(i: int, line: str) -> None:
            custom_id = None
            try:
                item = json.loads(line)
                custom_id = item.get("custom_id")
                url = item.get("url", batch.endpoint)
                if url != batch.endpoint:
                    raise ValueError(
                        f"line url {url!r} != batch endpoint")
                req_body = dict(item.get("body") or {})
                req_body.pop("stream", None)  # batch items never stream
                async with sem:
                    if batch.cancelled:
                        return
                    if batch.endpoint == "/v1/embeddings":
                        h = svc.h_embeddings
                    elif batch.endpoint == "/v1/completions":
                        h = svc.h_completions
                    else:
                        h = svc.h_chat
                    status, payload = await _response_payload(
                        await h(_InlineRequest(req_body)))
                results[i] = {
                    "id": f"batch_req_{secrets.token_hex(8)}",
                    "custom_id": custom_id,
                    "response": {"status_code": status, "body": payload},
                    "error": None,
                }
                if status == 200:
                    batch.counts["completed"] += 1
                else:
                    batch.counts["failed"] += 1
            except asyncio.CancelledError:
                raise
            except Exception as e:
                batch.counts["failed"] += 1
                results[i] = {
                    "id": f"batch_req_{secrets.token_hex(8)}",
                    "custom_id": custom_id,
                    "response": None,
                    "error": {"message": str(e)},
                }

        try:
            await asyncio.gather(*(one(i, ln)
                                   for i, ln in enumerate(lines)))
        except asyncio.CancelledError:
            batch.status = "cancelled"
            return
        ok_lines = [json.dumps(r) for r in results
                    if r is not None and r["error"] is None]
        err_lines = [json.dumps(r) for r in results
                     if r is not None and r["error"] is not None]
        if ok_lines:
            batch.output_file_id = self.files.put(
                ("\n".join(ok_lines) + "\n").encode(),
                f"{batch.id}_output.jsonl", "batch_output")["id"]
        if err_lines:
            batch.error_file_id = self.files.put(
                ("\n".join(err_lines) + "\n").encode(),
                f"{batch.id}_errors.jsonl", "batch_output")["id"]
        batch.completed_at = int(time.time())
        batch.status = "cancelled" if batch.cancelled else "completed"

    async def h_list_batches(self, request: Request) -> Response:
        return json_response({
            "object": "list",
            "data": [b.to_dict() for b in self.batches.values()],
        })

    async def h_get_batch(self, request: Request) -> Response:
        b = self.batches.get(request.match_info["bid"])
        if b is None:
            return self.service._error(404, "batch not found",
                                       "not_found_error")
        return json_response(b.to_dict())

    async def h_cancel_batch(self, request: Request) -> Response:
        b = self.batches.get(request.match_info["bid"])
        if b is None:
            return self.service._error(404, "batch not found",
                                       "not_found_error")
        b.cancelled = True
        if b.status in ("validating", "in_progress"):
            b.status = "cancelling"
        return json_response(b.to_dict())

    async def close(self) -> None:
        for b in self.batches.values():
            if b.task is not None and not b.task.done():
                b.task.cancel()
                try:
                    await b.task
                except (asyncio.CancelledError, Exception):
                    pass
