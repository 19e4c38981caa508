"""Anthropic Messages API over the model pipelines.

Ref: lib/llm/src/http/service/anthropic.rs — /v1/messages (unary + SSE)
and /v1/messages/count_tokens, mapped onto the same preprocessor/
pipeline path the OpenAI routes use.  The Anthropic SSE framing differs
structurally from OpenAI chunks: typed events
(message_start → content_block_start → content_block_delta* →
content_block_stop → message_delta → message_stop) with input usage
reported up front in message_start (anthropic.rs:282 notes the same).

Stop-reason mapping: length → max_tokens, stop-string → stop_sequence,
EOS → end_turn.

A copy of dynamo_tpu/frontend/anthropic.py on the port's HTTP server
(runtime/http_server.py `Request`, `Response`, `StreamResponse`).
"""

from __future__ import annotations

import asyncio
import json
import logging
import secrets
import time
from typing import Any, Dict, List, Optional, Tuple

from ..runtime.http_server import (
    HttpServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)

logger = logging.getLogger(__name__)


def _error(status: int, etype: str, msg: str) -> Response:
    return json_response(
        {"type": "error", "error": {"type": etype, "message": msg}},
        status=status)


def _convert_blocks(content) -> Any:
    """Anthropic content blocks -> OpenAI chat content parts.  Text and
    image blocks map losslessly (base64 source -> data URI); anything
    else raises so callers get a 400 instead of a silently-ignored
    input."""
    if not isinstance(content, list):
        return content
    parts: List[Dict[str, Any]] = []
    for b in content:
        if not isinstance(b, dict):
            raise ValueError("content blocks must be objects")
        btype = b.get("type")
        if btype == "text":
            parts.append({"type": "text", "text": b.get("text", "")})
        elif btype == "image":
            src = b.get("source") or {}
            if src.get("type") == "base64":
                uri = (f"data:{src.get('media_type', 'image/png')};"
                       f"base64,{src.get('data', '')}")
            elif src.get("type") == "url":
                uri = src.get("url", "")
            else:
                raise ValueError(
                    f"unsupported image source {src.get('type')!r}")
            parts.append({"type": "image_url", "image_url": {"url": uri}})
        else:
            raise ValueError(f"unsupported content block type {btype!r}")
    return parts


def _split_tool_blocks(m: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One Anthropic message -> one or more OpenAI-shaped messages,
    peeling tool_use (assistant) and tool_result (user) blocks out of the
    content list.  Prior assistant tool calls re-render as hermes
    <tool_call> spans — the textual form the model emitted them in, so
    any chat template reproduces the turn faithfully — and tool results
    become role "tool" messages."""
    role = m.get("role", "user")
    content = m.get("content")
    if not isinstance(content, list):
        return [{"role": role, "content": _convert_blocks(content)}]
    plain: List[Dict[str, Any]] = []
    out: List[Dict[str, Any]] = []
    for b in content:
        btype = b.get("type") if isinstance(b, dict) else None
        if btype == "tool_use":
            plain.append({
                "type": "text",
                "text": "<tool_call>" + json.dumps(
                    {"name": b.get("name", ""),
                     "arguments": b.get("input", {})}) + "</tool_call>"})
        elif btype == "thinking":
            continue  # prior-turn reasoning is not replayed into context
        elif btype == "tool_result":
            inner = b.get("content")
            if inner is None:
                inner = ""  # tools may legally return nothing
            if isinstance(inner, list):
                texts = []
                for x in inner:
                    if isinstance(x, dict) and x.get("type") == "text":
                        texts.append(x.get("text", ""))
                    else:
                        raise ValueError(
                            "unsupported tool_result content block "
                            f"{x.get('type') if isinstance(x, dict) else x!r}")
                inner = "".join(texts)
            if not isinstance(inner, str):
                inner = json.dumps(inner)
            if b.get("is_error"):
                # OpenAI tool messages carry no error field; mark the
                # failure in-band so the model sees it failed
                inner = f"[tool execution failed] {inner}"
            out.append({"role": "tool",
                        "tool_call_id": b.get("tool_use_id", ""),
                        "content": inner})
        else:
            plain.append(b)
    # tool messages come first (directly after the assistant tool-call
    # turn — Anthropic requires tool_result blocks lead the message, and
    # chat templates validate that adjacency); trailing user text follows
    if plain or not out:
        out.append({"role": role, "content": _convert_blocks(plain)})
    return out


def _to_chat_body(body: Dict[str, Any]) -> Tuple[Dict[str, Any], List[str]]:
    """Anthropic request -> OpenAI-chat-shaped body for the preprocessor.
    Returns (chat_body, stop_sequences)."""
    messages: List[Dict[str, Any]] = []
    system = body.get("system")
    if system:
        if isinstance(system, list):  # system content blocks
            system = "".join(b.get("text", "") for b in system
                             if isinstance(b, dict))
        messages.append({"role": "system", "content": system})
    for m in body.get("messages", []):
        messages.extend(_split_tool_blocks(m))
    stops = list(body.get("stop_sequences") or [])
    chat = {
        "model": body.get("model", ""),
        "messages": messages,
        "max_tokens": body.get("max_tokens", 256),
        "temperature": body.get("temperature", 1.0),
        "stop": stops,
    }
    if body.get("tools"):
        # Anthropic tool shape -> OpenAI function shape (the tools
        # preamble/parsers consume the OpenAI form)
        chat["tools"] = [
            {"type": "function",
             "function": {"name": t.get("name", ""),
                          "description": t.get("description", ""),
                          "parameters": t.get("input_schema", {})}}
            for t in body["tools"]]
    if body.get("top_p") is not None:
        chat["top_p"] = body["top_p"]
    if body.get("top_k") is not None:
        chat["top_k"] = body["top_k"]
    if body.get("ignore_eos"):  # benchmarking extension, same as OpenAI
        chat["ignore_eos"] = True
    return chat, stops


def _tool_use_block(call: Dict[str, Any]) -> Dict[str, Any]:
    """OpenAI tool_call dict (parsers.py wire shape) -> Anthropic
    tool_use content block; arguments re-parse from the JSON string the
    parser validated."""
    fn = call.get("function", {})
    try:
        args = json.loads(fn.get("arguments") or "{}")
    except ValueError:
        args = {}
    return {"type": "tool_use",
            "id": call.get("id", "").replace("call_", "toolu_", 1)
            or f"toolu_{secrets.token_hex(8)}",
            "name": fn.get("name", ""),
            "input": args}


def _stop_reason(finish: Optional[str],
                 trigger: Optional[str]) -> Tuple[str, Optional[str]]:
    """(stop_reason, stop_sequence): stop_sequence only when an actual
    stop string matched (EOS also reports finish 'stop' but must be
    end_turn)."""
    if finish == "length":
        return "max_tokens", None
    if trigger is not None:
        return "stop_sequence", trigger
    return "end_turn", None


class AnthropicRoutes:
    """Mixin-style route collection mounted on HttpService's server."""

    def __init__(self, service):
        self.service = service  # HttpService

    def mount(self, server: HttpServer) -> None:
        server.add_post("/v1/messages", self.h_messages)
        server.add_post("/v1/messages/count_tokens", self.h_count_tokens)

    # -- handlers ---------------------------------------------------------
    async def h_count_tokens(self, request: Request) -> Response:
        svc = self.service
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error(400, "invalid_request_error", "invalid JSON body")
        pipeline, lora = svc._resolve_pipeline(body.get("model", ""))
        if pipeline is None:
            return _error(404, "not_found_error",
                          f"model {body.get('model')!r} not found")
        try:
            chat, _ = _to_chat_body(body)
            req = pipeline.preprocessor.preprocess_chat(chat)
        except Exception as e:
            return _error(400, "invalid_request_error", str(e))
        return json_response({"input_tokens": len(req.token_ids)})

    async def h_messages(self, request: Request) -> StreamResponse:
        svc = self.service
        if svc._busy():
            return _error(529, "overloaded_error", "service busy")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error(400, "invalid_request_error", "invalid JSON body")
        model = body.get("model", "")
        pipeline, lora_name = svc._resolve_pipeline(model)
        if pipeline is None:
            return _error(404, "not_found_error",
                          f"model {model!r} not found")
        if not isinstance(body.get("messages"), list):
            return _error(400, "invalid_request_error",
                          "'messages' must be a list")
        if not isinstance(body.get("max_tokens"), int):
            return _error(400, "invalid_request_error",
                          "'max_tokens' is required")
        try:
            chat, stops = _to_chat_body(body)
            req = pipeline.preprocessor.preprocess_chat(chat)
        except Exception as e:
            return _error(400, "invalid_request_error",
                          f"preprocessing failed: {e}")
        if lora_name is not None:
            req.lora_name = lora_name
        from .affinity import session_affinity_from_headers
        from .request_trace import RequestTracker

        req.session_id, req.session_final = session_affinity_from_headers(
            request.headers)
        tracker = RequestTracker.from_headers(
            request.headers, req.request_id, model, svc.trace_sink,
            slo=svc.slo_plane, forensics=svc.forensics,
            timeline_on=svc.forensics is not None,
            session_id=req.session_id,
            endpoint="anthropic_messages",
            input_tokens=len(req.token_ids))
        from .. import obs

        tracker.propagate(req)
        # Same output-parser composition the OpenAI routes run:
        # Anthropic clients must see tool_use blocks / stop_reason
        # "tool_use", never raw <tool_call> text.
        from .parsers import OutputParser

        parser = OutputParser.for_request(pipeline, body)
        token = svc.runtime.root_token.child()
        svc._inflight_delta(+1)
        svc._m_requests.inc("dynamo_frontend_requests_total", model=model)
        t0 = time.monotonic()
        t_obs = obs.begin()
        # log<->trace correlation (same contract as the OpenAI routes):
        # bound immediately before the try whose finally unbinds it —
        # keep-alive requests share the connection task's context, and
        # a binding leaked past an exception would stamp this request's
        # id onto the next request's logs
        bind_tok = obs.bind_trace_id(tracker.trace_id)
        try:
            if body.get("stream"):
                return await self._stream(request, pipeline, req, model,
                                          stops, token, tracker, parser)
            return await self._unary(pipeline, req, model, stops, token,
                                     tracker, parser)
        finally:
            obs.end("request", t_obs, trace_id=tracker.trace_id,
                    request_id=req.request_id, model=model)
            obs.unbind_trace_id(bind_tok)
            svc._inflight_delta(-1)
            svc._m_requests.observe(
                "dynamo_frontend_request_duration_seconds",
                time.monotonic() - t0, model=model)
            token.detach()

    async def _unary(self, pipeline, req, model, stops, token,
                     tracker, parser=None) -> Response:
        from .service import HttpService, _LatencyProbe

        parts: List[str] = []
        thinking: List[str] = []
        tool_calls: List[Dict[str, Any]] = []

        def feed(text: str) -> None:
            if parser is None:
                parts.append(text)
                return
            out = parser.push(text)
            parts.append(out.content)
            thinking.append(out.reasoning)
            tool_calls.extend(out.tool_calls)

        finish = trigger = None
        ntok = 0
        probe = _LatencyProbe(self.service._m_requests, model)
        try:
            async for d in pipeline.generate_deltas(req, token=token,
                                                    tracker=tracker):
                if ntok == 0 and d.token_count:
                    tracker.cached_tokens = HttpService._kv_overlap_tokens(
                        pipeline, req.request_id)
                feed(d.text)
                probe.on_delta(d.token_count)
                tracker.on_tokens(d.token_count)
                ntok += d.token_count
                if d.finish_reason:
                    finish, trigger = d.finish_reason, d.stop_trigger
        except asyncio.CancelledError:
            token.kill()  # client went away; stop the engine
            tracker.finish(error="client_disconnected")
            raise
        except Exception as e:
            logger.exception("anthropic messages failed")
            tracker.finish(error=str(e))
            return _error(500, "api_error", str(e))
        if parser is not None:
            out = parser.flush()
            parts.append(out.content)
            thinking.append(out.reasoning)
            tool_calls.extend(out.tool_calls)
        content: List[Dict[str, Any]] = []
        think_text = "".join(thinking)
        if think_text:
            # signature is required by Anthropic SDK response models; we
            # have no signing scheme, so an empty signature satisfies the
            # schema (clients never verify locally)
            content.append({"type": "thinking", "thinking": think_text,
                            "signature": ""})
        text = "".join(parts)
        if text or not (think_text or tool_calls):
            content.append({"type": "text", "text": text})
        for call in tool_calls:
            content.append(_tool_use_block(call))
        if tool_calls:
            stop_reason, stop_seq = "tool_use", None
        else:
            stop_reason, stop_seq = _stop_reason(finish, trigger)
        tracker.add_tool_calls(tool_calls)
        tracker.finish(finish_reason=stop_reason)
        return json_response({
            "id": f"msg_{secrets.token_hex(12)}",
            "type": "message",
            "role": "assistant",
            "model": model,
            "content": content,
            "stop_reason": stop_reason,
            "stop_sequence": stop_seq,
            "usage": {"input_tokens": len(req.token_ids),
                      "output_tokens": ntok},
        }, headers={"X-Request-Id": tracker.x_request_id})

    async def _stream(self, request, pipeline, req, model, stops, token,
                      tracker, parser=None) -> StreamResponse:
        resp = StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "X-Request-Id": tracker.x_request_id,
        })
        await resp.prepare(request)

        async def event(name: str, data: Dict[str, Any]) -> None:
            await resp.write(
                f"event: {name}\ndata: {json.dumps(data)}\n\n".encode())

        msg_id = f"msg_{secrets.token_hex(12)}"
        await event("message_start", {
            "type": "message_start",
            "message": {"id": msg_id, "type": "message",
                        "role": "assistant", "model": model, "content": [],
                        "stop_reason": None, "stop_sequence": None,
                        "usage": {"input_tokens": len(req.token_ids),
                                  "output_tokens": 0}}})
        from .service import HttpService, _LatencyProbe

        # Typed content blocks open lazily as the parsed stream flips
        # between thinking / text / tool_use, so block indices follow the
        # Anthropic framing (one start/stop pair per block, in order).
        blk = {"index": -1, "open": None}

        async def close_block() -> None:
            if blk["open"] is not None:
                if blk["open"] == "thinking":
                    # SDK ThinkingBlock requires a signature; emit an
                    # empty one before the stop (no signing scheme here)
                    await event("content_block_delta", {
                        "type": "content_block_delta",
                        "index": blk["index"],
                        "delta": {"type": "signature_delta",
                                  "signature": ""}})
                await event("content_block_stop",
                            {"type": "content_block_stop",
                             "index": blk["index"]})
                blk["open"] = None

        async def open_block(kind: str, block: Dict[str, Any]) -> None:
            await close_block()
            blk["index"] += 1
            blk["open"] = kind
            await event("content_block_start", {
                "type": "content_block_start", "index": blk["index"],
                "content_block": block})

        async def emit_text(text: str) -> None:
            if blk["open"] != "text":
                await open_block("text", {"type": "text", "text": ""})
            await event("content_block_delta", {
                "type": "content_block_delta", "index": blk["index"],
                "delta": {"type": "text_delta", "text": text}})

        async def emit_thinking(text: str) -> None:
            if blk["open"] != "thinking":
                await open_block("thinking", {"type": "thinking",
                                              "thinking": "",
                                              "signature": ""})
            await event("content_block_delta", {
                "type": "content_block_delta", "index": blk["index"],
                "delta": {"type": "thinking_delta", "thinking": text}})

        async def emit_tool(call: Dict[str, Any]) -> None:
            # a parsed call is complete by construction (the parser only
            # yields on the close tag), so the block emits as start →
            # one input_json_delta carrying the full arguments → stop
            block = _tool_use_block(call)
            await open_block("tool_use", {"type": "tool_use",
                                          "id": block["id"],
                                          "name": block["name"],
                                          "input": {}})
            await event("content_block_delta", {
                "type": "content_block_delta", "index": blk["index"],
                "delta": {"type": "input_json_delta",
                          "partial_json": json.dumps(block["input"])}})
            await close_block()

        ntok = 0
        finish = trigger = None
        saw_tools = False
        flushed = False
        probe = _LatencyProbe(self.service._m_requests, model)

        async def emit_parsed(text, thinking, calls) -> None:
            nonlocal saw_tools
            if thinking:
                await emit_thinking(thinking)
            if text:
                await emit_text(text)
            for call in calls:
                saw_tools = True
                tracker.add_tool_calls([call])
                await emit_tool(call)

        try:
            async for d in pipeline.generate_deltas(req, token=token,
                                                    tracker=tracker):
                if ntok == 0 and d.token_count:
                    tracker.cached_tokens = HttpService._kv_overlap_tokens(
                        pipeline, req.request_id)
                probe.on_delta(d.token_count)
                tracker.on_tokens(d.token_count)
                ntok += d.token_count
                text, thinking, calls = d.text, "", []
                if parser is not None:
                    out = parser.push(d.text)
                    if d.finish_reason is not None:
                        fl = parser.flush()
                        flushed = True
                        out.content += fl.content
                        out.reasoning += fl.reasoning
                        out.tool_calls.extend(fl.tool_calls)
                    text, thinking, calls = (out.content, out.reasoning,
                                             out.tool_calls)
                await emit_parsed(text, thinking, calls)
                if d.finish_reason:
                    finish, trigger = d.finish_reason, d.stop_trigger
                    break
            if parser is not None and not flushed:
                # stream ended without a finish_reason delta: recover
                # whatever the parser still holds (unclosed spans)
                fl = parser.flush()
                await emit_parsed(fl.content, fl.reasoning, fl.tool_calls)
            if saw_tools:
                stop_reason, stop_seq = "tool_use", None
            else:
                stop_reason, stop_seq = _stop_reason(finish, trigger)
            if blk["index"] < 0:
                # zero-content stream: still frame one (empty) text block
                await open_block("text", {"type": "text", "text": ""})
            await close_block()
            await event("message_delta", {
                "type": "message_delta",
                "delta": {"stop_reason": stop_reason,
                          "stop_sequence": stop_seq},
                "usage": {"output_tokens": ntok}})
            await event("message_stop", {"type": "message_stop"})
            tracker.finish(finish_reason=stop_reason)
        except (ConnectionResetError, asyncio.CancelledError):
            token.kill()
            tracker.finish(error="client_disconnected")
            return resp
        except Exception as e:
            logger.exception("anthropic stream failed")
            tracker.finish(error=str(e))
            try:
                await event("error", {"type": "error",
                                      "error": {"type": "api_error",
                                                "message": str(e)}})
            except ConnectionResetError:
                return resp
        try:
            await resp.write_eof()
        except ConnectionResetError:
            pass
        return resp
