"""Incremental output parsers: reasoning spans and tool calls.

A copy of dynamo_tpu/frontend/parsers.py.

Ref: lib/llm/src/preprocessor.rs:2182-3120 — the reference's stream
parsers split model output into reasoning_content (DeepSeek-R1-style
<think> spans), tool_calls (hermes-style <tool_call> JSON), and plain
content, with holdback so a tag split across stream chunks never leaks
half-emitted.  Same decomposition here as pure incremental reducers the
HTTP layer composes per request.
"""

from __future__ import annotations

import json
import logging
import secrets
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def _partial_suffix(text: str, tag: str) -> int:
    """Length of the longest suffix of `text` that is a proper prefix of
    `tag` (the holdback amount)."""
    for k in range(min(len(tag) - 1, len(text)), 0, -1):
        if text.endswith(tag[:k]):
            return k
    return 0


@dataclass
class ReasoningParser:
    """Splits <think>...</think> spans out of the stream.

    push(delta) -> (content_delta, reasoning_delta).  Text inside the
    tags streams as reasoning; the tags themselves are swallowed.  An
    unclosed span at flush() stays reasoning (R1 emits the close tag
    reliably; a truncated stream should not dump half a chain-of-thought
    into content)."""

    open_tag: str = "<think>"
    close_tag: str = "</think>"
    # R1-style templates end the PROMPT with the open tag, so the model
    # emits only the close tag: start inside the reasoning span (a leading
    # explicit open tag is still consumed if the model repeats it)
    start_in_reasoning: bool = False
    _buf: str = ""
    _in_reasoning: bool = field(default=False)
    _started: bool = False

    def __post_init__(self) -> None:
        self._in_reasoning = self.start_in_reasoning

    def push(self, delta: str) -> Tuple[str, str]:
        self._buf += delta
        if self.start_in_reasoning and not self._started:
            stripped = self._buf.lstrip()
            if stripped.startswith(self.open_tag):
                self._buf = stripped[len(self.open_tag):]
                self._started = True
            elif len(stripped) < len(self.open_tag) \
                    and self.open_tag.startswith(stripped):
                return "", ""  # could still be a leading open tag
            else:
                self._started = True
        content, reasoning = [], []
        while True:
            tag = self.close_tag if self._in_reasoning else self.open_tag
            i = self._buf.find(tag)
            if i < 0:
                hold = _partial_suffix(self._buf, tag)
                emit = self._buf[: len(self._buf) - hold]
                self._buf = self._buf[len(self._buf) - hold:]
                (reasoning if self._in_reasoning else content).append(emit)
                return "".join(content), "".join(reasoning)
            emit = self._buf[:i]
            (reasoning if self._in_reasoning else content).append(emit)
            self._buf = self._buf[i + len(tag):]
            self._in_reasoning = not self._in_reasoning

    def flush(self) -> Tuple[str, str]:
        out = self._buf
        self._buf = ""
        return ("", out) if self._in_reasoning else (out, "")


@dataclass
class ToolCallParser:
    """Extracts hermes-style tool calls from the content stream.

    push(delta) -> (content_delta, [completed OpenAI tool_call dicts]).
    A <tool_call> span buffers until its close tag, then its JSON body
    ({"name": ..., "arguments": {...}}) becomes
    {"id", "type": "function", "function": {"name", "arguments"}} with
    arguments re-serialized as a JSON string (the OpenAI wire shape).
    Malformed JSON falls back to plain content (never silently dropped).
    """

    open_tag: str = "<tool_call>"
    close_tag: str = "</tool_call>"
    _buf: str = ""
    _in_call: bool = False
    _n: int = field(default=0)

    def _mk_call(self, body: str) -> Optional[Dict[str, Any]]:
        try:
            obj = json.loads(body)
            name = obj["name"]
            args = obj.get("arguments", {})
        except (ValueError, TypeError, KeyError):
            return None
        self._n += 1
        return {
            "id": f"call_{secrets.token_hex(8)}",
            "index": self._n - 1,
            "type": "function",
            "function": {"name": name,
                         "arguments": json.dumps(args)},
        }

    def push(self, delta: str) -> Tuple[str, List[Dict[str, Any]]]:
        self._buf += delta
        content: List[str] = []
        calls: List[Dict[str, Any]] = []
        while True:
            tag = self.close_tag if self._in_call else self.open_tag
            i = self._buf.find(tag)
            if i < 0:
                if self._in_call:
                    # keep buffering the call body
                    return "".join(content), calls
                hold = _partial_suffix(self._buf, tag)
                emit = self._buf[: len(self._buf) - hold]
                self._buf = self._buf[len(self._buf) - hold:]
                content.append(emit)
                return "".join(content), calls
            span = self._buf[:i]
            self._buf = self._buf[i + len(tag):]
            if self._in_call:
                call = self._mk_call(span)
                if call is not None:
                    calls.append(call)
                else:
                    logger.warning("malformed tool call body; emitting as "
                                   "content")
                    content.append(self.open_tag + span + self.close_tag)
            else:
                content.append(span)
            self._in_call = not self._in_call

    def flush(self) -> str:
        """Unterminated partial state returns to content verbatim."""
        out = (self.open_tag + self._buf) if self._in_call else self._buf
        self._buf = ""
        self._in_call = False
        return out


@dataclass
class OutputDelta:
    content: str = ""
    reasoning: str = ""
    tool_calls: List[Dict[str, Any]] = field(default_factory=list)

    def __bool__(self) -> bool:
        return bool(self.content or self.reasoning or self.tool_calls)


class OutputParser:
    """Composition the HTTP layer drives: reasoning splits first, tool
    calls parse from the non-reasoning content.

    reasoning: falsy = off; "deepseek_r1" starts inside the reasoning
    span (R1 templates end the prompt with <think>); any other truthy
    value expects explicit open tags."""

    def __init__(self, reasoning=False, tools: bool = False):
        self.reasoning = ReasoningParser(
            start_in_reasoning=(reasoning == "deepseek_r1")
        ) if reasoning else None
        self.tools = ToolCallParser() if tools else None
        self.saw_tool_call = False

    @classmethod
    def for_request(cls, pipeline, body: Dict[str, Any]):
        """The one composition rule every HTTP route family shares
        (OpenAI chat + Anthropic messages): tool-call extraction when the
        request advertises tools, reasoning spans when the model card
        declares a parser.  None when neither applies."""
        reasoning = pipeline.mdc.runtime_config.get("reasoning_parser")
        if not (body.get("tools") or reasoning):
            return None
        return cls(reasoning=reasoning or False,
                   tools=bool(body.get("tools")))

    def push(self, delta: str) -> OutputDelta:
        out = OutputDelta()
        if self.reasoning is not None:
            delta, out.reasoning = self.reasoning.push(delta)
        if self.tools is not None:
            delta, out.tool_calls = self.tools.push(delta)
            self.saw_tool_call |= bool(out.tool_calls)
        out.content = delta
        return out

    def flush(self) -> OutputDelta:
        out = OutputDelta()
        rest = ""
        if self.reasoning is not None:
            rest, out.reasoning = self.reasoning.flush()
        if self.tools is not None:
            c1, calls = self.tools.push(rest) if rest else ("", [])
            out.tool_calls = calls
            self.saw_tool_call |= bool(calls)
            out.content = c1 + self.tools.flush()
        else:
            out.content = rest
        return out


def render_tools_preamble(tools: List[Dict[str, Any]]) -> str:
    """Hermes-style tool advertisement injected as a system preamble when
    the model card has no native tool template (ref: the reference's
    tool-choice prompt construction)."""
    lines = [
        "You may call functions to assist the user.  Available tools:",
    ]
    for t in tools:
        fn = t.get("function", t)
        lines.append(json.dumps(fn))
    lines.append(
        'To call a tool, emit <tool_call>{"name": <name>, "arguments": '
        "<args-object>}</tool_call>."
    )
    return "\n".join(lines)


def envelope_to_tool_call(text: str):
    """Guided tool-choice envelope {"name":..., "arguments": {...}} ->
    OpenAI tool_call dict; None when the text isn't the envelope (the
    caller falls back to plain content)."""
    try:
        obj = json.loads(text)
        name = obj["name"]
        args = obj.get("arguments", {})
    except (ValueError, TypeError, KeyError):
        return None
    return {
        "id": f"call_{secrets.token_hex(8)}",
        "index": 0,
        "type": "function",
        "function": {"name": name, "arguments": json.dumps(args)},
    }
