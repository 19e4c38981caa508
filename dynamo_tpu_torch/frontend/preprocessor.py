"""OpenAI request preprocessing: chat templating + tokenization + params.

A copy of dynamo_tpu/frontend/preprocessor.py.  Its multimodal branch
hashes media with the port's multimodal/encoder.py `media_hash`; the
frontend's encoder hop (multimodal/hop.py) consumes the descriptors.

Ref: lib/llm/src/preprocessor.rs:286 (OpenAIPreprocessor) — minijinja chat
templating + HF tokenization producing a PreprocessedRequest.  jinja2 is the
Python equivalent of minijinja; HF chat templates render unchanged.
"""

from __future__ import annotations

import secrets
from typing import Any, Dict, List, Optional

import jinja2

from ..protocols import (
    ModelDeploymentCard,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from .tokenizer import Tokenizer, tokenizer_from_mdc

DEFAULT_CHAT_TEMPLATE = (
    "{% for m in messages %}"
    "<|{{ m['role'] }}|>\n{{ m['content'] }}<|end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)

DEFAULT_MAX_TOKENS = 512

# literal marker threaded through chat templating to carry an image's
# position into the tokenized prompt (split out in _build, never encoded)
_IMAGE_MARKER = "\x00<|dyn_image|>\x00"


class OpenAIPreprocessor:
    def __init__(self, mdc: ModelDeploymentCard,
                 tokenizer: Optional[Tokenizer] = None):
        self.mdc = mdc
        self.tokenizer = tokenizer or tokenizer_from_mdc(mdc.tokenizer)
        env = jinja2.Environment()
        self.template = env.from_string(mdc.chat_template or DEFAULT_CHAT_TEMPLATE)

    # -- request builders -------------------------------------------------
    def render_chat(self, messages: List[Dict[str, Any]],
                    tools: Optional[List[Dict[str, Any]]] = None) -> str:
        return self.template.render(
            messages=messages, add_generation_prompt=True, tools=tools
        )

    @staticmethod
    def _flatten_content(messages: List[Dict[str, Any]]):
        """OpenAI multimodal messages (content as a part list) -> string
        content with image markers + the extracted data URIs, in order.

        Ref: the reference preprocessor's multimodal fetch path
        (preprocessor.rs media handling); no-egress policy restricts URLs
        to data: URIs here."""
        from ..multimodal.encoder import media_hash

        flat = []
        media: List[Dict[str, Any]] = []
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                flat.append(m)
                continue
            text_parts = []
            for part in content:
                ptype = part.get("type")
                if ptype == "text":
                    # the marker is in-band: strip it from user text so a
                    # forged marker can neither desync the media count nor
                    # leak into the prompt
                    text_parts.append(
                        part.get("text", "").replace(_IMAGE_MARKER, ""))
                elif ptype == "image_url":
                    uri = (part.get("image_url") or {}).get("url", "")
                    if not uri.startswith("data:"):
                        raise ValueError(
                            "image_url must be a data: URI (no egress)")
                    payload = uri.partition(",")[2].encode()
                    media.append({"media_hash": media_hash(payload),
                                  "data_uri": uri})
                    text_parts.append(_IMAGE_MARKER)
                else:
                    raise ValueError(f"unsupported content part {ptype!r}")
            flat.append({**m, "content": "".join(text_parts)})
        return flat, media

    def preprocess_chat(self, body: Dict[str, Any]) -> PreprocessedRequest:
        messages, media = self._flatten_content(body.get("messages", []))
        tools = body.get("tools")
        if tools and "tools" not in (self.mdc.chat_template or ""):
            # no native tools template: inject the hermes-style preamble
            # (parsers.py); tools-aware templates receive `tools` directly
            # in render_chat instead
            from .parsers import render_tools_preamble

            messages = [{"role": "system",
                         "content": render_tools_preamble(tools)}
                        ] + messages
        prompt = self.render_chat(messages, tools=tools)
        req = self._build(prompt, body, media=media)
        # structural outputs (ref preprocessor.rs structural_tag / the
        # engines' guided_json):
        #  * response_format json_schema / json_object -> engine-side
        #    constrained sampling (guided/json_prefix.py)
        #  * tool_choice "required" or a named function -> the output IS
        #    a tool-call envelope, guided by the tool's own parameter
        #    schema; the HTTP layer wraps it as tool_calls
        rf = body.get("response_format") or {}
        if rf.get("type") == "json_schema":
            req.sampling.guided_json = (
                rf.get("json_schema", {}).get("schema")
                or rf.get("schema") or {})
        elif rf.get("type") == "json_object":
            # any JSON OBJECT (arbitrary keys) — not any JSON value
            req.sampling.guided_json = {"type": "object"}
        choice = body.get("tool_choice")
        forced = None
        if tools and choice == "required":
            forced = [t.get("function", t) for t in tools]
        elif isinstance(choice, dict) and tools:
            name = (choice.get("function") or {}).get("name")
            forced = [t.get("function", t) for t in tools
                      if t.get("function", t).get("name") == name]
            if not forced:
                raise ValueError(f"tool_choice names unknown tool {name!r}")
        if forced:
            req.sampling.guided_json = {
                "type": "object",
                "properties": {
                    "name": {"enum": [f.get("name", "") for f in forced]},
                    "arguments": (forced[0].get("parameters") or {}
                                  if len(forced) == 1 else {}),
                },
            }
            req.annotations = list(req.annotations) + ["forced_tool_call"]
        return req

    def preprocess_completion(self, body: Dict[str, Any]) -> PreprocessedRequest:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = "".join(prompt)
        return self._build(prompt, body)

    def _build(self, prompt: str, body: Dict[str, Any],
               media: Optional[List[Dict[str, Any]]] = None,
               ) -> PreprocessedRequest:
        multimodal = None
        if media:
            # tokenize per text segment; each descriptor records the token
            # index where the EncoderHop splices its placeholder tokens
            segments = prompt.split(_IMAGE_MARKER)
            if len(segments) != len(media) + 1:
                raise ValueError("image markers and media items diverged")
            token_ids: List[int] = []
            multimodal = []
            for seg, item in zip(segments[:-1], media):
                token_ids.extend(self.tokenizer.encode(seg) if seg else [])
                multimodal.append({**item, "insert_pos": len(token_ids)})
            if segments[-1]:
                token_ids.extend(self.tokenizer.encode(segments[-1]))
        else:
            token_ids = self.tokenizer.encode(prompt)
        max_ctx = self.mdc.context_length
        if len(token_ids) >= max_ctx:
            raise ValueError(
                f"prompt is {len(token_ids)} tokens, exceeding the model's "
                f"context length of {max_ctx}"
            )
        max_tokens = body.get("max_tokens") or body.get(
            "max_completion_tokens"
        ) or DEFAULT_MAX_TOKENS
        max_tokens = max(1, min(int(max_tokens), max_ctx - len(token_ids)))
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        return PreprocessedRequest(
            token_ids=token_ids,
            model=body.get("model", self.mdc.name),
            request_id=body.get("request_id") or f"req-{secrets.token_hex(8)}",
            sampling=SamplingOptions(
                temperature=float(body.get("temperature", 1.0)),
                top_p=float(body.get("top_p", 1.0)),
                top_k=int(body.get("top_k", 0)),
                seed=body.get("seed"),
                frequency_penalty=float(body.get("frequency_penalty", 0.0)),
                presence_penalty=float(body.get("presence_penalty", 0.0)),
            ),
            stop=StopConditions(
                max_tokens=max_tokens,
                stop=stop,
                ignore_eos=bool(body.get("ignore_eos", False)),
            ),
            lora_name=body.get("lora_name"),
            annotations=body.get("nvext", {}).get("annotations", []),
            multimodal=multimodal,
        )
