"""Guided decoding: JSON-schema prefix validation + canonical completion.

Ref role: the reference's guided decoding / structural outputs
(preprocessor.rs structural_tag; engines' guided_json).  TPU-first
design note: full-vocab token masks per step would ship a 128k-bool
mask host->device every token (or compile a token-level grammar DFA on
device) — instead the engine samples a top-M candidate set ON DEVICE
and the host picks the best candidate whose text keeps the output a
valid PREFIX of a schema-conforming JSON document (engine/core.py
guided path).  When no candidate fits, the canonical completion closes
the document deterministically, so output validity is GUARANTEED, with
model-chosen content whenever the model cooperates.

Schema subset (the function-calling arguments shape): object with
properties (all required, canonical declaration order), string, integer,
number, boolean, null, enum of strings/numbers, arrays of a primitive
item type, and nested objects thereof.

The validator is a prefix acceptor: `ok(text)` answers "can `text` be
extended to a conforming document?"; `complete(text)` returns the
canonical suffix that closes it.  Both run a recursive descent that
tolerates truncation at any byte.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Tuple

_WS = " \t\n\r"


class _Trunc(Exception):
    """Input ended mid-production: valid prefix."""

    def __init__(self, completion: str):
        self.completion = completion


class _Bad(Exception):
    """Input cannot be extended to a conforming document."""


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] in _WS:
        i += 1
    return i


def _canonical(schema: Dict[str, Any]) -> str:
    """The canonical minimal document for a schema (used to close
    truncated output)."""
    t = schema.get("type")
    if "enum" in schema:
        return json.dumps(schema["enum"][0])
    if t == "object":
        props = schema.get("properties")
        if props is None:
            return "{}"  # generic object (json_object response format)
        parts = [f"{json.dumps(k)}: {_canonical(v)}"
                 for k, v in props.items()]
        return "{" + ", ".join(parts) + "}"
    if t == "array":
        return "[]"
    if t == "string":
        return '""'
    if t in ("integer", "number"):
        return "0"
    if t == "boolean":
        return "false"
    if t == "null":
        return "null"
    return "null"


class JsonSchemaGuide:
    """Prefix acceptor + canonical completer for one schema."""

    def __init__(self, schema: Dict[str, Any]):
        self.schema = schema or {}

    # -- public API -------------------------------------------------------
    def ok(self, text: str) -> bool:
        """True iff `text` is a prefix of some conforming document
        (trailing whitespace after a complete document is allowed;
        trailing garbage is not)."""
        try:
            end = self._value(self.schema, text, _skip_ws(text, 0))
        except _Trunc:
            return True
        except _Bad:
            return False
        return _skip_ws(text, end) == len(text)

    def done(self, text: str) -> bool:
        """True iff `text` already IS a complete conforming document."""
        try:
            end = self._value(self.schema, text, _skip_ws(text, 0))
        except (_Trunc, _Bad):
            return False
        return _skip_ws(text, end) == len(text)

    def complete(self, text: str) -> str:
        """Canonical suffix closing a valid prefix (empty when done).
        Raises ValueError on an invalid prefix."""
        try:
            end = self._value(self.schema, text, _skip_ws(text, 0))
        except _Trunc as t:
            return t.completion
        except _Bad:
            raise ValueError(f"not a valid prefix: {text!r}")
        if _skip_ws(text, end) != len(text):
            raise ValueError(f"trailing garbage: {text!r}")
        return ""

    # -- recursive descent ------------------------------------------------
    # each _X(schema, s, i) returns the index AFTER the parsed value, or
    # raises _Trunc(canonical completion from the truncation point) /
    # _Bad.

    def _value(self, schema: Dict[str, Any], s: str, i: int) -> int:
        i = _skip_ws(s, i)
        if i >= len(s):
            raise _Trunc(_canonical(schema))
        if "enum" in schema:
            return self._enum(schema, s, i)
        t = schema.get("type")
        if t == "object":
            return self._object(schema, s, i)
        if t == "array":
            return self._array(schema, s, i)
        if t == "string":
            return self._string(s, i)
        if t == "integer":
            return self._number(s, i, integer=True)
        if t == "number":
            return self._number(s, i, integer=False)
        if t == "boolean":
            return self._literal(s, i, ("true", "false"))
        if t == "null":
            return self._literal(s, i, ("null",))
        # untyped: accept any JSON value (fall back to a tolerant parse)
        return self._any(s, i)

    def _literal(self, s: str, i: int, options: Tuple[str, ...]) -> int:
        for lit in options:
            if s.startswith(lit, i):
                return i + len(lit)
            # truncated prefix of the literal?
            rest = s[i:]
            if lit.startswith(rest) and rest:
                raise _Trunc(lit[len(rest):])
        raise _Bad

    def _enum(self, schema: Dict[str, Any], s: str, i: int) -> int:
        lits = [json.dumps(v) for v in schema["enum"]]
        best_trunc: Optional[str] = None
        for lit in lits:
            if s.startswith(lit, i):
                return i + len(lit)
            rest = s[i:]
            if lit.startswith(rest):
                # keep the FIRST enum member as the canonical close
                if best_trunc is None:
                    best_trunc = lit[len(rest):]
        if best_trunc is not None:
            raise _Trunc(best_trunc)
        raise _Bad

    def _string(self, s: str, i: int) -> int:
        if s[i] != '"':
            raise _Bad
        i += 1
        while i < len(s):
            c = s[i]
            if c == '"':
                return i + 1
            if c == "\\":
                if i + 1 >= len(s):
                    raise _Trunc('\\"'[1:] + '"')  # finish escape + close
                nxt = s[i + 1]
                if nxt in '"\\/bfnrt':
                    i += 2
                elif nxt == "u":
                    hexpart = s[i + 2:i + 6]
                    if len(hexpart) < 4:
                        if all(ch in "0123456789abcdefABCDEF"
                               for ch in hexpart):
                            raise _Trunc("0" * (4 - len(hexpart)) + '"')
                        raise _Bad
                    if not all(ch in "0123456789abcdefABCDEF"
                               for ch in hexpart):
                        raise _Bad
                    i += 6
                else:
                    raise _Bad
            elif ord(c) < 0x20:
                raise _Bad  # control chars must be escaped
            else:
                i += 1
        raise _Trunc('"')

    _DIGITS = "0123456789"

    def _number(self, s: str, i: int, integer: bool) -> int:
        j = i
        if j < len(s) and s[j] == "-":
            j += 1
            if j >= len(s):
                raise _Trunc("0")
        if j >= len(s) or s[j] not in self._DIGITS:
            raise _Bad
        while j < len(s) and s[j] in self._DIGITS:
            j += 1
        if j >= len(s):
            return j  # complete number (more digits could follow: still
            #           a valid END here — caller treats EOS as done)
        if not integer and s[j] == ".":
            j += 1
            if j >= len(s):
                raise _Trunc("0")
            if s[j] not in self._DIGITS:
                raise _Bad
            while j < len(s) and s[j] in self._DIGITS:
                j += 1
        if not integer and j < len(s) and s[j] in "eE":
            j += 1
            if j < len(s) and s[j] in "+-":
                j += 1
            if j >= len(s):
                raise _Trunc("0")
            if s[j] not in self._DIGITS:
                raise _Bad
            while j < len(s) and s[j] in self._DIGITS:
                j += 1
        return j

    def _object(self, schema: Dict[str, Any], s: str, i: int) -> int:
        props = schema.get("properties")
        if props is None:
            # {"type": "object"} with no declared properties: any object
            # with arbitrary keys/values (json_object response format)
            if s[i] != "{":
                raise _Bad
            return self._any(s, i)
        keys = list(props)
        if s[i] != "{":
            raise _Bad

        def closer(from_key: int, prefix: str) -> str:
            parts = [f"{json.dumps(k)}: {_canonical(props[k])}"
                     for k in keys[from_key:]]
            return prefix + ", ".join(parts) + "}" if parts \
                else prefix.rstrip(", ") + "}"

        i += 1
        if not keys:
            i = _skip_ws(s, i)
            if i >= len(s):
                raise _Trunc("}")
            if s[i] != "}":
                raise _Bad
            return i + 1
        for n, key in enumerate(keys):
            i = _skip_ws(s, i)
            klit = json.dumps(key)
            if i >= len(s):
                raise _Trunc(closer(n, ""))
            if not s.startswith(klit, i):
                rest = s[i:]
                if klit.startswith(rest):
                    raise _Trunc(klit[len(rest):] + ": "
                                 + _canonical(props[key])
                                 + closer(n + 1, ", "))
                raise _Bad
            i += len(klit)
            i = _skip_ws(s, i)
            if i >= len(s):
                raise _Trunc(": " + _canonical(props[key])
                             + closer(n + 1, ", "))
            if s[i] != ":":
                raise _Bad
            i += 1
            try:
                i = self._value(props[key], s, i)
            except _Trunc as t:
                raise _Trunc(t.completion + closer(n + 1, ", "))
            i = _skip_ws(s, i)
            sep = "," if n + 1 < len(keys) else "}"
            if i >= len(s):
                raise _Trunc(closer(n + 1, ", ") if sep == ","
                             else "}")
            if s[i] != sep:
                raise _Bad
            i += 1
        return i

    def _array(self, schema: Dict[str, Any], s: str, i: int) -> int:
        item = schema.get("items", {})
        if s[i] != "[":
            raise _Bad
        i += 1
        i = _skip_ws(s, i)
        if i >= len(s):
            raise _Trunc("]")
        if s[i] == "]":
            return i + 1
        while True:
            try:
                i = self._value(item, s, i)
            except _Trunc as t:
                raise _Trunc(t.completion + "]")
            i = _skip_ws(s, i)
            if i >= len(s):
                raise _Trunc("]")
            if s[i] == "]":
                return i + 1
            if s[i] != ",":
                raise _Bad
            i += 1
            i = _skip_ws(s, i)
            if i >= len(s):
                raise _Trunc(_canonical(item) + "]")

    def _any(self, s: str, i: int) -> int:
        """Untyped value: structural JSON check without a schema."""
        c = s[i]
        if c == "{":
            # generic object: string keys, any values
            i += 1
            i = _skip_ws(s, i)
            if i >= len(s):
                raise _Trunc("}")
            if s[i] == "}":
                return i + 1
            while True:
                try:
                    i = self._string(s, i)
                except _Trunc:
                    raise _Trunc('": null}')
                i = _skip_ws(s, i)
                if i >= len(s):
                    raise _Trunc(": null}")
                if s[i] != ":":
                    raise _Bad
                try:
                    i = self._any(s, _skip_ws(s, i + 1))
                except _Trunc as t:
                    raise _Trunc(t.completion + "}")
                except IndexError:
                    raise _Trunc("null}")
                i = _skip_ws(s, i)
                if i >= len(s):
                    raise _Trunc("}")
                if s[i] == "}":
                    return i + 1
                if s[i] != ",":
                    raise _Bad
                i = _skip_ws(s, i + 1)
                if i >= len(s):
                    raise _Trunc('"k": null}')
        if c == "[":
            return self._array({"items": {}}, s, i)
        if c == '"':
            return self._string(s, i)
        if c in "-0123456789":
            return self._number(s, i, integer=False)
        return self._literal(s, i, ("true", "false", "null"))
