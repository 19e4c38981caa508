"""Tokenizer artifacts + incremental detokenization.

A copy of dynamo_tpu/frontend/tokenizer.py: the worker's guided decoding
(engine/core.py) validates candidate text with the model's tokenizer
built from its MDC (`tokenizer_from_mdc`), and the byte mock must be
byte-equal to the JAX frontend's, which decodes the same ids.  `tokenizers`
is imported lazily, only for an "hf" card.  Here:

  * HFTokenizer    — wraps a local `tokenizer.json` (no network fetch).
  * MockTokenizer  — offline-friendly: UTF-8 bytes shifted past the special
    ids for encoding (deterministic, so prefix caching works), and a readable
    word per id on decode for ids outside the byte range (what the mocker's
    pseudo-random generations produce).
  * IncrementalDetokenizer — streams text deltas token-by-token, handling
    multi-token UTF-8 sequences without emitting replacement chars.
"""

from __future__ import annotations

import codecs
from typing import Dict, List, Optional

_WORDS = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo lima "
    "mike november oscar papa quebec romeo sierra tango uniform victor whiskey "
    "xray yankee zulu".split()
)


class Tokenizer:
    pad_id = 0
    bos_id = 1
    eos_id = 2

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: List[int]) -> str:
        raise NotImplementedError

    def make_detokenizer(self) -> "IncrementalDetokenizer":
        return IncrementalDetokenizer(self)


class MockTokenizer(Tokenizer):
    """Byte-shift tokenizer with readable decode for out-of-range ids."""

    BYTE_BASE = 3  # ids 3..258 are bytes 0..255

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [self.BYTE_BASE + b for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        buf = bytearray()
        for i in ids:
            if self.BYTE_BASE <= i < self.BYTE_BASE + 256:
                buf.append(i - self.BYTE_BASE)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf.clear()
                if i == self.eos_id:
                    continue
                out.append(" " + _WORDS[i % len(_WORDS)])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


class HFTokenizer(Tokenizer):
    """HF `tokenizers` tokenizer from a local tokenizer.json (or a model
    directory containing one) or an inline json blob."""

    def __init__(self, path: Optional[str] = None, json_blob: Optional[str] = None,
                 eos_id: Optional[int] = None):
        import os

        from tokenizers import Tokenizer as _HFTok

        if path:
            if os.path.isdir(path):
                path = os.path.join(path, "tokenizer.json")
            self._tok = _HFTok.from_file(path)
        elif json_blob:
            self._tok = _HFTok.from_str(json_blob)
        else:
            raise ValueError("HFTokenizer needs path or json_blob")
        self.vocab_size = self._tok.get_vocab_size()
        if eos_id is not None:
            self.eos_id = eos_id

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


class IncrementalDetokenizer:
    """Turns a token stream into a text-delta stream.

    For byte-level tokenizers an incremental UTF-8 decoder suffices; for HF
    tokenizers we re-decode a sliding window and diff (the standard
    prefix-diff approach), which is O(window) per token.
    """

    def __init__(self, tokenizer: Tokenizer, window: int = 16):
        self.tokenizer = tokenizer
        self.window = window
        self._ids: List[int] = []
        # the sliding decode window [prefix_offset:] — prefix decode cost is
        # O(window) per token, not O(total) (vLLM-style incremental detok)
        self._prefix_offset = 0
        self._read_offset = 0
        self._utf8 = (
            codecs.getincrementaldecoder("utf-8")(errors="replace")
            if isinstance(tokenizer, MockTokenizer)
            else None
        )

    def push(self, token_ids: List[int]) -> str:
        """Feed tokens, get the new text delta."""
        if self._utf8 is not None:
            tk = self.tokenizer
            out: List[str] = []
            for i in token_ids:
                if MockTokenizer.BYTE_BASE <= i < MockTokenizer.BYTE_BASE + 256:
                    out.append(self._utf8.decode(
                        bytes([i - MockTokenizer.BYTE_BASE])
                    ))
                elif i == tk.eos_id:
                    continue
                else:
                    out.append(self._utf8.decode(b"", final=False))
                    out.append(" " + _WORDS[i % len(_WORDS)])
            return "".join(out)
        # HF path: decode the window before and after the new tokens, diff
        self._ids.extend(token_ids)
        prefix_text = self.tokenizer.decode(
            self._ids[self._prefix_offset : self._read_offset]
        )
        full_text = self.tokenizer.decode(self._ids[self._prefix_offset :])
        if full_text.endswith("�"):
            return ""  # mid multi-byte sequence; wait for more tokens
        delta = full_text[len(prefix_text):]
        # slide: the old frontier becomes the new prefix anchor, so each push
        # decodes at most the last two pushes' tokens
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return delta


def tokenizer_from_mdc(tok_cfg: Dict) -> Tokenizer:
    kind = tok_cfg.get("type", "byte")
    if kind in ("byte", "mock"):
        return MockTokenizer(vocab_size=tok_cfg.get("vocab_size", 32000))
    if kind == "hf":
        return HFTokenizer(
            path=tok_cfg.get("path"),
            json_blob=tok_cfg.get("json"),
            eos_id=tok_cfg.get("eos_id"),
        )
    raise ValueError(f"unknown tokenizer type {kind!r}")
