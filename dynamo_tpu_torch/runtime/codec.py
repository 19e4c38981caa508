"""Wire codec for the request plane and the event plane.

A copy of dynamo_tpu/runtime/codec.py: length-prefixed msgpack frames.
One TCP connection multiplexes many concurrent request/response streams,
keyed by request id.

Frame types (field "t"):
  client→server:  req   {t, id, path, payload, ctx}
                  cancel{t, id, kill}
  server→client:  data  {t, id, data}          (one per stream item)
                  err   {t, id, error}         (terminal)
                  end   {t, id}                (terminal)

The port does not depend on the `msgpack` package (the GPU machine need
not have it): `packb` / `unpackb` below encode and decode exactly the
subset of msgpack the wire uses, byte for byte as
`msgpack.packb(obj, use_bin_type=True)` / `msgpack.unpackb(b, raw=False)`
do, so a JAX frontend and a torch worker read each other's frames.

  nil, bool; int from -2**63 to 2**64 - 1 in the smallest encoding;
  float as float64; str as fixstr/str8/16/32 (UTF-8); bytes, bytearray
  and memoryview as bin8/16/32; list and tuple as arrays; dict as maps.

Anything else raises TypeError (numpy integer and float32 scalars
included, as msgpack raises for them); an int outside that range raises
OverflowError, as msgpack does.  Subclasses pack as their base type
(bool before int), as msgpack's default does: a numpy float64 is a
float, an IntEnum an int.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Dict, List, Tuple

_LEN = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        if n <= 0x7F:
            out.append(n)
        elif n <= 0xFF:
            out += b"\xcc" + _U8.pack(n)
        elif n <= 0xFFFF:
            out += b"\xcd" + _U16.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xce" + _U32.pack(n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _U64.pack(n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(n & 0xFF)
    elif n >= -0x80:
        out += b"\xd0" + _I8.pack(n)
    elif n >= -0x8000:
        out += b"\xd1" + _I16.pack(n)
    elif n >= -0x80000000:
        out += b"\xd2" + _I32.pack(n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + _I64.pack(n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int,
              codes: Tuple[int, int, int]) -> None:
    """A length header: `fix | n` up to fix_max (fix 0 = no fix form),
    else the 8-, 16- or 32-bit form (codes[0] 0 = no 8-bit form)."""
    if fix and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out += bytes((codes[1],)) + _U16.pack(n)
    elif n <= 0xFFFFFFFF:
        out += bytes((codes[2],)) + _U32.pack(n)
    else:
        raise ValueError(f"msgpack length {n} is too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + _F64.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), out, 0, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (0, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj` (as msgpack.packb(obj, use_bin_type=True))."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, s: struct.Struct) -> Any:
        return s.unpack(self.take(s.size))[0]


# fixed-width codes -> (struct, kind); kind "n" is a number read as is,
# "s"/"b" a str/bin length, "a"/"m" an array/map length
_CODES: Dict[int, Tuple[struct.Struct, str]] = {
    0xCC: (_U8, "n"), 0xCD: (_U16, "n"), 0xCE: (_U32, "n"), 0xCF: (_U64, "n"),
    0xD0: (_I8, "n"), 0xD1: (_I16, "n"), 0xD2: (_I32, "n"), 0xD3: (_I64, "n"),
    0xCA: (_F32, "n"), 0xCB: (_F64, "n"),
    0xD9: (_U8, "s"), 0xDA: (_U16, "s"), 0xDB: (_U32, "s"),
    0xC4: (_U8, "b"), 0xC5: (_U16, "b"), 0xC6: (_U32, "b"),
    0xDC: (_U16, "a"), 0xDD: (_U32, "a"),
    0xDE: (_U16, "m"), 0xDF: (_U32, "m"),
}


def _unpack(r: _Reader) -> Any:
    code = r.take(1)[0]
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0xA0 <= code <= 0xBF:
        return str(r.take(code & 0x1F), "utf-8")
    if 0x90 <= code <= 0x9F:
        return _array(r, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _map(r, code & 0x0F)
    if code == 0xC0:
        return None
    if code in (0xC2, 0xC3):
        return code == 0xC3
    ent = _CODES.get(code)
    if ent is None:
        raise ValueError(f"unsupported msgpack type code 0x{code:02x} "
                         "(ext types are not on this wire)")
    s, kind = ent
    v = r.unpack(s)
    if kind == "n":
        return v
    if kind == "s":
        return str(r.take(v), "utf-8")
    if kind == "b":
        return bytes(r.take(v))
    return _array(r, v) if kind == "a" else _map(r, v)


def _array(r: _Reader, n: int) -> List[Any]:
    return [_unpack(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> Dict[Any, Any]:
    out: Dict[Any, Any] = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    """The value of one msgpack object (as msgpack.unpackb(data,
    raw=False)); trailing bytes raise ValueError."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return obj


def encode_frame(obj: Dict[str, Any]) -> bytes:
    body = packb(obj)
    return _LEN.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> Dict[str, Any]:
    hdr = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return unpackb(body)


async def write_frame(writer: asyncio.StreamWriter, obj: Dict[str, Any]) -> None:
    writer.write(encode_frame(obj))
    await writer.drain()
