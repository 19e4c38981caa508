"""KV-block transfer between a prefill and a decode worker.

A copy of dynamo_tpu/disagg/transfer.py, with the same wire protocol
and the same `disagg_open`/`disagg_chunk` spans (obs/) on the pull's ops, so a torch worker pulls from a JAX worker and a
JAX worker pulls from a torch worker.  The decode side owns the pull,
and it is RECEIVER-PACED, tiered by where the two engines live:

  tier 1 — same process: block chunks stay on the device; the receiver
           injects the sender's gathered chunk without a host round trip
           (disagg/broker.py).
  tier 2 — another process on the same card, when both ends opt in:
           each chunk is staged in a sender-owned device buffer and
           copied out by the receiver over CUDA IPC; only the chunk's
           metadata rides the request plane (disagg/device_transfer.py).
  tier 3 — host-staged, correct on any topology: chunks gather to the
           host and ride the request plane as byte frames
           (RequestPlanePullSource below).

The pull speaks the op protocol of the sender's `kv_pull` endpoint:

  {"op": "open",  "request_id"}                  -> header frame
      header = {prompt_len, layout: KvLayout[, cuda_ipc]}
  {"op": "chunk", "request_id", "start", "count"}
      -> one chunk frame: {"block_start", "block_count", "k", "v"
         [, "ks", "vs"], "crc"}
  {"op": "chunk", ..., "via": "cuda_ipc"}          (tier 2)
      -> {"uuid", "block_start", "block_count", "handle", "event",
          "nbytes", "parts"}
  {"op": "close", "request_id"}                  -> {} (release parked KV)

Each chunk is one scheduler op on each engine, so decode bursts
interleave with the sender's gathers and the receiver's injects, and
neither side holds more than one chunk of payload in host memory.

Payloads are logical blocks [layers, n_blocks, block_size, kv_heads,
head_dim] in the universal transfer layout (ops/kv_transfer.py), whatever
either engine's cache layout.  The codec moves raw bytes: numpy has no
bfloat16 without `ml_dtypes`, which the port does not import, so frames
are built from torch tensors' bytes and decoded with `torch.frombuffer`.
The bytes are the JAX package's, crc32 footer included.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs

# wire dtype names (numpy's, as the JAX package writes them) and their
# torch dtypes
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}

# Default chunk bound.  Well under the request plane's 256MB frame cap even
# after msgpack framing, large enough to amortize per-frame overhead.
DEFAULT_CHUNK_BYTES = 16 * 1024 * 1024


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype ("bfloat16", "float32", ...)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"no wire name for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown KV payload dtype {name!r}") from None


@dataclass
class KvLayout:
    """Logical geometry of a KV payload + the sender's parallel layout.

    The logical fields are contract: a mismatch is a model mismatch and the
    pull must fail.  The mesh fields are advisory."""

    num_layers: int
    num_blocks: int
    block_size: int
    kv_heads: int
    head_dim: int
    dtype: str
    tp: int = 1
    dp: int = 1
    # MLA engines cache an asymmetric pair (the latent and the rope
    # key); 0 means "v matches k", the GQA case
    head_dim_v: int = 0
    # int8-quantized payload (quant/kv.py): chunks carry fp32 scale
    # planes [L, n, bs, nkv] alongside k/v, verbatim
    scales: bool = False

    @property
    def hd_v(self) -> int:
        return self.head_dim_v or self.head_dim

    def to_dict(self) -> Dict[str, Any]:
        return {
            "num_layers": self.num_layers, "num_blocks": self.num_blocks,
            "block_size": self.block_size, "kv_heads": self.kv_heads,
            "head_dim": self.head_dim, "dtype": self.dtype,
            "tp": self.tp, "dp": self.dp, "head_dim_v": self.head_dim_v,
            "scales": self.scales,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "KvLayout":
        return cls(**{k: d[k] for k in (
            "num_layers", "num_blocks", "block_size", "kv_heads",
            "head_dim", "dtype")}, tp=d.get("tp", 1), dp=d.get("dp", 1),
            head_dim_v=d.get("head_dim_v", 0),
            scales=bool(d.get("scales", False)))

    @classmethod
    def of(cls, k: torch.Tensor, tp: int = 1, dp: int = 1,
           v: Optional[torch.Tensor] = None,
           scales: bool = False) -> "KvLayout":
        """From a universal-layout K (and optionally V) tensor."""
        L, nb, bs, nkv, hd = k.shape
        hd_v = v.shape[4] if v is not None and v.shape[4] != hd else 0
        return cls(num_layers=L, num_blocks=nb, block_size=bs, kv_heads=nkv,
                   head_dim=hd, dtype=dtype_name(k.dtype), tp=tp, dp=dp,
                   head_dim_v=hd_v, scales=scales)

    def check_compatible(self, other: "KvLayout") -> None:
        """Logical-geometry contract check (tp/dp intentionally excluded).
        `dtype`/`scales` are part of the contract: an int8 payload cannot
        scatter into a bf16 cache (or vice versa) without silent
        corruption."""
        for f in ("num_layers", "block_size", "kv_heads", "head_dim",
                  "dtype", "scales"):
            a, b = getattr(self, f), getattr(other, f)
            if a != b:
                raise ValueError(
                    f"incompatible KV layout: {f} is {a} on the sender but "
                    f"{b} on the receiver"
                )
        if self.hd_v != other.hd_v:
            raise ValueError(
                f"incompatible KV layout: head_dim_v is {self.hd_v} on the "
                f"sender but {other.hd_v} on the receiver"
            )

    # -- chunk sizing -----------------------------------------------------
    def block_bytes(self) -> int:
        """Payload bytes of ONE block across all layers (k + v, plus the
        fp32 scale planes for a quantized payload)."""
        itemsize = torch_dtype(self.dtype).itemsize
        per_tok = self.kv_heads * (self.head_dim + self.hd_v)
        data = self.num_layers * self.block_size * per_tok * itemsize
        if self.scales:
            data += self.num_layers * self.block_size * self.kv_heads * 2 * 4
        return data

    def blocks_per_chunk(self, max_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
        """Whole blocks per chunk under the byte bound (always >= 1: the
        bound is a target; the request plane's frame cap is the hard
        limit)."""
        return max(1, max_bytes // max(1, self.block_bytes()))


def make_header(prompt_len: int, layout: KvLayout,
                ipc: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The `open` op's answer.  `ipc` is the sender's CUDA IPC capability
    (disagg/device_transfer.py), under a key of its own that a JAX
    receiver ignores; without it the header is the JAX package's.  A JAX
    sender may add "transfer_addr", its own tier-2 server, which the
    port's receiver ignores."""
    h: Dict[str, Any] = {"prompt_len": prompt_len,
                         "layout": layout.to_dict()}
    if ipc:
        h["cuda_ipc"] = dict(ipc)
    return h


def _bytes(a) -> bytes:
    """The raw bytes of a tensor (any dtype, any device) or a numpy
    array, in C order."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a).tobytes()
    t = a.detach().contiguous().cpu()
    return t.view(torch.uint8).numpy().tobytes()


def encode_chunk_frame(b0: int, kb, vb, ksb=None, vsb=None
                       ) -> Dict[str, Any]:
    """Host-staged chunk -> wire frame.  kb/vb are universal-layout
    [L, n, bs, nkv, hd] for the block range [b0, b0+n); a quantized
    payload adds the fp32 scale planes ksb/vsb [L, n, bs, nkv]."""
    frame = {
        "block_start": int(b0),
        "block_count": int(kb.shape[1]),
        "k": _bytes(kb),
        "v": _bytes(vb),
    }
    if ksb is not None:
        frame["ks"] = _bytes(ksb)
        frame["vs"] = _bytes(vsb)
    frame["crc"] = _frame_crc(frame)
    return frame


def _frame_crc(frame: Dict[str, Any]) -> int:
    """crc32 over the frame's payload byte members in canonical order,
    seeded with (block_start, block_count) so a frame spliced onto the
    wrong block range fails verification too."""
    crc = zlib.crc32(
        f"{int(frame['block_start'])}:{int(frame['block_count'])}"
        .encode())
    for name in ("k", "v", "ks", "vs"):
        if name in frame:
            crc = zlib.crc32(frame[name], crc)
    return crc & 0xFFFFFFFF


def _tensor(buf: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    if len(buf) != n * dtype.itemsize:
        raise ValueError(f"payload of {len(buf)} bytes does not hold "
                         f"{tuple(shape)} {dtype}")
    # a bytearray copy: torch.frombuffer wants a writable buffer
    return torch.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)


def decode_chunk_frame(
    frame: Dict[str, Any], layout: KvLayout
) -> Tuple[Any, ...]:
    """Wire frame -> (b0, n, kb, vb[, ksb, vsb]), CPU tensors, with
    bounds checked against the header layout (a corrupt frame must not
    write outside the payload).  The scale planes come back only when the
    layout declares them — and a declaring layout REQUIRES them."""
    b0 = int(frame["block_start"])
    n = int(frame["block_count"])
    if not (0 <= b0 and n >= 1 and b0 + n <= layout.num_blocks):
        raise ValueError(f"chunk out of bounds: blocks=[{b0},{b0 + n}) of "
                         f"{layout.num_blocks}")
    if "crc" in frame and _frame_crc(frame) != int(frame["crc"]):
        raise ValueError(
            f"chunk frame for blocks [{b0},{b0 + n}) failed its crc32 "
            "footer")
    dt = torch_dtype(layout.dtype)
    lo = layout
    kb = _tensor(frame["k"], dt, (lo.num_layers, n, lo.block_size,
                                  lo.kv_heads, lo.head_dim))
    vb = _tensor(frame["v"], dt, (lo.num_layers, n, lo.block_size,
                                  lo.kv_heads, lo.hd_v))
    if not lo.scales:
        return b0, n, kb, vb
    if "ks" not in frame or "vs" not in frame:
        raise ValueError("quantized chunk frame is missing scale planes")
    sshape = (lo.num_layers, n, lo.block_size, lo.kv_heads)
    return (b0, n, kb, vb, _tensor(frame["ks"], torch.float32, sshape),
            _tensor(frame["vs"], torch.float32, sshape))


class PullSource:
    """Receiver-side pull source interface (the engine paces it).

    open()  -> header dict ({"prompt_len", "layout", ...})
    chunk(b0, n) -> (kb, vb) — plus (ksb, vsb) scale planes for an int8
        payload — for blocks [b0, b0+n): CPU tensors (tier 3) or tensors
        on the sender's device (tier 1)
    close() -> release the sender's parked KV.  Idempotent; called on
        success AND failure."""

    async def open(self) -> Dict[str, Any]:
        raise NotImplementedError

    async def chunk(self, b0: int, n: int) -> Tuple[Any, ...]:
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError


class RequestPlanePullSource(PullSource):
    """Tier 3: host-staged chunks over the request plane (the universal
    fallback).  One RPC per op; the sender gathers each chunk as its own
    scheduler op, so its decode interleaves with the extraction."""

    def __init__(self, client, params: Dict[str, Any]):
        self.client = client
        self.params = params
        self.layout: Optional[KvLayout] = None

    async def _call(self, body: Dict[str, Any]) -> Dict[str, Any]:
        out = None
        async for item in self.client.generate(
            body, instance_id=self.params["instance_id"]
        ):
            out = item
        if out is None:
            raise RuntimeError("empty kv_pull response")
        return out

    async def open(self) -> Dict[str, Any]:
        with obs.span("disagg_open",
                      request_id=self.params["request_id"]):
            header = await self._call(
                {"op": "open", "request_id": self.params["request_id"]})
        self.layout = KvLayout.from_dict(header["layout"])
        return header

    async def chunk(self, b0: int, n: int):
        with obs.span("disagg_chunk",
                      request_id=self.params["request_id"],
                      start=int(b0), count=int(n)):
            frame = await self._call({
                "op": "chunk", "request_id": self.params["request_id"],
                "start": int(b0), "count": int(n),
            })
        out = decode_chunk_frame(frame, self.layout)
        fb0, fn, arrs = out[0], out[1], out[2:]
        if fb0 != b0 or fn != n:
            raise ValueError(f"sender returned blocks [{fb0},{fb0 + fn}) "
                             f"for a request of [{b0},{b0 + n})")
        return arrs

    async def close(self) -> None:
        try:
            await self._call({"op": "close",
                              "request_id": self.params["request_id"]})
        except Exception:
            pass  # sender-side TTL reaps unreleased parks


def make_transfer_params(
    *,
    instance_id: int,
    request_id: str,
    prompt_len: int,
    first_token: int,
    block_size: int,
    num_layers: int,
    engine: str = "jax",
) -> Dict[str, Any]:
    """kv_transfer_params attached to the prefill response.  `engine`
    names the wire protocol, not the framework: a decode side of either
    package pulls only when it reads "jax"."""
    return {
        "engine": engine,
        "instance_id": instance_id,
        "request_id": request_id,
        "prompt_len": prompt_len,
        "first_token": first_token,
        "block_size": block_size,
        "num_layers": num_layers,
    }
