"""Vision encoders: the ViT tower as a torch module and a mock, with an
embedding cache keyed by media hash.

A copy of dynamo_tpu/multimodal/encoder.py.  The JAX tower is a
functional jnp ViT (patchify -> transformer blocks -> projection to the
LLM's embedding width) and consults no Pallas kernel, so the port's is
plain torch with the same arithmetic: the patchify order
`(B, g, p, g, p, 3) -> transpose(0, 1, 3, 2, 4, 5)`, an RMS norm computed
in fp32 and cast back to the input's dtype, attention in fp32 and a
ReLU MLP of width 4 x d_model.  Weights are random from a
torch.Generator on the module's device (models/convert.py
vit_from_numpy carries a JAX tower's weights across).  `.npy` payloads
decode without PIL; other images need it.
"""

from __future__ import annotations

import base64
import hashlib
import io
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def media_hash(data: bytes) -> str:
    """Stable content hash for a media item: the cache / routing /
    KV-salt key (the frontend's hop routes by it)."""
    return hashlib.sha256(data).hexdigest()[:32]


def decode_data_uri(uri: str) -> Tuple[bytes, str]:
    """data: URI -> (payload bytes, mime type)."""
    if not uri.startswith("data:"):
        raise ValueError("only data: URIs are supported (no egress)")
    head, _, b64 = uri.partition(",")
    mime = head[5:].split(";")[0] or "application/octet-stream"
    return base64.b64decode(b64), mime


def pixels_from_payload(data: bytes, mime: str,
                        image_size: int) -> np.ndarray:
    """Media payload -> [H, W, 3] float32 in [0, 1], resized to the
    encoder's square input.  `.npy` payloads pass through (tests, raw
    tensors); images decode via PIL when available."""
    if mime == "application/x-npy" or data[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(data))
        arr = np.asarray(arr, np.float32)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ValueError(
                f"cannot decode {mime!r} media without PIL; send an .npy "
                "payload instead") from e
        img = Image.open(io.BytesIO(data)).convert("RGB")
        img = img.resize((image_size, image_size))
        arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[:2] != (image_size, image_size):
        # nearest-neighbor resize without PIL (npy path)
        ys = (np.arange(image_size) * arr.shape[0] // image_size)
        xs = (np.arange(image_size) * arr.shape[1] // image_size)
        arr = arr[ys][:, xs]
    return np.ascontiguousarray(arr[..., :3], np.float32)


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 64
    patch_size: int = 16
    d_model: int = 128       # vision tower width
    n_layers: int = 2
    n_heads: int = 4
    out_dim: int = 512       # LLM embedding width (projection target)
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


def _weight(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


class _VitBlock(torch.nn.Module):
    """One pre-norm block's weights, named as the JAX tree's layer dict."""

    def __init__(self, cfg: VisionConfig, dense, ones):
        super().__init__()
        d = cfg.d_model
        self.norm1 = ones(d)
        self.norm2 = ones(d)
        self.wqkv = dense((d, 3 * d))
        self.wo = dense((d, d))
        self.w1 = dense((d, 4 * d))
        self.w2 = dense((4 * d, d))


class VitEncoder(torch.nn.Module):
    """The ViT tower: encode([B, H, W, 3]) -> [B, n_patches, out_dim].
    Weights [in, out] as the JAX tree's (`x @ w`), norms fp32, the rest
    cfg.dtype, drawn from `generator` (default: one seeded with 0 on
    `device`) with JAX's scale 1/sqrt(fan_in)."""

    def __init__(self, cfg: VisionConfig, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        gen = generator
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)

        def dense(shape):
            w = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) / math.sqrt(shape[0])
            return _weight(w.to(cfg.dtype))

        def ones(n):
            return _weight(torch.ones(n, dtype=torch.float32, device=dev))

        self.patch_embed = dense((cfg.patch_dim, cfg.d_model))
        self.pos_embed = dense((cfg.n_patches, cfg.d_model))
        self.out_proj = dense((cfg.d_model, cfg.out_dim))
        self.final_norm = ones(cfg.d_model)
        self.layers = torch.nn.ModuleList(
            _VitBlock(cfg, dense, ones) for _ in range(cfg.n_layers))

    @property
    def n_tokens(self) -> int:
        return self.cfg.n_patches

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * (1.0 / torch.sqrt(var + self.cfg.rms_eps)) * w).to(
            x.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B = pixels.shape[0]
        p = cfg.patch_size
        g = cfg.image_size // p
        n, d = cfg.n_patches, cfg.d_model
        # [B, H, W, 3] -> [B, n_patches, patch_dim], row-major patches
        x = pixels.reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, n, cfg.patch_dim).to(cfg.dtype)
        x = x @ self.patch_embed + self.pos_embed
        nh = cfg.n_heads
        hd = d // nh
        for layer in self.layers:
            h = self._norm(x, layer.norm1)
            qkv = (h @ layer.wqkv).reshape(B, n, 3, nh, hd)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            s = torch.einsum("bihd,bjhd->bhij", q.float(),
                             k.float()) / math.sqrt(hd)
            pattn = torch.exp(s - s.amax(-1, keepdim=True))
            pattn = pattn / pattn.sum(-1, keepdim=True)
            o = torch.einsum("bhij,bjhd->bihd", pattn,
                             v.float()).to(cfg.dtype)
            x = x + o.reshape(B, n, d) @ layer.wo
            h = self._norm(x, layer.norm2)
            x = x + torch.clamp_min(h @ layer.w1, 0.0) @ layer.w2
        x = self._norm(x, self.final_norm)
        return (x @ self.out_proj).to(cfg.dtype)

    @torch.no_grad()
    def encode(self, pixels: np.ndarray) -> torch.Tensor:
        """[B, H, W, 3] numpy -> [B, n_patches, out_dim] on the CPU in
        cfg.dtype (JAX's returns numpy in its dtype; numpy has no
        bfloat16)."""
        out = self(torch.from_numpy(np.ascontiguousarray(pixels, np.float32))
                   .to(self.device))
        return out.cpu()


class MockVisionEncoder:
    """Deterministic embeddings from the media bytes: the CPU test
    double (same contract as VitEncoder.encode on decoded payloads, but
    keyed on raw bytes so no pixel decoding is needed)."""

    def __init__(self, n_tokens: int = 4, out_dim: int = 16):
        self._n_tokens = n_tokens
        self.out_dim = out_dim

    @property
    def n_tokens(self) -> int:
        return self._n_tokens

    def encode_bytes(self, data: bytes) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(data).digest()[:8], "big")
        rng = np.random.default_rng(seed)
        return rng.standard_normal(
            (self._n_tokens, self.out_dim)).astype(np.float32)


class EmbeddingCache:
    """LRU embeddings by media hash: re-encoding the same image for every
    turn of a session is the main encoder cost."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._d: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[np.ndarray]:
        emb = self._d.get(key)
        if emb is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return emb

    def put(self, key: str, emb: np.ndarray) -> None:
        self._d[key] = emb
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
