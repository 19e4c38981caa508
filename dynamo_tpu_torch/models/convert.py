"""Carry weights and cache state across from the JAX package.

The only place the two packages' layouts meet.  Everything crosses as
numpy arrays: numpy has no bfloat16 without `ml_dtypes`, which the port
does not import, so a caller upcasts bf16 JAX arrays to float32 first
(exact) and the port rounds them back to its dtype (exact again).

  * parameters: the JAX parameter tree (nested dicts and lists, weights
    [in, out]) maps one to one onto the port's tree; norms stay fp32, the
    rest takes the model config's dtype.
  * KV cache: the JAX cache is [L, nkv, num_blocks, head_dim, block_size]
    (blocks transposed for TPU lanes); the port's is
    [L, nkv, num_blocks, block_size, head_dim] (ops/paged_attention.py).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .llama import LlamaConfig

_FLOATS = (np.float16, np.float32, np.float64)


def _tensor(a, dtype: torch.dtype, dev: torch.device,
            path: str) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _FLOATS:
        raise TypeError(
            f"{path}: numpy dtype {a.dtype} cannot cross without ml_dtypes; "
            "upcast the JAX array to float32 first")
    # np.array copies: a JAX-backed array is read-only
    return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)


def params_from_numpy(tree: Any, cfg: LlamaConfig,
                      device: DeviceLike = "cuda") -> Any:
    """The JAX package's parameter tree, as numpy float arrays, turned into
    the port's parameters on `device`: tensors named under a "norm" key
    are fp32 (as the JAX init makes them), the rest cfg.dtype."""
    dev = resolve_device(device)

    def conv(node, path: str, in_norm: bool):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}", in_norm or "norm" in k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}[{i}]", in_norm)
                    for i, v in enumerate(node)]
        return _tensor(node, torch.float32 if in_norm else cfg.dtype, dev,
                       path)

    return conv(tree, "", False)


def kv_cache_from_numpy(k: np.ndarray, v: np.ndarray,
                        device: DeviceLike = "cuda",
                        dtype: Optional[torch.dtype] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX cache arrays [L, nkv, nb, hd, bs] -> the port's (k, v)
    [L, nkv, nb, bs, hd], contiguous, in `dtype` (default: the arrays')."""
    dev = resolve_device(device)
    out = []
    for name, a in (("k", k), ("v", v)):
        a = np.swapaxes(np.asarray(a), -1, -2)
        t = _tensor(a, dtype or torch.from_numpy(np.empty(0, a.dtype)).dtype,
                    dev, name)
        out.append(t.contiguous())
    return out[0], out[1]


def kv_cache_to_numpy(kv_cache: Tuple[torch.Tensor, torch.Tensor]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The port's (k, v) cache -> float32 numpy arrays in the JAX layout
    [L, nkv, nb, hd, bs]."""
    return tuple(np.ascontiguousarray(
        t.detach().float().cpu().numpy().swapaxes(-1, -2))
        for t in kv_cache)
