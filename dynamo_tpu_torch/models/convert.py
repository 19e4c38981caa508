"""Carry weights and cache state across from the JAX package.

The only place the two packages' layouts meet.  Everything crosses as
numpy arrays: numpy has no bfloat16 without `ml_dtypes`, which the port
does not import, so a caller upcasts bf16 JAX arrays to float32 first
(exact) and the port rounds them back to its dtype (exact again).

  * parameters: the JAX parameter tree (nested dicts and lists, weights
    [in, out]) maps one to one onto the port's tree; norms stay fp32, the
    rest takes the model config's dtype.  A MoE layer's router
    `moe_gate` [d, E] and expert stacks `moe_w_*` [E, in, out] are no
    norms, so they take the model's dtype, as the JAX init makes them.
    The DeepSeek tree (models/deepseek.py) crosses the same way, its
    latent norms fp32 and its V3 router bias `moe_gate_bias` fp32 too:
    the bias decides the expert choice, and bf16 would change it.
  * KV cache: the JAX cache is [L, nkv, num_blocks, head_dim, block_size]
    (blocks transposed for TPU lanes); the port's is
    [L, nkv, num_blocks, block_size, head_dim] (ops/paged_attention.py).
    Each member crosses on its own, so the MLA pair (a latent cache of
    width R and a rope-key cache of width dr, one head) crosses alike.
    An int8 cache's codes cross as int8, transposed like the data, and
    its fp32 scale planes [L, nkv, num_blocks, block_size] unchanged:
    both packages lay them out alike.
  * LoRA bank: the JAX bank's stacked A/B arrays map one to one onto the
    port's (lora/bank.py), in the model's dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .deepseek import DeepseekConfig
from .llama import LlamaConfig

_FLOATS = (np.float16, np.float32, np.float64)
# what a KV cache may hold: floats, or an int8 cache's codes
_KV_TYPES = _FLOATS + (np.int8,)
# parameter keys kept fp32 besides the norms (the V3 router's choice bias)
_FP32_KEYS = ("moe_gate_bias",)


def _tensor(a, dtype: torch.dtype, dev: torch.device, path: str,
            kinds=_FLOATS) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in kinds:
        raise TypeError(
            f"{path}: numpy dtype {a.dtype} cannot cross without ml_dtypes; "
            "upcast the JAX array to float32 first")
    # np.array copies: a JAX-backed array is read-only
    return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)


def params_from_numpy(tree: Any, cfg: Union[LlamaConfig, DeepseekConfig],
                      device: DeviceLike = "cuda") -> Any:
    """The JAX package's parameter tree, as numpy float arrays, turned into
    the port's parameters on `device`: tensors named under a "norm" key
    and `moe_gate_bias` are fp32 (as the JAX init makes them), the rest
    cfg.dtype."""
    dev = resolve_device(device)

    def conv(node, path: str, in_norm: bool):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}",
                            in_norm or "norm" in k or k in _FP32_KEYS)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}[{i}]", in_norm)
                    for i, v in enumerate(node)]
        return _tensor(node, torch.float32 if in_norm else cfg.dtype, dev,
                       path)

    return conv(tree, "", False)


def kv_cache_from_numpy(k: np.ndarray, v: np.ndarray,
                        device: DeviceLike = "cuda",
                        dtype: Optional[torch.dtype] = None,
                        k_scale: Optional[np.ndarray] = None,
                        v_scale: Optional[np.ndarray] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """JAX cache arrays [L, nkv, nb, hd, bs] -> the port's (k, v)
    [L, nkv, nb, bs, hd], contiguous, in `dtype` (default: the arrays').
    With an int8 cache's scale planes [L, nkv, nb, bs] the result is the
    4-tuple (k, v, k_scale, v_scale), the planes fp32 and unchanged."""
    dev = resolve_device(device)
    out = []
    for name, a in (("k", k), ("v", v)):
        a = np.swapaxes(np.asarray(a), -1, -2)
        t = _tensor(a, dtype or torch.from_numpy(np.empty(0, a.dtype)).dtype,
                    dev, name, _KV_TYPES)
        out.append(t.contiguous())
    if k_scale is not None or v_scale is not None:
        out += [_tensor(a, torch.float32, dev, name)
                for name, a in (("k_scale", k_scale), ("v_scale", v_scale))]
    return tuple(out)


def kv_cache_to_numpy(kv_cache: Tuple[torch.Tensor, ...]
                      ) -> Tuple[np.ndarray, ...]:
    """The port's cache -> numpy arrays in the JAX layout: float data as
    float32 [L, nkv, nb, hd, bs], int8 codes as int8 in the same layout,
    and an int8 cache's scale planes [L, nkv, nb, bs] unchanged."""
    out = []
    for i, t in enumerate(kv_cache):
        a = t.detach().cpu()
        a = (a.float() if a.is_floating_point() else a).numpy()
        out.append(np.ascontiguousarray(a if i >= 2 else a.swapaxes(-1, -2)))
    return tuple(out)


def bank_from_numpy(bank: Dict[str, Any], dtype: torch.dtype,
                    device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """A JAX LoRA bank (lora/bank.py: {"A_q": [L, N, d_in, r], "B_q":
    [L, N, r, d_out], ...}), as numpy float arrays, turned into the
    port's bank on `device` in `dtype` (the model's).  Both banks share
    the layout, so nothing is transposed."""
    dev = resolve_device(device)
    return {k: _tensor(v, dtype, dev, k).contiguous()
            for k, v in bank.items()}
