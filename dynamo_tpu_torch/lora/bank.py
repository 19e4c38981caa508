"""Stacked multi-LoRA adapter bank: batched low-rank deltas in PyTorch.

The counterpart of dynamo_tpu/lora/bank.py.  The bank holds N adapter
slots per target projection as ONE stacked tensor pair per target,
`A [L, N, d_in, r]` and `B [L, N, r, d_out]`, so a batch where every
sequence (or every packed token) uses a different adapter runs the same
program with static shapes.  Slot 0 is all zeros (no adapter): base
traffic adds an exact zero.  Ranks are zero-padded to the bank's r and
the PEFT scaling (alpha/r) is folded into B at load time
(lora/source.py).

Two differences from the JAX bank:

  * writes are IN PLACE (`copy_` into the slot's slice): the captured
    CUDA graphs (engine/graphs.py) hold the bank's addresses, so a
    rebound bank would leave every graph reading the old one;
  * a per-row index does not gather the rows' adapters.  JAX's
    `A[idx]` with a [T] per-token index is [T, d_in, r]: 268 MB a
    projection a layer at T = 2048 and llama-8b width in bf16.  Here
    x @ A runs for every slot at once ([N, n, r]), a one-hot mask keeps
    each row's own slot, and the masked [n, N*r] products contract with
    B viewed as [N*r, d_out] in one matmul.  The other slots' terms are
    exact zeros, so the sum is the row's own delta.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# target projections (HF PEFT default attention set)
TARGETS = ("q", "k", "v", "o")


def empty_bank(n_layers: int, n_adapters: int, rank: int, d_model: int,
               q_dim: int, kv_dim: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed bank on `device` in `dtype` (the model's).  n_adapters
    includes slot 0 (the no-adapter slot)."""
    dims = {"q": (d_model, q_dim), "k": (d_model, kv_dim),
            "v": (d_model, kv_dim), "o": (q_dim, d_model)}
    bank: Dict[str, torch.Tensor] = {}
    for t, (d_in, d_out) in dims.items():
        bank[f"A_{t}"] = torch.zeros((n_layers, n_adapters, d_in, rank),
                                     dtype=dtype, device=device)
        bank[f"B_{t}"] = torch.zeros((n_layers, n_adapters, rank, d_out),
                                     dtype=dtype, device=device)
    return bank


def bank_layer(bank: Dict[str, torch.Tensor],
               li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li] for k, v in bank.items()}


def slot_onehot(idx: torch.Tensor, n_slots: int,
                dtype: torch.dtype) -> torch.Tensor:
    """[n, N] one-hot of the per-row slot index `idx` [n], in `dtype`:
    computed once per forward and shared by every layer and target."""
    slots = torch.arange(n_slots, device=idx.device, dtype=idx.dtype)
    return (idx[:, None] == slots[None, :]).to(dtype)


def masked_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 onehot: torch.Tensor) -> torch.Tensor:
    """The low-rank delta of each row of x [n, ..., d_in] under its own
    slot (`onehot` [n, N], slot_onehot); A [N, d_in, r], B [N, r, d_out].
    Returns [n, ..., d_out]."""
    N, d_in, r = A.shape
    lead = x.shape[:-1]
    n = lead[0]
    xf = x.reshape(-1, d_in)                                 # [n*m, d_in]
    u = torch.matmul(xf, A).view(N, n, -1, r)                # [N, n, m, r]
    u = u * onehot.T[:, :, None, None]
    u = u.permute(1, 2, 0, 3).reshape(xf.shape[0], N * r)    # [n*m, N*r]
    return (u @ B.reshape(N * r, -1)).reshape(*lead, B.shape[-1])


def lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Low-rank delta for a batch of (possibly distinct) adapters.

    x [..., d_in]; A [N, d_in, r]; B [N, r, d_out].
    idx: a scalar int (all of x shares one adapter), or [n] matching x's
    leading dim (a slot per decode lane, or per token of a packed
    stream).  Returns [..., d_out]."""
    if idx.ndim == 0:
        return (x @ A[idx]) @ B[idx]
    return masked_delta(x, A, B, slot_onehot(idx, A.shape[0], x.dtype))


def write_adapter(bank: Dict[str, torch.Tensor], slot: int,
                  tensors: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Write one adapter's (already rank-padded, scaling-folded) tensors
    into bank slot `slot`, in place.  `tensors` keys: A_q/B_q/... each
    [L, d_in, r] / [L, r, d_out]; missing targets keep what the slot
    held (adapters may target a subset of the projections: the engine
    clears a slot before it reuses one).  Returns the same bank."""
    for key, arr in tensors.items():
        if key not in bank:
            raise KeyError(f"unknown bank tensor {key!r}")
        dst = bank[key][:, slot]
        src = torch.as_tensor(np.asarray(arr))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"bank tensor {key!r}: adapter shape "
                             f"{tuple(src.shape)} != slot shape "
                             f"{tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype), non_blocking=False)
    return bank


def clear_slot(bank: Dict[str, torch.Tensor],
               slot: int) -> Dict[str, torch.Tensor]:
    """Zero bank slot `slot`, in place.  Returns the same bank."""
    for v in bank.values():
        v[:, slot].zero_()
    return bank
