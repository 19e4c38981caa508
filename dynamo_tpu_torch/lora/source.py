"""LoRA adapter sources: discovery and loading of HF-PEFT checkpoints.

The counterpart of dynamo_tpu/lora/source.py.  A local directory tree
is the source:

    <root>/<adapter_name>/adapter_config.json
    <root>/<adapter_name>/adapter_model.safetensors

is the standard PEFT layout.  Loading maps the q/k/v/o projection
weights into the stacked-bank layout (lora/bank.py): `A [L, d_in, r]`,
`B [L, r, d_out]` with the scaling (alpha/r) folded into B, as float32
numpy arrays equal to the JAX source's.  The file is read with the
port's own safetensors reader (models/loader.py: the standard library
and torch.frombuffer), not `safetensors.numpy`: numpy has no bfloat16
without `ml_dtypes`, which a GPU host need not have.  Each tensor is
upcast to float32 in torch (exact) before numpy sees it.
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_PEFT_KEY = re.compile(
    r"\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.lora_(A|B)\.weight$")


@dataclass
class LoraAdapter:
    name: str
    rank: int
    scaling: float
    base_model: Optional[str] = None
    # bank-layout tensors: A_q [L, d_model, r], B_q [L, r, q_dim], ...
    tensors: Dict[str, np.ndarray] = field(default_factory=dict)

    def padded_to(self, bank_rank: int) -> "LoraAdapter":
        if self.rank == bank_rank:
            return self
        if self.rank > bank_rank:
            raise ValueError(
                f"adapter {self.name!r} rank {self.rank} exceeds the "
                f"engine's lora_rank {bank_rank}")
        out: Dict[str, np.ndarray] = {}
        pad = bank_rank - self.rank
        for k, v in self.tensors.items():
            if k.startswith("A_"):
                out[k] = np.pad(v, ((0, 0), (0, 0), (0, pad)))
            else:
                out[k] = np.pad(v, ((0, 0), (0, pad), (0, 0)))
        return LoraAdapter(self.name, bank_rank, self.scaling,
                           self.base_model, out)


class LocalLoraSource:
    """Adapter registry over a directory tree."""

    def __init__(self, root: str):
        self.root = root

    def list(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, d,
                                           "adapter_config.json")))

    def config(self, name: str) -> Dict:
        with open(os.path.join(self.root, name,
                               "adapter_config.json")) as f:
            return json.load(f)

    def load(self, name: str, n_layers: int) -> LoraAdapter:
        cfg = self.config(name)
        rank = int(cfg.get("r", cfg.get("rank", 8)))
        alpha = float(cfg.get("lora_alpha", rank))
        scaling = alpha / rank
        path = os.path.join(self.root, name, "adapter_model.safetensors")
        # imported here: models/llama.py imports this package's bank
        from ..models.loader import iter_safetensors_file

        stats = {"tensors": 0, "bytes": 0, "copies": 0}
        # per-target per-layer staging; missing layers/targets stay zero
        staged: Dict[str, Dict[int, np.ndarray]] = {}
        for key, t in iter_safetensors_file(path, stats):
            m = _PEFT_KEY.search(key)
            if m is None:
                continue
            li, tgt, ab = int(m.group(1)), m.group(2), m.group(3)
            # a copy in float32, detached from the file's map
            staged.setdefault(f"{ab}_{tgt}", {})[li] = \
                t.float().numpy().copy()
        tensors: Dict[str, np.ndarray] = {}
        for skey, by_layer in staged.items():
            ab = skey[0]
            sample = next(iter(by_layer.values()))
            if ab == "A":
                # PEFT lora_A.weight: [r, d_in] -> bank A [d_in, r]
                d_in = sample.shape[1]
                arr = np.zeros((n_layers, d_in, rank), np.float32)
                for li, w in by_layer.items():
                    arr[li] = w.T
            else:
                # PEFT lora_B.weight: [d_out, r] -> bank B [r, d_out],
                # scaling folded here so the runtime math is just A@B
                d_out = sample.shape[0]
                arr = np.zeros((n_layers, rank, d_out), np.float32)
                for li, w in by_layer.items():
                    arr[li] = (w * scaling).T
            tensors[skey] = arr
        if not tensors:
            raise ValueError(
                f"adapter {name!r} has no recognized q/k/v/o lora weights")
        return LoraAdapter(name=name, rank=rank, scaling=scaling,
                           base_model=cfg.get("base_model_name_or_path"),
                           tensors=tensors)
