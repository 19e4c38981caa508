"""Stubs that let chip_smoke.py's phases run on the CPU at a tiny width.

`rehearse(monkeypatch)` swaps the llama-8b preset for a 2-layer d=256
config (vocab 4096, 8 heads over 2, hd 64), shrinks the int8 cache's
memory budget, stubs the torch.cuda calls the phases make around their
timings (synchronize, peak-memory stats, events) and wraps the model's
attention ops so that each CPU call bumps the CUDA wrapper's `launches`
counter, as a kernel launch on the card would.  The phases then run
their checks, gates and planted faults as they do on the card; their
times read the CPU's.
"""

import time

import torch

import chip_smoke
from dynamo_tpu_torch import models
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import cuda_packed_prefill as k3
from dynamo_tpu_torch.ops import cuda_paged_attention as k1

TINY_8B = llama.LlamaConfig(name="llama-8b", vocab_size=4096, d_model=256,
                            n_layers=2, n_heads=8, n_kv_heads=2, head_dim=64,
                            ffn_dim=512)


class _Event:
    def __init__(self, enable_timing: bool = False):
        self.t = 0.0

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _counting(fn, kernels):
    def wrapped(*args, **kw):
        int8 = kw.get("k_scale") is not None
        kernels[int8].launches += 1
        return fn(*args, **kw)

    return wrapped


def rehearse(monkeypatch) -> llama.LlamaConfig:
    """Apply the stubs; returns the tiny config standing for llama-8b."""
    monkeypatch.setitem(llama.PRESETS, "llama-8b", TINY_8B)
    monkeypatch.setitem(models.PRESETS, "llama-8b", TINY_8B)
    monkeypatch.setattr(chip_smoke, "INT8_KV_HBM_GB", 0.05)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(llama, "paged_attention_decode", _counting(
        llama.paged_attention_decode,
        {False: k1.paged_decode, True: k1.paged_decode_int8}))
    monkeypatch.setattr(llama, "packed_prefill_attention", _counting(
        llama.packed_prefill_attention,
        {False: k3.packed_prefill, True: k3.packed_prefill_int8}))
    return TINY_8B
