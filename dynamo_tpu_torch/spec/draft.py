"""Draft-model proposer: a second model beside the target, on its device.

The counterpart of dynamo_tpu/spec/draft.py.  The draft holds its own
params and its own KV cache, but the cache is ADDRESSED BY THE TARGET'S
BLOCK TABLES: same block_size, same num_blocks, same garbage block 0.
That makes the proposer allocator-free: wherever the engine's allocator
put a sequence's target KV, the draft KV for the same positions lives at
the same block ids in the draft's tensors.  Shared prefix blocks are safe
by the same hash argument as the target cache (one hash = one token run =
one KV content), and a block id recycled to a new sequence is overwritten
by that sequence's catch-up prefill before it is ever read.  The cache
follows the target's kv_cache_dtype (an int8 cache holds its scale
planes too).

Per speculation round for one slot:

  1. catch-up: prefill the draft over tokens[draft_pos:ctx] in B = 1
     chunks bucketed by prefill_buckets, each one dispatch of that
     bucket's catch-up program (engine/graphs.py CatchupPrograms: one
     packed segment, K3 attends, the draft's cache written), captured
     once per bucket by `warmup` (`catchup_dispatches` and `catchup_s`,
     the host seconds, count them).
     draft_pos is engine bookkeeping on the slot; after a partly accepted
     round it equals the new ctx, so the catch-up is empty, and after a
     fully accepted one it is one token short (the last draft's own KV
     was never a decode input).
  2. propose: ONE decode_multi burst runs k greedy draft steps from
     last_token at position ctx, the ids chained on the device: the
     engine's own decode programs (engine/graphs.py DecodePrograms) at
     B = 1, one per k in 1..max_k, each captured once as a CUDA graph by
     `warmup` (eager on the CPU and with capture=False).

Greedy drafts only: the proposal is a point mass, which is what
engine/sampler.py spec_accept_tokens assumes.

Beside a tensor-parallel target the draft is whole on the leader's
device, with its own whole cache addressed by the leader's block
tables: its programs are the leader's alone (spec/__init__.py).
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch

from ..engine.graphs import CatchupPrograms, DecodePrograms
from ..models import llama


class DraftModelProposer:
    name = "draft"

    def __init__(self, model_cfg: llama.LlamaConfig, device: torch.device, *,
                 num_blocks: int, block_size: int, max_blocks_per_seq: int,
                 prefill_buckets, model_path: str = "", max_k: int = 4,
                 seed: int = 0, kv_cache_dtype: str = "bf16", params=None,
                 capture: bool = True):
        """`params`: the draft's parameter tree on `device`; None loads
        the checkpoint at model_path, or makes random weights from `seed`
        (the engine's: a draft with the target's config and seed then has
        the target's weights)."""
        self.cfg = model_cfg
        self.device = device
        self.buckets = tuple(prefill_buckets)
        self.max_k = max_k
        if params is None and model_path:
            from ..models.loader import load_params

            params = load_params(model_path, model_cfg, device=device)
        elif params is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            params = llama.init_params(model_cfg, gen, device)
        self.params = params
        int8 = kv_cache_dtype == "int8"
        kv = [torch.zeros(shape, dtype=torch.int8 if int8 else model_cfg.dtype,
                          device=device)
              for shape in llama.kv_cache_shapes(model_cfg, num_blocks,
                                                 block_size)]
        if int8:
            kv += [torch.zeros(shape, dtype=torch.float32, device=device)
                   for shape in llama.kv_cache_scale_shapes(
                       model_cfg, num_blocks, block_size)]
        self.kv = tuple(kv)
        self.programs = DecodePrograms(self.params, model_cfg, self.kv, 1,
                                       max_blocks_per_seq, device,
                                       capture=capture)
        # the capture watch records them as the JAX proposer's programs
        self.programs.FAMILY_ONE = self.programs.FAMILY_MULTI = \
            "draft_propose"
        self.catchup = CatchupPrograms(self.params, model_cfg, self.kv, 1,
                                       max_blocks_per_seq, self.buckets,
                                       device, capture=capture)
        self.metrics = {"catchup_dispatches": 0, "catchup_s": 0.0}

    def warmup(self) -> None:
        """Build every catch-up program (one per prefill bucket) and every
        propose program (k = 1..max_k): one token in the garbage block 0,
        nothing real computed."""
        for T in self.catchup.buckets:
            a = self.catchup.host_descriptor(T)
            a["valid"][0] = True
            self.catchup.upload(a)
            self.catchup.run(T)
        g = self.programs
        a = g.host_descriptor()
        a["ctx_lens"][:] = a["steps"][:] = 1
        for k in range(1, self.max_k + 1):
            g.upload(a)
            g.run(True, k).wait()

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def propose(self, tokens: Sequence[int], k: int, *, ctx: int,
                draft_pos: int, block_table) -> List[int]:
        """k greedy draft tokens continuing tokens[:ctx+1] (last_token is
        tokens[ctx]).  Catch-up prefill covers [draft_pos, ctx); the
        caller advances draft_pos to the new ctx after verification."""
        pos = draft_pos
        if pos < ctx:
            t0 = time.perf_counter()
            cp = self.catchup
            while pos < ctx:
                chunk = min(ctx - pos, self.buckets[-1])
                a = cp.host_descriptor(self._bucket_for(chunk))
                a["toks"][:chunk] = tokens[pos:pos + chunk]
                a["positions"][:chunk] = np.arange(pos, pos + chunk)
                a["valid"][:chunk] = True
                a["tables"][0] = block_table
                cp.run(cp.upload(a))
                self.metrics["catchup_dispatches"] += 1
                pos += chunk
            self.metrics["catchup_s"] += time.perf_counter() - t0
        k = min(k, self.max_k)
        g = self.programs
        a = g.host_descriptor()
        a["tokens"][0] = tokens[ctx]
        a["positions"][0] = a["ctx_lens"][0] = ctx
        a["tables"][0] = block_table
        a["valid"][0] = True
        g.upload(a)
        burst = g.run(True, k).wait()  # [k, 1]
        return [int(t) for t in burst[:, 0]]
