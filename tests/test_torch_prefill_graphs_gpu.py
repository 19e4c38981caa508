"""Packed-prefill programs on a card (engine/graphs.py PrefillPrograms).

This file imports neither jax nor the JAX package, so it also runs on a
GPU host without them:

    python -m pytest --noconftest -m gpu tests/test_torch_prefill_graphs_gpu.py

The prefill programs keep their own graph pool, and serving replays them
in any order with the decode programs: a replayed bucket between decode
replays must write what the program's eager body writes, bit for bit.
And a capture must survive a cyclic collection falling due inside it: the
collector could destroy an unreachable engine's graphs there, which
invalidates the capture.
"""

import gc

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, graphs


@pytest.mark.gpu
def test_prefill_replay_between_decode_replays_equals_eager_on_gpu():
    """On a card: a bucket's replay, with decode programs replayed before
    and after it (their own graph pool), writes the same first tokens and
    logits as the program's eager body on the same descriptor, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    eng = TorchEngine(EngineConfig(model="tiny", block_size=128,
                                   num_blocks=64, max_blocks_per_seq=8,
                                   max_num_seqs=4), device="cuda")
    eng.warmup_decode()
    g, dec = eng.prefill_graphs, eng.graphs
    a = g.host_descriptor(512)
    rng = np.random.default_rng(1)
    for row, (off, n, blocks) in enumerate(((0, 300, (1, 2, 3)),
                                            (300, 40, (4,)))):
        a["toks"][off:off + n] = rng.integers(0, 32000, n)
        a["positions"][off:off + n] = np.arange(n)
        a["seg_ids"][off:off + n] = row
        a["valid"][off:off + n] = True
        a["tables"][row, :len(blocks)] = blocks
        a["last_idx"][row] = off + n - 1
    a["temps"][1], a["top_ps"][1], a["seeds"][1] = 0.8, 0.9, 5
    g.upload(a)
    eager = g.run_eager(512).clone()
    eager_logits = g.logits[512].clone()
    d = dec.host_descriptor()
    d["tokens"][:2], d["positions"][:2] = (7, 9), (40, 12)
    d["ctx_lens"][:2], d["steps"][:2], d["valid"][:2] = (40, 12), 1, True
    d["tables"][0, :1], d["tables"][1, :1] = 5, 6
    for _ in range(2):
        dec.upload(d)
        dec.run(True, 8)
        g.upload(a)
        replay = g.run(512)
        dec.run(False, 4)
        torch.cuda.synchronize()
        assert torch.equal(replay, eager)
        assert torch.equal(g.logits[512], eager_logits)
    assert g.counts == {T: 1 for T in g.buckets}


class _Cycle:
    pass


@pytest.mark.gpu
def test_capture_defers_collecting_an_unreachable_graph_on_gpu():
    """On a card: a CUDA graph that becomes cyclic garbage inside a
    capture, with the collector's threshold at 1 and allocations that
    start a collection when the collector runs, is not destroyed there:
    the capture succeeds and its replay computes the body.  A first pass
    without a capture shows the same body does start a collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    x = torch.zeros(16, device=dev)
    runs = []

    def make_garbage(graph):
        c = _Cycle()
        c.c, c.graph = c, graph

    def body():
        x.add_(1)
        make_garbage(dead.pop())
        gc.set_threshold(1)
        keep = [_Cycle() for _ in range(200)]
        x.mul_(2)
        return keep

    def dead_graph():
        g = torch.cuda.CUDAGraph()
        y = torch.zeros(4, device=dev)
        with torch.cuda.graph(g):
            y.add_(1)
        return [g]

    def seen(phase, info):
        if phase == "start":
            runs.append(info["generation"])

    thresholds = gc.get_threshold()
    gc.collect()
    gc.callbacks.append(seen)
    try:
        dead = dead_graph()
        body()  # eager: the collector runs inside the body
        gc.set_threshold(*thresholds)
        assert runs, "the body started no collection"
        gc.collect()
        dead = dead_graph()
        torch.cuda.synchronize()
        graph, _, _, _ = graphs._capture(
            dev, torch.cuda.graph_pool_handle(), body, ())
    finally:
        gc.callbacks.remove(seen)
        gc.set_threshold(*thresholds)
    gc.collect()  # the dead graph goes now, outside the capture
    x.fill_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 4))
