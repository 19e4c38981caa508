"""Tensor and data parallelism of the port against the JAX package's
(CPU, fp32, no spawned process):

* parallel/mesh.py: param_sharding_rules names the axis JAX's
  PartitionSpec splits, for every name; shard_params over JAX's
  init_params puts back the whole tree exactly; the kv-head and head
  slabs, and their refusals; make_mesh's device count error and the
  backend the devices choose; graphs.check_capture's refusal on gloo.
* The per-rank decode and packed-prefill attention (ops/paged_attention.py
  paged_attention_decode_tp, ops/packed_prefill.py
  packed_prefill_attention_tp), concatenated over the ranks of a dp=2,
  tp=4 mesh, equal JAX's kernels under its tp shard_map
  (`_decode_pallas_tp`, `_packed_pallas_tp`, interpret mode on the
  virtual 8-device mesh) within 1e-5, on float and int8 caches.
* The tp forward (models/llama.py) with its ranks as threads, each with a
  gloo group over one in-process store: decode, decode_multi,
  prefill_packed, prefill and prefill_batched at tp = 2 and 4 equal
  tp = 1 (logits within 1e-5, each rank's cache slab equal to tp = 1's).
* Weights by shard: init_params(shard=), params_from_numpy(rank, tp),
  and the loader from a checkpoint and from the weight cache each give
  the shard shard_params cuts.
* The step stream (parallel/multihost.py) over a queue: ordered, the
  codec round-trips every dtype, a gap is fatal on the follower, stop
  ends it.
* EngineConfig: tp and dp build, and what a mesh serves (the disagg
  roles, KVBM, the MoE and MLA families, speculation, LoRA, the fused
  epilogue) builds there (one parametrised test); sp builds and sp=0 is
  refused; the CLI's --tp/--dp.

The spawned-rank engines are tests/test_torch_tp_engine.py's.
"""

import dataclasses
import datetime
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dynamo_tpu.models.llama import PRESETS as JAX_PRESETS
from dynamo_tpu.models.llama import init_params as jax_init_params
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.graphs import check_capture
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import (
    kv_cache_from_numpy,
    params_from_numpy,
)
from dynamo_tpu_torch.ops.packed_prefill import packed_prefill_attention_tp
from dynamo_tpu_torch.ops.paged_attention import paged_attention_decode_tp
from dynamo_tpu_torch.parallel import mesh
from dynamo_tpu_torch.parallel.mesh import (
    MeshConfig,
    TensorGroup,
    shard_config,
    shard_params,
)
from dynamo_tpu_torch.parallel.multihost import (
    GroupTransport,
    StepBroadcaster,
    StepFollower,
    StepGapError,
    decode_step,
    encode_step,
)

# the tiny preset's widths (nh 8 over nkv 4, so tp = 4 divides), fp32,
# cut to 2 layers and a 4096-token vocabulary for the CPU
TINY = dict(name="tiny-tp", vocab_size=4096, d_model=128, n_layers=2,
            n_heads=8, n_kv_heads=4, head_dim=16, ffn_dim=256)
JAX_CFG = dataclasses.replace(JAX_PRESETS["tiny"], dtype=jnp.float32,
                              **TINY)
CFG = llama.LlamaConfig(dtype=torch.float32, **TINY)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_params(seed=0):
    return _np_tree(jax_init_params(JAX_CFG, jax.random.PRNGKey(seed)))


def _leaves(tree, name=None):
    """(innermost key, leaf) of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, name)
    else:
        yield name, tree


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


def test_sharding_rules_split_the_axis_jax_splits():
    want = {name: (list(spec).index("tp") if "tp" in spec else None)
            for name, spec in jmesh.param_sharding_rules().items()}
    assert mesh.param_sharding_rules() == want


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_puts_back_the_whole_jax_tree(tp):
    full = _jax_params()
    shards = [shard_params(full, r, tp) for r in range(tp)]
    rules = mesh.param_sharding_rules()
    cut = 0
    for i, (name, leaf) in enumerate(_leaves(full)):
        parts = [list(_leaves(s))[i][1] for s in shards]
        axis = rules.get(name)
        if axis is None:
            for p in parts:
                np.testing.assert_array_equal(p, leaf)
            continue
        cut += 1
        assert all(p.shape[axis] * tp == leaf.shape[axis] for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts, axis=axis), leaf)
    # embedding, lm_head and 7 projections a layer
    assert cut == 2 + 7 * TINY["n_layers"]


def test_slabs_and_their_refusals():
    assert mesh.head_slabs(32, 8, 1, 2) == (slice(16, 32), slice(4, 8))
    assert mesh.kv_cache_spec(3, 4, 8) == slice(6, 8)
    assert mesh.kv_scale_spec(3, 4, 8) == slice(6, 8)
    with pytest.raises(ValueError, match="n_kv_heads of 2 does not divide"):
        mesh.head_slabs(8, 2, 0, 4)
    with pytest.raises(ValueError, match="n_heads of 6 does not divide"):
        mesh.head_slabs(6, 4, 0, 4)
    local = shard_config(CFG, 4)
    assert (local.n_heads, local.n_kv_heads, local.ffn_dim,
            local.vocab_size) == (2, 1, 64, 4096)
    assert shard_config(CFG, 1) is CFG
    with pytest.raises(ValueError, match="ffn_dim"):
        shard_config(dataclasses.replace(CFG, ffn_dim=250), 4)


def test_mesh_device_count_backend_and_coords():
    cfg = MeshConfig(dp=2, tp=2)
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 2"):
        mesh.mesh_devices(cfg, ["cpu", "cpu"])
    # the CLI's default on a machine without CUDA devices
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 0"):
        mesh.mesh_devices(cfg, mesh.default_devices(cfg,
                                                    torch.device("cuda")))
    assert mesh.default_devices(cfg, torch.device("cpu")) == ["cpu"] * 4
    # JAX's reshape(dp, tp, sp) order, and its device-count error text
    assert [mesh.rank_coords(cfg, r) for r in range(4)] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert mesh.tensor_group_ranks(cfg, 1) == [2, 3]
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=8))
    with pytest.raises(ValueError) as terr:
        mesh.mesh_devices(MeshConfig(dp=2, tp=8), ["cpu"] * 8)
    assert str(terr.value) == str(jerr.value)
    dev = torch.device
    assert mesh.group_backend([dev("cuda:0"), dev("cuda:1")]) == "nccl"
    assert mesh.group_backend([dev("cuda:0"), dev("cuda:0")]) == "gloo"
    assert mesh.group_backend([dev("cpu"), dev("cpu")]) == "gloo"
    with pytest.raises(ValueError, match="cuda_graphs=False"):
        check_capture("gloo", dev("cuda:0"), True)
    check_capture("gloo", dev("cuda:0"), False)
    check_capture("nccl", dev("cuda:0"), True)
    check_capture("gloo", dev("cpu"), True)
    check_capture(None, dev("cuda:0"), True)


# ---------------------------------------------------------------------------
# per-rank attention against JAX's tp kernels (dp=2, tp=4)
# ---------------------------------------------------------------------------

NKV, GROUP, HD, BS, L = 4, 2, 16, 4, 2


def _caches(rng, num_blocks, int8):
    """JAX-layout caches [L, nkv, nb, hd, bs] (int8 codes with fp32
    scale planes [L, nkv, nb, bs] when int8), as numpy."""
    shape = (L, NKV, num_blocks, HD, BS)
    if not int8:
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32), None, None)
    codes = [rng.integers(-127, 128, shape).astype(np.int8) for _ in "kv"]
    scales = [rng.uniform(0.005, 0.02, (L, NKV, num_blocks, BS))
              .astype(np.float32) for _ in "kv"]
    return codes[0], codes[1], scales[0], scales[1]


def _jax_tp(fn, kc, vc, ks, vs):
    """Run fn(kc, vc, ks, vs) under jit on the dp=2, tp=4 virtual mesh
    with the caches (and scale planes) kv-head sharded, as the engine
    places them."""
    jm = jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=4))
    cspec = NamedSharding(jm, P(None, "tp", None, None, None))
    sspec = NamedSharding(jm, P(None, "tp", None, None))
    with jm:
        args = [jax.device_put(jnp.asarray(kc), cspec),
                jax.device_put(jnp.asarray(vc), cspec)]
        if ks is not None:
            args += [jax.device_put(jnp.asarray(ks), sspec),
                     jax.device_put(jnp.asarray(vs), sspec)]
        else:
            args += [None, None]
        return np.asarray(jax.jit(lambda *a: fn(jm, *a))(*args))


def _port_caches(kc, vc, ks, vs):
    t = kv_cache_from_numpy(kc, vc, device="cpu", k_scale=ks, v_scale=vs)
    return (t + (None, None))[:4]


def _per_rank(run, cfg=MeshConfig(dp=2, tp=4)):
    """Each dp replica's tensor ranks' outputs concatenated over heads."""
    out = []
    for d in range(cfg.dp):
        parts = [run(mesh.rank_coords(cfg, r)[1])
                 for r in mesh.tensor_group_ranks(cfg, d)]
        out.append(torch.cat(parts, dim=-2).numpy())
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_decode_attention_per_rank_equals_jax_tp_kernel(int8):
    from dynamo_tpu.ops.paged_attention import paged_attention_decode

    rng = np.random.default_rng(11)
    B, mb = 3, 5
    nb = 1 + B * mb
    kc, vc, ks, vs = _caches(rng, nb, int8)
    q = rng.standard_normal((B, NKV * GROUP, HD)).astype(np.float32)
    tables = np.zeros((B, mb), np.int32)
    perm = rng.permutation(nb - 1) + 1
    for b in range(B):
        tables[b] = perm[b * mb:(b + 1) * mb]
    lens = np.array([1, 9, mb * BS], np.int32)
    want = _jax_tp(lambda jm, kc_, vc_, ks_, vs_: paged_attention_decode(
        jnp.asarray(q), kc_, vc_, 1, jnp.asarray(tables), jnp.asarray(lens),
        impl="pallas_interpret", mesh=jm, k_scale=ks_, v_scale=vs_),
        kc, vc, ks, vs)
    tk, tv, tks, tvs = _port_caches(kc, vc, ks, vs)
    got = _per_rank(lambda r: paged_attention_decode_tp(
        torch.from_numpy(q), tk, tv, 1, torch.from_numpy(tables),
        torch.from_numpy(lens), rank=r, tp=4, k_scale=tks, v_scale=tvs))
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_packed_attention_per_rank_equals_jax_tp_kernel(int8):
    from dynamo_tpu.ops.packed_prefill import packed_prefill_attention

    rng = np.random.default_rng(6)
    lens, ctx0, mb, bucket = [7, 9], [3, 0], 8, 24
    S = len(lens)
    nb = 1 + S * mb
    kc, vc, ks, vs = _caches(rng, nb, int8)
    T = sum(lens)
    seg = np.concatenate([np.full(n, i, np.int32) for i, n in
                          enumerate(lens)] + [np.zeros(bucket - T, np.int32)])
    pos = np.concatenate([c + np.arange(n, dtype=np.int32) for c, n in
                          zip(ctx0, lens)] + [np.zeros(bucket - T, np.int32)])
    valid = np.arange(bucket) < T
    tables = (rng.permutation(nb - 1) + 1)[:S * mb].reshape(S, mb)
    tables = tables.astype(np.int32)
    q = rng.standard_normal((bucket, NKV * GROUP, HD)).astype(np.float32)
    want = _jax_tp(lambda jm, kc_, vc_, ks_, vs_: packed_prefill_attention(
        jnp.asarray(q), kc_, vc_, 0, jnp.asarray(tables), jnp.asarray(seg),
        jnp.asarray(pos), jnp.asarray(valid), impl="pallas_interpret",
        mesh=jm, k_scale=ks_, v_scale=vs_), kc, vc, ks, vs)
    tk, tv, tks, tvs = _port_caches(kc, vc, ks, vs)
    got = _per_rank(lambda r: packed_prefill_attention_tp(
        torch.from_numpy(q), tk, tv, 0, torch.from_numpy(tables),
        torch.from_numpy(seg), torch.from_numpy(pos),
        torch.from_numpy(valid), rank=r, tp=4, k_scale=tks, v_scale=tvs))
    for g in got:
        np.testing.assert_allclose(g[valid], want[valid], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the tp forward, ranks as threads
# ---------------------------------------------------------------------------


def run_ranks(tp: int, body, timeout_s: float = 60.0) -> list:
    """body(rank, TensorGroup) on tp threads, each with a gloo group over
    one in-process store; returns the ranks' results in order."""
    store = dist.HashStore()
    out, errs = [None] * tp, []

    def run(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("tp", store), r, tp,
                                       datetime.timedelta(seconds=timeout_s))
            out[r] = body(r, TensorGroup("gloo", pg, r, tp))
        except BaseException as e:  # re-raised on the test's thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errs:
        raise errs[0]
    return out


def _cache(cfg, nb, bs, int8):
    kind = torch.int8 if int8 else torch.float32
    kv = [torch.zeros(s, dtype=kind) for s in
          llama.kv_cache_shapes(cfg, nb, bs)]
    if int8:
        kv += [torch.zeros(s) for s in
               llama.kv_cache_scale_shapes(cfg, nb, bs)]
    return tuple(kv)


def _slab(kv, r, tp):
    sl = mesh.kv_cache_spec(r, tp, kv[0].shape[1])
    return tuple(t[:, sl].clone() for t in kv)


def _forward(name, params, cfg, kv):
    """One call of forward `name` on a fixed workload (cfg: the rank's
    config); returns its output (logits or burst tokens)."""
    g = torch.Generator().manual_seed(5)
    nb, bs, mb = kv[0].shape[2], kv[0].shape[3], 6
    tables = torch.arange(1, 1 + 3 * mb, dtype=torch.int32).reshape(3, mb)
    if name == "prefill_packed":
        lens, T = [5, 7], 16
        seg = torch.tensor([0] * 5 + [1] * 7 + [0] * 4, dtype=torch.int32)
        pos = torch.tensor(list(range(5)) + list(range(7)) + [0] * 4,
                           dtype=torch.int32)
        valid = torch.arange(T) < sum(lens)
        toks = torch.randint(0, cfg.vocab_size, (T,), generator=g,
                             dtype=torch.int32)
        last = torch.tensor([4, 11], dtype=torch.int32)
        return llama.prefill_packed(params, cfg, kv, toks, pos, seg,
                                    tables[:2], last, valid)[0]
    if name == "prefill":
        toks = torch.randint(0, cfg.vocab_size, (8,), generator=g,
                             dtype=torch.int32)
        return llama.prefill(params, cfg, kv, toks, torch.arange(8) + 3,
                             tables[0], 3, 6)[0]
    if name == "prefill_batched":
        toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g,
                             dtype=torch.int32)
        pos = torch.arange(8).repeat(2, 1)
        return llama.prefill_batched(params, cfg, kv, toks, pos, tables[:2],
                                     [0, 0], [8, 5])[0]
    toks = torch.randint(0, cfg.vocab_size, (3,), generator=g,
                         dtype=torch.int32)
    ctx = torch.tensor([0, 4, 9], dtype=torch.int32)
    if name == "decode":
        return llama.decode(params, cfg, kv, toks, ctx, tables, ctx)[0]
    return llama.decode_multi(params, cfg, kv, toks, ctx, tables, ctx, 3)[0]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name", ["decode", "decode_multi", "prefill_packed",
                                  "prefill", "prefill_batched"])
def test_tp_forward_equals_tp1(name, int8, tp):
    full = _jax_params()
    whole = params_from_numpy(full, CFG, "cpu")
    kv1 = _cache(CFG, 24, 4, int8)
    want = _forward(name, whole, CFG, kv1)
    local = shard_config(CFG, tp)

    def body(r, group):
        params = params_from_numpy(full, CFG, "cpu", rank=r, tp=tp)
        params["tp"] = group
        kv = _cache(local, 24, 4, int8)
        return _forward(name, params, local, kv), kv

    outs = run_ranks(tp, body)
    for r, (got, kv) in enumerate(outs):
        if name == "decode_multi":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
        for a, b in zip(kv, _slab(kv1, r, tp)):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# weights by shard
# ---------------------------------------------------------------------------


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _assert_trees_equal(got, want):
    g, w = _paths(got), _paths(want)
    assert sorted(g) == sorted(w)
    for path, b in w.items():
        a = g[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("tp", [2, 4])
def test_random_and_converted_weights_by_shard(tp):
    whole = llama.init_params(CFG, torch.Generator().manual_seed(3),
                              torch.device("cpu"))
    full = _jax_params()
    conv = params_from_numpy(full, CFG, "cpu")
    for r in range(tp):
        _assert_trees_equal(
            llama.init_params(CFG, torch.Generator().manual_seed(3),
                              torch.device("cpu"), shard=(r, tp)),
            shard_params(whole, r, tp))
        _assert_trees_equal(params_from_numpy(full, CFG, "cpu", rank=r,
                                              tp=tp),
                            shard_params(conv, r, tp))


@pytest.mark.parametrize("variant", ["llama", "llama-tied", "qwen3"])
def test_checkpoint_and_cache_load_by_shard(variant, tmp_path, monkeypatch):
    from dynamo_tpu_torch.models.loader import load_params
    from test_torch_loader import write_checkpoint

    monkeypatch.delenv("DYN_WEIGHT_CACHE", raising=False)
    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", str(tmp_path / "wcache"))
    path = write_checkpoint(tmp_path / "ck", variant)
    whole = load_params(path, device="cpu", host_cache=False)
    for r in range(2):
        _assert_trees_equal(load_params(path, device="cpu", host_cache=False,
                                        shard=(r, 2)),
                            shard_params(whole, r, 2))
    load_params(path, device="cpu")  # a tp = 1 load fills the cache
    for r in range(2):
        _assert_trees_equal(load_params(path, device="cpu", shard=(r, 2)),
                            shard_params(whole, r, 2))


def _blank_checkpoint_data(path) -> None:
    """Zero every tensor byte of the checkpoint's safetensors files in
    place, keeping each file's size and mtime, so the weight cache's
    fingerprint still matches: a load that reads the checkpoint now gets
    zeros, one that reads the cache the original weights."""
    import os
    import struct

    for f in sorted(os.listdir(path)):
        if not f.endswith(".safetensors"):
            continue
        p = os.path.join(path, f)
        st = os.stat(p)
        with open(p, "r+b") as fh:
            start = 8 + struct.unpack("<Q", fh.read(8))[0]
            fh.seek(start)
            fh.write(bytes(st.st_size - start))
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns))


@pytest.mark.parametrize("variant", ["llama", "mixtral"])
def test_a_sharded_load_fills_the_weight_cache_once(variant, tmp_path,
                                                    monkeypatch):
    """The mesh leader's sharded load (fill_cache=True) writes the whole
    tree once, as a tp = 1 load does; every rank's later load then reads
    the cache, not the checkpoint.  A sharded load left to the default
    writes nothing."""
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.models.weight_cache import read_cache
    from test_torch_loader import write_checkpoint

    cache = str(tmp_path / "wcache")
    monkeypatch.delenv("DYN_WEIGHT_CACHE", raising=False)
    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", cache)
    path = write_checkpoint(tmp_path / "ck", variant)
    whole = load_params(path, device="cpu", host_cache=False)
    _assert_trees_equal(load_params(path, device="cpu", shard=(1, 2)),
                        shard_params(whole, 1, 2))
    assert read_cache(cache, path, device="cpu") is None
    _assert_trees_equal(load_params(path, device="cpu", shard=(0, 2),
                                    fill_cache=True),
                        shard_params(whole, 0, 2))
    _assert_trees_equal(read_cache(cache, path, device="cpu"), whole)
    _blank_checkpoint_data(path)
    assert not torch.equal(
        load_params(path, device="cpu", host_cache=False)["embedding"],
        whole["embedding"])
    for r in range(2):
        for fill in (None, True):
            _assert_trees_equal(load_params(path, device="cpu",
                                            shard=(r, 2), fill_cache=fill),
                                shard_params(whole, r, 2))


def test_a_tp_worker_restart_reads_the_weight_cache(tmp_path, monkeypatch):
    """A tp = 2 engine on a checkpoint, its two ranks as two launchers in
    this process (parallel/multihost.py; rank 1's engine built on the
    joined mesh, as a follower launcher's worker builds it): the first
    start fills the weight cache from the leader's load, so after the
    checkpoint's bytes are blanked (its fingerprint kept) a second start
    still holds the original weights on both ranks."""
    import asyncio
    import socket

    from dynamo_tpu_torch.engine.core import TorchEngine
    from dynamo_tpu_torch.models.loader import load_params
    from dynamo_tpu_torch.parallel.multihost import (
        MultihostContext,
        join_ranks,
        replay,
    )
    from test_torch_loader import write_checkpoint

    monkeypatch.delenv("DYN_WEIGHT_CACHE", raising=False)
    monkeypatch.setenv("DYN_WEIGHT_CACHE_DIR", str(tmp_path / "wcache"))
    path = write_checkpoint(tmp_path / "ck", "llama")
    whole = load_params(path, device="cpu", host_cache=False)
    cfg = EngineConfig(model_path=path, tp=2, block_size=4, num_blocks=16,
                       max_blocks_per_seq=8, max_num_seqs=2)

    def start():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{sk.getsockname()[1]}"
        out = {}

        def follower():
            ranks = join_ranks(cfg, ["cpu"], None, False, 60.0,
                               MultihostContext(1, 2, coord))
            out[1] = TorchEngine(cfg, device="cpu", cuda_graphs=False,
                                 mesh=ranks.mesh)
            replay(out[1], ranks.mesh)

        t = threading.Thread(target=follower, daemon=True)
        t.start()
        out[0] = TorchEngine(cfg, device="cpu", cuda_graphs=False,
                             mesh_timeout_s=60.0,
                             mh=MultihostContext(0, 2, coord))
        asyncio.run(out[0].close())  # publishes stop: rank 1 returns
        t.join(60.0)
        assert not t.is_alive(), "rank 1 did not replay the stop"
        return [{k: v for k, v in out[r].params.items() if k != "tp"}
                for r in (0, 1)]

    for first in (True, False):
        got = start()
        for r in (0, 1):
            _assert_trees_equal(got[r], shard_params(whole, r, 2))
        if first:
            _blank_checkpoint_data(path)


# ---------------------------------------------------------------------------
# the step stream
# ---------------------------------------------------------------------------


def test_step_stream_ordered_and_gap_fatal():
    q: "queue.Queue[bytes]" = queue.Queue()
    bc = StepBroadcaster(q.put)
    fo = StepFollower(lambda: q.get(timeout=5))
    steps = fo.steps()
    arrays = {"x": np.arange(4, dtype=np.int32),
              "f": np.full((2, 2), 0.5, np.float32),
              "b": np.array([True, False]), "k": np.int32(8)}
    assert bc.publish_step("decode_multi", arrays) == 0
    bc.publish_step("decode_cont", {"k": np.int32(4)})
    kind, got = next(steps)
    assert kind == "decode_multi" and set(got) == set(arrays)
    for k, a in arrays.items():
        assert got[k].dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(got[k], a)
    assert next(steps)[0] == "decode_cont"
    # a lost frame: the follower must stop, not skip
    bc._seq += 1
    bc.publish_step("prefill_packed", {})
    with pytest.raises(StepGapError, match="expected step 2, got 3"):
        next(steps)
    # stop ends a follower
    fo2 = StepFollower(lambda: q.get(timeout=5))
    q.put(encode_step(0, "decode", {}))
    q.put(encode_step(1, "stop", {}))
    assert [k for k, _ in fo2.steps()] == ["decode"]
    assert decode_step(encode_step(7, "prefill", {}))[:2] == (7, "prefill")


def test_follower_waits_out_an_idle_leader():
    """Over a gloo group whose timeout is 1 s, a follower still takes a
    step the leader sends after 2 s of idling (an engine idles as long as
    no request comes)."""
    store = dist.HashStore()
    got = []

    def rank(r):
        pg = dist.ProcessGroupGloo(dist.PrefixStore("s", store), r, 2,
                                   datetime.timedelta(seconds=1))
        transport = GroupTransport(pg)
        if r == 0:
            time.sleep(2.0)
            bc = StepBroadcaster(transport.send)
            bc.publish_step("decode", {"x": np.arange(3)})
            bc.publish_step("stop")
        else:
            got.extend(StepFollower(transport.recv).steps())

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 1 and got[0][0] == "decode"
    np.testing.assert_array_equal(got[0][1]["x"], np.arange(3))


# ---------------------------------------------------------------------------
# config and CLI
# ---------------------------------------------------------------------------


def test_config_builds_tp_and_dp():
    assert EngineConfig(tp=2).tp == 2
    c = EngineConfig(dp=2, tp=2)
    assert (c.dp, c.tp) == (2, 2)
    # sequence parallelism builds, alone and beside tp
    assert EngineConfig(sp=2).sp == 2
    c = EngineConfig(tp=2, sp=2)
    assert (c.tp, c.sp) == (2, 2)
    for f in ("dp", "tp", "sp"):
        with pytest.raises(ValueError, match="dp, tp and sp must be >= 1"):
            EngineConfig(**{f: 0})


@pytest.mark.parametrize("kw,holds", [
    (dict(role="prefill"), lambda c, m: c.role == "prefill"),
    (dict(role="decode"), lambda c, m: c.role == "decode"),
    (dict(host_cache_blocks=8), lambda c, m: c.host_cache_blocks == 8),
    (dict(model="tiny-moe"), lambda c, m: m.n_experts == 4),
    (dict(model="tiny-mla"), lambda c, m: m.kv_lora_rank == 64),
    (dict(spec_decode="ngram"), lambda c, m: c.spec_decode == "ngram"),
    (dict(spec_decode="draft", spec_draft_model="tiny"),
     lambda c, m: c.spec_decode == "draft"),
    (dict(lora_max_adapters=2), lambda c, m: c.lora_max_adapters == 2),
    (dict(sampling_epilogue="fused"),
     lambda c, m: c.sampling_epilogue == "fused"),
], ids=["prefill", "decode", "kvbm", "moe", "mla", "spec-ngram",
        "spec-draft", "lora", "fused"])
@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(dp=2)],
                         ids=["tp2", "dp2"])
def test_mesh_features_build_and_shard(kw, holds, mesh_kw):
    """What a mesh refused before it served them (disagg roles, KVBM, the
    MoE and MLA families, speculation, LoRA, the fused epilogue): the
    config builds on the mesh, keeps the feature, and its rank's shard
    config divides what tp splits."""
    cfg = EngineConfig(**mesh_kw, **kw)
    model = cfg.resolve_model()
    assert holds(cfg, model) and (cfg.dp, cfg.tp) == (
        mesh_kw.get("dp", 1), mesh_kw.get("tp", 1))
    local = shard_config(model, cfg.tp)
    assert local.n_heads * cfg.tp == model.n_heads
    assert getattr(local, "n_experts", 0) * cfg.tp == \
        getattr(model, "n_experts", 0)


def test_cli_tp_dp_parse_into_the_config():
    from dynamo_tpu.engine.__main__ import build_args as jax_args
    from dynamo_tpu_torch.engine.__main__ import build_args, engine_config

    argv = ["--tp", "2", "--dp", "2"]
    cfg = engine_config(build_args().parse_args(argv))
    j = jax_args().parse_args(argv)
    assert (cfg.tp, cfg.dp) == (j.tp, j.dp) == (2, 2)
    d, jd = build_args().parse_args([]), jax_args().parse_args([])
    assert (d.tp, d.dp) == (jd.tp, jd.dp) == (1, 1)
    helps = {a.dest: a.help for a in build_args()._actions}
    jhelps = {a.dest: a.help for a in jax_args()._actions}
    assert (helps["tp"], helps["dp"]) == (jhelps["tp"], jhelps["dp"])
