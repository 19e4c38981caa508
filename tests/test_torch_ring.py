"""Sequence parallelism and the pipeline primitive of the port against the
JAX package's (CPU, no spawned process): ranks run as threads, each with
gloo groups over one in-process store, and JAX runs on the 8 virtual CPU
devices tests/conftest.py sets.

* ops/ring_attention.py `ring_attention`, the rank outputs concatenated
  over the ring, equals JAX's `ring_attention` on an sp mesh and its
  `attention_reference` (sp 2 and 8, causal and full, MHA (4, 4) and GQA
  (8, 2)) within 2e-5; bf16 within JAX's 0.05 with no NaN; on a
  (tp=2, sp=4) mesh, each tp coordinate's ring over its own heads equals
  JAX's head-sharded ring.  Odd query tiles (SCORE_BLOCK_BYTES cut to
  three rows' worth) change nothing.
* models/llama.py `prefill_ring` at sp 2 and 4 equals JAX's
  `prefill_ring` on the same weights (models/convert.py): the first-token
  logits within 1e-5, every block the prompt wrote equal on every rank's
  cache (codes within one step and scales at the tolerance on an int8
  cache) and every other block unchanged, for a dense model, a MoE model
  in dense dispatch and one in capacity dispatch at a capacity factor
  that drops tokens: there the expert capacity and the drop order span
  the whole padded sequence, which a per-rank pool would not reproduce.
  At tp=2 x sp=2 the same holds with each rank's kv-head slab.
* parallel/pipeline.py `pipeline_apply` with S = 4 stages and M = 4, 7,
  2 microbatches equals JAX's `pipeline_apply` (ys, and every stage's
  count state, which bubbles must not touch), and a leaf whose leading
  dimension is not S raises JAX's ValueError text.
"""

import datetime
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from dynamo_tpu.models import llama as jl
from dynamo_tpu.ops.ring_attention import attention_reference as jax_ref
from dynamo_tpu.ops.ring_attention import ring_attention as jax_ring
from dynamo_tpu.parallel import mesh as jmesh
from dynamo_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import (
    kv_cache_from_numpy,
    kv_cache_to_numpy,
    params_from_numpy,
)
from dynamo_tpu_torch.ops import ring_attention as ring_module
from dynamo_tpu_torch.ops.ring_attention import (
    attention_reference,
    ring_attention,
)
from dynamo_tpu_torch.parallel.mesh import (
    RingGroup,
    TensorGroup,
    kv_cache_spec,
    shard_config,
)
from dynamo_tpu_torch.parallel.pipeline import pipeline_apply

TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_ring_attention.py's
FWD = dict(rtol=1e-5, atol=1e-5)     # fp32 forwards, as test_torch_tp


def run_mesh(tp: int, sp: int, body, timeout_s: float = 60.0) -> list:
    """body(tp_rank, sp_rank, TensorGroup | None, RingGroup | None) on
    tp * sp threads (rank t * sp + s), each with the gloo groups of its
    coordinates over one in-process store; returns the ranks' results in
    rank order."""
    store = dist.HashStore()
    n = tp * sp
    out, errs = [None] * n, []
    to = datetime.timedelta(seconds=timeout_s)

    def run(r):
        t, s = divmod(r, sp)
        try:
            tg = rg = None
            if tp > 1:
                tg = TensorGroup("gloo", dist.ProcessGroupGloo(
                    dist.PrefixStore(f"tp{s}", store), t, tp, to), t, tp)
            if sp > 1:
                rg = RingGroup("gloo", dist.ProcessGroupGloo(
                    dist.PrefixStore(f"sp{t}", store), s, sp, to), s, sp)
            out[r] = body(t, s, tg, rg)
        except BaseException as e:  # re-raised on the test's thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout_s)
    assert not any(th.is_alive() for th in threads), "a rank hung"
    if errs:
        raise errs[0]
    return out


def _jax_mesh(tp: int, sp: int):
    if len(jax.devices()) < tp * sp:
        pytest.skip(f"needs {tp * sp} devices")
    return jmesh.make_mesh(jmesh.MeshConfig(dp=1, tp=tp, sp=sp))


def _jax_prefill_ring(jparams, jcfg, start, toks, pos, table, true_len,
                      tp, sp):
    """JAX's prefill_ring, jitted as its engine runs it (an eager
    shard_map compiles every op)."""
    fn = jax.jit(partial(jl.prefill_ring, cfg=jcfg,
                         mesh=_jax_mesh(tp, sp)))
    return fn(jparams, kv_cache=tuple(jnp.asarray(a) for a in start),
              token_ids=jnp.asarray(toks), positions=jnp.asarray(pos),
              block_table=jnp.asarray(table),
              true_len=jnp.int32(true_len))


def _qkv(seed, b, t, hq, hkv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(dtype)
                 for h in (hq, hkv, hkv))


def _ring(q, k, v, tp, sp, causal=True, dtype=torch.float32):
    """The port's ring over a (tp, sp) mesh of threads: rank (t, s) holds
    the heads of t and the rows of s; the outputs put back whole."""
    T = q.shape[1]
    tq = T // sp

    def body(t, s, _tg, ring):
        def cut(a):
            h = a.shape[2] // tp
            return torch.from_numpy(
                a[:, s * tq:(s + 1) * tq, t * h:(t + 1) * h].copy()
            ).to(dtype)
        return ring_attention(cut(q), cut(k), cut(v), ring, causal=causal)

    outs = run_mesh(tp, sp, body)
    rows = [torch.cat([outs[t * sp + s] for t in range(tp)], dim=2)
            for s in range(sp)]
    return torch.cat(rows, dim=1)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sp", [2, 8])
def test_ring_matches_jax_ring_and_reference(sp, causal, hq, hkv,
                                             monkeypatch):
    q, k, v = _qkv(0, 2, 64, hq, hkv, 16)
    # query tiles of three rows: the last tile of a shard is short
    monkeypatch.setattr(ring_module, "SCORE_BLOCK_BYTES",
                        3 * 4 * 2 * hq * (64 // sp))
    jm = Mesh(np.array(jax.devices()[:sp]), axis_names=("sp",))
    want = np.asarray(jax.jit(partial(jax_ring, mesh=jm, causal=causal))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    ref = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), causal=causal))
    got = _ring(q, k, v, 1, sp, causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    # the plain version is JAX's oracle
    plain = attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal).numpy()
    np.testing.assert_allclose(plain, ref, **TOL)


def test_ring_bf16_stable():
    q, k, v = _qkv(1, 1, 32, 4, 4, 16)
    jm = Mesh(np.array(jax.devices()[:8]), axis_names=("sp",))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_ref(jq, jk, jv), np.float32)
    want = np.asarray(jax.jit(partial(jax_ring, mesh=jm))(jq, jk, jv),
                      np.float32)
    bf = [np.asarray(a, np.float32) for a in (jq, jk, jv)]
    out = _ring(*bf, 1, 8, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_ring_splits_heads_over_tp():
    """(tp=2, sp=4): heads over tp, the sequence over sp; each tp
    coordinate's ring runs on its own heads (JAX's head_axis="tp")."""
    q, k, v = _qkv(3, 1, 64, 8, 4, 16)
    jm = _jax_mesh(2, 4)
    want = np.asarray(jax.jit(lambda q, k, v: jax_ring(
        q, k, v, jm, axis_name="sp", head_axis="tp"))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = _ring(q, k, v, 2, 4).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))), **TOL)


# ---------------------------------------------------------------------------
# prefill_ring
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=16, ffn_dim=128)
MODELS = {
    "dense": {},
    "moe-dense": dict(n_experts=4, experts_per_token=2),
    # a capacity factor that drops tokens, so the pool's span shows
    "moe-capacity": dict(n_experts=4, experts_per_token=2,
                         moe_dispatch="capacity", moe_capacity_factor=0.5),
}
BS, NB, MB = 4, 24, 12


def _model(name):
    kw = {**BASE, "name": f"ring-{name}", **MODELS[name]}
    return (jl.LlamaConfig(dtype=jnp.float32, **kw),
            tl.LlamaConfig(dtype=torch.float32, **kw))


def _random_cache(jcfg, int8: bool, seed: int = 4):
    """A JAX-layout cache of random contents (so untouched blocks show),
    as numpy arrays: float, or int8 codes with fp32 scale planes."""
    rng = np.random.default_rng(seed)
    shape = jl.kv_cache_shapes(jcfg, NB, BS)[0]
    if not int8:
        return tuple(rng.standard_normal(shape).astype(np.float32)
                     for _ in "kv")
    sshape = jl.kv_cache_scale_shapes(jcfg, NB, BS)[0]
    return (tuple(rng.integers(-127, 128, shape).astype(np.int8)
                  for _ in "kv")
            + tuple(rng.uniform(0.01, 0.1, sshape).astype(np.float32)
                    for _ in "kv"))


def _ring_inputs(sp: int, true_len: int):
    """The engine's descriptor: T_pad a pow2 multiple of sp x 8 (the
    smallest bucket), a shuffled block table."""
    g = sp * 8
    T = (1 << max(0, (-(-true_len // g) - 1).bit_length())) * g
    rng = np.random.default_rng(6)
    toks = np.zeros(T, np.int32)
    toks[:true_len] = rng.integers(1, 256, true_len)
    table = np.zeros(MB, np.int32)
    nb = -(-true_len // BS)
    table[:nb] = rng.permutation(np.arange(1, NB))[:nb]
    return toks, np.arange(T, dtype=np.int32), table


def _same_cache(got, want, start, int8: bool):
    """got (port cache as numpy, JAX layout) against JAX's: block 0 (the
    garbage block) aside, within the forward's tolerance (int8 codes
    within one step), and equal to `start` wherever JAX's is."""
    for i, (g, w, s) in enumerate(zip(got, want, start)):
        g, w, s = g[:, :, 1:], np.asarray(w)[:, :, 1:], s[:, :, 1:]
        if int8 and i < 2:
            np.testing.assert_allclose(g.astype(np.int32),
                                       w.astype(np.int32), rtol=0, atol=1)
        else:
            np.testing.assert_allclose(g, w, **FWD)
        untouched = (w == s)
        assert untouched.any()
        np.testing.assert_array_equal(g[untouched], s[untouched])


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("sp", [2, 4])
def test_prefill_ring_matches_jax(sp, int8, model):
    jcfg, tcfg = _model(model)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    true_len = 27
    toks, pos, table = _ring_inputs(sp, true_len)
    start = _random_cache(jcfg, int8)
    jlog, jkv = _jax_prefill_ring(jparams, jcfg, start, toks, pos, table,
                                  true_len, 1, sp)

    def body(_t, _s, _tg, ring):
        params = params_from_numpy(tree, tcfg, "cpu")
        kv = kv_cache_from_numpy(*start[:2], device="cpu",
                                 k_scale=start[2] if int8 else None,
                                 v_scale=start[3] if int8 else None)
        logits, kv = tl.prefill_ring(
            params, tcfg, kv, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(table), true_len, ring=ring)
        return logits, kv_cache_to_numpy(kv)

    outs = run_mesh(1, sp, body)
    assert all(lg is None for lg, _ in outs[1:])
    np.testing.assert_allclose(outs[0][0].numpy(), np.asarray(jlog), **FWD)
    for _, kv in outs:  # every rank holds the whole prompt's K/V
        _same_cache(kv, jkv, start, int8)


def test_prefill_ring_tp2_sp2_matches_jax():
    """tp=2 x sp=2: each rank's heads, its kv-head slab of the cache and
    the logits of the s = 0 tensor group equal JAX's on a (tp, sp)
    mesh; the capacity-dispatch MoE's whole-sequence pool included."""
    jcfg, tcfg = _model("moe-capacity")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    true_len = 29
    toks, pos, table = _ring_inputs(2, true_len)
    start = _random_cache(jcfg, False)
    jlog, jkv = _jax_prefill_ring(jparams, jcfg, start, toks, pos, table,
                                  true_len, 2, 2)
    local = shard_config(tcfg, 2)

    def body(t, _s, tg, ring):
        params = params_from_numpy(tree, tcfg, "cpu", rank=t, tp=2)
        params["tp"] = tg
        heads = kv_cache_spec(t, 2, tcfg.n_kv_heads)
        kv = kv_cache_from_numpy(start[0][:, heads], start[1][:, heads],
                                 device="cpu")
        logits, kv = tl.prefill_ring(
            params, local, kv, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(table), true_len, ring=ring)
        return logits, kv_cache_to_numpy(kv), heads

    outs = run_mesh(2, 2, body)
    for r, (logits, kv, heads) in enumerate(outs):
        if r % 2:  # s = 1
            assert logits is None
        else:
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                       **FWD)
        _same_cache(kv, [np.asarray(a)[:, heads] for a in jkv],
                    [a[:, heads] for a in start], False)


# ---------------------------------------------------------------------------
# pipeline_apply
# ---------------------------------------------------------------------------


def _jax_stage(params, state, x, active):
    """tests/test_pipeline.py's stage: a residual two-matmul MLP that
    counts the tokens it processed (writes masked in bubbles)."""
    y = jnp.tanh(x @ params["w1"]) @ params["w2"] + x
    count = state["count"] + jnp.where(active, x.shape[0], 0)
    return y, {"count": count}


def _torch_stage(params, state, x, active):
    y = torch.tanh(x @ params["w1"]) @ params["w2"] + x
    return y, {"count": state["count"] + (x.shape[0] if active else 0)}


@pytest.mark.parametrize("M", [4, 7, 2])  # M == S, M > S, M < S
def test_pipeline_matches_jax(M):
    S, d, hidden, mb = 4, 16, 32, 3
    rng = np.random.default_rng(M)
    w1 = (rng.standard_normal((S, d, hidden)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((S, hidden, d)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, mb, d)).astype(np.float32)
    jm = Mesh(np.array(jax.devices()[:S]), axis_names=("pp",))
    jys, jstate = jax_pipeline(
        _jax_stage, {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
        {"count": jnp.zeros((S,), jnp.int32)}, jnp.asarray(xs), jm)

    def body(_t, _s, _tg, ring):
        return pipeline_apply(
            _torch_stage, {"w1": torch.from_numpy(w1),
                           "w2": torch.from_numpy(w2)},
            {"count": torch.zeros(S, dtype=torch.int32)},
            torch.from_numpy(xs), ring)

    outs = run_mesh(1, S, body)
    for ys, _ in outs:  # every rank returns the last stage's outputs
        np.testing.assert_allclose(ys.numpy(), np.asarray(jys), **TOL)
    count = torch.cat([state["count"] for _, state in outs]).numpy()
    np.testing.assert_array_equal(count, np.asarray(jstate["count"]))
    np.testing.assert_array_equal(count, np.full(S, M * mb))


def test_pipeline_leading_dim_error_equals_jax():
    S = 4
    jm = Mesh(np.array(jax.devices()[:S]), axis_names=("pp",))
    bad = np.zeros((S + 1, 2, 2), np.float32)
    with pytest.raises(ValueError) as jerr:
        jax_pipeline(_jax_stage, {"w1": jnp.asarray(bad)}, {},
                     jnp.zeros((2, 1, 2)), jm)

    def body(_t, _s, _tg, ring):
        with pytest.raises(ValueError) as terr:
            pipeline_apply(_torch_stage, {"w1": torch.from_numpy(bad)}, {},
                           torch.zeros(2, 1, 2), ring)
        return str(terr.value)

    assert run_mesh(1, S, body) == [str(jerr.value)] * S
