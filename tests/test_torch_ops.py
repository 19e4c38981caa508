"""The port's paged ops against the JAX package's, on the same inputs.

Inputs are made with numpy from a seed and go through both packages; the
KV caches cross through models/convert.py (the JAX layout
[L, nkv, nb, hd, bs] vs the port's [L, nkv, nb, bs, hd]).  On the CPU the
port's kernel wrappers run their plain versions; the JAX side runs its
references and, for one case per op, its Pallas kernels in interpret
mode, as tests/test_packed_pallas.py does.

Tolerance: 1e-5 absolute and relative in fp32 (both sides compute the
same fp32 sums in another order); writes are exact copies, and an int8
cache's codes and scales equal the JAX package's bit for bit (both
quantize the same fp32 values with the same division and rounding).
The kernels themselves only run on the card: tests/test_torch_kernels.py
holds them to the plain versions there (chip_smoke.py does the same at
the llama-8b shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# sibling-module reuse (the tests/ conftest puts tests/ on sys.path)
from test_packed_pallas import _packed_case

from dynamo_tpu.ops.packed_prefill import (
    packed_prefill_attention as jax_packed_attention,
    write_packed_kv as jax_write_packed_kv,
)
from dynamo_tpu.ops.paged_attention import (
    paged_attention_decode as jax_decode,
    write_token_kv as jax_write_token_kv,
)
from dynamo_tpu.ops.pallas_packed_prefill import (
    packed_prefill_attention_pallas,
)
from dynamo_tpu.quant.kv import quantize_tokens as jax_quantize
from dynamo_tpu_torch.models.convert import (
    kv_cache_from_numpy,
    kv_cache_to_numpy,
)
from dynamo_tpu_torch.ops import cuda_packed_prefill, cuda_paged_attention
from dynamo_tpu_torch.ops.packed_prefill import (
    packed_prefill_attention,
    packed_prefill_attention_ref,
    write_packed_kv,
)
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_ref,
    write_token_kv,
)

pytestmark = pytest.mark.allow_slow_callbacks

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))  # a writable copy
    return t if dtype is None else t.to(dtype)


def _decode_case(rng, kv_lens, *, nkv=2, group=2, hd=16, bs=4, mb=8, L=2):
    """fp32 decode case: random caches (garbage block 0 included), each
    row's blocks a disjoint random set, padded table entries -> block 0."""
    B = len(kv_lens)
    nb = 1 + B * mb
    kc = rng.standard_normal((L, nkv, nb, hd, bs)).astype(np.float32)
    vc = rng.standard_normal((L, nkv, nb, hd, bs)).astype(np.float32)
    kc[:, :, 0] *= 1e3  # junk in the garbage block
    vc[:, :, 0] *= 1e3
    tables = np.zeros((B, mb), np.int32)
    perm = rng.permutation(nb - 1) + 1
    for b, n in enumerate(kv_lens):
        used = -(-n // bs)
        tables[b, :used] = perm[b * mb:b * mb + used]
    q = rng.standard_normal((B, nkv * group, hd)).astype(np.float32)
    return q, kc, vc, tables, np.asarray(kv_lens, np.int32)


def _int8_decode_case(rng, kv_lens, **kw):
    """_decode_case with its caches quantized per (position, head) by the
    JAX quantizer, each block's magnitude spread over 0.1-10 first (so a
    scale row from the wrong block shows), and junk codes and scales in
    the garbage block: (q, k, v, k_scale, v_scale, tables, lens) in the
    JAX layout."""
    q, kc, vc, tables, lens = _decode_case(rng, kv_lens, **kw)
    out = []
    for c in (kc, vc):
        c = c * 10.0 ** rng.uniform(-1, 1, c.shape[:3])[..., None, None]
        codes, scale = jax_quantize(jnp.asarray(np.swapaxes(c, -1, -2)))
        codes = np.swapaxes(np.asarray(codes), -1, -2).copy()
        scale = np.asarray(scale).copy()
        codes[:, :, 0] = rng.integers(-127, 128, codes[:, :, 0].shape)
        scale[:, :, 0] = 1e6
        out += [codes, scale]
    kc8, ks, vc8, vs = out
    return q, kc8, vc8, ks, vs, tables, lens


def _port_cache(kc, vc, ks=None, vs=None):
    return kv_cache_from_numpy(kc, vc, device="cpu", k_scale=ks, v_scale=vs)


def test_write_token_kv_matches_jax():
    rng = np.random.default_rng(0)
    q, kc, vc, tables, _ = _decode_case(rng, [5, 12, 1])
    ctx = np.array([4, 11, 0], np.int32)  # next position to write
    k = rng.standard_normal((3, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 2, 16)).astype(np.float32)
    jk, jv = jax_write_token_kv(jnp.asarray(kc), jnp.asarray(vc), 1,
                                jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(tables), jnp.asarray(ctx))
    tk, tv = kv_cache_from_numpy(kc, vc, device="cpu")
    write_token_kv(tk, tv, 1, _t(k), _t(v), _t(tables), _t(ctx))
    ok, ov = kv_cache_to_numpy((tk, tv))
    np.testing.assert_array_equal(ok, np.asarray(jk))
    np.testing.assert_array_equal(ov, np.asarray(jv))


def test_write_packed_kv_matches_jax():
    """Two segments, one at a prefix offset, and a padded tail whose
    writes go to the garbage block (block 0 compared apart: several
    padded tokens land on the same slot there, so its content is
    unspecified in both packages)."""
    rng = np.random.default_rng(1)
    _, kc, vc, _, _ = _decode_case(rng, [4, 4])
    tables = np.array([[3, 5, 7, 0], [2, 4, 6, 8]], np.int32)
    seg = np.array([0] * 5 + [1] * 6 + [0] * 5, np.int32)
    pos = np.concatenate([np.arange(5), 3 + np.arange(6),
                          np.zeros(5)]).astype(np.int32)
    valid = np.arange(16) < 11
    k = rng.standard_normal((16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((16, 2, 16)).astype(np.float32)
    jk, jv = jax_write_packed_kv(
        jnp.asarray(kc), jnp.asarray(vc), 0, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(seg), jnp.asarray(pos),
        jnp.asarray(valid))
    tk, tv = kv_cache_from_numpy(kc, vc, device="cpu")
    write_packed_kv(tk, tv, 0, _t(k), _t(v), _t(tables), _t(seg), _t(pos),
                    _t(valid))
    ok, ov = kv_cache_to_numpy((tk, tv))
    np.testing.assert_array_equal(ok[:, :, 1:], np.asarray(jk)[:, :, 1:])
    np.testing.assert_array_equal(ov[:, :, 1:], np.asarray(jv)[:, :, 1:])


@pytest.mark.parametrize("kv_lens,jax_impl", [
    # uneven rows, partial last blocks (the test_chained_dma decode rows)
    ([1, 24, 3], "jnp"),
    ([1, 24, 3], "pallas_interpret"),
    # exact block boundaries and a full table
    ([4, 8, 32, 9], "jnp"),
])
def test_decode_attention_matches_jax(kv_lens, jax_impl):
    rng = np.random.default_rng(2)
    q, kc, vc, tables, lens = _decode_case(rng, kv_lens)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 1,
                     jnp.asarray(tables), jnp.asarray(lens), impl=jax_impl)
    tk, tv = kv_cache_from_numpy(kc, vc, device="cpu")
    out = paged_attention_decode(_t(q), tk, tv, 1, _t(tables), _t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _packed_from_jax(case):
    q, kc, vc, _, _, tables, seg, pos, valid = case
    tk, tv = kv_cache_from_numpy(np.asarray(kc), np.asarray(vc),
                                 device="cpu")
    return (_t(q), tk, tv, _t(tables), _t(seg), _t(pos), _t(valid))


def _packed_int8_from_jax(case):
    """(q, k, v, tables, seg, pos, valid) and the scales dict of an int8
    _packed_case, in the port's layout."""
    q, kc, vc, ks, vs, tables, seg, pos, valid = case
    tk, tv, tks, tvs = _port_cache(*(np.asarray(a) for a in (kc, vc, ks, vs)))
    return ((_t(q), tk, tv, _t(tables), _t(seg), _t(pos), _t(valid)),
            dict(k_scale=tks, v_scale=tvs))


@pytest.mark.parametrize("lens,bucket,ctx0,pallas", [
    # segment boundaries mid-tile, padded tail (test_chained_dma layout)
    ([5, 11, 3, 13], 32, None, True),
    # leading and interleaved EMPTY rows: the first active (tile,
    # segment) pair is not (0, 0)
    ([0, 7, 0, 9, 0], 16, None, False),
    # committed prefixes: segments start at a prefix offset
    ([6, 4, 6], 16, [13, 0, 5], False),
])
def test_packed_attention_matches_jax(lens, bucket, ctx0, pallas):
    rng = np.random.default_rng(3)
    case = _packed_case(rng, lens, bucket=bucket, ctx0=ctx0)
    q, kc, vc, _, _, tables, seg, pos, valid = case
    ref = jax_packed_attention(q, kc, vc, 1, tables, seg, pos, valid,
                               impl="xla")
    args = _packed_from_jax(case)
    out = packed_prefill_attention(args[0], args[1], args[2], 1, *args[3:])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if pallas:
        kern = packed_prefill_attention_pallas(
            q, kc, vc, 1, tables, seg, pos, valid, interpret=True,
            token_block=8, chunk_cols=1)
        np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)


def test_garbage_block_and_padded_tail():
    """Junk in block 0 (the target of padded table entries) never reaches
    an output, and tokens no segment owns output exactly 0."""
    rng = np.random.default_rng(4)
    case = _packed_case(rng, [5, 3], bucket=16)
    q, tk, tv, tables, seg, pos, valid = _packed_from_jax(case)
    out = packed_prefill_attention_ref(q, tk, tv, 0, tables, seg, pos, valid)
    tk[:, :, 0] = 1e6
    tv[:, :, 0] = -1e6
    again = packed_prefill_attention_ref(q, tk, tv, 0, tables, seg, pos,
                                         valid)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    assert torch.all(out[~valid] == 0)

    qd, kc, vc, dtab, lens = _decode_case(rng, [3, 9])
    dk, dv = kv_cache_from_numpy(kc, vc, device="cpu")
    d0 = paged_attention_decode_ref(_t(qd), dk, dv, 0, _t(dtab), _t(lens))
    dk[:, :, 0] = 1e6
    d1 = paged_attention_decode_ref(_t(qd), dk, dv, 0, _t(dtab), _t(lens))
    torch.testing.assert_close(d1, d0, rtol=0, atol=0)


@pytest.mark.parametrize("lens,group,ctx0", [
    # segment boundaries mid-tile (the test_chained_dma layout)
    ([5, 11, 3, 13], 4, [0, 0, 0, 0]),
    # leading and interleaved EMPTY rows: the first active (tile,
    # segment) pair is not (0, 0)
    ([0, 7, 0, 9, 0], 8, [0, 0, 0, 0, 0]),
    # uneven rows at prefix offsets, boundaries mid-tile at group 8
    ([6, 4, 6], 8, [13, 0, 5]),
    # one segment over several tiles, another starting mid-tile (group 4:
    # 32-token tiles), a long prefix capped at the table width
    ([70, 0, 25], 4, [0, 0, 40]),
    # group 1: 128-token tiles, the whole stream in one tile
    ([9, 30], 1, [3, 0]),
])
def test_packed_tile_plan_matches_pallas_formula(lens, group, ctx0):
    """The wrapper-side tile-skip plane equals the TPU wrapper's formula
    (pallas_packed_prefill.py:244-254 at chunk_cols=1) at the CUDA
    kernel's tile size: per (tile, segment) the causal frontier in
    blocks, 0 for foreign segments; the tiles are ordered by their work,
    most first."""
    bs, mb = 4, 8
    tb = cuda_packed_prefill.token_block(group)
    T = sum(lens)
    Tp = -(-(T + 3) // tb) * tb  # a padded tail
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]
                         + [np.zeros(Tp - T)]).astype(np.int32)
    pos = np.concatenate([c + np.arange(n) for c, n in zip(ctx0, lens)]
                         + [np.zeros(Tp - T)]).astype(np.int32)
    valid = np.arange(Tp) < T
    tables = _t(np.ones((len(lens), mb), np.int32))
    plan = cuda_packed_prefill.packed_prefill_plan(
        _t(seg), _t(pos), _t(valid), tables, 4 * group, 4, bs)
    assert plan.token_block == tb == 2 * (64 // group)
    n_tiles = Tp // tb
    want = np.zeros((n_tiles, len(lens)), np.int32)
    for t in range(n_tiles):
        for s in range(len(lens)):
            sl = slice(t * tb, (t + 1) * tb)
            owned = (seg[sl] == s) & valid[sl]
            if owned.any():
                want[t, s] = min(pos[sl][owned].max() // bs + 1, mb)
    np.testing.assert_array_equal(plan.nchunks.numpy(), want)
    assert plan.seg_eff.shape == (Tp,)
    assert (plan.seg_eff.numpy()[~valid] == -1).all()
    work = want.sum(1)
    order = plan.order.numpy()
    assert sorted(order) == list(range(n_tiles))
    assert (np.diff(work[order]) <= 0).all()


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers compute the plain version and launch
    nothing; "torch" selects the plain version explicitly."""
    rng = np.random.default_rng(5)
    q, kc, vc, tables, lens = _decode_case(rng, [7, 2])
    tk, tv = kv_cache_from_numpy(kc, vc, device="cpu")
    before = (cuda_paged_attention.paged_decode.launches,
              cuda_packed_prefill.packed_prefill.launches)
    a = paged_attention_decode(_t(q), tk, tv, 0, _t(tables), _t(lens))
    b = paged_attention_decode(_t(q), tk, tv, 0, _t(tables), _t(lens),
                               impl="torch")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    case = _packed_from_jax(_packed_case(rng, [5, 3], bucket=16))
    c = packed_prefill_attention(case[0], case[1], case[2], 0, *case[3:])
    d = packed_prefill_attention(case[0], case[1], case[2], 0, *case[3:],
                                 impl="torch")
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    assert (cuda_paged_attention.paged_decode.launches,
            cuda_packed_prefill.packed_prefill.launches) == before
    with pytest.raises(ValueError):
        paged_attention_decode(_t(q), tk, tv, 0, _t(tables), _t(lens),
                               impl="pallas")
    # an int8 cache with its scales: the int8 plain version, no launch
    q8, kc8, vc8, ks, vs, tab8, lens8 = _int8_decode_case(rng, [7, 2])
    tk8, tv8, tks, tvs = _port_cache(kc8, vc8, ks, vs)
    before8 = cuda_paged_attention.paged_decode_int8.launches
    got = paged_attention_decode(_t(q8), tk8, tv8, 0, _t(tab8), _t(lens8),
                                 k_scale=tks, v_scale=tvs)
    want = paged_attention_decode_ref(_t(q8), tk8, tv8, 0, _t(tab8),
                                      _t(lens8), k_scale=tks, v_scale=tvs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cuda_paged_attention.paged_decode_int8.launches == before8
    # scales never go unused, and an int8 cache never goes without them
    with pytest.raises(TypeError):
        paged_attention_decode(_t(q), tk, tv, 0, _t(tables), _t(lens),
                               k_scale=tks, v_scale=tvs)
    with pytest.raises(TypeError):
        paged_attention_decode(_t(q8), tk8, tv8, 0, _t(tab8), _t(lens8))
    with pytest.raises(ValueError):
        paged_attention_decode(_t(q8), tk8, tv8, 0, _t(tab8), _t(lens8),
                               k_scale=tks)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------


def test_write_token_kv_int8_matches_jax():
    """Quantize-on-write: codes and scale planes equal JAX's exactly."""
    rng = np.random.default_rng(10)
    _, kc, vc, ks, vs, tables, _ = _int8_decode_case(rng, [5, 12, 1])
    ctx = np.array([4, 11, 0], np.int32)
    k = (3 * rng.standard_normal((3, 2, 16))).astype(np.float32)
    v = rng.standard_normal((3, 2, 16)).astype(np.float32)
    want = jax_write_token_kv(
        *(jnp.asarray(a) for a in (kc, vc)), 1, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(tables), jnp.asarray(ctx),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    cache = _port_cache(kc, vc, ks, vs)
    write_token_kv(cache[0], cache[1], 1, _t(k), _t(v), _t(tables), _t(ctx),
                   k_scale=cache[2], v_scale=cache[3])
    got = kv_cache_to_numpy(cache)
    assert got[0].dtype == np.int8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_write_packed_kv_int8_matches_jax():
    """The packed write of test_write_packed_kv_matches_jax on an int8
    cache (block 0 compared apart: padded tokens collide there)."""
    rng = np.random.default_rng(11)
    _, kc, vc, ks, vs, _, _ = _int8_decode_case(rng, [4, 4])
    tables = np.array([[3, 5, 7, 0], [2, 4, 6, 8]], np.int32)
    seg = np.array([0] * 5 + [1] * 6 + [0] * 5, np.int32)
    pos = np.concatenate([np.arange(5), 3 + np.arange(6),
                          np.zeros(5)]).astype(np.int32)
    valid = np.arange(16) < 11
    k = rng.standard_normal((16, 2, 16)).astype(np.float32)
    v = (0.01 * rng.standard_normal((16, 2, 16))).astype(np.float32)
    want = jax_write_packed_kv(
        *(jnp.asarray(a) for a in (kc, vc)), 0, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(tables), jnp.asarray(seg),
        jnp.asarray(pos), jnp.asarray(valid), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    cache = _port_cache(kc, vc, ks, vs)
    write_packed_kv(cache[0], cache[1], 0, _t(k), _t(v), _t(tables),
                    _t(seg), _t(pos), _t(valid), k_scale=cache[2],
                    v_scale=cache[3])
    for g, w in zip(kv_cache_to_numpy(cache), want):
        np.testing.assert_array_equal(g[:, :, 1:], np.asarray(w)[:, :, 1:])


@pytest.mark.parametrize("kv_lens,jax_impl,impl", [
    ([1, 24, 3], "jnp", "auto"),
    ([1, 24, 3], "pallas_interpret", "auto"),
    ([1, 24, 3], "jnp", "torch"),
    ([4, 8, 32, 9], "jnp", "auto"),
    ([4, 8, 32, 9], "pallas_interpret", "torch"),
])
def test_decode_attention_int8_matches_jax(kv_lens, jax_impl, impl):
    """Int8 decode: the CPU wrapper path ("auto") and the plain version
    ("torch") against JAX's reference and its interpret-mode kernel."""
    rng = np.random.default_rng(12)
    q, kc, vc, ks, vs, tables, lens = _int8_decode_case(rng, kv_lens)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 1,
                     jnp.asarray(tables), jnp.asarray(lens), impl=jax_impl,
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tk, tv, tks, tvs = _port_cache(kc, vc, ks, vs)
    out = paged_attention_decode(_t(q), tk, tv, 1, _t(tables), _t(lens),
                                 impl=impl, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lens,bucket,ctx0,pallas", [
    ([5, 11, 3, 13], 32, None, True),
    ([0, 7, 0, 9, 0], 16, None, False),
    ([6, 4, 6], 16, [13, 0, 5], False),
    # the test_packed_pallas_int8_dequant layout
    ([7, 1, 12, 4], 32, [3, 0, 0, 5], True),
])
def test_packed_attention_int8_matches_jax(lens, bucket, ctx0, pallas):
    """Int8 packed prefill over a cache written through JAX's quantizing
    write ops (_packed_case int8=True), against JAX's XLA reference and
    its interpret-mode kernel."""
    rng = np.random.default_rng(13)
    case = _packed_case(rng, lens, bucket=bucket, ctx0=ctx0, int8=True)
    q, kc, vc, ks, vs, tables, seg, pos, valid = case
    ref = jax_packed_attention(q, kc, vc, 1, tables, seg, pos, valid,
                               impl="xla", k_scale=ks, v_scale=vs)
    args, scales = _packed_int8_from_jax(case)
    out = packed_prefill_attention(*args[:3], 1, *args[3:], **scales)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    plain = packed_prefill_attention(*args[:3], 1, *args[3:], impl="torch",
                                     **scales)
    torch.testing.assert_close(plain, out, rtol=0, atol=0)
    if pallas:
        kern = packed_prefill_attention_pallas(
            q, kc, vc, 1, tables, seg, pos, valid, interpret=True,
            token_block=8, chunk_cols=2, k_scale=ks, v_scale=vs)
        np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)


def test_int8_garbage_block_tolerance():
    """Junk codes and scales in block 0 leave both int8 plain versions
    bit-identical."""
    rng = np.random.default_rng(14)
    case = _packed_case(rng, [5, 3], bucket=16, int8=True)
    args, scales = _packed_int8_from_jax(case)
    out = packed_prefill_attention_ref(*args[:3], 0, *args[3:], **scales)
    args[1][:, :, 0] = 127
    args[2][:, :, 0] = -127
    scales["k_scale"][:, :, 0] = 1e30
    scales["v_scale"][:, :, 0] = 1e30
    again = packed_prefill_attention_ref(*args[:3], 0, *args[3:], **scales)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    assert torch.all(out[~args[6]] == 0)

    q, kc, vc, ks, vs, tables, lens = _int8_decode_case(rng, [3, 9])
    tk, tv, tks, tvs = _port_cache(kc, vc, ks, vs)
    d0 = paged_attention_decode_ref(_t(q), tk, tv, 0, _t(tables), _t(lens),
                                    k_scale=tks, v_scale=tvs)
    tk[:, :, 0] = 127
    tvs[:, :, 0] = 1e30
    d1 = paged_attention_decode_ref(_t(q), tk, tv, 0, _t(tables), _t(lens),
                                    k_scale=tks, v_scale=tvs)
    torch.testing.assert_close(d1, d0, rtol=0, atol=0)
