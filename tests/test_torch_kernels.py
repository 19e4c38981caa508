"""The port's CUDA kernel wrappers: input checks (CPU) and the kernels
against their plain versions (on the card).

This file imports neither jax nor the JAX package, so it also runs on a
machine with the card and no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(--noconftest: tests/conftest.py configures jax).  The card tests carry
the `gpu` marker and skip where torch.cuda is unavailable.  Tolerance in
bf16: chip_smoke.py's, with its reason: each output row's relative L2
error against the plain version, which rounds q * 1/sqrt(hd) to bf16 as
the kernels do (round_scaled_q=True), is at most REL_TOL.
"""

import numpy as np
import pytest
import torch

from chip_smoke import REL_TOL, row_rel_err
from dynamo_tpu_torch.ops import cuda_packed_prefill, cuda_paged_attention
from dynamo_tpu_torch.ops.packed_prefill import packed_prefill_attention_ref
from dynamo_tpu_torch.ops.paged_attention import paged_attention_decode_ref
from dynamo_tpu_torch.quant.kv import quantize_tokens


def _quantized(k, v, rng):
    """(k codes, v codes, k_scale, v_scale) of float caches
    [L, nkv, nb, bs, hd], each block's magnitude spread over 0.1-10 first
    so that a scale row read from the wrong block shows."""
    out = []
    for c in (k, v):
        spread = 10.0 ** rng.uniform(-1, 1, c.shape[:3])
        out.append(quantize_tokens(
            c.float() * torch.from_numpy(spread).float()[..., None, None]
            .to(c.device)))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


def _decode_inputs(kv_lens, *, nkv=2, group=4, hd=128, bs=128, mb=4, L=2,
                   device="cpu", dtype=torch.bfloat16):
    rng = np.random.default_rng(0)
    B = len(kv_lens)
    nb = 1 + B * mb
    k = torch.from_numpy(rng.standard_normal((L, nkv, nb, bs, hd)))
    v = torch.from_numpy(rng.standard_normal((L, nkv, nb, bs, hd)))
    k[:, :, 0] *= 50.0  # junk in the garbage block
    v[:, :, 0] *= 50.0
    tables = np.zeros((B, mb), np.int32)
    for b, n in enumerate(kv_lens):
        used = -(-n // bs)
        tables[b, :used] = 1 + b * mb + np.arange(used)
    q = torch.from_numpy(rng.standard_normal((B, nkv * group, hd)))
    to = dict(device=device, dtype=dtype)
    return (q.to(**to), k.to(**to), v.to(**to),
            torch.from_numpy(tables).to(device),
            torch.tensor(kv_lens, dtype=torch.int32, device=device))


def _decode_inputs_int8(kv_lens, **kw):
    """_decode_inputs with int8 caches: (q, k, v, tables, lens, k_scale,
    v_scale)."""
    q, k, v, tables, lens = _decode_inputs(kv_lens, **kw)
    kq, vq, ks, vs = _quantized(k, v, np.random.default_rng(2))
    return q, kq, vq, tables, lens, ks, vs


def _packed_inputs(lens, ctx0, *, nkv=2, group=4, hd=128, bs=128, mb=4,
                   L=2, pad=5, device="cpu", dtype=torch.bfloat16):
    rng = np.random.default_rng(1)
    S = len(lens)
    T = sum(lens) + pad
    seg = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    valid = np.zeros(T, bool)
    off = 0
    for s in reversed(range(S)):  # the stream does not start with row 0
        seg[off:off + lens[s]] = s
        pos[off:off + lens[s]] = ctx0[s] + np.arange(lens[s])
        valid[off:off + lens[s]] = True
        off += lens[s]
    nb = 1 + S * mb
    tables = (1 + np.arange(S * mb, dtype=np.int32)).reshape(S, mb)
    k = torch.from_numpy(rng.standard_normal((L, nkv, nb, bs, hd)))
    v = torch.from_numpy(rng.standard_normal((L, nkv, nb, bs, hd)))
    q = torch.from_numpy(rng.standard_normal((T, nkv * group, hd)))
    to = dict(device=device, dtype=dtype)
    return (q.to(**to), k.to(**to), v.to(**to),
            *(torch.from_numpy(a).to(device)
              for a in (tables, seg, pos, valid)))


def _packed_inputs_int8(lens, ctx0, **kw):
    """_packed_inputs with int8 caches: (q, k, v, tables, seg, pos,
    valid, k_scale, v_scale)."""
    q, k, v, *rest = _packed_inputs(lens, ctx0, **kw)
    kq, vq, ks, vs = _quantized(k, v, np.random.default_rng(3))
    return (q, kq, vq, *rest, ks, vs)


# int8 misuse: name -> (change to (k, v, k_scale, v_scale), error)
_INT8_MISUSE = {
    "int8 cache without scales": (
        lambda k, v, ks, vs: (k, v, None, None), TypeError),
    "scales with a bf16 cache": (
        lambda k, v, ks, vs: (k.to(torch.bfloat16), v.to(torch.bfloat16),
                              ks, vs), TypeError),
    "one scale plane": (lambda k, v, ks, vs: (k, v, ks, None), ValueError),
    "bf16 scales": (
        lambda k, v, ks, vs: (k, v, ks.to(torch.bfloat16), vs), TypeError),
    "scale plane of another shape": (
        lambda k, v, ks, vs: (k, v, ks[:, :, :-1].contiguous(), vs),
        ValueError),
    "non-contiguous scales": (
        lambda k, v, ks, vs: (k, v, ks.transpose(0, 1).contiguous()
                              .transpose(0, 1), vs), ValueError),
    "scales on another device": (
        lambda k, v, ks, vs: (k, v, ks, vs.to("meta")), ValueError),
}


@pytest.mark.parametrize("change,error", [
    (dict(dtype=torch.float32), TypeError),   # the kernels take bf16
    (dict(hd=32), ValueError),                # head_dim 64 or 128
    (dict(group=32), ValueError),             # group too large
    (dict(bs=48), ValueError),                # block size a multiple of 32
])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    q, k, v, tables, lens = _decode_inputs([5, 9], **change)
    with pytest.raises(error):
        cuda_paged_attention._check(q, k, v, 1, tables, lens)


@pytest.mark.parametrize("change,error", [
    (dict(dtype=torch.float32), TypeError),
    (dict(bs=96), ValueError),   # block size a multiple of 64, <= 128
    (dict(group=16), ValueError),
])
def test_packed_wrapper_rejects_what_the_kernel_does_not_take(change,
                                                              error):
    args = _packed_inputs([7, 3], [0, 4], **change)
    with pytest.raises(error):
        cuda_packed_prefill._check(args[0], args[1], args[2], 1, *args[3:])


@pytest.mark.parametrize("misuse", sorted(_INT8_MISUSE))
def test_decode_wrapper_rejects_int8_misuse(misuse):
    change, error = _INT8_MISUSE[misuse]
    q, k, v, tables, lens, ks, vs = _decode_inputs_int8([5, 9])
    k, v, ks, vs = change(k, v, ks, vs)
    with pytest.raises(error):
        cuda_paged_attention._check(q, k, v, 1, tables, lens, ks, vs)


@pytest.mark.parametrize("misuse", sorted(_INT8_MISUSE))
def test_packed_wrapper_rejects_int8_misuse(misuse):
    change, error = _INT8_MISUSE[misuse]
    q, k, v, *meta, ks, vs = _packed_inputs_int8([7, 3], [0, 4])
    k, v, ks, vs = change(k, v, ks, vs)
    with pytest.raises(error):
        cuda_packed_prefill._check(q, k, v, 1, *meta, ks, vs)


def test_wrapper_checks_accept_the_main_path_shapes():
    q, k, v, tables, lens = _decode_inputs([5, 9])
    cuda_paged_attention._check(q, k, v, 1, tables, lens)
    args = _packed_inputs([7, 3], [0, 4])
    cuda_packed_prefill._check(args[0], args[1], args[2], 1, *args[3:])
    with pytest.raises(IndexError):
        cuda_paged_attention._check(q, k, v, 2, tables, lens)
    q, k, v, tables, lens, ks, vs = _decode_inputs_int8([5, 9])
    cuda_paged_attention._check(q, k, v, 1, tables, lens, ks, vs)
    q, k, v, *meta, ks, vs = _packed_inputs_int8([7, 3], [0, 4])
    cuda_packed_prefill._check(q, k, v, 1, *meta, ks, vs)


def test_int8_wrappers_on_cpu_take_the_int8_plain_version():
    q, k, v, tables, lens, ks, vs = _decode_inputs_int8([5, 9])
    before = cuda_paged_attention.paged_decode_int8.launches
    got = cuda_paged_attention.paged_decode_int8(q, k, v, ks, vs, 1, tables,
                                                 lens)
    want = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                      k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    q, k, v, *meta, ks, vs = _packed_inputs_int8([7, 3], [0, 4])
    got = cuda_packed_prefill.packed_prefill_int8(q, k, v, ks, vs, 1, *meta)
    want = packed_prefill_attention_ref(q, k, v, 1, *meta, k_scale=ks,
                                        v_scale=vs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cuda_paged_attention.paged_decode_int8.launches == before
    with pytest.raises(TypeError):  # the bf16 entry point on int8 codes
        cuda_paged_attention.paged_decode(q[:2], k, v, 1, tables, lens)


def test_tolerance_passes_rounding_and_catches_an_off_by_one():
    """The bound on the CPU, with plain versions standing in for the
    kernel: leaving out the kernels' rounding of q * 1/sqrt(hd) to bf16
    (an error of the size bf16 makes) stays inside REL_TOL; reading one
    position past a row's end does not.  hd = 128, where the scale is
    not a power of two, so the rounding changes q."""
    q, k, v, tables, lens = _decode_inputs([1, 127, 300, 511], hd=128)
    want = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                      round_scaled_q=True)
    unrounded = paged_attention_decode_ref(q, k, v, 1, tables, lens)
    assert 0 < row_rel_err(unrounded, want) <= REL_TOL
    longer = lens.clone()
    longer[-1] += 1
    past_end = paged_attention_decode_ref(q, k, v, 1, tables, longer,
                                          round_scaled_q=True)
    assert row_rel_err(past_end, want) > REL_TOL


def test_tolerance_catches_a_wrong_scale_row():
    """On an int8 cache with per-block magnitude spread, a block's scale
    rows read from another block err far above REL_TOL, while the int8
    plain version's own q rounding stays inside it."""
    q, k, v, tables, lens, ks, vs = _decode_inputs_int8([1, 127, 300, 511])
    want = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                      round_scaled_q=True, k_scale=ks,
                                      v_scale=vs)
    unrounded = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                           k_scale=ks, v_scale=vs)
    assert 0 < row_rel_err(unrounded, want) <= REL_TOL
    blk, other = int(tables[3, 2]), int(tables[2, 0])
    wks, wvs = ks.clone(), vs.clone()
    wks[1, :, blk] = ks[1, :, other]
    wvs[1, :, blk] = vs[1, :, other]
    wrong = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                       round_scaled_q=True, k_scale=wks,
                                       v_scale=wvs)
    assert row_rel_err(wrong, want) > REL_TOL


@pytest.mark.parametrize("B,nkv,mb,bs,sms,want", [
    (8, 8, 16, 128, 132, 5),    # the chip_smoke case: 64 (row, head) pairs
    (4, 8, 16, 128, 132, 9),    # the engine's batch
    (1, 8, 16, 128, 132, 16),   # one row: capped at MAX_SPLITS
    (64, 8, 16, 128, 132, 1),   # more pairs than one wave holds
    (2, 2, 3, 32, 132, 2),      # a table narrower than two units
])
def test_decode_split_plan_follows_the_grid(B, nkv, mb, bs, sms, want):
    """K1's split count comes from B, nkv, the table width and the SM
    count: one wave of CTAS_PER_SM CTAs per SM at full tables, never more
    splits than a full table has 64-position units or MAX_SPLITS."""
    assert cuda_paged_attention.decode_splits(B, nkv, mb, bs, sms) == want


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_kernel_matches_plain_on_gpu(hd):
    dev = _cuda()
    q, k, v, tables, lens = _decode_inputs([1, 127, 128, 129, 300], hd=hd,
                                           device=dev)
    before = cuda_paged_attention.paged_decode.launches
    got = cuda_paged_attention.paged_decode(q, k, v, 1, tables, lens)
    assert cuda_paged_attention.paged_decode.launches == before + 1
    want = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                      round_scaled_q=True)
    assert row_rel_err(got, want) <= REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("hd,bs", [(64, 64), (128, 128)])
def test_packed_kernel_matches_plain_on_gpu(hd, bs):
    dev = _cuda()
    args = _packed_inputs([150, 0, 37, 70], [0, 0, 100, 3], hd=hd, bs=bs,
                          device=dev)
    before = cuda_packed_prefill.packed_prefill.launches
    got = cuda_packed_prefill.packed_prefill(args[0], args[1], args[2], 1,
                                             *args[3:])
    assert cuda_packed_prefill.packed_prefill.launches == before + 1
    want = packed_prefill_attention_ref(args[0], args[1], args[2], 1,
                                        *args[3:], round_scaled_q=True)
    assert row_rel_err(got, want) <= REL_TOL
    assert bool((got[~args[6]] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_int8_kernel_matches_plain_on_gpu(hd):
    dev = _cuda()
    q, k, v, tables, lens, ks, vs = _decode_inputs_int8(
        [1, 127, 128, 129, 300], hd=hd, device=dev)
    before = cuda_paged_attention.paged_decode_int8.launches
    got = cuda_paged_attention.paged_decode_int8(q, k, v, ks, vs, 1, tables,
                                                 lens)
    assert cuda_paged_attention.paged_decode_int8.launches == before + 1
    want = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                      round_scaled_q=True, k_scale=ks,
                                      v_scale=vs)
    assert row_rel_err(got, want) <= REL_TOL


# decode edge cases: (kv_lens, mb); B = 64 draws its lengths from a seed
_DECODE_EDGES = {
    "B=1, kv_len 1": ([1], 4),
    "B=1, a full table": ([2048], 16),
    "one unit, one split's worth, a unit boundary": ([64, 128, 192, 65], 4),
    "B=64": (list(np.random.default_rng(7).integers(1, 257, 64)), 2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", sorted(_DECODE_EDGES))
def test_decode_kernel_edge_cases_on_gpu(case, int8):
    """K1 in both modes at the split plan's edges: a 1-position row, a
    row that is exactly one unit (its one live split writes the output
    directly), rows that end on a unit or block boundary, B = 1 (every
    split of one row live) and B = 64 (one or two splits a row)."""
    dev = _cuda()
    kv_lens, mb = _DECODE_EDGES[case]
    kw = dict(mb=mb, device=dev)
    if int8:
        q, k, v, tables, lens, ks, vs = _decode_inputs_int8(kv_lens, **kw)
        got = cuda_paged_attention.paged_decode_int8(q, k, v, ks, vs, 1,
                                                     tables, lens)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        q, k, v, tables, lens = _decode_inputs(kv_lens, **kw)
        got = cuda_paged_attention.paged_decode(q, k, v, 1, tables, lens)
        scales = {}
    want = paged_attention_decode_ref(q, k, v, 1, tables, lens,
                                      round_scaled_q=True, **scales)
    assert row_rel_err(got, want) <= REL_TOL
    # a second call finds the merge counters reset
    again = (cuda_paged_attention.paged_decode_int8(q, k, v, ks, vs, 1,
                                                    tables, lens) if int8
             else cuda_paged_attention.paged_decode(q, k, v, 1, tables,
                                                    lens))
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_packed_kernel_group8_tile_boundaries_on_gpu(int8):
    """K3 at group 8, hd 64, bs 64: 16-token tiles, with segment
    boundaries inside tiles, an empty row, a prefix offset and a padded
    tail; the plan is computed once and reused, as the model does."""
    dev = _cuda()
    lens, ctx0 = [5, 16, 0, 23, 40], [0, 70, 0, 9, 0]
    kw = dict(group=8, hd=64, bs=64, mb=3, nkv=2, device=dev)
    if int8:
        q, k, v, *meta, ks, vs = _packed_inputs_int8(lens, ctx0, **kw)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        q, k, v, *meta = _packed_inputs(lens, ctx0, **kw)
        scales = {}
    tables, seg, pos, valid = meta
    plan = cuda_packed_prefill.packed_prefill_plan(seg, pos, valid, tables,
                                                   16, 2, 64)
    assert plan.token_block == 16
    fn = (cuda_packed_prefill.packed_prefill_int8 if int8
          else cuda_packed_prefill.packed_prefill)
    args = (q, k, v, *(scales.values()), 1, *meta)
    got = fn(*args, plan=plan)
    assert torch.equal(fn(*args), got)  # the plan computed per call
    want = packed_prefill_attention_ref(q, k, v, 1, *meta,
                                        round_scaled_q=True, **scales)
    assert row_rel_err(got, want) <= REL_TOL
    assert bool((got[~valid] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hd,bs", [(64, 64), (128, 128)])
def test_packed_int8_kernel_matches_plain_on_gpu(hd, bs):
    dev = _cuda()
    q, k, v, *meta, ks, vs = _packed_inputs_int8(
        [150, 0, 37, 70], [0, 0, 100, 3], hd=hd, bs=bs, device=dev)
    before = cuda_packed_prefill.packed_prefill_int8.launches
    got = cuda_packed_prefill.packed_prefill_int8(q, k, v, ks, vs, 1, *meta)
    assert cuda_packed_prefill.packed_prefill_int8.launches == before + 1
    want = packed_prefill_attention_ref(q, k, v, 1, *meta,
                                        round_scaled_q=True, k_scale=ks,
                                        v_scale=vs)
    assert row_rel_err(got, want) <= REL_TOL
    assert bool((got[~meta[3]] == 0).all())
