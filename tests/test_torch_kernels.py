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


def test_wrapper_checks_accept_the_main_path_shapes():
    q, k, v, tables, lens = _decode_inputs([5, 9])
    cuda_paged_attention._check(q, k, v, 1, tables, lens)
    args = _packed_inputs([7, 3], [0, 4])
    cuda_packed_prefill._check(args[0], args[1], args[2], 1, *args[3:])
    with pytest.raises(IndexError):
        cuda_paged_attention._check(q, k, v, 2, tables, lens)


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
