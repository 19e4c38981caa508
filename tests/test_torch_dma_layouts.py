"""K4a/K4b's plain versions against the TPU kernels' bodies (CPU).

The TPU microbench (benchmarks/bench_dma_layouts.py) is run here in
Pallas's TPU interpret mode at a small size: `gather_kernel` through
`make_gather`'s grid spec built in the test (its module's REPS set by
monkeypatch), and the `seq` kernel of its `main` restated.  The port's
plain versions (dynamo_tpu_torch/bench/bench_dma_layouts.py), which the
CUDA kernels are held to on the card, must give the same output on the
same slab: both sum bf16 values in fp32, in another order, so the bound
is 1e-6 relative.  BS stays 128 and HD >= 8: the TPU kernel reads an
(8, 128) corner of each plane.  The array crosses unchanged: the port's
[bs, hd] plane order names the TPU's [hd, bs] axes the other way round,
and both take the plane's first 8 rows.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dynamo_tpu_torch.bench import bench_dma_layouts as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NKV, HD, BS, NB, NREAD, REPS = 2, 8, 128, 32, 16, 2


@pytest.fixture
def tpu_bench(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "tpu_bench_dma_layouts",
        os.path.join(REPO, "benchmarks", "bench_dma_layouts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "REPS", REPS)
    return mod


def _slab(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16)


def _tables(seed=0):
    return np.random.default_rng(seed).permutation(NB)[:NREAD].astype(
        np.int32)


@pytest.mark.parametrize("mode", ["strided", "contig"])
def test_gather_plain_matches_tpu_gather_kernel(tpu_bench, mode):
    bpc = tpu_bench.BPC
    shape = (NKV, NB, HD, BS) if mode == "strided" else (NB, NKV, HD, BS)
    slab, tables = _slab(shape), _tables()
    fn = pl.pallas_call(
        functools.partial(tpu_bench.gather_kernel, mode=mode, nread=NREAD),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((8, 128), lambda i, *r: (0, 0)),
            scratch_shapes=[pltpu.VMEM((2, bpc, NKV, HD, BS), jnp.bfloat16),
                            pltpu.SemaphoreType.DMA((2,))]),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=pltpu.InterpretParams())
    want = np.asarray(fn(jnp.asarray(tables), slab))
    t = torch.from_numpy(np.asarray(slab, np.float32)).to(torch.bfloat16)
    wrapper = port.gather_strided if mode == "strided" \
        else port.gather_contig
    got = wrapper(t, torch.from_numpy(tables), reps=REPS, bpc=bpc)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a table whose chunk-first entry names another block reads otherwise
    bad = tables.copy()
    bad[0] = next(b for b in range(1, NB) if b not in tables)
    off = wrapper(t, torch.from_numpy(bad), reps=REPS, bpc=bpc)
    assert port.row_rel_err(off, torch.from_numpy(want.copy())) > 1e-5


def test_seq_plain_matches_tpu_seq_kernel(tpu_bench):
    bpc = tpu_bench.BPC
    slab = _slab((NB, NKV, HD, BS), seed=1)

    # the `seq` kernel of the TPU bench's main(), restated
    def seq_kernel(x_ref, o_ref):
        @pl.when(pl.program_id(0) == 0)
        def _():
            o_ref[...] = jnp.zeros_like(o_ref)
        o_ref[...] += x_ref[0, 0].astype(jnp.float32)

    fn = pl.pallas_call(
        seq_kernel, grid=(REPS * NB // bpc,),
        in_specs=[pl.BlockSpec((bpc, NKV, HD, BS),
                               lambda i: (jax.lax.rem(i, NB // bpc), 0, 0,
                                          0))],
        out_specs=pl.BlockSpec((HD, BS), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((HD, BS), jnp.float32),
        interpret=pltpu.InterpretParams())
    want = np.asarray(fn(slab))
    t = torch.from_numpy(np.asarray(slab, np.float32)).to(torch.bfloat16)
    got = port.seq(t, reps=REPS, bpc=bpc)
    assert got.shape == (HD, BS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_benchmark_shapes_and_bytes():
    """The source's shapes: 1.07 GB a gather call, 2.15 GB a sequential
    call, both past the 50 MB L2; the CPU wrappers count no launch."""
    assert (port.NKV, port.HD, port.BS, port.NB, port.NREAD, port.BPC,
            port.REPS) == (8, 128, 128, 1024, 512, 8, 8)
    assert port.nbytes("strided") == port.nbytes("contig") == 2**30
    assert port.nbytes("seq") == 2**31
    slab = torch.zeros(4, 2, 16, 8, dtype=torch.bfloat16)
    port.seq(slab, reps=1, bpc=2)
    port.gather_contig(slab, torch.arange(4, dtype=torch.int32), reps=1,
                       bpc=2)
    assert port.seq.launches == port.gather_contig.launches == 0


@pytest.mark.gpu
def test_gpu_kernels_match_plain_on_gpu():
    """On a card: each mode of the CUDA kernels against its plain version
    at the benchmark's shapes, and deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    x = port.inputs(torch.device("cuda", 0))
    plain = {"strided": port.gather_ref(x["layer"], x["tables"], True),
             "contig": port.gather_ref(x["slab"], x["tables"], False),
             "seq": port.seq_ref(x["slab"])}
    for mode, fn in port.calls(x).items():
        a, b = fn(), fn()
        assert torch.equal(a, b)
        assert port.row_rel_err(a, plain[mode]) <= 1e-5
