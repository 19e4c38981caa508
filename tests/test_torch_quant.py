"""The port's int8 KV quantizer and capacity math against the JAX
package's (dynamo_tpu/quant/kv.py), on the same inputs.

Codes and scales must be equal bit for bit: both packages compute
absmax / 127 in fp32, divide (a true division), round half to even and
clip.  Dequantization is one fp32 product per element on both sides.
The capacity math must give the same byte and block counts for every
preset and block size, since it decides how many blocks a deployment's
memory budget holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jax_llama
from dynamo_tpu.quant import kv as jax_kv
from dynamo_tpu_torch.models import llama as torch_llama
from dynamo_tpu_torch.quant import kv as torch_kv


def _rows(kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        return (3.0 * rng.standard_normal((64, 4, 32))).astype(np.float32)
    if kind == "zeros":
        return np.zeros((3, 2, 8), np.float32)
    if kind == "extremes":
        return np.array([[-5.0, 2.0, 5.0, 0.0],
                         [3e38, -3e38, 1.0, 0.0],
                         [1e-35, -2e-35, 0.0, 1e-38],
                         [-127.0, 127.0, 126.5, -0.25]], np.float32)
    # exact half steps: absmax 127 gives scale 1, so x / scale = k + 0.5
    # and round-half-to-even decides every code
    half = np.arange(-126, 127, dtype=np.float32) + 0.5
    return np.concatenate([[127.0], half]).reshape(1, -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "zeros", "extremes",
                                  "half_steps"])
def test_quantize_tokens_matches_jax_exactly(kind):
    x = _rows(kind)
    jq, js = jax_kv.quantize_tokens(jnp.asarray(x))
    tq, ts = torch_kv.quantize_tokens(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dequantize_matches_jax():
    x = _rows("random")
    jq, js = jax_kv.quantize_tokens(jnp.asarray(x))
    want = np.asarray(jax_kv.dequantize(jq, js))
    tq, ts = (torch.from_numpy(np.array(a)) for a in (jq, js))
    got = torch_kv.dequantize(tq, ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    # error bound of symmetric per-token quantization: absmax / 254
    err = np.abs(got.numpy() - x)
    bound = np.asarray(js)[..., None] * (0.5 + 1e-5) + 1e-6
    assert (err <= bound).all()
    assert torch_kv.dequantize(tq, ts, torch.bfloat16).dtype \
        == torch.bfloat16


def test_cache_tuple_helpers():
    k, v = torch.zeros(1), torch.ones(1)
    assert not torch_kv.is_quantized((k, v))
    assert torch_kv.unpack_kv((k, v)) == (k, v, None, None)
    four = (k, v, k + 2, v + 3)
    assert torch_kv.is_quantized(four)
    assert torch_kv.unpack_kv(four) == four


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("block_size", [16, 128])
@pytest.mark.parametrize("model", ["tiny", "llama-1b", "llama-8b"])
def test_capacity_math_matches_jax(model, block_size, dtype):
    jcfg = jax_llama.PRESETS[model]
    tcfg = torch_llama.PRESETS[model]
    per = torch_kv.kv_cache_bytes_per_block(torch_llama, tcfg, block_size,
                                            dtype)
    assert per == jax_kv.kv_cache_bytes_per_block(jax_llama, jcfg,
                                                  block_size, dtype)
    for budget in (0, 10**6, int(4.5e9), int(60e9)):
        assert torch_kv.blocks_for_hbm_budget(
            torch_llama, tcfg, block_size, dtype, budget) \
            == jax_kv.blocks_for_hbm_budget(jax_llama, jcfg, block_size,
                                            dtype, budget)
    if dtype == "int8" and model == "llama-8b":
        # (hd + 4) / (2 hd) of the bf16 bytes at head_dim 128
        bf16 = torch_kv.kv_cache_bytes_per_block(torch_llama, tcfg,
                                                 block_size, "bf16")
        assert per / bf16 == pytest.approx(132 / 256)
