"""The port's sampler against dynamo_tpu.engine.sampler.

Greedy rows must pick the same token as the JAX sampler.  Sampled rows
cannot match JAX's threefry draws (the port draws from a per-request
torch.Generator), so the property held is the support: every draw comes
from the candidate set the JAX code keeps, i.e. the CAP window, top-k
clamped to CAP, and the top-p nucleus measured against the full-vocab
softmax.  The JAX side of that set is `spec_window_weights`, the numpy
mirror of exactly the masking `sample_tokens` applies on device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine.sampler import CAP as JAX_CAP
from dynamo_tpu.engine.sampler import greedy_tokens as jax_greedy
from dynamo_tpu.engine.sampler import sample_tokens as jax_sample
from dynamo_tpu.engine.sampler import spec_window_weights
from dynamo_tpu_torch.engine.sampler import (
    CAP,
    candidate_window,
    greedy_tokens,
    sample_tokens,
)

pytestmark = pytest.mark.allow_slow_callbacks


def test_greedy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 1000)).astype(np.float32) * 4
    want = np.asarray(jax_greedy(jnp.asarray(logits)))
    got = greedy_tokens(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert CAP == JAX_CAP


def _jax_kept(logits, temp, top_k, top_p):
    """Candidate ids the JAX sampler can draw (weights > 0)."""
    scaled = logits.astype(np.float64) / max(temp, 1e-6)
    order = np.argsort(-scaled, kind="stable")[:CAP]
    lse = np.log(np.exp(scaled - scaled.max()).sum()) + scaled.max()
    w = spec_window_weights(scaled[order], lse, top_k, top_p)
    return set(order[w > 0].tolist())


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       temp=st.sampled_from([0.3, 0.8, 1.0, 2.0]),
       top_k=st.sampled_from([0, 1, 5, 40, 64, 200]),
       top_p=st.sampled_from([0.05, 0.5, 0.9, 1.0]))
def test_draws_stay_in_the_jax_kept_set(seed, temp, top_k, top_p):
    rng = np.random.default_rng(seed)
    # distinct values: a tie at the window or nucleus edge would make
    # the kept set depend on the sort's tie order
    logits = (rng.permutation(500).astype(np.float32) / 50.0
              + rng.standard_normal(500).astype(np.float32) * 0.01)
    kept = _jax_kept(logits, temp, top_k, top_p)
    lt = torch.from_numpy(logits)[None].repeat(8, 1)
    temps = torch.full((8,), temp)
    ks = torch.full((8,), top_k)
    ps = torch.full((8,), top_p)
    ids, masked = candidate_window(lt, temps, ks, ps)
    port_kept = set(ids[0][masked[0] > -1e29].tolist())
    assert port_kept == kept
    gens = [torch.Generator().manual_seed(seed + i) for i in range(8)]
    draws = sample_tokens(lt, temps, ks, ps, gens).tolist()
    assert set(draws) <= kept
    # the JAX sampler draws from the same set
    jd = jax_sample(jnp.asarray(logits)[None], jnp.int32([seed % 1000]),
                    jnp.int32([1]), jnp.float32([temp]), jnp.int32([top_k]),
                    jnp.float32([top_p]))
    assert int(jd[0]) in kept


def test_mixed_batch_greedy_rows_and_seeded_draws():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((3, 300)).astype(
        np.float32))
    temps = torch.tensor([0.0, 0.9, 0.0])
    ks = torch.tensor([0, 0, 5])
    ps = torch.tensor([1.0, 0.95, 1.0])

    def draw(seed):
        gens = [None, torch.Generator().manual_seed(seed), None]
        return [sample_tokens(logits, temps, ks, ps, gens).tolist()
                for _ in range(4)]

    a, b = draw(123), draw(123)
    assert a == b  # a seeded request's stream is reproducible
    argmax = logits.argmax(-1).tolist()
    for row in a:
        assert row[0] == argmax[0] and row[2] == argmax[2]
    assert len({row[1] for row in draw(7) + draw(8)}) > 1
