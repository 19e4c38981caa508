"""The port's sampler against dynamo_tpu.engine.sampler.

Greedy rows pick the JAX sampler's token.  Sampled rows draw statelessly
from fold_in(PRNGKey(seed), step) in both packages: the port's threefry2x32
bits equal `jax.random.bits` bit for bit over a hypothesis sweep of seeds
and steps, and `sample_tokens` returns JAX's token for token on seeded
logits.  The candidate set is held too: the CAP window, top-k clamped to
CAP, and the top-p nucleus measured against the full-vocab softmax (the
JAX side of that set is `spec_window_weights`, the numpy mirror of the
masking `sample_tokens` applies on device).
"""

import jax
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
    fold_in,
    gumbel,
    greedy_tokens,
    prng_key,
    random_bits,
    sample_tokens,
)

pytestmark = pytest.mark.allow_slow_callbacks

INT32 = st.integers(-2**31, 2**31 - 1)


def test_greedy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 1000)).astype(np.float32) * 4
    want = np.asarray(jax_greedy(jnp.asarray(logits)))
    got = greedy_tokens(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert CAP == JAX_CAP


@jax.jit
def _jax_bits(seeds, steps):
    def one(seed, step):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        return jax.random.bits(key, (CAP,), jnp.uint32), \
            jax.random.gumbel(key, (CAP,))
    return jax.vmap(one)(seeds, steps)


@settings(max_examples=25, deadline=None, database=None, derandomize=True)
@given(seeds=st.lists(INT32, min_size=1, max_size=6),
       steps=st.lists(st.integers(0, 2**31 - 1), min_size=6, max_size=6))
def test_threefry_bits_equal_jax_random_bits(seeds, steps):
    """Per row, the bits of fold_in(PRNGKey(seed), step) over the CAP
    window: equal bit for bit; the Gumbel noise made from them within an
    ulp of the log's rounding."""
    seeds = np.asarray(seeds, np.int32)
    steps = np.asarray(steps[:len(seeds)], np.int32)
    want, want_g = (np.asarray(x) for x in _jax_bits(jnp.asarray(seeds),
                                                      jnp.asarray(steps)))
    key = fold_in(prng_key(torch.from_numpy(seeds)), torch.from_numpy(steps))
    got = random_bits(key, CAP).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_allclose(gumbel(key, CAP).numpy(), want_g,
                               rtol=1e-6, atol=1e-6)


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       temp=st.sampled_from([0.3, 0.8, 1.0, 2.0]),
       top_k=st.sampled_from([0, 1, 5, 40, 64, 200]),
       top_p=st.sampled_from([0.05, 0.5, 0.9, 1.0]))
def test_draws_stay_in_the_jax_kept_set(seed, temp, top_k, top_p):
    """The candidates kept equal JAX's kept set, and eight seeded draws
    equal JAX's draws token for token (hence stay in that set)."""
    rng = np.random.default_rng(seed)
    # distinct values: a tie at the window or nucleus edge would make
    # the kept set depend on the sort's tie order
    logits = (rng.permutation(500).astype(np.float32) / 50.0
              + rng.standard_normal(500).astype(np.float32) * 0.01)
    kept = _jax_kept(logits, temp, top_k, top_p)
    lt = torch.from_numpy(logits)[None].repeat(8, 1)
    temps = torch.full((8,), temp)
    ks = torch.full((8,), top_k, dtype=torch.int32)
    ps = torch.full((8,), top_p)
    ids, masked = candidate_window(lt, temps, ks, ps)
    port_kept = set(ids[0][masked[0] > -1e29].tolist())
    assert port_kept == kept
    seeds = (seed + np.arange(8)).astype(np.int32)
    steps = np.arange(8, dtype=np.int32)
    draws = sample_tokens(lt, torch.from_numpy(seeds),
                          torch.from_numpy(steps), temps, ks, ps).tolist()
    assert set(draws) <= kept
    jd = jax_sample(jnp.asarray(lt.numpy()), jnp.asarray(seeds),
                    jnp.asarray(steps), jnp.float32(temps.numpy()),
                    jnp.asarray(ks.numpy()), jnp.float32(ps.numpy()))
    assert draws == np.asarray(jd).tolist()


def _jax_kept(logits, temp, top_k, top_p):
    """Candidate ids the JAX sampler can draw (weights > 0)."""
    scaled = logits.astype(np.float64) / max(temp, 1e-6)
    order = np.argsort(-scaled, kind="stable")[:CAP]
    lse = np.log(np.exp(scaled - scaled.max()).sum()) + scaled.max()
    w = spec_window_weights(scaled[order], lse, top_k, top_p)
    return set(order[w > 0].tolist())


def test_mixed_batch_greedy_rows_and_seeded_draws():
    """Greedy rows take the argmax; a seeded row's draw is a function of
    (seed, step) alone, equal to JAX's, and other steps draw otherwise."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 300)).astype(np.float32)
    temps = np.float32([0.0, 0.9, 0.0])
    ks = np.int32([0, 0, 5])
    ps = np.float32([1.0, 0.95, 1.0])
    seeds = np.int32([11, 123, 5])

    def draw(step):
        steps = np.full(3, step, np.int32)
        args = (logits, seeds, steps, temps, ks, ps)
        got = sample_tokens(*(torch.from_numpy(a) for a in args)).tolist()
        assert got == np.asarray(jax_sample(
            *(jnp.asarray(a) for a in args))).tolist()
        return got

    a = [draw(s) for s in range(6)]
    assert a == [draw(s) for s in range(6)]  # reproducible
    argmax = logits.argmax(-1).tolist()
    for row in a:
        assert row[0] == argmax[0] and row[2] == argmax[2]
    assert len({row[1] for row in a}) > 1


def test_seeded_draws_equal_jax_on_tied_logits():
    """Logits rounded to one decimal tie everywhere, 80 of them at the
    maximum: the window cuts through ties at its CAP edge and holds equal
    values inside.  `lax.top_k` orders equal values by ascending id and
    the draw indexes its noise by window position, so the port's window
    must order them the same (order_keys) to draw JAX's tokens; a window
    in torch.topk's order drew other tokens."""
    rng = np.random.default_rng(0)
    logits = np.round(rng.standard_normal((8, 300)), 1).astype(np.float32)
    logits[:, rng.permutation(300)[:80]] = 5.0
    args = (logits, np.arange(8, dtype=np.int32) + 3, np.ones(8, np.int32),
            np.full(8, 0.7, np.float32), np.int32([0, 0, 5, 70, 64, 0, 3, 0]),
            np.float32([1.0, 0.9, 1.0, 1.0, 0.99, 0.5, 1.0, 1.0]))
    got = sample_tokens(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jax_sample(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(got, want)
    ids, _ = candidate_window(torch.from_numpy(logits), torch.ones(8),
                              torch.zeros(8, dtype=torch.int32),
                              torch.ones(8))
    _, jids = jax.lax.top_k(jnp.asarray(logits), CAP)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_apply_penalties_matches_jax():
    from dynamo_tpu.engine.sampler import apply_penalties as jax_penalties
    from dynamo_tpu_torch.engine.sampler import apply_penalties

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    counts = rng.integers(0, 3, (3, 50)).astype(np.int32)
    freq = np.float32([0.0, 0.5, -0.3])
    pres = np.float32([1.0, 0.0, 0.25])
    got = apply_penalties(*(torch.from_numpy(a)
                            for a in (logits, counts, freq, pres)))
    want = jax_penalties(*(jnp.asarray(a)
                           for a in (logits, counts, freq, pres)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
