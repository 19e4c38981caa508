"""The port's native KV indexer (csrc/kv_indexer.cc over ctypes) against
its Python indexer and the JAX package's `PyKvIndexer` (CPU).

The host C++ compiler builds the library into the git-ignored
`dynamo_tpu_torch/_build/` at first use (a few seconds).  Randomized
interleavings of stores, removals, worker drops and clears, queried as
they go, give equal matches, block counts and workers on all three, and
through the tier-aware wrapper; `make_indexer` resolves as JAX's does
(`auto` native once built); a compiler that fails raises with its
output, and leaves no library behind.
"""

import os
import random
import stat

import pytest

from dynamo_tpu.router.indexer import PyKvIndexer as JaxPyIndexer
from dynamo_tpu_torch.router import native_indexer
from dynamo_tpu_torch.router.indexer import (
    PyKvIndexer,
    indexer_impl,
    make_indexer,
)
from dynamo_tpu_torch.router.tiered_index import make_tiered_indexer


def _ops(seed: int, n: int = 1200):
    """A seeded interleaving: ("store"|"remove", worker, hashes),
    ("drop"|"clear", worker) and ("query", hashes).  Hashes are 128-bit,
    as the router's block hashes are."""
    rng = random.Random(seed)
    universe = [rng.getrandbits(128) for _ in range(400)]
    chains = [[rng.choice(universe) for _ in range(rng.randint(4, 24))]
              for _ in range(24)]
    live, out = [], []
    for _ in range(n):
        op = rng.random()
        w = rng.randrange(1, 2 ** 40) if rng.random() < 0.02 \
            else rng.randrange(6)
        if op < 0.5:
            hashes = rng.choice(chains)[:rng.randint(1, 24)]
            out.append(("store", w, hashes))
            live.append((w, hashes))
        elif op < 0.68 and live:
            w, hashes = live.pop(rng.randrange(len(live)))
            cut = rng.randint(0, len(hashes))
            out.append(("remove", w, hashes[cut:]))
        elif op < 0.72:
            out.append(("drop", w))
            live = [(lw, h) for lw, h in live if lw != w]
        elif op < 0.74:
            out.append(("clear", w))
        else:
            base = rng.choice(chains)
            q = base[:rng.randint(1, len(base))]
            if rng.random() < 0.3:
                q = q + rng.sample(universe, rng.randint(1, 4))
            out.append(("query", q))
    return out


def _apply(ix, op):
    kind = op[0]
    if kind == "store":
        ix.apply_stored(op[1], op[2])
    elif kind == "remove":
        ix.apply_removed(op[1], op[2])
    elif kind == "drop":
        ix.remove_worker(op[1])
    elif kind == "clear":
        ix.clear_worker(op[1])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_native_equals_python_and_jax_on_random_events(seed):
    ixs = [make_indexer("native"), PyKvIndexer(), JaxPyIndexer()]
    assert indexer_impl(ixs[0]) == "native"
    for op in _ops(seed):
        if op[0] != "query":
            for ix in ixs:
                _apply(ix, op)
            continue
        got = [ix.find_matches(op[1]) for ix in ixs]
        assert got[0] == got[1] == got[2]
        assert ixs[0].num_blocks == ixs[1].num_blocks == ixs[2].num_blocks
    for w in range(6):
        counts = {ix.worker_block_count(w) for ix in ixs}
        assert len(counts) == 1
    assert sorted(ixs[0].workers) == sorted(ixs[1].workers) \
        == sorted(ixs[2].workers)


@pytest.mark.parametrize("seed", [7, 8])
def test_tiered_wrapper_over_native_equals_python(seed):
    nat, py = make_tiered_indexer("native"), make_tiered_indexer("py")
    assert indexer_impl(nat) == "native" and indexer_impl(py) == "py"
    for op in _ops(seed, 600):
        if op[0] == "query":
            assert nat.find_matches(op[1]) == py.find_matches(op[1])
            assert (nat.find_matches_tiered(op[1], list(range(6)))
                    == py.find_matches_tiered(op[1], list(range(6))))
        else:
            _apply(nat, op)
            _apply(py, op)


def test_empty_and_unknown_queries():
    ix = make_indexer("native")
    assert ix.find_matches([]) == {} and ix.num_blocks == 0
    ix.apply_stored(3, [])
    ix.apply_removed(9, [1, 2])
    ix.remove_worker(9)
    assert ix.worker_block_count(9) == 0 and ix.workers == []
    ix.apply_stored(3, [2 ** 128 - 1, 0])
    assert ix.find_matches([2 ** 128 - 1, 0, 5]) == {3: 2}


def test_make_indexer_resolves_like_jax(monkeypatch):
    make_indexer("native")  # built
    assert native_indexer.is_built()
    assert indexer_impl(make_indexer()) == "native"
    monkeypatch.setenv("DYN_INDEXER", "py")
    assert indexer_impl(make_indexer()) == "py"
    monkeypatch.setattr(native_indexer, "is_built", lambda: False)
    monkeypatch.setenv("DYN_INDEXER", "auto")
    assert indexer_impl(make_indexer()) == "py"
    with pytest.raises(ValueError):
        make_indexer("gpu")


def test_a_failing_compiler_raises_with_its_output(tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'kv_indexer.cc:1: error: planted "
                   "compiler failure' >&2\nexit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_indexer, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_indexer, "_loaded", None)
    with pytest.raises(RuntimeError, match="planted compiler failure") as e:
        make_indexer("native")
    assert "exit 3" in str(e.value)
    assert not native_indexer.is_built()
    assert [p for p in os.listdir(tmp_path / "build")] == []
    # auto does not build: the Python indexer serves
    assert indexer_impl(make_indexer("auto")) == "py"
