"""Pipeline parallelism: the rotating microbatch schedule over a ring of
stage ranks.

The counterpart of dynamo_tpu/parallel/pipeline.py, per rank.  There,
layer parameters and per-stage state are stacked on a leading stage axis
and sharded over the "pp" mesh axis, and one shard_map program runs
every stage, activations hopping stage to stage with `lax.ppermute`.
Here each stage is a rank (a process, or a thread in the tests) with a
ring group over the S stages (parallel/mesh.py RingGroup), and it runs
the same schedule:

  * with M microbatches the loop runs S + M - 1 ticks; at tick t stage s
    holds microbatch m = t - s when 0 <= m < M, else it is in a bubble;
  * stage 0 ingests xs[m], a later stage the activation its predecessor
    produced a tick earlier; every tick ends with one hop forward
    (`RingGroup.exchange`: the last stage's send wraps to stage 0, which
    never reads it, as JAX's permutation wraps);
  * the last stage's outputs are the results, summed over the ring so
    every rank returns them (JAX's psum; the other stages add zeros).

A bubble is where the JAX program, which cannot diverge across
devices, still runs the stage masked (`active` False, its state writes
a no-op, its output discarded).  A rank is its own program, so it skips
the bubble's stage_fn: what comes out, ys and every stage's state, is
what JAX's masked run leaves.  stage_fn is called with active True only.

The engine composes nothing with this yet, as in JAX: it is the
primitive a pipelined forward (a stage = a contiguous slice of layers,
its state that slice's KV) would run.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

# stage_fn(params_slice, state_slice, x, active) -> (y, new_state_slice):
#   the stage's slice of the stacked trees (leading axis removed), one
#   microbatch's activations x, and active (True here: bubbles are
#   skipped); y has x's shape
StageFn = Callable


def _leaves_with_path(tree, path: str = ""):
    """(keystr, leaf) of every tensor leaf of nested dicts, lists and
    tuples, in JAX's `keystr` spelling (`['w1']`, `[0]`)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(
    stage_fn: StageFn,
    params: Any,           # pytree, leaves [S, ...] (stage-stacked)
    state: Any,            # pytree, leaves [S, ...] (per-stage; may be {})
    xs: torch.Tensor,      # [M, ...] microbatches
    group,                 # parallel/mesh.py RingGroup over the S stages
) -> Tuple[torch.Tensor, Any]:
    """Run every microbatch through all S stages; this rank is stage
    `group.rank` of `group.size`.  Returns (ys [M, ...], the same on
    every rank; this stage's updated state, its slice kept stacked
    [1, ...], as JAX's program leaves each device its shard of the
    stage-stacked state).  Raises JAX's ValueError on a leaf whose
    leading dimension is not S."""
    S, sidx = group.size, group.rank
    for path, leaf in list(_leaves_with_path(params)) + \
            list(_leaves_with_path(state)):
        if tuple(leaf.shape[:1]) != (S,):
            raise ValueError(
                f"stage-stacked leaf {path} has "
                f"leading dim {leaf.shape[0] if leaf.ndim else None}, "
                f"expected the pp axis size {S}"
            )
    M = xs.shape[0]
    params = _tree_map(lambda a: a[sidx], params)
    state = _tree_map(lambda a: a[sidx], state)
    ys = torch.zeros_like(xs)
    buf = torch.zeros_like(xs[0])
    for t in range(S + M - 1):
        m = t - sidx                      # microbatch at this stage now
        y = buf
        if 0 <= m < M:
            # stage 0 ingests fresh microbatches; later stages consume
            # the activation their predecessor sent last tick
            x_in = xs[m] if sidx == 0 else buf
            y, state = stage_fn(params, state, x_in, True)
            if sidx == S - 1:
                ys[m] = y
        if S > 1:
            buf = group.exchange(y)()
    if S > 1:
        group.all_reduce(ys)
    return ys, _tree_map(lambda a: a[None], state)
