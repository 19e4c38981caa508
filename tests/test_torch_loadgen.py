"""The port's loadgen against the JAX package's (CPU, host only).

* `synthesize` and `synthesize_diurnal` give bit-equal rows from the same
  seed and shape arguments (parametrized), `materialize_tokens` bit-equal
  token ids, and the JSONL trace round-trips (aliases included) the same
  through either package's `save_trace` / `load_trace`;
* `replay` against the port's MockerWorker (over the port's runtime)
  completes every row with the summary keys JAX's replay against JAX's
  mocker gives, session turns serialized and goodput at stated SLOs;
* the CLI's flags.
"""

import json
import uuid

import pytest

import dynamo_tpu.loadgen as jax_loadgen
import dynamo_tpu.loadgen.__main__ as jax_cli
import dynamo_tpu.mocker as jax_mocker
import dynamo_tpu.runtime as jax_runtime
import dynamo_tpu_torch.loadgen as port_loadgen
import dynamo_tpu_torch.loadgen.__main__ as port_cli
import dynamo_tpu_torch.mocker as port_mocker
import dynamo_tpu_torch.runtime as port_runtime

SIDES = {"jax": (jax_loadgen, jax_mocker, jax_runtime),
         "port": (port_loadgen, port_mocker, port_runtime)}

SYNTH = {
    "plain": dict(n_requests=20, rate_rps=4.0, input_len=256,
                  output_len=32, seed=0),
    "prefix": dict(n_requests=16, rate_rps=8.0, input_len=512,
                   output_len=32, prefix_groups=2, prefix_blocks=4,
                   seed=25),
    "sessions": dict(n_requests=6, rate_rps=50.0, input_len=64,
                     output_len=8, session_turns=3, prefix_groups=3,
                     seed=9),
}
DIURNAL = {
    "swing": dict(duration_s=20.0, rate_low_rps=0.5, rate_high_rps=5.0,
                  seed=1),
    "period": dict(duration_s=12.0, rate_low_rps=1.0, rate_high_rps=8.0,
                   period_s=6.0, input_len=128, prefix_groups=2, seed=4),
}


def _rows(rows):
    return [r.to_dict() for r in rows]


@pytest.mark.parametrize("kind,case", [("synth", c) for c in sorted(SYNTH)]
                         + [("diurnal", c) for c in sorted(DIURNAL)])
def test_traces_and_tokens_equal_jax(kind, case, tmp_path):
    out = {}
    for side, (lg, _, _) in SIDES.items():
        rows = (lg.synthesize(**SYNTH[case]) if kind == "synth"
                else lg.synthesize_diurnal(**DIURNAL[case]))
        toks = [lg.materialize_tokens(r, block_size=16, vocab_size=32000)
                for r in rows]
        path = tmp_path / f"{side}.jsonl"
        lg.save_trace(str(path), rows)
        out[side] = (_rows(rows), toks, path.read_text(),
                     _rows(lg.load_trace(str(path))))
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][3] == out["port"][0]


def test_trace_aliases_and_materialize_equal_jax(tmp_path):
    lines = [{"input_tokens": 32, "output_tokens": 4, "created_time": 1500.0,
              "hash_ids": [1, 2]},
             {"request_id": "x", "input_length": 40, "input_tokens": 7,
              "hash_ids": [9, 2]},
             {"input_length": 20, "session_id": "s", "delay_ms": 30.0},
             {"input_length": 3}]
    path = tmp_path / "alias.jsonl"
    path.write_text("".join(json.dumps(d) + "\n" for d in lines) + "\n")
    out = {}
    for side, (lg, _, _) in SIDES.items():
        rows = lg.load_trace(str(path))
        out[side] = (_rows(rows), [
            lg.materialize_tokens(r, bs, v) for r in rows
            for bs, v in ((16, 32000), (4, 256))])
    assert out["port"] == out["jax"]
    assert out["port"][0][0]["timestamp"] == 1500.0


async def _replay(side):
    lg, mocker, runtime = SIDES[side]
    rt = await runtime.DistributedRuntime(
        config=runtime.RuntimeConfig(discovery_backend="mem",
                                     event_plane="inproc"),
        cluster_id=uuid.uuid4().hex).start()
    worker = await mocker.MockerWorker(
        rt, mocker.MockEngineArgs(model_name="m", block_size=16,
                                  num_blocks=1024, speedup_ratio=50.0),
        component="backend").start()
    client = await (rt.namespace("dynamo").component("backend")
                    .endpoint("generate").client()).start()
    try:
        await client.wait_for_instances()
        rows = lg.synthesize(12, rate_rps=200.0, input_len=48, output_len=6,
                             prefix_groups=2, prefix_blocks=2, seed=3)
        s = (await lg.replay(client.generate, rows, block_size=16,
                             speedup=2.0)).summary(slo_ttft_s=30.0,
                                                   slo_itl_s=30.0)
        sess = [lg.TraceRow(request_id="s0", session_id="S",
                            input_length=32, output_length=4, timestamp=0.0),
                lg.TraceRow(request_id="s1", session_id="S",
                            input_length=16, output_length=4, delay=10.0)]
        rep = await lg.replay(client.generate, sess, block_size=16)
    finally:
        await client.close()
        await worker.close()
        await rt.shutdown()
    by = {r.request_id: r for r in rep.results}
    return s, by["s1"].start_t >= by["s0"].end_t, sorted(
        r.output_tokens for r in rep.results)


def _keys(d, prefix=""):
    return sorted(k for key, v in d.items() for k in (
        _keys(v, f"{prefix}{key}.") if isinstance(v, dict)
        else [prefix + key]))


async def test_replay_against_port_mocker_matches_jax_summary():
    js, jserial, jtoks = await _replay("jax")
    ps, pserial, ptoks = await _replay("port")
    assert _keys(ps) == _keys(js)
    for s in (ps, js):
        assert (s["requests"], s["completed"], s["errors"], s["dropped"]) \
            == (12, 12, 0, 0)
        assert s["goodput"]["good_requests"] == 12
        assert s["output_tokens_per_s"] > 0 and s["ttft_s"]["p50"] > 0
    assert pserial and jserial and ptoks == jtoks == [4, 4]


def test_loadgen_cli_takes_the_jax_flags():
    argv = ["--namespace", "pool", "--component", "mocker", "--synthesize",
            "16", "--save-trace", "/t.jsonl", "--rate", "8", "--input-len",
            "512", "--output-len", "32", "--prefix-groups", "2",
            "--prefix-blocks", "4", "--block-size", "64", "--vocab-size",
            "1000", "--speedup", "2", "--max-concurrency", "8",
            "--slo-ttft", "2.0", "--slo-itl", "0.05", "--router-mode",
            "random"]
    assert vars(port_cli.build_args().parse_args(argv)) == \
        vars(jax_cli.build_args().parse_args(argv))
