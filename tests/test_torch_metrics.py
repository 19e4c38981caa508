"""The port's metrics hierarchy against the JAX package's (CPU).

dynamo_tpu_torch/runtime/metrics.py renders the Prometheus text format
on the standard library; dynamo_tpu/runtime/metrics.py renders it with
prometheus_client.  The same sequence of inc/set/observe/remove through
both must parse (prometheus_client's own parser) to the same samples:
names, labels and values, the `_created` samples aside (the port leaves
them out).
"""

import math

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families
from prometheus_client.utils import floatToGoString

from dynamo_tpu.runtime.metrics import MetricsHierarchy as JaxMetrics
from dynamo_tpu.runtime.metrics import percentile as jax_percentile
from dynamo_tpu_torch.runtime.metrics import (
    MetricsHierarchy,
    format_value,
    percentile,
)


def _samples(text: str):
    return sorted(
        (s.name, tuple(sorted(s.labels.items())), s.value)
        for fam in text_string_to_metric_families(text)
        for s in fam.samples if not s.name.endswith("_created"))


def _families(text: str):
    return sorted((f.name, f.type, f.documentation)
                  for f in text_string_to_metric_families(text)
                  if not f.name.endswith("_created"))


def _counters_and_gauges(m):
    s = m.scoped(component="backend", endpoint="generate")
    rng = np.random.default_rng(0)
    for i in range(20):
        s.inc("dynamo_requests_total", 1.0, "requests served",
              model=f"m{i % 3}")
        s.inc("dynamo_tokens", float(rng.integers(1, 50)))
        s.set("dynamo_engine_mbu", float(rng.random()), "mbu",
              phase=("prefill", "decode", "spec_verify")[i % 3])
    s.set("dynamo_engine_kv_usage", 0.25)
    s.set("dynamo_test_big", 12345678.5, "a large value")
    s.set("dynamo_test_tiny", 1e-9)
    s.set("dynamo_test_neg", -3.5)
    s.set("dynamo_test_esc", 1.0, 'doc with \\ and "quotes"\nand a newline',
          lab='a"b\\c\nd')
    m.scoped(component="health").inc("dynamo_health_transitions_total",
                                     endpoint="dynamo/backend/generate",
                                     to="ready")


def _histograms(m):
    s = m.scoped(component="backend")
    rng = np.random.default_rng(1)
    for x in rng.exponential(0.01, 200):
        s.observe("dynamo_trace_span_seconds", float(x), "spans",
                  kind=("step", "sched")[int(x * 1e4) % 2])
    h = s.histogram("dynamo_engine_compile_seconds", "compiles",
                    ("family",), buckets=(0.01, 0.05, 0.1, 1.0, 60.0))
    for fam, x in (("decode", 0.02), ("decode", 3.0), ("prefill", 100.0)):
        h.labels(**s.labels, family=fam).observe(x)
    s.histogram("dynamo_test_declared_only", "no samples", ("x",))


def _removals(m):
    s = m.scoped(component="router")
    for w in range(5):
        s.set("dynamo_router_worker_load", float(w), worker=str(w))
    s.remove("dynamo_router_worker_load", worker="2")
    s.remove("dynamo_router_worker_load", worker="99")  # absent: no-op
    s.remove("dynamo_test_never_defined")
    s.set("dynamo_test_plain", 4.0)
    s.remove("dynamo_test_plain")
    s.inc("dynamo_test_after_remove_total", 2.0)


@pytest.mark.parametrize("drive", [_counters_and_gauges, _histograms,
                                   _removals])
def test_render_parses_to_the_jax_samples(drive):
    renders = []
    for cls in (JaxMetrics, MetricsHierarchy):
        m = cls(namespace="dynamo")
        drive(m)
        renders.append(m.render().decode())
    jax_text, port_text = renders
    assert _samples(port_text) == _samples(jax_text)
    assert _families(port_text) == _families(jax_text)
    assert "_created" not in port_text


def test_label_mismatch_and_negative_counter_raise_as_jax():
    for cls in (JaxMetrics, MetricsHierarchy):
        m = cls()
        m.set("dynamo_test_g", 1.0, tier="g1")
        with pytest.raises(ValueError, match="already defined"):
            m.set("dynamo_test_g", 1.0, other="x")
        with pytest.raises(ValueError):
            m.inc("dynamo_test_c", -1.0)
        with pytest.raises(ValueError):
            # the hierarchy's own labels missing
            m.gauge("dynamo_test_g", "", ("tier",)).labels(tier="g1")


def test_value_formatting_is_prometheus_clients():
    values = [0.0, 1.0, -1.0, 0.1, 1e-9, 3.25, 123456.0, 1234567.0,
              12345678.5, 1e20, -1e20, float("inf"), float("-inf"),
              float("nan"), 2.5e-5, 7.0e6]
    assert [format_value(v) for v in values] \
        == [floatToGoString(v) for v in values]


def test_percentile_equals_jax():
    rng = np.random.default_rng(3)
    xs = list(rng.normal(size=101))
    for q in (0.0, 50.0, 95.0, 99.9, 100.0):
        assert percentile(xs, q) == jax_percentile(xs, q)
    assert percentile([], 50.0) == jax_percentile([], 50.0) == 0.0
    assert math.isfinite(percentile(xs, 95.0))
