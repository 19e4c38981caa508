"""Hierarchical Prometheus metrics, a copy of dynamo_tpu/runtime/metrics.py
on the standard library.

Every metric created through a MetricsHierarchy is auto-labeled with
namespace/component/endpoint, so dashboards aggregate across the
deployment without per-callsite label plumbing.  The JAX module keeps its
metrics in prometheus_client, which the machines the port serves on do
not have; this module keeps the same families (counters, gauges,
histograms with labeled children) and renders them in the Prometheus
text exposition format, version 0.0.4, as prometheus_client's
`generate_latest` does: the same metric names, `_total` suffixes, label
sets, histogram buckets and `_bucket`/`_count`/`_sum` samples, values
formatted as Go's.  The `_created` samples are left out (they carry the
creation time, which no reader here uses).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
INF = float("inf")
# prometheus_client's default histogram buckets
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0, INF)


def percentile(xs: Sequence[float], q: float) -> float:
    """Shared percentile (q in [0, 100], numpy linear interpolation) so
    profiler sweeps and loadgen reports are comparable on the same data."""
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def format_value(d: float) -> str:
    """A sample value as the exposition format writes it (Go's float
    formatting, as prometheus_client's floatToGoString)."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _labels_text(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    return "{" + ",".join(f'{n}="{_escape_label(v)}"'
                          for n, v in zip(names, values)) + "}"


class _Child:
    """One labeled sample set of a family."""

    __slots__ = ("_family", "_value", "_buckets", "_sum")

    def __init__(self, family: "_Family"):
        self._family = family
        self._value = 0.0
        if family.kind == "histogram":
            self._buckets = [0.0] * len(family.buckets)
            self._sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if self._family.kind == "counter" and amount < 0:
            raise ValueError("Counters can only be incremented by "
                             "non-negative amounts.")
        with self._family.lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        with self._family.lock:
            self._value = float(value)

    def observe(self, amount: float) -> None:
        f = self._family
        with f.lock:
            self._sum += amount
            for i, bound in enumerate(f.buckets):
                if amount <= bound:
                    self._buckets[i] += 1.0
                    break


class _Family:
    """A metric family: its name, documentation, kind, label names and
    labeled children, in the order they were first used."""

    def __init__(self, kind: str, name: str, doc: str,
                 labelnames: Sequence[str], lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        if kind == "counter" and name.endswith("_total"):
            name = name[:-len("_total")]
        self.kind = kind
        self.name = name
        self.doc = doc
        self._labelnames = tuple(labelnames)
        self.lock = lock
        if kind == "histogram":
            bs = sorted(float(b) for b in (buckets or DEFAULT_BUCKETS))
            if bs[-1] != INF:
                bs.append(INF)
            self.buckets = tuple(bs)
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def labels(self, *values, **kw) -> _Child:
        if kw:
            if values or set(kw) != set(self._labelnames):
                raise ValueError("Incorrect label names")
            values = tuple(kw[n] for n in self._labelnames)
        elif len(values) != len(self._labelnames):
            raise ValueError("Incorrect label count")
        key = tuple(str(v) for v in values)
        with self.lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
        return child

    def remove(self, *values) -> None:
        key = tuple(str(v) for v in values)
        with self.lock:
            del self._children[key]

    def render(self, out: List[str]) -> None:
        shown = f"{self.name}_total" if self.kind == "counter" else self.name
        out.append(f"# HELP {shown} {_escape_help(self.doc)}")
        out.append(f"# TYPE {shown} {self.kind}")
        names = self._labelnames
        with self.lock:
            children = [(k, c._value,
                         list(getattr(c, "_buckets", ())),
                         getattr(c, "_sum", 0.0))
                        for k, c in self._children.items()]
        for key, value, buckets, total in children:
            if self.kind != "histogram":
                out.append(f"{shown}{_labels_text(names, key)} "
                           f"{format_value(value)}")
                continue
            acc = 0.0
            for bound, n in zip(self.buckets, buckets):
                acc += n
                out.append(f"{self.name}_bucket"
                           f"{_labels_text(names + ('le',), key + (format_value(bound),))}"
                           f" {format_value(acc)}")
            out.append(f"{self.name}_count{_labels_text(names, key)} "
                       f"{format_value(acc)}")
            out.append(f"{self.name}_sum{_labels_text(names, key)} "
                       f"{format_value(total)}")


class CollectorRegistry:
    """The families of one process (or one test), in registration order."""

    def __init__(self):
        self.lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def register(self, family: _Family) -> None:
        if family.name in self._families:
            raise ValueError(f"Duplicated timeseries in CollectorRegistry: "
                             f"{family.name}")
        self._families[family.name] = family

    def render(self) -> bytes:
        out: List[str] = []
        for fam in list(self._families.values()):
            fam.render(out)
        return ("\n".join(out) + "\n").encode() if out else b""


class MetricsHierarchy:
    _HIER_LABELS = ("dynamo_namespace", "dynamo_component", "dynamo_endpoint")

    def __init__(self, registry: Optional[CollectorRegistry] = None,
                 namespace: str = "", component: str = "", endpoint: str = ""):
        self.registry = registry if registry is not None else CollectorRegistry()
        self.labels = {
            "dynamo_namespace": namespace,
            "dynamo_component": component,
            "dynamo_endpoint": endpoint,
        }
        self._metrics: Dict[str, _Family] = {}

    def scoped(self, namespace: str = "", component: str = "",
               endpoint: str = "") -> "MetricsHierarchy":
        child = MetricsHierarchy(
            registry=self.registry,
            namespace=namespace or self.labels["dynamo_namespace"],
            component=component or self.labels["dynamo_component"],
            endpoint=endpoint or self.labels["dynamo_endpoint"],
        )
        child._metrics = self._metrics  # share metric objects, differ in labels
        return child

    def _get(self, kind: str, name: str, doc: str, extra: Sequence[str] = (),
             buckets=None) -> _Family:
        # metric names are unique per registry; a second callsite with a
        # different extra-label set is a definition error, surfaced here
        # rather than as a late .labels() ValueError
        m = self._metrics.get(name)
        if m is None:
            m = _Family(kind, name, doc,
                        list(self._HIER_LABELS) + list(extra),
                        self.registry.lock, buckets)
            self.registry.register(m)
            self._metrics[name] = m
        else:
            want = tuple(self._HIER_LABELS) + tuple(extra)
            if tuple(m._labelnames) != want:
                raise ValueError(
                    f"metric {name!r} already defined with labels "
                    f"{m._labelnames}, requested {want}"
                )
        return m

    def counter(self, name: str, doc: str = "", extra: Sequence[str] = ()):
        return self._get("counter", name, doc, extra)

    def gauge(self, name: str, doc: str = "", extra: Sequence[str] = ()):
        return self._get("gauge", name, doc, extra)

    def histogram(self, name: str, doc: str = "", extra: Sequence[str] = (),
                  buckets=None):
        return self._get("histogram", name, doc, extra, buckets or None)

    def inc(self, name: str, value: float = 1.0, doc: str = "", **extra) -> None:
        self.counter(name, doc, tuple(extra.keys())).labels(
            **self.labels, **extra
        ).inc(value)

    def set(self, name: str, value: float, doc: str = "", **extra) -> None:
        self.gauge(name, doc, tuple(extra.keys())).labels(
            **self.labels, **extra
        ).set(value)

    def observe(self, name: str, value: float, doc: str = "", **extra) -> None:
        self.histogram(name, doc, tuple(extra.keys())).labels(
            **self.labels, **extra
        ).observe(value)

    def remove(self, name: str, **extra) -> None:
        """Drop one labeled sample from an existing family (a departed
        worker's gauge: a stale label would otherwise freeze its last
        value into every future scrape); with no extra labels it drops
        this hierarchy's own sample of a plain family.  No-op when the
        family or sample doesn't exist."""
        m = self._metrics.get(name)
        if m is None:
            return
        try:
            m.remove(*self.labels.values(), *extra.values())
        except KeyError:
            pass

    def render(self) -> bytes:
        return self.registry.render()
