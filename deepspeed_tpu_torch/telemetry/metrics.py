"""Metrics registry: labeled counters / gauges / fixed-bucket histograms.

Copied from the JAX package's ``telemetry/metrics.py`` (which imports no
JAX): one registry per engine holds serving metrics as first-class
objects.  :class:`CounterDictView` is the dict-shaped facade the JAX
engine's ``timings`` is; the port's engine keeps a plain dict for its
``timings`` and registers the request-lifecycle histograms and counters
of :class:`~deepspeed_tpu_torch.telemetry.lifecycle.RequestTracker` and
its health gauge here.  The exposition (Prometheus text, JSONL, the
monitor fan-out and the text parser), pull-based gauges and the
registry's snapshot are not ported yet (ROADMAP Queue 1 item 5, host
layers).

Everything here is plain host-side arithmetic with no device tensors: a
metric update must never trigger a sync.  Single-writer by design: the
serving loop is single-threaded, so there are no locks on the update
path.
"""

from __future__ import annotations

import bisect
from typing import (Any, Dict, Iterator, List, MutableMapping, Optional,
                    Sequence, Tuple)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    """Float formatting matching Prometheus conventions (ints bare)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Metric:
    """Base: one named metric holding one series per label set."""
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> Iterator[Tuple[LabelKey, float]]:
        if not self._values:
            yield (), 0.0
            return
        for k in sorted(self._values):
            yield k, self._values[k]

    def reset(self) -> None:
        self._values = {}


class Counter(Metric):
    """Monotonic accumulator.  ``int_valued`` marks token/step counts so
    the :class:`CounterDictView` façade hands back true ints."""
    kind = "counter"

    def __init__(self, name: str, help: str = "", int_valued: bool = False):
        super().__init__(name, help)
        self.int_valued = int_valued

    def inc(self, amount: float = 1, **labels) -> None:
        k = _label_key(labels)
        self._values[k] = self._values.get(k, 0.0) + amount

    def _set(self, value: float, **labels) -> None:
        """Back-compat escape hatch for the dict view (``tm[k] = 0``);
        counters are otherwise inc-only."""
        self._values[_label_key(labels)] = value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        k = _label_key(labels)
        self._values[k] = self._values.get(k, 0.0) + amount


class Histogram(Metric):
    """Fixed-bucket histogram (cumulative ``le`` buckets, Prometheus
    semantics).  Bucket bounds are chosen at registration — observation
    is one bisect + three adds, no allocation."""
    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = ""):
        super().__init__(name, help)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"{name}: buckets must be sorted and "
                             f"non-empty, got {buckets!r}")
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        # per label set: [count per bucket + overflow], sum, count
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        counts = self._counts.get(k)
        if counts is None:
            counts = self._counts[k] = [0] * (len(self.buckets) + 1)
            self._sums[k] = 0.0
            self._totals[k] = 0
        counts[bisect.bisect_left(self.buckets, value)] += 1
        self._sums[k] += value
        self._totals[k] += 1

    def count(self, **labels) -> int:
        return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def mean(self, **labels) -> float:
        n = self.count(**labels)
        return self.sum(**labels) / n if n else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Bucket-resolution quantile estimate (linear interpolation
        inside the winning bucket; the overflow bucket reports its lower
        bound — the histogram cannot see past its last edge)."""
        k = _label_key(labels)
        counts = self._counts.get(k)
        total = self._totals.get(k, 0)
        if not counts or not total:
            return 0.0
        target = q * total
        cum = 0
        lo = 0.0
        for i, upper in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= target:
                frac = (target - prev) / max(counts[i], 1)
                return lo + (upper - lo) * min(1.0, frac)
            lo = upper
        return self.buckets[-1]

    def bucket_counts(self, **labels) -> Dict[str, int]:
        """Cumulative counts keyed by ``le`` edge (``+Inf`` last)."""
        k = _label_key(labels)
        counts = self._counts.get(k, [0] * (len(self.buckets) + 1))
        out: Dict[str, int] = {}
        cum = 0
        for i, upper in enumerate(self.buckets):
            cum += counts[i]
            out[_fmt(upper)] = cum
        out["+Inf"] = cum + counts[-1]
        return out

    def series(self) -> Iterator[Tuple[LabelKey, float]]:
        for k in sorted(self._counts) or [()]:
            yield k, float(self._totals.get(k, 0))

    def summary(self, **labels) -> Dict[str, Any]:
        return {"count": self.count(**labels),
                "sum": round(self.sum(**labels), 6),
                "mean": round(self.mean(**labels), 6),
                "p50": round(self.percentile(0.50, **labels), 6),
                "p90": round(self.percentile(0.90, **labels), 6),
                "p99": round(self.percentile(0.99, **labels), 6),
                "buckets": self.bucket_counts(**labels)}

    def reset(self) -> None:
        self._counts = {}
        self._sums = {}
        self._totals = {}


class MetricsRegistry:
    """Ordered name -> metric table with get-or-create registration."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    # ------------------------------------------------------------------
    def _register(self, name: str, factory, kind: str) -> Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise ValueError(f"metric {name!r} already registered "
                                 f"as {m.kind}, requested {kind}")
            return m
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                int_valued: bool = False) -> Counter:
        return self._register(
            name, lambda: Counter(name, help, int_valued), "counter")

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(name, lambda: Gauge(name, help), "gauge")

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        return self._register(
            name, lambda: Histogram(name, buckets, help), "histogram")

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def __iter__(self) -> Iterator[Metric]:
        return iter(self._metrics.values())

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def reset(self) -> None:
        """Zero every metric (registrations and bucket layouts stay)."""
        for m in self._metrics.values():
            m.reset()

class CounterDictView(MutableMapping):
    """Dict-shaped façade over registry counters.

    ``engine.timings`` was a plain accumulator dict; it is now this view
    over first-class registry counters, so ``tm["stage_ms"] += dt`` and
    ``dict(engine.timings)`` keep working while ``engine.metrics`` holds
    the same numbers for Prometheus/JSONL export.  Int-valued counters
    (steps, token counts) read back as true ints."""

    def __init__(self, counters: Dict[str, Counter]):
        self._counters = dict(counters)

    def __getitem__(self, key: str):
        c = self._counters[key]
        v = c.value()
        return int(v) if c.int_valued else v

    def __setitem__(self, key: str, value) -> None:
        self._counters[key]._set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("engine.timings keys are fixed; "
                        "register new metrics on engine.metrics instead")

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __repr__(self) -> str:
        return f"CounterDictView({dict(self)!r})"

    def reset(self) -> None:
        for c in self._counters.values():
            c.reset()
