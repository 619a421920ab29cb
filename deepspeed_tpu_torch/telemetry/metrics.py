"""Metrics registry: counters, gauges, fixed-bucket histograms.

Copied from the JAX package's ``telemetry/metrics.py`` (which imports no
JAX).  One registry instance per engine holds every serving (or
training) metric as a first-class object: the engine's ``timings`` is a
:class:`CounterDictView` facade over these counters, so callers keep
their dict while new code reads the registry.

Exports:

* :meth:`MetricsRegistry.prometheus_text` -- Prometheus text exposition
  (:func:`parse_prometheus_text` is the matching parser).
* :meth:`MetricsRegistry.write_jsonl` -- one JSON snapshot line appended
  per call.
* :meth:`MetricsRegistry.publish` -- fan out through the ``monitor/``
  writer interface (:class:`deepspeed_tpu_torch.monitor.Monitor`), so
  serving metrics and training scalars share one pipeline.

Everything here is plain host-side arithmetic with no device tensors (a
metric update must never trigger a sync).  Single-writer by design: the
serving loop and the training step are single-threaded, so there are
no locks on the update path.
"""

from __future__ import annotations

import bisect
import json
import re
import time
from typing import (Any, Dict, Iterator, List, MutableMapping, Optional,
                    Sequence, Tuple)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    if not labels:
        return ()       # the serving loop's timings carry no labels
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Prometheus-legal metric name (``Train/loss`` -> ``Train_loss``)."""
    safe = _NAME_SANITIZE.sub("_", name)
    return "_" + safe if safe[:1].isdigit() else safe


def _prom_label_str(key: LabelKey) -> str:
    if not key:
        return ""
    parts = []
    for k, v in key:
        v = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{_prom_name(k)}="{v}"')
    return "{" + ",".join(parts) + "}"


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


class FnGauge(Gauge):
    """Pull-based gauge: its value is computed by a zero-arg callable at
    *read/export* time (snapshot / Prometheus exposition / monitor
    fan-out), so the measured subsystem never pays an update on its hot
    path and a scrape always sees the current truth.  The callable
    returns a number, or ``None`` for "no sample right now" — the gauge
    is then ABSENT from the exposition (the contract device telemetry
    uses for probes a backend does not support: absent, never fake).
    Exceptions from the callable also read as absent (a gauge must
    never take the exporter down), ``set()`` raises (there is nothing
    to set), and ``reset()`` is a no-op (the source owns the state)."""
    kind = "gauge"

    def __init__(self, name: str, fn, help: str = ""):
        super().__init__(name, help)
        self._fn = fn

    def value(self, **labels) -> float:
        v = self._read()
        return 0.0 if v is None else v

    def _read(self) -> Optional[float]:
        try:
            v = self._fn()
        except Exception:  # tpulint: disable=silent-except — a broken probe reads as an absent sample, never an export crash
            return None
        return None if v is None else float(v)

    def series(self) -> Iterator[Tuple[LabelKey, float]]:
        v = self._read()
        if v is not None:
            yield (), v

    def set(self, value: float, **labels) -> None:
        raise TypeError(f"{self.name} is a pull-based FnGauge; "
                        "its source computes the value")

    def inc(self, amount: float = 1, **labels) -> None:
        raise TypeError(f"{self.name} is a pull-based FnGauge; "
                        "its source computes the value")

    def reset(self) -> None:
        pass                    # the source owns the state


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

    def gauge_fn(self, name: str, fn, help: str = "") -> FnGauge:
        """Register a pull-based gauge computed by ``fn()`` at read
        time (:class:`FnGauge`); re-registering rebinds the callable
        (an engine rebuilt over the same registry must not read a dead
        object's state).  A name already held by a PLAIN gauge raises —
        silently dropping the callable would freeze the metric."""
        g = self._register(name, lambda: FnGauge(name, fn, help), "gauge")
        if not isinstance(g, FnGauge):
            raise ValueError(
                f"metric {name!r} already registered as a set-based "
                "gauge; gauge_fn cannot rebind it to a callable")
        g._fn = fn
        return g

    def histogram(self, name: str, buckets: Sequence[float],
                  help: str = "") -> Histogram:
        return self._register(
            name, lambda: Histogram(name, buckets, help), "histogram")

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def series_sum(self, name: str) -> float:
        """Sum of a metric's value across ALL its label sets — the
        scalar a dashboard wants from a labeled counter (e.g. total
        scale-ups regardless of ``pool=``).  0.0 for an unknown name or
        an empty metric; histograms sum their observation totals (the
        ``_count`` a Prometheus ``sum()`` over buckets would yield)."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        if isinstance(m, Histogram):
            return float(sum(m._totals.values()))
        if not m._values and not isinstance(m, FnGauge):
            # Metric.series() yields a synthetic ((), 0.0) placeholder
            # for empty metrics; the SUM of nothing is a plain 0.0
            return 0.0
        return float(sum(v for _, v in m.series()))

    def __iter__(self) -> Iterator[Metric]:
        return iter(self._metrics.values())

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def reset(self) -> None:
        """Zero every metric (registrations and bucket layouts stay)."""
        for m in self._metrics.values():
            m.reset()

    # ------------------------------------------------------------------
    # snapshots / export
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: scalar metrics map to their value (or a
        ``{label_str: value}`` dict when labeled), histograms to a
        summary with cumulative bucket counts."""
        out: Dict[str, Any] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                if not m._counts:
                    out[name] = m.summary()
                elif list(m._counts) == [()]:
                    out[name] = m.summary()
                else:
                    out[name] = {
                        _prom_label_str(k) or "{}": {
                            "count": m._totals[k],
                            "sum": round(m._sums[k], 6)}
                        for k in sorted(m._counts)}
                continue
            vals = dict(m.series())
            if not vals:
                # a pull-based gauge with no current sample (FnGauge
                # returning None — e.g. memory_stats on a backend
                # without them) is ABSENT, not zero
                continue
            if list(vals) == [()]:
                v = vals[()]
                out[name] = int(v) if getattr(m, "int_valued", False) \
                    else round(v, 6)
            else:
                out[name] = {_prom_label_str(k) or "{}": round(v, 6)
                             for k, v in vals.items()}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Histogram):
                keys = sorted(m._counts) or [()]
                for k in keys:
                    for le, cum in m.bucket_counts(
                            **dict(k)).items():
                        lk = _prom_label_str(k + (("le", le),))
                        lines.append(f"{pname}_bucket{lk} {cum}")
                    ls = _prom_label_str(k)
                    lines.append(f"{pname}_sum{ls} "
                                 f"{_fmt(m._sums.get(k, 0.0))}")
                    lines.append(f"{pname}_count{ls} "
                                 f"{m._totals.get(k, 0)}")
            else:
                for k, v in m.series():
                    lines.append(f"{pname}{_prom_label_str(k)} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def write_jsonl(self, path: str, step: Optional[int] = None) -> None:
        """Append one snapshot line (``{"time", "step"?, "metrics"}``)."""
        rec: Dict[str, Any] = {"time": time.time(),
                               "metrics": self.snapshot()}
        if step is not None:
            rec["step"] = step
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------------
    # monitor fan-out
    # ------------------------------------------------------------------
    def scalar_events(self, step: int) -> List[Tuple[str, float, int]]:
        """(name, value, step) scalar triples in the ``monitor/`` event
        shape: counters/gauges as-is (labels suffixed into the name),
        histograms as ``_count`` / ``_sum`` / ``_p50``."""
        events: List[Tuple[str, float, int]] = []
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                for k in sorted(m._counts) or [()]:
                    suffix = _prom_label_str(k)
                    lb = dict(k)
                    events.append((f"{name}{suffix}_count",
                                   float(m.count(**lb)), step))
                    events.append((f"{name}{suffix}_sum",
                                   m.sum(**lb), step))
                    events.append((f"{name}{suffix}_p50",
                                   m.percentile(0.5, **lb), step))
            else:
                for k, v in m.series():
                    events.append((f"{name}{_prom_label_str(k)}",
                                   float(v), step))
        return events

    def publish(self, monitor, step: int) -> None:
        """Fan the current values out through a ``monitor/`` writer
        (Monitor/MonitorMaster ``write_events`` interface) — serving
        metrics and training scalars ride the same CSV/TensorBoard/
        WandB pipeline."""
        if monitor is None:
            return
        monitor.write_events(self.scalar_events(step))


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


# --------------------------------------------------------------------------
# exposition parser (round-trip testing / scrape tooling)
# --------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse text exposition back into
    ``{name: {"type": kind, "samples": {label_key: value}}}`` —
    histogram ``_bucket``/``_sum``/``_count`` samples fold back under
    their base metric name."""
    out: Dict[str, Dict[str, Any]] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            types[name] = kind.strip()
            out.setdefault(name, {"type": kind.strip(), "samples": {}})
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name = m.group("name")
        labels: LabelKey = ()
        if m.group("labels"):
            labels = tuple(sorted(
                (k, v.replace('\\"', '"').replace("\\n", "\n")
                 .replace("\\\\", "\\"))
                for k, v in _LABEL_RE.findall(m.group("labels"))))
        value = float(m.group("value"))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[:-len(suffix)] if name.endswith(suffix) else None
            if stem and types.get(stem) == "histogram":
                base = stem
                break
        rec = out.setdefault(base, {"type": types.get(base, "untyped"),
                                    "samples": {}})
        rec["samples"][(name, labels)] = value
    return out
