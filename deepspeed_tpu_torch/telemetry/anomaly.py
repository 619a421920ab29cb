"""Streaming anomaly detection over per-step telemetry signals
(docs/OBSERVABILITY.md "Anomaly detection & deep capture").

The tracer and the metrics made the serving loop *observable*, and
device telemetry the device — but nothing watched those streams live: a latency
regression, retrace storm, or KV-pool leak was only discovered after
the fact by benchdiff or a crash dump.  This module is the watcher:
cheap streaming detectors the engines feed once per step with values
they already computed (no added clock reads), each firing a structured
:class:`AnomalyEvent` that the engine notes into the flight recorder,
counts (``serving_anomalies_total{signal=...}``), surfaces through
``engine.health()``, and — rate-limited — uses to arm a deep-capture
window (telemetry/profiler.py).

Three detector shapes, all **deterministic**: a detector consumes the
values it is fed and the integer step index, never a clock, so unit
tests drive them with a fake step counter and fixed value streams.

* :class:`EwmaMadDetector` — rolling median/MAD firing + EWMA trend;
  fires on ``|z| > z_threshold`` in the configured direction, where z
  is measured against the window MEDIAN (Hampel-style).  The robust
  default for latency-shaped signals (step interval, device ms, wait
  ms, TTFT/TPOT): the median ignores the compile-gap outliers that
  would drag a mean, the MAD ignores the spike it is about to flag,
  and the scale floor keeps a near-constant stream (MAD 0) from
  firing on noise.
* :class:`RollingPercentileDetector` — fires when a value leaves the
  rolling window's [q_low, q_high] band by a margin ratio.  The right
  shape for bounded rates (prefix hit rate, spec acceptance) where a
  *collapse* is the anomaly and absolute z-scores mean little.
* :class:`ThresholdDetector` — fires when a value crosses a fixed
  limit.  For signals where ANY occurrence is the anomaly (a runtime
  retrace after warmup).

:class:`AnomalyMonitor` owns the per-signal detector table, the
cooldown ledger (a fired signal is suppressed for ``cooldown``
subsequent samples — a pathological workload must not fire per step),
the bounded event ring, and the sustained-anomaly window
``engine.health()`` consults.  Everything here is host-side floats and
deques — no JAX imports, no device work (the telemetry/ contract).

Copied from the JAX package's ``telemetry/anomaly.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional, Tuple

# MAD -> sigma for a normal distribution; the usual robust-scale factor
_MAD_SIGMA = 1.4826


@dataclasses.dataclass
class AnomalyConfig:
    """Knobs shared by the default detector catalog and the monitor.

    ``warmup``: samples a detector must see before it may fire (the
    baseline is meaningless earlier).  ``window``: rolling-window length
    for MAD / percentile scale estimates.  ``ewma_alpha``: baseline
    smoothing.  ``z_threshold``: robust z-score a sample must exceed.
    ``cooldown``: per-signal samples suppressed after a fire.
    ``sustained_count`` within ``sustained_window`` steps flips
    ``engine.health()`` to degraded.  ``max_captures``: anomaly-armed
    deep-capture budget per engine (``reset_metrics`` rearms it);
    ``capture_steps``: length of each anomaly-armed capture window."""
    warmup: int = 16
    window: int = 64
    ewma_alpha: float = 0.05
    z_threshold: float = 8.0
    # relative + absolute floors under the MAD scale estimate: a
    # near-constant stream (MAD ~ 0) must not turn float jitter into
    # infinite z-scores
    min_scale_frac: float = 0.05
    min_scale: float = 1e-3
    cooldown: int = 32
    sustained_count: int = 3
    sustained_window: int = 128
    max_captures: int = 2
    capture_steps: int = 4


@dataclasses.dataclass
class AnomalyEvent:
    """One fired detector: what was observed vs. what the baseline
    promised, and how far out it was (robust z-score, or the band ratio
    for percentile detectors)."""
    signal: str
    step: int
    observed: float
    baseline: float
    score: float
    detector: str
    direction: str

    def as_dict(self) -> Dict[str, Any]:
        return {"signal": self.signal, "step": self.step,
                "observed": round(self.observed, 6),
                "baseline": round(self.baseline, 6),
                "score": round(self.score, 3),
                "detector": self.detector,
                "direction": self.direction}


class EwmaMadDetector:
    """EWMA trend + rolling median/MAD firing; fires on robust z-score.

    The *firing* reference is the rolling-window MEDIAN with a MAD
    scale (the Hampel shape): a few huge outliers — the compile gaps
    every serving engine's first steps contain — cannot poison it the
    way they drag a mean/EWMA, so a genuine 250 ms stall still reads
    as a spike against a 3 ms median even when the window remembers a
    15 s compile.  The EWMA is maintained as the smoothed trend
    (:attr:`baseline` — what dashboards want to plot), not the firing
    reference.  The score is computed against the window *before* the
    sample enters it, so one spike cannot hide itself; it does enter
    afterwards, which (with the cooldown upstream) naturally de-arms
    the detector while a shifted regime establishes a new normal."""

    kind = "ewma_mad"

    def __init__(self, warmup: int = 16, alpha: float = 0.05,
                 window: int = 64, z_threshold: float = 8.0,
                 direction: str = "high", min_scale_frac: float = 0.05,
                 min_scale: float = 1e-3):
        if direction not in ("high", "low", "both"):
            raise ValueError(f"direction={direction!r}")
        self.warmup = max(2, int(warmup))
        self.alpha = float(alpha)
        self.z_threshold = float(z_threshold)
        self.direction = direction
        self.min_scale_frac = float(min_scale_frac)
        self.min_scale = float(min_scale)
        self._win: Deque[float] = deque(maxlen=max(4, int(window)))
        self.reset()

    def reset(self) -> None:
        self._ewma: Optional[float] = None
        self._n = 0
        self._win.clear()

    @property
    def baseline(self) -> Optional[float]:
        """The EWMA trend (plot this; firing uses the median)."""
        return self._ewma

    def _center_scale(self) -> Tuple[float, float]:
        """Rolling median + floored MAD scale.  Both floors key off
        the MEDIAN, not the EWMA: a compile-gap-inflated trend must
        not inflate the band a real stall has to clear."""
        vals = sorted(self._win)
        n = len(vals)
        med = vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1]
                                                + vals[n // 2])
        dev = sorted(abs(v - med) for v in vals)
        mad = dev[n // 2] if n % 2 else 0.5 * (dev[n // 2 - 1]
                                               + dev[n // 2])
        return med, max(mad * _MAD_SIGMA, abs(med) * self.min_scale_frac,
                        self.min_scale)

    def observe(self, value: float) -> Optional[Tuple[float, float]]:
        """Feed one sample; returns ``(baseline, score)`` when the
        detector fires (baseline = the rolling median compared
        against), else None.  Always updates state — a cooldown
        upstream must not freeze the reference."""
        value = float(value)
        fired = None
        if self._n >= self.warmup and self._win:
            med, scale = self._center_scale()
            z = (value - med) / scale
            out = (z if self.direction == "high"
                   else -z if self.direction == "low" else abs(z))
            if out > self.z_threshold:
                fired = (med, z)
        self._n += 1
        self._ewma = value if self._ewma is None else \
            self._ewma + self.alpha * (value - self._ewma)
        self._win.append(value)
        return fired


class RollingPercentileDetector:
    """Fires when a sample leaves the rolling window's percentile band
    by ``ratio``: ``value > ratio * pct(q_high)`` (direction high) or
    ``value < pct(q_low) / ratio`` (direction low).  The score is the
    band-exceedance ratio."""

    kind = "rolling_pct"

    def __init__(self, warmup: int = 16, window: int = 64,
                 q: float = 0.95, ratio: float = 2.0,
                 direction: str = "low"):
        if direction not in ("high", "low"):
            raise ValueError(f"direction={direction!r}")
        self.warmup = max(2, int(warmup))
        self.q = float(q)
        self.ratio = float(ratio)
        self.direction = direction
        self._win: Deque[float] = deque(maxlen=max(4, int(window)))
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._win.clear()

    def _pct(self, q: float) -> float:
        vals = sorted(self._win)
        i = min(len(vals) - 1, max(0, int(q * (len(vals) - 1))))
        return vals[i]

    def observe(self, value: float) -> Optional[Tuple[float, float]]:
        value = float(value)
        fired = None
        if self._n >= self.warmup and self._win:
            if self.direction == "high":
                edge = self._pct(self.q)
                if value > self.ratio * edge and value > 0:
                    fired = (edge, value / max(edge, 1e-12))
            else:
                edge = self._pct(1.0 - self.q)
                if value * self.ratio < edge:
                    fired = (edge, edge / max(value, 1e-12))
        self._n += 1
        self._win.append(value)
        return fired


class ThresholdDetector:
    """Fires whenever a sample crosses a fixed ``limit`` (after
    ``warmup`` samples); the degenerate detector for signals where any
    occurrence IS the anomaly — e.g. the per-step runtime-retrace
    delta, whose healthy value is exactly zero."""

    kind = "threshold"

    def __init__(self, limit: float = 0.0, warmup: int = 0,
                 direction: str = "high"):
        if direction not in ("high", "low"):
            raise ValueError(f"direction={direction!r}")
        self.limit = float(limit)
        self.warmup = int(warmup)
        self.direction = direction
        self.reset()

    def reset(self) -> None:
        self._n = 0

    def observe(self, value: float) -> Optional[Tuple[float, float]]:
        value = float(value)
        fired = None
        if self._n >= self.warmup:
            if (value > self.limit if self.direction == "high"
                    else value < self.limit):
                fired = (self.limit, value - self.limit)
        self._n += 1
        return fired


def default_serving_detectors(cfg: AnomalyConfig) -> Dict[str, object]:
    """The serving-engine signal catalog (docs/OBSERVABILITY.md lists
    what each watches for).  All values are fed from timestamps and
    counters the loop already takes — enabling detection adds no clock
    reads to a warm step."""
    def lat(**kw):
        return EwmaMadDetector(
            warmup=cfg.warmup, alpha=cfg.ewma_alpha, window=cfg.window,
            z_threshold=cfg.z_threshold,
            min_scale_frac=cfg.min_scale_frac, min_scale=cfg.min_scale,
            **kw)

    return {
        # host stall / GC pause / injected latency spike: the gap
        # between consecutive dispatches
        "step_interval_ms": lat(direction="high"),
        # the device step itself got slower (shape drift, thermal
        # throttle, a losing autotune config)
        "step_device_ms": lat(direction="high"),
        # the host blocked longer on the collected step's readiness
        "step_wait_ms": lat(direction="high"),
        # schedule+stage host work per step (the depth-2 pipeline's
        # whole point is keeping this off the critical path)
        "step_host_ms": lat(direction="high"),
        "ttft_ms": lat(direction="high"),
        "tpot_ms": lat(direction="high"),
        # any runtime retrace after warmup is a storm signal (the
        # dynamic complement of tpulint's static retrace rule)
        "retrace": ThresholdDetector(limit=0.0, warmup=1),
        # KV-pool growth burst: referenced-block delta far above the
        # workload's baseline.  The scale floor is 8 whole blocks —
        # block counts are small integers and ordinary prefill
        # admissions grow the pool by a few per step, which must not
        # read as z=inf against a near-zero MAD
        "kv_referenced_delta": EwmaMadDetector(
            warmup=2 * cfg.warmup, alpha=cfg.ewma_alpha,
            window=cfg.window, z_threshold=cfg.z_threshold,
            min_scale_frac=cfg.min_scale_frac, min_scale=8.0,
            direction="high"),
        # prefix-cache hit-rate collapse (an eviction storm, a routing
        # change upstream): per-admission hit rate leaves the band
        "prefix_hit_rate": RollingPercentileDetector(
            warmup=cfg.warmup, window=cfg.window, q=0.95, ratio=2.0,
            direction="low"),
        # speculative acceptance collapse: drafts stopped matching
        "spec_acceptance": RollingPercentileDetector(
            warmup=cfg.warmup, window=cfg.window, q=0.95, ratio=2.0,
            direction="low"),
    }


def default_training_detectors(cfg: AnomalyConfig) -> Dict[str, object]:
    """Training-engine catalog: the step's host phases and the retrace
    storm signal (the fused train step leaves little else visible
    host-side; device captures answer the *why*)."""
    def lat(**kw):
        return EwmaMadDetector(
            warmup=cfg.warmup, alpha=cfg.ewma_alpha, window=cfg.window,
            z_threshold=cfg.z_threshold,
            min_scale_frac=cfg.min_scale_frac, min_scale=cfg.min_scale,
            **kw)

    return {
        "step_interval_ms": lat(direction="high"),
        "step_host_ms": lat(direction="high"),
        "retrace": ThresholdDetector(limit=0.0, warmup=1),
    }


class AnomalyMonitor:
    """Per-engine detector table + cooldown + event ring + sustained
    window.

    ``observe(signal, value, step)`` feeds one sample and returns the
    fired :class:`AnomalyEvent` (already counted and ring-recorded) or
    None.  A fired signal is suppressed — but its detector keeps
    learning — for ``cfg.cooldown`` subsequent samples.  ``sustained()``
    answers whether enough events fired within the recent window to
    call the engine degraded.  ``registry``: when given, fires bump a
    labeled ``<prefix>_anomalies_total`` counter so the events are
    scrape-visible next to every other serving metric."""

    def __init__(self, cfg: Optional[AnomalyConfig] = None,
                 registry=None, prefix: str = "serving",
                 event_capacity: int = 256):
        self.cfg = cfg or AnomalyConfig()
        self.prefix = prefix
        self._detectors: Dict[str, object] = {}
        self._cooldown_until: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.events: Deque[AnomalyEvent] = deque(maxlen=event_capacity)
        self._fire_steps: Deque[int] = deque(maxlen=256)
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                f"{prefix}_anomalies_total",
                "anomaly-detector fires by signal", int_valued=True)

    def watch(self, signal: str, detector) -> None:
        self._detectors[signal] = detector

    def watch_all(self, detectors: Dict[str, object]) -> None:
        for s, d in detectors.items():
            self.watch(s, d)

    @property
    def signals(self) -> List[str]:
        return list(self._detectors)

    def observe(self, signal: str, value: float,
                step: int) -> Optional[AnomalyEvent]:
        det = self._detectors.get(signal)
        if det is None:
            return None
        fired = det.observe(value)
        if fired is None:
            return None
        if step < self._cooldown_until.get(signal, -1):
            return None                      # suppressed, still learned
        baseline, score = fired
        self._cooldown_until[signal] = step + self.cfg.cooldown
        ev = AnomalyEvent(signal=signal, step=int(step),
                          observed=float(value),
                          baseline=float(baseline) if baseline is not None
                          else 0.0,
                          score=float(score), detector=det.kind,
                          direction=getattr(det, "direction", "high"))
        self.counts[signal] = self.counts.get(signal, 0) + 1
        self.events.append(ev)
        self._fire_steps.append(int(step))
        if self._counter is not None:
            self._counter.inc(signal=signal)
        return ev

    def total(self) -> int:
        return sum(self.counts.values())

    def sustained(self, step: int) -> bool:
        """True when ``sustained_count`` events fired within the last
        ``sustained_window`` steps — the health() degradation bar."""
        recent = sum(1 for s in self._fire_steps
                     if step - s <= self.cfg.sustained_window)
        return recent >= self.cfg.sustained_count

    def summary(self) -> Dict[str, Any]:
        """JSON-able tally for bench legs / SLO sweeps / health."""
        return {"total": self.total(),
                "by_signal": dict(self.counts),
                "recent": [e.as_dict() for e in list(self.events)[-8:]]}

    def reset(self) -> None:
        """Full rearm (``engine.reset_metrics``): detector baselines,
        cooldowns, counts, and the event ring all restart — a bench
        leg's timed region watches with fresh eyes.  The registry
        counter resets with the registry itself."""
        for det in self._detectors.values():
            det.reset()
        self._cooldown_until.clear()
        self.counts.clear()
        self.events.clear()
        self._fire_steps.clear()

    def __iter__(self) -> Iterator[AnomalyEvent]:
        return iter(self.events)
