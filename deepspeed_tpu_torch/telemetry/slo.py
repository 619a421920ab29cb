"""Per-class SLO objectives, error budgets, and burn-rate signals
(docs/OBSERVABILITY.md "SLOs & error budgets").

The serving stack routes by SLO class (``x-slo-class`` -> priority /
deadline / pool) and even scales pools by class, but routing a class is
not *meeting* it.  This module is the measurement half: per-class
:class:`SloObjective` targets (TTFT / TPOT / e2e latency, deadline-met,
availability = the non-shed fraction), rolling compliance windows, an
error budget per class, and deterministic multi-window burn-rate
detectors that plug into the existing :class:`~.anomaly.AnomalyMonitor`
catalog as the ``slo_burn_rate_<class>`` signal family — so a burning
budget breadcrumbs the flight recorder, arms a budgeted profiler
capture, and reaches the autoscaler's signal->pool map exactly like
every other anomaly signal.

Design rules (the telemetry-layer discipline):

* **zero new clock reads** — the tracker is fed at the same two
  statements :class:`~.lifecycle.RequestTracker` already stamps (the
  first-token branch of ``on_tokens`` and the terminal close-out of
  ``on_finish``) and evaluates entirely from timestamps already on the
  :class:`~.lifecycle.RequestRecord`.  SLO tracking ON adds zero
  ``perf_counter`` calls per warm step; OFF constructs nothing
  (``InferenceConfig.slo`` is the usual ``"auto"|"on"|"off"`` gate,
  auto resolving OFF today).
* **attainment == counter quotient by construction** — every
  evaluation bumps the paired labeled counters
  ``serving_slo_good_total`` / ``serving_slo_evaluated_total``
  (``class=`` / ``objective=`` labels) at ONE site, declared to
  tpulint's counter-pairing pass, so the scorecard's attainment is
  exactly the quotient of two exported monotonic counters — a
  dashboard recomputes it from a scrape and gets the same number.
* **request-counted, deterministic burn windows** — the fast/slow
  windows count *requests*, not seconds (Google-SRE multi-window
  burn-rate shape, made replayable): burn rate is
  ``bad_fraction / (1 - target)`` over each window, and the detector
  fires when BOTH windows exceed their thresholds — the fast window
  catches the current burn, the slow window confirms it is sustained
  rather than one unlucky request.

Hop closures (``migrated`` / ``handed_off``) are *not* evaluated: the
request lives on at the fleet level and will be judged once, by the
replica that actually finishes it (otherwise a disaggregated fleet
double-counts every request's availability).

Copied from the JAX package's ``telemetry/slo.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple

# the class a record evaluates under when it was never tagged — the
# same default the gateway's class map applies to header-less requests
DEFAULT_SLO_CLASS = "standard"

# statuses that are a hop, not an end: skip evaluation entirely
HOP_STATUSES = ("migrated", "handed_off")

# statuses charged against availability (the engine failed the client)
UNAVAILABLE_STATUSES = ("shed", "failed")


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One class's service-level objective.  Latency targets are
    opt-in (None = that dimension is not part of this class's
    contract); ``target`` is the attainment goal the error budget and
    burn rates are normalised against.  Window sizes count REQUESTS —
    the whole scorecard replays deterministically."""
    ttft_ms: Optional[float] = None       # first-token latency bound
    tpot_ms: Optional[float] = None       # decode-tail per-token bound
    e2e_ms: Optional[float] = None        # arrival->finish bound
    target: float = 0.95                  # latency/deadline attainment
    availability: float = 0.999           # non-shed fraction target
    window: int = 512                     # rolling compliance window
    fast_window: int = 32                 # burn-rate windows (requests)
    slow_window: int = 256
    fast_burn: float = 14.0               # fire thresholds (x budget)
    slow_burn: float = 6.0

    def __post_init__(self):
        if not (0.0 < self.target < 1.0):
            raise ValueError("target must be in (0, 1)")
        if not (0.0 < self.availability <= 1.0):
            raise ValueError("availability must be in (0, 1]")
        if self.window < 1 or self.fast_window < 1 or self.slow_window < 1:
            raise ValueError("window sizes must be >= 1")
        if self.fast_window > self.slow_window:
            raise ValueError("fast_window must be <= slow_window (the "
                             "slow window is the sustained confirmation)")
        for name in ("ttft_ms", "tpot_ms", "e2e_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive when set")
        if self.fast_burn <= 0 or self.slow_burn <= 0:
            raise ValueError("burn thresholds must be positive")


def default_slo_objectives() -> Dict[str, SloObjective]:
    """Objectives for the gateway's default class map
    (``sloclass.default_slo_classes``): interactive carries the tight
    latency contract, standard a loose one, batch only a throughput-ish
    TPOT bound and availability."""
    return {
        "interactive": SloObjective(ttft_ms=1000.0, tpot_ms=200.0,
                                    e2e_ms=30_000.0, target=0.95),
        "standard": SloObjective(ttft_ms=5000.0, e2e_ms=120_000.0,
                                 target=0.9),
        "batch": SloObjective(tpot_ms=500.0, target=0.9),
    }


class BurnRateDetector:
    """Deterministic multi-window error-budget burn detector, protocol-
    compatible with the :class:`~.anomaly.AnomalyMonitor` catalog
    (``kind`` / ``direction`` / ``reset`` / ``observe``).

    ``observe(bit)`` takes one request's composite violation bit
    (1.0 = the request violated its class objective).  Burn rate over a
    window is ``bad_fraction / (1 - target)`` — 1.0 means the budget is
    consumed exactly at the rate the objective allows for; the detector
    fires when the fast window burns >= ``fast_burn`` AND the slow
    window burns >= ``slow_burn``.  The fast window must be FULL before
    the first fire (warm-up); the slow window evaluates over however
    many of its samples exist so far (early in life it equals the fast
    window — the sustained confirmation strengthens as traffic
    accumulates).  No clocks anywhere: replay-identical."""

    kind = "burn_rate"
    direction = "high"

    def __init__(self, target: float = 0.95, fast_window: int = 32,
                 slow_window: int = 256, fast_burn: float = 14.0,
                 slow_burn: float = 6.0):
        if fast_window < 1 or slow_window < fast_window:
            raise ValueError("need 1 <= fast_window <= slow_window")
        self.target = float(target)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self._budget = max(1.0 - self.target, 1e-9)
        self._fast: Deque[float] = deque(maxlen=fast_window)
        self._slow: Deque[float] = deque(maxlen=slow_window)

    @classmethod
    def for_objective(cls, obj: SloObjective) -> "BurnRateDetector":
        return cls(target=obj.target, fast_window=obj.fast_window,
                   slow_window=obj.slow_window, fast_burn=obj.fast_burn,
                   slow_burn=obj.slow_burn)

    def reset(self) -> None:
        self._fast.clear()
        self._slow.clear()

    def _burn(self, win: Deque[float]) -> float:
        if not win:
            return 0.0
        return (sum(win) / len(win)) / self._budget

    @property
    def fast_rate(self) -> float:
        return self._burn(self._fast)

    @property
    def slow_rate(self) -> float:
        return self._burn(self._slow)

    def observe(self, value: float) -> Optional[Tuple[float, float]]:
        bit = 1.0 if value else 0.0
        self._fast.append(bit)
        self._slow.append(bit)
        if len(self._fast) < self._fast.maxlen:
            return None                      # warm-up: fast window full
        fast, slow = self.fast_rate, self.slow_rate
        if fast >= self.fast_burn and slow >= self.slow_burn:
            # baseline = the allowed bad fraction, score = how many
            # times over budget the fast window is burning
            return self._budget, fast
        return None


class SloTracker:
    """Per-class scorecard state over one :class:`MetricsRegistry`.

    Fed by :class:`~.lifecycle.RequestTracker` at its existing stamp
    sites (:meth:`on_first_token`, :meth:`on_close`); every evaluation
    flows through ONE paired-counter site (:meth:`_observe`) so
    attainment is the exported counter quotient by construction.
    ``bind`` attaches the per-class burn detectors to an
    :class:`AnomalyMonitor` so fires ride the monitor's cooldown /
    event ring / counters and reach the engine's capture+breadcrumb
    path like any other anomaly."""

    # the composite per-request objective every class evaluates: "this
    # request met everything its class asked of it"
    COMPOSITE = "requests"

    def __init__(self, objectives: Dict[str, SloObjective], registry,
                 default_class: str = DEFAULT_SLO_CLASS):
        if not objectives:
            raise ValueError("need at least one SloObjective")
        self.objectives = dict(objectives)
        self.default_class = default_class
        # tpulint: pair=_c_good/_c_eval
        self._c_good = registry.counter(
            "serving_slo_good_total",
            "SLO evaluations that met their objective "
            "(class/objective labels)", int_valued=True)
        self._c_eval = registry.counter(
            "serving_slo_evaluated_total",
            "SLO evaluations performed (class/objective labels)",
            int_valued=True)
        # rolling compliance windows, (class, objective) -> 0/1 ring
        self._windows: Dict[Tuple[str, str], Deque[int]] = {}
        self._burn: Dict[str, BurnRateDetector] = {
            cls: BurnRateDetector.for_objective(obj)
            for cls, obj in self.objectives.items()}
        self._monitor = None
        self._step_fn = None
        self._on_fire = None

    # ------------------------------------------------------------------
    # anomaly-catalog attachment
    # ------------------------------------------------------------------
    def bind(self, monitor, step_fn, on_fire=None) -> None:
        """Register the per-class burn detectors as the
        ``slo_burn_rate_<class>`` signal family of ``monitor``;
        ``step_fn`` supplies the step a fire is stamped with and
        ``on_fire(event)`` receives fired events (the engine routes
        them into its breadcrumb + budgeted-capture path)."""
        for cls in self._burn:
            monitor.watch(f"slo_burn_rate_{cls}", self._burn[cls])
        self._monitor = monitor
        self._step_fn = step_fn
        self._on_fire = on_fire

    # ------------------------------------------------------------------
    # the one paired-counter site (attainment == quotient by construction)
    # ------------------------------------------------------------------
    def _observe(self, cls: str, objective: str, good: bool) -> None:
        labels = {"class": cls, "objective": objective}
        self._c_eval.inc(**labels)
        if good:
            self._c_good.inc(**labels)
        win = self._windows.get((cls, objective))
        if win is None:
            obj = self.objectives.get(cls)
            size = obj.window if obj is not None else 512
            win = self._windows[(cls, objective)] = deque(maxlen=size)
        win.append(1 if good else 0)

    def _class_of(self, rec) -> str:
        return getattr(rec, "slo_class", None) or self.default_class

    # ------------------------------------------------------------------
    # feed points (RequestTracker's existing stamp statements)
    # ------------------------------------------------------------------
    def on_first_token(self, rec) -> None:
        """Fed from the first-token branch of ``on_tokens`` —
        ``rec.ttft_ms`` is already computed from stamps the tracker
        just stored; no clock is read here."""
        cls = self._class_of(rec)
        obj = self.objectives.get(cls)
        if obj is None or obj.ttft_ms is None:
            return
        ttft = rec.ttft_ms
        if ttft is None:
            return
        self._observe(cls, "ttft", ttft <= obj.ttft_ms)

    def on_close(self, rec) -> None:
        """Fed from ``on_finish`` after the record's terminal stamp —
        evaluates availability, deadline-met, the latency targets, and
        the composite per-request bit that drives the burn detector.
        Hop closures are skipped (module docstring)."""
        status = rec.status
        if status in HOP_STATUSES:
            return
        cls = self._class_of(rec)
        obj = self.objectives.get(cls)
        if obj is None:
            return
        avail_ok = status not in UNAVAILABLE_STATUSES
        self._observe(cls, "availability", avail_ok)
        deadline_ok = status != "deadline_exceeded"
        self._observe(cls, "deadline", deadline_ok)
        good = avail_ok and deadline_ok
        if obj.ttft_ms is not None and rec.ttft_ms is not None:
            # already counted under "ttft" at first token; folded into
            # the composite here without re-counting
            good = good and rec.ttft_ms <= obj.ttft_ms
        if obj.tpot_ms is not None and rec.tpot_ms is not None:
            tpot_ok = rec.tpot_ms <= obj.tpot_ms
            self._observe(cls, "tpot", tpot_ok)
            good = good and tpot_ok
        if obj.e2e_ms is not None and status == "finished" \
                and rec.e2e_ms is not None:
            e2e_ok = rec.e2e_ms <= obj.e2e_ms
            self._observe(cls, "e2e", e2e_ok)
            good = good and e2e_ok
        self._observe(cls, self.COMPOSITE, good)
        self._feed_burn(cls, good)

    def _feed_burn(self, cls: str, good: bool) -> None:
        bit = 0.0 if good else 1.0
        if self._monitor is not None:
            ev = self._monitor.observe(f"slo_burn_rate_{cls}", bit,
                                       self._step_fn())
            if ev is not None and self._on_fire is not None:
                self._on_fire(ev)
        else:
            # unbound (anomaly plane off): the detector still tracks
            # burn rates so the scorecard reports them
            self._burn[cls].observe(bit)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def _pair(self, cls: str, objective: str) -> Tuple[int, int]:
        labels = {"class": cls, "objective": objective}
        good = int(self._c_good.value(**labels))
        total = int(self._c_eval.value(**labels))
        return good, total

    def scorecard(self) -> Dict:
        """The per-class scorecard (JSON-able): per-objective counter
        pairs + attainment quotient + rolling-window attainment, the
        class error budget on the composite objective, and the burn
        detector's fast/slow rates."""
        classes: Dict[str, Dict] = {}
        for cls in sorted(self.objectives):
            obj = self.objectives[cls]
            objectives: Dict[str, Dict] = {}
            for name, tgt in (("ttft", obj.ttft_ms),
                              ("tpot", obj.tpot_ms),
                              ("e2e", obj.e2e_ms)):
                if tgt is None:
                    continue
                objectives[name] = self._objective_entry(
                    cls, name, obj.target, threshold_ms=tgt)
            objectives["deadline"] = self._objective_entry(
                cls, "deadline", obj.target)
            objectives["availability"] = self._objective_entry(
                cls, "availability", obj.availability)
            objectives[self.COMPOSITE] = self._objective_entry(
                cls, self.COMPOSITE, obj.target)
            good, total = self._pair(cls, self.COMPOSITE)
            bad = total - good
            budget = (1.0 - obj.target) * total
            det = self._burn[cls]
            classes[cls] = {
                "objectives": objectives,
                "error_budget": {
                    "target": obj.target,
                    "evaluated": total,
                    "allowed_bad": round(budget, 4),
                    "consumed_bad": bad,
                    "remaining": round(budget - bad, 4),
                    "burn_total": (round(bad / budget, 4)
                                   if budget > 0 else None),
                },
                "burn_rate": {
                    "fast": round(det.fast_rate, 4),
                    "slow": round(det.slow_rate, 4),
                    "fast_window": det._fast.maxlen,
                    "slow_window": det._slow.maxlen,
                    "fast_threshold": det.fast_burn,
                    "slow_threshold": det.slow_burn,
                },
            }
        return {"enabled": True, "default_class": self.default_class,
                "classes": classes}

    def _objective_entry(self, cls: str, name: str, target: float,
                         threshold_ms: Optional[float] = None) -> Dict:
        good, total = self._pair(cls, name)
        win = self._windows.get((cls, name))
        entry = {
            "good": good,
            "evaluated": total,
            "attainment": (round(good / total, 4) if total else None),
            "target": target,
            "window_attainment": (round(sum(win) / len(win), 4)
                                  if win else None),
        }
        if threshold_ms is not None:
            entry["threshold_ms"] = threshold_ms
        return entry

    def reset(self) -> None:
        """Rearm windows and burn detectors (counters are the
        registry's to reset — ``engine.reset_metrics`` clears both)."""
        self._windows.clear()
        for det in self._burn.values():
            det.reset()


def merge_scorecards(cards: Dict[str, Dict]) -> Dict:
    """Fleet rollup of per-replica scorecards: counter pairs SUM (the
    quotient stays exact — the fleet attainment is the quotient of the
    summed exported counters), budgets sum, and burn rates take the
    per-replica MAX (the fleet number for a peak signal is its worst
    replica, the FleetRegistry rollup convention).  Disabled replicas
    contribute nothing; all-disabled merges to ``{"enabled": False}``."""
    live = {n: c for n, c in cards.items() if c and c.get("enabled")}
    if not live:
        return {"enabled": False, "replicas": sorted(cards)}
    classes: Dict[str, Dict] = {}
    for name in sorted(live):
        for cls, entry in live[name]["classes"].items():
            agg = classes.setdefault(cls, {
                "objectives": {}, "error_budget": None,
                "burn_rate": {"fast": 0.0, "slow": 0.0},
            })
            for oname, o in entry["objectives"].items():
                tgt = agg["objectives"].setdefault(oname, {
                    "good": 0, "evaluated": 0, "target": o["target"]})
                tgt["good"] += o["good"]
                tgt["evaluated"] += o["evaluated"]
                if "threshold_ms" in o:
                    tgt["threshold_ms"] = o["threshold_ms"]
            eb = entry["error_budget"]
            acc = agg["error_budget"]
            if acc is None:
                agg["error_budget"] = acc = {
                    "target": eb["target"], "evaluated": 0,
                    "allowed_bad": 0.0, "consumed_bad": 0}
            acc["evaluated"] += eb["evaluated"]
            acc["allowed_bad"] += eb["allowed_bad"]
            acc["consumed_bad"] += eb["consumed_bad"]
            br = entry["burn_rate"]
            agg["burn_rate"]["fast"] = max(agg["burn_rate"]["fast"],
                                           br["fast"])
            agg["burn_rate"]["slow"] = max(agg["burn_rate"]["slow"],
                                           br["slow"])
    for cls, agg in classes.items():
        for o in agg["objectives"].values():
            o["attainment"] = (round(o["good"] / o["evaluated"], 4)
                               if o["evaluated"] else None)
        eb = agg["error_budget"]
        eb["allowed_bad"] = round(eb["allowed_bad"], 4)
        eb["remaining"] = round(eb["allowed_bad"] - eb["consumed_bad"], 4)
        eb["burn_total"] = (round(eb["consumed_bad"] / eb["allowed_bad"], 4)
                            if eb["allowed_bad"] > 0 else None)
    return {"enabled": True, "classes": classes,
            "replicas": {n: c for n, c in cards.items()}}
