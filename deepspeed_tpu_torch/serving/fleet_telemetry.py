"""Fleet observability plane (docs/OBSERVABILITY.md "Fleet
observability").

The router turned one hardened engine into a fleet, but every
observability surface of the engine — span rings, metrics registries, flight
recorders, anomaly detectors — was strictly per-engine: a request
placed on replica A, surviving A's quarantine, migrating to B and
finishing there left its story scattered across N uncorrelated rings.
This module is the fleet half, built on the SAME contracts rather than
new ones:

* **Request journeys** — :class:`FleetTelemetry` keeps a per-uid
  journey log (placed → (quarantined | migrated | failed-over)* →
  terminal, step-counter timestamps and reasons) plus a router-owned
  :class:`~deepspeed_tpu_torch.telemetry.SpanTracer` whose placement /
  migrate / failover spans carry ``uid`` + ``replica`` args, so the
  merged fleet timeline can flow-connect one request's hops.
* **Fleet metrics aggregation** — :class:`FleetRegistry` scrapes each
  live replica's registry at EXPORT time (pull-gauges stay pull, never
  cached stale) and re-exports every ``serving_*`` series with a
  ``replica=`` label, plus ``serving_fleet_*`` rollups (sum, max for
  peaks/states) and the *reconciled* terminal-status rollup that
  dedups migration/routing double counting.  Dead/quarantined replicas
  export their last scrape with a ``serving_fleet_replica_stale``
  marker instead of silently vanishing.
* **Fleet anomaly catalog** — :func:`default_fleet_detectors` watches
  placement imbalance (load-share skew), affinity hit-rate collapse,
  failover/migration storms, and cross-replica TTFT p95 divergence;
  fires bump ``serving_fleet_anomalies_total{signal=}``, breadcrumb
  the router's flight recorder, and arm a budgeted deep-capture window
  *on the implicated replica* through the engines' existing
  :class:`~deepspeed_tpu_torch.telemetry.ProfilerCapture` seam.
* **Fleet request dedup** — :func:`fleet_request_metrics` merges
  per-replica :class:`~deepspeed_tpu_torch.telemetry.RequestTracker` records
  migration-aware: a migrated uid yields ONE record attributed to its
  finishing replica, with token sums that still equal the sum of the
  per-replica engine counters (the fuzz's reconciliation bar).

Zero-cost-off (the engine's bar, counted by test): fleet telemetry off
constructs no monitor, no tracer ring, no journey table, and adds zero
``perf_counter`` reads per router step — the router's only clock stays
its step counter.  Everything here is host-side dict/float work; no
JAX imports (the telemetry/ contract).

Copied from the JAX package's ``serving/fleet_telemetry.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..telemetry import (AnomalyConfig, AnomalyMonitor, MetricsRegistry,
                         SpanTracer)
from ..telemetry.anomaly import (EwmaMadDetector,
                                 RollingPercentileDetector,
                                 ThresholdDetector)
from ..telemetry.slo import (BurnRateDetector, SloObjective, SloTracker,
                             default_slo_objectives)
from ..telemetry.metrics import Histogram, _fmt, _prom_label_str, _prom_name
from ..utils.logging import logger

# fleet post-mortem bundle schema (router.debug_dump writes it,
# validate_fleet_dump checks it, the fleet chaos smoke asserts it on
# every auto-dump)
FLEET_DUMP_VERSION = 1
FLEET_DUMP_REQUIRED_KEYS = ("version", "reason", "time", "fingerprint",
                            "steps", "health", "metrics", "rollups",
                            "journeys", "request_metrics", "events",
                            "replicas")

# journey events that end a uid's fleet life — a later placement of the
# same uid starts a FRESH journey (the engine's uid-reuse semantics,
# mirrored; the revived-uid races the router hardened are the reason this is
# explicit)
JOURNEY_TERMINAL = "closed"


class _NoopCtx:
    """Shared do-nothing context manager (telemetry-off placement
    spans): no clock reads, no allocs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_CTX = _NoopCtx()


@dataclasses.dataclass
class FleetTelemetryConfig:
    """Knobs for the fleet observability plane (constructed only when
    ``FleetConfig.telemetry`` resolves on)."""
    # detector shape knobs shared with the engine catalog; None takes
    # AnomalyConfig defaults
    anomaly: Optional[AnomalyConfig] = None
    # router span-ring capacity (placement/migrate/failover spans +
    # journey instants)
    trace_capacity: int = 1 << 14
    # journey table bound: beyond it the oldest journey is evicted
    # (closed or not — bounded beats complete on a long-lived router)
    max_journeys: int = 4096
    # failover/migration storm: fires when more than ``storm_limit``
    # failover+migration+retry events land within ``storm_window``
    # router steps (a single clean failover is an incident, not a
    # storm)
    storm_window: int = 32
    storm_limit: float = 3.0
    # cross-replica TTFT divergence: fires when the max/min p95 ratio
    # across routable replicas (each with >= ttft_min_samples observed
    # TTFTs) exceeds the ratio
    ttft_divergence_ratio: float = 4.0
    ttft_min_samples: int = 4
    # anomaly-armed deep captures: window length (engine steps) and the
    # fleet-level budget (reset_metrics on the router rearms it)
    capture_steps: int = 4
    max_captures: int = 2
    # where anomaly-armed replica captures land; None falls back to
    # FleetConfig.flight_dir (the post-mortem dir is a sensible home)
    capture_dir: Optional[str] = None
    # fleet-level SLO burn detectors (telemetry/slo.py): the class ->
    # SloObjective map the per-class ``slo_burn_rate_<class>`` signals
    # normalise against.  None takes default_slo_objectives(); a fleet
    # whose replicas run custom objectives should mirror them here.
    # The signals only move when replicas export the serving_slo_*
    # composite counters (InferenceConfig.slo on) — an all-off fleet
    # feeds nothing.
    slo_objectives: Optional[Dict[str, SloObjective]] = None


def default_fleet_detectors(cfg: FleetTelemetryConfig) -> Dict[str, object]:
    """The fleet signal catalog (docs/OBSERVABILITY.md "Fleet anomaly
    catalog").  Every signal is fed from counters and integer loads the
    router already holds — feeding adds no clock reads."""
    a = cfg.anomaly or AnomalyConfig()
    return {
        # busiest replica's share of the fleet's live work — affinity
        # placement trades some imbalance for cache hits, so the
        # detector learns the workload's normal skew and fires on a
        # shift (one replica eating the fleet).  The 0.05 scale floor
        # is 5 share points: share jitter below that is routing noise
        "placement_imbalance": EwmaMadDetector(
            warmup=a.warmup, alpha=a.ewma_alpha, window=a.window,
            z_threshold=a.z_threshold,
            min_scale_frac=a.min_scale_frac, min_scale=0.05,
            direction="high"),
        # per-step affinity hit rate (hit placements / placements)
        # leaving the rolling band low-side: the cache-affinity signal
        # collapsed (an eviction storm somewhere, a workload shift)
        "affinity_hit_rate": RollingPercentileDetector(
            warmup=a.warmup, window=a.window, q=0.95, ratio=2.0,
            direction="low"),
        # failover+migration+retry events within the rolling window —
        # any count above storm_limit is a storm, sustained by
        # construction (the window IS the sustain)
        "failover_migration_storm": ThresholdDetector(
            limit=cfg.storm_limit, warmup=0),
        # max/min cross-replica TTFT p95 ratio: one replica serving
        # visibly worse than its peers (thermal, a poisoned cache, a
        # sick host) while the fleet average still looks fine
        "ttft_divergence": ThresholdDetector(
            limit=cfg.ttft_divergence_ratio, warmup=0),
    }


class FleetTelemetry:
    """The router's observability plane: journey log + span tracer +
    anomaly monitor + capture budget.  Constructed ONLY when
    ``FleetConfig.telemetry`` resolves on — its absence is the
    zero-cost-off guarantee."""

    def __init__(self, cfg: Optional[FleetTelemetryConfig],
                 registry: MetricsRegistry):
        self.cfg = cfg or FleetTelemetryConfig()
        self.tracer = SpanTracer(capacity=self.cfg.trace_capacity,
                                 enabled=True)
        self.monitor = AnomalyMonitor(self.cfg.anomaly, registry,
                                      prefix="serving_fleet")
        self.monitor.watch_all(default_fleet_detectors(self.cfg))
        self._journeys: Dict[int, List[Dict[str, Any]]] = {}
        self._prev: Dict[str, float] = {}     # detector feed scratch
        self._storm: Deque[Tuple[int, int]] = deque()
        # SLO burn-rate scratch: per-(replica, class) last-seen
        # (good, evaluated) composite-counter readings, per-class
        # per-replica bad tallies since the last fire (implication),
        # and the set of lazily-watched burn signals
        self._slo_prev: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._slo_bad: Dict[str, Dict[str, int]] = {}
        self._slo_signals: set = set()
        self._captures_used = 0
        # completed/armed anomaly captures: {signal, replica, dir, step}
        self.captures: List[Dict[str, Any]] = []
        self.last_placed: Optional[str] = None
        self.last_migration_dest: Optional[str] = None
        self._warned_no_capture_dir = False

    # ------------------------------------------------------------------
    # journeys
    # ------------------------------------------------------------------
    def begin_journey(self, uid: int) -> None:
        """Start a fresh journey for a NEW fleet life of ``uid`` (a
        revived uid — fleet-shed then re-admitted — must not inherit
        its dead life's story)."""
        j = self._journeys.get(uid)
        if j is None or (j and j[-1]["event"] == JOURNEY_TERMINAL):
            self._journeys[uid] = []
            while len(self._journeys) > self.cfg.max_journeys:
                self._journeys.pop(next(iter(self._journeys)))

    def journey_event(self, uid: int, event: str, step: int,
                      replica: Optional[str] = None, **extra) -> None:
        """Append one journey event (step-counter timestamp — the
        router's only clock) and mirror it onto the tracer's journey
        track so the merged fleet timeline can flow-connect hops by
        shared ``uid`` args."""
        j = self._journeys.get(uid)
        if j is None:
            j = self._journeys[uid] = []
            while len(self._journeys) > self.cfg.max_journeys:
                self._journeys.pop(next(iter(self._journeys)))
        ev: Dict[str, Any] = {"event": event, "step": int(step)}
        if replica is not None:
            ev["replica"] = replica
        ev.update(extra)
        j.append(ev)
        self.tracer.instant(event, track="journey", uid=int(uid),
                            replica=replica, **extra)

    def journey(self, uid: int) -> Optional[List[Dict[str, Any]]]:
        j = self._journeys.get(uid)
        return None if j is None else list(j)

    # ------------------------------------------------------------------
    # anomaly feeding (called once per router step; ints/floats only —
    # no clock reads, the counted zero-cost bar)
    # ------------------------------------------------------------------
    def span(self, name: str, **args):
        return self.tracer.span(name, track="router", **args)

    def feed_step(self, router) -> None:
        mon, prev, step = self.monitor, self._prev, router._steps
        fired: List[Tuple[object, Optional[str]]] = []
        # placement imbalance: busiest live replica's work share
        loads = [(rep.load(), name)
                 for name, rep in router._reps.items() if not rep.dead]
        total = sum(v for v, _ in loads)
        if len(loads) > 1 and total:
            mx, mx_name = max(loads)
            ev = mon.observe("placement_imbalance", mx / total, step)
            if ev is not None:
                fired.append((ev, mx_name))
        # per-class SLO error-budget burn (replica composite counters)
        self._feed_slo_burn(router, step, fired)
        # affinity hit rate over this step's placements (labeled
        # counter: series_sum folds every policy= series)
        placements = router.metrics.series_sum(
            "serving_fleet_placements_total")
        hits = router._c_place_hits.value()
        dp = placements - prev.get("placements", 0)
        dh = hits - prev.get("hits", 0)
        prev["placements"], prev["hits"] = placements, hits
        if dp > 0:
            ev = mon.observe("affinity_hit_rate", dh / dp, step)
            if ev is not None:
                fired.append((ev, self.last_placed))
        # failover/migration storm: rolling-window event count
        events = int(router._c_failovers.value()) \
            + int(router._c_migrations.value()) \
            + int(router._c_migration_retries.value())
        de = events - int(prev.get("events", 0))
        prev["events"] = events
        if de > 0:
            self._storm.append((step, de))
        while self._storm and step - self._storm[0][0] \
                > self.cfg.storm_window:
            self._storm.popleft()
        ev = mon.observe("failover_migration_storm",
                         float(sum(n for _, n in self._storm)), step)
        if ev is not None:
            fired.append((ev, self.last_migration_dest))
        # cross-replica TTFT p95 divergence
        p95s = []
        for name, rep in router._reps.items():
            if rep.dead:
                continue
            h = rep.engine.metrics.get("serving_ttft_ms")
            if h is not None and h.count() >= self.cfg.ttft_min_samples:
                p95s.append((h.percentile(0.95), name))
        if len(p95s) >= 2:
            hi, hi_name = max(p95s)
            lo, _ = min(p95s)
            ev = mon.observe("ttft_divergence", hi / max(lo, 1e-9), step)
            if ev is not None:
                fired.append((ev, hi_name))
        for ev, name in fired:
            self._on_anomaly(router, ev, name)

    def _feed_slo_burn(self, router, step: int,
                       fired: List[Tuple[object, Optional[str]]]) -> None:
        """Fleet-level error-budget burn: diff each live replica's
        ``serving_slo_*_total`` composite counters (objective=requests,
        bumped by :class:`~..telemetry.slo.SloTracker` at request
        close-out — counter reads only, no clocks) and replay the
        deltas as per-request pass/fail bits through per-class
        request-counted :class:`BurnRateDetector` windows.  A fire
        implicates the replica that contributed the most bad requests
        since the last fire (tie-break by name) so the capture lands
        where the budget is burning."""
        mon, prev = self.monitor, self._slo_prev
        objs = self.cfg.slo_objectives or default_slo_objectives()
        # per-class delta aggregation across live replicas
        goods: Dict[str, int] = {}
        bads: Dict[str, int] = {}
        for name, rep in router._reps.items():
            if rep.dead:
                continue
            m_good = rep.engine.metrics.get("serving_slo_good_total")
            m_eval = rep.engine.metrics.get("serving_slo_evaluated_total")
            if m_good is None or m_eval is None:
                continue  # replica runs with SLO tracking off
            for key, ev_v in m_eval.series():
                labels = dict(key)
                if labels.get("objective") != SloTracker.COMPOSITE:
                    continue
                cls = labels.get("class")
                if cls is None:
                    continue
                good_v = m_good.value(**labels)
                pg, pe = prev.get((name, cls), (0, 0))
                dg = max(int(good_v) - pg, 0)
                de = max(int(ev_v) - pe, 0)
                prev[(name, cls)] = (int(good_v), int(ev_v))
                if de <= 0:
                    continue
                db = max(de - dg, 0)
                goods[cls] = goods.get(cls, 0) + (de - db)
                bads[cls] = bads.get(cls, 0) + db
                if db:
                    tally = self._slo_bad.setdefault(cls, {})
                    tally[name] = tally.get(name, 0) + db
        for cls in sorted(set(goods) | set(bads)):
            sig = f"slo_burn_rate_{cls}"
            if sig not in self._slo_signals:
                self._slo_signals.add(sig)
                mon.watch(sig, BurnRateDetector.for_objective(
                    objs.get(cls) or SloObjective()))
            # goods first so a mixed step's bads land on the freshest
            # window state (order within a step is not observable
            # per-request; bads-last is the deterministic choice) —
            # the detector's bit convention is 1.0 = VIOLATION
            bits = [0.0] * goods.get(cls, 0) + [1.0] * bads.get(cls, 0)
            for bit in bits:
                ev = mon.observe(sig, bit, step)
                if ev is not None:
                    tally = self._slo_bad.pop(cls, {})
                    impl = max(tally.items(),
                               key=lambda kv: (kv[1], kv[0]),
                               default=None)
                    fired.append((ev, impl[0] if impl else None))

    def ops_capture(self, router, reason: str = "ops",
                    replica: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Operator-requested budgeted capture (the gateway's
        ``POST /debug/capture``): same budget + directory rules as an
        anomaly-armed capture, aimed at ``replica`` (default: the
        busiest routable one).  Returns ``{replica, dir}`` or ``None``
        when the budget is spent / nowhere to write / no target."""
        name = replica
        if name is None or name not in router._reps \
                or router._reps[name].dead:
            live = [(rep.load(), n) for n, rep in router._reps.items()
                    if rep.routable()]
            if not live:
                return None
            name = max(live)[1]
        if self._captures_used >= self.cfg.max_captures:
            return None
        d = self.cfg.capture_dir or router.cfg.flight_dir
        if not d:
            return None
        got = router._reps[name].engine.capture(
            steps=self.cfg.capture_steps, reason=reason,
            out_dir=os.path.join(d, "captures", name))
        if got is None:
            return None
        self._captures_used += 1
        self.captures.append({"signal": reason, "replica": name,
                              "dir": got, "step": int(router._steps)})
        return {"replica": name, "dir": got}

    def _on_anomaly(self, router, ev, replica: Optional[str]) -> None:
        """One fired fleet detector: breadcrumb the router's flight
        recorder (the counter was bumped by the monitor) and arm a
        budgeted capture window on the implicated replica through the
        engine's existing ProfilerCapture seam."""
        router.flight.note("fleet_anomaly", replica=replica,
                           **ev.as_dict())
        name = replica
        if name is None or name not in router._reps \
                or router._reps[name].dead:
            # the implicated replica is gone (a storm's source is the
            # DEAD replica): capture where its load landed instead —
            # the busiest routable survivor
            live = [(rep.load(), n) for n, rep in router._reps.items()
                    if rep.routable()]
            if not live:
                return
            name = max(live)[1]
        if self._captures_used >= self.cfg.max_captures:
            return
        d = self.cfg.capture_dir or router.cfg.flight_dir
        if not d:
            if not self._warned_no_capture_dir:
                self._warned_no_capture_dir = True
                logger.warning(
                    "fleet anomaly capture skipped: no capture "
                    "directory (set FleetTelemetryConfig.capture_dir "
                    "or FleetConfig.flight_dir) — detectors still "
                    "fire/count")
            return
        got = router._reps[name].engine.capture(
            steps=self.cfg.capture_steps,
            reason=f"fleet_{ev.signal}",
            out_dir=os.path.join(d, "captures", name))
        if got is not None:
            self._captures_used += 1
            self.captures.append({"signal": ev.signal, "replica": name,
                                  "dir": got, "step": int(ev.step)})

    def summary(self) -> Dict[str, Any]:
        """JSON-able fleet anomaly tally (bench legs / fleet dumps)."""
        return {**self.monitor.summary(),
                "captures": [dict(c) for c in self.captures]}

    def reset(self) -> None:
        """Rearm detectors + capture budget (the router's
        ``reset_metrics``); journeys and spans clear too."""
        self.monitor.reset()
        self._prev.clear()
        self._storm.clear()
        self._slo_prev.clear()
        self._slo_bad.clear()
        self._captures_used = 0
        self.captures.clear()
        self._journeys.clear()
        self.tracer.clear()


# --------------------------------------------------------------------------
# migration-aware fleet request metrics
# --------------------------------------------------------------------------

def _merged_rec(uid: int) -> Dict[str, Any]:
    return {"uid": int(uid), "replica": None, "status": "open",
            "hops": [], "prompt_tokens": 0, "cached_tokens": 0,
            "generated_tokens": 0, "drafted_tokens": 0,
            "accepted_tokens": 0, "preemptions": 0, "retries": 0,
            "ttft_ms": None, "e2e_ms": None,
            "_t0": None, "_t_first": None, "_t_finish": None}


def _fold(cur: Dict[str, Any], name: str, rec) -> None:
    cur["prompt_tokens"] += rec.prompt_tokens
    cur["cached_tokens"] += rec.cached_tokens
    cur["generated_tokens"] += rec.generated_tokens
    cur["drafted_tokens"] += rec.drafted_tokens
    cur["accepted_tokens"] += rec.accepted_tokens
    cur["preemptions"] += rec.preemptions
    cur["retries"] += rec.retries
    if cur["_t0"] is None:
        cur["_t0"] = rec.t_arrival
    if rec.t_first_token is not None and cur["_t_first"] is None:
        cur["_t_first"] = rec.t_first_token
    if rec.t_finish is not None:
        cur["_t_finish"] = rec.t_finish


def _close_merged(cur: Dict[str, Any]) -> Dict[str, Any]:
    if cur["_t_first"] is not None and cur["_t0"] is not None:
        cur["ttft_ms"] = round((cur["_t_first"] - cur["_t0"]) * 1e3, 4)
    if cur["_t_finish"] is not None and cur["_t0"] is not None \
            and cur["status"] not in ("open", "migrating"):
        cur["e2e_ms"] = round((cur["_t_finish"] - cur["_t0"]) * 1e3, 4)
    for k in ("_t0", "_t_first", "_t_finish"):
        del cur[k]
    return cur


def fleet_request_records(router) -> List[Dict[str, Any]]:
    """Merge every replica's lifecycle records into fleet-level request
    records, migration-aware (docs/OBSERVABILITY.md "Fleet
    observability"):

    * a ``migrated`` or ``handed_off`` close on one replica is a HOP —
      it folds into the uid's temporally-next record (the continuation
      the router placed elsewhere), so a migrated or prefill→decode
      handed-off request yields ONE record attributed to its finishing
      replica;
    * an ``open`` record on a DEAD replica is the failover's hop (the
      engine died before closing it; the router re-placed or
      fleet-closed the work);
    * phantom ``shed`` closures — an engine shedding a put the router
      then retried elsewhere (``serving_fleet_replica_shed_retries_
      total``) — are dropped: they were never a fleet terminal;
    * a trailing hop with no continuation takes the FLEET status
      (``migrating`` in the queue, or the router's terminal closure).

    All replicas share one in-process ``perf_counter`` clock, so
    sorting a uid's records by arrival time orders its hops.  Token
    sums over the merged records equal the sum of the per-replica
    engine counters (every hop's tokens were counted where they ran) —
    the invariant the fleet fuzz asserts.
    """
    per_uid: Dict[int, List[Tuple[float, str, Any, bool]]] = {}
    for name, rep in router._reps.items():
        dead = rep.dead
        for rec in rep.engine.requests.records():
            per_uid.setdefault(rec.uid, []).append(
                (rec.t_arrival, name, rec, dead))
    phantom = dict(router._phantoms)
    merged: List[Dict[str, Any]] = []
    for uid, items in sorted(per_uid.items()):
        items.sort(key=lambda e: e[0])
        kept = []
        for t, name, rec, dead in items:
            if rec.status == "shed" and phantom.get((uid, name), 0) > 0:
                phantom[(uid, name)] -= 1        # routing retry, not a
                continue                         # fleet terminal
            kept.append((t, name, rec, dead))
        cur = None
        for t, name, rec, dead in kept:
            hop = rec.status in ("migrated", "handed_off") \
                or (dead and rec.status == "open")
            if cur is None:
                cur = _merged_rec(uid)
            _fold(cur, name, rec)
            cur["hops"].append({"replica": name, "status": rec.status})
            if not hop:
                cur["status"] = rec.status
                cur["replica"] = name
                merged.append(_close_merged(cur))
                cur = None
        if cur is not None:
            # trailing hop: the fleet knows where the story went
            cur["status"] = router._fleet_status_of(uid)
            merged.append(_close_merged(cur))
    return merged


def fleet_request_metrics(router) -> Dict[str, Any]:
    """Fleet-level ``request_metrics()``: migration-deduped records,
    the exact fleet aggregate, and each replica's own aggregate.

    ``aggregate["statuses"]`` is the record-derived fleet truth
    (merged records plus the router's record-gap tally — closures that
    left no engine record, e.g. a fleet-saturation shed); the
    counter-derived twin is the :class:`FleetRegistry`'s reconciled
    ``serving_fleet_requests_terminal_total`` rollup, and the fleet
    fuzz asserts the two agree."""
    records = fleet_request_records(router)
    statuses: Dict[str, int] = {}
    open_n = 0
    sums = {"prompt_tokens": 0, "cached_tokens": 0,
            "generated_tokens": 0, "drafted_tokens": 0,
            "accepted_tokens": 0}
    preemptions = retries = 0
    for r in records:
        if r["status"] in ("open", "migrating"):
            open_n += 1
        else:
            statuses[r["status"]] = statuses.get(r["status"], 0) + 1
        for k in sums:
            sums[k] += r[k]
        preemptions += r["preemptions"]
        retries += r["retries"]
    gaps = dict(router._record_gaps)
    for s, n in gaps.items():
        statuses[s] = statuses.get(s, 0) + n
    return {
        "aggregate": {
            "requests": len(records) + sum(gaps.values()),
            "open": open_n,
            "statuses": statuses,
            **sums,
            "preemptions": preemptions,
            "retries": retries,
            "fleet_shed": int(router._c_shed.value()),
            "fleet_failed": int(router._c_failed.value()),
            "failovers": int(router._c_failovers.value()),
            "migrations": int(router._c_migrations.value()),
        },
        "replicas": {name: rep.engine.request_metrics()["aggregate"]
                     for name, rep in router._reps.items()},
        "requests": records,
    }


def reconciled_terminal_statuses(router) -> Dict[str, int]:
    """Counter-derived fleet terminal statuses, exact (docs/
    OBSERVABILITY.md "Fleet observability"): per-replica
    ``serving_requests_terminal_total`` sums with the migration/routing
    double counting reconciled out —

    * ``migrated`` and ``handed_off`` closures are dropped (internal
      hops, the request lives on);
    * per-replica ``shed`` closures that were fleet routing retries
      (phantoms, counted by ``serving_fleet_replica_shed_retries_
      total``) are subtracted;
    * fleet-level closures with no engine terminal (saturation sheds,
      migration-exhaustion sheds, inexact-record fails, migration-queue
      settles) are added from the router's own ledger.
    """
    tally: Dict[str, int] = {}
    for rep in router._reps.values():
        c = rep.engine.metrics.get("serving_requests_terminal_total")
        if c is None:
            continue
        for k, v in c.series():
            if not k:
                continue
            status = dict(k).get("status")
            if status is None or status in ("migrated", "handed_off"):
                continue
            tally[status] = tally.get(status, 0) + int(v)
    phantoms = int(router._c_phantom.value())
    if phantoms:
        tally["shed"] = tally.get("shed", 0) - phantoms
    for s, n in router._fleet_closures.items():
        tally[s] = tally.get(s, 0) + n
    return {s: n for s, n in tally.items() if n}


# --------------------------------------------------------------------------
# FleetRegistry: one exposition for the whole fleet
# --------------------------------------------------------------------------

def _scrape_registry(reg: MetricsRegistry) -> Dict[str, Dict[str, Any]]:
    """Snapshot one replica registry's ``serving_*`` series for
    re-export.  Pull-based FnGauges evaluate HERE — at scrape time —
    so the exposition is never stale for a live replica, and an absent
    sample (FnGauge None) stays absent."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in reg:
        if not m.name.startswith("serving_"):
            continue
        if isinstance(m, Histogram):
            out[m.name] = {
                "kind": "histogram", "help": m.help,
                "buckets": m.buckets,
                "hist": {k: (list(m._counts[k]), m._sums.get(k, 0.0),
                             m._totals.get(k, 0))
                         for k in m._counts}}
        else:
            out[m.name] = {"kind": m.kind, "help": m.help,
                           "int": bool(getattr(m, "int_valued", False)),
                           "samples": list(m.series())}
    return out


def _with_replica(key, name: str):
    return tuple(sorted(key + (("replica", name),)))


class FleetRegistry:
    """One Prometheus exposition for the fleet: every live replica's
    ``serving_*`` series re-exported under a ``replica=`` label,
    ``serving_fleet_*`` rollups (sum; max for peaks and state codes;
    rates skipped — a summed ratio is a lie), the reconciled terminal
    rollup, a staleness marker per replica, and the router's own fleet
    series — all pulled at export time, nothing cached for a routable
    replica.

    Dead and quarantined replicas keep exporting — their last snapshot
    (a dead engine's registry is frozen host truth; an unreadable one
    serves its cached last scrape), marked
    ``serving_fleet_replica_stale{replica=} 1`` — instead of silently
    vanishing from dashboards mid-incident.

    The registry also accepts fleet-scope registrations (``counter`` /
    ``gauge`` / ``gauge_fn`` / ``histogram`` delegate to an internal
    :class:`MetricsRegistry`); tpulint's metric-name rule checks these
    registration sites like any other registry — and additionally bans
    f-string metric NAMES on fleet receivers: per-replica identity is
    the ``replica=`` label (from the handle), never part of the name.
    """

    def __init__(self, router):
        self._router = router
        self._extra = MetricsRegistry()
        self._last: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._warned_unreadable: set = set()

    # fleet-scope registration (delegates; the exposition includes them)
    def counter(self, name: str, help: str = "", int_valued: bool = False):
        return self._extra.counter(name, help, int_valued)

    def gauge(self, name: str, help: str = ""):
        return self._extra.gauge(name, help)

    def gauge_fn(self, name: str, fn, help: str = ""):
        return self._extra.gauge_fn(name, fn, help)

    def histogram(self, name: str, buckets, help: str = ""):
        return self._extra.histogram(name, buckets, help)

    # ------------------------------------------------------------------
    def collect(self):
        """(per-replica scrape snaps, staleness map).  Every replica
        scrapes LIVE at collect time — in-process, a dead engine's
        registry is frozen host truth, so the live read IS its last
        snapshot (and a quarantined replica's open work is still
        moving its counters; freezing them would break the fleet's
        exact token accounting).  The cache serves only a registry
        that can no longer be read (the remote-replica shape), and the
        ``serving_fleet_replica_stale`` marker flags every
        non-routable (quarantined/dead) replica so dashboards know
        those series no longer describe live traffic-serving."""
        snaps: Dict[str, Dict[str, Dict[str, Any]]] = {}
        stale: Dict[str, bool] = {}
        for name, rep in self._router._reps.items():
            try:
                self._last[name] = _scrape_registry(rep.engine.metrics)
            except Exception as e:  # tpulint: disable=silent-except — scrape fallback: an unreadable replica registry serves its cached last scrape instead of taking the exporter down
                if name not in self._warned_unreadable:
                    self._warned_unreadable.add(name)
                    logger.warning(
                        "fleet registry: replica %s unreadable (%s: "
                        "%s) — exporting its last scrape", name,
                        type(e).__name__, e)
            stale[name] = not rep.breaker.state in ("closed",
                                                    "half_open")
            if name in self._last:
                snaps[name] = self._last[name]
        return snaps, stale

    def _rollup_mode(self, name: str, kind: str) -> Optional[str]:
        """"sum" / "max" / None (skip).  Counters and histograms sum;
        gauges sum except peaks and state codes (max — the worst
        replica is the fleet's number); rates never roll up (recompute
        them from the summed numerators/denominators instead)."""
        if name.endswith("_rate"):
            return None
        if kind == "gauge" and ("peak" in name
                                or name.endswith("_state")):
            return "max"
        return "sum"

    def rollups(self, snaps=None) -> Dict[str, Dict[str, Any]]:
        """``serving_fleet_*`` rollup series.  A rollup whose name
        collides with one of the router's own fleet metrics is skipped
        (the router's series IS the fleet-level truth there); the
        terminal-status rollup is the reconciled one, never the naive
        sum (docs/OBSERVABILITY.md "Fleet observability")."""
        if snaps is None:
            snaps, _ = self.collect()
        router = self._router
        out: Dict[str, Dict[str, Any]] = {}
        names: List[str] = []
        for snap in snaps.values():
            for n in snap:
                if n not in names:
                    names.append(n)
        for name in names:
            rname = "serving_fleet_" + name[len("serving_"):]
            if rname in router.metrics or rname in self._extra:
                continue
            if name == "serving_requests_terminal_total":
                out[rname] = {
                    "kind": "counter",
                    "help": "fleet terminal closures by status, "
                            "reconciled (migration hops and routing-"
                            "retry sheds deduped)",
                    "samples": [((("status", s),), float(v))
                                for s, v in sorted(
                                    reconciled_terminal_statuses(
                                        router).items())]}
                continue
            first = next(snap[name] for snap in snaps.values()
                         if name in snap)
            mode = self._rollup_mode(name, first["kind"])
            if mode is None:
                continue
            if first["kind"] == "histogram":
                agg: Dict[Any, List] = {}
                for snap in snaps.values():
                    ent = snap.get(name)
                    if ent is None:
                        continue
                    for k, (counts, s, t) in ent["hist"].items():
                        got = agg.get(k)
                        if got is None:
                            agg[k] = [list(counts), s, t]
                        else:
                            got[0] = [a + b for a, b
                                      in zip(got[0], counts)]
                            got[1] += s
                            got[2] += t
                out[rname] = {"kind": "histogram",
                              "help": f"fleet rollup of {name}",
                              "buckets": first["buckets"],
                              "hist": {k: tuple(v)
                                       for k, v in agg.items()}}
                continue
            vals: Dict[Any, float] = {}
            for snap in snaps.values():
                ent = snap.get(name)
                if ent is None:
                    continue
                for k, v in ent["samples"]:
                    if mode == "max":
                        vals[k] = max(vals.get(k, v), v)
                    else:
                        vals[k] = vals.get(k, 0.0) + v
            if vals:
                out[rname] = {"kind": first["kind"],
                              "help": f"fleet rollup of {name} "
                                      f"({mode} over replicas)",
                              "samples": sorted(vals.items())}
        return out

    # ------------------------------------------------------------------
    def prometheus_text(self) -> str:
        """The fleet's one Prometheus exposition (text format 0.0.4):
        per-replica re-export + rollups + staleness markers + the
        router's own fleet series."""
        snaps, stale = self.collect()
        lines: List[str] = []
        names: List[str] = []
        for snap in snaps.values():
            for n in snap:
                if n not in names:
                    names.append(n)
        for name in names:
            first = next(snap[name] for snap in snaps.values()
                         if name in snap)
            pname = _prom_name(name)
            if first["help"]:
                lines.append(f"# HELP {pname} {first['help']}")
            lines.append(f"# TYPE {pname} {first['kind']}")
            for rname_, snap in snaps.items():
                ent = snap.get(name)
                if ent is None:
                    continue
                if ent["kind"] == "histogram":
                    self._hist_lines(lines, pname, ent["buckets"],
                                     ent["hist"], rname_)
                else:
                    for k, v in ent["samples"]:
                        lk = _prom_label_str(_with_replica(k, rname_))
                        lines.append(f"{pname}{lk} {_fmt(v)}")
        for rname, ent in self.rollups(snaps).items():
            pname = _prom_name(rname)
            if ent["help"]:
                lines.append(f"# HELP {pname} {ent['help']}")
            lines.append(f"# TYPE {pname} {ent['kind']}")
            if ent["kind"] == "histogram":
                self._hist_lines(lines, pname, ent["buckets"],
                                 ent["hist"], None)
            else:
                for k, v in ent["samples"]:
                    lines.append(
                        f"{pname}{_prom_label_str(tuple(k))} {_fmt(v)}")
        lines.append("# HELP serving_fleet_replica_stale replica "
                     "exporting its last scrape (dead or quarantined) "
                     "rather than live truth")
        lines.append("# TYPE serving_fleet_replica_stale gauge")
        for name in snaps:
            lk = _prom_label_str((("replica", name),))
            lines.append(
                f"serving_fleet_replica_stale{lk} "
                f"{1 if stale[name] else 0}")
        text = "\n".join(lines) + "\n"
        if self._extra._metrics:
            text += self._extra.prometheus_text()
        return text + self._router.metrics.prometheus_text()

    @staticmethod
    def _hist_lines(lines: List[str], pname: str, buckets,
                    hist: Dict[Any, tuple],
                    replica: Optional[str]) -> None:
        for k in sorted(hist):
            counts, hsum, total = hist[k]
            base = _with_replica(tuple(k), replica) \
                if replica is not None else tuple(k)
            cum = 0
            for i, edge in enumerate(buckets):
                cum += counts[i]
                lk = _prom_label_str(
                    tuple(sorted(base + (("le", _fmt(edge)),))))
                lines.append(f"{pname}_bucket{lk} {cum}")
            lk = _prom_label_str(
                tuple(sorted(base + (("le", "+Inf"),))))
            lines.append(f"{pname}_bucket{lk} {cum + counts[-1]}")
            ls = _prom_label_str(base)
            lines.append(f"{pname}_sum{ls} {_fmt(hsum)}")
            lines.append(f"{pname}_count{ls} {total}")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able fleet view: per-replica scalar snapshots (labels
        flattened), rollup values, staleness."""
        snaps, stale = self.collect()
        reps: Dict[str, Any] = {}
        for name, snap in snaps.items():
            vals: Dict[str, Any] = {}
            for mname, ent in snap.items():
                if ent["kind"] == "histogram":
                    vals[mname] = {
                        _prom_label_str(tuple(k)) or "{}": {
                            "count": t, "sum": round(s, 6)}
                        for k, (c, s, t) in sorted(ent["hist"].items())}
                else:
                    vals[mname] = {
                        _prom_label_str(tuple(k)) or "{}": round(v, 6)
                        for k, v in ent["samples"]}
            reps[name] = vals
        return {"replicas": reps, "rollups": self.rollup_snapshot(snaps),
                "stale": dict(stale)}

    def rollup_snapshot(self, snaps=None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for rname, ent in self.rollups(snaps).items():
            if ent["kind"] == "histogram":
                out[rname] = {
                    _prom_label_str(tuple(k)) or "{}": {
                        "count": t, "sum": round(s, 6)}
                    for k, (c, s, t) in sorted(ent["hist"].items())}
            else:
                vals = dict(ent["samples"])
                if list(vals) == [()]:
                    out[rname] = round(vals[()], 6)
                else:
                    out[rname] = {
                        _prom_label_str(tuple(k)) or "{}": round(v, 6)
                        for k, v in vals.items()}
        return out


# --------------------------------------------------------------------------
# fleet post-mortem validation
# --------------------------------------------------------------------------

def validate_fleet_dump(dump: Dict[str, Any],
                        base_dir: Optional[str] = None) -> List[str]:
    """Schema check for one fleet post-mortem bundle's ``fleet.json``
    (loaded): returns violations, empty when valid.  With ``base_dir``
    (the bundle directory) each replica's referenced ``flight.json``
    must exist on disk too — the bundle is only a post-mortem if the
    per-replica black boxes actually landed."""
    problems: List[str] = []
    for k in FLEET_DUMP_REQUIRED_KEYS:
        if k not in dump:
            problems.append(f"missing key {k!r}")
    if dump.get("version") != FLEET_DUMP_VERSION:
        problems.append(f"version {dump.get('version')!r} != "
                        f"{FLEET_DUMP_VERSION}")
    fp = dump.get("fingerprint")
    if not (isinstance(fp, dict) and "engine_version" in fp
            and "config_hash" in fp):
        problems.append("fingerprint missing engine_version/config_hash")
    for k in ("metrics", "rollups", "journeys", "replicas"):
        if k in dump and not isinstance(dump[k], dict):
            problems.append(f"{k} is not a dict")
    if not isinstance(dump.get("events"), list):
        problems.append("events is not a list")
    rm = dump.get("request_metrics")
    if not (isinstance(rm, dict) and "aggregate" in rm):
        problems.append("request_metrics missing aggregate")
    reps = dump.get("replicas")
    for name, info in (reps.items() if isinstance(reps, dict) else ()):
        if not isinstance(info, dict) or "flight" not in info:
            problems.append(f"replica {name!r} entry missing flight")
            continue
        if base_dir is not None:
            p = os.path.join(base_dir, info["flight"])
            if not os.path.isfile(p):
                problems.append(
                    f"replica {name!r} flight dump missing: {p}")
    return problems
