"""The signal-driven autoscaling actuator (docs/SERVING.md
"Disaggregated pools & elasticity"; ROADMAP item 1 — the consumer the
fleet anomaly catalog and ``FleetConfig.telemetry="auto"`` were built
for).

The :class:`Autoscaler` closes the loop the observability plane left
open: the fleet detectors (placement imbalance, affinity
collapse, failover/migration storms, TTFT divergence) and the pool
depth/load gauges produce scaling *signals*; this actuator turns them
into ``add_replica`` / ``scale_down`` *actions*, sizing the two pools
independently — interactive TTFT is prefill-pool depth, batch TPOT is
decode-pool width.

Design rules, all step-counted and deterministic (the serving-layer
discipline — chaos replays must be machine-independent):

* **hysteresis** — a pressure signal must persist for
  ``hysteresis_steps`` consecutive evaluations before any action; one
  bursty step must not mint a replica.
* **cooldown** — after any action on a pool, that pool holds still for
  ``cooldown_steps`` router steps; the fleet must re-observe the new
  size before acting again (no thrash).
* **anomaly veto** — a fleet anomaly fired this step vetoes
  scale-DOWN everywhere (shrinking a fleet that is visibly struggling
  compounds the struggle) and arms the implicated pool's scale-up
  streak.
* **never below min, never above max** — per-pool bounds; scale-down
  drains the pool's least-loaded replica through the router's
  zero-lost ``scale_down`` path.

Attaching the actuator flips the router's ``telemetry="auto"`` plane
ON (``router.enable_telemetry()``) — the actuator IS the signal
consumer "auto" was waiting for.  Scale-ups build replicas through the
caller's ``replica_factory(pool)``; pair it with
:class:`WeightStreamColdStart` so a new replica's weights restore from
the NVMe weight store spilled once at deploy (fast cold start, and the
resident-weight modes streaming would force off stay available).

Copied from the JAX package's ``serving/autoscaler.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from ..utils.logging import logger

# which pool a fired fleet detector implicates: prompt-side signals
# pressure the prefill pool, decode-side divergence pressures decode;
# a storm is pure veto (scaling during failover churn adds churn)
_SIGNAL_POOL = {
    "placement_imbalance": "prefill",
    "affinity_hit_rate": "prefill",
    "ttft_divergence": "decode",
    "failover_migration_storm": None,
}

# SLO burn signals (``slo_burn_rate_<class>``, telemetry/slo.py) map by
# the burning class: interactive/standard budgets burn on TTFT — queue
# admission pressure, a prefill problem; a batch budget burns on TPOT —
# decode throughput.  Unknown classes lean prefill (admission is the
# commonest bottleneck and a wrong lean is bounded by pool maximums).
_SLO_BURN_POOL = {
    "interactive": "prefill",
    "standard": "prefill",
    "batch": "decode",
}
_SLO_BURN_PREFIX = "slo_burn_rate_"


def _signal_pool(sig: str) -> Optional[str]:
    if sig in _SIGNAL_POOL:
        return _SIGNAL_POOL[sig]
    if sig.startswith(_SLO_BURN_PREFIX):
        return _SLO_BURN_POOL.get(sig[len(_SLO_BURN_PREFIX):], "prefill")
    return None


@dataclasses.dataclass
class AutoscalerConfig:
    """Actuator knobs — all thresholds are integer loads and step
    counts, so decisions replay deterministically."""
    # per-pool size bounds (live replicas serving the pool)
    min_prefill: int = 1
    max_prefill: int = 4
    min_decode: int = 1
    max_decode: int = 4
    # average live+queued requests per pool replica that arm scale-up
    # / scale-down pressure
    up_load: float = 3.0
    down_load: float = 0.5
    # consecutive armed evaluations before acting (hysteresis), and
    # per-pool post-action quiet period (cooldown)
    hysteresis_steps: int = 3
    cooldown_steps: int = 8
    # evaluate every N router steps (1 = every step)
    evaluate_every: int = 1

    def __post_init__(self):
        if self.min_prefill < 1 or self.min_decode < 1:
            raise ValueError("pool minimums must be >= 1")
        if self.max_prefill < self.min_prefill \
                or self.max_decode < self.min_decode:
            raise ValueError("pool maximums must be >= their minimums")
        if self.hysteresis_steps < 1:
            raise ValueError("hysteresis_steps must be >= 1")
        if self.cooldown_steps < 0:
            raise ValueError("cooldown_steps must be >= 0")
        if self.evaluate_every < 1:
            raise ValueError("evaluate_every must be >= 1")
        if self.down_load >= self.up_load:
            raise ValueError("down_load must be < up_load (the dead "
                             "band between them is the stability zone)")


class Autoscaler:
    """Per-pool scaling actuator over one :class:`~.router.FleetRouter`
    (module docstring).  ``replica_factory(pool)`` returns a fresh
    engine for a scale-up into ``pool`` ("prefill" / "decode" /
    "mixed"); the router is stepped by its driver as usual — the
    actuator rides ``router.step`` via ``on_router_step`` once
    attached (construction attaches)."""

    def __init__(self, router,
                 replica_factory: Callable[[str], object],
                 cfg: Optional[AutoscalerConfig] = None):
        self.router = router
        self.factory = replica_factory
        self.cfg = cfg or AutoscalerConfig()
        self.decisions: List[Dict] = []
        self._up_streak = {"prefill": 0, "decode": 0}
        self._down_streak = {"prefill": 0, "decode": 0}
        self._cool_until = {"prefill": 0, "decode": 0}
        self._minted = 0
        self._last_anomalies = 0
        # the actuator IS the consumer telemetry="auto" waits for
        router.enable_telemetry()
        router._autoscaler = self

    # ---- bounds ----------------------------------------------------------
    def _bounds(self, pool: str) -> tuple:
        if pool == "prefill":
            return self.cfg.min_prefill, self.cfg.max_prefill
        return self.cfg.min_decode, self.cfg.max_decode

    # ---- the per-step evaluation ----------------------------------------
    def on_router_step(self) -> None:  # tpulint: serving-loop
        """One evaluation: fold this step's anomaly fires and pool
        loads into the streaks, act where hysteresis + cooldown +
        bounds allow.  Called by ``router.step`` after gauges and
        telemetry refresh — integer loads and counter reads only, no
        clocks (the decisions must replay)."""
        router = self.router
        if router._steps % self.cfg.evaluate_every:
            return
        # anomaly deltas since the last evaluation, attributed to pools
        fired_pools = set()
        veto = False
        ftel = router._ftel
        if ftel is not None:
            counts = ftel.monitor.counts
            total = sum(counts.values())
            if total > self._last_anomalies:
                veto = True
                for sig in counts:
                    p = _signal_pool(sig)
                    if p is not None:
                        fired_pools.add(p)
            self._last_anomalies = total
        for pool in ("prefill", "decode"):
            self._evaluate_pool(pool, pool in fired_pools, veto)

    def _evaluate_pool(self, pool: str, anomaly_up: bool,
                       veto: bool) -> None:
        router = self.router
        members = router.pool_members(pool)
        if not members:
            return
        lo, hi = self._bounds(pool)
        load = sum(r.load() for r in members) / len(members)
        if load > self.cfg.up_load or anomaly_up:
            self._up_streak[pool] += 1
            self._down_streak[pool] = 0
        elif load < self.cfg.down_load and not veto:
            self._down_streak[pool] += 1
            self._up_streak[pool] = 0
        else:
            self._up_streak[pool] = 0
            self._down_streak[pool] = 0
        if router._steps < self._cool_until[pool]:
            return
        if self._up_streak[pool] >= self.cfg.hysteresis_steps \
                and len(members) < hi:
            self._scale_up(pool, load)
        elif self._down_streak[pool] >= self.cfg.hysteresis_steps \
                and len(members) > lo:
            self._shrink(pool, members, load)

    # ---- actions ---------------------------------------------------------
    def _decide(self, pool: str, action: str, replica: str,
                load: float) -> None:
        d = {"step": int(self.router._steps), "pool": pool,
             "action": action, "replica": replica,
             "avg_load": round(float(load), 3)}
        self.decisions.append(d)
        self.router.flight.note("scale_decision", **d)
        logger.info("fleet autoscaler: %s %s pool via %s (avg load "
                    "%.2f at step %d)", action, pool, replica, load,
                    self.router._steps)
        self._cool_until[pool] = \
            self.router._steps + self.cfg.cooldown_steps
        self._up_streak[pool] = 0
        self._down_streak[pool] = 0

    def _scale_up(self, pool: str, load: float) -> None:
        self._minted += 1
        name = f"as-{pool}-{self._minted}"
        engine = self.factory(pool)
        self.router.add_replica(name, engine, role=pool)
        self.router._c_scale_ups.inc(pool=pool)
        self._decide(pool, "scale_up", name, load)

    def _shrink(self, pool: str, members, load: float) -> None:
        # drain the least-loaded member (ties broken by name for
        # determinism); its open work re-places through the router's
        # zero-lost scale_down path
        victim = min(members, key=lambda r: (r.load(), r.name))
        self.router.scale_down(victim.name)
        self.router._c_scale_downs.inc(pool=pool)
        self._decide(pool, "scale_down", victim.name, load)

    # ---- reporting -------------------------------------------------------
    def summary(self) -> Dict:
        """JSON-able decision log + streak state (bench/chaos legs)."""
        ups = sum(1 for d in self.decisions
                  if d["action"] == "scale_up")
        downs = sum(1 for d in self.decisions
                    if d["action"] == "scale_down")
        return {"decisions": [dict(d) for d in self.decisions],
                "scale_ups": ups, "scale_downs": downs,
                "up_streak": dict(self._up_streak),
                "down_streak": dict(self._down_streak)}


class WeightStreamColdStart:
    """Scale-up cold start through the NVMe weight-stream store: the
    template engine's stacked block weights are spilled ONCE (deploy
    time), and every minted replica restores them RESIDENT from the
    store's aio read path (``NVMeWeightStore.restore_stacked``)
    instead of re-running checkpoint load — the fleet's weight fabric
    is the cold-start fabric.  Because the new engine never sets
    ``icfg.weight_stream``, none of the modes streaming forces off
    (decode bursts, speculative decode) are forced on it — the test
    bar the satellite names.

    ``build`` is a zero-arg engine constructor (same config the pool
    expects); instances are valid ``replica_factory`` callables for
    :class:`Autoscaler`."""

    def __init__(self, template_engine, build: Callable[[], object],
                 path: str):
        from ..inference.weight_stream import NVMeWeightStore
        if "blocks" not in template_engine.params:
            raise ValueError("template engine has no stacked 'blocks' "
                             "params to spill")
        self.build = build
        self.store = NVMeWeightStore(path,
                                     template_engine.cfg.num_layers,
                                     device=template_engine.device)
        self.store.spill({"blocks": template_engine.params["blocks"]})
        self.restores = 0

    def __call__(self, pool: str = "mixed"):
        eng = self.build()
        # bit-identical weights from the store: token parity across a
        # scale-up is the spilled bytes' parity
        eng.params["blocks"] = \
            self.store.restore_stacked()["blocks"]
        self.restores += 1
        return eng
