"""Multi-replica serving front-end: cache-affinity routing, failover,
live request migration (docs/SERVING.md "Fleet: routing, failover,
migration"; ROADMAP item: multi-replica serving — the fleet analogue of
data-parallel replication, where availability is won at the replica
boundary).

The :class:`FleetRouter` stands where one hardened engine used to be
and speaks the same request API (``put`` / ``step`` / ``flush`` /
``cancel`` / ``query``), so the load harness and any future gateway
drive a fleet exactly like an engine.  It composes contracts earlier
PRs already built — nothing here invents a new one:

* **placement** — each NEW request is scored by prefix-cache affinity
  (longest cached-chain match of the prompt's chain digests against
  every replica's live ``prefix_digests()``; the content hashes are
  the key), falling back to least-loaded; ``round_robin`` exists as
  the measured baseline.
* **health & quarantine** — replicas are watched through the engine
  health ladder and their own failure counters; a per-replica
  :class:`~.replica.CircuitBreaker` quarantines a replica after
  consecutive failing steps (NEW placements avoid it; its open work
  keeps stepping) and re-admits it after a clean probe.
* **failover** — a replica death mid-traffic (:class:`EngineDeadError`)
  loses zero requests: the dead engine's ``snapshot()`` (host truth,
  valid on a dead backend) yields restore()-compatible per-request
  records that migrate onto surviving replicas via
  ``load_snapshot(..., merge=True)``, with bounded retry + step-counted
  exponential backoff while the fleet is unplaceable.  The
  (uid, position)-folded sampling keys make migrated streams
  token-identical to an undisturbed run.
* **live migration & scale-down** — ``migrate()`` moves a chosen
  subset of open work between live replicas (``engine.migrate_out``);
  ``scale_down()`` drains a replica and re-places exactly its
  ``shed_uids``.
* **fleet-level shed** — a request is rejected only when EVERY
  routable replica's own admission bound shed it (the 429-equivalent);
  one replica's backpressure is the next replica's placement.
* **disaggregated pools** — replicas carry roles (``prefill`` /
  ``decode`` / ``mixed``): with both pools present, new arrivals place
  SLO-class-aware (interactive prompts onto chunk-free prefill
  replicas, batch streams straight onto the decode pool), and a
  request that finishes prefill on a pure-prefill replica is shipped
  to a decode replica as routing plus block transfer
  (``engine.handoff_out`` → ``load_snapshot(merge=True)``, the KV
  chain riding the same ``export_tier_chain`` path an affinity-miss
  restage uses) — docs/SERVING.md "Disaggregated pools & elasticity".

Everything is step-counted and host-side: no wall-clock waits, no
polling loops — the router's only clock is its own step counter, so
chaos replays stay machine-independent (the same discipline tpulint's
``serving-wait`` rule enforces on the marked methods below).

Copied from the JAX package's ``serving/router.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..inference import SamplingParams
from ..inference.engine import InferenceEngine
from ..inference.failures import EngineDeadError
from ..inference.overload import AdmissionVerdict
from ..inference.ragged.state import iter_prefix_chain_digests
from ..telemetry import (FlightRecorder, MetricsRegistry,
                         config_fingerprint, merge_scorecards)
from ..utils.logging import logger
from .fleet_telemetry import (FLEET_DUMP_VERSION, NOOP_CTX, FleetRegistry,
                              FleetTelemetry, FleetTelemetryConfig,
                              fleet_request_metrics)
from .placement import (PLACEMENT_POLICIES, REPLICA_ROLES, rank_replicas,
                        split_by_pool)
from .replica import ReplicaHandle

# fleet-level view of engine health states, exported per replica as
# the serving_fleet_replica_health gauge (same 0-3 code space as the
# engine's own serving_health_state; 4 = router-quarantined)
_HEALTH_CODE = {"healthy": 0, "degraded": 1, "draining": 2, "dead": 3}


@dataclasses.dataclass
class FleetConfig:
    """Knobs for the fleet router."""
    # placement policy for NEW requests: "affinity" (longest cached-
    # chain match, least-loaded tiebreak), "least_loaded", or
    # "round_robin" (the bench baseline the affinity bar beats)
    placement: str = "affinity"
    # circuit breaker: consecutive failing steps before a replica is
    # quarantined from new placements, and how many router steps the
    # quarantine lasts before the half-open probe
    failure_threshold: int = 2
    probe_interval_steps: int = 8
    # migration placement: bounded retries with step-counted
    # exponential backoff (base * 2^attempt, capped) while no replica
    # is routable; exhausted retries close the request "shed" at the
    # fleet level rather than parking it forever
    max_migration_retries: int = 8
    migration_backoff_steps: int = 1
    # fleet observability plane (docs/OBSERVABILITY.md "Fleet
    # observability"): "on" constructs the FleetTelemetry object
    # (journeys, router spans, fleet anomaly detectors, capture
    # budget); "off" constructs NOTHING and adds zero clock reads per
    # router step (the counted zero-cost bar).  "auto" resolves OFF until
    # a signal consumer flips it: attaching the autoscaling actuator
    # (serving/autoscaler.py) calls router.enable_telemetry(), exactly
    # like the engines' anomaly/device_telemetry gates
    telemetry: str = "auto"
    telemetry_cfg: Optional[FleetTelemetryConfig] = None
    # fleet post-mortem bundles: router.debug_dump() target for the
    # failover/quarantine/fleet-shed auto-dumps (None = no auto-dumps),
    # bounded by max_autodumps per router generation
    flight_dir: Optional[str] = None
    max_autodumps: int = 8

    def __post_init__(self):
        if self.placement not in PLACEMENT_POLICIES:
            raise ValueError(f"placement={self.placement!r}: expected "
                             f"one of {PLACEMENT_POLICIES}")
        if self.telemetry not in ("auto", "on", "off"):
            raise ValueError(f"telemetry={self.telemetry!r}: expected "
                             "'auto', 'on', or 'off'")
        if self.max_autodumps < 0:
            raise ValueError("max_autodumps must be >= 0")
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.probe_interval_steps < 1:
            raise ValueError("probe_interval_steps must be >= 1")
        if self.max_migration_retries < 0:
            raise ValueError("max_migration_retries must be >= 0")
        if self.migration_backoff_steps < 1:
            raise ValueError("migration_backoff_steps must be >= 1")


@dataclasses.dataclass
class _Migration:
    """One request record waiting for re-placement (failover, live
    migration, scale-down, or a prefill→decode handoff).  ``pool``
    targets the placement at one pool (ranked fallback to the rest —
    a full pool degrades to colocated placement, never to a lost
    request); ``via`` labels the journey's "placed" event."""
    rec: Dict
    source: str
    attempts: int = 0
    next_step: int = 0
    pool: Optional[str] = None
    via: str = "migration"


class FleetRouter:
    """N engine replicas behind one engine-shaped front-end (module
    docstring).  ``replicas``: ``{name: InferenceEngine}`` (insertion
    order is the deterministic rank tiebreak) or a sequence of engines
    auto-named ``r0, r1, ...``."""

    def __init__(self, replicas, cfg: Optional[FleetConfig] = None,
                 roles: Optional[Dict[str, str]] = None):
        self.cfg = cfg or FleetConfig()
        self._reps: Dict[str, ReplicaHandle] = {}
        self._block_size: Optional[int] = None
        self._max_blocks = 1      # hash budget: fleet max blocks/seq
        self._owner: Dict[int, str] = {}      # open uid -> replica name
        self._closed: Dict[int, str] = {}     # fleet-terminal statuses
        self._reaped: set = set()             # fleet closures to report
        self._migrations: List[_Migration] = []
        self._steps = 0
        self._rr = 0                          # round-robin cursor
        # uids already handed off prefill→decode once this life: a
        # fallback placement that lands one back on a prefill replica
        # must not re-extract it (no ping-pong); size-bounded
        self._handed: set = set()
        # the attached scaling actuator (serving/autoscaler.py); the
        # router drives it once per step, after telemetry feeds
        self._autoscaler = None
        # reconciliation ledgers (docs/OBSERVABILITY.md "Fleet
        # observability"): per-(uid, replica) phantom-shed counts
        # (engine shed closures that were fleet routing retries —
        # bounded FIFO), fleet-level closures that left NO engine
        # terminal, and record-gap closures that left NO engine record
        # at all (fleet_request_metrics adds them to its tally)
        self._phantoms: Dict[Tuple[int, str], int] = {}
        self._fleet_closures: Dict[str, int] = {}
        self._record_gaps: Dict[str, int] = {}
        self._setup_metrics()
        # the black box is ALWAYS constructed (engine discipline: the
        # happy path never touches it; the failure path's breadcrumbs
        # must exist before the incident someone debugs).  Placement
        # decisions are noted only when the telemetry plane is on
        self.flight = FlightRecorder()
        self._autodumps = 0
        tmode = self.cfg.telemetry
        # "auto" resolves OFF until a consumer flips it — attaching
        # the autoscaler calls enable_telemetry(), like the engines'
        # anomaly/device_telemetry gates
        self._ftel: Optional[FleetTelemetry] = FleetTelemetry(
            self.cfg.telemetry_cfg, self.metrics) \
            if tmode == "on" else None
        # the fleet-wide exposition view; pull-only, so constructing
        # it costs nothing on the serving path
        self.fleet_registry = FleetRegistry(self)
        items = replicas.items() if isinstance(replicas, dict) \
            else ((f"r{i}", e) for i, e in enumerate(replicas))
        for name, eng in items:
            self.add_replica(name, eng,
                             role=(roles or {}).get(name, "mixed"))
        if not self._reps:
            raise ValueError("FleetRouter needs at least one replica")

    def _setup_metrics(self) -> None:
        """Fleet gauges/counters (docs/OBSERVABILITY.md "Fleet
        gauges") — host counter bumps only, exported through the same
        registry/exposition machinery the engines use."""
        self.metrics = MetricsRegistry()
        reg = self.metrics
        self._c_placements = reg.counter(
            "serving_fleet_placements_total",
            "new requests placed on a replica (label policy=)",
            int_valued=True)
        self._c_place_hits = reg.counter(
            "serving_fleet_placement_affinity_hits_total",
            "placements whose chosen replica held a nonzero cached "
            "chain for the prompt", int_valued=True)
        self._c_shed = reg.counter(
            "serving_fleet_shed_total",
            "requests shed at the FLEET level (every routable replica "
            "rejected, or migration retries exhausted) — the "
            "429-equivalent", int_valued=True)
        self._c_failovers = reg.counter(
            "serving_fleet_failovers_total",
            "replica deaths answered by snapshot migration",
            int_valued=True)
        self._c_migrations = reg.counter(
            "serving_fleet_migrations_total",
            "request records re-placed onto a surviving replica",
            int_valued=True)
        self._c_migration_retries = reg.counter(
            "serving_fleet_migration_retries_total",
            "migration placements deferred by backoff (no routable "
            "replica at that step)", int_valued=True)
        self._c_quarantines = reg.counter(
            "serving_fleet_quarantines_total",
            "circuit-breaker trips (replica quarantined from new "
            "placements)", int_valued=True)
        self._c_readmissions = reg.counter(
            "serving_fleet_readmissions_total",
            "quarantined replicas re-admitted after a clean probe",
            int_valued=True)
        self._c_failed = reg.counter(
            "serving_fleet_requests_failed_total",
            "requests closed 'failed' at the fleet level (inexact "
            "records whose device-side tokens died with a replica)",
            int_valued=True)
        self._c_phantom = reg.counter(
            "serving_fleet_replica_shed_retries_total",
            "engine-level shed closures that were fleet routing "
            "retries — phantom terminals the reconciled fleet rollups "
            "subtract back out", int_valued=True)
        self._c_tier_fetches = reg.counter(
            "serving_fleet_tier_fetches_total",
            "cross-replica KV tier chain fetches: a spilled chain "
            "pulled from a peer replica's tier into the chosen "
            "replica's (docs/KV_TIERING.md)", int_valued=True)
        self._c_tier_fetch_blocks = reg.counter(
            "serving_fleet_tier_fetch_blocks_total",
            "KV blocks moved by cross-replica tier fetches",
            int_valued=True)
        self._c_tier_fetch_rejects = reg.counter(
            "serving_fleet_tier_fetch_rejects_total",
            "tier-fetch payloads rejected by digest/checksum "
            "verification on arrival (the chosen replica re-prefills "
            "instead)", int_valued=True)
        self._c_handoffs = reg.counter(
            "serving_fleet_handoffs_total",
            "prefill→decode handoffs: requests extracted from a "
            "prefill replica after first token and re-placed on the "
            "decode pool (docs/SERVING.md \"Disaggregated pools & "
            "elasticity\")", int_valued=True)
        self._c_scale_ups = reg.counter(
            "serving_fleet_scale_ups_total",
            "replicas added by the autoscaling actuator (label "
            "pool=)", int_valued=True)
        self._c_scale_downs = reg.counter(
            "serving_fleet_scale_downs_total",
            "replicas drained away by the autoscaling actuator "
            "(label pool=)", int_valued=True)
        self._g_replicas = reg.gauge(
            "serving_fleet_replicas", "replicas registered (incl. dead)")
        self._g_routable = reg.gauge(
            "serving_fleet_replicas_routable",
            "replicas currently accepting new placements")
        self._g_rep_health = reg.gauge(
            "serving_fleet_replica_health",
            "per-replica health (label replica=): 0 healthy 1 degraded "
            "2 draining 3 dead 4 quarantined")
        self._g_pool_replicas = reg.gauge(
            "serving_fleet_pool_replicas",
            "live replicas serving a pool (label pool=; mixed "
            "replicas serve both, so the pools may overlap)")
        self._g_pool_load = reg.gauge(
            "serving_fleet_pool_load",
            "summed live+queued requests across a pool's replicas "
            "(label pool=) — the depth/width signal the autoscaler "
            "sizes each pool by")
        reg.gauge_fn("serving_fleet_requests_migrating",
                     lambda: len(self._migrations),
                     "request records waiting for re-placement")
        reg.gauge_fn("serving_fleet_placement_hit_rate",
                     self._placement_hit_rate,
                     "affinity-hit placements / placements (absent "
                     "before the first placement)")

    def _placement_hit_rate(self) -> Optional[float]:
        total = self.metrics.series_sum("serving_fleet_placements_total")
        if not total:
            return None
        return self._c_place_hits.value() / total

    # ------------------------------------------------------------------
    # fleet membership
    # ------------------------------------------------------------------
    def add_replica(self, name: str, engine: InferenceEngine,
                    role: str = "mixed") -> None:
        """Register a replica (scale-up).  Fleets must share one KV
        block size — the chain digest is block-aligned, so a
        heterogeneous fleet could never compare affinity keys.
        ``role`` joins it to a pool (docs/SERVING.md "Disaggregated
        pools & elasticity"); a ``prefill`` replica's prompt ingestion
        is made chunk-free here — the chunk cap exists to protect
        decode TPOT on a replica that also decodes, which a pure
        prefill replica never does."""
        if name in self._reps:
            raise ValueError(f"replica {name!r} already registered")
        bs = engine.icfg.kv_block_size
        if self._block_size is None:
            self._block_size = bs
        elif bs != self._block_size:
            raise ValueError(
                f"replica {name!r} has kv_block_size={bs}, fleet uses "
                f"{self._block_size}: affinity digests are block-"
                "aligned and cannot mix sizes")
        self._max_blocks = max(self._max_blocks,
                               engine.max_blocks_per_seq)
        if role == "prefill" and engine.ocfg.prefill_chunk is not None:
            engine.ocfg = dataclasses.replace(engine.ocfg,
                                              prefill_chunk=None)
            logger.info("fleet: replica %s joins the prefill pool "
                        "chunk-free (prefill_chunk cleared)", name)
        self._reps[name] = ReplicaHandle(
            name, engine, threshold=self.cfg.failure_threshold,
            probe_interval=self.cfg.probe_interval_steps, role=role)

    def replica(self, name: str) -> ReplicaHandle:
        return self._reps[name]

    @property
    def replica_names(self) -> List[str]:
        return list(self._reps)

    def _routable(self) -> List[ReplicaHandle]:
        return [r for r in self._reps.values() if r.routable()]

    def _roles(self) -> Dict[str, str]:
        return {name: rep.role for name, rep in self._reps.items()}

    def _disaggregated(self) -> bool:
        """Pools are ACTIVE: at least one live prefill replica and at
        least one live replica that can decode (decode or mixed).  An
        all-mixed fleet — every pre-roles caller — never splits."""
        has_prefill = has_decode = False
        for rep in self._reps.values():
            if rep.dead:
                continue
            if rep.role == "prefill":
                has_prefill = True
            else:
                has_decode = True
        return has_prefill and has_decode

    def pool_members(self, pool: str) -> List[ReplicaHandle]:
        """Live replicas serving ``pool`` — dedicated-role replicas
        when the pool has any, else the mixed replicas standing in
        for it (an all-mixed fleet IS both pools)."""
        live = [r for r in self._reps.values() if not r.dead]
        exact = [r for r in live if r.role == pool]
        if exact:
            return exact
        return [r for r in live if r.role == "mixed"]

    def _arrival_pool(self, slo_class: Optional[str]) -> Optional[str]:
        """Which pool a NEW arrival targets.  None (no split) while
        the fleet isn't disaggregated.  Batch-class streams place
        straight onto the decode pool — their TTFT is not the SLO, and
        keeping them off the prefill replicas keeps prefill-pool depth
        (= interactive TTFT) low; everything else ingests chunk-free
        on the prefill pool and hands off after first token."""
        if not self._disaggregated():
            return None
        return "decode" if slo_class == "batch" else "prefill"

    def enable_telemetry(self) -> None:
        """Flip the ``telemetry="auto"`` fleet observability plane ON
        — the autoscaler's attach path: the actuator is the signal
        consumer "auto" was waiting for, exactly like the engines'
        anomaly/device_telemetry gates.  Idempotent; a hard "off" is
        respected (the operator said no)."""
        if self._ftel is None and self.cfg.telemetry != "off":
            self._ftel = FleetTelemetry(self.cfg.telemetry_cfg,
                                        self.metrics)

    def _score_candidates(self, tokens, cands) -> Dict[str, int]:
        """Leading-run affinity scores for one prompt against every
        candidate's LIVE index dict, from one shared LAZY digest
        stream: hashing stops at the block where every candidate's run
        has missed (a fleet-wide cache-miss prompt hashes ONE block —
        the same discipline as ``match_prefix``) and is capped at the
        fleet's max blocks/seq (blocks past it can never be cached)."""
        scores = {name: 0 for name, _, _ in cands}
        alive = {name: idx for name, idx, _ in cands}
        if alive:
            for h in iter_prefix_chain_digests(
                    tokens, self._block_size, self._max_blocks):
                for name in list(alive):
                    if h in alive[name]:
                        scores[name] += 1
                    else:
                        del alive[name]
                if not alive:
                    break
        return scores

    def _rank(self, tokens,
              pool: Optional[str] = None
              ) -> Tuple[List[str], Dict[str, int]]:
        """Rank routable replicas for one placement.  Half-open
        (probing) replicas rank strictly AFTER every closed one
        whatever their affinity — quarantine means minimal traffic, so
        they only receive work when no closed replica can take it (and
        that one placement is the probe).  ``pool`` stable-partitions
        each group so pool-serving replicas keep their rank ahead of
        the rest (a ranked fallback, never a hard filter — a full pool
        degrades to colocated placement, not a lost request)."""
        closed = [(rep.name, rep.digest_index(), rep.load())
                  for rep in self._routable()
                  if rep.breaker.state == "closed"]
        probing = [(rep.name, rep.digest_index(), rep.load())
                   for rep in self._routable()
                   if rep.breaker.state == "half_open"]
        scores = self._score_candidates(tokens, closed + probing)
        roles = self._roles() if pool is not None else {}
        order, _ = rank_replicas(self.cfg.placement, (), closed,
                                 rr_offset=self._rr, scores=scores)
        order = split_by_pool(order, roles, pool)
        if probing:
            p_order, _ = rank_replicas(
                self.cfg.placement, (), probing,
                rr_offset=self._rr, scores=scores)
            order = order + split_by_pool(p_order, roles, pool)
        return order, scores

    def _tier_fetch(self, uid: int, name: str, tokens) -> None:  # tpulint: serving-loop
        """Cross-replica KV tier fetch (docs/KV_TIERING.md "The tier as
        a fleet asset").  After placing ``uid`` on replica ``name``,
        find the prompt-chain CONTINUATION the chosen replica cannot
        serve locally (neither resident nor tiered) but some peer still
        holds in ITS tier, and move that leading run over the
        snapshot-v2 record path — ``export_tier_chain`` (checksum-
        verified on the way out) into ``load_snapshot(merge=True)``
        (digest+checksum re-verified on arrival; a rejected payload
        leaves the destination untouched and the stream simply
        re-prefills).  Host-side bytes only — no device work; the
        destination engine restages the blocks through its own
        dispatch-overlapped revive path."""
        dst = self._reps[name].engine
        if getattr(dst.state, "tier", None) is None or len(self._reps) < 2:
            return
        peers = [(p, tier)
                 for p, rep in self._reps.items()
                 if p != name and not rep.dead
                 and (tier := getattr(rep.engine.state, "tier",
                                      None)) is not None
                 and len(tier)]
        if not peers:
            return
        local = self._reps[name].digest_index()
        digests = list(iter_prefix_chain_digests(
            tokens, self._block_size, self._max_blocks))
        n = 0
        for h in digests:
            if h not in local:
                break              # match_prefix stops here too
            n += 1
        rest = digests[n:]
        if not rest:
            return
        best, best_len = None, 0
        for peer, tier in peers:
            k = 0
            for h in rest:
                if h not in tier:
                    break          # only a leading run is restageable
                k += 1
            if k > best_len:
                best, best_len = peer, k
        if best is None:
            return
        payload = self._reps[best].engine.export_tier_chain(
            rest[:best_len])
        if payload is None:
            return                 # peer's copy vanished or failed export
        try:
            dst.load_snapshot(payload, merge=True)
        except ValueError as e:
            # verification rejected the payload on arrival: count it,
            # keep the placement — the request re-prefills normally
            self._c_tier_fetch_rejects.inc()
            self.flight.note("tier_fetch_reject", uid=int(uid),
                             src=best, dst=name)
            logger.warning("fleet: tier fetch %s -> %s rejected (%s)",
                           best, name, e)
            return
        nblk = len(payload["tier_blocks"])
        self._c_tier_fetches.inc()
        self._c_tier_fetch_blocks.inc(nblk)
        if self._ftel is not None:
            self._ftel.journey_event(uid, "tier_fetch", self._steps,
                                     replica=name, src=best,
                                     blocks=nblk)

    # ------------------------------------------------------------------
    # the engine-shaped request API
    # ------------------------------------------------------------------
    def put(self, uid: int, tokens: Sequence[int], priority: int = 0,
            deadline_ms: Optional[float] = None,
            slo_class: Optional[str] = None) -> AdmissionVerdict:  # tpulint: serving-loop
        """Route a request.  Continuations forward to the owning
        replica (or join the request's queued migration record — the
        fed-back token is simply the next stream token).  NEW requests
        are placed by the configured policy; a replica's shed verdict
        sends the request to the NEXT candidate, and only when every
        routable replica sheds does the fleet shed (``replica=None`` on
        the verdict — the 429-equivalent).  ``slo_class`` (the
        gateway's resolved ``x-slo-class``) steers the placement's pool
        on a disaggregated fleet; it never changes admission."""
        owner = self._owner.get(uid)
        if owner is not None:
            v = self._reps[owner].engine.put(uid, tokens,
                                             priority=priority,
                                             deadline_ms=deadline_ms,
                                             slo_class=slo_class)
            return v._replace(replica=owner)
        for m in self._migrations:
            if m.rec["uid"] == uid:
                m.rec["tokens"].extend(int(t) for t in tokens)
                return AdmissionVerdict(True, "continued",
                                        reason="joined migration record")
        ft = self._ftel
        if ft is not None:
            # a revived uid (fleet-shed then re-admitted) gets a FRESH
            # journey — the dead life's story must not leak into it
            ft.begin_journey(uid)
        pool = self._arrival_pool(slo_class)
        with (ft.span("placement", uid=int(uid)) if ft is not None
              else NOOP_CTX):
            order, scores = self._rank(tokens, pool=pool)
            if self.cfg.placement == "round_robin" and order:
                # the rotation cursor advances per ARRIVAL, here only —
                # migration placements also rank (in _place_record) and
                # must not skew the baseline's rotation over new requests
                self._rr += 1
            for name in order:
                v = self._reps[name].engine.put(uid, tokens,
                                                priority=priority,
                                                deadline_ms=deadline_ms,
                                                slo_class=slo_class)
                for eu in v.evicted_uids:
                    # evict-lowest backpressure shed a queued request on
                    # that replica: terminal at the fleet level too
                    self._closed[eu] = "shed"
                    self._owner.pop(eu, None)
                    self._reaped.add(eu)
                    if ft is not None:
                        ft.journey_event(eu, "closed", self._steps,
                                         replica=name, status="shed",
                                         reason="evicted by backpressure")
                if v.admitted:
                    self._owner[uid] = name
                    # a terminal uid that returns lives a full new life —
                    # the engine's own reuse semantics, mirrored.  The
                    # stale reaped entry goes too: a driver draining later
                    # must not drop the now-live request as closed
                    self._closed.pop(uid, None)
                    self._reaped.discard(uid)
                    self._handed.discard(uid)
                    self._c_placements.inc(policy=self.cfg.placement)
                    if scores.get(name, 0) > 0:
                        self._c_place_hits.inc()
                    if ft is not None:
                        ft.last_placed = name
                        extra = {}
                        if pool is not None:
                            extra = {"pool": pool,
                                     "slo": slo_class or "standard"}
                        ft.journey_event(
                            uid, "placed", self._steps, replica=name,
                            via="arrival", policy=self.cfg.placement,
                            score=int(scores.get(name, 0)), **extra)
                    # the chosen replica may be missing part of the
                    # prompt's chain that a PEER spilled to its tier:
                    # fetch it now, before first admission, so the
                    # engine's match sees it and restages instead of
                    # re-prefilling (docs/KV_TIERING.md)
                    self._tier_fetch(uid, name, tokens)
                    return v._replace(replica=name)
                # this replica shed a put the fleet will retry
                # elsewhere: its engine-side terminal is a PHANTOM the
                # reconciled fleet accounting subtracts back out
                self._note_phantom(uid, name)
                if ft is not None:
                    ft.journey_event(uid, "replica_shed", self._steps,
                                     replica=name, reason=v.reason)
        self._c_shed.inc()
        self._fleet_closures["shed"] = \
            self._fleet_closures.get("shed", 0) + 1
        # a saturation shed leaves NO fleet-visible record (every
        # engine record was a phantom): the record view adds it back
        self._note_record_gap(uid, "shed")
        self._closed[uid] = "shed"
        self._reaped.add(uid)
        self.flight.note("fleet_shed", uid=int(uid),
                         routable=len(order))
        if ft is not None:
            ft.journey_event(uid, "closed", self._steps, status="shed",
                             reason="fleet saturated" if order
                             else "no routable replica")
        self._autodump("fleet_shed")
        return AdmissionVerdict(
            False, "shed",
            reason="fleet saturated: every routable replica shed the "
                   "request" if order else "no routable replica")

    def _life_has_hop(self, uid: int) -> bool:
        """Whether ``uid``'s CURRENT fleet life still ends in a hop
        record somewhere — a ``migrated`` close or a dead replica's
        open record that the merged-record view will resolve with the
        fleet status.  A fleet-level closure of a life WITH a hop is
        already visible to ``fleet_request_metrics``; one WITHOUT (all
        its engine records were phantom routing-retry sheds, or it
        never held one) must be tallied in the record-gap ledger or
        the record view undercounts.  Walks the same phantom-dropped
        record chain the merged view builds (failure-path only — never
        per step)."""
        items = []
        for name, rep in self._reps.items():
            dead = rep.dead
            for rec in rep.engine.requests.records():
                if rec.uid == uid:
                    items.append((rec.t_arrival, name, rec, dead))
        items.sort(key=lambda e: e[0])
        budget = {k: v for k, v in self._phantoms.items()
                  if k[0] == uid}
        last = None
        for t, name, rec, dead in items:
            if rec.status == "shed" and budget.get((uid, name), 0) > 0:
                budget[(uid, name)] -= 1
                continue
            last = (rec, dead)
        if last is None:
            return False
        rec, dead = last
        return rec.status in ("migrated", "handed_off") \
            or (dead and rec.status == "open")

    def _note_record_gap(self, uid: int, status: str) -> None:
        """Tally a fleet-level closure the merged-record view cannot
        see (no surviving record for the life)."""
        if not self._life_has_hop(uid):
            self._record_gaps[status] = \
                self._record_gaps.get(status, 0) + 1

    def _note_phantom(self, uid: int, name: str) -> None:
        """One engine-level shed closure that was a fleet routing
        retry, not a fleet terminal (put retried the next candidate, or
        scale-down re-placed the drain's shed set).  Counted for the
        reconciled rollups and remembered per (uid, replica) so the
        merged record view can drop exactly those records; the map is
        FIFO-bounded like the lifecycle tracker's forgotten set."""
        self._c_phantom.inc()
        key = (int(uid), name)
        self._phantoms[key] = self._phantoms.get(key, 0) + 1
        while len(self._phantoms) > 8192:
            self._phantoms.pop(next(iter(self._phantoms)))

    def step(self, rng=None,
             sampling: SamplingParams = SamplingParams()
             ) -> Dict[int, int]:  # tpulint: serving-loop
        """One fleet step: every live replica runs one engine step
        (quarantined replicas included — their open work must finish,
        and their clean steps are what the probe eventually certifies),
        breaker bookkeeping folds in each replica's outcome, a replica
        that died mid-step fails over, and the migration queue pumps.
        Returns the merged ``{uid: token}`` emissions — uids are
        disjoint across replicas because each open request is owned by
        exactly one."""
        self._steps += 1
        outs: Dict[int, int] = {}
        for name in list(self._reps):
            rep = self._reps[name]
            if rep.dead:
                continue
            rep.breaker.tick(self._steps)
            try:
                o = rep.engine.step(rng=rng, sampling=sampling)
            except EngineDeadError:
                self._failover(name)
                continue
            ev = rep.observe(self._steps)
            if ev == "opened":
                self._c_quarantines.inc()
                self.flight.note("quarantine", replica=name,
                                 failures=rep.breaker.failures,
                                 step=self._steps)
                if self._ftel is not None:
                    # every request riding the quarantined replica
                    # carries the detour in its journey
                    with self._ftel.span("quarantine", replica=name):
                        for juid, own in self._owner.items():
                            if own == name:
                                self._ftel.journey_event(
                                    juid, "quarantined", self._steps,
                                    replica=name)
                logger.warning(
                    "fleet: replica %s quarantined after %d consecutive "
                    "failing steps (probe in %d steps)", name,
                    rep.breaker.failures, self.cfg.probe_interval_steps)
                self._autodump("quarantine")
            elif ev == "readmitted":
                self._c_readmissions.inc()
                self.flight.note("readmitted", replica=name,
                                 step=self._steps)
                logger.warning(
                    "fleet: replica %s re-admitted after a clean probe",
                    name)
            for uid in rep.engine._drain_reaped():
                self._note_engine_close(rep, uid)
            outs.update(o)
        # handoffs enqueue BEFORE the migration pump so extraction and
        # re-placement land in the SAME router step: the decode
        # replica admits the record at its next schedule pass, inside
        # its depth-2 dispatch-ahead window — arrival overlaps the
        # step already in flight and TPOT never stalls on it
        self._pump_handoffs(outs)
        self._pump_migrations()
        self._refresh_gauges()
        if self._ftel is not None:
            # fleet anomaly signals ride the counters and integer
            # loads this step already produced — no added clock reads
            self._ftel.feed_step(self)
        if self._autoscaler is not None:
            # the actuator reads the gauges/anomalies this step just
            # refreshed and may add_replica/scale_down — membership
            # changes take effect at the NEXT step's replica loop
            self._autoscaler.on_router_step()
        return outs

    def _pump_handoffs(self, outs: Dict[int, int]) -> None:  # tpulint: serving-loop
        """Ship every request that finished prefill this step on a
        pure-prefill replica to the decode pool (docs/SERVING.md
        "Disaggregated pools & elasticity").  A uid emitting a token
        on a prefill replica IS the prefill-done signal — its prompt
        is fully ingested.  ``engine.handoff_out`` closes it there
        (``handed_off``) with its KV chain staged into the source
        tier; the record enqueues for decode-pool placement and the
        migration pump places it within this same step, after which
        the chain rides ``_tier_fetch`` to the destination.  The
        driver's fed-back token joins the queued record exactly like
        a migration continuation."""
        if not self._disaggregated():
            return
        by_src: Dict[str, List[int]] = {}
        for uid in outs:
            name = self._owner.get(uid)
            if name is None or uid in self._handed:
                continue
            rep = self._reps.get(name)
            if rep is None or rep.dead or rep.role != "prefill":
                continue
            by_src.setdefault(name, []).append(uid)
        for name, uids in by_src.items():
            rep = self._reps[name]
            with (self._ftel.span("handoff", replica=name,
                                  n=len(uids))
                  if self._ftel is not None else NOOP_CTX):
                part = rep.engine.handoff_out(uids)
                for rec in part["requests"]:
                    uid = int(rec["uid"])
                    self._owner.pop(uid, None)
                    self._handed.add(uid)
                    self._c_handoffs.inc()
                    if self._ftel is not None:
                        self._ftel.journey_event(
                            uid, "handed_off", self._steps,
                            replica=name, via="prefill_done")
                    self._migrations.append(_Migration(
                        rec=rec, source=name, next_step=self._steps,
                        pool="decode", via="handoff"))
            for uid in rep.engine._drain_reaped():
                self._note_engine_close(rep, uid)  # "handed_off": early out
        while len(self._handed) > 8192:
            self._handed.pop()

    def flush(self, uid: int) -> None:
        """Client-side completion — forwards to the owner and records
        the fleet-terminal status.  A uid waiting in the migration
        queue settles HERE: the client is done with it, and a record
        left in the queue would re-run on a survivor as an orphan
        nobody ever drives or flushes."""
        for i, m in enumerate(self._migrations):
            if m.rec["uid"] == uid:
                del self._migrations[i]
                self._close_queued(m, "finished")
                return
        owner = self._owner.pop(uid, None)
        if owner is None:
            return
        self._reps[owner].engine.flush(uid)
        self._closed[uid] = "finished"
        if self._ftel is not None:
            self._ftel.journey_event(uid, "closed", self._steps,
                                     replica=owner, status="finished")

    def _close_queued(self, m: _Migration, status: str) -> None:
        """A record settled while waiting in the migration queue: the
        fleet closure has no engine terminal (the source closed it
        ``migrated`` — or, for a scale-down record, a reconciled-away
        ``shed``), so both reconciliation ledgers take it here."""
        uid = int(m.rec["uid"])
        self._closed[uid] = status
        self._fleet_closures[status] = \
            self._fleet_closures.get(status, 0) + 1
        self._note_record_gap(uid, status)
        if self._ftel is not None:
            self._ftel.journey_event(uid, "closed", self._steps,
                                     status=status,
                                     reason="settled in migration queue")

    def cancel(self, uid: int) -> None:
        """Client abort, wherever the request is: owned by a replica,
        waiting in the migration queue, or already gone (no-op)."""
        for i, m in enumerate(self._migrations):
            if m.rec["uid"] == uid:
                del self._migrations[i]
                self._close_queued(m, "cancelled")
                self._reaped.add(uid)
                return
        owner = self._owner.pop(uid, None)
        if owner is None:
            return
        rep = self._reps[owner]
        rep.engine.cancel(uid)
        for ru in rep.engine._drain_reaped():
            if ru != uid:          # other staged closures still surface
                self._note_engine_close(rep, ru)
        self._closed[uid] = "cancelled"
        self._reaped.add(uid)
        if self._ftel is not None:
            self._ftel.journey_event(uid, "closed", self._steps,
                                     replica=owner, status="cancelled")

    def query(self, uid: int) -> Dict:
        """Fleet-level request status: the owning replica's ``query()``
        plus ``replica``; ``migrating`` while a record waits for
        re-placement; the fleet-terminal status after closure.  With
        the telemetry plane on, the request's JOURNEY (its placed /
        quarantined / migrated / failed-over hops) rides along under
        ``"journey"``."""
        d = self._query_status(uid)
        if self._ftel is not None:
            j = self._ftel.journey(uid)
            if j is not None:
                d["journey"] = j
        return d

    def _query_status(self, uid: int) -> Dict:
        if uid in self._closed:
            return {"status": self._closed[uid], "replica": None}
        for m in self._migrations:
            if m.rec["uid"] == uid:
                return {"status": "migrating", "replica": None,
                        "generated": list(m.rec.get("generated", []))}
        owner = self._owner.get(uid)
        if owner is not None:
            d = self._reps[owner].engine.query(uid)
            d["replica"] = owner
            return d
        return {"status": "unknown", "replica": None}

    def request_journey(self, uid: int) -> Optional[List[Dict]]:
        """The request's fleet journey — placed → (quarantined |
        migrated | failed-over)* → terminal, step-counter timestamps
        and reasons (docs/OBSERVABILITY.md "Fleet observability").
        None when the telemetry plane is off or the uid is unknown."""
        if self._ftel is None:
            return None
        return self._ftel.journey(uid)

    def _fleet_status_of(self, uid: int) -> str:
        """Where a record with no live engine tail ended up, fleet-
        side: queued for re-placement, fleet-closed, or (conservative
        fallback) still open — the merged-record view's trailing-hop
        resolver."""
        for m in self._migrations:
            if m.rec["uid"] == uid:
                return "migrating"
        return self._closed.get(uid, "open")

    def drain_reaped(self) -> set:
        """Uids the FLEET terminally closed since the last call
        (replica-side closures, fleet sheds, failed migrations) — the
        driver drops them from its active set, exactly like
        ``engine._drain_reaped``."""
        out = self._reaped
        self._reaped = set()
        return out

    def _note_engine_close(self, rep: ReplicaHandle, uid: int) -> None:
        """An engine-side terminal closure surfaced through that
        replica's reaped set.  ``migrated`` / ``handed_off`` are NOT
        fleet closures — the record is in flight to another replica.
        A STALE report is ignored: a uid shed on this replica and then
        re-admitted on another before the reaped set drained is live
        THERE — closing it here would orphan the revived request."""
        own = self._owner.get(uid)
        if own is not None and own != rep.name:
            return
        s = rep.engine.query(uid)["status"]
        if s in ("migrated", "handed_off"):
            return
        if s in ("queued", "running"):
            # the engine reaps only at terminal close, so a LIVE status
            # means the uid was re-admitted on this replica after the
            # reap was staged (same revival race, same-replica form)
            return
        if s in ("unknown", "forgotten"):
            s = "released"
        self._closed[uid] = s
        self._owner.pop(uid, None)
        self._reaped.add(uid)
        if self._ftel is not None:
            self._ftel.journey_event(uid, "closed", self._steps,
                                     replica=rep.name, status=s)

    # ------------------------------------------------------------------
    # failover, migration, scale-down
    # ------------------------------------------------------------------
    def _failover(self, name: str) -> None:  # tpulint: serving-loop
        """A replica died mid-step.  Zero lost requests: its
        ``snapshot()`` (host truth — valid on the dead backend) yields
        per-request records that enter the migration queue; inexact
        records (device-side tokens died with the replica) close
        ``failed`` honestly."""
        rep = self._reps[name]
        rep.breaker.kill()
        self._c_failovers.inc()
        self.flight.note("failover", replica=name, step=self._steps)
        # closures the engine staged in its dying step (deadline
        # reaps, sheds) must still surface as fleet closures — the
        # step that would have delivered them raised instead
        for uid in rep.engine._drain_reaped():
            self._note_engine_close(rep, uid)
        snap = rep.engine.snapshot()
        n = 0
        with (self._ftel.span("failover", replica=name)
              if self._ftel is not None else NOOP_CTX):
            for rec in snap["requests"]:
                uid = int(rec["uid"])
                self._owner.pop(uid, None)
                if self._ftel is not None:
                    self._ftel.journey_event(uid, "failed_over",
                                             self._steps, replica=name)
                n += self._enqueue_migration(rec, source=name)
        self.flight.note("failover_migrations", replica=name,
                         queued=n, failed=len(snap["requests"]) - n)
        logger.warning(
            "fleet: replica %s died; %d open request(s) queued for "
            "migration, %d inexact record(s) closed failed", name, n,
            len(snap["requests"]) - n)
        self._autodump("failover")

    def _enqueue_migration(self, rec: Dict, source: str) -> int:
        uid = int(rec["uid"])
        if not rec.get("exact", True) or not rec.get("tokens"):
            self._closed[uid] = "failed"
            self._reaped.add(uid)
            self._c_failed.inc()
            self._fleet_closures["failed"] = \
                self._fleet_closures.get("failed", 0) + 1
            self._note_record_gap(uid, "failed")
            if self._ftel is not None:
                self._ftel.journey_event(
                    uid, "closed", self._steps, status="failed",
                    reason="record not replayable (device-side tokens "
                           "lost)")
            return 0
        self._migrations.append(
            _Migration(rec=rec, source=source, next_step=self._steps))
        return 1

    def _pump_migrations(self) -> None:  # tpulint: serving-loop
        """Place queued migration records on surviving replicas.  A
        record that cannot place (no routable replica right now)
        retries with step-counted exponential backoff, bounded by
        ``max_migration_retries`` — exhausted retries shed at the
        fleet level instead of parking forever."""
        if not self._migrations:
            return
        still: List[_Migration] = []
        for m in self._migrations:
            uid = int(m.rec["uid"])
            if m.next_step > self._steps:
                still.append(m)
                continue
            name = self._place_record(m.rec, exclude=m.source,
                                      pool=m.pool)
            if name is not None:
                self._owner[uid] = name
                self._c_migrations.inc()
                if self._ftel is not None:
                    self._ftel.last_migration_dest = name
                    self._ftel.journey_event(uid, "placed", self._steps,
                                             replica=name,
                                             via=m.via)
                if m.pool is not None:
                    # handoff arrival: pull the chain the source just
                    # staged into its tier (plus anything other peers
                    # hold) so the destination restages the prefilled
                    # KV instead of re-prefilling the prompt
                    self._tier_fetch(uid, name,
                                     m.rec.get("tokens") or ())
                continue
            m.attempts += 1
            self._c_migration_retries.inc()
            if self._ftel is not None:
                self._ftel.journey_event(uid, "migration_retry",
                                         self._steps,
                                         attempts=m.attempts)
            if m.attempts > self.cfg.max_migration_retries:
                # last resort before destroying the work: going HOME
                # beats shedding — the source may be alive again (a
                # quarantined-then-readmitted replica); only a record
                # with nowhere at all left sheds
                name = self._place_record(m.rec)
                if name is not None:
                    self._owner[uid] = name
                    self._c_migrations.inc()
                    if self._ftel is not None:
                        self._ftel.last_migration_dest = name
                        self._ftel.journey_event(uid, "placed",
                                                 self._steps,
                                                 replica=name,
                                                 via="home")
                    continue
                self._closed[uid] = "shed"
                self._reaped.add(uid)
                self._c_shed.inc()
                self._fleet_closures["shed"] = \
                    self._fleet_closures.get("shed", 0) + 1
                self._note_record_gap(uid, "shed")
                self.flight.note("migration_exhausted", uid=uid,
                                 attempts=m.attempts - 1)
                if self._ftel is not None:
                    self._ftel.journey_event(
                        uid, "closed", self._steps, status="shed",
                        reason=f"migration exhausted after "
                               f"{m.attempts - 1} retries")
                logger.warning(
                    "fleet: migration of uid %d exhausted %d retries "
                    "with no routable replica — shed",
                    uid, m.attempts - 1)
                self._autodump("fleet_shed")
                continue
            m.next_step = self._steps + self.cfg.migration_backoff_steps \
                * (1 << min(m.attempts - 1, 6))
            still.append(m)
        self._migrations = still

    def _place_record(self, rec: Dict,
                      exclude: Optional[str] = None,
                      pool: Optional[str] = None) -> Optional[str]:
        """Place one migration record by the same affinity ranking new
        requests get (its stream's cached chain may still be resident
        somewhere).  The SOURCE replica is excluded — its cached-free
        chain makes it the top affinity score for its own evictee, and
        a migration that lands back home moved nothing.  ``pool``
        ranks that pool's replicas first (handoffs target decode).
        ``load_snapshot(merge=True)`` bypasses admission bounds — the
        request was admitted by the fleet once; shedding it again
        would double-charge the client."""
        order, _ = self._rank(rec.get("tokens") or (), pool=pool)
        for name in order:
            if name == exclude:
                continue
            rep = self._reps[name]
            try:
                rep.engine.load_snapshot(
                    {"version": InferenceEngine.SNAPSHOT_VERSION,
                     "partial": True, "requests": [rec]}, merge=True)
            except ValueError:
                continue          # uid collision: try the next replica
            # no placement-hit bump here: migrations are not counted
            # in the placements denominator, and the MEASURED hit rate
            # (engine cached/prompt counters) covers them anyway
            return name
        return None

    def migrate(self, uids: Sequence[int], source: str) -> int:
        """Live request migration: extract the given OPEN requests from
        ``source`` (``engine.migrate_out`` — closes them ``migrated``
        there, releasing their KV) and re-place them by affinity on the
        rest of the fleet.  Returns the number of records that entered
        the migration queue.  With no routable destination besides the
        source, nothing is extracted (0) — a migration that could only
        end in retry-exhaustion must not destroy requests the source
        is serving fine."""
        if not any(rep.routable() for rep in self._reps.values()
                   if rep.name != source):
            return 0
        rep = self._reps[source]
        with (self._ftel.span("migrate", replica=source)
              if self._ftel is not None else NOOP_CTX):
            part = rep.engine.migrate_out(uids)
            n = 0
            for rec in part["requests"]:
                uid = int(rec["uid"])
                self._owner.pop(uid, None)
                if self._ftel is not None:
                    self._ftel.journey_event(uid, "migrated",
                                             self._steps,
                                             replica=source,
                                             via="migrate")
                n += self._enqueue_migration(rec, source=source)
        for uid in rep.engine._drain_reaped():
            self._note_engine_close(rep, uid)  # "migrated" returns early
        self._pump_migrations()
        return n

    def scale_down(self, name: str,
                   deadline_ms: Optional[float] = None,
                   sampling: SamplingParams = SamplingParams(),
                   rng=None) -> Dict:
        """Drain-to-scale-down: ``engine.drain()`` the replica, then
        re-place exactly its ``shed_uids`` records (the drain's
        completed set stays settled — re-placing it would double-run).
        The replica leaves the routable set permanently; returns the
        drain's snapshot."""
        rep = self._reps[name]
        snap = rep.engine.drain(deadline_ms=deadline_ms,
                                sampling=sampling, rng=rng)
        rep.breaker.kill()
        recs = {int(r["uid"]): r for r in snap["requests"]}
        shed = set(snap["shed_uids"])
        for uid in snap["shed_uids"]:
            if uid in recs:
                self._owner.pop(uid, None)
                # the drain closed this request "shed" on the replica,
                # but the fleet is RE-PLACING it: that engine terminal
                # is a phantom the reconciled accounting subtracts out
                self._note_phantom(uid, name)
                if self._ftel is not None:
                    self._ftel.journey_event(uid, "migrated",
                                             self._steps, replica=name,
                                             via="scale_down")
                self._enqueue_migration(recs[uid], source=name)
        for uid in rep.engine._drain_reaped():
            if uid in shed:
                continue          # re-placing, not closing
            self._note_engine_close(rep, uid)
        self._pump_migrations()
        return snap

    def drain(self, deadline_ms: Optional[float] = None,
              sampling: SamplingParams = SamplingParams(),
              rng=None) -> Dict:
        """Fleet-wide graceful drain — the seam verb the single engine
        already speaks, so a front-end (the gateway's SIGTERM path)
        shuts either backend down through one code path.  Every live
        replica runs its own ``engine.drain()`` (step-bounded, splits
        any ``deadline_ms`` across replicas), records still waiting in
        the migration queue close ``shed`` fleet-side (there is no
        surviving replica to re-place onto — the whole fleet is going
        away), and the merged final :meth:`snapshot` is the warm-
        restart hand-off — every shed record rides along in
        ``requests`` tagged ``replica: None``, exactly like the
        engine-level drain keeps its shed records restorable.  Unlike
        :meth:`scale_down` nothing is re-placed: a fleet drain ends
        the fleet's serving life."""
        t0 = time.perf_counter()
        live = [rep for rep in self._reps.values() if not rep.dead]
        shed: set = set()
        completed: set = set()
        shed_records: List[Dict] = []
        for i, rep in enumerate(live):
            per_rep = None
            if deadline_ms is not None:
                left = deadline_ms - (time.perf_counter() - t0) * 1e3
                per_rep = max(0.0, left)
            try:
                part = rep.engine.drain(deadline_ms=per_rep,
                                        sampling=sampling, rng=rng)
            except EngineDeadError:
                continue
            # the engine's hand-off snapshot carries the shed records
            # (taken before the close); keep them — the merged fleet
            # snapshot below is built AFTER every breaker dies, so it
            # cannot see them on its own
            by_uid = {int(r["uid"]): r for r in part["requests"]}
            for u in part.get("shed_uids", ()):
                shed.add(int(u))
                rec = by_uid.get(int(u))
                if rec is not None:
                    rec = dict(rec)
                    rec["replica"] = None
                    shed_records.append(rec)
            completed.update(int(u)
                             for u in part.get("completed_uids", ()))
            rep.breaker.kill()
            for uid in rep.engine._drain_reaped():
                self._note_engine_close(rep, uid)
        # queued migrations have no destination anymore: fleet-shed
        while self._migrations:
            m = self._migrations.pop()
            self._close_queued(m, "shed")
            # surfaces through drain_reaped() like every other fleet
            # shed (cancel, retry exhaustion) — a driver still watching
            # its active set must see the closure
            self._reaped.add(int(m.rec["uid"]))
            shed.add(int(m.rec["uid"]))
            rec = dict(m.rec)
            rec["replica"] = None
            shed_records.append(rec)
        snap = self.snapshot()
        snap["requests"] = snap["requests"] + shed_records
        snap["shed_uids"] = sorted(shed)
        snap["completed_uids"] = sorted(
            u for u in completed if u not in shed)
        return snap

    def snapshot(self) -> Dict:
        """Fleet-merged host truth, schema-compatible with
        ``engine.snapshot()`` (seam verb): every live replica's open
        request records (tagged ``replica``), records in flight in the
        migration queue (tagged ``replica: None``), summed engine
        counters, and the union prefix-cache index.  Like the engine's,
        it is valid with dead replicas in the fleet — their open work
        is whatever failover already queued."""
        from .. import __version__
        reqs: List[Dict] = []
        counters: Dict[str, int] = {}
        prefix: set = set()
        for name, rep in self._reps.items():
            if rep.dead:
                continue
            part = rep.engine.snapshot()
            for rec in part["requests"]:
                rec = dict(rec)
                rec["replica"] = name
                reqs.append(rec)
            for k, v in part["counters"].items():
                counters[k] = counters.get(k, 0) + v
            prefix.update(part["prefix_index"])
        for m in self._migrations:
            rec = dict(m.rec)
            rec["replica"] = None
            reqs.append(rec)
        return {
            "version": InferenceEngine.SNAPSHOT_VERSION,
            "engine_version": __version__,
            "health": self.health_state(),
            "counters": counters,
            "requests": reqs,
            "prefix_index": sorted(prefix),
            # per-replica attribution (resident ∪ tiered digests) —
            # what restore_prefix_index() needs to route each prefix
            # family back to its old replica after a router restart;
            # the union above keeps its pre-roles schema
            "replica_prefix_index": {
                name: sorted(rep.prefix_digests())
                for name, rep in self._reps.items() if not rep.dead},
            "roles": {name: rep.role
                      for name, rep in self._reps.items()
                      if not rep.dead},
            "replicas": sorted(name for name, rep in self._reps.items()
                               if not rep.dead),
        }

    def restore_prefix_index(self, snap: Dict) -> int:
        """Seed placement affinity from a PRIOR router generation's
        :meth:`snapshot` (ROADMAP 1b: cache affinity survives a
        restart).  Each named replica's digests load as warm
        placement-only entries (``ReplicaHandle.warm_digests``):
        affinity scoring sees them immediately, so the restarted fleet
        routes every prefix family back to the replica that served it
        — the first visit re-prefills honestly, every later one hits
        the rebuilt cache.  Replicas the snapshot doesn't name (or
        that no longer exist) are skipped; falls back to the fleet
        union for pre-``replica_prefix_index`` snapshots.  Returns
        the number of digests seeded."""
        per = snap.get("replica_prefix_index")
        if per is None:
            union = snap.get("prefix_index") or ()
            per = {name: union for name in self._reps}
        n = 0
        for name, hexes in per.items():
            rep = self._reps.get(name)
            if rep is None or rep.dead:
                continue
            for h in hexes:
                rep.warm_digests.add(bytes.fromhex(h))
                n += 1
        return n

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def _refresh_gauges(self) -> None:
        # health_state(), not health(): the full probe is a phase
        # boundary (it polls device memory under device_telemetry) and
        # must not run per replica per router step
        self._g_replicas.set(len(self._reps))
        self._g_routable.set(len(self._routable()))
        for name, rep in self._reps.items():
            if rep.breaker.state in ("open", "half_open"):
                code = 4
            else:
                code = _HEALTH_CODE.get(rep.engine.health_state(), 3)
            self._g_rep_health.set(code, replica=name)
        for pool in ("prefill", "decode"):
            members = self.pool_members(pool)
            self._g_pool_replicas.set(len(members), pool=pool)
            self._g_pool_load.set(sum(r.load() for r in members),
                                  pool=pool)

    def health_state(self) -> str:
        """The fleet's cheap health-LADDER read, mirroring
        ``engine.health_state()`` so a front-end (the network gateway)
        probes either backend shape through one seam: ``dead`` when no
        replica is alive, ``degraded`` when nothing is routable or any
        live replica is degraded/quarantined, else ``healthy``.  No
        gauge writes, no memory polls — :meth:`health` is the
        phase-boundary probe."""
        live = [rep for rep in self._reps.values() if not rep.dead]
        if not live:
            return "dead"
        if not self._routable():
            return "degraded"
        if any(rep.engine.health_state() != "healthy"
               or rep.breaker.state != "closed" for rep in live):
            return "degraded"
        return "healthy"

    def health(self) -> Dict:
        """Fleet health summary — the gateway's ``/healthz`` payload:
        per-replica engine state + breaker state + load, and the
        fleet-level tallies."""
        self._refresh_gauges()
        reps = {}
        for name, rep in self._reps.items():
            reps[name] = {
                "state": rep.engine.health()["state"],
                "breaker": rep.breaker.state,
                "load": rep.load(),
                "quarantines": rep.breaker.quarantines,
                "readmissions": rep.breaker.readmissions,
            }
        return {
            "replicas": reps,
            "routable": len(self._routable()),
            "migrating": len(self._migrations),
            "steps": self._steps,
            "failovers": int(self._c_failovers.value()),
            "migrations": int(self._c_migrations.value()),
            "fleet_shed": int(self._c_shed.value()),
        }

    def metrics_snapshot(self) -> Dict:
        """JSON-able snapshot of the fleet gauges/counters; the whole
        fleet's series (every replica's registry under ``replica=``
        labels, plus rollups) live on ``router.fleet_registry``."""
        return self.metrics.snapshot()

    def request_metrics(self) -> Dict:
        """Fleet-level request metrics, migration-deduped (docs/
        OBSERVABILITY.md "Fleet observability"): ``{"aggregate": the
        exact fleet tally, "replicas": {name: per-replica aggregate},
        "requests": [merged records]}`` — a migrated uid yields ONE
        record attributed to its finishing replica, with token sums
        equal to the sum of the per-replica engine counters."""
        return fleet_request_metrics(self)

    def anomaly_summary(self) -> Optional[Dict]:
        """Fleet anomaly tally + anomaly-armed capture records; None
        while the telemetry plane is off."""
        if self._ftel is None:
            return None
        return self._ftel.summary()

    def slo_scorecard(self) -> Dict:
        """The FLEET SLO scorecard (telemetry/slo.py): per-replica
        engine scorecards merged by ``merge_scorecards`` — counter
        pairs sum (the fleet attainment is the quotient of the summed
        exported counters, exactly what the ``serving_fleet_slo_*``
        rollups scrape), burn rates take the worst replica.  Replicas
        with SLO tracking off merge as disabled; an all-off fleet
        reports ``{"enabled": False}``."""
        return merge_scorecards(
            {name: rep.engine.slo_scorecard()
             for name, rep in self._reps.items()})

    def arm_budgeted_capture(self, reason: str = "ops",
                             replica: Optional[str] = None
                             ) -> Optional[Dict]:
        """Arm ONE budgeted capture window through the fleet-telemetry
        capture budget (``FleetTelemetryConfig.max_captures`` — the
        same budget anomaly-armed captures draw from), on ``replica``
        or the busiest routable one.  The gateway ``POST
        /debug/capture`` seam: returns ``{"replica", "dir"}`` or None
        when telemetry is off, the budget is exhausted, no directory
        is configured, or no replica can take the window."""
        if self._ftel is None:
            return None
        return self._ftel.ops_capture(self, reason=reason,
                                      replica=replica)

    def ops_dump(self) -> Optional[str]:
        """The gateway ``POST /debug/dump`` seam: one budgeted fleet
        bundle through the ``_autodump`` path (``FleetConfig.
        max_autodumps`` per router generation, into ``flight_dir``).
        Returns the bundle directory, or None when the budget is
        exhausted or no flight_dir is configured — a wire client can
        name neither the path nor the budget."""
        return self._autodump("ops")

    def reset_metrics(self) -> None:
        """Reset the ROUTER-side telemetry: fleet counters/gauges, the
        reconciliation ledgers that ride them, the flight-event ring,
        journeys, detector baselines, and the capture budget.  The
        replicas' own registries are theirs to reset — reconciled
        views are only exact when both sides reset together (the bench
        legs reset engines before building the router)."""
        self.metrics.reset()
        self._phantoms.clear()
        self._fleet_closures.clear()
        self._record_gaps.clear()
        self.flight.clear()
        if self._ftel is not None:
            self._ftel.reset()

    def request_journeys(self) -> Dict[int, List[Dict]]:
        """Every live journey (uid -> event list); empty when the
        telemetry plane is off."""
        if self._ftel is None:
            return {}
        return {uid: list(j)
                for uid, j in self._ftel._journeys.items()}

    def capture(self, steps: Optional[int] = None, replicas=None,
                out_dir: Optional[str] = None,
                reason: str = "manual") -> Dict[str, Optional[str]]:
        """Arm a deep-capture window on the given replicas (default:
        every live one) through the engines' existing ProfilerCapture
        seam; windows begin at each engine's next step boundary and the
        artifacts land under ``<dir>/captures/<replica>/``.  Returns
        {replica: capture dir or None (refused)}.  Raises without a
        resolvable directory — an explicit capture with nowhere to
        write is a caller error (the ANOMALY path degrades instead)."""
        tcfg = self._ftel.cfg if self._ftel is not None \
            else FleetTelemetryConfig()
        d = out_dir or tcfg.capture_dir or self.cfg.flight_dir
        if not d:
            raise ValueError(
                "no capture directory: pass out_dir=, or set "
                "FleetTelemetryConfig.capture_dir / "
                "FleetConfig.flight_dir")
        names = list(replicas) if replicas is not None else \
            [n for n, r in self._reps.items() if not r.dead]
        out = {}
        for n in names:
            out[n] = self._reps[n].engine.capture(
                steps or tcfg.capture_steps, reason=f"fleet_{reason}",
                out_dir=os.path.join(d, "captures", n))
        return out

    # ------------------------------------------------------------------
    # fleet post-mortems
    # ------------------------------------------------------------------
    def debug_dump(self, path: str, reason: str = "debug") -> Dict:
        """Write the fleet post-mortem BUNDLE (docs/OBSERVABILITY.md
        "Fleet observability") into directory ``path``::

            path/
                fleet.json            router events + journeys + fleet
                                      metrics/rollups + deduped request
                                      metrics (validate_fleet_dump)
                router_trace.json     router span ring (telemetry on)
                replicas/<name>/flight.json   each replica's own
                                      debug_dump (valid on a DEAD one)

        Returns the fleet dump dict.  ``tools/tracemerge.py --fleet``
        merges the bundle (router trace + each replica's capture
        artifacts) onto one Perfetto timeline."""
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as e:
            logger.warning("fleet dump dir %r unusable (%s)", path, e)
        replicas: Dict[str, Dict] = {}
        for name, rep in self._reps.items():
            rdir = os.path.join(path, "replicas", name)
            try:
                os.makedirs(rdir, exist_ok=True)
            except OSError as e:
                logger.warning("fleet dump: replica dir %r unusable "
                               "(%s)", rdir, e)
            rep.engine.debug_dump(os.path.join(rdir, "flight.json"),
                                  reason=f"fleet_{reason}")
            replicas[name] = {
                "flight": os.path.join("replicas", name, "flight.json"),
                "captures": list(rep.engine.capture_dirs),
                "breaker": rep.breaker.state,
                "dead": rep.dead,
            }
        router_trace = None
        if self._ftel is not None and len(self._ftel.tracer):
            router_trace = "router_trace.json"
            try:
                self._ftel.tracer.export_chrome_trace(
                    os.path.join(path, router_trace),
                    process_name="fleet_router")
            except OSError as e:
                logger.warning("fleet dump: cannot write router trace "
                               "(%s)", e)
                router_trace = None
        dump = {
            "version": FLEET_DUMP_VERSION,
            "reason": reason,
            "time": time.time(),
            "fingerprint": config_fingerprint(),
            "steps": self._steps,
            "health": self.health(),
            "metrics": self.metrics.snapshot(),
            "rollups": self.fleet_registry.rollup_snapshot(),
            "journeys": {str(u): j
                         for u, j in self.request_journeys().items()},
            "anomalies": self.anomaly_summary(),
            "request_metrics": self.request_metrics(),
            "events": self.flight.events(),
            "replicas": replicas,
            "router_trace": router_trace,
        }
        self.flight.dump(os.path.join(path, "fleet.json"), reason,
                         snap=dump)
        return dump

    def _autodump(self, reason: str) -> Optional[str]:
        """One budgeted fleet post-mortem bundle into ``FleetConfig.
        flight_dir`` (no-op unset): failover, quarantine, and fleet-
        shed each leave a bundle, at most ``max_autodumps`` per router
        generation, with collision-safe directory names across
        generations sharing one flight_dir (the engine-dump
        discipline)."""
        d = self.cfg.flight_dir
        if not d or self._autodumps >= self.cfg.max_autodumps:
            return None
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            logger.warning("fleet flight_dir %r unusable (%s)", d, e)
            return None
        n = self._autodumps
        while True:
            path = os.path.join(d, f"fleet_{reason}_s{self._steps}_{n}")
            if not os.path.exists(path):
                break
            n += 1
        self._autodumps += 1
        self.flight.note("dump", reason=reason, path=path)
        self.debug_dump(path, reason=reason)
        return path
