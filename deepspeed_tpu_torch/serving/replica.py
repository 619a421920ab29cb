"""Replica handle + per-replica circuit breaker for the fleet router
(docs/SERVING.md "Fleet: routing, failover, migration").

A :class:`ReplicaHandle` wraps one hardened
:class:`~deepspeed_tpu_torch.inference.InferenceEngine` behind the
per-replica contract the failure layer built — ``health()`` / ``drain()`` /
``snapshot()`` / ``restore()`` — plus the two things only the fleet
layer needs: the live prefix-digest set (the cache-affinity placement
key) and a :class:`CircuitBreaker` fed from the engine's own failure
counters.

The breaker is **step-counted and deterministic** (no wall clocks —
the same discipline as the engine's retry backoff, so chaos replays
are machine-independent):

    closed --(threshold consecutive failing steps)--> open
    open --(probe_interval router steps)--> half_open
    half_open --(one clean dispatched step: the probe)--> closed
    half_open --(a failing step)--> open          (re-quarantined)
    any --(replica death / drain-to-scale-down)--> dead   (sticky)

``open`` quarantines the replica from NEW placements only: the router
keeps stepping it so its live requests finish and its clean steps make
the eventual probe meaningful.  Failure evidence is the engine's own
``serving_step_retries_total`` counter delta — the classifier already
decided those steps failed; the breaker just watches the ledger, and
idle rounds (backoff, empty queue: no ``steps`` delta) are neither
success nor failure, so a retry-backoff window cannot launder a sick
replica back to closed.

Copied from the JAX package's ``serving/replica.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

from typing import Dict, Optional

from .placement import REPLICA_ROLES, CombinedDigestIndex


class CircuitBreaker:
    """Per-replica quarantine state machine (module docstring above).
    All transitions are driven by the router's step counter — never a
    clock."""

    def __init__(self, threshold: int = 2, probe_interval: int = 8):
        if threshold < 1:
            raise ValueError("failure threshold must be >= 1")
        if probe_interval < 1:
            raise ValueError("probe_interval must be >= 1")
        self.threshold = threshold
        self.probe_interval = probe_interval
        self.state = "closed"
        self.failures = 0            # consecutive failing steps
        self.opened_step = 0
        self.probes = 0              # half-open probe windows entered
        self.quarantines = 0         # closed/half_open -> open trips
        self.readmissions = 0        # half_open -> closed (clean probe)

    @property
    def routable(self) -> bool:
        """Fully closed — the strict form.  The ROUTING predicate is
        :meth:`ReplicaHandle.routable`, which additionally admits
        half-open (one last-resort placement IS the probe, ranked
        after every closed replica)."""
        return self.state == "closed"

    def record_failure(self, step: int) -> bool:
        """One failing engine step (a step-retry delta).  Returns True
        when this failure OPENED the breaker (the router counts the
        quarantine)."""
        if self.state == "dead":
            return False
        self.failures += 1
        if self.state == "half_open" or (
                self.state == "closed"
                and self.failures >= self.threshold):
            self.state = "open"
            self.opened_step = step
            self.quarantines += 1
            return True
        return False

    def record_success(self) -> bool:
        """One clean DISPATCHED engine step (idle rounds don't call
        this).  Returns True when it was the half-open probe that
        re-admitted the replica."""
        if self.state == "closed":
            self.failures = 0
            return False
        if self.state == "half_open":
            self.state = "closed"
            self.failures = 0
            self.readmissions += 1
            return True
        return False                 # open: quarantined steps don't close

    def tick(self, step: int) -> None:
        """Router-step clock: an open breaker becomes half-open (probe
        window) after ``probe_interval`` steps in quarantine."""
        if self.state == "open" \
                and step - self.opened_step >= self.probe_interval:
            self.state = "half_open"
            self.probes += 1

    def kill(self) -> None:
        """Sticky terminal state: a dead or drained-away replica never
        re-admits."""
        self.state = "dead"


class ReplicaHandle:
    """One engine replica as the router sees it: identity, breaker,
    placement inputs (digest set + load), and the counter-delta
    bookkeeping that feeds the breaker after every stepped round."""

    def __init__(self, name: str, engine, threshold: int = 2,
                 probe_interval: int = 8, role: str = "mixed"):
        if role not in REPLICA_ROLES:
            raise ValueError(f"role={role!r}: expected one of "
                             f"{REPLICA_ROLES}")
        self.name = name
        self.engine = engine
        self.role = role
        self.breaker = CircuitBreaker(threshold, probe_interval)
        self._last_retries = int(engine.timings["step_retries"])
        self._last_steps = int(engine.timings["steps"])
        # warm placement digests seeded from a PRIOR router generation's
        # snapshot (router.restore_prefix_index): bytes digests that
        # score affinity so a restarted fleet routes each prefix family
        # back to its old replica — the engine re-prefills the first
        # visit, every later one hits the rebuilt cache.  Advertised to
        # placement only, never re-exported as real cache content
        self.warm_digests: set = set()

    @property
    def dead(self) -> bool:
        return self.breaker.state == "dead"

    def prefix_digests(self) -> frozenset:
        """The replica's LIVE cache-affinity key (hex digest set) —
        same key space as ``snapshot()["prefix_index"]``.  With the KV
        tier on, TIERED chains are advertised too: a spilled chain is
        still servable (restage beats re-prefill), so it must still
        attract its stream (docs/KV_TIERING.md)."""
        base = self.engine.state.prefix_digests()
        tier = getattr(self.engine.state, "tier", None)
        if tier is not None and len(tier):
            base = base | frozenset(h.hex() for h in tier.digests())
        return base

    def digest_index(self):
        """The live BYTES-digest membership view the router scores
        against per placement — the index dict itself, so scoring a
        prompt costs dict lookups only (no per-placement set build or
        hex conversion; read-only by contract), or the resident+tier
        :class:`~.placement.CombinedDigestIndex` when the engine's KV
        tier is on (two lookups — tiered chains score like resident
        ones).  :meth:`prefix_digests` is the exportable hex form."""
        tier = getattr(self.engine.state, "tier", None)
        base = self.engine.state._hash_index
        if tier is not None:
            base = CombinedDigestIndex(base, tier)
        if self.warm_digests:
            base = CombinedDigestIndex(base, self.warm_digests)
        return base

    def load(self) -> int:
        """Live sequences + requests still waiting for first admission
        — the least-loaded tiebreak (ints: exact, deterministic)."""
        eng = self.engine
        return len(eng.state.seqs) + sum(
            1 for uid, t in eng._pending.items()
            if t and uid not in eng.state.seqs)

    def routable(self) -> bool:
        """Placeable for NEW work: breaker closed — or half-open, where
        one placement IS the probe (an idle quarantined replica has no
        backlog left to certify itself with; classic half-open admits
        limited traffic) — and the engine still admits (not draining,
        not dead)."""
        return self.breaker.state in ("closed", "half_open") \
            and not self.engine._draining \
            and self.engine._health != "dead"

    def health(self) -> Dict:
        return self.engine.health()

    def observe(self, router_step: int) -> Optional[str]:  # tpulint: serving-loop
        """Post-step breaker bookkeeping from the engine's own counter
        deltas: a ``step_retries`` delta is a failing step, a ``steps``
        delta without one is a clean dispatched step, neither is an
        idle round (no evidence either way).  Returns the breaker event
        — ``"opened"`` / ``"readmitted"`` / ``"failure"`` / ``"clean"``
        — or None on idle."""
        tm = self.engine.timings
        retries = int(tm["step_retries"])
        steps = int(tm["steps"])
        if retries < self._last_retries or steps < self._last_steps:
            # the counters were reset underneath us (reset_metrics
            # between bench legs): resync the baselines — a stale
            # higher baseline would blind the breaker to every failure
            # until the counter re-exceeded it
            self._last_retries = retries
            self._last_steps = steps
            return None
        ev = None
        if retries > self._last_retries:
            ev = "opened" if self.breaker.record_failure(router_step) \
                else "failure"
        elif steps > self._last_steps:
            ev = "readmitted" if self.breaker.record_success() \
                else "clean"
        self._last_retries = retries
        self._last_steps = steps
        return ev
