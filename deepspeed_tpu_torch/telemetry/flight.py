"""Post-mortem flight recorder (docs/OBSERVABILITY.md "Device &
compiler telemetry").

The failure layer can declare an engine dead, quarantine a poison
request, or abandon a hung dispatch — and until now left NO artifact to
debug from: the spans, counters, and request records died with the
process.  The flight recorder is the bounded black box: a ring of
failure/health events the engine notes as they happen, plus a
``snapshot`` assembled on demand from the live telemetry objects —
last-N spans, the full metrics snapshot, recent request statuses, the
config fingerprint (so the artifact says WHICH engine defaults
produced it), and the engine's health/failure state.

Dump triggers (wired in ``inference/engine.py``):

* automatically, when ``FailureConfig.flight_dir`` is set — on watchdog
  expiry, on the fatal transition to engine-dead, and on the first
  healthy->degraded transition of a failure window;
* on demand, via ``engine.debug_dump(path)`` (always available, no
  config needed).

Everything here is host-side dict/list work on the failure path — the
happy path never touches the recorder beyond its construction, and the
event ring is bounded, so a long-lived engine cannot grow it.

Copied from the JAX package's ``telemetry/flight.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..utils.logging import logger

FLIGHT_SCHEMA_VERSION = 1

# the snapshot's required top-level keys — validated by the chaos
# harness on every auto-dump and by tests/test_device_telemetry.py
FLIGHT_REQUIRED_KEYS = ("version", "reason", "time", "fingerprint",
                        "health", "steps", "metrics", "spans",
                        "requests", "events")


def config_fingerprint() -> Dict[str, str]:
    """Engine version + a short digest over the serving/overload/
    failure config DEFAULTS — the knobs whose defaults PRs keep
    evolving.  Two artifacts (BENCH JSONs, flight dumps) with different
    hashes came from different default engines; compare only within a
    hash.  Shared by ``bench.py`` (the BENCH JSON fingerprint) and the
    flight recorder, so the bench trajectory and the post-mortems are
    joinable on the same key."""
    import dataclasses
    import hashlib

    from .. import __version__
    from ..inference import (FailureConfig, InferenceConfig,
                             OverloadConfig)

    blob = json.dumps(
        {cls.__name__: {f.name: repr(getattr(cls(), f.name))
                        for f in dataclasses.fields(cls)
                        if f.name not in ("overload", "failure")}
         for cls in (InferenceConfig, OverloadConfig, FailureConfig)},
        sort_keys=True)
    return {"engine_version": __version__,
            "config_hash": hashlib.blake2b(
                blob.encode(), digest_size=8).hexdigest()}


class FlightRecorder:
    """Bounded black box for one engine.

    ``note(kind, **info)`` appends one event to the ring (failure
    verdicts, health transitions, dump records — the failure path's
    breadcrumbs); ``snapshot(...)`` assembles the full artifact;
    ``dump(path, ...)`` writes it as JSON and returns the path."""

    def __init__(self, capacity: int = 128, span_tail: int = 256):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.span_tail = span_tail
        self._events: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self.dumps = 0             # artifacts written by this recorder

    def note(self, kind: str, **info) -> None:
        """Record one breadcrumb (failure-path only — never per-step).
        The wall-clock stamp is deliberate: post-mortems are read next
        to logs and other hosts' artifacts, where monotonic clocks mean
        nothing."""
        self._events.append({"kind": kind, "time": time.time(), **info})

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    # ------------------------------------------------------------------
    def snapshot(self, reason: str, metrics=None, tracer=None,
                 requests=None, health: Optional[Dict] = None,
                 steps: int = 0,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Assemble the black-box artifact from the live telemetry
        objects (each optional — a partial engine still dumps what it
        has): the last ``span_tail`` spans, the full registry snapshot,
        the most recent request records (ring-bounded by the tracker
        already), and the event breadcrumbs."""
        spans: List[Dict[str, Any]] = []
        if tracer is not None:
            spans = tracer.events()[-self.span_tail:]
        reqs: List[Dict[str, Any]] = []
        if requests is not None:
            reqs = [r.as_dict() for r in requests.records()]
        snap: Dict[str, Any] = {
            "version": FLIGHT_SCHEMA_VERSION,
            "reason": reason,
            "time": time.time(),
            "fingerprint": config_fingerprint(),
            "health": health if health is not None else {},
            "steps": int(steps),
            "metrics": metrics.snapshot() if metrics is not None else {},
            "spans": spans,
            "requests": reqs,
            "events": self.events(),
        }
        if extra:
            snap.update(extra)
        return snap

    def dump(self, path: str, reason: str,
             snap: Optional[Dict[str, Any]] = None, **kw) -> str:
        """Write :meth:`snapshot` (or a prebuilt ``snap``) to ``path``
        as JSON.  Best-effort by design: a post-mortem writer must
        never turn a degraded engine into a crashed one — I/O failures
        log and return the path unwritten."""
        if snap is None:
            snap = self.snapshot(reason, **kw)
        try:
            with open(path, "w") as f:
                json.dump(snap, f)
            self.dumps += 1
        except OSError as e:
            logger.warning("flight recorder: cannot write %s (%s)",
                           path, e)
        return path


def validate_flight_dump(snap: Dict[str, Any]) -> List[str]:
    """Schema check for one flight artifact (loaded JSON): returns the
    list of violations, empty when valid — the chaos harness asserts
    emptiness on every auto-dump it finds."""
    problems = []
    for k in FLIGHT_REQUIRED_KEYS:
        if k not in snap:
            problems.append(f"missing key {k!r}")
    if snap.get("version") != FLIGHT_SCHEMA_VERSION:
        problems.append(f"version {snap.get('version')!r} != "
                        f"{FLIGHT_SCHEMA_VERSION}")
    fp = snap.get("fingerprint")
    if not (isinstance(fp, dict) and "engine_version" in fp
            and "config_hash" in fp):
        problems.append("fingerprint missing engine_version/config_hash")
    if not isinstance(snap.get("metrics"), dict):
        problems.append("metrics is not a dict")
    for k in ("spans", "requests", "events"):
        if not isinstance(snap.get(k), list):
            problems.append(f"{k} is not a list")
    return problems
