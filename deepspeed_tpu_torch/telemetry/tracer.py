"""Host-side span tracing for the serving and training loops.

A :class:`SpanTracer` is a preallocated ring buffer of (name, track,
begin, duration) records on the monotonic ``time.perf_counter_ns``
clock.  It exists to make the pipelined serving loop's overlap structure
*visible*: each pipeline stage (schedule / stage / dispatch / wait /
readback) records onto its own track, so the exported Chrome trace shows
dispatch-ahead steps overlapping device compute exactly as they ran.

Design constraints (docs/OBSERVABILITY.md):

* **Near-zero cost when disabled** — every entry point checks
  ``self.enabled`` first and returns a shared no-op; a disabled tracer
  never reads the clock and never allocates.
* **Bounded memory** — the ring holds ``capacity`` records; older spans
  are overwritten (``dropped`` counts them), so a long-lived serving
  engine can leave tracing on without growing.
* **No device work** — the tracer only ever touches host integers.
  Recording a span must never force a device sync (enforced tree-wide
  by tpulint's ``telemetry-hotpath`` rule: telemetry calls are banned
  inside jit-traced functions).

Two export formats:

* :meth:`export_chrome_trace` — Chrome trace-event JSON (load in
  Perfetto / ``chrome://tracing``), one thread-track per stage.
* :meth:`export_jsonl` — one JSON object per span, for ad-hoc tooling.

Copied from the JAX package's ``telemetry/tracer.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional


class _NoopSpan:
    """Shared do-nothing context manager returned while disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """Context manager that records one span on exit."""
    __slots__ = ("_tracer", "_name", "_track", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str,
                 track: Optional[str], args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        tr = self._tracer
        tr._depth += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tracer
        tr._depth -= 1
        tr._push(self._name, self._track or self._name, self._t0,
                 t1 - self._t0, tr._depth, self._args)
        return False


class SpanTracer:
    """Preallocated-ring span recorder on ``perf_counter_ns``.

    Spans can be recorded two ways:

    * ``with tracer.span("prefix_match", track="schedule"):`` — the
      context manager reads the clock at enter/exit; nesting is tracked
      (``depth``) so tooling can reconstruct the stack without relying
      on time containment alone.
    * ``tracer.record("schedule", t0, t1, track="schedule")`` — explicit
      ``time.perf_counter()`` (float seconds) endpoints.  The serving
      loop uses this form to reuse the timestamps it already takes for
      ``engine.timings``, so tracing adds no extra clock reads on the
      hot path.
    """

    def __init__(self, capacity: int = 1 << 16, enabled: bool = False):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.enabled = bool(enabled)
        # the ring is allocated lazily on the first recorded span, so a
        # never-enabled tracer (every engine constructs one) costs one
        # None attribute, not a capacity-sized list
        self._buf: Optional[List[Optional[tuple]]] = None
        self._cursor = 0
        self._total = 0            # spans ever recorded (dropped included)
        self._depth = 0            # live context-manager nesting depth

    # ------------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._buf = None
        self._cursor = 0
        self._total = 0
        self._depth = 0

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wraparound."""
        return max(0, self._total - self.capacity)

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def _push(self, name: str, track: str, ts_ns: int, dur_ns: int,
              depth: int, args: Optional[Dict[str, Any]]) -> None:
        buf = self._buf
        if buf is None:
            buf = self._buf = [None] * self.capacity
        i = self._cursor
        buf[i] = (name, track, ts_ns, dur_ns, depth, args)
        self._cursor = (i + 1) % self.capacity
        self._total += 1

    def span(self, name: str, track: Optional[str] = None, **args):
        """Context manager timing its body; no-op while disabled."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, track, args or None)

    def record(self, name: str, t0: float, t1: float,
               track: Optional[str] = None, depth: int = 0,
               **args) -> None:
        """Record a span from explicit ``time.perf_counter()`` endpoints
        (float seconds — the same clock as ``perf_counter_ns``)."""
        if not self.enabled:
            return
        ts = int(t0 * 1e9)
        self._push(name, track or name, ts, max(0, int(t1 * 1e9) - ts),
                   depth, args or None)

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        """Zero-duration marker (request arrivals, evictions, ...)."""
        if not self.enabled:
            return
        self._push(name, track or name, time.perf_counter_ns(), -1,
                   self._depth, args or None)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def events(self, since_ns: Optional[int] = None
               ) -> List[Dict[str, Any]]:
        """Recorded spans, oldest first (wraparound-corrected).
        ``since_ns`` keeps only spans beginning at/after that
        ``perf_counter_ns`` instant — the capture-window export
        (telemetry/profiler.py) uses it to emit just the window."""
        if self._buf is None:
            return []
        n = len(self)
        start = (self._cursor - n) % self.capacity
        out = []
        for k in range(n):
            name, track, ts_ns, dur_ns, depth, args = \
                self._buf[(start + k) % self.capacity]
            if since_ns is not None and ts_ns < since_ns:
                continue
            ev: Dict[str, Any] = {"name": name, "track": track,
                                  "ts_ns": ts_ns, "depth": depth}
            if dur_ns >= 0:
                ev["dur_ns"] = dur_ns
            else:
                ev["instant"] = True
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def chrome_trace(self, process_name: str = "deepspeed_tpu",
                     since_ns: Optional[int] = None) -> Dict:
        """Chrome trace-event JSON object (the ``traceEvents`` array
        format Perfetto and chrome://tracing load).  One tid per track,
        named via thread_name metadata, so each pipeline stage renders
        as its own horizontal track and the dispatch-ahead overlap is
        visually inspectable.  ``since_ns`` restricts the export to
        spans beginning at/after that instant (capture windows)."""
        tids: Dict[str, int] = {}
        trace_events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": process_name}}]
        body: List[Dict[str, Any]] = []
        for ev in self.events(since_ns=since_ns):
            track = ev["track"]
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                trace_events.append({
                    "name": "thread_name", "ph": "M", "pid": 1,
                    "tid": tid, "args": {"name": track}})
                # stable top-to-bottom track order in the viewer
                trace_events.append({
                    "name": "thread_sort_index", "ph": "M", "pid": 1,
                    "tid": tid, "args": {"sort_index": tid}})
            rec: Dict[str, Any] = {
                "name": ev["name"], "pid": 1, "tid": tid,
                "ts": ev["ts_ns"] / 1e3,              # microseconds
                "ph": "i" if ev.get("instant") else "X"}
            if not ev.get("instant"):
                rec["dur"] = ev["dur_ns"] / 1e3
            else:
                rec["s"] = "t"                        # thread-scoped
            if ev.get("args"):
                rec["args"] = ev["args"]
            body.append(rec)
        return {"traceEvents": trace_events + body,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def export_chrome_trace(self, path: str,
                            process_name: str = "deepspeed_tpu") -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(process_name), f)
        return path

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev) + "\n")
        return path
