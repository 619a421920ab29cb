"""Deep-capture windows: bounded ``torch.profiler`` traces armed around
the next N engine steps (docs/OBSERVABILITY.md "Anomaly detection & deep
capture").

Counterpart of the JAX package's ``telemetry/profiler.py``, on
``torch.profiler`` in place of ``jax.profiler``: CPU activity always,
CUDA activity when a card is present.  The engines hold one
:class:`ProfilerCapture` and call ``begin()`` / ``end_step()`` at their
step boundaries, so a window opens before a step's schedule and closes
after its collect, never inside a CUDA graph capture (which runs within
a step's launch).

A capture window produces the JAX package's directory layout, so the
unchanged ``tools/tracemerge.py`` merges it into one Perfetto file::

    <out_dir>/capture_<seq>_<reason>/
        meta.json          clock anchor (perf_ns <-> epoch_ns at start),
                           step/sid range, reason, profiler presence
        host_trace.json    Chrome trace of the window's host spans
        device/torch_profiler.trace.json.gz
                           the profiler's events, their ``ts`` made
                           relative to ``t_start_perf_ns`` (absent when
                           the profiler could not start)
        flight.json        the engine's flight-recorder dump

Kineto stamps its events on a clock of its own, so the window records a
``record_function`` marker right after the session starts, together
with the ``perf_counter_ns`` read just before it: every event is shifted
by the marker's offset, and tracemerge's anchor shift then lands it on
the host spans' timeline.  Flow events (``ph`` s/t/f) are dropped:
tracemerge shifts only duration and instant events.

One profiler session per process: a module-level owner keeps two
engines from starting two.  A busy or failing profiler logs a warning
and the window still completes with host spans and meta.

Windows may open on a worker thread (a gateway runs its engine on one).
Kineto registers PyTorch's client on the main thread and wants the
process's first session there too: a first session on a worker logs
"External init callback must run in same thread as registerClient".  So
:func:`prime_profiler` runs one empty session on the main thread, once
per process, where an engine with a capture directory, a capture
manager or a gateway is built.
"""

from __future__ import annotations

import gzip
import json
import os
import time
from typing import Any, Dict, List, Optional

from ..utils.logging import logger

# process-wide session owner: one profiler session at a time
_TRACE_OWNER: List[object] = []
# the number of activities each priming session on the main thread had
_PRIMED: List[int] = []

# the marker event that anchors Kineto's clock to perf_counter_ns
ANCHOR_EVENT = "deepspeed_tpu_torch.capture_anchor"
DEVICE_TRACE = "torch_profiler.trace.json.gz"


def profiler_available() -> bool:
    """Whether ``torch.profiler`` can start a session here (a presence
    probe: no session is started)."""
    try:
        import torch.profiler
        return hasattr(torch.profiler, "profile")
    except ImportError as e:
        logger.warning("torch.profiler unavailable: %r", e)
        return False


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    return acts


def prime_profiler() -> bool:
    """Run one empty session on the main thread, once per process (once
    more when CUDA has been initialised since), so that windows begun
    later on worker threads start without Kineto's thread error.  A
    no-op off the main thread and while a session is active.  Returns
    whether the process is primed for the activities available now."""
    acts = _activities()
    if _PRIMED and _PRIMED[-1] >= len(acts):
        return True
    import threading
    if threading.current_thread() is not threading.main_thread() \
            or _TRACE_OWNER or not profiler_available():
        return False
    try:
        from torch.profiler import profile
        with profile(activities=acts, acc_events=True):
            pass
    except RuntimeError as e:
        logger.warning("torch.profiler could not be primed (%s)",
                       (str(e).splitlines() or [""])[0][:120])
        return False
    _PRIMED.append(len(acts))
    return True


def write_device_trace(raw_json: str, out_path: str, t_start_perf_ns: int,
                       t_anchor_perf_ns: int) -> int:
    """Rewrite one exported ``torch.profiler`` Chrome trace (the file
    ``raw_json``) as the gzip ``out_path``, each event's ``ts`` made
    microseconds since ``t_start_perf_ns`` on the ``perf_counter``
    clock: the anchor marker's ``ts`` maps to ``t_anchor_perf_ns``.
    Returns the number of events written."""
    with open(raw_json) as f:
        events = json.load(f).get("traceEvents", [])
    anchor = next((e for e in events if e.get("name") == ANCHOR_EVENT
                   and e.get("ph") == "X"), None)
    if anchor is None:
        raise RuntimeError("profiler trace holds no anchor marker")
    shift = float(anchor["ts"]) - (t_anchor_perf_ns - t_start_perf_ns) / 1e3
    out = []
    named_pids: Dict[str, int] = {}
    for e in events:
        if not isinstance(e, dict) or e.get("ph") in ("s", "t", "f"):
            continue
        e = dict(e)
        if "ts" in e:
            e["ts"] = float(e["ts"]) - shift
        pid = e.get("pid", 0)
        if not isinstance(pid, int):
            # Kineto names some tracks by string ("Spans"): tracemerge
            # bumps integer pids, so each name gets one of its own
            e["pid"] = named_pids.setdefault(str(pid), 9000 + len(named_pids))
        out.append(e)
    with gzip.open(out_path, "wt") as f:
        json.dump({"traceEvents": out,
                   "otherData": {"source": "torch.profiler",
                                 "anchor_event": ANCHOR_EVENT}}, f)
    return len(out)


class ProfilerCapture:
    """One engine's capture-window manager.

    States: idle -> ``armed`` (``arm()``) -> ``active`` (``begin()``,
    called by the engine right before its next dispatch) -> idle again
    when ``end_step()`` counts the window down (or ``finish_now()``
    closes it early on a step failure).  One window at a time;
    anomaly-armed windows (``budgeted=True``) draw from ``max_captures``
    until ``reset_budget()`` rearms it, explicit ``engine.capture()``
    windows do not."""

    def __init__(self, out_dir: str, tracer=None,
                 max_captures: Optional[int] = 2):
        self.out_dir = out_dir
        self.tracer = tracer
        self.max_captures = max_captures
        self.captures: List[str] = []     # finished capture dirs
        self._seq = 0
        self._budget_used = 0
        self._armed: Optional[Dict[str, Any]] = None
        self._active: Optional[Dict[str, Any]] = None
        self._warned_unavailable = False
        prime_profiler()

    # ------------------------------------------------------------------
    @property
    def armed(self) -> bool:
        return self._armed is not None

    @property
    def active(self) -> bool:
        return self._active is not None

    def budget_left(self) -> Optional[int]:
        if self.max_captures is None:
            return None
        return max(0, self.max_captures - self._budget_used)

    def reset_budget(self) -> None:
        """Rearm the anomaly-capture budget (``engine.reset_metrics``)."""
        self._budget_used = 0

    # ------------------------------------------------------------------
    def arm(self, steps: int, reason: str = "manual",
            budgeted: bool = False) -> Optional[str]:
        """Schedule a capture of the next ``steps`` engine steps; returns
        the capture directory path, or None when refused (a window is
        already armed or active, or the anomaly budget is spent).
        Nothing starts until the engine's next step boundary calls
        :meth:`begin`."""
        if self._armed is not None or self._active is not None:
            logger.debug("capture %r refused: a window is already %s",
                         reason, "active" if self._active else "armed")
            return None
        if budgeted:
            left = self.budget_left()
            if left is not None and left <= 0:
                logger.debug("capture %r refused: budget exhausted "
                             "(max_captures=%s)", reason,
                             self.max_captures)
                return None
            self._budget_used += 1
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:48]
        cdir = os.path.join(self.out_dir,
                            f"capture_{self._seq:03d}_{safe}")
        self._seq += 1
        self._armed = {"steps": max(1, int(steps)), "reason": reason,
                       "dir": cdir, "budgeted": budgeted}
        return cdir

    def _start_profiler(self, reason: str):
        """Start the session and record the anchor marker; returns (the
        profiler, the marker's perf_counter_ns) or None, loudly."""
        if _TRACE_OWNER:
            if not self._warned_unavailable:
                self._warned_unavailable = True
                logger.warning("capture %r: another profiler session is "
                               "active — this window records host spans "
                               "only", reason)
            return None
        if not profiler_available():
            return None
        try:
            from torch.profiler import profile, record_function
            prof = profile(activities=_activities(), acc_events=True)
            prof.start()
            t_anchor = time.perf_counter_ns()
            with record_function(ANCHOR_EVENT):
                pass
        except RuntimeError as e:
            logger.warning("capture %r: torch.profiler could not start "
                           "(%s) — recording host spans only", reason,
                           (str(e).splitlines() or [""])[0][:120])
            return None
        _TRACE_OWNER.append(self)
        return prof, t_anchor

    def begin(self, sid: Optional[int] = None,
              step: Optional[int] = None) -> None:
        """Start the armed window: create the capture dir, start the
        profiler session, force the span tracer on and record the clock
        anchor tracemerge aligns with.  Called by the engine at the step
        boundary BEFORE its schedule/stage work, so the window covers
        whole steps."""
        a, self._armed = self._armed, None
        if a is None:
            return
        cdir = a["dir"]
        try:
            os.makedirs(cdir, exist_ok=True)
        except OSError as e:
            logger.warning("capture dir %r unusable (%s); window "
                           "dropped", cdir, e)
            if a.get("budgeted"):
                # a window that produced nothing does not burn the budget
                self._budget_used = max(0, self._budget_used - 1)
            return
        tracer_was = None
        if self.tracer is not None:
            tracer_was = self.tracer.enabled
            self.tracer.enable()
        t_start_perf = time.perf_counter_ns()
        t_start_epoch = time.time_ns()
        started = self._start_profiler(a["reason"])
        self._active = {
            **a,
            "steps_left": a["steps"],
            "profiling": started is not None,
            "prof": started[0] if started else None,
            "t_anchor_perf_ns": started[1] if started else None,
            "tracer_was_enabled": tracer_was,
            "t_start_perf_ns": t_start_perf,
            "t_start_epoch_ns": t_start_epoch,
            "sid_start": sid,
            "step_start": step,
        }

    def end_step(self, sid: Optional[int] = None,
                 step: Optional[int] = None) -> Optional[str]:
        """Count one completed engine step against the active window;
        finalizes and returns the capture dir when the window is done,
        else None."""
        a = self._active
        if a is None:
            return None
        a["steps_left"] -= 1
        a["sid_end"] = sid
        a["step_end"] = step
        if a["steps_left"] > 0:
            return None
        return self._finish()

    def finish_now(self) -> Optional[str]:
        """Close an active window immediately (on a step failure, or when
        the driver's work runs out)."""
        if self._active is None:
            return None
        return self._finish()

    def _stop_profiler(self, a: Dict[str, Any]) -> bool:
        """Stop the session and write the device trace; False when
        nothing usable came out."""
        prof = a["prof"]
        try:
            prof.stop()
            os.makedirs(os.path.join(a["dir"], "device"), exist_ok=True)
            raw = os.path.join(a["dir"], "device", "raw_trace.json")
            prof.export_chrome_trace(raw)
            write_device_trace(raw, os.path.join(a["dir"], "device",
                                                 DEVICE_TRACE),
                               a["t_start_perf_ns"], a["t_anchor_perf_ns"])
            os.remove(raw)
            return True
        except (RuntimeError, OSError, ValueError) as e:
            logger.warning("capture %r: the profiler trace was lost "
                           "(%s: %s)", a["reason"], type(e).__name__, e)
            return False
        finally:
            if _TRACE_OWNER and _TRACE_OWNER[-1] is self:
                _TRACE_OWNER.pop()

    def _finish(self) -> str:
        a, self._active = self._active, None
        t_stop = time.perf_counter_ns()
        if a["profiling"]:
            a["profiling"] = self._stop_profiler(a)
        host_trace = None
        if self.tracer is not None:
            try:
                host_trace = os.path.join(a["dir"], "host_trace.json")
                with open(host_trace, "w") as f:
                    json.dump(self.tracer.chrome_trace(
                        since_ns=a["t_start_perf_ns"]), f)
            except OSError as e:
                logger.warning("capture %r: cannot write host trace "
                               "(%s)", a["reason"], e)
                host_trace = None
            if a["tracer_was_enabled"] is False:
                self.tracer.disable()
        meta = {
            "version": 1,
            "reason": a["reason"],
            "steps": a["steps"],
            "t_start_perf_ns": a["t_start_perf_ns"],
            "t_start_epoch_ns": a["t_start_epoch_ns"],
            "t_stop_perf_ns": t_stop,
            "t_anchor_perf_ns": a["t_anchor_perf_ns"],
            "profiler": a["profiling"],
            "device_dir": "device" if a["profiling"] else None,
            "host_trace": "host_trace.json" if host_trace else None,
            "sid_start": a["sid_start"], "sid_end": a.get("sid_end"),
            "step_start": a["step_start"], "step_end": a.get("step_end"),
        }
        try:
            with open(os.path.join(a["dir"], "meta.json"), "w") as f:
                json.dump(meta, f)
        except OSError as e:
            logger.warning("capture %r: cannot write meta (%s)",
                           a["reason"], e)
        self.captures.append(a["dir"])
        logger.info("capture %r complete: %s (device trace: %s)",
                    a["reason"], a["dir"],
                    "yes" if a["profiling"] else "ABSENT")
        return a["dir"]
