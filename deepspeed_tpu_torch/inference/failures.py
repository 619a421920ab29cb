"""Failure domains for the serving engine: dispatch watchdog, failure
classification, and fault injection (counterpart of the JAX package's
``inference/failures.py``; everything but :func:`classify_failure` is
copied as it is there, and the watchdog's idle worker drops the last
guarded call and ends with its watchdog, so that a dropped engine's
cache is freed).

The threat model: a request whose batch runs the step out of memory, a
CUDA error that aborts one replay, a device call that never returns, a
sticky CUDA error (an illegal address, a device-side assert, a launch
failure) that leaves the CUDA context unusable.  Without supervision any
one of those wedges ``generate()`` or kills the process; with it, every
failure degrades to a *request-level terminal status* (``failed``), a
bounded retry, or — worst case — a declared-dead engine whose host-side
truth a :meth:`~InferenceEngine.snapshot` carries into a warm restart
(in another process when the CUDA context is gone).

Three pieces, all host-side:

* :class:`Watchdog` — runs a guarded device call (the wait on a step's
  token event and the host read behind it) on a daemon worker thread
  under a deadline.  Expiry raises :class:`DispatchTimeoutError` (the
  stuck call is abandoned; a fresh worker serves the next call, and
  repeated expiries escalate to engine-dead, bounding the leaked-thread
  count by ``FailureConfig.fatal_timeouts``).  Only calls that read and
  never write are guarded: the cache and the graphs' buffers are
  updated in place, so an abandoned call that wrote would land its
  stale writes in a cache the recovery already handed to other
  sequences.  The replays run inline, unguarded; a device that hangs
  shows in the next read, whose deadline expires.
* :func:`classify_failure` — THE one classifier seam: every broad
  ``except`` on the serving loop routes its exception here and acts on
  the verdict: ``RETRY_STEP`` (transient: re-queue the batch, back off),
  ``POISON_STEP`` (deterministic for this batch: re-queue bisected to
  quarantine the poison request), or ``FATAL_ENGINE`` (the device is
  gone: mark the engine dead and raise :class:`EngineDeadError`).
  Exceptions the classifier does not recognize — host-side
  ``ValueError`` / ``KeyError`` / a bare ``RuntimeError`` — return
  ``None`` and re-raise: a programming error is not a failure domain.
* :class:`FailurePolicy` — per-engine state: the resolved watchdog
  deadline (``dispatch_timeout_ms``, auto-scaled from the observed step
  latency in the engine's timings), and the fault-injection queue the
  chaos tests drive the whole layer with.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import weakref
from typing import Callable, List, Optional, Tuple

import torch

# classifier verdicts (docs/SERVING.md "Failure domains & recovery")
RETRY_STEP = "retry"          # transient: re-queue the batch, back off
POISON_STEP = "poison"        # deterministic for this batch: bisect it
FATAL_ENGINE = "fatal"        # the device is gone: dead + snapshot

# message fragments that mark a CUDA runtime error as a *capacity*
# failure of this batch: the step is deterministic-bad for this batch
# shape, so bisect it
_POISON_MARKERS = ("resource_exhausted", "out of memory", "oom",
                   "allocation", "exceeds the memory")
# fragments that mark the backend itself as gone — no batch will ever
# run again on this engine.  The CUDA ones are the sticky errors: after
# them every CUDA call of the process fails, so the restore happens in
# another process
_FATAL_MARKERS = ("aborted", "data_loss", "device halted", "terminated",
                  "unavailable", "failed to connect", "socket closed",
                  # cudaGetErrorString of CUDA's sticky errors (the
                  # launch timeout's ends "and was terminated")
                  "illegal memory access", "unspecified launch failure",
                  "device-side assert", "an illegal instruction",
                  "misaligned address", "invalid program counter",
                  "hardware stack error",
                  "not supported on global/shared address space",
                  "ecc error", "nvlink error")
# fragments of the message of a RuntimeError raised by a CUDA runtime or
# cuBLAS call (torch versions without ``torch.AcceleratorError``)
_CUDA_ERROR_MARKERS = ("CUDA error", "cudaError", "CUBLAS_STATUS")


class DispatchTimeoutError(RuntimeError):
    """A guarded device dispatch/readback outlived its deadline."""


class InjectedTimeout(DispatchTimeoutError):
    """A SYNTHETIC watchdog expiry (``inject("timeout")``): raised
    before the guarded call ran, so — unlike a real expiry — the
    dispatch never consumed its donated operands and recovery may keep
    the KV pool.  Classified exactly like the real thing otherwise."""


class EngineDeadError(RuntimeError):
    """The classifier declared the engine unrecoverable: the device (or
    its runtime) is gone.  Host-side truth is intact — callers
    ``snapshot()`` the dead engine and ``InferenceEngine.restore`` the
    work onto a fresh one (the warm-restart loop the chaos tests
    exercise)."""


class InjectedFault(RuntimeError):
    """A synthetic failure armed via :meth:`FailurePolicy.inject` —
    carries the fault ``kind`` the classifier maps to a verdict, so the
    chaos tests drive the real recovery machinery end-to-end without a
    real broken device."""

    def __init__(self, kind: str, uid: Optional[int] = None):
        super().__init__(f"injected fault: {kind}"
                         + (f" (uid {uid})" if uid is not None else ""))
        self.kind = kind
        self.uid = uid


@dataclasses.dataclass
class FailureConfig:
    """Knobs for the failure-domain layer (``InferenceConfig.failure``).

    The defaults keep the hot path unchanged for short-lived engines:
    the auto watchdog only engages after ``watchdog_warmup_steps``
    observed steps (captures are slow and legitimate), and its
    deadline is generous — operators who want tight hang detection set
    ``dispatch_timeout_ms`` explicitly."""
    # watchdog deadline per guarded device call: a number (ms), "auto"
    # (scaled from the observed mean step latency once warmed up), or
    # None (watchdog off — direct calls, zero thread hops).  A guarded
    # call pays one worker-thread round trip on the readback (PERF.md
    # gives its cost on the card); engines chasing the last fraction of
    # a millisecond per step can set None and keep the
    # classifier/quarantine layer (raised errors still route through
    # it) without deadline supervision
    dispatch_timeout_ms: object = "auto"
    # auto mode: unguarded for the first N steps (capture steps are
    # slow and legitimate), then max(floor, scale x mean step ms)
    watchdog_warmup_steps: int = 8
    auto_timeout_floor_ms: float = 10_000.0
    auto_timeout_scale: float = 50.0
    # consecutive watchdog expiries before the engine is declared dead
    fatal_timeouts: int = 2
    # LIFETIME cap on abandoned watchdog workers: consecutive-expiry
    # escalation resets on every successful step, so a device that
    # hangs intermittently (one expiry every N clean steps) would
    # otherwise strand threads without bound — past this many total
    # abandonments the next expiry is fatal regardless of spacing
    max_abandoned_workers: int = 16
    # consecutive RETRY_STEP failures tolerated before an unrecognized
    # transient error escalates to POISON_STEP (bisect instead of
    # spinning on retries)
    max_step_retries: int = 2
    # times a request may sit in a failing batch before it is closed
    # terminally with status "failed".  A singleton failing batch is
    # proof positive and fails immediately regardless — bisection
    # normally isolates the poison via such a probe; this cap is the
    # safety net for interleavings bisection cannot untangle.  It must
    # exceed ~log2(batch) + 1: an innocent neighbor of a poison request
    # shares its failing probe groups all the way down to the pair
    # split (strikes clear on the innocent's first clean probe)
    poison_strikes: int = 5
    # retry backoff: the scheduler admits nothing for up to this many
    # rounds after a retryable failure (doubling per consecutive
    # failure) — deterministic step-counted backoff, not wall-clock
    max_backoff_rounds: int = 8
    # health(): "degraded" while the last failure is within this many
    # steps (docs/OBSERVABILITY.md health-state table)
    health_window_steps: int = 64
    # post-mortem flight recorder: directory to auto-dump the black-box
    # JSON into on watchdog expiry, on the fatal engine-dead transition,
    # and on the first healthy->degraded transition of a failure window
    flight_dir: Optional[str] = None

    def __post_init__(self):
        t = self.dispatch_timeout_ms
        if t is not None and t != "auto" \
                and not (isinstance(t, (int, float)) and t > 0):
            raise ValueError(
                f"dispatch_timeout_ms={t!r}: expected a positive ms "
                "value, 'auto', or None")
        if self.fatal_timeouts < 1:
            raise ValueError("fatal_timeouts must be >= 1")
        if self.poison_strikes < 1:
            raise ValueError("poison_strikes must be >= 1")


def _is_cuda_error(exc: BaseException) -> bool:
    """An error raised by the CUDA runtime or cuBLAS (not by host
    code): ``torch.AcceleratorError`` where this torch has it, else
    a ``RuntimeError`` whose message carries a CUDA error marker."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in _CUDA_ERROR_MARKERS)


def classify_failure(exc: BaseException, attempt: int = 0,
                     consecutive_timeouts: int = 0,
                     cfg: Optional[FailureConfig] = None) -> Optional[str]:
    """THE classifier seam: map an exception raised by a guarded device
    dispatch/readback to a verdict — :data:`RETRY_STEP`,
    :data:`POISON_STEP`, :data:`FATAL_ENGINE` — or ``None`` for
    exceptions that are not device failures at all (host programming
    errors re-raise untouched).

    ``attempt``: consecutive failed steps so far (an unrecognized
    transient escalates retry -> poison after ``max_step_retries``).
    ``consecutive_timeouts``: watchdog expiries in a row (escalate to
    fatal after ``fatal_timeouts`` — a device that repeatedly outlives
    a generous deadline is gone, and each expiry leaks one abandoned
    worker thread)."""
    cfg = cfg or FailureConfig()
    if isinstance(exc, InjectedFault):
        return {"crash": POISON_STEP, "oom": POISON_STEP,
                "transient": RETRY_STEP,
                "fatal": FATAL_ENGINE}.get(exc.kind, POISON_STEP)
    if isinstance(exc, DispatchTimeoutError):
        return FATAL_ENGINE if consecutive_timeouts >= cfg.fatal_timeouts \
            else RETRY_STEP
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return POISON_STEP
    if not _is_cuda_error(exc):
        return None
    msg = str(exc).lower()
    if any(m in msg for m in _FATAL_MARKERS):
        return FATAL_ENGINE
    if any(m in msg for m in _POISON_MARKERS):
        return POISON_STEP
    return RETRY_STEP if attempt < cfg.max_step_retries else POISON_STEP


class Watchdog:
    """Deadline supervision for blocking device calls.

    One daemon worker thread runs the guarded callable; the caller
    waits on a result queue with a timeout.  Expiry raises
    :class:`DispatchTimeoutError` and ABANDONS the worker (a stuck CUDA
    call cannot be interrupted from Python) — the next guarded call
    gets a fresh worker, a poison pill makes the abandoned one exit as
    soon as its stuck call completes, and the engine's
    ``fatal_timeouts`` / ``max_abandoned_workers`` escalations bound
    how many threads a dying device can strand.  With
    ``timeout_ms=None`` the call runs inline: zero threads, zero hops —
    the watchdog costs nothing unless a deadline is actually set."""

    def __init__(self):
        self._req: Optional[queue.Queue] = None
        self._res: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._token = 0
        self.abandoned = 0          # workers stranded by expiries
        # ONE guarded call at a time: the worker handshake is a single
        # (req, res) queue pair, so two concurrent run() calls would
        # interleave tokens on one queue, and a shared expiry could
        # tear down (_thread = _req = _res = None) the very worker the
        # other caller is still waiting on — double-counting
        # ``abandoned`` and stranding a result.  The admission lock
        # makes spawn + token bump + wait + abandon one atomic episode.
        # Reentrant: run() holds it across its call into
        # _ensure_worker(), which takes it again for callers that
        # pre-warm the worker directly.
        self._admit = threading.RLock()

    def _ensure_worker(self) -> None:
        with self._admit:
            if self._thread is not None and self._thread.is_alive():
                return
            self._req = queue.Queue()
            self._res = queue.Queue()

            def loop(req: queue.Queue, res: queue.Queue) -> None:
                while True:
                    token, fn = req.get()
                    if fn is None:    # poison pill: worker was abandoned
                        return
                    try:
                        out = (token, True, fn())
                    except BaseException as e:  # tpulint: disable=silent-except — shipped across the queue and re-raised in the caller
                        out = (token, False, e)
                    res.put(out)
                    # an idle worker must hold neither the guarded call
                    # (a closure over the engine, its cache and graphs)
                    # nor its result
                    fn = out = None

            self._thread = threading.Thread(
                target=loop, args=(self._req, self._res),
                name="serving-watchdog", daemon=True)
            self._thread.start()
            # a dropped watchdog (its engine collected) ends its worker
            weakref.finalize(self, self._req.put, (None, None))

    def run(self, fn: Callable, timeout_ms: Optional[float]):
        """Run ``fn()`` under ``timeout_ms``; inline when None."""
        if timeout_ms is None:
            return fn()
        with self._admit:
            self._ensure_worker()
            self._token += 1
            token = self._token
            self._req.put((token, fn))
            deadline = time.perf_counter() + timeout_ms / 1e3
            while True:
                remaining = deadline - time.perf_counter()
                try:
                    tok, ok, val = self._res.get(
                        timeout=max(1e-4, remaining)
                        if remaining > 0 else 1e-4)
                except queue.Empty:
                    # abandon this worker.  A stuck CUDA call cannot be
                    # interrupted from Python, but the poison pill makes
                    # the thread EXIT (instead of parking forever) the
                    # moment the call eventually completes — only calls
                    # that truly never return keep a thread, and the
                    # engine's max_abandoned_workers cap declares the
                    # device dead before that count can grow unboundedly
                    self.abandoned += 1
                    self._req.put((None, None))
                    self._thread = self._req = self._res = None
                    raise DispatchTimeoutError(
                        f"device dispatch outlived its {timeout_ms:.0f} ms "
                        "deadline") from None
                if tok != token:    # stale result from an older call
                    continue
                if ok:
                    return val
                raise val


class FailurePolicy:
    """Per-engine failure-domain state: the resolved watchdog deadline
    and the fault-injection queue.  The ENGINE owns the recovery
    bookkeeping (strikes, probe groups, backoff — it owns the state
    those mutate); this object owns what is independent of it."""

    def __init__(self, cfg: FailureConfig, timings):
        """``timings``: the engine's ``timings`` dict (reset in place,
        never rebound) — the auto deadline reads observed ``device_ms +
        wait_ms`` per step from it."""
        self.cfg = cfg
        self._timings = timings
        self.watchdog = Watchdog()
        # armed injections, consumed in order by the engine's calls:
        # (kind, uid filter or None, remaining fire count)
        self._inject: List[Tuple[str, Optional[int], int]] = []

    # ---- fault injection (the chaos harness seam) ---------------------
    def inject(self, kind: str, uid: Optional[int] = None,
               n: int = 1) -> None:
        """Arm ``n`` firings of a synthetic fault, consumed by the
        engine's device calls.  ``kind``: ``crash``/``oom`` (classified
        poison-for-step), ``transient`` (retryable), ``fatal``
        (engine-dead), ``timeout`` (a deterministic watchdog expiry —
        no real sleeping), or ``hang`` (a real sleep longer than the
        deadline inside the next guarded call — a read — driving the
        real watchdog thread).  With ``uid``, the fault only fires on a
        batch containing that uid (a *poison request*: every batch it
        sits in fails, which is what the bisection quarantine
        isolates)."""
        self._inject.append((kind, uid, n))

    def _take_injection(self, uids, guarded: bool) -> Optional[str]:
        for i, (kind, uid, n) in enumerate(self._inject):
            if uid is not None and uid not in uids:
                continue
            if kind == "hang" and not guarded:
                continue        # a stall only a guarded call can catch
            if n <= 1:
                del self._inject[i]
            else:
                self._inject[i] = (kind, uid, n - 1)
            return kind
        return None

    # ---- the device-call entry ---------------------------------------
    def run(self, fn: Callable, uids=(), cold: bool = False):
        """Run one device call of the engine: consume any armed
        injection, then execute it — under the current watchdog
        deadline, or inline on the caller's thread when ``cold``.  The
        reference marks ``cold`` a call that may carry a compile; the
        engine here guards only its reads (an event wait and the host
        copy behind it) and passes ``cold=True`` for the rest: a replay
        or an eager forward writes the cache in place, so it is never
        abandoned half way to land later (a capture rides it too, and a
        capture must stay on the caller's thread)."""
        kind = self._take_injection(uids, not cold)
        if kind is not None:
            if kind == "timeout":
                raise InjectedTimeout("injected watchdog expiry")
            if kind == "hang":
                # a real stall: the real watchdog must catch it
                inner = fn

                def fn():
                    time.sleep((self.deadline_ms() or 50.0) * 4 / 1e3)
                    return inner()
            else:
                raise InjectedFault(kind, uid=None)
        return self.watchdog.run(fn,
                                 None if cold else self.deadline_ms())

    def deadline_ms(self) -> Optional[float]:
        """The current watchdog deadline: the configured value, or the
        auto-scaled one — ``max(floor, scale x mean observed step
        ms)`` once ``watchdog_warmup_steps`` steps calibrated it (the
        warmup steps run unguarded: captures are slow and legitimate,
        and short unit-test engines never pay the thread hop)."""
        t = self.cfg.dispatch_timeout_ms
        if t is None:
            return None
        if t != "auto":
            return float(t)
        tm = self._timings
        steps = int(tm["steps"])
        if steps < self.cfg.watchdog_warmup_steps:
            return None
        mean_ms = (float(tm["device_ms"]) + float(tm["wait_ms"])) \
            / max(steps, 1)
        return max(self.cfg.auto_timeout_floor_ms,
                   self.cfg.auto_timeout_scale * mean_ms)


def bisect_groups(uids: List[int]) -> List[List[int]]:
    """Split a failing batch's uids into the two probe halves the
    quarantine schedules next (docs/SERVING.md: the bisection rule).
    Singleton batches don't bisect — a singleton failure is proof."""
    if len(uids) <= 1:
        return []
    mid = len(uids) // 2
    return [uids[:mid], uids[mid:]]
