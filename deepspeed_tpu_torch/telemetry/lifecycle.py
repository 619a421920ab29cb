"""Request-lifecycle records for the serving engine.

Copied from the JAX package's ``telemetry/lifecycle.py`` (which imports
no JAX); the port's engine keeps its request ledger here.

Every request the engine sees walks one state machine
(docs/OBSERVABILITY.md):

    arrival --> admitted --> prefill_start --> first_token --> finish
    (put)       (scheduler    (first dispatch   (first emitted  (flush)
                 takes its     carrying its      token)
                 prompt)       tokens launches)

and its :class:`RequestRecord` yields the per-request latency story:

* **queue wait** — arrival -> admitted (scheduler backlog / pool
  pressure);
* **TTFT** — arrival -> first emitted token (what the user feels);
* **TPOT** — mean inter-token time over the decode tail
  (``(t_last - t_first) / (generated - 1)``).

Token accounting mirrors the engine counters *by construction*: the
tracker is bumped at the same statements that bump
``engine.timings["prompt_tokens"/"cached_tokens"/"generated_tokens"]``,
so ``sum(per-request) == engine counter`` is an invariant the tests
enforce (a drift means someone added an accounting site and forgot one
side).

All timestamps are monotonic ``time.perf_counter()`` seconds; the
tracker performs dict lookups and float stores only — never device
work.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from .metrics import MetricsRegistry

# fixed histogram bucket edges (ms) — powers-of-ten-ish ladders wide
# enough for CPU tests and serving on the card alike
TTFT_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                   1000.0, 2000.0, 5000.0, 10000.0, 30000.0)
TPOT_BUCKETS_MS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                   500.0, 1000.0, 5000.0)
QUEUE_WAIT_BUCKETS_MS = TTFT_BUCKETS_MS


# terminal statuses a record may close with (docs/OBSERVABILITY.md):
#   finished          — ran to completion (stop token / max_new / flush)
#   shed              — rejected or evicted by backpressure before ever
#                       holding KV (overload.OverloadConfig.shed_policy),
#                       or left unfinished by engine.drain()
#   deadline_exceeded — its deadline_ms elapsed before completion
#   context_exhausted — hit the engine's max context; nothing more can
#                       be scheduled for it
#   cancelled         — engine.cancel() (client abort)
#   released          — its KV was released out-of-band (direct
#                       StateManager.release while the record was open)
#   failed            — quarantined by the failure classifier: the
#                       request repeatedly sat in failing step batches
#                       (poison — docs/SERVING.md "Failure domains &
#                       recovery"), or its device-side tokens were lost
#                       to a failure the host could not replay
#   migrated          — its open work was extracted
#                       (engine.migrate_out) and re-placed on another
#                       replica by the fleet router: terminal on THIS
#                       engine, while the request lives on at the
#                       fleet level (docs/SERVING.md "Fleet: routing,
#                       failover, migration")
#   handed_off        — prefill finished on a prefill-pool replica and
#                       the request was shipped to a decode replica
#                       (engine.handoff_out): like ``migrated``,
#                       terminal on THIS engine while the stream lives
#                       on at the fleet level (docs/SERVING.md
#                       "Disaggregated pools & elasticity")
TERMINAL_STATUSES = ("finished", "shed", "deadline_exceeded",
                     "context_exhausted", "cancelled", "released",
                     "failed", "migrated", "handed_off")


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle timestamps + token accounting."""
    uid: int
    t_arrival: float
    # "open" until a terminal event closes the record; then one of
    # TERMINAL_STATUSES.  Preemption is NOT terminal: a preempted
    # request is re-queued (its KV re-prefills, from the prefix cache
    # when possible) and the record stays open with ``preemptions``
    # counting the evictions it survived.
    status: str = "open"
    preemptions: int = 0
    # step-failure recoveries this request rode through (non-terminal:
    # the failed batch was re-queued and the request resumed — the
    # failure-domain sibling of ``preemptions``)
    retries: int = 0
    t_admitted: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_finish: Optional[float] = None
    # decode-tail anchor for TPOT.  Stepwise emission: == t_first_token.
    # When the record's FIRST emission is a multi-token burst (all n
    # tokens materialize at one readback instant), this anchors at the
    # burst's dispatch time instead, so the tail isn't zero-width and
    # TPOT doesn't collapse to 0 (see RequestTracker.on_tokens).
    t_tail_start: Optional[float] = None
    prompt_tokens: int = 0
    cached_tokens: int = 0
    generated_tokens: int = 0
    # --- speculative decoding (docs/SERVING.md "Speculative decoding"):
    # drafts this request's verify windows scored / committed.  Bumped
    # at the same engine statements as the serving_spec_* counters, so
    # sum(per-request) == engine counter by construction — and the
    # per-request acceptance_rate is the measured signal the autotuner
    # (ROADMAP item 4) needs to drive spec_decode="auto" from data.
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    # SLO class the request was admitted under (gateway header / fleet
    # routing) — the key the scorecard evaluates it by; None = the
    # tracker's default class (telemetry/slo.py)
    slo_class: Optional[str] = None

    @property
    def queue_wait_ms(self) -> Optional[float]:
        if self.t_admitted is None:
            return None
        return (self.t_admitted - self.t_arrival) * 1e3

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return (self.t_first_token - self.t_arrival) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean time per output token over the decode tail; needs at
        least two emitted tokens to have a tail."""
        if self.t_first_token is None or self.t_last_token is None \
                or self.generated_tokens < 2:
            return None
        tail0 = self.t_tail_start if self.t_tail_start is not None \
            else self.t_first_token
        return (self.t_last_token - tail0) * 1e3 \
            / (self.generated_tokens - 1)

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.t_finish is None:
            return None
        return (self.t_finish - self.t_arrival) * 1e3

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Accepted / drafted over this request's verify windows; None
        when no window was ever scored (spec off, or the proposer never
        matched)."""
        if not self.drafted_tokens:
            return None
        return self.accepted_tokens / self.drafted_tokens

    def as_dict(self) -> Dict[str, Any]:
        ms = {k: (None if v is None else round(v, 4))
              for k, v in (("queue_wait_ms", self.queue_wait_ms),
                           ("ttft_ms", self.ttft_ms),
                           ("tpot_ms", self.tpot_ms),
                           ("e2e_ms", self.e2e_ms))}
        ar = self.acceptance_rate
        return {"uid": self.uid,
                "slo_class": self.slo_class,
                "prompt_tokens": self.prompt_tokens,
                "cached_tokens": self.cached_tokens,
                "generated_tokens": self.generated_tokens,
                "drafted_tokens": self.drafted_tokens,
                "accepted_tokens": self.accepted_tokens,
                "acceptance_rate": None if ar is None else round(ar, 4),
                "finished": self.t_finish is not None,
                "status": self.status,
                "preemptions": self.preemptions,
                "retries": self.retries,
                **ms}


class RequestTracker:
    """Open-record table + bounded finished ring, feeding the latency
    histograms and request counters of a :class:`MetricsRegistry`."""

    def __init__(self, registry: MetricsRegistry,
                 max_finished: int = 4096):
        self.registry = registry
        # optional SloTracker sink (telemetry/slo.py), attached by the
        # engine when InferenceConfig.slo resolves ON.  None = SLO
        # tracking off: the two hook sites below are a single attribute
        # test — the zero-cost-off bar.  When attached, both hooks
        # evaluate from timestamps ALREADY stamped on the record (zero
        # new clock reads on the hot path).
        self.slo = None
        self.open: Dict[int, RequestRecord] = {}  # tpulint: live-set
        self.finished: Deque[RequestRecord] = deque(maxlen=max_finished)
        self._h_ttft = registry.histogram(
            "serving_ttft_ms", TTFT_BUCKETS_MS,
            "arrival to first emitted token")
        self._h_tpot = registry.histogram(
            "serving_tpot_ms", TPOT_BUCKETS_MS,
            "mean inter-token latency over the decode tail")
        self._h_queue = registry.histogram(
            "serving_queue_wait_ms", QUEUE_WAIT_BUCKETS_MS,
            "arrival to first scheduler admission")
        self._c_arrived = registry.counter(
            "serving_requests_total", "requests ever opened",
            int_valued=True)
        # tpulint: pair=_c_finished/_c_terminal
        self._c_finished = registry.counter(
            "serving_requests_finished_total",
            "requests closed with any terminal status", int_valued=True)
        self._c_terminal = registry.counter(
            "serving_requests_terminal_total",
            "terminal lifecycle closures by status", int_valued=True)
        self._c_preempted = registry.counter(
            "serving_preemptions_total",
            "preemption-by-eviction events (non-terminal: the request "
            "is re-queued)", int_valued=True)
        self._c_retried = registry.counter(
            "serving_request_retries_total",
            "step-failure recoveries ridden through (non-terminal: the "
            "failed batch was re-queued)", int_valued=True)
        # uid -> last terminal status, bounded alongside the finished
        # ring (``_status_refs`` counts ring records per uid so the
        # entry dies with its last evicted record)
        self._last_status: Dict[int, str] = {}
        self._status_refs: Dict[int, int] = {}
        # uids whose terminal status aged OUT of the ring — so
        # ``status_of`` can answer "forgotten" (the uid existed; its
        # story is gone) instead of the never-seen "unknown".  Bounded
        # at 8x the ring: beyond that, truly ancient uids fall back to
        # "unknown" (insertion-ordered dict = O(1) FIFO eviction)
        self._forgotten: Dict[int, None] = {}
        self._forgotten_cap = 8 * max_finished
        # cumulative speculative-decode tallies (plain ints, NOT registry
        # counters — the engine's serving_spec_* counters are the
        # exported metric; these survive finished-ring eviction so the
        # aggregate acceptance_rate stays exact over long traffic)
        self._drafted = 0
        self._accepted = 0

    def clear(self) -> None:
        self.open.clear()
        self.finished.clear()
        self._last_status.clear()
        self._status_refs.clear()
        self._forgotten.clear()
        self._drafted = 0
        self._accepted = 0

    # ------------------------------------------------------------------
    # lifecycle events (all O(1) dict/float work)
    # ------------------------------------------------------------------
    def on_arrival(self, uid: int, now: Optional[float] = None,
                   slo_class: Optional[str] = None) -> RequestRecord:
        rec = self.open.get(uid)
        if rec is not None:
            # continuation put: a late class tag fills the blank, but
            # never overwrites the class the request arrived under
            if slo_class is not None and rec.slo_class is None:
                rec.slo_class = slo_class
            return rec
        rec = RequestRecord(uid, now if now is not None
                            else time.perf_counter(),
                            slo_class=slo_class)
        self.open[uid] = rec
        self._forgotten.pop(uid, None)       # the uid lives again
        self._c_arrived.inc()
        return rec

    def on_admitted(self, uid: int, prompt_tokens: int,
                    cached_tokens: int, now: float) -> None:
        rec = self.open.get(uid)
        if rec is None:                      # direct-API putless entry
            rec = self.on_arrival(uid, now)
        if rec.t_admitted is None:
            rec.t_admitted = now
            self._h_queue.observe((now - rec.t_arrival) * 1e3)
        rec.prompt_tokens += prompt_tokens
        rec.cached_tokens += cached_tokens

    def on_prefill_start(self, uid: int, now: float) -> None:
        rec = self.open.get(uid)
        if rec is not None and rec.t_prefill_start is None:
            rec.t_prefill_start = now

    def on_tokens(self, uid: int, n: int, now: float,
                  t_dispatch: Optional[float] = None) -> None:
        """``t_dispatch``: for an ``n > 1`` burst emission (all tokens
        land at one readback), the burst's dispatch time — used as the
        decode-tail anchor when these are the record's first tokens.
        TTFT stays at ``now``: the tokens are not visible to the host
        before readback."""
        rec = self.open.get(uid)
        if rec is None or n <= 0:
            return
        if rec.t_first_token is None:
            rec.t_first_token = now
            rec.t_tail_start = t_dispatch \
                if (t_dispatch is not None and n > 1) else now
            self._h_ttft.observe((now - rec.t_arrival) * 1e3)
            if self.slo is not None:
                # same statement the TTFT histogram observes at —
                # the scorecard reads the stamps just stored
                self.slo.on_first_token(rec)
        rec.t_last_token = now
        rec.generated_tokens += n

    def on_draft(self, uid: int, drafted: int, accepted: int) -> None:
        """One resolved verify window: ``drafted`` tokens scored,
        ``accepted`` of them committed (emission also flows through
        :meth:`on_tokens` — these counters are the speculative overlay,
        not a second token count)."""
        rec = self.open.get(uid)
        if rec is None:
            return
        rec.drafted_tokens += drafted
        rec.accepted_tokens += accepted
        self._drafted += drafted
        self._accepted += accepted

    def on_preempted(self, uid: int, now: Optional[float] = None) -> None:
        """A running request was evicted and re-queued — NOT terminal:
        the record stays open accumulating tokens/latency across the
        re-prefill; only the eviction count and counter move."""
        rec = self.open.get(uid)
        if rec is None:
            return
        rec.preemptions += 1
        self._c_preempted.inc()

    def on_retried(self, uid: int) -> None:
        """The request sat in a step batch the failure classifier
        recovered (re-queue + re-prefill) — NOT terminal; the
        failure-domain sibling of :meth:`on_preempted`."""
        rec = self.open.get(uid)
        if rec is None:
            return
        rec.retries += 1
        self._c_retried.inc()

    def on_finish(self, uid: int, now: Optional[float] = None,
                  status: str = "finished") -> None:
        """Close the record with a terminal ``status`` (idempotent: a
        second terminal event for the same uid is a no-op, so e.g. a
        context-exhausted close followed by generate()'s flush never
        double-counts)."""
        rec = self.open.pop(uid, None)
        if rec is None:
            return
        rec.t_finish = now if now is not None else time.perf_counter()
        rec.status = status
        tpot = rec.tpot_ms
        if tpot is not None:
            self._h_tpot.observe(tpot)
        self._c_finished.inc()
        self._c_terminal.inc(status=status)
        if self.slo is not None:
            # terminal close-out: the record carries every timestamp
            # the scorecard needs — no clock is read here
            self.slo.on_close(rec)
        if len(self.finished) == self.finished.maxlen:
            old = self.finished[0]          # about to be ring-evicted
            self._status_refs[old.uid] -= 1
            if not self._status_refs[old.uid]:
                del self._status_refs[old.uid]
                if self._last_status.pop(old.uid, None) is not None:
                    # the uid's whole story just aged out: remember
                    # THAT it existed (bounded), so status_of answers
                    # "forgotten" instead of the never-seen "unknown"
                    self._forgotten[old.uid] = None
                    while len(self._forgotten) > self._forgotten_cap:
                        self._forgotten.pop(next(iter(self._forgotten)))
        self.finished.append(rec)
        self._last_status[uid] = status
        self._forgotten.pop(uid, None)
        self._status_refs[uid] = self._status_refs.get(uid, 0) + 1

    def status_of(self, uid: int) -> Optional[str]:
        """``"open"`` while the request is live, its terminal status
        after closure (as far back as the finished ring remembers),
        ``"forgotten"`` for a uid whose terminal record aged out of the
        ring (sized by ``OverloadConfig.status_retention``), or None
        for a uid this tracker never saw."""
        if uid in self.open:
            return "open"
        s = self._last_status.get(uid)
        if s is None and uid in self._forgotten:
            return "forgotten"
        return s

    # ------------------------------------------------------------------
    def records(self) -> List[RequestRecord]:
        """Finished (oldest first) then still-open records."""
        return list(self.finished) + list(self.open.values())

    def aggregate(self) -> Dict[str, Any]:
        """Compact summary for bench JSON / dashboards."""
        return {
            "requests": int(self._c_arrived.value()),
            "finished": int(self._c_finished.value()),
            "open": len(self.open),
            "preemptions": int(self._c_preempted.value()),
            "retries": int(self._c_retried.value()),
            # terminal closures by status (only statuses that occurred)
            "statuses": {k[0][1]: int(v)
                         for k, v in self._c_terminal.series() if k},
            "ttft_ms": self._h_ttft.summary(),
            "tpot_ms": self._h_tpot.summary(),
            "queue_wait_ms": self._h_queue.summary(),
            # speculative decoding (docs/SERVING.md "Speculative
            # decoding"): fleet-wide draft tallies + acceptance_rate —
            # the measured signal ROADMAP item 4's autotuner reads
            "drafted_tokens": self._drafted,
            "accepted_tokens": self._accepted,
            "acceptance_rate": (round(self._accepted / self._drafted, 4)
                                if self._drafted else None),
        }
