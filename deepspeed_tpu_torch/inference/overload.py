"""Overload policy for the serving engine: SLA-aware admission,
backpressure, and preemption-by-eviction.

The SplitFuse scheduler (`engine._schedule`) packs a fixed token budget
per step; this module holds the *policy* layer that decides WHICH
requests get that budget when the offered load exceeds capacity
(docs/SERVING.md "Surviving overload"):

* **Admission tiers** — every request carries a ``priority`` (lower
  number = more important, like a nice level; default 0) and an optional
  ``deadline_ms`` relative to arrival.  The scheduler orders candidates
  by *effective* priority: waiting ``aging_ms`` promotes a request one
  tier, so low-priority traffic is delayed under load but never starved
  (anti-starvation aging).
* **Backpressure** — the admission queue is bounded
  (``max_queued_requests`` / ``max_queued_tokens``).  ``engine.put()``
  returns an :class:`AdmissionVerdict` instead of silently growing the
  backlog; over the bound the ``shed_policy`` decides: ``"reject"``
  sheds the newcomer, ``"evict-lowest"`` sheds the worst-priority
  *queued* request when the newcomer outranks it, ``"degrade"`` accepts
  everyone but demotes the newcomer to the background tier
  (``degrade_priority``) — the ZeRO-Offload trade (arxiv 2101.06840):
  a slower-but-alive path beats hard failure.
* **Preemption-by-eviction** — when the block pool or slot table
  starves a strictly higher-priority candidate, the scheduler evicts a
  running victim: its KV blocks release back through the refcounted
  allocator (full content-hashed blocks retire to the cached-free LRU
  pool, so with the prefix cache on, "evict and re-prefill from cache"
  costs one aliasing pass, not a recompute) and its full host-known
  token stream is re-queued as a prompt.  Seeded sampling keys are
  (uid, position)-folded, so a preempted-then-resumed request emits
  token-identical output (tests/test_scheduler_fuzz.py parity test).
* **Chunked prefill** — ``prefill_chunk`` caps the prompt tokens one
  request may take per step, so a long prompt is interleaved across
  steps instead of monopolizing the budget (decode tokens are always
  packed first; leftover budget still flows to prefill — the split is
  work-conserving).

Every decision here is pure host-side arithmetic over small dicts —
policy evaluation adds no device work and no syncs.  The scheduler's
decisions surface as terminal request statuses (``shed`` /
``deadline_exceeded`` / ``context_exhausted``) through ``query()``.

A copy of ``deepspeed_tpu/inference/overload.py`` (which is free of
JAX), kept in the port so the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, NamedTuple, Optional, Tuple

SHED_POLICIES = ("reject", "evict-lowest", "degrade")


@dataclasses.dataclass
class OverloadConfig:
    """Knobs for the admission / backpressure / preemption policy.

    The defaults reproduce the legacy cooperative-client behavior
    exactly: unbounded queue, no chunk cap, and preemption that can
    never trigger while every request rides the same priority tier —
    so ``InferenceConfig()`` engines are bit-for-bit unchanged."""
    # admission-queue bounds (None = unbounded).  "Queued" counts
    # requests waiting for their FIRST admission — a request that
    # already holds KV is live, not queued, and is never shed here.
    max_queued_requests: Optional[int] = None
    max_queued_tokens: Optional[int] = None
    # what to do with a NEW request that would exceed a bound
    shed_policy: str = "reject"          # reject | evict-lowest | degrade
    # max prompt tokens one request may take per step (None = no cap).
    # Decode tokens are packed first either way; leftover budget after
    # every prefill had its chunk is handed back out (work-conserving).
    prefill_chunk: Optional[int] = None
    # preemption-by-eviction of strictly lower-priority running
    # sequences when a candidate starves on blocks/slots
    preemption: bool = True
    max_preemptions_per_step: int = 2
    # anti-starvation aging: waiting this many ms promotes a queued
    # request by one priority tier (None disables aging)
    aging_ms: Optional[float] = 1000.0
    # the tier "degrade" demotes to — below any sane client priority,
    # so degraded requests only consume otherwise-idle capacity
    degrade_priority: int = 1_000_000
    # finished-record retention: how many terminally-closed requests
    # the lifecycle tracker remembers (ring-bounded).  query() answers
    # a terminal status as far back as this ring reaches; a uid that
    # aged out answers "forgotten" (distinct from the never-seen
    # "unknown"), so long-lived load-harness clients can tell a
    # retention miss from a request the engine never had
    status_retention: int = 4096

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy={self.shed_policy!r}: expected one of "
                f"{SHED_POLICIES}")
        if self.max_preemptions_per_step < 0:
            raise ValueError("max_preemptions_per_step must be >= 0")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")
        if self.status_retention < 1:
            raise ValueError("status_retention must be >= 1")


@dataclasses.dataclass
class RequestMeta:
    """Per-request admission metadata the engine keeps from ``put()``
    until the request reaches a terminal state."""
    priority: int = 0
    deadline_ms: Optional[float] = None
    t_arrival: float = 0.0               # perf_counter seconds
    degraded: bool = False               # admitted via shed_policy=degrade

    def expired(self, now: float) -> bool:
        return (self.deadline_ms is not None
                and (now - self.t_arrival) * 1e3 > self.deadline_ms)


class AdmissionVerdict(NamedTuple):
    """What ``engine.put()`` did with the request.  ``admitted`` means
    the tokens entered the engine (queued or continuing) — it does NOT
    promise scheduling; ``status`` is one of ``queued`` (new request
    accepted), ``continued`` (tokens appended to a known request),
    ``degraded`` (accepted at the background tier), or ``shed``.
    ``evicted_uids``: queued requests shed to make room under the
    ``evict-lowest`` policy (several, when the token bound needs more
    than one eviction to hold).  ``replica``: which fleet replica
    admitted the request when the verdict came through a fleet router
    (None from a bare engine; a router-level shed with ``replica=None`` is the
    fleet-saturated 429-equivalent — every routable replica's own
    bound rejected it)."""
    admitted: bool
    status: str
    reason: str = ""
    evicted_uids: Tuple[int, ...] = ()
    replica: Optional[str] = None

    def __bool__(self) -> bool:          # `if eng.put(...):` reads right
        return self.admitted


def effective_priority(priority: int, t_arrival: float, now: float,
                       aging_ms: Optional[float]) -> float:
    """Aged priority: lower is better; waiting ``aging_ms`` subtracts a
    whole tier, so any finite-priority request eventually outranks a
    static lower tier (anti-starvation)."""
    if not aging_ms:
        return float(priority)
    return priority - max(0.0, (now - t_arrival) * 1e3) / aging_ms


def admission_decision(
        cfg: OverloadConfig, priority: int, n_tokens: int,
        queued: List[Tuple[int, float, int]], now: float,
) -> Tuple[str, Tuple[int, ...]]:
    """Decide what ``put()`` does with a NEW request given the current
    backlog.  ``queued``: ``(uid, effective_priority, pending_tokens)``
    for every request still waiting for its first admission.  Returns
    ``(action, victim_uids)`` with action one of ``admit`` / ``shed`` /
    ``evict`` (shed every ``victim_uids``, admit the newcomer) /
    ``degrade``."""
    def fits(n_req: int, n_tok: int) -> bool:
        if cfg.max_queued_requests is not None \
                and n_req >= cfg.max_queued_requests:
            return False
        if cfg.max_queued_tokens is not None \
                and n_tok + n_tokens > cfg.max_queued_tokens:
            return False
        return True

    if fits(len(queued), sum(q[2] for q in queued)):
        return "admit", ()
    if cfg.shed_policy == "degrade":
        return "degrade", ()
    if cfg.shed_policy == "evict-lowest" and queued:
        # evict worst-first until BOTH bounds actually hold for the
        # newcomer (the token bound can need several evictions) — only
        # entries STRICTLY worse than the newcomer's RAW priority
        # qualify: ties shed the newcomer, never churn the backlog
        victims: List[int] = []
        n_req = len(queued)
        n_tok = sum(q[2] for q in queued)
        for uid, eff, ntok in sorted(queued, key=lambda q: (q[1], q[0]),
                                     reverse=True):
            if eff <= priority:
                break
            victims.append(uid)
            n_req -= 1
            n_tok -= ntok
            if fits(n_req, n_tok):
                return "evict", tuple(victims)
    return "shed", ()


def select_victim(candidates: Iterable[Tuple[int, float, int]],
                  better_than: float) -> Optional[int]:
    """Pick the preemption victim among running sequences:
    ``candidates`` are ``(uid, priority, n_blocks)`` for every
    *eligible* live sequence (the engine filters out sequences with
    in-flight steps or host-unknown tokens).  Only a victim with
    priority STRICTLY worse (numerically greater) than ``better_than``
    qualifies; among those, the worst tier wins and ties break toward
    the sequence holding the most KV blocks (one eviction frees the
    most headroom)."""
    worst_key = None
    worst_uid = None
    for uid, pri, n_blocks in candidates:
        if pri <= better_than:
            continue
        key = (pri, n_blocks)
        if worst_key is None or key > worst_key:
            worst_key, worst_uid = key, uid
    return worst_uid
