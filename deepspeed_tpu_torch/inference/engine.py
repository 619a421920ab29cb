"""Serving engine: continuous ragged batching with Dynamic SplitFuse.

Counterpart of ``deepspeed_tpu/inference/engine.py`` (``InferenceConfig``,
``InferenceEngine``).  Ported: ``put``, ``step``, ``generate`` (the sync
driver and the dispatch-ahead pipeline), ``flush``, ``cancel``,
``query``, the SplitFuse scheduler with prefix-cache admission and the
overload policy (priorities, deadlines, bounded admission, preemption),
the copy-on-write drain and the power-of-two context bucketing of each
step's block bound.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item when its config field is set away from the default): the
attention-implementation probe, failure domains and the watchdog,
telemetry (tracing, device telemetry, anomaly detection, SLOs,
captures), speculative decoding, decode bursts, the KV tier, weight and
KV quantization, KV offload, weight streaming and tensor parallelism.

API:
    eng = InferenceEngine(model, InferenceConfig(...))
    eng.put(uid, prompt_tokens)      # enqueue / continue a request
    out = eng.step()                 # one SplitFuse step -> {uid: token}
    eng.generate(prompts, sampling)  # convenience loop
    eng.flush(uid)                   # free a finished sequence

Pipelining on the card: a step's sampled tokens are copied into a pinned
host buffer right after the sample (non-blocking) and an event is
recorded behind the copy; the collect waits on that event only.  A
blocking ``.cpu()`` of step N after step N+1 was enqueued would wait for
step N+1 too and silently serialise the pipeline.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.transformer import Model, TransformerConfig, tree_map
from .model import pipelined_ragged_step
from .overload import (AdmissionVerdict, OverloadConfig, RequestMeta,
                       admission_decision, effective_priority,
                       select_victim)
from .ragged.state import (FEEDBACK_TOKEN, BatchStager, KVCacheConfig,
                           StateManager)
from .sampler import SamplingParams, sample_rows


@dataclasses.dataclass
class InferenceConfig:
    """Same field names and defaults as the JAX package's
    ``InferenceConfig``; dtypes are ``torch.dtype``s."""
    token_budget: int = 256          # tokens per step (SplitFuse budget)
    max_seqs: int = 8                # concurrent sequences
    kv_block_size: int = 64
    num_kv_blocks: int = 256         # pool size
    max_seq_len: Optional[int] = None   # default: model max
    kv_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    # "auto" only: CUDA tensors take the kernel, CPU tensors the plain
    # version — there is no implementation race to run
    attn_impl: str = "auto"
    kv_quant: Optional[str] = None
    weight_quant: Optional[str] = None
    mixed_gemm: str = "auto"
    quantize_embeddings: bool = False
    kv_offload: bool = False
    weight_stream: Optional[str] = None
    decode_burst: int = 1
    # serving-pipeline depth for generate(): 2 keeps one step in flight
    # (the host schedules and stages step N+1 and reads step N's tokens
    # back while step N computes); 1 is the strict-sync mode.  Both run
    # the same step, so outputs are token-for-token identical.
    pipeline_depth: int = 2
    # the port always updates the cache in place ("auto"/"on")
    kv_donate: str = "auto"
    comm_overlap: str = "auto"
    comm_tiles: int = 4
    comm_quant: Optional[str] = None
    # automatic prefix caching over the paged KV cache ("auto" = on)
    prefix_cache: str = "auto"
    trace: bool = False
    trace_capacity: int = 1 << 16
    device_telemetry: str = "auto"
    anomaly: str = "auto"
    anomaly_cfg: Optional[object] = None
    profile: Optional[str] = None
    profile_steps: int = 4
    spec_decode: str = "auto"
    spec_max_draft: int = 4
    # overload policy (inference/overload.py); None = OverloadConfig()
    overload: Optional[OverloadConfig] = None
    failure: Optional[object] = None
    kv_tier: str = "auto"
    kv_tier_ram_mb: float = 64.0
    kv_tier_dir: Optional[str] = None
    kv_tier_nvme_mb: float = 256.0
    slo: str = "auto"
    slo_objectives: Optional[dict] = None


# field -> (accepted values, ROADMAP item that ports the rest)
_QUANT = "ROADMAP Queue 1, quantized serving"
_HOST = "ROADMAP Queue 1, host layers above the engine"
_UNSUPPORTED = {
    "attn_impl": (("auto",), "ROADMAP Queue 1, serving slice: the kernel "
                  "is chosen by the tensors' device, there is no probe"),
    "kv_quant": ((None,), _QUANT),
    "weight_quant": ((None,), _QUANT),
    "mixed_gemm": (("auto", "off"), _QUANT),
    "quantize_embeddings": ((False,), _QUANT),
    "kv_offload": ((False,), "ROADMAP Queue 1, multi-GPU training "
                   "breadth (offload)"),
    "weight_stream": ((None,), _HOST),
    "decode_burst": ((1,), "ROADMAP Queue 1, decode bursts"),
    "kv_donate": (("auto", "on"), "in-place KV updates (no 'off')"),
    "comm_overlap": (("auto", "off"), "ROADMAP Queue 1, multi-GPU "
                     "training breadth (tensor parallelism)"),
    "comm_quant": ((None,), "ROADMAP Queue 1, multi-GPU training breadth"),
    "trace": ((False,), _HOST),
    "device_telemetry": (("auto", "off"), _HOST),
    "anomaly": (("auto", "off"), _HOST),
    "anomaly_cfg": ((None,), _HOST),
    "profile": ((None,), _HOST),
    "spec_decode": (("auto", "off"), "ROADMAP Queue 1, speculative "
                    "decoding"),
    "failure": ((None,), "ROADMAP Queue 1, failure domains"),
    "kv_tier": (("auto", "off"), _HOST),
    "slo": (("auto", "off"), _HOST),
    "slo_objectives": ((None,), _HOST),
}


class _InFlight(NamedTuple):
    """One dispatched-but-unread serving step: the on-device [max_seqs]
    sample tensor, its host copy and the event recorded behind that
    copy, the (uid, slot) emission list frozen at dispatch time, the
    dispatch sequence number, and every uid it scheduled tokens for."""
    toks: torch.Tensor
    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    emit: Tuple[Tuple[int, int], ...]
    sid: int
    uids: Tuple[int, ...] = ()


_TIMINGS = ("schedule_ms", "stage_ms", "device_ms", "wait_ms",
            "readback_ms", "steps", "prompt_tokens", "cached_tokens",
            "prefix_hits", "generated_tokens")


class InferenceEngine:
    """Single-device serving engine on the model's device (the card, or
    the CPU when the model was built with ``device="cpu"``)."""

    def __init__(self, model: Model, config: Optional[InferenceConfig] = None):
        self.model = model
        self.cfg: TransformerConfig = model.config
        self.icfg = config or InferenceConfig()
        for name, (ok, item) in _UNSUPPORTED.items():
            val = getattr(self.icfg, name)
            if val not in ok:
                raise NotImplementedError(
                    f"InferenceConfig.{name}={val!r} is not ported yet "
                    f"({item}); accepted here: {ok}")
        if self.icfg.prefix_cache not in ("auto", "on", "off"):
            raise ValueError(f"prefix_cache={self.icfg.prefix_cache!r}: "
                             "expected 'auto', 'on', or 'off'")
        if self.icfg.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.device = model.device
        max_len = self.icfg.max_seq_len or self.cfg.max_seq_len
        # a sequence can never hold more blocks than the pool has
        self.max_blocks_per_seq = min(-(-max_len // self.icfg.kv_block_size),
                                      self.icfg.num_kv_blocks)
        kv_cfg = KVCacheConfig(
            num_layers=self.cfg.num_layers,
            num_kv_heads=self.cfg.num_kv_heads,
            head_dim=self.cfg.head_dim,
            block_size=self.icfg.kv_block_size,
            num_blocks=self.icfg.num_kv_blocks,
            dtype=self.icfg.kv_dtype, device=self.device)
        self.state = StateManager(kv_cfg, max_seqs=self.icfg.max_seqs,
                                  max_blocks_per_seq=self.max_blocks_per_seq,
                                  prefix_cache=self.icfg.prefix_cache
                                  != "off")
        self.params = tree_map(
            lambda x: x.to(self.icfg.param_dtype)
            if x.dtype == torch.float32 else x, model.params)
        self._cuda = self.device.type == "cuda"
        # uid -> unprocessed toks
        self._pending: Dict[int, List[int]] = {}
        self._ctx_exhausted: set = set()
        self._stager = BatchStager(self.icfg.token_budget,
                                   self.icfg.max_seqs,
                                   self.icfg.num_kv_blocks,
                                   depth=max(2, self.icfg.pipeline_depth),
                                   pin=self._cuda)
        self._zero_toks = torch.zeros(self.icfg.max_seqs, dtype=torch.int32,
                                      device=self.device)
        self._last_toks: Optional[torch.Tensor] = None
        self._dispatch_seq = 0
        self._fb_step: Dict[int, int] = {}   # uid -> sid its marker defers to
        # --- overload policy state (inference/overload.py) -------------
        self.ocfg = self.icfg.overload or OverloadConfig()
        self._meta: Dict[int, RequestMeta] = {}   # uid -> admission meta
        self._deadline_uids: set = set()
        self._inflight_sched: Dict[int, int] = {} # uid -> uncollected steps
        self._preempting: set = set()             # release() = preemption
        self._preempt_gen: Dict[int, List[int]] = {}  # pre-eviction tokens
        self._closing: Dict[int, str] = {}        # uid -> staged status
        self._reaped: set = set()   # engine-closed uids drivers must drop
        # request records: open uids (arrival time), terminal statuses
        # (ring of ``status_retention``), forgotten uids, first-token ms
        self._open: Dict[int, float] = {}
        self._finished: "OrderedDict[int, str]" = OrderedDict()
        self._forgotten: "OrderedDict[int, None]" = OrderedDict()
        self.ttft_ms: Dict[int, float] = {}
        self.timings: Dict[str, float] = dict.fromkeys(_TIMINGS, 0)
        self.state.on_release = self._on_state_release

    def reset_timings(self) -> None:
        """Zero the per-phase milliseconds (host scheduling, batch
        staging, the step's enqueue, the wait for a collected step's
        tokens, their host read) and the token counters
        (``prompt_tokens``, ``cached_tokens`` — prompt tokens served
        from the prefix cache, ``prefix_hits``, ``generated_tokens``)."""
        self.timings = dict.fromkeys(_TIMINGS, 0)

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------
    def put(self, uid: int, tokens: Sequence[int], priority: int = 0,
            deadline_ms: Optional[float] = None) -> AdmissionVerdict:
        """Enqueue a new request or continue a known one; returns an
        :class:`AdmissionVerdict` (truthy iff the tokens entered the
        engine).  ``priority``: lower = more important.  ``deadline_ms``:
        relative to arrival; a request still unfinished when it elapses
        is closed with status ``deadline_exceeded``.  Both only matter
        on the FIRST put for a uid."""
        now = time.perf_counter()
        toks = [int(t) for t in tokens]
        if uid in self._meta or uid in self.state.seqs \
                or uid in self._pending:
            self._pending.setdefault(uid, []).extend(toks)
            return AdmissionVerdict(True, "continued")
        ocfg = self.ocfg
        queued: List[tuple] = []
        if ocfg.max_queued_requests is not None \
                or ocfg.max_queued_tokens is not None:
            for quid, qt in self._pending.items():
                if not qt or quid in self.state.seqs:
                    continue
                m = self._meta.get(quid)
                queued.append((
                    quid,
                    effective_priority(m.priority if m else 0,
                                       m.t_arrival if m else now,
                                       now, ocfg.aging_ms),
                    len(qt)))
        action, victims = admission_decision(ocfg, priority, len(toks),
                                             queued, now)
        if action == "shed":
            self._record_closed(uid, "shed")
            return AdmissionVerdict(False, "shed",
                                    reason="admission queue bound")
        for victim in victims:
            self._finish(victim, "shed")
            self._reaped.add(victim)
        if action == "degrade":
            priority = max(priority, ocfg.degrade_priority)
        self._meta[uid] = RequestMeta(priority=priority,
                                      deadline_ms=deadline_ms,
                                      t_arrival=now,
                                      degraded=(action == "degrade"))
        if deadline_ms is not None:
            self._deadline_uids.add(uid)
        self._open[uid] = now
        self._forgotten.pop(uid, None)
        self._pending.setdefault(uid, []).extend(toks)
        return AdmissionVerdict(
            True, "degraded" if action == "degrade" else "queued",
            evicted_uids=victims)

    def flush(self, uid: int) -> None:
        self._finish(uid, "finished")

    def cancel(self, uid: int) -> None:
        """Client abort: close ``uid`` wherever it is (queued, running,
        or already gone).  Safe mid-flight: an uncollected step's emit
        for a cancelled uid is discarded by the slot guard in
        ``_collect``."""
        self._finish(uid, "cancelled")
        self._reaped.add(uid)

    def _finish(self, uid: int, status: str) -> None:
        """Terminally close a request: a live sequence releases its KV
        (``_on_state_release`` does the bookkeeping), a queued-only
        request just drops its backlog entry.  Idempotent."""
        if uid in self.state.seqs:
            self._closing[uid] = status
            try:
                self.state.release(uid)   # -> _on_state_release
            finally:
                self._closing.pop(uid, None)
            return
        self._forget(uid, status)

    def _forget(self, uid: int, status: str) -> None:
        self._pending.pop(uid, None)
        self._fb_step.pop(uid, None)
        self._meta.pop(uid, None)
        self._deadline_uids.discard(uid)
        self._preempt_gen.pop(uid, None)
        self._ctx_exhausted.discard(uid)
        if uid in self._open:
            self._record_closed(uid, status)

    def _record_closed(self, uid: int, status: str) -> None:
        self._open.pop(uid, None)
        self._finished.pop(uid, None)
        self._finished[uid] = status
        while len(self._finished) > self.ocfg.status_retention:
            old, _ = self._finished.popitem(last=False)
            self._forgotten[old] = None
            while len(self._forgotten) > 8 * self.ocfg.status_retention:
                self._forgotten.popitem(last=False)

    def _on_state_release(self, uid: int) -> None:
        """``StateManager.on_release`` hook: preemption is the one
        non-terminal release; every other path closes the request."""
        if uid in self._preempting:
            return
        self._forget(uid, self._closing.get(uid, "released"))

    def _drain_reaped(self) -> set:
        out = self._reaped
        self._reaped = set()
        return out

    def query(self, uid: int) -> Dict:
        """``status`` is ``queued``, ``running``, a terminal status
        (``finished`` / ``shed`` / ``cancelled`` / ``deadline_exceeded``
        / ``context_exhausted`` / ``released``), ``forgotten`` (aged out
        of the finished ring) or ``unknown``."""
        seq = self.state.seqs.get(uid)
        if seq is not None:
            status = "running"
        elif self._pending.get(uid) or uid in self._meta \
                or uid in self._open:
            status = "queued"
        elif uid in self._finished:
            status = self._finished[uid]
        else:
            status = "forgotten" if uid in self._forgotten else "unknown"
        gen = self._preempt_gen.get(uid, [])
        return {
            "status": status,
            "pending_tokens": len(self._pending.get(uid, [])),
            "seen_tokens": seq.seen_tokens if seq else 0,
            "generated": list(gen) + (list(seq.tokens) if seq else []),
            "max_context": self.max_blocks_per_seq * self.icfg.kv_block_size,
            "cached_tokens": seq.cached_tokens if seq else 0,
        }

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _schedule(self) -> List[tuple]:
        """Dynamic SplitFuse + overload policy: pack the fixed token
        budget — decode tokens first, then prompt chunks — while
        reserving KV blocks and slots as requests are admitted, so the
        collective admission never exceeds the pool.  New prompts first
        consult the prefix cache.  Expired deadlines are reaped first;
        candidates are ordered by aged priority within each class; each
        prefill takes at most ``prefill_chunk`` tokens; a candidate
        starved of blocks/slots may preempt a strictly lower-priority
        running sequence.  With the default config every overload knob
        is inert and this is the FIFO SplitFuse packer."""
        budget = self.icfg.token_budget
        bs = self.icfg.kv_block_size
        ocfg = self.ocfg
        now = time.perf_counter()
        self._reap_deadlines(now)
        reserved_blocks = 0
        reserved_slots = 0
        prefix_on = self.state.prefix_cache
        sched: List[tuple] = []
        sched_uids: set = set()
        preempts_left = (ocfg.max_preemptions_per_step
                         if ocfg.preemption else 0)

        def admit(uid, toks) -> str:
            """"ok", "starved" (pool or slot table blocked it — a
            preemption could help) or "skip"."""
            nonlocal budget, reserved_blocks, reserved_slots
            seq = self.state.seqs.get(uid)
            ctx_rem = self.state.context_remaining(uid)
            if ctx_rem <= 0:
                self._ctx_exhausted.add(uid)
                return "skip"
            needs_slot = uid not in self.state._slots
            if needs_slot and \
                    len(self.state._free_slots) - reserved_slots <= 0:
                return "starved"
            new_prompt = seq is None
            prompt_len = len(toks) if new_prompt else 0
            cached = 0
            if new_prompt and prefix_on and toks[0] != FEEDBACK_TOKEN:
                cached = self.state.match_prefix(
                    uid, toks,
                    max_pool_take=self.state.allocator.free_blocks
                    - reserved_blocks)
                if cached:
                    del toks[:cached]
                    seq = self.state.seqs[uid]
                    needs_slot = False     # match_prefix claimed the slot
                    ctx_rem = self.state.context_remaining(uid)
            n = min(len(toks), budget, ctx_rem)
            if len(toks) > 1 and ocfg.prefill_chunk is not None:
                n = min(n, ocfg.prefill_chunk)
            avail = self.state.allocator.free_blocks - reserved_blocks
            need = 0
            while n > 0:
                seen = seq.seen_tokens if seq else 0
                have = len(seq.blocks) if seq else 0
                need = max(0, -(-(seen + n) // bs) - have)
                if need <= avail:
                    break
                n //= 2
            if n <= 0 and not cached:
                return "starved"
            tm = self.timings
            tm["prompt_tokens"] += prompt_len
            if cached:
                tm["cached_tokens"] += cached
                tm["prefix_hits"] += 1
            if n <= 0:
                # matched but the pool can't take the uncached remainder
                # yet: the sequence keeps its aliased blocks and waits
                return "ok"
            sched.append((uid, toks[:n]))
            sched_uids.add(uid)
            del toks[:n]
            budget -= n
            reserved_blocks += need
            if needs_slot:
                reserved_slots += 1
            return "ok"

        decodes: List[tuple] = []
        prefills: List[tuple] = []
        effs: Dict[int, float] = {}
        for uid, t in self._pending.items():
            if not t:
                continue
            if t[0] == FEEDBACK_TOKEN \
                    and self._fb_step.get(uid) != self._dispatch_seq:
                # deferred sample owned by an OLDER still-uncollected
                # step (pipeline_depth >= 3): the step only sees the last
                # dispatch's samples, so wait for the owner's collect
                continue
            m = self._meta.get(uid)
            effs[uid] = effective_priority(
                m.priority, m.t_arrival, now,
                ocfg.aging_ms) if m is not None else 0.0
            (decodes if len(t) == 1 and uid in self.state.seqs
             else prefills).append((uid, t))
        decodes.sort(key=lambda e: effs[e[0]])
        prefills.sort(key=lambda e: effs[e[0]])
        for uid, toks in decodes + prefills:
            if budget <= 0:
                break
            if self._pending.get(uid) is not toks:
                # a mid-round preemption rebound this uid's pending list;
                # the requeue waits its turn next round
                continue
            verdict = admit(uid, toks)
            while verdict == "starved" and preempts_left > 0:
                # preemption compares RAW tiers: two equal requests must
                # never evict each other back and forth
                m = self._meta.get(uid)
                victim = select_victim(
                    self._victim_candidates(sched_uids | {uid}),
                    better_than=m.priority if m else 0)
                if victim is None:
                    break
                self._preempt(victim)
                preempts_left -= 1
                verdict = admit(uid, toks)
        return sched

    def _victim_candidates(self, exclude: set) -> List[tuple]:
        """``(uid, raw_priority, n_blocks)`` for every live sequence
        preemption may evict: nothing scheduled this round or in flight,
        nothing whose KV contents the host cannot reconstruct, nothing
        already at the context limit."""
        out = []
        for uid, seq in self.state.seqs.items():
            if uid in exclude or uid in self._ctx_exhausted:
                continue
            if self._inflight_sched.get(uid, 0) or not seq.resumable:
                continue
            p = self._pending.get(uid)
            if p and p[0] == FEEDBACK_TOKEN:
                continue
            m = self._meta.get(uid)
            out.append((uid, float(m.priority if m else 0),
                        len(seq.blocks)))
        return out

    def _preempt(self, uid: int) -> None:
        """Preemption-by-eviction: release ``uid``'s KV (hashed full
        blocks retire to the cached-free pool, so with the prefix cache
        the re-prefill is one aliasing pass) and re-queue its full
        host-known token stream as a prompt.  Not terminal."""
        seq = self.state.seqs[uid]
        requeue = [int(t) for t in seq.chain]
        tail = [int(t) for t in self._pending.get(uid, [])
                if t != FEEDBACK_TOKEN]
        if seq.tokens:
            self._preempt_gen[uid] = (self._preempt_gen.get(uid, [])
                                      + [int(t) for t in seq.tokens])
        self._preempting.add(uid)
        try:
            self.state.release(uid)
        finally:
            self._preempting.discard(uid)
        self._fb_step.pop(uid, None)
        self._pending[uid] = requeue + tail

    def _reap_deadlines(self, now: float) -> None:
        for uid in list(self._deadline_uids):
            m = self._meta.get(uid)
            if m is None:
                self._deadline_uids.discard(uid)
                continue
            if not m.expired(now) or self._inflight_sched.get(uid, 0):
                continue
            self._finish(uid, "deadline_exceeded")
            self._reaped.add(uid)

    def _close_ctx_exhausted(self) -> None:
        """Close context-exhausted sequences once nothing is in flight
        for them (status ``context_exhausted``)."""
        for uid in list(self._ctx_exhausted):
            if uid not in self.state.seqs:
                self._ctx_exhausted.discard(uid)
            elif not self._inflight_sched.get(uid, 0):
                self._finish(uid, "context_exhausted")
                self._reaped.add(uid)

    # ------------------------------------------------------------------
    # dispatch / collect
    # ------------------------------------------------------------------
    def step(self, sampling: SamplingParams = SamplingParams()
             ) -> Dict[int, int]:
        """Run one engine step; returns {uid: next_token} for sequences
        whose last pending token was consumed.  Strict-sync form of the
        pipeline: dispatch, then read straight back."""
        st = self._dispatch(sampling)
        if st is None:
            return {}
        return {u: ts[-1] for u, ts in self._collect(st).items()}

    def _dispatch(self, sampling: SamplingParams) -> Optional[_InFlight]:
        """Schedule, stage and launch one serving step WITHOUT reading
        the sampled tokens back; returns the in-flight record or None
        when nothing is schedulable."""
        t0 = time.perf_counter()
        sched = self._schedule()
        self._close_ctx_exhausted()
        if not sched:
            return None
        # context bucket: the step's block bound covers every scheduled
        # sequence's post-step context, rounded to a power of two (the
        # plain attention's work grows with it; the kernel walks only
        # each token's own blocks)
        bs_blk = self.icfg.kv_block_size
        need = 1
        for uid, toks in sched:
            seq = self.state.seqs.get(uid)
            seen = seq.seen_tokens if seq else 0
            need = max(need, -(-(seen + len(toks)) // bs_blk))
        mbs = 1
        while mbs < need:
            mbs *= 2
        mbs = min(mbs, self.max_blocks_per_seq)
        t1 = time.perf_counter()
        batch = self.state.build_batch(sched, self.icfg.token_budget,
                                       stager=self._stager)
        self._drain_cow()       # COW copies land before the step's write
        t2 = time.perf_counter()
        prev = self._last_toks if self._last_toks is not None \
            else self._zero_toks
        toks, self.state.kv = pipelined_ragged_step(
            self.cfg, self.params, self.state.kv, batch, prev,
            lambda logits: sample_rows(logits, sampling),
            bs_blk, mbs)
        if self._cuda:
            # start the token readback now, behind the sample on the
            # stream; _collect waits on this event only
            host = torch.empty(toks.shape, dtype=toks.dtype,
                               pin_memory=True)
            host.copy_(toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = toks, None
        t3 = time.perf_counter()
        self._last_toks = toks
        tm = self.timings
        tm["schedule_ms"] += (t1 - t0) * 1e3
        tm["stage_ms"] += (t2 - t1) * 1e3
        tm["device_ms"] += (t3 - t2) * 1e3
        tm["steps"] += 1
        uids = tuple(uid for uid, _ in sched)
        emit = tuple((uid, self.state.slot(uid)) for uid in uids
                     if not self._pending.get(uid))
        for uid in uids:
            self._inflight_sched[uid] = self._inflight_sched.get(uid, 0) + 1
        self._dispatch_seq += 1
        return _InFlight(toks=toks, host=host, event=event, emit=emit,
                         sid=self._dispatch_seq, uids=uids)

    def _drain_cow(self) -> None:
        """Run queued copy-on-write block copies (a prefix-cache match
        that covered a whole prompt aliases its last block as a private
        copy) on the device BEFORE the step that appends into the copy.
        Asynchronous; a round with no full-cover match is a no-op."""
        for src, dst in self.state.take_cow_copies():
            self.state.kv[:, dst] = self.state.kv[:, src]

    def _mark_feedback(self, uid: int, st: _InFlight) -> None:
        """Queue uid's next decode token as a deferred on-device read of
        step ``st``'s samples."""
        self._pending[uid] = [FEEDBACK_TOKEN]
        self._fb_step[uid] = st.sid

    def _fetch_tokens(self, st: _InFlight) -> np.ndarray:
        """THE device-to-host read of the serving loop: waits for step
        ``st``'s token copy (its event), then reads the host buffer."""
        if st.event is not None:
            st.event.synchronize()
        return st.host.numpy().copy()

    def _collect(self, st: _InFlight) -> Dict[int, List[int]]:
        """Read one in-flight step's tokens back and emit them (a list
        per uid); patches any still-deferred feedback marker THIS step
        owns to the concrete value."""
        for uid in st.uids:
            n = self._inflight_sched.get(uid, 0) - 1
            if n > 0:
                self._inflight_sched[uid] = n
            else:
                self._inflight_sched.pop(uid, None)
        t0 = time.perf_counter()
        toks_np = self._fetch_tokens(st)
        t2 = time.perf_counter()
        tm = self.timings
        tm["wait_ms"] += (t2 - t0) * 1e3
        out: Dict[int, List[int]] = {}
        for uid, slot in st.emit:
            emitted = [int(toks_np[slot])]
            seq = self.state.seqs.get(uid)
            if seq is not None and self.state._slots.get(uid) == slot:
                seq.tokens.extend(emitted)
                tm["generated_tokens"] += len(emitted)
                if uid not in self.ttft_ms and uid in self._open:
                    self.ttft_ms[uid] = (t2 - self._open[uid]) * 1e3
            out[uid] = emitted
            if self._fb_step.get(uid) == st.sid:
                self._fb_step.pop(uid)
                p = self._pending.get(uid)
                if p and p[0] == FEEDBACK_TOKEN:
                    p[0] = emitted[-1]
        tm["readback_ms"] += (time.perf_counter() - t2) * 1e3
        return out

    # ------------------------------------------------------------------
    def generate(self, prompts: Dict[int, Sequence[int]],
                 sampling: SamplingParams = SamplingParams()
                 ) -> Dict[int, List[int]]:
        """Run all prompts to max_new_tokens/stop.  ``pipeline_depth >=
        2`` (the default) keeps steps in flight: host scheduling,
        staging and token readback overlap device compute, and the
        sampled tokens feed the next step on the device."""
        done: Dict[int, List[int]] = {}
        active = set()
        for uid, p in prompts.items():
            done[uid] = []
            if self.put(uid, p):
                active.add(uid)
        if self.icfg.pipeline_depth >= 2:
            return self._generate_pipelined(done, active, sampling)
        return self._generate_sync(done, active, sampling)

    def _emit(self, done, active, uid, toks, sampling) -> bool:
        """Append ``toks`` to ``done[uid]`` up to stop/max; True when the
        request finished (and was flushed)."""
        for tok in toks:
            done[uid].append(tok)
            if (sampling.stop_token is not None
                    and tok == sampling.stop_token) \
                    or len(done[uid]) >= sampling.max_new_tokens:
                active.discard(uid)
                self.flush(uid)
                return True
        return False

    def _generate_sync(self, done: Dict[int, List[int]], active: set,
                       sampling: SamplingParams) -> Dict[int, List[int]]:
        """Strict step-at-a-time driver (``pipeline_depth=1``)."""
        i = 0
        while active:
            active -= self._drain_reaped()
            if not active:
                break
            st = self._dispatch(sampling)
            outs = self._collect(st) if st is not None else {}
            for uid in list(self._ctx_exhausted):
                if uid in active:
                    active.discard(uid)
                    self.flush(uid)
                self._ctx_exhausted.discard(uid)
            for uid, toks in outs.items():
                if uid in active and not self._emit(done, active, uid,
                                                    toks, sampling):
                    self.put(uid, [toks[-1]])
            i += 1
            if i > 100_000:
                raise RuntimeError("generate() did not terminate")
        return done

    def _generate_pipelined(self, done: Dict[int, List[int]], active: set,
                            sampling: SamplingParams
                            ) -> Dict[int, List[int]]:
        """Depth-``pipeline_depth`` dispatch-ahead driver: after
        launching step N it schedules, stages and launches step N+1 —
        continuing decodes ride the FEEDBACK_TOKEN marker, so their ids
        come from step N's on-device samples — and only then reads step
        N's tokens back.  A sequence that stops at step N already has a
        speculative token in flight at N+1, which is discarded."""
        depth = self.icfg.pipeline_depth
        inflight: deque = deque()
        finishing: set = set()    # ctx-exhausted, last token still in flight
        counts = {uid: 0 for uid in done}   # emitted + in-flight samples
        stall = 0
        while active or inflight:
            reaped = self._drain_reaped()
            if reaped:
                active -= reaped
                finishing -= reaped
            while len(inflight) < depth and any(self._pending.values()):
                st = self._dispatch(sampling)
                for uid in list(self._ctx_exhausted):
                    self._ctx_exhausted.discard(uid)
                    if uid in active:
                        finishing.add(uid)
                if st is None:
                    break
                for uid, _slot in st.emit:
                    if uid not in active:
                        continue               # put() outside generate()
                    counts[uid] += 1
                    if counts[uid] >= sampling.max_new_tokens:
                        continue               # finishes by count at emit
                    self._mark_feedback(uid, st)
                inflight.append(st)
            if inflight:
                stall = 0
                out = self._collect(inflight.popleft())
                for uid, toks in out.items():
                    if uid not in active:
                        continue               # stopped earlier: discard
                    if self._emit(done, active, uid, toks, sampling):
                        finishing.discard(uid)
                    elif not self._pending.get(uid) \
                            and uid not in finishing \
                            and not self._inflight_sched.get(uid, 0):
                        self.put(uid, [toks[-1]])
                        counts[uid] = len(done[uid])
            for uid in list(finishing):
                if not any(uid == u for s in inflight for u, _ in s.emit):
                    finishing.discard(uid)
                    active.discard(uid)
                    self.flush(uid)
            if not inflight and active:
                stall += 1
                if stall > 100_000:
                    raise RuntimeError("generate() did not terminate")
        return done
