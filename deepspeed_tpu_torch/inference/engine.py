"""Serving engine: continuous ragged batching with Dynamic SplitFuse.

Counterpart of ``deepspeed_tpu/inference/engine.py`` (``InferenceConfig``,
``InferenceEngine``).  Ported: ``put``, ``step``, ``generate`` (the sync
driver and the dispatch-ahead pipeline), ``flush``, ``cancel``,
``query``, the SplitFuse scheduler with prefix-cache admission and the
overload policy (priorities, deadlines, bounded admission, preemption),
the copy-on-write drain, the power-of-two context bucketing of each
step's block bound, quantized serving: int8/int4 weights
(``weight_quant``, ``quantize_embeddings``, or a pre-built ``quant_tree``)
through the mixed-input GEMM (``mixed_gemm``) and an int8/fp8 KV cache
(``kv_quant``), seeded sampling (``rng=`` on ``step`` and ``generate``)
with the JAX engine's key stream, decode bursts (``decode_burst``: the
``decode_burst()`` method, and ``generate`` at ``decode_burst > 1``) and
model-free speculative decoding (``spec_decode="on"``: prompt-lookup
drafts, one verify step a window, the longest matching prefix accepted),
failure domains (``failure``: the watchdog, the classifier, retries and
the bisection quarantine, ``inference/failures.py``) and the seam the
router and the gateway call (``health``, ``snapshot``,
``snapshot_requests``, ``migrate_out``, ``handoff_out``,
``load_snapshot``, ``restore``, ``drain``, ``put(..., slo_class=)``),
with request records in the copied ``telemetry.lifecycle.RequestTracker``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item when its config field is set away from the default): the
attention-implementation probe, telemetry (tracing, device telemetry,
anomaly detection, SLOs, captures, the flight recorder), the KV tier,
the fp6/fp12 minifloat weight layouts, KV offload and weight streaming
(Queue 1 item 4b) and tensor parallelism.

API:
    eng = InferenceEngine(model, InferenceConfig(...))
    eng.put(uid, prompt_tokens)      # enqueue / continue a request
    out = eng.step()                 # one SplitFuse step -> {uid: token}
    eng.generate(prompts, sampling, rng=PRNGKey(seed))  # convenience loop
    eng.decode_burst(steps)          # pure decode, steps tokens a request
    eng.flush(uid)                   # free a finished sequence

Sampling keys (``utils.prng``, bit for bit the JAX package's threefry
keys): a caller's key is the base key of every step of the call; without
one, a sampler that needs a key takes the next ``split`` of the engine's
own stream (``PRNGKey(0)`` at construction), one per dispatched step
(and one per burst).  Each row then samples with ``fold_in(fold_in(base,
uid), position)``, so a seeded stream does not depend on pipeline depth,
chunking, prefix-cache hits, bursts or speculation.

Fixed shapes: a step computes its scheduled tokens padded up to a token
bucket (powers of two from ``max_seqs``, or ``max_seqs`` x the verify
width, up to ``token_budget``) over a power-of-two context bucket; the
padding tokens are invalid and write only the trash block.  On the CPU
the padded step runs eagerly.  On the card every step and every burst is
a CUDA graph (the counterpart of the JAX engine's compiled-step cache):
captured once per (token bucket, context bucket, sampler[, verify
width]) — or (steps, sampler, prefix bucket) for a burst — on an
engine-owned stream after one eager warm-up there, then replayed with
its inputs copied into static device buffers (the staged batch, the
previous step's tokens, the base key).  A failed capture or replay
raises; nothing falls back to eager launches.  ``timings`` counts the
captures (``compiles``, ``compile_ms``, ``compile_retraces`` for a key
captured again after its graph was evicted) and ``graph_replays``; the
kernels' launch counters move on every replay by what the capture
counted.

Pipelining on the card: a step's sampled tokens are copied from the
graph's output into a ring of ``pipeline_depth + 1`` device buffers and
from there into a ring of pinned host buffers (non-blocking), and an
event is recorded behind the copy; the collect waits on that event only.
A blocking ``.cpu()`` of step N after step N+1 was enqueued would wait
for step N+1 too and silently serialise the pipeline.

Failure domains: a step's replay (with its token copies and event), a
burst's replay (with its) and the wait on such an event with the host
read behind it run through ``FailurePolicy.run``.  Only the wait and the
read run under the watchdog's deadline, on a worker thread: they write
nothing, so a call the watchdog abandons cannot land stale writes later.
The replays (and a capture riding one), the staging and the schedule
stay inline on the caller's thread; a hung device shows in the next
read.
A failure the classifier recognises degrades to a retry, a bisection
quarantine (status ``failed`` for the poison request) or a dead engine
(``EngineDeadError``; ``snapshot()`` reads host state only, so it works
after a sticky CUDA error too).  A real (not injected) failure may have
left the cache half written: every live sequence is re-queued and the
cache is zeroed in place on the engine's stream, so the captured graphs,
which hold its address, stay valid.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..models.transformer import Model, TransformerConfig, tree_map
from ..ops import mixed_gemm as _mixed_gemm_mod
from ..ops.mixed_gemm import flat_kn
from ..ops.mixed_gemm import held_workspaces as _mixed_workspaces
from ..ops.mixed_gemm import shape_error
from ..ops.paged_attention import forget_plan
from ..ops.paged_attention import held_workspaces as _paged_workspaces
from ..ops.quant import (WEIGHT_QUANT_BITS, QuantizedTensor,
                         is_mixed_gemm_layout, is_rowwise_int4)
from ..telemetry.lifecycle import RequestTracker
from ..telemetry.metrics import MetricsRegistry
from ..utils.logging import logger
from ..utils.prng import PRNGKey, split
from . import model as _model_mod
from .failures import (FATAL_ENGINE, POISON_STEP, DispatchTimeoutError,
                       EngineDeadError, FailureConfig, FailurePolicy,
                       InjectedFault, InjectedTimeout, bisect_groups,
                       classify_failure)
from .model import (decode_burst_forward, pipelined_ragged_step,
                    scatter_tail, snapshot_prefix)
from .overload import (AdmissionVerdict, OverloadConfig, RequestMeta,
                       admission_decision, effective_priority,
                       select_victim)
from .quantization import (DENSE_ONLY_GROUPS, contract_dims,
                           quantize_model_params)
from .ragged.state import (FEEDBACK_TOKEN, BatchStager, KVCacheConfig,
                           StateManager, batch_from_flat)
from .sampler import SamplingParams, sample_rows
from .spec_decode import NgramProposer


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
    # None | "int8" | "fp8": the paged cache holds codes + per-vector scales
    kv_quant: Optional[str] = None
    # None | "int8" | "int4" (fp6/fp12 are not ported)
    weight_quant: Optional[str] = None
    # "auto": a row-wise int8/int4 tree takes the mixed-input GEMM (no
    # probe: the kernel on the card, its plain version on the CPU), any
    # other layout is dequantized per layer; "on": the GEMM, or raise at
    # construction; "off": dequantize each layer and torch.matmul
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
    # failure domains (inference/failures.py); None = FailureConfig():
    # the "auto" watchdog engages after 8 steps
    failure: Optional[FailureConfig] = None
    kv_tier: str = "auto"
    kv_tier_ram_mb: float = 64.0
    kv_tier_dir: Optional[str] = None
    kv_tier_nvme_mb: float = 256.0
    slo: str = "auto"
    slo_objectives: Optional[dict] = None


# field -> (accepted values, ROADMAP item that ports the rest)
_HOST = "ROADMAP Queue 1, host layers above the engine"
_SERVING_OFFLOAD = "ROADMAP Queue 1 item 4b, serving offload"
_UNSUPPORTED = {
    "attn_impl": (("auto",), "ROADMAP Queue 1, serving slice: the kernel "
                  "is chosen by the tensors' device, there is no probe"),
    "weight_quant": ((None, "int8", "int4"), "ROADMAP Queue 1 item 7: the "
                     "fp6/fp12 minifloat layouts"),
    "kv_offload": ((False,), _SERVING_OFFLOAD),
    "weight_stream": ((None,), _SERVING_OFFLOAD),
    "kv_donate": (("auto", "on"), "in-place KV updates (no 'off')"),
    "comm_overlap": (("auto", "off"), "ROADMAP Queue 1, multi-GPU "
                     "training breadth (tensor parallelism)"),
    "comm_quant": ((None,), "ROADMAP Queue 1, multi-GPU training breadth"),
    "trace": ((False,), _HOST),
    "device_telemetry": (("auto", "off"), _HOST),
    "anomaly": (("auto", "off"), _HOST),
    "anomaly_cfg": ((None,), _HOST),
    "profile": ((None,), _HOST),
    "kv_tier":(("auto", "off"), _HOST),
    "slo": (("auto", "off"), _HOST),
    "slo_objectives": ((None,), _HOST),
}

# retained CUDA graphs (the JAX engine's executable-cache bounds)
_MAX_STEP_GRAPHS = 16
_MAX_BURST_GRAPHS = 8


class _InFlight(NamedTuple):
    """One dispatched-but-unread serving step: the on-device sample
    tensor ([max_seqs], or [max_seqs, W] on a speculating engine), its
    host copy and the event recorded behind that copy, the (uid, slot)
    emission list frozen at dispatch time, the dispatch sequence number,
    every uid it scheduled tokens for, the draft windows it verifies,
    the stop token of its sampler, the prefix-cache (digest, block)
    entries its build registered (a collect failure withdraws exactly
    these)."""
    toks: torch.Tensor
    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    emit: Tuple[Tuple[int, int], ...]
    sid: int
    uids: Tuple[int, ...] = ()
    drafts: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()
    stop: Optional[int] = None
    registered: Tuple[Tuple[bytes, int], ...] = ()


_TIMINGS = ("schedule_ms", "stage_ms", "device_ms", "wait_ms",
            "readback_ms", "steps", "prompt_tokens", "cached_tokens",
            "prefix_hits", "generated_tokens", "decode_steps",
            "decode_device_ms", "bursts", "burst_iterations", "compiles",
            "compile_ms", "compile_retraces", "graph_replays",
            "spec_drafted_tokens", "spec_accepted_tokens",
            "spec_rejected_tokens", "spec_windows", "step_retries",
            "requests_failed")

_HEALTH_CODE = {"healthy": 0, "degraded": 1, "draining": 2, "dead": 3}


def _launch_counted():
    """The kernel wrappers whose launch counters a graph's replay moves:
    looked up where the serving forward looks them up, at call time."""
    return (_model_mod.paged_attention, _mixed_gemm_mod.mixed_matmul_2d,
            _mixed_gemm_mod.mixed4_matmul_2d)


def launch_counts(fns) -> Dict[tuple, object]:
    """The integer counters (and dicts of them) on each function object
    of ``fns``, by (function, attribute)."""
    out = {}
    for fn in fns:
        for name, v in vars(fn).items():
            if isinstance(v, int) and not isinstance(v, bool):
                out[fn, name] = v
            elif isinstance(v, dict) and v and all(
                    isinstance(x, int) for x in v.values()):
                out[fn, name] = dict(v)
    return out


def launch_delta(before: Dict[tuple, object],
                 after: Dict[tuple, object]) -> Dict[tuple, object]:
    """What the counters moved between two :func:`launch_counts`."""
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, dict):
            b = b if isinstance(b, dict) else {}
            d = {n: c - b.get(n, 0) for n, c in v.items()
                 if c != b.get(n, 0)}
            if d:
                out[k] = d
        elif v != (b or 0):
            out[k] = v - (b or 0)
    return out


def add_launches(delta: Dict[tuple, object], sign: int = 1) -> None:
    """Move the counters by ``sign`` x ``delta``: a replay adds what its
    capture counted (the capture itself launched nothing: sign -1)."""
    for (fn, name), d in delta.items():
        cur = getattr(fn, name)
        if isinstance(d, dict):
            for n, c in d.items():
                cur[n] = cur.get(n, 0) + sign * c
        else:
            setattr(fn, name, cur + sign * d)


class _Graph:
    """A captured step or burst: the graph, its output tensor, the
    launch counts one replay stands for, and the kernel workspaces it
    captured (held, so that no later growth frees them)."""
    __slots__ = ("graph", "out", "delta", "keep")

    def __init__(self, graph, out, delta, keep):
        self.graph, self.out, self.delta, self.keep = graph, out, delta, keep


class InferenceEngine:
    """Single-device serving engine on the model's device (the card, or
    the CPU when the model was built with ``device="cpu"``)."""

    def __init__(self, model: Model, config: Optional[InferenceConfig] = None,
                 topology=None, *, quant_tree=None):
        """The positional order is the reference's (``model, config,
        topology``).  ``topology``: the device mesh of a sharded engine;
        one device takes none, and anything else raises.  ``quant_tree``:
        a pre-built quantized tree (the second output of
        ``quantization.quantize_model_params``, e.g. carried over from a
        quantized checkpoint with ``models.quant_tree_from_numpy``);
        ``model.params`` must then be the matching dense remainder, and
        ``weight_quant`` is not re-applied."""
        if topology is not None:
            raise NotImplementedError(
                f"InferenceEngine(topology={topology!r}): a sharded engine "
                "is not ported yet (ROADMAP Queue 1 item 6, multi-GPU); "
                "one device takes topology=None")
        self.model = model
        self.cfg: TransformerConfig = model.config
        self.icfg = config or InferenceConfig()
        wq = self.icfg.weight_quant
        if wq is not None and wq not in WEIGHT_QUANT_BITS:
            raise ValueError(f"weight_quant={wq!r}: expected one of "
                             f"{sorted(WEIGHT_QUANT_BITS)}")
        if self.icfg.mixed_gemm not in ("auto", "on", "off"):
            raise ValueError(f"mixed_gemm={self.icfg.mixed_gemm!r}: "
                             "expected 'auto', 'on', or 'off'")
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
        if self.icfg.decode_burst < 1:
            raise ValueError("decode_burst must be >= 1")
        self._setup_spec_decode()
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
            dtype=self.icfg.kv_dtype, quant=self.icfg.kv_quant or "none",
            device=self.device)
        self.state = StateManager(kv_cfg, max_seqs=self.icfg.max_seqs,
                                  max_blocks_per_seq=self.max_blocks_per_seq,
                                  prefix_cache=self.icfg.prefix_cache
                                  != "off")
        self.params = tree_map(
            lambda x: x.to(self.icfg.param_dtype)
            if x.dtype == torch.float32 else x, model.params)
        self._quant = None
        if quant_tree is not None:
            self._quant = quant_tree
        elif wq:
            # quantized one layer slice at a time, on the model's device
            self.params, self._quant = quantize_model_params(
                self.params, bits=WEIGHT_QUANT_BITS[wq],
                quantize_embeddings=self.icfg.quantize_embeddings)
        # "auto" takes the mixed-input GEMM wherever the tree allows it;
        # an explicit force-on with an ineligible tree is a config error:
        # fail at construction, not at the first step
        refusal = (None if self.icfg.mixed_gemm == "off"
                   else self._mixed_gemm_refusal())
        if self.icfg.mixed_gemm == "on" and refusal is not None:
            raise ValueError(f"mixed_gemm='on': {refusal}; use 'auto'")
        self._mixed_gemm_active = (self.icfg.mixed_gemm != "off"
                                   and refusal is None)
        self._cuda = self.device.type == "cuda"
        # uid -> unprocessed toks
        self._pending: Dict[int, List[int]] = {}
        self._ctx_exhausted: set = set()
        self._stager = BatchStager(self.icfg.token_budget,
                                   self.icfg.max_seqs,
                                   self.icfg.num_kv_blocks,
                                   depth=max(2, self.icfg.pipeline_depth),
                                   n_verify=self._n_verify, pin=self._cuda)
        # a speculating engine's steps return [S, W] windows, so the
        # feedback operand (and its step-0 zero fallback) is too
        self._toks_shape = ((self.icfg.max_seqs,) if self._n_verify == 1
                            else (self.icfg.max_seqs, self._n_verify))
        self._zero_toks = torch.zeros(self._toks_shape, dtype=torch.int32,
                                      device=self.device)
        self._last_toks: Optional[torch.Tensor] = None
        # CUDA graphs: (token bucket, context bucket, sampler key[, verify
        # width]) -> step graph, (steps, sampler key, prefix bucket) ->
        # burst graph, both LRU; every key ever captured (retraces)
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._burst_graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._captured_ever: set = set()
        self._steps_done = 0
        if self._cuda:
            self._setup_graph_buffers()
        # the engine's own key stream (a sampler without a caller key);
        # kept on the device: a per-step host-to-card copy would stall
        # the pipeline
        self._rng = PRNGKey(0, device=self.device)
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
        # request records (lifecycle, terminal statuses in a ring of
        # ``status_retention``), first-token ms by uid
        self.metrics = MetricsRegistry()
        self.requests = RequestTracker(
            self.metrics, max_finished=self.ocfg.status_retention)
        self._health_gauge = self.metrics.gauge(
            "serving_health_state",
            "engine health: 0=healthy 1=degraded 2=draining 3=dead")
        self.ttft_ms: Dict[int, float] = {}
        self.timings: Dict[str, float] = dict.fromkeys(_TIMINGS, 0)
        # --- failure-domain state (inference/failures.py) --------------
        self.fcfg = self.icfg.failure or FailureConfig()
        if self.fcfg.flight_dir is not None:
            raise NotImplementedError(
                f"FailureConfig.flight_dir={self.fcfg.flight_dir!r}: the "
                f"flight recorder is not ported yet ({_HOST}); accepted "
                "here: None")
        self.failures = FailurePolicy(self.fcfg, self.timings)
        self._strikes: Dict[int, int] = {}   # uid -> failing-batch count
        self._probe_groups: List[List[int]] = []  # bisection quarantine
        self._backoff_rounds = 0             # rounds admitting nothing
        self._consec_failures = 0
        self._consec_timeouts = 0
        self._last_failure_step = -(1 << 30)
        self._health = "healthy"             # healthy|degraded computed;
        self._draining = False               # draining|dead are sticky
        self.state.on_release = self._on_state_release

    def _setup_spec_decode(self) -> None:
        """Resolve ``spec_decode`` to a proposer (or None) and the fixed
        verify-window width ``_n_verify`` (``spec_max_draft + 1`` when
        on, else 1).  "auto" resolves off, as in the reference."""
        mode = self.icfg.spec_decode
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"spec_decode={mode!r}: expected 'auto', "
                             "'on', or 'off'")
        if mode == "on" and self.icfg.decode_burst > 1:
            raise ValueError(
                "spec_decode='on' with decode_burst > 1: both multi-token"
                " the decode path (bursts device-side); pick one")
        self._spec: Optional[NgramProposer] = None
        self._n_verify = 1
        if mode == "on":
            if self.icfg.spec_max_draft < 1:
                raise ValueError("spec_max_draft must be >= 1")
            self._spec = NgramProposer(self.icfg.spec_max_draft)
            self._n_verify = self.icfg.spec_max_draft + 1
        self._sched_drafts: Dict[int, List[int]] = {}

    def _setup_graph_buffers(self) -> None:
        """The card's graph state, made once: the engine's stream (every
        warm-up, capture and replay runs on it), one memory pool for the
        engine's graphs, the static inputs a replay reads (the staged
        batch, the previous step's tokens, the base key), and the rings
        the sampled tokens leave through (``pipeline_depth + 1`` device
        buffers, pinned host buffers and events)."""
        dev = self.device
        self._stream = torch.cuda.Stream(device=dev)
        self._pool = torch.cuda.graph_pool_handle()
        self._flat_dev = self._stager.device_buffer(dev)
        self._prev_dev = torch.zeros(self._toks_shape, dtype=torch.int32,
                                     device=dev)
        self._key_dev = torch.zeros(2, dtype=torch.int64, device=dev)
        n = self.icfg.pipeline_depth + 1
        self._ring_dev = [torch.zeros(self._toks_shape, dtype=torch.int32,
                                      device=dev) for _ in range(n)]
        self._ring_host = [torch.zeros(self._toks_shape, dtype=torch.int32,
                                       pin_memory=True) for _ in range(n)]
        self._ring_events = [torch.cuda.Event() for _ in range(n)]
        self._ring_i = 0
        # one burst's inputs: block tables [S, blocks], base context,
        # fed token and uid bits [S] each, staged in one pinned buffer
        S, nb = self.icfg.max_seqs, self.icfg.num_kv_blocks
        self._burst_host = torch.zeros(S * (nb + 3), dtype=torch.int32,
                                       pin_memory=True)
        self._burst_dev = torch.zeros(S * (nb + 3), dtype=torch.int32,
                                      device=dev)

    def _mixed_gemm_refusal(self) -> Optional[str]:
        """Why the resident quantized weights cannot take the mixed-input
        GEMM, or None.  Every weight the projection sites consume (the
        ``blocks`` groups outside ``DENSE_ONLY_GROUPS``; the embedding
        table is dequantized either way) must be a row-wise int8 or
        packed int4 layout whose flattened ``[K, N]`` the kernel family
        takes (``mixed_gemm.shape_error``)."""
        if self._quant is None:
            return "no quantized weights"
        leaves = [(f"{gname}.{name}", qt, contract_dims(gname, name,
                                                        len(qt.shape)))
                  for gname, group in (self._quant.get("blocks") or {}).items()
                  if gname not in DENSE_ONLY_GROUPS
                  for name, qt in group.items()
                  if isinstance(qt, QuantizedTensor)]
        if not leaves:
            return "no quantized projection weights"
        for path, qt, cd in leaves:
            if not is_mixed_gemm_layout(qt):
                return (f"{path} is {qt!r}, not a row-wise int8/int4 layout "
                        "the kernel family consumes")
            K, N = flat_kn(qt.shape[1:], cd)
            why = shape_error(K, N, is_rowwise_int4(qt))
            if why is not None:
                return f"{path} [{K}, {N}]: {why}"
        return None

    def reset_timings(self) -> None:
        """Zero the per-phase milliseconds (host scheduling, batch
        staging, the step's enqueue — ``device_ms``, of which
        ``decode_device_ms`` over the ``decode_steps`` whose rows are all
        single decode tokens — the wait for a collected step's tokens,
        their host read), the token counters (``prompt_tokens``,
        ``cached_tokens`` — prompt tokens served from the prefix cache,
        ``prefix_hits``, ``generated_tokens``), the bursts and their
        iterations, the graph counters (``compiles``, ``compile_ms``,
        ``compile_retraces``, ``graph_replays``) and the speculation
        counters (``spec_windows`` resolved, ``spec_drafted_tokens`` =
        ``spec_accepted_tokens`` + ``spec_rejected_tokens``) and the
        failure counters (``step_retries``, ``requests_failed``).  The
        graphs themselves stay captured.  Reset in place: the failure
        policy's auto deadline reads the same dict (and, as in the JAX
        engine, calibrates again after a reset)."""
        for k in self.timings:
            self.timings[k] = 0

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------
    def put(self, uid: int, tokens: Sequence[int], priority: int = 0,
            deadline_ms: Optional[float] = None,
            slo_class: Optional[str] = None) -> AdmissionVerdict:
        """Enqueue a new request or continue a known one; returns an
        :class:`AdmissionVerdict` (truthy iff the tokens entered the
        engine).  ``priority``: lower = more important.  ``deadline_ms``:
        relative to arrival; a request still unfinished when it elapses
        is closed with status ``deadline_exceeded``.  Both only matter
        on the FIRST put for a uid.  ``slo_class`` tags the request's
        record (carried by snapshots; the SLO scorecard is ROADMAP Queue
        1 item 5).  A draining or dead engine sheds new requests;
        continuations still land."""
        now = time.perf_counter()
        toks = [int(t) for t in tokens]
        if uid in self._meta or uid in self.state.seqs \
                or uid in self._pending:
            self.requests.on_arrival(uid, now, slo_class=slo_class)
            self._pending.setdefault(uid, []).extend(toks)
            return AdmissionVerdict(True, "continued")
        if self._draining or self._health == "dead":
            self.requests.on_arrival(uid, now, slo_class=slo_class)
            self.requests.on_finish(uid, now, status="shed")
            return AdmissionVerdict(False, "shed",
                                    reason="engine is "
                                    + ("dead" if self._health == "dead"
                                       else "draining"))
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
            self.requests.on_arrival(uid, now, slo_class=slo_class)
            self.requests.on_finish(uid, now, status="shed")
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
        self.requests.on_arrival(uid, now, slo_class=slo_class)
        self._pending.setdefault(uid, []).extend(toks)
        if self._spec is not None:
            # the prompt seeds the prompt-lookup history (emitted tokens
            # are observed at collect)
            self._spec.observe(uid, toks)
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
        self._strikes.pop(uid, None)
        if self._spec is not None:
            self._spec.forget(uid)
        self.requests.on_finish(uid, status=status)

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
        / ``context_exhausted`` / ``released`` / ``failed`` /
        ``migrated`` / ``handed_off``), ``forgotten`` (aged out of the
        finished ring) or ``unknown``."""
        seq = self.state.seqs.get(uid)
        if seq is not None:
            status = "running"
        elif self._pending.get(uid) or uid in self._meta:
            status = "queued"
        else:
            s = self.requests.status_of(uid)
            status = "queued" if s == "open" else (s or "unknown")
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
        self._sched_drafts = {}
        self._reap_deadlines(now)
        if self._backoff_rounds > 0:
            # retry backoff after a transient step failure: admit
            # nothing for a bounded, step-counted number of rounds
            self._backoff_rounds -= 1
            return []
        # bisection quarantine: while probe groups are queued, only the
        # head group's requests are schedulable (each probe step clears
        # its group or bisects it further); groups whose requests all
        # left the engine are pruned, or the quarantine would wedge
        probe_allowed = None
        while self._probe_groups:
            head = [u for u in self._probe_groups[0]
                    if self._pending.get(u) or u in self.state.seqs]
            if head:
                probe_allowed = set(head)
                break
            self._probe_groups.pop(0)
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
            draft: List[int] = []
            if (self._spec is not None and seq is not None
                    and len(toks) == 1 and toks[0] >= 0
                    and not seq.draft_len):
                # a decoding row with a concrete fed token mines a draft
                # window from its own history; drafts consume budget and
                # blocks like a chunked prefill
                limit = min(self._n_verify - 1, budget - 1, ctx_rem - 1)
                if limit > 0:
                    draft = self._spec.propose(uid, toks[0], limit)
            n = min(len(toks), budget, ctx_rem)
            if len(toks) > 1 and ocfg.prefill_chunk is not None:
                n = min(n, ocfg.prefill_chunk)
            nw = n + len(draft)       # the scheduled window, drafts included
            avail = self.state.allocator.free_blocks - reserved_blocks
            need = 0
            while nw > 0:
                seen = seq.seen_tokens if seq else 0
                have = len(seq.blocks) if seq else 0
                need = max(0, -(-(seen + nw) // bs) - have)
                if need <= avail:
                    break
                nw //= 2
            if nw <= 0:
                if not cached:
                    return "starved"
                draft, n = [], 0
            elif nw <= n:
                draft, n = [], nw     # pool pressure ate the window
            else:
                del draft[nw - n:]
            tm = self.timings
            tm["prompt_tokens"] += prompt_len
            if cached:
                tm["cached_tokens"] += cached
                tm["prefix_hits"] += 1
            if prompt_len or cached:
                self.requests.on_admitted(uid, prompt_len, cached,
                                          time.perf_counter())
            if n <= 0:
                # matched but the pool can't take the uncached remainder
                # yet: the sequence keeps its aliased blocks and waits
                return "ok"
            sched.append((uid, toks[:n] + draft))
            sched_uids.add(uid)
            if draft:
                self._sched_drafts[uid] = draft
            del toks[:n]
            budget -= n + len(draft)
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
            if probe_allowed is not None and uid not in probe_allowed:
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

    def _evict_to_queue(self, uid: int) -> None:
        """Release ``uid``'s KV (hashed full blocks retire to the
        cached-free pool, so with the prefix cache the re-prefill is one
        aliasing pass) and re-queue its full host-known token stream as
        a prompt.  Not terminal: the mechanics preemption and failure
        recovery share; callers count the event on the request record
        (``on_preempted`` / ``on_retried``)."""
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

    def _preempt(self, uid: int) -> None:
        """Preemption-by-eviction: evict-and-requeue, counted on the
        request record."""
        self._evict_to_queue(uid)
        self.requests.on_preempted(uid)

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
    # failure domains (inference/failures.py)
    # ------------------------------------------------------------------
    def _ensure_alive(self) -> None:
        """Refuse device work on a dead engine — ``snapshot()`` still
        works; ``restore()`` the truth onto a fresh one."""
        if self._health == "dead":
            raise EngineDeadError(
                "serving engine is dead — snapshot() holds the host-side "
                "truth; InferenceEngine.restore() it onto a fresh engine")

    def _note_step_success(self, uids) -> None:
        """One completed device step: reset the escalation counters,
        clear the strikes of every sequence it carried, and exonerate
        exactly the covered part of the head probe group (a clean step
        carrying half the group must not acquit the other half)."""
        self._consec_failures = 0
        self._consec_timeouts = 0
        for uid in uids:
            self._strikes.pop(uid, None)
        if self._probe_groups:
            covered = set(self._probe_groups[0]) & set(uids)
            if covered:
                rest = [u for u in self._probe_groups[0]
                        if u not in covered]
                if rest:
                    self._probe_groups[0] = rest
                else:
                    self._probe_groups.pop(0)

    def _zero_kv(self) -> None:
        """Zero every part of the cache in place (on the card on the
        engine's stream, behind any replay still queued there): the
        captured graphs hold the cache's address, so it is never
        reallocated."""
        kv = self.state.kv
        parts = kv if isinstance(kv, tuple) else (kv,)
        if self._cuda:
            with torch.cuda.stream(self._stream):
                for t in parts:
                    t.zero_()
        else:
            for t in parts:
                t.zero_()

    def _die(self, exc: BaseException, phase: str) -> None:
        """Mark the engine dead and raise :class:`EngineDeadError` from
        ``exc``; touches no device state."""
        self._health = "dead"
        self._health_gauge.set(_HEALTH_CODE["dead"])
        raise EngineDeadError(
            f"serving backend dead after {type(exc).__name__} at "
            f"{phase}; snapshot() holds the host-side truth — "
            "restore onto a fresh engine") from exc

    def _handle_step_failure(self, exc: BaseException, uids, phase: str,
                             registered=()) -> None:
        """Recover from one failed guarded call: classify the exception
        at the one seam (:func:`classify_failure`) and act on the verdict.

        * ``retry`` — every affected sequence is released and re-queued
          (its chain re-prefills token-identically) and the scheduler
          backs off a bounded, step-counted number of rounds.
        * ``poison`` — the same re-queue, and the batch bisects into
          probe groups the scheduler runs in isolation; a singleton
          failing batch closes its request ``failed``.
        * ``fatal`` — the engine is marked dead and
          :class:`EngineDeadError` raised; nothing touches the device on
          the way (a sticky CUDA error leaves the context unusable).

        Unrecognised exceptions re-raise untouched.  A sequence whose
        stream the host cannot replay, or with another step in flight,
        closes ``failed``.  A real (not injected) failure may have left
        the cache half written: every live sequence is re-queued, the
        prefix index dropped and the cache zeroed in place; an error of
        that zeroing declares the engine dead."""
        if isinstance(exc, DispatchTimeoutError):
            self._consec_timeouts += 1
            if self.failures.watchdog.abandoned \
                    >= self.fcfg.max_abandoned_workers:
                # the lifetime cap: an intermittently hanging device
                # must not strand workers without bound
                self._consec_timeouts = max(self._consec_timeouts,
                                            self.fcfg.fatal_timeouts)
        verdict = classify_failure(
            exc, attempt=self._consec_failures,
            consecutive_timeouts=self._consec_timeouts, cfg=self.fcfg)
        if verdict is None:
            raise exc
        self._consec_failures += 1
        self._last_failure_step = self._steps_done
        logger.warning(
            f"serving step failure at {phase} ({type(exc).__name__}: "
            f"{(str(exc).splitlines() or [''])[0][:120]}) -> {verdict}")
        if verdict == FATAL_ENGINE:
            self._die(exc, phase)
        tm = self.timings
        tm["step_retries"] += 1
        affected = [int(u) for u in uids]
        # an injected fault raises before the call runs; anything else (a
        # real error, a real expiry while the step may still run) may
        # have left the cache half written — the port always updates it
        # in place
        kv_lost = not isinstance(exc, (InjectedFault, InjectedTimeout))
        if kv_lost:
            affected = list(dict.fromkeys(list(self.state.seqs)
                                          + affected))
        singleton = verdict == POISON_STEP and len(affected) == 1
        requeued: List[int] = []
        # recovery may register post-rollback blocks (resolve_draft);
        # those ride the failed step and are withdrawn with it, while a
        # newer in-flight step's entries (a depth-2 collect failure)
        # survive
        pre_recovery = len(self.state.round_registered)
        for uid in affected:
            self._strikes[uid] = self._strikes.get(uid, 0) + 1
            seq = self.state.seqs.get(uid)
            if seq is not None and seq.draft_len:
                # drafts in the failed window were never verified
                self.state.resolve_draft(uid, 0)
                seq = self.state.seqs.get(uid)
            poison = singleton \
                or self._strikes[uid] >= self.fcfg.poison_strikes
            # another dispatched-but-uncollected step of this sequence
            # would emit from a context the re-queue regenerates
            inflight_elsewhere = self._inflight_sched.get(uid, 0) > 0
            if poison or inflight_elsewhere \
                    or (seq is not None and not seq.resumable):
                tm["requests_failed"] += 1
                self._finish(uid, "failed")
                self._reaped.add(uid)
            else:
                if seq is not None:
                    self._evict_to_queue(uid)
                self.requests.on_retried(uid)
                requeued.append(uid)
        # the failed step's KV writes never (reliably) happened: withdraw
        # the prefix-index entries that promise them
        self.state.unregister_blocks(
            list(registered)
            + list(self.state.round_registered[pre_recovery:]))
        if kv_lost:
            self.state.reset_prefix_cache()
            try:
                self._zero_kv()
            except Exception as e:
                # the device failed its own recovery: whatever the first
                # error's message, the context is gone (a sticky error
                # the classifier does not know fails here)
                self._die(e, f"{phase} recovery")
            self._last_toks = None
        # a failed probe step retires its group but never loses it: its
        # bisected split (poison) or the group itself (a transient
        # mid-quarantine) takes its place
        hit_probe = bool(self._probe_groups) \
            and bool(set(self._probe_groups[0]) & set(affected))
        if hit_probe:
            self._probe_groups.pop(0)
        if verdict == POISON_STEP and len(requeued) > 1:
            self._probe_groups = bisect_groups(requeued) \
                + self._probe_groups
        else:
            if requeued and (hit_probe or verdict == POISON_STEP):
                self._probe_groups = [list(requeued)] \
                    + self._probe_groups
            # step-counted exponential backoff, bounded
            self._backoff_rounds = min(
                self.fcfg.max_backoff_rounds,
                1 << min(self._consec_failures - 1, 6))

    # ------------------------------------------------------------------
    # health, snapshots, migration, drain (the router's seam)
    # ------------------------------------------------------------------
    def health_state(self) -> str:
        """The health-ladder state alone (no gauge write): ``healthy``,
        ``degraded`` while the last failure is within
        ``FailureConfig.health_window_steps`` steps, or the sticky
        ``draining`` / ``dead``."""
        state = self._health
        if state == "healthy" and self._steps_done \
                - self._last_failure_step <= self.fcfg.health_window_steps:
            state = "degraded"
        return state

    def health(self) -> Dict:
        """Engine health for a router's liveness probe; also sets the
        ``serving_health_state`` gauge (0 healthy, 1 degraded, 2
        draining, 3 dead).  Reads host state only, so a dead engine
        answers too.  Anomaly detection and captures are not ported
        (ROADMAP Queue 1 item 5): ``anomalies`` and ``captures`` are 0."""
        state = self.health_state()
        self._health_gauge.set(_HEALTH_CODE[state])
        tm = self.timings
        return {
            "state": state,
            "steps": int(tm["steps"]),
            "step_retries": int(tm["step_retries"]),
            "requests_failed": int(tm["requests_failed"]),
            "consecutive_failures": self._consec_failures,
            "consecutive_timeouts": self._consec_timeouts,
            "dispatch_deadline_ms": self.failures.deadline_ms(),
            "probing": bool(self._probe_groups),
            "backoff_rounds": self._backoff_rounds,
            "live": len(self.state.seqs),
            "queued": sum(1 for t in self._pending.values() if t),
            "anomalies": 0,
            "captures": 0,
        }

    # the snapshot schema the JAX engine emits and restores: a snapshot
    # is plain host data, so either engine loads the other's
    SNAPSHOT_VERSION = 2

    def _open_uids(self) -> List[int]:
        """Every uid with open work here (admission metadata, queued
        tokens, or a live sequence), in a stable order."""
        return list(dict.fromkeys(list(self._meta) + list(self._pending)
                                  + list(self.state.seqs)))

    def _request_record(self, uid: int, now: float) -> Dict:
        """One open request's restorable record: the replayable token
        stream (KV chain + still-pending tokens), the output so far and
        the admission metadata.  A stream the host cannot replay (a
        broken chain, an in-flight feedback marker) is ``exact: False``."""
        seq = self.state.seqs.get(uid)
        pend = [int(t) for t in self._pending.get(uid, [])]
        gen = list(self._preempt_gen.get(uid, []))
        exact = FEEDBACK_TOKEN not in pend
        stream = pend
        if seq is not None:
            exact = exact and seq.resumable
            stream = [int(t) for t in seq.chain] \
                + [t for t in pend if t != FEEDBACK_TOKEN]
            gen += [int(t) for t in seq.tokens]
        m = self._meta.get(uid)
        remaining = None
        if m is not None and m.deadline_ms is not None:
            remaining = max(
                0.0, m.deadline_ms - (now - m.t_arrival) * 1e3)
        rec = self.requests.open.get(uid)
        return {
            "uid": int(uid),
            "tokens": stream if exact else None,
            "generated": gen,
            "priority": int(m.priority) if m else 0,
            "deadline_ms": remaining,
            "preemptions": rec.preemptions if rec else 0,
            "retries": rec.retries if rec else 0,
            "slo": rec.slo_class if rec else None,
            "exact": exact,
        }

    def snapshot(self) -> Dict:
        """The engine's host-side truth: every open request's record
        (:meth:`_request_record`), the counters and the prefix-cache
        index digests (a routing key, not revivable KV).  No device
        state: the streams re-prefill on :meth:`restore`, and the (uid,
        position)-folded sampling keys make the resumed outputs equal
        to an uninterrupted run.  Valid on a dead engine, after a
        sticky CUDA error too (it reads no device tensor).  Take it at
        a step boundary."""
        from .. import __version__
        now = time.perf_counter()
        return {
            "version": self.SNAPSHOT_VERSION,
            "engine_version": __version__,
            "health": self.health()["state"],
            "counters": {k: self.timings[k]
                         for k in ("steps", "prompt_tokens",
                                   "cached_tokens", "generated_tokens",
                                   "step_retries", "requests_failed")},
            "requests": [self._request_record(uid, now)
                         for uid in self._open_uids()],
            "prefix_index": sorted(self.state.prefix_digests()),
        }

    def snapshot_requests(self, uids: Sequence[int]) -> Dict:
        """Restorable records of a subset of the open requests, marked
        ``"partial": True`` (uids with no open work here are skipped).
        Closes nothing: :meth:`migrate_out` extracts and closes."""
        from .. import __version__
        now = time.perf_counter()
        known = set(self._open_uids())
        wanted = dict.fromkeys(int(u) for u in uids)   # dedup, ordered
        return {
            "version": self.SNAPSHOT_VERSION,
            "engine_version": __version__,
            "partial": True,
            "requests": [self._request_record(u, now)
                         for u in wanted if u in known],
        }

    def _extract_and_close(self, uids: Sequence[int], status: str) -> Dict:
        """:meth:`snapshot_requests` of the requests a move would not
        destroy (none in flight, a replayable stream), then close them
        with ``status``; the others stay for a later step boundary."""
        eligible = [int(u) for u in uids
                    if not self._inflight_sched.get(int(u), 0)]
        part = self.snapshot_requests(eligible)
        part["requests"] = [rec for rec in part["requests"]
                            if rec["exact"] and rec["tokens"]]
        for rec in part["requests"]:
            self._finish(rec["uid"], status)
            self._reaped.add(rec["uid"])
        return part

    def migrate_out(self, uids: Sequence[int]) -> Dict:
        """Live migration: extract the given open requests and close
        them ``migrated`` here (their KV goes back to the pool); they
        live on wherever the records are ``load_snapshot(...,
        merge=True)``-ed."""
        return self._extract_and_close(uids, "migrated")

    def handoff_out(self, uids: Sequence[int]) -> Dict:
        """Prefill-to-decode handoff: :meth:`migrate_out` with the
        status ``handed_off``.  The JAX engine also stages each chain's
        blocks into its KV tier; the tier is not ported (ROADMAP Queue 1
        item 5), so the decode side re-prefills."""
        return self._extract_and_close(uids, "handed_off")

    def export_tier_chain(self, digests: Sequence[bytes]) -> Optional[Dict]:
        """The KV tier's leading run of ``digests``; None while the tier
        is off, which it always is here (ROADMAP Queue 1 item 5)."""
        return None

    def load_snapshot(self, snap: Dict, merge: bool = False) -> None:
        """Re-open a snapshot's requests here: their streams re-enter as
        prompts, admission bounds are bypassed (they were admitted
        once), output so far stays visible through ``query()``, and
        inexact records close ``failed``.  The engine must be fresh
        unless ``merge=True`` (a migration into live traffic; a uid
        already open here raises).  The whole payload is validated
        before any record is applied.  No cache tensor is written or
        allocated, so the engine's graphs stay valid.  ``tier_blocks``
        are dropped with a warning (the tier is off)."""
        if snap.get("version") != self.SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {snap.get('version')!r}: this engine "
                f"restores version {self.SNAPSHOT_VERSION}")
        open_now = set(self._open_uids()) | set(self.requests.open)
        if not merge and open_now:
            raise ValueError(
                f"load_snapshot onto an engine with {len(open_now)} open "
                "request(s): restore assumes a fresh engine — pass "
                "merge=True to migrate records into live traffic")
        incoming = [int(rec["uid"]) for rec in snap["requests"]]
        seen: set = set()
        dupes: set = set()
        for u in incoming:
            (dupes if u in seen else seen).add(u)
        if dupes:
            raise ValueError(
                f"snapshot payload repeats uid(s) {sorted(dupes)}: a "
                "request must never be applied twice")
        if merge:
            clash = open_now & set(incoming)
            if clash:
                raise ValueError(
                    f"load_snapshot(merge=True): uid(s) {sorted(clash)} "
                    "already open on this engine — a request must never "
                    "run on two replicas at once")
        now = time.perf_counter()
        tm = self.timings
        for rec in snap["requests"]:
            uid = int(rec["uid"])
            self.requests.on_arrival(uid, now, slo_class=rec.get("slo"))
            if not rec.get("exact", True) or not rec.get("tokens"):
                # device-side tokens died with the old engine
                tm["requests_failed"] += 1
                self.requests.on_finish(uid, status="failed")
                self._reaped.add(uid)
                continue
            self._meta[uid] = RequestMeta(
                priority=int(rec.get("priority", 0)),
                deadline_ms=rec.get("deadline_ms"),
                t_arrival=now)
            if rec.get("deadline_ms") is not None:
                self._deadline_uids.add(uid)
            toks = [int(t) for t in rec["tokens"]]
            self._pending[uid] = toks
            if rec.get("generated"):
                self._preempt_gen[uid] = [int(t)
                                          for t in rec["generated"]]
            open_rec = self.requests.open.get(uid)
            if open_rec is not None:
                open_rec.preemptions = int(rec.get("preemptions", 0))
                open_rec.retries = int(rec.get("retries", 0))
            if self._spec is not None:
                self._spec.observe(uid, toks)
        if snap.get("tier_blocks"):
            logger.warning(
                "load_snapshot: %d tier_blocks arrived but kv_tier is off "
                "on this engine — dropping them (the request records were "
                "applied normally)", len(snap["tier_blocks"]))

    @classmethod
    def restore(cls, model: Model, snap: Dict,
                config: Optional[InferenceConfig] = None, topology=None,
                quant_tree=None) -> "InferenceEngine":
        """Warm restart: a fresh engine (its own cache, its own graphs,
        captured as its steps first run) with every request of ``snap``
        re-opened on it::

            try:
                out = eng.step()
            except EngineDeadError:
                eng = InferenceEngine.restore(model, eng.snapshot(),
                                              eng.icfg)
        """
        eng = cls(model, config, topology, quant_tree=quant_tree)
        eng.load_snapshot(snap)
        return eng

    def finish_capture(self) -> Optional[str]:
        """Close an active capture window; captures are not ported
        (ROADMAP Queue 1 item 5), so there is never one: None."""
        return None

    def drain(self, deadline_ms: Optional[float] = None,
              sampling: SamplingParams = SamplingParams(),
              rng: Optional[torch.Tensor] = None) -> Dict:
        """Graceful drain: stop admitting new requests (continuations
        still land), run the backlog down until nothing is pending or
        ``deadline_ms`` elapses (step-bounded: a wedged pool cannot hang
        it), then return the final :meth:`snapshot` and close everything
        still open ``shed``.  The snapshot adds ``shed_uids`` (closed by
        the drain: the set to re-place elsewhere) and ``completed_uids``
        (open at the start, settled otherwise during the drain)."""
        self._draining = True
        open_at_start = set(self._open_uids()) | set(self.requests.open)
        if self._health != "dead":
            self._health = "draining"
            self._health_gauge.set(_HEALTH_CODE["draining"])
        t0 = time.perf_counter()
        pending_tokens = sum(len(t) for t in self._pending.values())
        step_budget = 4 * (pending_tokens // max(self.icfg.token_budget,
                                                 1) + len(self._pending)) \
            + 4 * self.fcfg.max_backoff_rounds + 16
        empty_rounds = 0
        while any(self._pending.values()) and step_budget > 0:
            if deadline_ms is not None \
                    and (time.perf_counter() - t0) * 1e3 >= deadline_ms:
                break
            step_budget -= 1
            try:
                out = self.step(rng=rng, sampling=sampling)
            except EngineDeadError:
                break
            # more empty rounds than the backoff cap: the rest is
            # unschedulable — the close below sheds it
            empty_rounds = 0 if out else empty_rounds + 1
            if empty_rounds > self.fcfg.max_backoff_rounds + 2:
                break
        self.finish_capture()
        snap = self.snapshot()
        shed: List[int] = []
        for uid in self._open_uids():
            self._finish(uid, "shed")
            self._reaped.add(uid)
            shed.append(int(uid))
        shed_set = set(shed)
        snap["shed_uids"] = sorted(shed_set)
        snap["completed_uids"] = sorted(
            int(u) for u in open_at_start if u not in shed_set)
        return snap

    # ------------------------------------------------------------------
    # dispatch / collect
    # ------------------------------------------------------------------
    def step(self, rng: Optional[torch.Tensor] = None,
             sampling: SamplingParams = SamplingParams()) -> Dict[int, int]:
        """Run one engine step; returns {uid: next_token} for sequences
        whose last pending token was consumed.  Strict-sync form of the
        pipeline: dispatch, then read straight back.  ``rng``: the base
        key of this step, or None for the engine's own stream."""
        st = self._dispatch(sampling, rng)
        if st is None:
            return {}
        return {u: ts[-1] for u, ts in self._collect(st).items()}

    def _rng_drawer(self, rng: Optional[torch.Tensor]):
        """None, or a zero-arg callable yielding the BASE sampling key
        for each dispatched step.  An explicit caller key is reused
        verbatim for every step of the call (moved to the engine's
        device once): per-token randomness comes from the (uid,
        position) fold inside the step (``sampler.row_keys``)."""
        if rng is None:
            return None
        rng = rng.to(self.device)
        return lambda: rng

    def token_bucket(self, n_tokens: int) -> int:
        """The token count a step of ``n_tokens`` is padded to: the least
        power-of-two multiple of ``max_seqs`` (x the verify width on a
        speculating engine) that holds it, at most ``token_budget``."""
        b = self.icfg.max_seqs * self._n_verify
        while b < n_tokens:
            b *= 2
        return min(b, self.icfg.token_budget)

    def _dispatch(self, sampling: SamplingParams,
                  rng=None) -> Optional[_InFlight]:
        """Schedule, stage and launch one serving step WITHOUT reading
        the sampled tokens back; returns the in-flight record or None
        when nothing is schedulable.  ``rng``: an explicit key, a
        zero-arg callable invoked only once a step is known to launch,
        or None (the engine's own stream when the sampler needs a
        key).  A failed launch goes to the failure seam and returns
        None."""
        self._ensure_alive()
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
        bucket = self.token_bucket(sum(len(t) for _, t in sched))
        decode = all(uid in self.state.seqs and len(toks) == 1 + len(
            self._sched_drafts.get(uid, ())) for uid, toks in sched)
        t1 = time.perf_counter()
        uids = tuple(uid for uid, _ in sched)
        try:
            if self._cuda:
                # the engine's stream follows whatever the caller queued
                cur = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(cur)
                with torch.cuda.stream(self._stream):
                    toks, host, event, t2 = self._launch_step(
                        sched, sampling, rng, bucket, mbs, uids)
                cur.wait_stream(self._stream)
            else:
                toks, host, event, t2 = self._launch_step(
                    sched, sampling, rng, bucket, mbs, uids)
        except Exception as e:
            # the failure seam: build_batch's registrations are the
            # live ledger of this step
            self._handle_step_failure(
                e, uids, "dispatch",
                registered=tuple(self.state.round_registered))
            return None
        t3 = time.perf_counter()
        self._steps_done += 1
        self._last_toks = toks
        tm = self.timings
        tm["schedule_ms"] += (t1 - t0) * 1e3
        tm["stage_ms"] += (t2 - t1) * 1e3
        tm["device_ms"] += (t3 - t2) * 1e3
        tm["steps"] += 1
        if decode:
            tm["decode_steps"] += 1
            tm["decode_device_ms"] += (t3 - t2) * 1e3
        for uid in uids:
            self.requests.on_prefill_start(uid, t3)
        emit = tuple((uid, self.state.slot(uid)) for uid in uids
                     if not self._pending.get(uid))
        for uid in uids:
            self._inflight_sched[uid] = self._inflight_sched.get(uid, 0) + 1
        self._dispatch_seq += 1
        return _InFlight(toks=toks, host=host, event=event, emit=emit,
                         sid=self._dispatch_seq, uids=uids,
                         drafts=tuple((u, tuple(d)) for u, d in
                                      self._sched_drafts.items()),
                         stop=sampling.stop_token,
                         registered=tuple(self.state.round_registered))

    def _launch_step(self, sched, sampling: SamplingParams, rng,
                     bucket: int, mbs: int, uids: Tuple[int, ...]):
        """Stage the batch and run the padded step through the failure
        policy, inline and unguarded: eagerly on the CPU, as a replay of
        its CUDA graph on the card (captured at the first step of its
        key).  Returns (tokens, their host copy, the event behind that
        copy or None, the time staging ended)."""
        cuda = self._cuda
        batch = self.state.build_batch(
            sched, self.icfg.token_budget, stager=self._stager,
            draft_lens={u: len(d) for u, d in self._sched_drafts.items()},
            n_verify=self._n_verify,
            out=self._flat_dev if cuda else None)
        self._drain_cow()       # COW copies land before the step's write
        t2 = time.perf_counter()
        if callable(rng):
            rng = rng()
        if rng is None and sampling.needs_rng:
            self._rng, rng = split(self._rng)
        # greedy takes no key (the JAX engine passes a zero key that XLA
        # then drops; here the fold would run, so none is passed)
        rng = rng.to(self.device) if sampling.needs_rng else None
        prev = self._last_toks if self._last_toks is not None \
            else self._zero_toks
        sample_fn = self._sample_fn(sampling)
        mixed = self._mixed_gemm_active
        n_verify = self._n_verify
        key = ("p", bucket, mbs, sampling.sampler_key) + (
            (n_verify,) if n_verify > 1 else ())
        if not cuda:
            def step():
                toks, _ = pipelined_ragged_step(
                    self.cfg, self.params, self._quant, self.state.kv,
                    batch._replace(n_tokens=bucket), prev, rng, sample_fn,
                    self.icfg.kv_block_size, mbs, mixed_gemm=mixed)
                return toks

            toks = self.failures.run(step, uids=uids, cold=True)
            return toks, toks, None, t2
        self._prev_dev.copy_(prev)
        if rng is not None:
            self._key_dev.copy_(rng)
        shape_key = (self.icfg.token_budget, self.icfg.max_seqs,
                     self.icfg.num_kv_blocks, self._stager.n_verify)
        n_seqs = batch.n_seqs
        key_in = self._key_dev if rng is not None else None

        def run():
            b = batch_from_flat(self._flat_dev, shape_key, bucket, n_seqs,
                                n_verify)
            toks, _ = pipelined_ragged_step(
                self.cfg, self.params, self._quant, self.state.kv, b,
                self._prev_dev, key_in, sample_fn, self.icfg.kv_block_size,
                mbs, mixed_gemm=mixed)
            return toks

        i = self._ring_i
        self._ring_i = (i + 1) % len(self._ring_dev)
        toks, host = self._ring_dev[i], self._ring_host[i]
        event = self._ring_events[i]

        def replay() -> _Graph:
            g = self._graph_for(self._graphs, _MAX_STEP_GRAPHS, key, run)
            g.graph.replay()
            toks.copy_(g.out)
            # start the token readback now, behind the sample on the
            # stream; _collect waits on this event only
            host.copy_(toks, non_blocking=True)
            event.record(self._stream)
            return g

        self._replay(replay, uids)
        return toks, host, event, t2

    def _replay(self, replay: Callable[[], _Graph], uids) -> _Graph:
        """Run ``replay`` (a graph's replay, with what rides behind it on
        the engine's stream; it returns the graph) through the failure
        policy, inline and unguarded, then count the graph's launches
        and return the graph.
        The replay rewrote the paged-attention plan workspace, so the
        wrapper forgets what it held, whatever happened."""
        try:
            g = self.failures.run(replay, uids=uids, cold=True)
        finally:
            forget_plan(self.device, self._stream.cuda_stream)
        add_launches(g.delta)
        self.timings["graph_replays"] += 1
        return g

    @staticmethod
    def _sample_fn(sampling: SamplingParams) -> Callable:
        return lambda logits, keys: sample_rows(logits, sampling, keys)

    def _graph_for(self, cache: "OrderedDict[tuple, _Graph]", bound: int,
                   key: tuple, run: Callable[[], torch.Tensor]) -> _Graph:
        """The graph of ``key`` in ``cache`` (LRU, at most ``bound``),
        captured from ``run`` when missing.  A key captured before whose
        graph was evicted is a retrace: counted and warned about, as the
        JAX engine does for a recompile."""
        g = cache.pop(key, None)
        if g is None:
            if len(cache) >= bound:
                cache.popitem(last=False)
            tm = self.timings
            if key in self._captured_ever:
                tm["compile_retraces"] += 1
                logger.warning(
                    "serving graph %r CAPTURED AGAIN (retrace #%d): the "
                    "graph cache is churning — LRU thrash or shape churn",
                    key, int(tm["compile_retraces"]))
            self._captured_ever.add(key)
            t0 = time.perf_counter()
            g = self._capture(run)
            tm["compiles"] += 1
            tm["compile_ms"] += (time.perf_counter() - t0) * 1e3
        cache[key] = g
        return g

    def _capture(self, run: Callable[[], torch.Tensor]) -> _Graph:
        """Warm ``run`` up once on the engine's stream (libraries load,
        the kernels' workspaces and plans are made, caches fill: the
        eager launches count as launches), then capture it into a CUDA
        graph in the engine's pool.  The capture launches nothing, so
        the launch counters it moved are moved back and kept as the
        graph's delta, which every replay adds.  Raises if the capture
        fails."""
        s = self._stream
        dev, sid = self.device, s.cuda_stream
        fns = _launch_counted()
        forget_plan(dev, sid)
        with torch.cuda.stream(s):
            run()
        before = launch_counts(fns)
        graph = torch.cuda.CUDAGraph()
        # the first paged-attention call of the graph must plan
        forget_plan(dev, sid)
        # no collection may run inside the capture: an unreachable engine
        # freed there (its graphs, pools, pinned buffers) makes CUDA calls
        # that invalidate it; collect now, then hold the collector off
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            # thread-local capture mode: a read the watchdog abandoned
            # may still sit in its event wait (a CUDA call the default
            # "global" mode forbids any thread to make during a capture,
            # invalidating it); the read enqueues nothing, so no other
            # thread's call touches this capture's stream
            with torch.cuda.graph(graph, pool=self._pool, stream=s,
                                  capture_error_mode="thread_local"):
                out = run()
        finally:
            if gc_was_on:
                gc.enable()
        delta = launch_delta(before, launch_counts(fns))
        add_launches(delta, -1)
        forget_plan(dev, sid)
        keep = _paged_workspaces(dev, sid) + _mixed_workspaces(dev, sid)
        return _Graph(graph, out, delta, keep)

    def _drain_cow(self) -> None:
        """Run queued copy-on-write block copies (a prefix-cache match
        that covered a whole prompt aliases its last block as a private
        copy) on the device BEFORE the step that appends into the copy;
        a quantized cache copies codes and scales.  Asynchronous; a round
        with no full-cover match is a no-op."""
        kv = self.state.kv
        parts = kv if isinstance(kv, tuple) else (kv,)
        for src, dst in self.state.take_cow_copies():
            for t in parts:
                t[:, dst] = t[:, src]

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
        return st.host.cpu().numpy().copy()

    def _collect(self, st: _InFlight) -> Dict[int, List[int]]:
        """Read one in-flight step's tokens back and emit them (a list
        per uid: one token for a plain row, up to ``1 + spec_max_draft``
        for a resolved verify window); patches any still-deferred
        feedback marker THIS step owns to the concrete value.

        Speculative acceptance happens here: a drafting row's column
        ``j`` is the model's token after window position ``j``, so the
        drafts are compared against columns ``0..k-1``; ``a`` leading
        matches emit ``a + 1`` tokens and ``resolve_draft`` rewinds the
        KV write cursor over the rejected tail.  A stop token inside the
        window truncates the emission where the stepwise engine would
        have stopped feeding."""
        for uid in st.uids:
            n = self._inflight_sched.get(uid, 0) - 1
            if n > 0:
                self._inflight_sched[uid] = n
            else:
                self._inflight_sched.pop(uid, None)
        t0 = time.perf_counter()
        try:
            # the readback surfaces the step's asynchronous errors and can
            # hang with the device: the guarded call, under the deadline
            # (``_fetch_tokens`` looked up at call time)
            toks_np = self.failures.run(lambda: self._fetch_tokens(st),
                                        uids=st.uids)
        except Exception as e:
            if st.sid == self._dispatch_seq:
                # the latest dispatch: its samples must never feed a later
                # step (the zero fallback is safe)
                self._last_toks = None
            self._handle_step_failure(e, st.uids, "collect",
                                      registered=st.registered)
            return {}
        t2 = time.perf_counter()
        self._note_step_success(st.uids)
        tm = self.timings
        tm["wait_ms"] += (t2 - t0) * 1e3
        spec = self._n_verify > 1
        drafts = dict(st.drafts)
        out: Dict[int, List[int]] = {}
        for uid, slot in st.emit:
            row = toks_np[slot]            # [W] on a speculating engine
            seq = self.state.seqs.get(uid)
            live = seq is not None and self.state._slots.get(uid) == slot
            d = drafts.get(uid)
            if d:
                a = 0
                while a < len(d) and int(row[a]) == d[a]:
                    a += 1
                emitted = [int(row[j]) for j in range(a + 1)]
                if st.stop is not None and st.stop in emitted:
                    emitted = emitted[:emitted.index(st.stop) + 1]
                if live:
                    # commit the fed token and the emitted tokens already
                    # in KV (all but the last sample); rewind the rest
                    self.state.resolve_draft(uid, len(emitted) - 1)
                    tm["spec_windows"] += 1
                    tm["spec_drafted_tokens"] += len(d)
                    tm["spec_accepted_tokens"] += len(emitted) - 1
                    tm["spec_rejected_tokens"] += len(d) - (len(emitted)
                                                            - 1)
                    self.requests.on_draft(uid, len(d), len(emitted) - 1)
            else:
                emitted = [int(row[0] if spec else row)]
            if live:
                seq.tokens.extend(emitted)
                tm["generated_tokens"] += len(emitted)
                self.requests.on_tokens(uid, len(emitted), t2)
                rec = self.requests.open.get(uid)
                if uid not in self.ttft_ms and rec is not None:
                    self.ttft_ms[uid] = rec.ttft_ms
                if self._spec is not None:
                    self._spec.observe(uid, emitted)
            out[uid] = emitted
            if self._fb_step.get(uid) == st.sid:
                self._fb_step.pop(uid)
                p = self._pending.get(uid)
                if p and p[0] == FEEDBACK_TOKEN:
                    # markers are never speculated for drafting rows, so
                    # the last emitted token is column 0's sample
                    p[0] = emitted[-1]
        tm["readback_ms"] += (time.perf_counter() - t2) * 1e3
        return out

    # ------------------------------------------------------------------
    # decode bursts
    # ------------------------------------------------------------------
    def decode_burst(self, steps: Optional[int] = None,
                     sampling: SamplingParams = SamplingParams(),
                     rng: Optional[torch.Tensor] = None
                     ) -> Dict[int, List[int]]:
        """Run ``steps`` decode iterations with no host step between
        them: each sampled token feeds the next forward on the device,
        and the tokens come back in one read.  Every pending request
        must be a single-token continuation of a live sequence (pure
        decode); the burst is capped by context headroom, shrunk until
        its KV reservation fits the free pool (a single ``step`` when it
        shrinks to 1), its blocks are reserved ahead, and a sequence
        whose stop token lands inside it is truncated there.  On the
        card the burst is one CUDA graph of (steps, sampler, prefix
        bucket).  Its replay runs inline and its read under the
        watchdog; a failure goes to the failure seam and returns {}.
        Returns {uid: [token, ...]}."""
        self._ensure_alive()
        steps = steps or max(1, self.icfg.decode_burst)
        pending = {u: t for u, t in self._pending.items() if t}
        if not pending:
            return {}
        if any(len(t) != 1 or t[0] < 0 or u not in self.state.seqs
               for u, t in pending.items()):
            raise ValueError("decode_burst requires every pending request "
                             "to be a single-token continuation (with a "
                             "concrete, non-deferred token id); use "
                             "step() for prefill")
        st = self.state
        steps = min([steps] + [st.context_remaining(u) for u in pending])
        bs_blk = self.icfg.kv_block_size
        while steps > 1:
            need = sum(st.seqs[u].blocks_needed(steps, bs_blk)
                       for u in pending)
            if need <= st.allocator.free_blocks:
                break
            steps -= 1
        if steps <= 1:
            out = self.step(rng=rng, sampling=sampling)
            return {u: [t] for u, t in out.items()}
        for uid in pending:
            if not st.reserve_ahead(uid, steps):
                raise RuntimeError(      # unreachable after the fit check
                    f"uid {uid}: cannot reserve {steps} tokens of KV")
        if rng is None:
            self._rng, rng = split(self._rng)
        t0 = time.perf_counter()
        try:
            if self._cuda:
                cur = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(cur)
                with torch.cuda.stream(self._stream):
                    toks_np, t1 = self._launch_burst(pending, steps,
                                                     sampling, rng)
                cur.wait_stream(self._stream)
            else:
                toks_np, t1 = self._launch_burst(pending, steps, sampling,
                                                 rng)
        except Exception as e:
            # the blocks reserved ahead release with the re-queue;
            # seen_tokens was not advanced, so a resumable chain
            # re-prefills token-identically
            self._handle_step_failure(e, tuple(pending), "burst")
            return {}
        t2 = time.perf_counter()
        self._steps_done += steps
        self._note_step_success(tuple(pending))
        tm = self.timings
        tm["device_ms"] += (t1 - t0) * 1e3
        tm["wait_ms"] += (t2 - t1) * 1e3
        tm["bursts"] += 1
        tm["burst_iterations"] += steps
        out: Dict[int, List[int]] = {}
        for uid in pending:
            seq_toks = [int(t) for t in toks_np[:, st.slot(uid)]]
            adv = steps
            if sampling.stop_token is not None \
                    and sampling.stop_token in seq_toks:
                # truncate at the stop token: KV rows committed = the fed
                # token + the sampled tokens before the stop
                i = seq_toks.index(sampling.stop_token)
                seq_toks = seq_toks[:i + 1]
                adv = i + 1
            st.seqs[uid].tokens.extend(seq_toks)
            tm["generated_tokens"] += len(seq_toks)
            self.requests.on_tokens(uid, len(seq_toks), t2, t_dispatch=t0)
            # the burst wrote `steps` KV rows (the fed token + the first
            # steps - 1 samples); only the pre-stop prefix is committed
            st.advance(uid, adv)
            self._pending[uid] = []
            out[uid] = seq_toks
        return out

    def _launch_burst(self, pending: Dict[int, List[int]], steps: int,
                      sampling: SamplingParams, rng: torch.Tensor):
        """Stage one burst's inputs and run it through the failure policy:
        the forward (eager on the CPU, a graph replay on the card) inline,
        its read under the watchdog.  Returns (tokens [steps, S] on the
        host, the time the launch was enqueued)."""
        self._drain_cow()       # queued COW copies precede burst writes
        S, nb = self.icfg.max_seqs, self.icfg.num_kv_blocks
        flat = (self._burst_host.numpy() if self._cuda
                else np.empty(S * (nb + 3), np.int32))
        tables = flat[:S * nb].reshape(S, nb)
        base, tok0, uid_bits = (flat[S * nb + i * S:S * nb + (i + 1) * S]
                                for i in range(3))
        tables.fill(-1)
        base.fill(0)
        tok0.fill(0)
        uid_bits.fill(0)
        st = self.state
        for uid, toks in pending.items():
            slot = st.slot(uid)
            seq = st.seqs[uid]
            base[slot] = seq.seen_tokens
            tok0[slot] = toks[0]
            uid_bits.view(np.uint32)[slot] = np.uint32(uid & 0xFFFFFFFF)
            tables[slot, :len(seq.blocks)] = seq.blocks
        # prefix bucket: doubling block-aligned sizes, so a long context
        # makes O(log) burst graphs, not one per 256 tokens of growth
        bs = self.icfg.kv_block_size
        chunk = bs * max(1, -(-256 // bs))
        cap = self.max_blocks_per_seq * bs
        P = chunk
        while P < min(int(base.max()), cap):
            P *= 2
        P = int(min(P, cap))
        key_in = rng.to(self.device) if sampling.needs_rng else None
        sample_fn = self._sample_fn(sampling)
        mixed = self._mixed_gemm_active
        gkey = ("b", steps, sampling.sampler_key, P)
        uids = tuple(pending)

        def run_on(buf, key):
            t = buf[:S * nb].reshape(S, nb)
            b, k0, u = (buf[S * nb + i * S:S * nb + (i + 1) * S]
                        for i in range(3))
            prefix = snapshot_prefix(st.kv, t, P, bs)
            toks, tail = decode_burst_forward(
                self.cfg, self.params, prefix, b, k0, steps, sample_fn, key,
                uids=u, quant=self._quant, mixed_gemm=mixed)
            scatter_tail(st.kv, tail, t, b, bs)
            return toks

        if not self._cuda:
            toks = self.failures.run(
                lambda: run_on(torch.from_numpy(flat).to(self.device),
                               key_in), uids=uids, cold=True)
            t1 = time.perf_counter()
            return self.failures.run(lambda: toks.cpu().numpy(),
                                     uids=uids), t1
        self._burst_dev.copy_(self._burst_host, non_blocking=True)
        if key_in is not None:
            self._key_dev.copy_(key_in)
        key_dev = self._key_dev if key_in is not None else None

        def replay() -> _Graph:
            g = self._graph_for(self._burst_graphs, _MAX_BURST_GRAPHS,
                                gkey, lambda: run_on(self._burst_dev,
                                                     key_dev))
            g.graph.replay()
            return g

        g = self._replay(replay, uids)
        # the tokens' copy and its event ride behind the replay on the
        # stream: the guarded read only waits and copies on the host
        host = torch.empty(g.out.shape, dtype=g.out.dtype, pin_memory=True)
        host.copy_(g.out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._stream)
        t1 = time.perf_counter()

        def read() -> np.ndarray:
            event.synchronize()
            return host.numpy().copy()

        return self.failures.run(read, uids=uids), t1

    # ------------------------------------------------------------------
    def generate(self, prompts: Dict[int, Sequence[int]],
                 sampling: SamplingParams = SamplingParams(),
                 rng: Optional[torch.Tensor] = None
                 ) -> Dict[int, List[int]]:
        """Run all prompts to max_new_tokens/stop.  With ``decode_burst >
        1``, decode-only rounds run as bursts (the sync driver);
        otherwise ``pipeline_depth >= 2`` (the default) keeps steps in
        flight: host scheduling, staging and token readback overlap
        device compute, and the sampled tokens feed the next step on the
        device.  ``rng``: the base key of every step
        (``utils.prng.PRNGKey(seed)``), or None for the engine's own
        stream."""
        done: Dict[int, List[int]] = {}
        active = set()
        for uid, p in prompts.items():
            done[uid] = []
            if self.put(uid, p):
                active.add(uid)
        if self.icfg.decode_burst <= 1 and self.icfg.pipeline_depth >= 2:
            return self._generate_pipelined(done, active, sampling, rng)
        return self._generate_sync(done, active, sampling, rng)

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
                       sampling: SamplingParams,
                       rng: Optional[torch.Tensor]) -> Dict[int, List[int]]:
        """Strict step-at-a-time driver (``pipeline_depth=1``, and the
        burst dispatcher when ``decode_burst > 1``)."""
        i = 0
        draw = self._rng_drawer(rng)
        while active:
            active -= self._drain_reaped()
            if not active:
                break
            pending = {u: t for u, t in self._pending.items() if t}
            decode_only = pending and all(
                len(t) == 1 and u in self.state.seqs
                for u, t in pending.items())
            burst = 1
            if decode_only and self.icfg.decode_burst > 1:
                # uids fed outside this call have no 'done' row: they
                # force single steps; bursts run only at the full
                # configured width (a shrinking tail would capture one
                # graph per remaining count)
                room = min((sampling.max_new_tokens - len(done[u])
                            for u in pending if u in done), default=0)
                burst = (self.icfg.decode_burst
                         if room >= self.icfg.decode_burst else 1)
            if burst > 1:
                outs = self.decode_burst(burst, sampling=sampling,
                                         rng=draw() if draw else None)
            else:
                st = self._dispatch(sampling, draw)
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
                            sampling: SamplingParams,
                            rng: Optional[torch.Tensor]
                            ) -> Dict[int, List[int]]:
        """Depth-``pipeline_depth`` dispatch-ahead driver: after
        launching step N it schedules, stages and launches step N+1 —
        continuing decodes ride the FEEDBACK_TOKEN marker, so their ids
        come from step N's on-device samples — and only then reads step
        N's tokens back.  A sequence that stops at step N already has a
        speculative token in flight at N+1, which is discarded.  With
        speculation on, a verify window's row and a row whose stream is
        predictable (``NgramProposer.lookahead``) take no marker: their
        collect puts the concrete token, on which the next schedule can
        anchor a draft window."""
        depth = self.icfg.pipeline_depth
        inflight: deque = deque()
        finishing: set = set()    # ctx-exhausted, last token still in flight
        counts = {uid: 0 for uid in done}   # emitted + in-flight samples
        draw = self._rng_drawer(rng)
        stall = 0
        while active or inflight:
            reaped = self._drain_reaped()
            if reaped:
                active -= reaped
                finishing -= reaped
            while len(inflight) < depth and any(self._pending.values()):
                st = self._dispatch(sampling, draw)
                for uid in list(self._ctx_exhausted):
                    self._ctx_exhausted.discard(uid)
                    if uid in active:
                        finishing.add(uid)
                if st is None:
                    break
                draft_uids = {u for u, _ in st.drafts}
                for uid, _slot in st.emit:
                    if uid not in active:
                        continue               # put() outside generate()
                    if uid in draft_uids or (
                            self._spec is not None
                            and self._spec.lookahead(uid)):
                        continue               # the collect puts the token
                    counts[uid] += 1
                    if counts[uid] >= sampling.max_new_tokens:
                        continue               # finishes by count at emit
                    self._mark_feedback(uid, st)
                inflight.append(st)
            if inflight:
                stall = 0
                out = self._collect(inflight.popleft())
                # a failure this round may have closed a request whose
                # older step was still in flight: drop it before its
                # tokens are emitted and fed back (a put would open it
                # again as a new request)
                reaped = self._drain_reaped()
                if reaped:
                    active -= reaped
                    finishing -= reaped
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
