"""The network gateway: streaming tokens to real sockets.

A stdlib-asyncio HTTP/1.1 front-end (no new dependencies) over either
a single :class:`~deepspeed_tpu_torch.inference.InferenceEngine` or a
:class:`~deepspeed_tpu_torch.serving.FleetRouter` — both already speak the
same engine-shaped seam (``put``/``step``/``flush``/``cancel``/
``query``), so the gateway fronts either without knowing which
(docs/SERVING.md "Network gateway").

Wire surface:

* ``POST /v1/completions`` — OpenAI-style body (token-id prompts; the
  stack is tokenizer-free), ``stream: true`` for SSE token streaming.
* ``GET /healthz`` — the engine health ladder as status codes.
* ``GET /metrics`` — the Prometheus exposition that already exists
  (engine registry, or the fleet's one merged exposition).
* ``SIGTERM`` — graceful drain: in-flight streams finish, new
  arrivals get 503 + Retry-After, the backend's ``drain()`` settles
  leftovers, the process exits clean.

Concurrency contract: the engine is synchronous and NOT thread-safe,
so every backend call — steps, puts, cancels, health probes, metric
scrapes — runs on ONE single-worker executor thread via
:meth:`Gateway._call`; the event loop never blocks on the engine and
the engine never sees two concurrent callers.  The ``async-blocking``
lint rule (docs/TPULINT.md) holds this file to that discipline.

Backpressure is a translation, not new policy: a non-admitted
:class:`AdmissionVerdict` becomes 429/503 with a computed Retry-After
(protocol.shed_decision), and a slow SSE *reader* stalls its own
stream — the driver stops feeding that uid's continuation token back
to the engine until the client drains its bounded queue, so one slow
client costs itself, never the batch.

Copied from the JAX package's ``gateway/server.py``, which imports no JAX;
its imports point at the port's own modules.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

from ..inference import EngineDeadError, SamplingParams
from ..telemetry.profiler import prime_profiler
from ..utils.prng import PRNGKey
from ..utils.logging import logger
from . import protocol
from .sloclass import (SLO_CLASS_HEADER, SloClass, default_slo_classes,
                       resolve_slo)


class GatewayError(RuntimeError):
    """Gateway-level refusal (e.g. starting on a dead engine)."""


@dataclasses.dataclass
class GatewayConfig:
    host: str = "127.0.0.1"
    port: int = 0                    # 0 = ephemeral (read Gateway.port)
    model_name: str = "deepspeed-tpu"

    # completions defaults/caps
    max_tokens_default: int = 16
    max_tokens_cap: int = 512

    # per-stream backpressure: the driver stops feeding a stream's
    # continuation token back to the engine while more than this many
    # tokens sit undelivered to the client (docs/SERVING.md table)
    stream_queue: int = 8

    # SLO-class header map (sloclass.py); the default class applies
    # when the header is absent
    slo_classes: Optional[Dict[str, SloClass]] = None
    default_slo_class: str = "standard"

    # Retry-After math (protocol.retry_after_s)
    est_ms_per_request: float = 250.0
    max_retry_after_s: int = 30
    drain_retry_after_s: int = 5

    # SIGTERM drain budget: in-flight streams get this long to finish
    # before the backend drain sheds the remainder
    drain_deadline_ms: float = 30_000.0

    # sampling is per-SERVER: one compiled step serves the whole
    # ragged batch, so temperature/top_k/stop are engine-level knobs;
    # per-request knobs are max_tokens / priority / deadline_ms
    sampling: Optional[SamplingParams] = None
    seed: Optional[int] = None       # base key for temperature > 0

    # driver pacing + wire timeouts
    idle_s: float = 0.002
    head_timeout_s: float = 10.0

    install_signals: bool = True     # SIGTERM -> drain (main thread only)
    check_invariants: bool = False   # allocator/record checks per pump
    journey_retention: int = 256     # wire journeys kept (ring)

    # ops plane (docs/OBSERVABILITY.md "SLOs & error budgets"): the
    # ``GET /debug/*`` surface — "auto"|"on"|"off", auto resolves OFF
    # (exposing internals on the wire is an operator opt-in, never
    # ambient).  ops_token guards the MUTATING endpoints (``POST
    # /debug/dump`` / ``/debug/capture``): with no token configured
    # they refuse (403) even when the read surface is on.
    ops: str = "auto"
    ops_token: Optional[str] = None


class _Finish:
    """Queue sentinel: the stream ended with ``reason``."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason


@dataclasses.dataclass
class _Stream:
    """Server-side state of one wire request (streaming or not)."""
    uid: int
    rid: str
    max_tokens: int
    want_stream: bool
    queue: asyncio.Queue
    tokens: List[int] = dataclasses.field(default_factory=list)
    emitted: int = 0
    stalled: Optional[int] = None    # token held back by backpressure
    finished: bool = False
    finish_reason: Optional[str] = None
    disconnected: bool = False


def _query_params(query: str) -> Dict[str, Optional[str]]:
    """Minimal ``k=v&flag`` query parsing for the ops routes (no
    percent-decoding — ops values are ints and bare flags)."""
    params: Dict[str, Optional[str]] = {}
    for part in query.split("&"):
        if not part:
            continue
        k, sep, v = part.partition("=")
        params[k] = v if sep else None
    return params


def _jsonable(obj):
    """Config objects -> JSON-safe trees for ``GET /debug/config``:
    dataclasses expand field-by-field, anything non-primitive falls
    back to ``repr`` (a resolved config must always serialize — an
    exotic field value can't take the route down)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    return repr(obj)


# engine-side terminal statuses -> the finish_reason the wire reports
_STATUS_REASON = {"finished": "stop", "cancelled": "cancelled",
                  "deadline_exceeded": "deadline_exceeded",
                  "shed": "shed", "failed": "failed",
                  "context_exhausted": "length", "released": "released",
                  "migrated": "migrated", "handed_off": "handed_off"}


class Gateway:
    """One gateway over one backend (engine or fleet router).

    Use :func:`spawn_gateway` for the run-it-in-a-thread form tests
    and the load harness use; a real deployment runs
    :meth:`start` + :meth:`wait_stopped` on its own loop
    (``python -m deepspeed_tpu_torch.gateway``)."""

    def __init__(self, backend, cfg: Optional[GatewayConfig] = None):
        self.cfg = cfg or GatewayConfig()
        self.backend = backend
        # duck-typed: the router is the thing that can grow replicas
        self._is_fleet = hasattr(backend, "add_replica")
        self._sampling = self.cfg.sampling or SamplingParams(
            max_new_tokens=1 << 30)
        self._rng = None
        if self.cfg.seed is not None:
            # bitwise the JAX package's threefry key for the same seed
            self._rng = PRNGKey(self.cfg.seed)
        self._slo = self.cfg.slo_classes or default_slo_classes()
        if self.cfg.default_slo_class not in self._slo:
            raise GatewayError(
                f"default_slo_class {self.cfg.default_slo_class!r} is not "
                f"in the class map {sorted(self._slo)}")
        if self.cfg.ops not in ("auto", "on", "off"):
            raise GatewayError(
                f"ops={self.cfg.ops!r}: expected 'auto', 'on', or 'off'")
        self._ops_on = self.cfg.ops == "on"

        # ONE engine thread: every backend touch is serialized here
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gateway-engine")
        self._streams: Dict[int, _Stream] = {}  # tpulint: live-set
        self._uid_iter = itertools.count(1)
        self._journeys: Dict[int, List[Dict]] = {}
        # _journeys is written on the event loop but read from the
        # engine thread (_reaped_statuses) and from test/main threads
        # (wire_journey*): one lock covers every cross-domain touch
        self._jlock = threading.Lock()
        self._t0 = time.perf_counter()
        self._wake = asyncio.Event()
        self._stopped = asyncio.Event()
        self._draining = False
        self._dead = False
        self._stop_driver = False
        self._shutting = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._driver_task: Optional[asyncio.Task] = None
        self.port: Optional[int] = None
        self.final_snapshot: Optional[Dict] = None
        self._setup_metrics()

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _setup_metrics(self) -> None:
        """Gateway-scope counters, registered into the BACKEND's
        registry so one scrape carries engine + wire truth
        (docs/OBSERVABILITY.md "Gateway counters")."""
        reg = self.backend.metrics
        self._c_conns = reg.counter(
            "serving_gateway_connections_total",
            "TCP connections accepted", int_valued=True)
        self._c_requests = reg.counter(
            "serving_gateway_requests_total",
            "HTTP requests by route", int_valued=True)
        self._c_streams = reg.counter(
            "serving_gateway_streams_total",
            "SSE streams opened", int_valued=True)
        self._c_sheds = reg.counter(
            "serving_gateway_sheds_total",
            "wire-level sheds by HTTP status code", int_valued=True)
        self._c_disc = reg.counter(
            "serving_gateway_disconnect_cancels_total",
            "client disconnects that cancelled an open request",
            int_valued=True)
        self._c_sse_bytes = reg.counter(
            "serving_gateway_sse_bytes_total",
            "SSE payload bytes written", int_valued=True)
        self._g_open = reg.gauge(
            "serving_gateway_open_streams",
            "wire requests currently open")

    def _journey(self, uid: int, phase: str, **info) -> None:
        stamp = {"phase": phase,
                 "t_ms": round((time.perf_counter() - self._t0) * 1e3, 3)}
        stamp.update(info)
        with self._jlock:
            j = self._journeys.get(uid)
            if j is None:
                while len(self._journeys) >= self.cfg.journey_retention:
                    self._journeys.pop(next(iter(self._journeys)))
                j = self._journeys[uid] = []
            j.append(stamp)

    def wire_journey(self, uid: int) -> Optional[List[Dict]]:
        """The wire-phase stamps of one request (received -> admitted/
        shed -> first_token -> closed, plus disconnects), the gateway's
        analogue of the router's request journeys."""
        with self._jlock:
            j = self._journeys.get(uid)
            return None if j is None else list(j)

    def wire_journeys(self) -> Dict[int, List[Dict]]:
        with self._jlock:
            return {u: list(j) for u, j in self._journeys.items()}

    # ------------------------------------------------------------------
    # the one seam onto the blocking backend
    # ------------------------------------------------------------------
    async def _call(self, fn, *args, **kwargs):
        """Run a blocking backend call on the single engine thread —
        the ONLY way gateway coroutines touch the engine."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec, partial(fn, *args, **kwargs))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> None:
        """Bind + start serving.  Refuses a DEAD backend loudly: a
        gateway that accepts connections only to shed 100% of them
        turns a visible outage into a silent one — restore/replace the
        engine (``load_snapshot``/``add_replica``) and start again."""
        state = await self._call(self._backend_state)
        if state == "dead":
            raise GatewayError(
                "refusing to start: backend engine is DEAD — the "
                "gateway would accept-then-shed every request; "
                "warm-restart the engine (snapshot/load_snapshot) or "
                "point the gateway at a live replica first")
        self._server = await asyncio.start_server(
            self._handle_conn, self.cfg.host, self.cfg.port,
            limit=protocol.MAX_BODY_BYTES + protocol.MAX_HEAD_BYTES)
        self.port = self._server.sockets[0].getsockname()[1]
        self._driver_task = asyncio.get_running_loop().create_task(
            self._drive())
        if self.cfg.install_signals:
            try:
                asyncio.get_running_loop().add_signal_handler(
                    signal.SIGTERM, self._on_sigterm)
            except (NotImplementedError, RuntimeError, ValueError) as e:
                # non-main-thread loops (spawn_gateway) cannot install
                # signal handlers; drains are triggered via shutdown()
                logger.debug("gateway: no SIGTERM handler (%s)", e)
        logger.info("gateway listening on %s:%d (backend=%s)",
                    self.cfg.host, self.port,
                    "fleet" if self._is_fleet else "engine")

    def _on_sigterm(self) -> None:
        logger.warning("gateway: SIGTERM — draining (deadline %.0f ms)",
                       self.cfg.drain_deadline_ms)
        asyncio.get_running_loop().create_task(self.shutdown())

    async def wait_stopped(self) -> None:
        await self._stopped.wait()

    async def shutdown(self, deadline_ms: Optional[float] = None) -> None:
        """Graceful drain (the SIGTERM path, also callable directly):
        stop admitting (new completions get 503 + Retry-After), keep
        the driver pumping until every in-flight stream finishes or
        the deadline elapses, then hand leftovers to the backend's own
        drain contract (``engine.drain`` sheds them and emits the
        final snapshot -> ``self.final_snapshot``), close the listener
        and the engine thread, and release :meth:`wait_stopped`."""
        if self._shutting:
            await self._stopped.wait()
            return
        self._shutting = True
        self._draining = True
        dl = self.cfg.drain_deadline_ms if deadline_ms is None \
            else float(deadline_ms)
        t0 = time.perf_counter()
        # phase 1: finish in-flight streams (the driver is still
        # pumping; continuations still land at the engine)
        while self._streams \
                and (time.perf_counter() - t0) * 1e3 < dl:
            await asyncio.sleep(0.005)
        # phase 2: stop the driver, settle leftovers via the backend
        self._stop_driver = True
        self._wake.set()
        if self._driver_task is not None:
            await self._driver_task
        leftovers = [s for s in self._streams.values() if not s.finished]
        rem = max(0.0, dl - (time.perf_counter() - t0) * 1e3)
        if not self._dead:
            try:
                if self._is_fleet:
                    # deliberately NOT router.drain(): that ends the
                    # FLEET's serving life (every replica drains and
                    # its breaker dies), but replicas outlive one
                    # gateway's shutdown; leftover wire requests are
                    # shed here and stay re-placeable on the fleet
                    for s in leftovers:
                        await self._call(self.backend.cancel, s.uid)
                else:
                    self.final_snapshot = await self._call(
                        self.backend.drain, rem, self._sampling,
                        self._rng)
            except EngineDeadError:
                logger.error("gateway: backend died during drain")
                self._dead = True
        for s in leftovers:
            self._close_stream(s, "shed")
            self._journey(s.uid, "drain_shed")
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # give handlers a moment to flush their final frames
        t1 = time.perf_counter()
        while self._streams and time.perf_counter() - t1 < 2.0:
            await asyncio.sleep(0.005)
        self._exec.shutdown(wait=True)
        self._stopped.set()
        logger.info("gateway: drained and stopped "
                    "(%d streams shed at deadline)", len(leftovers))

    # ------------------------------------------------------------------
    # backend probes (run on the engine thread)
    # ------------------------------------------------------------------
    def _backend_state(self) -> str:
        if self._dead:
            return "dead"
        # both backend shapes expose the same cheap ladder read:
        # engine.health_state() / FleetRouter.health_state()
        return self.backend.health_state()

    def _health_probe(self) -> Tuple[str, Dict]:
        state = self._backend_state()
        payload = self.backend.health()
        return state, payload

    def _metrics_text(self) -> str:
        if self._is_fleet:
            return self.backend.fleet_registry.prometheus_text()
        return self.backend.metrics.prometheus_text()

    def _reaped_statuses(self) -> Dict[int, str]:
        be = self.backend
        reaped = be.drain_reaped() if self._is_fleet \
            else be._drain_reaped()
        # include journeyed uids whose stream is already torn down
        # (disconnect path): their journey still needs its terminal
        # "closed" stamp even though no queue is left to feed
        with self._jlock:
            journeyed = set(self._journeys)
        return {uid: be.query(uid).get("status", "released")
                for uid in reaped
                if uid in self._streams or uid in journeyed}

    def _pump(self) -> Tuple[Dict[int, int], Dict[int, str]]:
        outs = self.backend.step(rng=self._rng, sampling=self._sampling)
        reaped = self._reaped_statuses()
        self._g_open.set(len(self._streams))
        if self.cfg.check_invariants:
            self._assert_backend_invariants()
        return outs, reaped

    def _assert_backend_invariants(self) -> None:
        """The chaos bar, run after every pump when armed: allocator
        partition intact and no lifecycle record leaked, on every live
        engine behind this gateway."""
        engines = [rep.engine for rep in self.backend._reps.values()
                   if not rep.dead] if self._is_fleet else [self.backend]
        for eng in engines:
            eng.state.allocator.assert_invariants()
            for uid in eng.requests.open:
                assert uid in eng.state.seqs or eng._pending.get(uid) \
                    or uid in eng._meta, \
                    f"gateway: leaked open record for uid {uid}"

    def _apply(self, feedbacks: List[Tuple[int, int]],
               flushes: List[int]) -> None:
        for uid, tok in feedbacks:
            s = self._streams.get(uid)
            if s is None or s.finished or s.disconnected:
                # STALE feedback: the stream closed (or its client
                # vanished and a cancel() is queued behind us) between
                # token routing and this apply.  Feeding the token
                # would RE-ADMIT the terminally-closed uid as a fresh
                # one-token prompt — a resurrected request no driver
                # owns, generating forever.  Ordering matters: the
                # disconnect path sets ``s.disconnected`` before it
                # enqueues the cancel, so this check can never skip a
                # continuation the cancel wouldn't have killed anyway.
                continue
            self.backend.put(uid, [tok])
        for uid in flushes:
            self.backend.flush(uid)

    # ------------------------------------------------------------------
    # the driver: pumps the engine off the event loop
    # ------------------------------------------------------------------
    async def _drive(self) -> None:
        try:
            while not self._stop_driver:
                fb: List[Tuple[int, int]] = []
                fl: List[int] = []
                self._resume_stalled(fb, fl)
                if fb or fl:
                    await self._call(self._apply, fb, fl)
                if not any(not s.finished
                           for s in self._streams.values()):
                    try:
                        await asyncio.wait_for(self._wake.wait(),
                                               timeout=0.05)
                    except asyncio.TimeoutError:
                        pass
                    self._wake.clear()
                    continue
                try:
                    outs, reaped = await self._call(self._pump)
                except EngineDeadError:
                    self._mark_dead()
                    break
                fb, fl = [], []
                self._route_tokens(outs, reaped, fb, fl)
                if fb or fl:
                    await self._call(self._apply, fb, fl)
                if not outs:
                    # idle/backoff round: don't hot-spin the engine
                    await asyncio.sleep(self.cfg.idle_s)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("gateway: driver crashed — failing open "
                             "streams and going dead")
            self._mark_dead()

    def _resume_stalled(self, fb: List[Tuple[int, int]],
                        fl: List[int]) -> None:
        """Backpressure release: a stalled stream whose client drained
        below the queue bound gets its held token delivered and its
        continuation fed back to the engine."""
        for s in self._streams.values():
            if s.stalled is None or s.finished:
                continue
            if s.queue.qsize() < self.cfg.stream_queue:
                tok, s.stalled = s.stalled, None
                self._deliver(s, tok, fb, fl)

    def _route_tokens(self, outs: Dict[int, int],
                      reaped: Dict[int, str],
                      fb: List[Tuple[int, int]], fl: List[int]) -> None:
        for uid, tok in outs.items():
            s = self._streams.get(uid)
            if s is None or s.finished:
                continue
            if s.queue.qsize() >= self.cfg.stream_queue:
                # slow reader: hold the token, DON'T feed the engine —
                # this stream stops consuming step budget until the
                # client catches up
                s.stalled = int(tok)
                continue
            self._deliver(s, int(tok), fb, fl)
        for uid, status in reaped.items():
            s = self._streams.get(uid)
            reason = _STATUS_REASON.get(status, status)
            if s is not None and not s.finished:
                self._close_stream(s, reason)
                continue
            # stream already gone (a disconnected handler tears down
            # before the engine's cancel reap comes back): write the
            # journey close _close_stream would have written, so every
            # journey terminates in exactly one "closed" stamp
            j = self._journeys.get(uid)
            if j is not None and not any(st["phase"] == "closed"
                                         for st in j):
                self._journey(uid, "closed", reason=reason)

    def _deliver(self, s: _Stream, tok: int,
                 fb: List[Tuple[int, int]], fl: List[int]) -> None:
        s.emitted += 1
        if s.emitted == 1:
            self._journey(s.uid, "first_token")
        s.tokens.append(tok)
        stop = self._sampling.stop_token
        finish = None
        if stop is not None and tok == stop:
            finish = "stop"
        elif s.emitted >= s.max_tokens:
            finish = "length"
        s.queue.put_nowait(tok)
        if finish is not None:
            self._close_stream(s, finish)
            fl.append(s.uid)
        else:
            fb.append((s.uid, tok))

    def _close_stream(self, s: _Stream, reason: str) -> None:  # tpulint: close-out
        if s.finished:
            return
        s.finished = True
        s.finish_reason = reason
        s.queue.put_nowait(_Finish(reason))
        self._journey(s.uid, "closed", reason=reason)

    def _mark_dead(self) -> None:
        self._dead = True
        for s in list(self._streams.values()):
            if not s.finished:
                self._close_stream(s, "failed")
        logger.error("gateway: backend engine is dead — open streams "
                     "closed 'failed', new arrivals get 503")

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------
    async def _send(self, writer: asyncio.StreamWriter, data: bytes,
                    sse: bool = False) -> None:
        writer.write(data)
        await writer.drain()
        if sse:
            self._c_sse_bytes.inc(len(data))

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._c_conns.inc()
        watcher: Optional[asyncio.Task] = None
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"),
                    timeout=self.cfg.head_timeout_s)
            except (asyncio.IncompleteReadError, ConnectionError,
                    asyncio.TimeoutError):
                return          # client gave up before a full request
            except asyncio.LimitOverrunError:
                # no blank line within the stream limit: an oversized
                # head is the client's error, not ours
                raise protocol.ProtocolError(
                    400, "head_too_large",
                    "request head exceeds the size limit")
            method, target, headers = protocol.parse_request_head(
                head[:-4])
            try:
                n_body = int(headers.get("content-length", "0") or 0)
            except ValueError:
                raise protocol.ProtocolError(
                    400, "bad_content_length",
                    f"malformed Content-Length "
                    f"{headers['content-length']!r}")
            if n_body < 0:
                raise protocol.ProtocolError(
                    400, "bad_content_length",
                    "negative Content-Length")
            if n_body > protocol.MAX_BODY_BYTES:
                raise protocol.ProtocolError(
                    413, "body_too_large",
                    f"body exceeds {protocol.MAX_BODY_BYTES} bytes")
            # the body read is bounded like the head read — a client
            # that promises bytes and stalls must not pin a handler
            # (and its fd) forever
            body = await asyncio.wait_for(
                reader.readexactly(n_body),
                timeout=self.cfg.head_timeout_s) if n_body else b""
            if method == "GET" and target == "/healthz":
                self._c_requests.inc(route="healthz")
                await self._route_healthz(writer)
            elif method == "GET" and target == "/metrics":
                self._c_requests.inc(route="metrics")
                await self._route_metrics(writer)
            elif target == "/v1/completions" and method == "POST":
                self._c_requests.inc(route="completions")
                watcher = await self._route_completions(
                    reader, writer, headers, body)
            elif self._ops_on \
                    and target.partition("?")[0].startswith("/debug/"):
                # ops OFF intentionally skips this branch: the whole
                # surface 404s below, indistinguishable from absent
                self._c_requests.inc(route="debug")
                await self._route_debug(method, target, headers, writer)
            elif target in ("/healthz", "/metrics", "/v1/completions"):
                await self._send_error(writer, protocol.ProtocolError(
                    405, "method_not_allowed",
                    f"{method} not supported on {target}"))
            else:
                await self._send_error(writer, protocol.ProtocolError(
                    404, "not_found", f"no route {target!r}"))
        except protocol.ProtocolError as e:
            await self._send_error(writer, e)
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            pass                # client went away mid-exchange
        except Exception:
            logger.exception("gateway: connection handler failed")
            await self._send_error(writer, protocol.ProtocolError(
                500, "internal", "internal gateway error"))
        finally:
            if watcher is not None:
                watcher.cancel()
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _send_error(self, writer: asyncio.StreamWriter,
                          e: protocol.ProtocolError,
                          extra: Optional[Dict[str, str]] = None) -> None:
        try:
            await self._send(writer, protocol.http_response(
                e.status, protocol.error_body(e.status, e.code, str(e)),
                extra_headers=extra))
        except (ConnectionError, OSError):
            pass

    # ------------------------------------------------------------------
    # routes
    # ------------------------------------------------------------------
    async def _route_healthz(self, writer) -> None:
        state, payload = await self._call(self._health_probe)
        if self._draining:
            state = "draining"
        code = protocol.health_status_code(state)
        extra = {}
        if code != 200:
            extra["Retry-After"] = str(self.cfg.drain_retry_after_s)
        body = json.dumps({"state": state,
                           "gateway": {
                               "draining": self._draining,
                               "dead": self._dead,
                               "open_streams": len(self._streams)},
                           "backend": payload}).encode("utf-8")
        await self._send(writer, protocol.http_response(
            code, body, extra_headers=extra))

    async def _route_metrics(self, writer) -> None:
        text = await self._call(self._metrics_text)
        await self._send(writer, protocol.http_response(
            200, text.encode("utf-8"),
            content_type="text/plain; version=0.0.4"))

    # ------------------------------------------------------------------
    # ops plane: /debug/* (docs/OBSERVABILITY.md "SLOs & error
    # budgets").  Read-only routes are gated by GatewayConfig.ops;
    # the mutators additionally by the ops token.  Every backend
    # touch still rides the single-executor _call seam.
    # ------------------------------------------------------------------
    @staticmethod
    def _require_method(method: str, want: str, path: str) -> None:
        if method != want:
            raise protocol.ProtocolError(
                405, "method_not_allowed",
                f"{method} not supported on {path}")

    def _check_ops_token(self, headers: Dict[str, str]) -> None:
        """Mutating-endpoint gate: no configured token refuses outright
        (403 — a deployment opts into remote dump/capture by setting
        one); a missing header is 401 (client never authenticated), a
        mismatched one 403."""
        if not self.cfg.ops_token:
            raise protocol.ProtocolError(
                403, "ops_mutations_disabled",
                "mutating /debug/* requires GatewayConfig.ops_token "
                "to be configured")
        got = headers.get("x-ops-token")
        if got is None:
            raise protocol.ProtocolError(
                401, "missing_ops_token",
                "x-ops-token header required")
        if got != self.cfg.ops_token:
            raise protocol.ProtocolError(
                403, "bad_ops_token", "x-ops-token mismatch")

    async def _send_json(self, writer, obj) -> None:
        await self._send(writer, protocol.http_response(
            200, json.dumps(obj).encode("utf-8")))

    async def _route_debug(self, method: str, target: str,
                           headers: Dict[str, str], writer) -> None:
        path, _, query = target.partition("?")
        if path == "/debug/slo":
            self._require_method(method, "GET", path)
            await self._send_json(
                writer, await self._call(self.backend.slo_scorecard))
        elif path.startswith("/debug/journeys/"):
            self._require_method(method, "GET", path)
            await self._route_debug_journey(path, writer)
        elif path == "/debug/anomalies":
            self._require_method(method, "GET", path)
            params = _query_params(query)
            if "tail" in params:
                await self._anomaly_tail(writer, params.get("tail"))
            else:
                await self._send_json(
                    writer, await self._call(self._ops_anomalies))
        elif path == "/debug/config":
            self._require_method(method, "GET", path)
            await self._send_json(writer,
                                  await self._call(self._ops_config))
        elif path == "/debug/dump":
            self._require_method(method, "POST", path)
            self._check_ops_token(headers)
            d = await self._call(self.backend.ops_dump)
            await self._send_json(writer, {"ok": d is not None,
                                           "dump": d})
        elif path == "/debug/capture":
            self._require_method(method, "POST", path)
            self._check_ops_token(headers)
            got = await self._call(self.backend.arm_budgeted_capture,
                                   "ops")
            await self._send_json(writer, {"ok": got is not None,
                                           "capture": got})
        else:
            raise protocol.ProtocolError(
                404, "not_found", f"no ops route {path!r}")

    async def _route_debug_journey(self, path: str, writer) -> None:
        tail = path[len("/debug/journeys/"):]
        try:
            uid = int(tail)
        except ValueError:
            raise protocol.ProtocolError(
                400, "bad_uid",
                f"journey uid must be an int, got {tail!r}")
        wire = self.wire_journey(uid)
        fleet = await self._call(self.backend.request_journey, uid) \
            if self._is_fleet else None
        if wire is None and fleet is None:
            raise protocol.ProtocolError(
                404, "unknown_uid",
                f"no journey recorded for uid {uid}")
        await self._send_json(writer, {"uid": uid, "wire": wire,
                                       "fleet": fleet})

    # ---- ops probes (run on the engine thread) -----------------------
    def _ops_anomalies(self) -> Dict:
        summ = self.backend.anomaly_summary()
        if summ is None:
            return {"enabled": False}
        return {"enabled": True, **summ}

    def _anomaly_ring(self) -> Tuple[int, List[Dict]]:
        """(total fires, full event ring) — the tail's polling read."""
        if self._is_fleet:
            ftel = self.backend._ftel
            mon = None if ftel is None else ftel.monitor
        else:
            mon = self.backend._anom
        if mon is None:
            return 0, []
        return mon.total(), [e.as_dict() for e in list(mon.events)]

    def _ops_config(self) -> Dict:
        from ..telemetry import config_fingerprint
        be = self.backend
        bcfg = be.cfg if self._is_fleet else be.icfg
        gw = _jsonable(self.cfg)
        # never serve the secret back over the surface it guards
        gw["ops_token"] = "<set>" if self.cfg.ops_token else None
        return {"fingerprint": config_fingerprint(),
                "gateway": gw, "backend": _jsonable(bcfg),
                "slo_classes": _jsonable(self._slo)}

    async def _anomaly_tail(self, writer,
                            limit_raw: Optional[str]) -> None:
        """SSE live tail of anomaly fires (``GET /debug/anomalies?
        tail``): replay the recent ring, then poll the monitor on the
        engine thread and emit each new fire as one frame.  ``?tail=N``
        closes after N frames (the deterministic form tests and
        one-shot CLIs use); bare ``?tail`` follows until the client
        disconnects or the gateway drains."""
        limit: Optional[int] = None
        if limit_raw:
            try:
                limit = max(int(limit_raw), 0)
            except ValueError:
                raise protocol.ProtocolError(
                    400, "bad_tail", f"tail must be an int, "
                    f"got {limit_raw!r}")
        await self._send(writer, protocol.sse_head(), sse=True)
        sent = 0
        total, ring = await self._call(self._anomaly_ring)
        try:
            for ev in ring[-8:]:
                if limit is not None and sent >= limit:
                    break
                await self._send(writer, protocol.sse_event(ev),
                                 sse=True)
                sent += 1
            seen = total
            while not (self._shutting or self._dead) \
                    and (limit is None or sent < limit):
                await asyncio.sleep(0.05)
                total, ring = await self._call(self._anomaly_ring)
                new = min(total - seen, len(ring))
                seen = total
                for ev in ring[len(ring) - new:] if new > 0 else ():
                    if limit is not None and sent >= limit:
                        break
                    await self._send(writer, protocol.sse_event(ev),
                                     sse=True)
                    sent += 1
            await self._send(writer, protocol.SSE_DONE, sse=True)
        except (ConnectionError, OSError):
            pass                 # tail reader went away — that's fine

    def _wire_depth(self) -> int:
        return sum(1 for s in self._streams.values() if not s.finished)

    async def _shed_response(self, writer, uid: int, status: str,
                             reason: str) -> None:
        code, ra, slug = protocol.shed_decision(
            status, reason, self._wire_depth(),
            self.cfg.est_ms_per_request, self.cfg.max_retry_after_s,
            self.cfg.drain_retry_after_s)
        self._c_sheds.inc(code=str(code))
        self._journey(uid, "shed", http=code, retry_after_s=ra)
        await self._send_error(
            writer,
            protocol.ProtocolError(code, slug,
                                   f"request shed: {reason or status}"),
            extra={"Retry-After": str(ra)})

    async def _next_uid(self) -> int:
        while True:
            uid = next(self._uid_iter)
            if uid in self._streams:
                continue
            st = (await self._call(self.backend.query, uid))["status"]
            if st in ("unknown", "forgotten"):
                return uid

    async def _route_completions(self, reader, writer,
                                 headers: Dict[str, str],
                                 body: bytes) -> Optional[asyncio.Task]:
        req = protocol.parse_completion_body(
            body, self.cfg.max_tokens_default, self.cfg.max_tokens_cap)
        try:
            priority, deadline_ms, cls = resolve_slo(
                headers.get(SLO_CLASS_HEADER), self._slo,
                self.cfg.default_slo_class, req.priority, req.deadline_ms)
        except KeyError as e:
            raise protocol.ProtocolError(
                400, "unknown_slo_class",
                f"unknown {SLO_CLASS_HEADER}: {e} (have "
                f"{sorted(self._slo)})")
        if req.uid is not None:
            uid = req.uid
            if uid in self._streams:
                raise protocol.ProtocolError(
                    409, "uid_in_use",
                    f"uid {uid} already has an open wire request")
        else:
            uid = await self._next_uid()
            while uid in self._streams:
                # an explicit-uid request grabbed this number while
                # _next_uid was off awaiting the engine thread
                uid = await self._next_uid()
        # RESERVE the uid synchronously — no await between the
        # membership check above and this insert, so two concurrent
        # same-uid requests cannot both pass the 409 guard and race
        # their puts into the engine's continuation branch (the
        # second put would silently append onto the first's prompt)
        s = _Stream(uid=uid, rid=f"cmpl-{uid}",
                    max_tokens=req.max_tokens,
                    want_stream=req.stream, queue=asyncio.Queue())
        # happens-before: the event loop is _streams' ONLY writer (this
        # insert + unreserve's del); the engine thread only performs
        # GIL-atomic point lookups (.get/membership/len) and never
        # iterates-while-mutating, and every executor read of a record
        # inserted here is ordered after the insert by the run_in_executor
        # submission that carries the uid across
        self._streams[uid] = s  # tpulint: disable=shared-state-race

        def unreserve() -> None:
            if self._streams.get(uid) is s:
                del self._streams[uid]

        self._journey(uid, "received", slo=cls, stream=req.stream,
                      prompt_tokens=len(req.prompt))
        if self._draining or self._dead:
            unreserve()
            await self._shed_response(
                writer, uid, "shed",
                "engine is dead" if self._dead else "engine is draining")
            return None
        if req.uid is not None:
            st = (await self._call(self.backend.query, uid))["status"]
            if st not in ("unknown", "forgotten"):
                unreserve()
                raise protocol.ProtocolError(
                    409, "uid_in_use",
                    f"uid {uid} is already known to the engine "
                    f"(status {st!r})")
        try:
            # both backends take the class: the fleet router routes by
            # it (interactive arrivals land on the prefill pool, batch
            # on decode) and either backend's SLO tracker evaluates
            # the request under it (telemetry/slo.py)
            verdict = await self._call(
                self.backend.put, uid, req.prompt,
                priority=priority, deadline_ms=deadline_ms,
                slo_class=cls)
        except Exception:
            unreserve()
            raise
        if not verdict.admitted:
            unreserve()
            await self._shed_response(writer, uid, verdict.status,
                                      verdict.reason)
            return None
        self._journey(uid, "admitted", status=verdict.status,
                      replica=verdict.replica)
        self._wake.set()
        watcher = asyncio.get_running_loop().create_task(
            self._watch_disconnect(reader, s))
        try:
            if req.stream:
                await self._stream_response(writer, s)
            else:
                await self._plain_response(writer, s, req)
        finally:
            unreserve()
        return watcher

    async def _watch_disconnect(self, reader: asyncio.StreamReader,
                                s: _Stream) -> None:
        """EOF on the read side means the client is gone (connections
        are one-request); an open request rides the engine's existing
        ``cancel()`` path — KV released, terminal status ``cancelled``,
        exactly the mid-flight-abort contract the engine built."""
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    break
        except (ConnectionError, OSError):
            pass
        if not s.finished and not s.disconnected:
            await self._client_gone(s)

    async def _client_gone(self, s: _Stream) -> None:
        if s.disconnected:
            return
        s.disconnected = True
        self._journey(s.uid, "disconnect", emitted=s.emitted)
        self._c_disc.inc()
        await self._call(self.backend.cancel, s.uid)

    async def _stream_response(self, writer, s: _Stream) -> None:
        self._c_streams.inc()
        created = int(time.time())
        try:
            await self._send(writer, protocol.sse_head(
                {"x-request-id": s.rid}))
            self._journey(s.uid, "sse_open")
            while True:
                item = await s.queue.get()
                if isinstance(item, _Finish):
                    frame = protocol.sse_event(protocol.completion_chunk(
                        s.rid, created, self.cfg.model_name,
                        finish_reason=item.reason)) + protocol.SSE_DONE
                    await self._send(writer, frame, sse=True)
                    break
                await self._send(writer, protocol.sse_event(
                    protocol.completion_chunk(
                        s.rid, created, self.cfg.model_name,
                        token=item)), sse=True)
        except (ConnectionError, OSError):
            if not s.finished and not s.disconnected:
                await self._client_gone(s)

    async def _plain_response(self, writer, s: _Stream,
                              req: protocol.CompletionRequest) -> None:
        created = int(time.time())
        while True:
            item = await s.queue.get()
            if isinstance(item, _Finish):
                break
        body = json.dumps(protocol.completion_response(
            s.rid, created, self.cfg.model_name, s.tokens,
            s.finish_reason or "stop", prompt_tokens=len(req.prompt),
            echo_prompt=req.prompt if req.echo else None)).encode("utf-8")
        try:
            await self._send(writer, protocol.http_response(
                200, body, extra_headers={"x-request-id": s.rid}))
        except (ConnectionError, OSError):
            pass                # response computed but client gone


# --------------------------------------------------------------------------
# run-in-a-thread helper (tests, loadgen, notebooks)
# --------------------------------------------------------------------------

class GatewayHandle:
    """A gateway running on its own event-loop thread.  ``port`` is
    bound and live on return from :func:`spawn_gateway`; call
    :meth:`begin_drain` for the programmatic SIGTERM-equivalent and
    :meth:`stop` to drain-and-join."""

    def __init__(self, gateway: Gateway, loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.gateway = gateway
        self._loop = loop
        self._thread = thread

    @property
    def host(self) -> str:
        return self.gateway.cfg.host

    @property
    def port(self) -> int:
        return self.gateway.port

    def submit(self, coro, timeout: float = 60.0):
        """Run a coroutine on the gateway loop, blocking for its
        result (the cross-thread control channel)."""
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    def begin_drain(self, deadline_ms: Optional[float] = None) -> None:
        """Trigger the drain WITHOUT waiting — exactly what the
        SIGTERM handler does in-process."""
        asyncio.run_coroutine_threadsafe(
            self.gateway.shutdown(deadline_ms), self._loop)

    def stop(self, deadline_ms: Optional[float] = None,
             timeout: float = 120.0) -> None:
        fut = asyncio.run_coroutine_threadsafe(
            self.gateway.shutdown(deadline_ms), self._loop)
        fut.result(timeout)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise GatewayError("gateway loop thread did not exit")


def spawn_gateway(backend, cfg: Optional[GatewayConfig] = None,
                  start_timeout_s: float = 120.0) -> GatewayHandle:
    """Start a :class:`Gateway` on a fresh event loop in a daemon
    thread and return once the socket is bound.  Startup errors (e.g.
    the dead-engine refusal) re-raise in the caller."""
    # the backend's capture windows open on the engine thread: prime the
    # profiler on the caller's thread first
    prime_profiler()
    box: Dict[str, object] = {}
    ready = threading.Event()

    def run() -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            gw = Gateway(backend, cfg)
            loop.run_until_complete(gw.start())
        except BaseException as e:  # startup failure -> caller
            logger.error("gateway: startup failed: %s", e)
            box["error"] = e
            ready.set()
            loop.close()
            return
        box["gw"] = gw
        box["loop"] = loop
        ready.set()
        try:
            loop.run_until_complete(gw.wait_stopped())
        finally:
            pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            loop.close()

    thread = threading.Thread(target=run, name="gateway-loop",
                              daemon=True)
    thread.start()
    if not ready.wait(start_timeout_s):
        raise GatewayError("gateway did not start within "
                           f"{start_timeout_s}s")
    if "error" in box:
        raise box["error"]
    return GatewayHandle(box["gw"], box["loop"], thread)
