"""The port's failure domains (``deepspeed_tpu_torch.inference.failures``
and the engine's recovery paths) held against the JAX package's.

Units run against the port's module: the classifier on torch's
exceptions (a bare ``RuntimeError`` is a host bug, not a failure
domain), ``FailureConfig`` validation, ``bisect_groups`` and the
watchdog's real deadline thread.  Recovery runs on both engines, in
fp32 on tests/test_failures.py's ``llama-tiny`` model (the port's
weights carried over with ``params_from_numpy``), with the same
injection schedule: a crash then a retry, a poison request under the
bisection quarantine (prefix cache on and off, the sync ``step()`` loop
and the depth-2 pipeline), a transient during the quarantine, a failed
decode burst, and timeouts that kill the engine before a seeded restore.
At depth 2 a request closed by a failure while its older step is in
flight stays closed (the JAX engine's generate() feeds that step's token back and
opens the uid again).
The streams, the ``query()`` statuses and the ``step_retries`` /
``requests_failed`` counters must be equal.  Each JAX run is built once,
in a module-scoped fixture.  A non-injected error recovers in place: the
cache keeps its storage (the card's graphs hold its address) and is
zeroed, and every live sequence is re-queued.
"""

import dataclasses
import gc
import threading
import time
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import EngineDeadError as JaxEngineDeadError
from deepspeed_tpu.inference import FailureConfig as JaxFailureConfig
from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           OverloadConfig, SamplingParams)
from deepspeed_tpu_torch.inference import failures as failures_mod
from deepspeed_tpu_torch.inference.failures import (
    FATAL_ENGINE, POISON_STEP, RETRY_STEP, DispatchTimeoutError,
    EngineDeadError, FailureConfig, FailurePolicy, InjectedFault,
    InjectedTimeout, Watchdog, bisect_groups, classify_failure)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.utils import prng

# tests/test_failures.py's engine, in fp32 on both sides
ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=8,
              num_kv_blocks=24, max_seq_len=96)
GREEDY = dict(max_new_tokens=1 << 30)
SEEDED = dict(temperature=0.8, top_k=40, max_new_tokens=1 << 30)
# either engine's EngineDeadError
DEAD = (EngineDeadError, JaxEngineDeadError)


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) with the same weights."""
    jm = jax_build_model("llama-tiny", vocab_size=128, num_layers=2,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         max_seq_len=256)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def jax_engine(jm, failure=None, **over):
    kw = dict(ENGINE, kv_dtype=jnp.float32, param_dtype=jnp.float32,
              attn_impl="xla")
    kw.update(over)
    if failure is not None:
        kw["failure"] = JaxFailureConfig(**failure)
    return JaxEngine(jm, JaxConfig(**kw))


def port_engine(pm, failure=None, **over):
    kw = dict(ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32)
    kw.update(over)
    if failure is not None:
        kw["failure"] = FailureConfig(**failure)
    return InferenceEngine(pm, InferenceConfig(**kw))


def sampling_for(eng, **kw):
    """The engine's own package's SamplingParams."""
    return (JaxSampling if isinstance(eng, JaxEngine) else SamplingParams)(
        **kw)


def key_for(eng, seed):
    """A base key of ``seed`` in the engine's own package (None: greedy)."""
    if seed is None:
        return None
    if isinstance(eng, JaxEngine):
        return jax.random.PRNGKey(seed)
    return prng.PRNGKey(seed)


def drive(eng, prompts, n_tok=5, sampling=None, seed=None, on_step=None,
          on_dead=None):
    """tests/test_failures.py's step()-API loop on either engine: feed
    the sampled tokens back, flush at ``n_tok``; ``on_step(eng, i)``
    fires before each step; ``on_dead(eng)`` maps an EngineDeadError to
    a replacement engine (a warm restart)."""
    sp = sampling_for(eng, **(sampling or GREEDY))
    done = {u: [] for u in prompts}
    for u, p in prompts.items():
        eng.put(u, list(p))
    active = set(prompts)
    n = 0
    while active:
        n += 1
        assert n < 500, f"drive wedged with {active}"
        if on_step is not None:
            on_step(eng, n)
        try:
            outs = eng.step(rng=key_for(eng, seed), sampling=sp)
        except DEAD:
            assert on_dead is not None, "engine died without a handler"
            eng = on_dead(eng)
            sp = sampling_for(eng, **(sampling or GREEDY))
            continue
        active -= eng._drain_reaped()
        for u, t in outs.items():
            if u not in active:
                continue
            done[u].append(int(t))
            if len(done[u]) >= n_tok:
                active.discard(u)
                eng.flush(u)
            else:
                eng.put(u, [int(t)])
    return done, eng


def prompts_of(n=4):
    r = np.random.RandomState(1)
    return {u: [int(x) for x in r.randint(1, 128, 8 + u)] for u in range(n)}


def outcome(eng, done):
    """What the two engines must agree on after a run."""
    tm = eng.timings
    return dict(streams=done,
                statuses={u: eng.query(u)["status"] for u in done},
                step_retries=int(tm["step_retries"]),
                requests_failed=int(tm["requests_failed"]))


def pool_is_whole(eng):
    al = eng.state.allocator
    al.assert_invariants()
    assert al.free_blocks == al.total_blocks


# --------------------------------------------------------------------------
# classifier units
# --------------------------------------------------------------------------

def _accel(msg):
    """A CUDA runtime error as this torch raises it."""
    cls = getattr(torch, "AcceleratorError", None)
    return cls(msg) if cls is not None else RuntimeError(f"CUDA error: {msg}")


CLASSIFIED = [
    ("injected crash", lambda: InjectedFault("crash"), POISON_STEP),
    ("injected oom", lambda: InjectedFault("oom"), POISON_STEP),
    ("injected transient", lambda: InjectedFault("transient"), RETRY_STEP),
    ("injected fatal", lambda: InjectedFault("fatal"), FATAL_ENGINE),
    ("torch oom", lambda: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), POISON_STEP),
    ("illegal address", lambda: _accel(
        "an illegal memory access was encountered"), FATAL_ENGINE),
    ("device assert", lambda: _accel(
        "device-side assert triggered"), FATAL_ENGINE),
    ("launch failure", lambda: RuntimeError(
        "CUDA error: unspecified launch failure"), FATAL_ENGINE),
    ("illegal instruction", lambda: RuntimeError(
        "CUDA error: an illegal instruction was encountered"), FATAL_ENGINE),
    ("ecc", lambda: RuntimeError(
        "CUDA error: uncorrectable ECC error encountered"), FATAL_ENGINE),
    ("misaligned address", lambda: _accel(
        "misaligned address\nSearch for `cudaErrorMisalignedAddress' in "
        "the CUDA documentation"), FATAL_ENGINE),
    ("invalid pc", lambda: _accel("invalid program counter"),
        FATAL_ENGINE),
    ("hardware stack error", lambda: RuntimeError(
        "CUDA error: hardware stack error"), FATAL_ENGINE),
    ("invalid address space", lambda: _accel(
        "operation not supported on global/shared address space"),
        FATAL_ENGINE),
    ("launch timeout", lambda: _accel(
        "the launch timed out and was terminated"), FATAL_ENGINE),
    ("nvlink", lambda: RuntimeError(
        "CUDA error: uncorrectable NVLink error detected during the "
        "execution"), FATAL_ENGINE),
    ("cuda oom message", lambda: RuntimeError(
        "CUDA error: out of memory"), POISON_STEP),
    ("cublas transient", lambda: RuntimeError(
        "CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx"),
        RETRY_STEP),
    ("cudaError transient", lambda: RuntimeError(
        "cudaErrorLaunchOutOfResources in graph replay"), RETRY_STEP),
    ("bare RuntimeError", lambda: RuntimeError("boom"), None),
    ("host ValueError", lambda: ValueError("bad arg"), None),
    ("host KeyError", lambda: KeyError(3), None),
    ("engine dead", lambda: EngineDeadError("dead"), None),
]


@pytest.mark.parametrize("name,make,verdict", CLASSIFIED,
                         ids=[c[0] for c in CLASSIFIED])
def test_classifier(name, make, verdict):
    assert classify_failure(make()) == verdict


def test_unrecognised_cuda_error_escalates_to_poison():
    odd = _accel("invalid argument")
    assert classify_failure(odd, attempt=0) == RETRY_STEP
    assert classify_failure(
        odd, attempt=FailureConfig().max_step_retries) == POISON_STEP


def test_timeout_escalates_to_fatal():
    cfg = FailureConfig(fatal_timeouts=2)
    for e in (DispatchTimeoutError("deadline"), InjectedTimeout("x")):
        assert classify_failure(e, consecutive_timeouts=1,
                                cfg=cfg) == RETRY_STEP
        assert classify_failure(e, consecutive_timeouts=2,
                                cfg=cfg) == FATAL_ENGINE


@pytest.mark.parametrize("bad", [dict(dispatch_timeout_ms=-5),
                                 dict(dispatch_timeout_ms="soon"),
                                 dict(fatal_timeouts=0),
                                 dict(poison_strikes=0)])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        FailureConfig(**bad)


def test_config_fields_and_defaults_are_the_reference():
    assert dataclasses.asdict(FailureConfig()) \
        == dataclasses.asdict(JaxFailureConfig())


def test_bisect_groups():
    assert bisect_groups([1]) == []
    assert bisect_groups([1, 2]) == [[1], [2]]
    assert bisect_groups([1, 2, 3, 4, 5]) == [[1, 2], [3, 4, 5]]


def test_engine_accepts_failure_config(models):
    _, pm = models
    eng = port_engine(pm, failure=dict(dispatch_timeout_ms=50.0,
                                       poison_strikes=3))
    assert eng.fcfg.poison_strikes == 3
    assert eng.failures.deadline_ms() == 50.0
    # None means FailureConfig(): the auto watchdog engages after 8 steps
    dflt = port_engine(pm)
    assert dflt.fcfg == FailureConfig()
    assert dflt.failures.deadline_ms() is None
    dflt.timings.update(steps=8, device_ms=8.0, wait_ms=8.0)
    assert dflt.failures.deadline_ms() == 10_000.0
    dflt.reset_timings()        # in place: the policy reads the same dict
    assert dflt.failures.deadline_ms() is None
    with pytest.raises(NotImplementedError, match="host layers"):
        port_engine(pm, failure=dict(flight_dir="/nonexistent"))


# --------------------------------------------------------------------------
# watchdog (tests/test_failures.py's TestWatchdog, on the port's module)
# --------------------------------------------------------------------------

class TestWatchdog:
    def test_inline_when_unbounded(self):
        wd = Watchdog()
        assert wd.run(lambda: 41 + 1, None) == 42
        assert wd._thread is None

    def test_fast_call_passes_value_and_exception(self):
        wd = Watchdog()
        assert wd.run(lambda: "ok", 1000.0) == "ok"
        with pytest.raises(ZeroDivisionError):
            wd.run(lambda: 1 // 0, 1000.0)

    def test_deadline_expiry_raises_and_recovers(self):
        wd = Watchdog()
        with pytest.raises(DispatchTimeoutError):
            wd.run(lambda: time.sleep(0.3), 30.0)
        assert wd.abandoned == 1
        assert wd.run(lambda: "alive", 1000.0) == "alive"

    def test_concurrent_guarded_calls_are_serialized(self):
        wd = Watchdog()
        results: dict = {}

        def guarded(i):
            results[i] = wd.run(lambda: i * 10, 1000.0)

        threads = [threading.Thread(target=guarded, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == {i: i * 10 for i in range(8)}
        assert wd.abandoned == 0

    def test_expiry_concurrent_with_fast_call(self):
        wd = Watchdog()

        def slow():
            with pytest.raises(DispatchTimeoutError):
                wd.run(lambda: time.sleep(0.3), 30.0)

        t = threading.Thread(target=slow)
        t.start()
        assert wd.run(lambda: "ok", 1000.0) == "ok"
        t.join()
        assert wd.abandoned == 1
        assert wd.run(lambda: "alive", 1000.0) == "alive"

    def test_dropped_engine_is_freed_and_its_worker_ends(self, models):
        """An idle worker holds neither the last guarded call (a closure
        over the engine, and so its cache) nor its result, and ends when
        its watchdog is collected."""
        _, pm = models
        eng = port_engine(pm, failure=dict(dispatch_timeout_ms=5000.0))
        drive(eng, {0: [1, 2, 3, 4]}, n_tok=3)
        thread = eng.failures.watchdog._thread
        assert thread is not None and thread.is_alive()
        ref = weakref.ref(eng)
        del eng
        gc.collect()
        assert ref() is None
        thread.join(timeout=5.0)
        assert not thread.is_alive()

    def test_auto_deadline_warmup_and_scaling(self):
        cfg = FailureConfig(watchdog_warmup_steps=4,
                            auto_timeout_floor_ms=100.0,
                            auto_timeout_scale=3.0)
        tm = {"steps": 0, "device_ms": 0.0, "wait_ms": 0.0}
        pol = FailurePolicy(cfg, tm)
        assert pol.deadline_ms() is None
        tm.update(steps=10, device_ms=400.0, wait_ms=100.0)
        assert pol.deadline_ms() == pytest.approx(150.0)
        tm.update(device_ms=40.0, wait_ms=10.0)
        assert pol.deadline_ms() == pytest.approx(100.0)
        assert FailurePolicy(FailureConfig(dispatch_timeout_ms=None),
                             tm).deadline_ms() is None
        assert FailurePolicy(FailureConfig(dispatch_timeout_ms=77.0),
                             tm).deadline_ms() == 77.0

    def test_real_hang_caught_end_to_end(self, models):
        """An injected stall on a warm step trips the real watchdog
        thread, classifies as retryable, and the requests still finish
        with the fault-free streams."""
        _, pm = models
        # a deadline well above a loaded CPU's step time: only the
        # injected stall (4 deadlines) may outlive it
        eng = port_engine(pm, failure=dict(dispatch_timeout_ms=400.0))
        prompts = {0: [1, 2, 3, 4], 1: [5, 6, 7]}
        ref, _ = drive(eng, prompts, n_tok=6)     # every key warm
        eng.reset_timings()

        def arm(e, i):
            if i == 2:
                e.failures.inject("hang")
        done, eng = drive(eng, prompts, n_tok=6, on_step=arm)
        assert done == ref
        assert int(eng.timings["step_retries"]) >= 1
        assert eng.failures.watchdog.abandoned >= 1


# --------------------------------------------------------------------------
# recovery on both engines, the same injection schedule
# --------------------------------------------------------------------------

def _crash_at_3(e, i):
    if i == 3:
        e.failures.inject("crash")


def _poison_2(e, i):
    if i == 1:
        e.failures.inject("crash", uid=2, n=1 << 20)


def _poison_2_then_timeout(e, i):
    _poison_2(e, i)
    if i == 3:
        # a transient landing while the probes run (a second one in a
        # row would kill the engine: fatal_timeouts=2)
        e.failures.inject("timeout")


SCENARIOS = {
    "crash-retry": dict(on_step=_crash_at_3),
    "poison-cache-on": dict(on_step=_poison_2, over=dict(prefix_cache="on")),
    "poison-cache-off": dict(on_step=_poison_2,
                             over=dict(prefix_cache="off")),
    "transient-mid-quarantine": dict(on_step=_poison_2_then_timeout),
}


def _run(make, model, name):
    sc = SCENARIOS[name]
    eng = make(model, **sc.get("over", {}))
    done, eng = drive(eng, prompts_of(), on_step=sc["on_step"])
    return outcome(eng, done), eng


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each scenario's JAX outcome, and the fault-free JAX streams."""
    jm, _ = models
    out = {name: _run(jax_engine, jm, name)[0] for name in SCENARIOS}
    out["fault-free"] = drive(jax_engine(jm), prompts_of())[0]
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recovery_matches_jax(models, jax_runs, name):
    _, pm = models
    got, eng = _run(port_engine, pm, name)
    want = jax_runs[name]
    assert got == want
    assert got["step_retries"] >= 1
    ref = jax_runs["fault-free"]
    if name == "crash-retry":
        assert got["streams"] == ref and got["requests_failed"] == 0
    else:
        # the poison request quarantined, every innocent exact
        assert got["statuses"][2] == "failed"
        assert got["requests_failed"] == 1
        assert all(got["streams"][u] == ref[u] for u in (0, 1, 3))
        agg = eng.requests.aggregate()
        assert agg["open"] == 0
        assert agg["statuses"] == {"failed": 1, "finished": 3}
        assert agg["retries"] > 0
    pool_is_whole(eng)


@pytest.fixture(scope="module")
def jax_pipelined_poison(models):
    jm, _ = models
    eng = jax_engine(jm, pipeline_depth=2)
    eng.failures.inject("crash", uid=2, n=1 << 20)
    out = eng.generate(prompts_of(), JaxSampling(max_new_tokens=6))
    return outcome(eng, out)


def test_pipelined_generate_quarantines_like_jax(models,
                                                 jax_pipelined_poison):
    """The depth-2 dispatch-ahead loop under a poison request: the
    same streams (uid 2's stays empty), statuses and counters."""
    _, pm = models
    eng = port_engine(pm, pipeline_depth=2)
    eng.failures.inject("crash", uid=2, n=1 << 20)
    out = eng.generate(prompts_of(), SamplingParams(max_new_tokens=6))
    assert outcome(eng, out) == jax_pipelined_poison
    assert out[2] == [] and eng.query(2)["status"] == "failed"
    pool_is_whole(eng)


def test_pipelined_failure_closes_inflight_requests_for_good(models):
    """At depth 2 the failing batch also holds a decode whose previous
    step is still in flight: that request closes ``failed`` (its stream
    cannot be replayed), and generate() drops it before the older step's
    token is emitted — feeding it back would open the uid again as a new
    request holding KV.  Nothing stays open; the pool is whole."""
    _, pm = models
    r = np.random.RandomState(5)
    prompts = {0: [int(x) for x in r.randint(1, 128, 20)],
               1: [int(x) for x in r.randint(1, 128, 20)],
               2: [int(x) for x in r.randint(1, 128, 8)]}
    eng = port_engine(pm, pipeline_depth=2)
    eng.failures.inject("crash", uid=2, n=1 << 20)
    out = eng.generate(prompts, SamplingParams(max_new_tokens=6))
    assert {u: eng.query(u)["status"] for u in prompts} \
        == dict.fromkeys(prompts, "failed")
    assert int(eng.timings["requests_failed"]) == 3
    assert not eng.requests.open and not eng.state.seqs
    assert all(len(v) <= 1 for v in out.values())
    pool_is_whole(eng)


def _burst_run(eng):
    """Prefill by step(), then bursts of 4 with a crash armed on the
    second: the burst's batch re-queues and re-prefills."""
    sp = sampling_for(eng, **GREEDY)
    prompts = prompts_of(3)
    for u, p in prompts.items():
        eng.put(u, p)
    done = {u: [] for u in prompts}
    while any(not v for v in done.values()):
        for u, t in eng.step(sampling=sp).items():
            done[u].append(int(t))
    for rnd in range(4):
        if rnd == 1:
            eng.failures.inject("crash")
        for u in prompts:
            if not eng._pending.get(u) and u in eng.state.seqs:
                eng.put(u, [done[u][-1]])
        if all(len(eng._pending.get(u, ())) == 1 for u in prompts):
            outs = eng.decode_burst(4, sampling=sp)
        else:
            outs = {u: [t] for u, t in eng.step(sampling=sp).items()}
        for u, ts in outs.items():
            done[u].extend(int(t) for t in ts)
    return outcome(eng, done)


def test_burst_failure_recovers_like_jax(models):
    jm, pm = models
    want = _burst_run(jax_engine(jm, decode_burst=4))
    got = _burst_run(port_engine(pm, decode_burst=4))
    assert got == want and got["step_retries"] == 1


@pytest.fixture(scope="module")
def jax_death(models):
    """Seeded run: a timeout kills the engine at step 3, the snapshot
    restores onto a fresh engine with the same explicit base key."""
    jm, _ = models
    return _death_run(jax_engine, jm)


def _death_run(make, model):
    fcfg = dict(fatal_timeouts=1)
    deaths = []

    def arm(e, i):
        if i == 3:
            e.failures.inject("timeout")

    def on_dead(old):
        deaths.append(old.health()["state"])
        snap = old.snapshot()
        new = type(old).restore(model, snap, old.icfg)
        return new
    done, eng = drive(make(model, failure=fcfg), prompts_of(3),
                      sampling=SEEDED, seed=7, on_step=arm, on_dead=on_dead)
    return dict(outcome(eng, done), deaths=deaths,
                open=eng.requests.aggregate()["open"])


def test_timeouts_kill_then_seeded_restore_matches_jax(models, jax_death):
    _, pm = models
    got = _death_run(port_engine, pm)
    assert got == jax_death
    assert got["deaths"] == ["dead"] and got["open"] == 0
    # and the restore changed no stream: the undisturbed seeded run
    ref, _ = drive(port_engine(pm), prompts_of(3), sampling=SEEDED, seed=7)
    assert got["streams"] == ref


def test_dead_engine_refuses_work_but_snapshots(models):
    jm, pm = models
    snaps = []
    for eng in (jax_engine(jm, failure=dict(fatal_timeouts=1)),
                port_engine(pm, failure=dict(fatal_timeouts=1))):
        eng.put(0, [1, 2, 3])
        eng.failures.inject("timeout")
        with pytest.raises(DEAD):
            eng.step()
        assert eng.health()["state"] == "dead"
        with pytest.raises(DEAD):
            eng.step()
        v = eng.put(99, [4, 5])
        assert not v.admitted and v.status == "shed"
        assert "dead" in v.reason
        snaps.append(eng.snapshot())
    jsnap, psnap = snaps
    assert psnap["requests"] == jsnap["requests"]
    assert {r["uid"] for r in psnap["requests"]} == {0}
    assert psnap["health"] == "dead" and psnap["version"] == 2


def test_real_error_recovers_in_place(models, jax_runs):
    """A non-injected poison-class error (torch's out-of-memory error,
    raised by the guarded readback) re-queues every live sequence, drops
    the prefix index and zeroes the cache in its own storage; the
    streams then finish equal to the fault-free JAX run."""
    _, pm = models
    ref = jax_runs["fault-free"]
    eng = port_engine(pm)
    kv_ptr = eng.state.kv.data_ptr()
    fetch = eng._fetch_tokens
    seen = {}

    def failing_fetch(st):
        if not seen:
            seen["live"] = sorted(eng.state.seqs)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return fetch(st)

    def arm(e, i):
        if i == 4:
            e._fetch_tokens = failing_fetch
        if i == 5:
            # right after the recovery: nothing live, cache zeroed in
            # place, every sequence queued again with its chain
            assert not e.state.seqs and seen["live"] == [0, 1, 2, 3]
            assert e.state.kv.data_ptr() == kv_ptr
            assert not bool(e.state.kv.any())
            assert not e.state.prefix_digests()
            assert all(e.query(u)["status"] == "queued" for u in range(4))
            assert e._last_toks is None
    done, eng = drive(eng, prompts_of(), on_step=arm)
    assert done == ref
    assert int(eng.timings["step_retries"]) == 1
    assert eng.health()["state"] == "degraded"
    assert eng.requests.aggregate()["retries"] == 4
    pool_is_whole(eng)


def test_abandoned_read_lands_during_the_recovered_run(models, jax_runs,
                                                      monkeypatch):
    """A hang in the guarded call (the read) expires and the run
    recovers; the abandoned call then completes while the recovered run
    is live, and the streams still finish equal to the fault-free JAX
    run: the only call the watchdog can abandon reads and never writes,
    so nothing of it lands in the cache the recovery handed on."""
    _, pm = models
    ref = jax_runs["fault-free"]
    gate = threading.Event()
    hung = []

    def stall(_seconds):
        hung.append(threading.current_thread())
        gate.wait(30.0)
    monkeypatch.setattr(failures_mod, "time", types.SimpleNamespace(
        sleep=stall, perf_counter=time.perf_counter))
    eng = port_engine(pm, failure=dict(dispatch_timeout_ms=300.0))

    def arm(e, i):
        if i == 3:
            e.failures.inject("hang")
        if i == 5:
            # two steps into the recovered run: the stalled call resumes
            assert hung and hung[0].is_alive()
            assert e.failures.watchdog.abandoned == 1
            assert e._open_uids()
            kv = e.state.kv.clone()
            gate.set()
            hung[0].join(10.0)
            assert not hung[0].is_alive()
            assert torch.equal(e.state.kv, kv)    # it wrote nothing
    done, eng = drive(eng, prompts_of(), on_step=arm)
    assert len(hung) == 1 and gate.is_set()
    assert done == ref
    assert int(eng.timings["step_retries"]) == 1
    pool_is_whole(eng)


def test_a_failed_recovery_declares_the_engine_dead(models):
    """A CUDA error the classifier only retries, whose recovery then
    fails on the device (zeroing the cache raises: the context is gone,
    whatever the first message said), marks the engine dead and raises
    EngineDeadError; snapshot() still answers from host state."""
    _, pm = models
    eng = port_engine(pm)
    eng.put(0, [1, 2, 3])

    def broken_fetch(st):
        raise _accel("unknown error")

    def broken_zero():
        raise _accel("unknown error")
    eng._fetch_tokens = broken_fetch
    eng._zero_kv = broken_zero
    with pytest.raises(EngineDeadError, match="collect recovery"):
        eng.step()
    assert eng.health()["state"] == "dead"
    with pytest.raises(EngineDeadError):
        eng.step()
    snap = eng.snapshot()
    assert snap["health"] == "dead"
    assert {r["uid"] for r in snap["requests"]} == {0}


def test_host_bug_propagates(models):
    """An exception the classifier does not recognise re-raises from
    step() and leaves the counters alone."""
    _, pm = models
    eng = port_engine(pm)
    eng.put(0, [1, 2, 3])

    def broken(st):
        raise RuntimeError("a bug in host code")
    eng._fetch_tokens = broken
    with pytest.raises(RuntimeError, match="bug in host code"):
        eng.step()
    assert eng.timings["step_retries"] == 0
    assert eng.health()["state"] == "healthy"


def test_status_retention_forgotten_vs_unknown(models):
    _, pm = models
    eng = port_engine(pm, overload=OverloadConfig(status_retention=2))
    for uid in (0, 1, 2):
        eng.put(uid, [1, 2, 3])
        eng.flush(uid)
    assert eng.query(0)["status"] == "forgotten"
    assert eng.query(1)["status"] == "finished"
    assert eng.query(777)["status"] == "unknown"
    eng.put(0, [4, 5])
    assert eng.query(0)["status"] == "queued"
