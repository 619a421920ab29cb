"""The port's serving engine (``deepspeed_tpu_torch.inference.engine``)
held against the JAX package's: greedy ``generate`` on the same weights
must match the JAX engine TOKEN FOR TOKEN, with the fp32 engines of
tests/test_inference.py, across prefix cache on/off x pipeline depth
1/2, prompts longer than the token budget (chunked prefill), a prompt
sharing another's leading blocks (a prefix-cache hit), a stop token and
the context limit.  Unsupported configuration values raise; a sampled
request runs (its seeded streams: tests/test_torch_sampler.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)


def _prompts():
    r = np.random.RandomState(0)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    long = tok(40)                                 # > budget: chunked
    return {1: tok(12), 2: long, 3: tok(5), 4: long[:32] + tok(6)}


@pytest.fixture(scope="module")
def models():
    jm = jax_inference.tiny_model()
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _jax_generate(jm, prompts, sp, **over):
    eng = jax_inference.make_fp32_engine(jm, attn_impl="xla",
                                         pipeline_depth=1, **over)
    return eng.generate(prompts, JaxSampling(
        max_new_tokens=sp.max_new_tokens, stop_token=sp.stop_token))


def _port_engine(port, **over):
    kw = dict(ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(port, InferenceConfig(**kw))


@pytest.fixture(scope="module")
def reference(models):
    jm, _ = models
    return _jax_generate(jm, _prompts(), SamplingParams(max_new_tokens=10),
                         prefix_cache="off")


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("prefix_cache", ["on", "off"])
def test_generate_token_identical_to_jax(models, reference, prefix_cache,
                                         depth):
    _, port = models
    eng = _port_engine(port, prefix_cache=prefix_cache, pipeline_depth=depth)
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=10))
    assert out == reference
    assert eng.timings["prompt_tokens"] == sum(map(len,
                                                   _prompts().values()))
    if prefix_cache == "on":
        # prompt 4 shares prompt 2's first 32 tokens (two full blocks)
        assert eng.timings["prefix_hits"] >= 1
        assert eng.timings["cached_tokens"] >= 16
    else:
        assert eng.timings["prefix_hits"] == 0
    for uid in out:
        assert eng.query(uid)["status"] == "finished"
    assert eng.query(99)["status"] == "unknown"
    al = eng.state.allocator
    al.assert_invariants()
    assert al.referenced_blocks == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_stop_token_matches_jax(models, reference, depth):
    jm, port = models
    stop = reference[1][3]          # prompt 1's 4th generated token
    sp = SamplingParams(max_new_tokens=10, stop_token=stop)
    ref = _jax_generate(jm, _prompts(), sp, prefix_cache="off")
    assert ref[1][-1] == stop and len(ref[1]) <= 4
    out = _port_engine(port, pipeline_depth=depth).generate(_prompts(), sp)
    assert out == ref


@pytest.mark.parametrize("depth", [1, 2])
def test_context_limit_matches_jax(models, depth):
    jm, port = models
    prompts = {1: list(range(1, 21)), 2: list(range(3, 10))}
    sp = SamplingParams(max_new_tokens=30)
    ref = _jax_generate(jm, prompts, sp, max_seq_len=32)
    eng = _port_engine(port, max_seq_len=32, pipeline_depth=depth)
    out = eng.generate(prompts, sp)
    assert out == ref
    assert len(out[1]) < 30             # stopped by the context, not count


def test_step_api_matches_generate(models, reference):
    """The direct put/step loop emits the same stream as generate()."""
    _, port = models
    eng = _port_engine(port)
    prompt = _prompts()[1]
    eng.put(1, prompt)
    toks = []
    while len(toks) < 10:
        out = eng.step()
        if 1 in out:
            toks.append(out[1])
            eng.put(1, [out[1]])
    assert toks == reference[1]
    assert eng.query(1)["status"] == "running"
    eng.cancel(1)
    assert eng.query(1)["status"] == "cancelled"


@pytest.mark.parametrize("field, value", [
    ("attn_impl", "pallas"), ("comm_quant", "int8"), ("kv_donate", "off")])
def test_unsupported_config_values_raise(models, field, value):
    _, port = models
    with pytest.raises(NotImplementedError, match=field):
        _port_engine(port, **{field: value})


@pytest.mark.parametrize("wq", ["fp6", "fp12"])
def test_minifloat_weight_quant_serves_as_jax(models, wq):
    """``weight_quant="fp6"|"fp12"`` (once gated as unported) serves: the
    block weights in the packed minifloat layout, dequantized a layer at
    a time (no mixed-input GEMM), the JAX engine's greedy streams."""
    jm, port = models
    eng = _port_engine(port, weight_quant=wq)
    assert not eng._mixed_gemm_active
    layout = {"fp6": "rowwise6", "fp12": "rowwise12"}[wq]
    assert {qt.layout for g in eng._quant["blocks"].values()
            for qt in g.values()} == {layout}
    sp = SamplingParams(max_new_tokens=10)
    assert eng.generate(_prompts(), sp) == _jax_generate(
        jm, _prompts(), sp, weight_quant=wq)


@pytest.mark.parametrize("field", [
    "profile", "trace", "device_telemetry", "anomaly", "slo", "anomaly_cfg",
    "slo_objectives"])
def test_ported_telemetry_config_values_are_honoured(models, tmp_path,
                                                     field):
    """The serving telemetry fields (ROADMAP Queue 1 item 5) are
    accepted and act: each turns its plane on, and a short ``generate``
    feeds it."""
    from deepspeed_tpu_torch.telemetry import AnomalyConfig, SloObjective
    _, port = models
    over = {
        "profile": dict(profile=str(tmp_path / "cap"), profile_steps=2),
        "trace": dict(trace=True),
        "device_telemetry": dict(device_telemetry="on"),
        "anomaly": dict(anomaly="on"),
        "slo": dict(slo="on"),
        "anomaly_cfg": dict(anomaly="on",
                            anomaly_cfg=AnomalyConfig(max_captures=5)),
        "slo_objectives": dict(slo="on", slo_objectives={
            "standard": SloObjective(ttft_ms=1e9)}),
    }[field]
    eng = _port_engine(port, **over)
    eng.generate({1: [3, 4, 5, 6, 7]}, SamplingParams(max_new_tokens=4))
    if field == "profile":
        (cdir,) = eng.capture_dirs
        assert cdir.startswith(str(tmp_path / "cap"))
    elif field == "trace":
        names = {e["name"] for e in eng.tracer.chrome_trace()["traceEvents"]}
        assert {"schedule", "dispatch", "wait", "readback"} <= names
    elif field == "device_telemetry":
        assert eng.device_snapshot()["programs"]
    elif field in ("anomaly", "anomaly_cfg"):
        assert eng.anomaly_summary() is not None
        assert eng._acfg.max_captures == over.get(
            "anomaly_cfg", AnomalyConfig()).max_captures
    else:
        card = eng.slo_scorecard()
        assert card["enabled"] and sum(
            c["error_budget"]["evaluated"]
            for c in card["classes"].values()) == 1
        if field == "slo_objectives":
            assert list(card["classes"]) == ["standard"]


def test_bad_values_and_seeded_sampling_raise(models):
    _, port = models
    with pytest.raises(ValueError, match="prefix_cache"):
        _port_engine(port, prefix_cache="sometimes")
    for field, value in (("kv_quant", "int4"), ("weight_quant", "int2"),
                         ("mixed_gemm", "sometimes")):
        with pytest.raises(ValueError, match=field):
            _port_engine(port, **{field: value})
    # 'on' with nothing quantized: no layout the kernel family consumes
    with pytest.raises(ValueError, match="mixed_gemm"):
        _port_engine(port, mixed_gemm="on")
    # seeded sampling is ported: a sampled request runs; the sampler
    # itself raises without keys (the engine always supplies them)
    from deepspeed_tpu_torch.inference.sampler import sample_rows
    sp = SamplingParams(temperature=0.8, top_k=20, max_new_tokens=4)
    with pytest.raises(ValueError, match="keys"):
        sample_rows(torch.zeros(2, 128), sp)
    out = _port_engine(port).generate({7: _prompts()[1]}, sp)
    assert len(out[7]) == 4 and all(0 <= t < 128 for t in out[7])


# --- the scheduler and overload policy, in lockstep with the JAX engine ---

def _sched_engines(jm, port, overload_kw, prefix_cache):
    """A JAX and a port engine with the same pools and overload policy
    (aging off: the two engines' clocks differ).  No step is dispatched:
    the scheduler and the state run on the host."""
    from deepspeed_tpu.inference import InferenceConfig as JaxConfig
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine
    from deepspeed_tpu.inference.overload import \
        OverloadConfig as JaxOverload
    from deepspeed_tpu_torch.inference import OverloadConfig
    kw = dict(token_budget=16, max_seqs=3, kv_block_size=8,
              num_kv_blocks=8, max_seq_len=48, prefix_cache=prefix_cache)
    ov = dict(aging_ms=None, **overload_kw)
    jeng = JaxEngine(jm, JaxConfig(overload=JaxOverload(**ov),
                                   attn_impl="xla", **kw))
    peng = InferenceEngine(port, InferenceConfig(
        overload=OverloadConfig(**ov), kv_dtype=torch.float32,
        param_dtype=torch.float32, **kw))
    return jeng, peng


def _round(eng):
    sched = eng._schedule()
    eng._close_ctx_exhausted()
    if sched:
        eng.state.build_batch(sched, eng.icfg.token_budget,
                              stager=eng._stager)
    return sched


@pytest.mark.parametrize("overload_kw", [
    {}, {"max_queued_requests": 2}, {"max_queued_tokens": 40},
    {"max_queued_requests": 2, "shed_policy": "evict-lowest"},
    {"max_queued_requests": 2, "shed_policy": "degrade"},
    {"prefill_chunk": 4}, {"preemption": False}],
    ids=["default", "reject", "token-bound", "evict-lowest", "degrade",
         "chunk", "no-preemption"])
@pytest.mark.parametrize("prefix_cache", ["on", "off"])
def test_scheduler_and_overload_match_jax(models, overload_kw,
                                          prefix_cache):
    """Seeded puts (with priorities), continuations, flushes, cancels and
    scheduling rounds drive both engines: verdicts, schedules, batches,
    query() answers and the pool state must be identical after every
    op — prefix-cache admission, chunking, shedding and preemption
    included."""
    jm, port = models
    jeng, peng = _sched_engines(jm, port, overload_kw, prefix_cache)
    r = np.random.RandomState(len(overload_kw) * 7 + len(prefix_cache))
    shared = [int(t) for t in r.randint(1, 128, 16)]
    next_uid, seen = 0, set()
    for _ in range(160):
        op = r.randint(6)
        live = sorted(peng.state.seqs)
        if op == 0:
            toks = (shared if r.rand() < 0.4 else []) + \
                [int(t) for t in r.randint(1, 128, r.randint(1, 30))]
            pri = int(r.randint(0, 3))
            jv = jeng.put(next_uid, toks, priority=pri)
            pv = peng.put(next_uid, toks, priority=pri)
            assert (jv.admitted, jv.status, jv.evicted_uids) == \
                (pv.admitted, pv.status, pv.evicted_uids)
            seen.add(next_uid)
            next_uid += 1
        elif op == 1 and live:
            uid = live[r.randint(len(live))]
            if not peng._pending.get(uid):
                tok = [int(r.randint(1, 128))]
                jeng.put(uid, tok)
                peng.put(uid, tok)
        elif op == 2 and live:
            uid = live[r.randint(len(live))]
            (jeng.cancel if r.rand() < 0.3 else jeng.flush)(uid)
            (peng.cancel if uid in jeng._reaped else peng.flush)(uid)
        else:
            assert _round(jeng) == _round(peng)
        assert jeng._drain_reaped() == peng._drain_reaped()
        for uid in seen:
            assert jeng.query(uid) == peng.query(uid), uid
        js_, ps_ = jeng.state, peng.state
        assert js_.seqs.keys() == ps_.seqs.keys()
        for uid in js_.seqs:
            assert js_.seqs[uid].blocks == ps_.seqs[uid].blocks
        assert js_.allocator._refs == ps_.allocator._refs
        ps_.allocator.assert_invariants()
    for k in ("prompt_tokens", "cached_tokens", "prefix_hits"):
        assert jeng.timings[k] == peng.timings[k], k


def test_preemption_and_requeue_match_jax(models):
    """A starved higher tier preempts a lower-tier running sequence; the
    victim re-queues its whole host-known stream (as in
    tests/test_overload.py TestPreemption)."""
    jm, port = models
    jeng, peng = _sched_engines(jm, port, {}, "on")
    for eng in (jeng, peng):
        eng.state.allocator = type(eng.state.allocator)(
            4, on_evict=eng.state._on_evict)
        eng.put(0, list(range(1, 33)), priority=5)
        while eng._pending.get(0):
            _round(eng)
        eng.state.seqs[0].tokens.extend([7, 8])        # as _collect would
        eng.put(1, list(range(40, 64)), priority=0)
    assert _round(jeng) == _round(peng)
    for eng in (jeng, peng):
        assert 0 not in eng.state.seqs
        assert eng._pending[0] == list(range(1, 33))
        assert eng.query(0)["status"] == "queued"
        assert eng.query(0)["generated"] == [7, 8]
    assert jeng.query(1) == peng.query(1)


def test_deadlines_and_closeout(models):
    """Deadline expiry (queued and running), cancel and context
    exhaustion close requests with their terminal status and release
    their KV (tests/test_overload.py TestTerminalCloseout)."""
    import time
    _, port = models
    eng = _port_engine(port, token_budget=16, max_seqs=3, kv_block_size=8,
                       num_kv_blocks=8, max_seq_len=32)
    eng.put(0, [1] * 4, deadline_ms=0.01)
    eng.put(1, [1] * 4, deadline_ms=60_000.0)
    time.sleep(0.002)
    assert [u for u, _ in _round(eng)] == [1]
    assert eng.query(0)["status"] == "deadline_exceeded"
    eng._meta[1].deadline_ms = 0.0          # expire it while running
    _round(eng)
    assert eng.query(1)["status"] == "deadline_exceeded"
    assert eng._drain_reaped() == {0, 1}
    eng.put(2, [1] * 30)
    while eng._pending.get(2):
        _round(eng)
    eng.put(2, [1, 2, 3])                   # beyond the 32-token context
    for _ in range(4):
        _round(eng)
    assert eng.query(2)["status"] == "context_exhausted"
    eng.put(3, [1] * 4)
    _round(eng)
    eng.state.release(3)
    assert eng.query(3)["status"] == "released"
    eng.cancel(42)                          # unknown uid: no-op
    al = eng.state.allocator
    al.assert_invariants()
    assert al.referenced_blocks == 0
