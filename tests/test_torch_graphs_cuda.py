"""The serving engine's CUDA graphs against eager launches, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the graphs
capture the CUDA kernels, which have no interpret mode).  The eager
reference is the same engine class with its graph path turned off
(``_cuda = False`` after construction: the padded step, launched eagerly
on the default stream); both run the same kernels on the same inputs, so
the tokens and the caches must be bitwise equal.  The failure guard's
tests run the replays inline on the engine's stream and the reads under
a watchdog deadline (on its worker thread), and capture a graph right
after a real expiry.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py
"""

import importlib
import threading

import pytest
import torch

from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference.failures import (DispatchTimeoutError,
                                                    FailureConfig)
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops.paged_attention import paged_attention_plain

pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
mg_mod = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")

ENGINE = dict(token_budget=64, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs of CUDA kernels)")
    # K2 takes head dim 64; K3 takes K and N in 512-wide blocks
    return build_model("llama-tiny", seed=5, device="cuda",
                       dtype=torch.bfloat16, vocab_size=512, num_layers=2,
                       d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024,
                       max_seq_len=512)


def _pair(model, **over):
    """(graph engine, eager engine) of the same config."""
    cfg = InferenceConfig(**dict(ENGINE, **over))
    graphed, eager = InferenceEngine(model, cfg), InferenceEngine(model, cfg)
    eager._cuda = False
    return graphed, eager


def _kv_equal(a, b):
    if isinstance(a.state.kv, tuple):
        return all(torch.equal(x, y) for x, y in zip(a.state.kv, b.state.kv))
    return torch.equal(a.state.kv, b.state.kv)


PROMPTS = {1: list(range(3, 40)), 2: [7, 7, 1], 3: list(range(100, 120))}


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_graph_replay_bitwise_equals_eager(model, sampled):
    """Prefill steps (token bucket 64) and decode steps (bucket 4) over
    contexts in two context buckets: every step a replay, the streams
    and the caches bitwise equal to the eager engine's; the paged
    attention launches are layers x (steps + captures)."""
    sp = SamplingParams(max_new_tokens=30, **(
        dict(temperature=0.8, top_k=20) if sampled else {}))
    pa = pa_mod.paged_attention
    g, e = _pair(model)
    pa.launches = 0
    out_g = g.generate({u: list(p) for u, p in PROMPTS.items()}, sp,
                       rng=torch.tensor([0, 11]) if sampled else None)
    torch.cuda.synchronize()
    tm = g.timings
    L = model.config.num_layers
    assert tm["graph_replays"] == tm["steps"] and tm["compiles"] >= 3
    assert pa.launches == L * (tm["steps"] + tm["compiles"])
    assert {k[1] for k in g._graphs} >= {4, 64}         # token buckets
    assert len({k[2] for k in g._graphs}) >= 2          # context buckets
    out_e = e.generate({u: list(p) for u, p in PROMPTS.items()}, sp,
                       rng=torch.tensor([0, 11]) if sampled else None)
    torch.cuda.synchronize()
    assert e.timings["graph_replays"] == 0
    assert out_g == out_e
    assert _kv_equal(g, e)


@pytest.mark.cuda
def test_replay_after_slots_change_matches_eager(model):
    """One decode key replayed over batches whose slots and positions
    differ (a request leaves, another joins): the plan is re-run inside
    every replay, so each step equals eager."""
    g, e = _pair(model)
    outs = {}
    for eng in (g, e):
        log = []
        eng.put(1, PROMPTS[1])
        eng.put(2, PROMPTS[2])
        for i in range(12):
            if i == 4:
                eng.flush(1)
                eng.put(3, PROMPTS[3])
            out = eng.step()
            log.append(out)
            for u, t in out.items():
                eng.put(u, [t])
        torch.cuda.synchronize()
        outs[eng is g] = log
    assert outs[True] == outs[False]
    decode_keys = [k for k in g._graphs if k[1] == 4]
    assert decode_keys and g.timings["graph_replays"] == 12


@pytest.mark.cuda
def test_eager_paged_attention_after_a_replay_replans(model):
    """After a replay on the engine's stream, the wrapper holds no plan
    for that stream, and an eager call there with new inputs matches
    the plain version."""
    g, _ = _pair(model)
    g.generate({1: PROMPTS[1]}, SamplingParams(max_new_tokens=3))
    stream = g._stream
    assert (g.device.index, stream.cuda_stream) not in pa_mod._planned
    cfg = model.config
    kv = g.state.kv[0]
    T = 5
    q = torch.randn(T, cfg.num_heads, cfg.head_dim, device="cuda",
                    dtype=torch.bfloat16)
    seq_slot = torch.zeros(T, dtype=torch.int32, device="cuda")
    positions = torch.arange(T, dtype=torch.int32, device="cuda")
    tables = torch.full((4, 8), -1, dtype=torch.int32, device="cuda")
    tables[0, 0] = 3
    args = (kv, q, seq_slot, positions, tables, 16, 8, 0.125)
    with torch.cuda.stream(stream):
        got = pa_mod.paged_attention(*args)
    stream.synchronize()
    want = paged_attention_plain(*args)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_mixed_gemm_designs_under_replay(model, bits):
    """Quantized weights through K3: the prefill design (bucket 64) and
    the decode design (bucket 4) replayed, bitwise equal to eager, with
    7 x layers launches a step counted through the replays."""
    over = dict(weight_quant=bits, mixed_gemm="on", kv_quant="int8")
    g, e = _pair(model, **over)
    fn = mg_mod.mixed_matmul_2d if bits == "int8" else mg_mod.mixed4_matmul_2d
    fn.launches = 0
    fn.design_launches = {"decode": 0, "prefill": 0}
    sp = SamplingParams(max_new_tokens=10)
    out_g = g.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    torch.cuda.synchronize()
    tm = g.timings
    L = model.config.num_layers
    assert fn.launches == 7 * L * (tm["steps"] + tm["compiles"])
    assert min(fn.design_launches.values()) > 0
    assert g.timings["graph_replays"] == tm["steps"]
    out_e = e.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    torch.cuda.synchronize()
    assert out_g == out_e
    assert _kv_equal(g, e)


@pytest.mark.cuda
def test_burst_graph_equals_eager_bursts(model):
    """``decode_burst=4``: each burst one graph replay, streams and caches
    bitwise equal to eager bursts; a burst launches no paged attention."""
    g, e = _pair(model, decode_burst=4)
    sp = SamplingParams(max_new_tokens=13)
    out_g = g.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    out_e = e.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    torch.cuda.synchronize()
    assert out_g == out_e
    assert g.timings["bursts"] >= 2 \
        and g.timings["bursts"] == e.timings["bursts"]
    assert any(k[0] == "b" for k in g._burst_graphs)
    assert _kv_equal(g, e)
    pa = pa_mod.paged_attention
    g.put(9, list(range(50, 70)))
    g.put(9, [g.step()[9]])
    pa.launches = 0
    assert len(g.decode_burst(4)[9]) == 4
    torch.cuda.synchronize()
    assert pa.launches == 0


@pytest.mark.cuda
def test_verify_step_under_a_graph(model):
    """Speculation on: verify steps (multi-token rows through K2's chunk
    design) replayed from graphs keyed by the verify width, streams
    bitwise equal to eager."""
    rep = [5, 6, 7, 8] * 6
    sp = SamplingParams(max_new_tokens=20)
    g, e = _pair(model, spec_decode="on", spec_max_draft=4)
    out_g = g.generate({0: list(rep), 1: [9, 2, 9, 2, 9, 2]}, sp)
    out_e = e.generate({0: list(rep), 1: [9, 2, 9, 2, 9, 2]}, sp)
    torch.cuda.synchronize()
    assert out_g == out_e
    assert _kv_equal(g, e)
    assert g.timings["spec_windows"] > 0
    assert g.timings["graph_replays"] == g.timings["steps"]
    assert all(k[-1] == 5 for k in g._graphs)


class _ReplayProbe:
    """Stands in for a captured graph: records the thread and the
    current stream of every replay, then replays."""

    def __init__(self, graph, seen):
        self.graph, self.seen = graph, seen

    def replay(self):
        self.seen.append((threading.current_thread().name,
                          torch.cuda.current_stream().cuda_stream))
        self.graph.replay()


@pytest.mark.cuda
def test_guard_replays_inline_and_reads_on_the_worker(model):
    """With a deadline, every replay runs inline on the caller's thread,
    on the engine's stream (never on a worker the watchdog could
    abandon), every read runs on the watchdog's worker, and the streams
    stay bitwise equal to eager."""
    fcfg = FailureConfig(dispatch_timeout_ms=5000.0)
    g, e = _pair(model, failure=fcfg)
    sp = SamplingParams(max_new_tokens=12)
    prompts = {u: list(p) for u, p in PROMPTS.items()}
    g.generate(prompts, sp)                       # every key captured
    g.state.reset_prefix_cache()
    seen, reads = [], []
    for gr in g._graphs.values():
        gr.graph = _ReplayProbe(gr.graph, seen)
    fetch = g._fetch_tokens

    def probe_fetch(st):
        reads.append(threading.current_thread().name)
        return fetch(st)
    g._fetch_tokens = probe_fetch
    out_g = g.generate(prompts, sp)
    out_e = e.generate(prompts, sp)
    torch.cuda.synchronize()
    assert out_g == out_e
    caller = threading.current_thread().name
    assert seen and all(name == caller and sid == g._stream.cuda_stream
                        for name, sid in seen)
    assert len(reads) == len(seen)
    assert all(name == "serving-watchdog" for name in reads)
    assert g.failures.watchdog.abandoned == 0


SLEEP_CYCLES = 4_000_000_000     # ~2 s at the H100's clock


@pytest.mark.cuda
def test_capture_after_an_expiry_with_an_abandoned_worker(model):
    """A real expiry: a sleep queued on the engine's stream holds a warm
    decode step's token event past the deadline, the worker is abandoned
    in the event wait, the cache is zeroed in place and every sequence
    re-queued; the next step carries a prompt of a token bucket never
    captured, so its capture runs while the abandoned worker may still
    wait.  The capture must hold, and the streams must equal an eager
    twin that takes the same (non-injected) expiry at the same step."""
    fcfg = FailureConfig(dispatch_timeout_ms=500.0)
    g, e = _pair(model, failure=fcfg)
    warm = {1: PROMPTS[2], 2: PROMPTS[3][:9]}
    later = {3: list(range(200, 260))}           # 60 tokens: bucket 64
    results = {}
    for eng in (g, e):
        sp = SamplingParams(max_new_tokens=1 << 30)
        fetch = eng._fetch_tokens
        done = {u: [] for u in list(warm) + list(later)}
        for u, p in warm.items():
            eng.put(u, list(p))
        kv_ptr = eng.state.kv.data_ptr()
        buckets_before = None
        for i in range(24):
            # step i + 1: step 7 is a decode step of a warm key (the
            # contexts stay within one block through step 8)
            if i == 6:
                if eng is g:
                    with torch.cuda.stream(g._stream):
                        torch.cuda._sleep(SLEEP_CYCLES)
                else:
                    def expire(st, fetch=fetch, eng=eng):
                        eng._fetch_tokens = fetch
                        raise DispatchTimeoutError("deadline")
                    eng._fetch_tokens = expire
            if i == 7:
                # the backoff round; the next step re-prefills every chain
                # with the new prompt: token bucket 64
                buckets_before = {k[1] for k in eng._graphs}
                for u, p in later.items():
                    eng.put(u, list(p))
            for u, t in eng.step(sampling=sp).items():
                done[u].append(t)
                eng.put(u, [t])
        torch.cuda.synchronize()
        assert eng.state.kv.data_ptr() == kv_ptr
        results[eng is g] = (done, dict(eng.timings), buckets_before)
    done_g, tm_g, before = results[True]
    done_e, tm_e, _ = results[False]
    assert g.failures.watchdog.abandoned == 1
    assert tm_g["step_retries"] == tm_e["step_retries"] == 1
    assert 64 not in before and 64 in {k[1] for k in g._graphs}
    assert done_g == done_e and len(done_g[3]) > 0


@pytest.mark.cuda
def test_moe_engine_graphs_equal_eager():
    """qwen2-moe-tiny (4 experts top-2 and the shared expert): prefill
    and decode steps and a decode burst replay graphs, and the streams and
    caches are bitwise the eager twin's.  The serving MoE reads nothing
    back to the host, so its steps capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs of CUDA kernels)")
    moe = build_model("qwen2-moe-tiny", seed=3, device="cuda",
                      dtype=torch.bfloat16, vocab_size=512, num_layers=2,
                      max_seq_len=512)
    sp = SamplingParams(max_new_tokens=12)
    for over in ({}, {"decode_burst": 4}):
        g, e = _pair(moe, **over)
        out_g = g.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
        out_e = e.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
        torch.cuda.synchronize()
        tm = g.timings
        assert tm["graph_replays"] == tm["steps"] + tm["bursts"] > 0
        assert tm["bursts"] > 0 or not over
        assert out_g == out_e
        assert _kv_equal(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("burst", [1, 4])
def test_telemetry_under_graphs_and_a_capture_window(model, tmp_path,
                                                     burst):
    """Every telemetry plane on, a 2-step capture window armed before
    the first step: the window waits for a step or a decode burst that
    replays (one that captures a graph never runs inside a profiler
    session), the streams equal the eager engine's, each graph key is
    reckoned once, and the merged capture lists paged attention on its
    device track (single steps) or the burst's span and kernels
    (``decode_burst=4``: the window opens at the second burst, and the
    cold single steps of the tail close it)."""
    import json

    from tools.tracemerge import merge_capture, validate_merged_trace
    tel = dict(trace=True, anomaly="on", slo="on", device_telemetry="on",
               decode_burst=burst,
               failure=FailureConfig(flight_dir=str(tmp_path / "flight")))
    g, e = _pair(model, **tel)
    inside = []
    capture = g._capture

    def watched(run):
        inside.append(g._cap is not None and g._cap.active)
        return capture(run)
    g._capture = watched
    cdir = g.capture(2, out_dir=str(tmp_path / "cap"))
    sp = SamplingParams(max_new_tokens=12)
    out_g = g.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    torch.cuda.synchronize()
    out_e = e.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    assert out_g == out_e
    assert inside and not any(inside)
    assert g.capture_dirs == [cdir]
    meta = json.load(open(f"{cdir}/meta.json"))
    assert meta["profiler"] and meta["step_start"] >= 1
    merged = json.load(open(merge_capture(cdir)))
    assert validate_merged_trace(merged) == []
    kernels = {ev["name"] for ev in merged["traceEvents"]
               if ev.get("pid", 0) >= 10_000 and ev.get("cat") == "kernel"}
    if burst == 1:
        assert any("paged_attention_kernel" in k for k in kernels)
    else:
        assert g.timings["bursts"] >= 2 and kernels
        assert any(ev.get("name") == "burst" for ev in merged["traceEvents"])
    snap = g.device_snapshot()
    assert set(snap["programs"]) == {repr(k) for k in [*g._graphs,
                                                       *g._burst_graphs]}
    assert snap["memory"] and snap["model_flops_total"] > 0
    assert g.metrics.get("serving_hbm_bytes_in_use") is not None
    assert g.slo_scorecard()["enabled"] and g.health()["captures"] == 1


@pytest.mark.cuda
def test_a_cold_burst_closes_an_active_capture_window(model, tmp_path):
    """A window opened at a warm step and still counting when a decode
    burst must capture its graph closes before that capture (the burst
    graph is never captured inside a profiler session), after the two
    steps it covered; the burst then captures and serves."""
    import json
    g = InferenceEngine(model, InferenceConfig(**ENGINE, trace=True))
    inside = []
    capture = g._capture

    def watched(run):
        inside.append(g._cap is not None and g._cap.active)
        return capture(run)
    g._capture = watched
    r = torch.Generator().manual_seed(3)

    def prompt():
        return [int(t) for t in torch.randint(1, 500, (20,), generator=r)]
    for uid in (9, 10):
        # uid 9 warms the prefill, decode and burst keys; uid 10 finds
        # the first two warm and the burst key cold again
        if uid == 10:
            g._burst_graphs.clear()
            cdir = g.capture(3, out_dir=str(tmp_path / "cap"))
        g.put(uid, prompt())
        g.put(uid, [g.step()[uid]])
        if uid == 10:
            assert g._cap.active
        g.put(uid, [g.step()[uid]])
        assert len(g.decode_burst(4)[uid]) == 4
    torch.cuda.synchronize()
    assert inside and not any(inside)
    assert g.capture_dirs == [cdir] and not g._cap.active
    meta = json.load(open(f"{cdir}/meta.json"))
    assert meta["profiler"] and meta["steps"] == 3
    assert meta["step_end"] == meta["step_start"] + 2
