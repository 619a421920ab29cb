"""The serving engine's CUDA graphs against eager launches, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the graphs
capture the CUDA kernels, which have no interpret mode).  The eager
reference is the same engine class with its graph path turned off
(``_cuda = False`` after construction: the padded step, launched eagerly
on the default stream); both run the same kernels on the same inputs, so
the tokens and the caches must be bitwise equal.  This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py
"""

import importlib

import pytest
import torch

from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
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
