"""The serving step's fixed shapes and its graph cache, on the CPU.

The engine pads every step's tokens up to a power-of-two token bucket so
that the step's shapes repeat; on the card each (token bucket, context
bucket, sampler) key is a CUDA graph, captured once and replayed (the
card's side: tests/test_torch_graphs_cuda.py).  Here: the bucket choice;
a padded step equal to the unpadded one (same tokens, same KV at every
valid row, the padding written only to the trash row); the graph cache's
LRU bound and its retrace counter (with the capture stubbed); and the
replay's launch accounting against fake kernel counters."""

import logging

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           KVCacheConfig, SamplingParams,
                                           StateManager)
from deepspeed_tpu_torch.inference import engine as engine_mod
from deepspeed_tpu_torch.inference.model import pipelined_ragged_step
from deepspeed_tpu_torch.inference.sampler import sample_rows
from deepspeed_tpu_torch.models import build_model
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model():
    return build_model("llama-tiny", seed=3, device="cpu", vocab_size=128,
                       num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, max_seq_len=128)


def _engine(model, **over):
    kw = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=16, kv_dtype=torch.float32,
              param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(model, InferenceConfig(**kw))


@pytest.mark.parametrize("over, cases", [
    ({}, [(1, 4), (4, 4), (5, 8), (9, 16), (17, 32), (32, 32)]),
    ({"token_budget": 24}, [(3, 4), (16, 16), (17, 24), (24, 24)]),
    ({"token_budget": 8, "max_seqs": 16}, [(1, 8), (8, 8)]),
    ({"spec_decode": "on", "spec_max_draft": 2},
     [(1, 12), (12, 12), (13, 24), (25, 32)]),
], ids=["pow2", "budget-24", "budget-below-seqs", "verify-width"])
def test_token_bucket(model, over, cases):
    eng = _engine(model, **over)
    for n, want in cases:
        assert eng.token_bucket(n) == want, n


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_padded_step_equals_unpadded(model, sampled):
    """A prefill of two prompts and a decode step, run at their exact
    token counts and padded to 16 and 32 tokens: the same sampled tokens
    and the same cache at every row but the trash row, which only the
    padded steps write."""
    cfg = model.config
    sp = (SamplingParams(temperature=0.9, top_k=10) if sampled
          else SamplingParams())
    rng = torch.tensor([0, 42], dtype=torch.int64) if sampled else None
    sample = lambda logits, keys: sample_rows(logits, sp, keys)  # noqa: E731
    kvs, toks = {}, {}
    for pad in (None, 16, 32):
        sm = StateManager(KVCacheConfig(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, block_size=16,
            num_blocks=8, dtype=torch.float32, device="cpu"), max_seqs=4)
        out = []
        prev = torch.zeros(4, dtype=torch.int32)
        for sched in ([(1, list(range(3, 12))), (2, [7, 7, 1])],
                      [(1, [5]), (2, [9])]):
            b = sm.build_batch(sched, 32)
            if pad is not None:
                b = b._replace(n_tokens=pad)
            prev, _ = pipelined_ragged_step(cfg, model.params, None, sm.kv,
                                            b, prev, rng, sample, 16, 4)
            out.append(prev[[sm.slot(1), sm.slot(2)]].tolist())
        toks[pad], kvs[pad] = out, sm.kv.clone()
    trash = kvs[None].shape[1] - 1
    for pad in (16, 32):
        assert toks[pad] == toks[None]
        assert torch.equal(kvs[pad][:, :trash], kvs[None][:, :trash])
        assert kvs[pad][:, trash].abs().sum() > 0
    assert kvs[None][:, trash].abs().sum() == 0


class _Stub:
    """Stands in for a captured graph."""


def test_graph_cache_lru_and_retraces(model, monkeypatch, caplog):
    """17 keys through a cache bounded at 16: the least recently used is
    evicted (a hit re-inserts), and capturing an evicted key again counts
    a retrace and warns."""
    eng = _engine(model)
    captured = []
    monkeypatch.setattr(eng, "_capture",
                        lambda run: captured.append(run()) or _Stub())
    cache = eng._graphs
    for k in range(16):
        eng._graph_for(cache, 16, ("p", k), lambda k=k: k)
    assert eng._graph_for(cache, 16, ("p", 0), lambda: -1) is cache[("p", 0)]
    eng._graph_for(cache, 16, ("p", 16), lambda: 16)     # evicts key 1
    assert len(cache) == 16 and ("p", 1) not in cache and ("p", 0) in cache
    assert list(cache)[-2:] == [("p", 0), ("p", 16)]
    tm = eng.timings
    assert tm["compiles"] == 17 and tm["compile_retraces"] == 0
    assert captured == list(range(17))
    logger = engine_mod.logger
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger=logger.name):
        eng._graph_for(cache, 16, ("p", 1), lambda: 1)
    assert tm["compiles"] == 18 and tm["compile_retraces"] == 1
    assert "CAPTURED AGAIN" in caplog.text
    assert tm["compile_ms"] >= 0
    eng.reset_timings()
    assert eng.timings["compile_retraces"] == 0 and len(cache) == 16


def test_replay_launch_accounting():
    """The capture's counter moves are taken back and become the graph's
    delta; each replay adds exactly that delta (ints and dicts alike),
    and counters the capture did not move stay out of it."""
    def k2():
        pass

    def k3():
        pass

    k2.launches, k2.int8_launches, k2.flag = 5, 0, True
    k3.launches, k3.design_launches = 2, {"decode": 2, "prefill": 0}
    fns = (k2, k3)
    before = engine_mod.launch_counts(fns)
    assert (k2, "flag") not in before
    # what a capture of a decode step of 3 layers would count
    k2.launches += 3
    k3.launches += 21
    k3.design_launches["decode"] += 21
    delta = engine_mod.launch_delta(before, engine_mod.launch_counts(fns))
    assert delta == {(k2, "launches"): 3, (k3, "launches"): 21,
                     (k3, "design_launches"): {"decode": 21}}
    engine_mod.add_launches(delta, -1)
    assert engine_mod.launch_counts(fns) == before
    # counts zeroed before a measured run (dicts replaced), then 4 replays
    k2.launches = k3.launches = 0
    k3.design_launches = {"decode": 0, "prefill": 0}
    for _ in range(4):
        engine_mod.add_launches(delta)
    assert k2.launches == 12 and k2.int8_launches == 0
    assert k3.launches == 84
    assert k3.design_launches == {"decode": 84, "prefill": 0}


def test_cpu_engine_captures_nothing(model):
    """The CPU runs the same padded step eagerly: no graph, no replay."""
    eng = _engine(model)
    out = eng.generate({1: [3, 4, 5], 2: list(range(20))},
                       SamplingParams(max_new_tokens=5))
    assert all(len(t) == 5 for t in out.values())
    tm = eng.timings
    assert tm["compiles"] == tm["graph_replays"] == 0 and not eng._graphs
    assert tm["decode_steps"] >= 3
    assert tm["steps"] > tm["decode_steps"]
