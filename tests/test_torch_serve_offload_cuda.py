"""Serving offload on the card: the KV cache in host memory under the CUDA
graphs, the block weights streamed from an NVMe store, and the KV block
tier, each against the resident engine on the card.

Marked ``cuda``: without a CUDA device every test here skips (the paths
under test are page-locked copies inside CUDA graphs, copy streams and
events around CUDA kernels).  Both engines run the same kernels on the
same inputs, so the streams (and the caches, where both hold one) must
be bitwise equal.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_offload_cuda.py
"""

import importlib

import pytest
import torch

from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.models import build_model

pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
mg_mod = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")

ENGINE = dict(token_budget=64, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
# prompt 1 fills the first step's budget, so prompt 2, sharing its first
# two blocks, hits the prefix cache a step later; prompt 1's first four
# blocks again are a full-cover hit served through a copy-on-write block
PROMPTS = {1: list(range(3, 73)), 2: list(range(3, 35)) + [9, 9, 1],
           3: list(range(100, 120))}
SP = SamplingParams(max_new_tokens=24)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (page-locked copies in CUDA graphs)")
    # K2 takes head dim 64; K3 takes K and N in 512-wide blocks
    return build_model("llama-tiny", seed=5, device="cuda",
                       dtype=torch.bfloat16, vocab_size=512, num_layers=2,
                       d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024,
                       max_seq_len=512)


def _serve(eng):
    """The traffic, then a full-cover repeat (a COW copy)."""
    out = eng.generate({u: list(p) for u, p in PROMPTS.items()}, SP)
    out[4] = eng.generate({4: PROMPTS[1][:64]}, SP)[4]
    torch.cuda.synchronize()
    return out


def _kv(eng):
    kv = eng.state.kv
    return tuple(t.cuda() for t in (kv if isinstance(kv, tuple) else (kv,)))


@pytest.mark.cuda
@pytest.mark.parametrize("depth,kv_quant", [(1, None), (2, None),
                                            (2, "int8")])
def test_kv_offload_replays_equal_resident(model, depth, kv_quant):
    """The cache in page-locked host memory, each layer copied through the
    working layer inside the step's graph: every step a replay, K2
    launched layers x (steps + captures), the streams and the caches
    bitwise the resident engine's, with prefix hits and a COW repeat at
    pipeline depth 1 and 2."""
    cfg = dict(ENGINE, pipeline_depth=depth, kv_quant=kv_quant)
    res = InferenceEngine(model, InferenceConfig(**cfg))
    off = InferenceEngine(model, InferenceConfig(kv_offload=True, **cfg))
    assert all(t.device.type == "cpu" and t.is_pinned()
               for t in (off.state.kv if kv_quant else (off.state.kv,)))
    work = off._kv_work if kv_quant else (off._kv_work,)
    ptrs = [t.data_ptr() for t in work]
    pa = pa_mod.paged_attention
    attr = "int8_launches" if kv_quant else "launches"
    setattr(pa, attr, 0)
    got = _serve(off)
    tm = off.timings
    L = model.config.num_layers
    assert tm["graph_replays"] == tm["steps"] and tm["eager_steps"] == 0
    assert getattr(pa, attr) == L * (tm["steps"] + tm["compiles"])
    assert tm["prefix_hits"] >= 2          # prompt 2 and the repeat
    assert [t.data_ptr() for t in work] == ptrs
    assert got == _serve(res)
    assert all(torch.equal(a, b) for a, b in zip(_kv(off), _kv(res)))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_weight_stream_eager_steps_equal_resident(model, quant, tmp_path):
    """Block weights from the NVMe store (bf16, or int8 with the
    mixed-input GEMM): every step eager on the engine's stream through the
    two page-locked slots; the streams bitwise the resident engine's."""
    over = (dict(weight_quant="int8", mixed_gemm="on") if quant == "int8"
            else {})
    res = InferenceEngine(model, InferenceConfig(**ENGINE, **over))
    eng = InferenceEngine(model, InferenceConfig(
        **ENGINE, weight_stream=str(tmp_path / "w"), **over))
    assert "blocks" not in eng.params
    k3 = mg_mod.mixed_matmul_2d
    k3.launches = 0
    got = _serve(eng)
    tm = eng.timings
    L = model.config.num_layers
    assert eng._wstore.pinned()
    assert tm["eager_steps"] == tm["steps"] and tm["graph_replays"] == 0
    assert k3.launches == (7 * L * tm["steps"] if quant == "int8" else 0)
    assert eng._mixed_gemm_active == (quant == "int8")
    assert eng._wstore.bytes_read == tm["steps"] * L * \
        eng._wstore.layer_bytes
    assert got == _serve(res)


@pytest.mark.cuda
@pytest.mark.parametrize("offload", [False, True], ids=["device", "host"])
def test_kv_tier_demotes_and_restages_on_the_card(model, offload,
                                                  tmp_path):
    """A pool of 8 blocks: prompt 1's chain is evicted and demoted (the
    ring holds two blocks, the rest spills to files), then revived from
    RAM and NVMe when prompt 1 returns; the streams equal a 64-block
    engine's (no eviction), and every step replays a graph."""
    fam = list(range(5, 53))                     # 3 full blocks
    fill = [list(range(200 + 40 * i, 240 + 40 * i)) for i in range(3)]

    def run(eng):
        out = {0: eng.generate({0: fam + [1, 2]}, SP)[0]}
        for i, f in enumerate(fill):
            out[1 + i] = eng.generate({1 + i: f}, SP)[1 + i]
        out[9] = eng.generate({9: fam + [3, 4]}, SP)[9]
        torch.cuda.synchronize()
        return out

    want = run(InferenceEngine(model, InferenceConfig(**ENGINE)))
    block = 2 * 2 * 16 * 2 * 64 * 2           # L x 2 x bs x Hkv x D x bf16
    eng = InferenceEngine(model, InferenceConfig(
        **dict(ENGINE, num_kv_blocks=8), kv_offload=offload, kv_tier="on",
        kv_tier_ram_mb=2.5 * block / 2 ** 20,
        kv_tier_dir=str(tmp_path / "tier")))
    got = run(eng)
    tm = eng.timings
    assert got == want
    assert tm["kv_tier_demotions"] >= 3 and tm["kv_tier_spills"] >= 1
    assert tm["kv_tier_revives_ram"] >= 1 and tm["kv_tier_revives_nvme"] >= 1
    assert tm["kv_tier_verify_failures"] == 0
    assert tm["graph_replays"] == tm["steps"]
