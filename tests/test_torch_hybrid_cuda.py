"""``InferenceEngine.refresh_params`` and the eigenvalue on the card.

Marked ``cuda``: without a CUDA device every test here skips (the served
graphs replay CUDA kernels, which have no interpret mode).  A captured
engine (bf16, and int8 ``weight_quant`` with the mixed-input GEMM) has
its weights refreshed in place: the next step and burst replays (no
capture) serve the new weights, bitwise the stream of a fresh engine
built on them; under int8 the K3 launches of the replays are counted.
The eigenvalue under ``attention_impl="flash"`` raises.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hybrid_cuda.py
"""

import importlib

import pytest
import torch

from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.models import Model, build_model
from deepspeed_tpu_torch.models.transformer import tree_map

pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
mg_mod = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")

ENGINE = dict(token_budget=64, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
# a 40-token prompt: two full blocks, cached after the first rollout
PROMPTS = {1: list(range(3, 43)), 2: [7, 7, 1], 3: list(range(100, 120))}
SP = SamplingParams(max_new_tokens=12)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs of CUDA kernels)")
    return build_model("llama-tiny", seed=5, device="cuda",
                       dtype=torch.bfloat16, vocab_size=512, num_layers=2,
                       d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024,
                       max_seq_len=512)


def _new_weights(model, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tree_map(lambda x: x + 0.05 * x.abs().mean() * torch.randn(
        x.shape, generator=gen, device="cuda", dtype=torch.float32).to(
            x.dtype), model.params)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, {"weight_quant": "int8",
                                       "mixed_gemm": "on"}],
                         ids=["bf16", "int8"])
def test_refresh_serves_new_weights_at_the_next_replay(model, over):
    cfg = InferenceConfig(**ENGINE, **over)
    served = Model.from_params(model.config, tree_map(
        lambda x: x.clone(), model.params))
    eng = InferenceEngine(served, cfg)
    prompts = {u: list(p) for u, p in PROMPTS.items()}
    eng.generate(dict(prompts), SP)            # captures every graph
    eng.generate({u + 10: p for u, p in prompts.items()}, SP)
    new = _new_weights(model, 1)
    eng.refresh_params(new)
    eng.reset_timings()
    mg = mg_mod.mixed_matmul_2d
    mg.launches = 0
    got = eng.generate({u + 20: p for u, p in prompts.items()}, SP)
    torch.cuda.synchronize()
    tm = eng.timings
    assert tm["compiles"] == 0 and tm["graph_replays"] == tm["steps"] \
        + tm["bursts"] > 0, tm
    assert tm["cached_tokens"] == 0          # no stale prefix reused
    if over:
        assert mg.launches == 7 * model.config.num_layers \
            * tm["graph_replays"]
    fresh = InferenceEngine(Model.from_params(model.config, new), cfg)
    want = fresh.generate({u + 20: p for u, p in prompts.items()}, SP)
    assert got == want
    old = InferenceEngine(Model.from_params(model.config, model.params),
                          cfg).generate({u + 20: p for u, p in
                                         prompts.items()}, SP)
    assert got != old                        # the new weights took


@pytest.mark.cuda
def test_flash_eigenvalue_raises(model):
    from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
    from deepspeed_tpu_torch.utils.prng import PRNGKey
    m = build_model("gpt2", seed=0, device="cuda", dtype=torch.bfloat16,
                    vocab_size=256, num_layers=1, d_model=128, num_heads=2,
                    max_seq_len=128, attention_impl="flash")
    ids = torch.randint(0, 256, (2, 128), device="cuda")
    with pytest.raises(TypeError, match="attention_impl='flash'"):
        Eigenvalue(max_iter=1).compute_eigenvalue(
            lambda p: m.loss_fn.hvp_loss(p, {"input_ids": ids}, PRNGKey(0)),
            m.params, PRNGKey(1))
