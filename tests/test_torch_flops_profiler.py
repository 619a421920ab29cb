"""The port's flops profiler (``deepspeed_tpu_torch.profiling``): the
string helpers equal to the JAX package's, ``analyze_fn`` /
``get_model_profile`` on a matrix product (2 x M x N x K exactly; the JAX
package reads XLA's cost analysis, at least that), and the engine's
``flops_profiler`` hook on a tiny GPT-2 with flash attention, with
random-LTD and PLD on: its flops a step equal the sum of 2 x M x N x K
over the step's products reckoned from the shapes (the flash kernels'
causal products counted as ``chip_smoke.flash_bound`` counts them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu import profiling as jp
from deepspeed_tpu_torch import profiling as tp
from deepspeed_tpu_torch.models.transformer import layer_keys, pld_drops
from deepspeed_tpu_torch.utils.prng import PRNGKey
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)
from tests.test_torch_train import tiny_models


@pytest.mark.parametrize("num", [0.0, 3.0, 999.0, 1e3, 2.5e6, 7e9, 2.5e12,
                                 -4.2e7])
def test_strings_equal(num):
    for name in ("flops_to_string", "params_to_string", "macs_to_string",
                 "number_to_string"):
        assert getattr(tp, name)(num) == getattr(jp, name)(num)
    assert tp.number_to_string(num, "M", 3) == jp.number_to_string(
        num, "M", 3)
    for s in (2.0, 0.02, 2e-5):
        assert tp.duration_to_string(s) == jp.duration_to_string(s)
    rep = {"flops": 1e9, "latency_s": 0.1, "params": 1e6,
           "tflops_per_s": 0.01}
    assert tp.FlopsProfiler.report(rep, batch_size=8) == \
        jp.FlopsProfiler.report(rep, batch_size=8)


def test_matmul_flops_and_model_profile():
    a, b = np.ones((128, 256), np.float32), np.ones((256, 64), np.float32)
    stats = tp.FlopsProfiler().profile(lambda x, y: x @ y,
                                       torch.from_numpy(a),
                                       torch.from_numpy(b))
    assert stats["flops"] == 2 * 128 * 256 * 64
    assert stats["latency_s"] > 0
    jstats = jp.FlopsProfiler().profile(lambda x, y: x @ y, jnp.asarray(a),
                                        jnp.asarray(b))
    assert jstats["flops"] >= 0.9 * stats["flops"]
    got = tp.get_model_profile(lambda x: (x @ torch.ones(64, 64)).sum(),
                               args=(torch.ones(8, 64),),
                               print_profile=False)
    want = jp.get_model_profile(lambda x: (x @ jnp.ones((64, 64))).sum(),
                                args=(jnp.ones((8, 64)),),
                                print_profile=False)
    # XLA's cost analysis also counts the sum's 512 adds
    assert got == ("65.54 KFLOPs", "32.77 KMACs", "0.00")
    assert want == ("66.05 KFLOPs", "33.02 KMACs", "0.00")


def reckon_step_flops(cfg, B, S, keep, kept_layers):
    """2 x M x N x K summed over one training step's products of a dense
    GPT-style model: per kept layer the projections (forward, and the
    backward's input and weight gradients) on ``keep`` tokens a row and
    flash attention's causal products (fwd 2, dq 3, dk/dv 4) at length
    ``keep``; the tied head on all S tokens (forward and both
    gradients)."""
    dm, dff, H, D, V = (cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim,
                        cfg.vocab_size)
    t = B * keep
    proj = 2 * t * dm * (3 * dm + dm + 2 * dff)
    flash = 2 * B * H * (keep * keep // 2) * D * (2 + 3 + 4)
    head = 2 * B * S * dm * V
    return kept_layers * (3 * proj + flash) + 3 * head


def test_engine_hook_counts_the_reckoned_products(tmp_path):
    _, tm = tiny_models("gpt2", attention_impl="flash", spec=(
        "gpt2", dict(vocab_size=256, num_layers=4, d_model=64, num_heads=2,
                     max_seq_len=256)))
    out = tmp_path / "prof.txt"
    eng = tds.initialize(model=tm, device="cpu", config={
        "train_micro_batch_size_per_device": 2, "steps_per_print": 1000,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "progressive_layer_drop": {"enabled": True, "theta": 0.0,
                                   "gamma": 10.0},
        "data_efficiency": {"enabled": True, "data_routing": {
            "enabled": True, "random_ltd": {
                "enabled": True, "min_value": 128, "max_value": 256,
                "require_steps": 100, "seq_per_step": 128}}},
        "flops_profiler": {"enabled": True, "profile_step": 2,
                           "output_file": str(out)}})
    ids = np.random.RandomState(0).randint(0, 256, (2, 256))
    for _ in range(3):
        eng.train_batch({"input_ids": ids})
    assert "flops per step" in out.read_text()
    # the profiled step: global step 1's key, theta after 1 step of decay
    _, keys = layer_keys(tm.config, PRNGKey(eng.config.seed + 1), True,
                         True)
    kept = 4 - sum(pld_drops(tm.config, keys, eng.pld.update_state(1)))
    assert 0 < kept < 4          # the seed drops some layers, not all
    want = reckon_step_flops(tm.config, 2, 256, 128, kept)
    assert eng.flops_profile["flops"] == want, eng.flops_profile["by_op"]
    flash = [k for k in eng.flops_profile["by_op"] if "flash" in k]
    assert len(flash) == 3
