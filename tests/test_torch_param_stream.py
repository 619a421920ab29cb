"""Per-layer NVMe parameter streaming on the port
(``deepspeed_tpu_torch/runtime/param_stream.py``), on the CPU, against the
port's plain engine and the JAX streamed engine
(``deepspeed_tpu/runtime/param_stream.py``) from the same weights.

Tolerances: losses rtol 2e-3 and atol 2e-4 over the steps, the bar of
the reference's own streamed-vs-plain test (tests/test_offload_aio.py):
the streamed step recomputes each layer and sums its grads in another
order, and its update is HostAdam's arithmetic.  Against the JAX streamed
engine (the same algorithm) rtol 1e-4.  The checkpoint round trip is
bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm import MeshTopology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.checkpoint.engine import consolidate
from deepspeed_tpu_torch.config.config import ConfigError
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        build_model, params_from_numpy)
from deepspeed_tpu_torch.runtime.param_stream import ResidencyMeter
from deepspeed_tpu_torch.runtime.runtime_utils import param_count
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

SEQ = 32
MODELS = {
    # the reference's streamed test model, 8 layers
    "gpt2": ("gpt2", dict(vocab_size=128, num_layers=8, d_model=32,
                          num_heads=4, max_seq_len=SEQ)),
    # parallel block, partial rotary (rope_pct 0.25), untied head with bias
    "gptj": ("gptj-tiny", dict(vocab_size=128, num_layers=3, d_model=64,
                               num_heads=4, max_seq_len=SEQ)),
}


def _models(name):
    """The JAX model and the port's on the same weights."""
    preset, over = MODELS[name]
    jm = jax_build_model(preset, seed=3, attention_impl="xla", **over)
    params = jax.tree.map(np.asarray, jm.params)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    return jm, params, cfg


def _port_model(params, cfg):
    return Model.from_params(cfg, params_from_numpy(params, device="cpu"))


def _config(path, gas=1, stream=True, precision=None):
    zero = {"stage": 3}
    if stream:
        zero["offload_optimizer"] = {"device": "nvme",
                                     "nvme_path": str(path),
                                     "buffer_size": 4096}
        zero["offload_param"] = {"device": "nvme", "nvme_path": str(path)}
    cfg = {"train_micro_batch_size_per_device": 2,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "mesh": {"data": 1}, "steps_per_print": 1000,
           "gradient_clipping": 1.0, "zero_optimization": zero}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def _batch(rows, seed):
    return {"input_ids": np.random.RandomState(seed).randint(
        0, 128, (rows, SEQ))}


def _losses(engine, steps, gas=1):
    return [float(engine.train_batch(_batch(2 * gas, i))["loss"])
            for i in range(steps)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_streamed_matches_plain_and_the_jax_stream(tmp_path, name):
    jm, params, cfg = _models(name)
    plain = tds.initialize(model=_port_model(params, cfg),
                           config=_config(tmp_path, stream=False),
                           device="cpu")
    stream = tds.initialize(model=_port_model(params, cfg),
                            config=_config(tmp_path / "p"), device="cpu")
    assert stream._stream is not None and stream.offload_active
    topo = MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])
    jstream = jds.initialize(model=jm, config=_config(tmp_path / "j"),
                             topology=topo)
    assert jstream._stream is not None
    got, want = _losses(stream, 4), _losses(plain, 4)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got, _losses(jstream, 4), rtol=1e-4)
    assert stream.num_params == param_count(plain.state.master)
    io = stream._stream.io
    assert io["read"] > 0 and io["written"] > 0
    assert set(stream._stream.last_times) == {"forward", "backward",
                                              "update"}
    assert np.isfinite(stream.eval_batch(_batch(2, 99)))


def test_streamed_gas_2_matches_plain(tmp_path):
    _, params, cfg = _models("gpt2")
    plain = tds.initialize(model=_port_model(params, cfg),
                           config=_config(tmp_path, gas=2, stream=False),
                           device="cpu")
    stream = tds.initialize(model=_port_model(params, cfg),
                            config=_config(tmp_path / "p", gas=2),
                            device="cpu")
    np.testing.assert_allclose(_losses(stream, 2, gas=2),
                               _losses(plain, 2, gas=2), rtol=2e-3,
                               atol=2e-4)


def test_eval_batch_and_host_residency(tmp_path):
    """bf16: the streamed eval equals the plain engine's on the same
    weights; ResidencyMeter's peak stays below the model's bf16 bytes (8
    layers: one layer and one swap group are a small part of it)."""
    _, params, cfg = _models("gpt2")
    plain = tds.initialize(model=_port_model(params, cfg),
                           config=_config(tmp_path, stream=False,
                                          precision="bf16"), device="cpu")
    stream = tds.initialize(model=_port_model(params, cfg),
                            config=_config(tmp_path / "p",
                                           precision="bf16"), device="cpu")
    ids = _batch(2, 5)
    assert stream.eval_batch(ids) == plain.eval_batch(ids)
    _losses(stream, 2)
    peak = stream._stream.meter.peak
    assert 0 < peak < 2 * param_count(plain.state.master)
    with pytest.raises(ConfigError, match="param streaming"):
        stream.compute_params
    m = ResidencyMeter()
    m.alloc(10)
    m.free(4)
    m.alloc(3)
    assert (m.cur, m.peak) == (9, 10)


def test_streamed_checkpoint_round_trip(tmp_path):
    """Save after 2 steps; a fresh streamed engine (other weights) loads:
    master and moments bitwise, the next step's loss bitwise; a plain
    engine loads the same checkpoint (the stacked fp32 layout)."""
    _, params, cfg = _models("gptj")
    a = tds.initialize(model=_port_model(params, cfg),
                       config=_config(tmp_path / "a"), device="cpu")
    _losses(a, 2)
    a.save_checkpoint(str(tmp_path / "ck"))
    other = jax.tree.map(lambda x: x + 0.5, params)
    b = tds.initialize(model=_port_model(other, cfg),
                       config=_config(tmp_path / "b"), device="cpu")
    b.load_checkpoint(str(tmp_path / "ck"))
    assert b.state.step == 2 and b.global_steps == 2
    for ta, tb in zip(a._stream.state_trees(), b._stream.state_trees()):
        for x, y in zip(jax.tree_util.tree_leaves(ta),
                        jax.tree_util.tree_leaves(tb)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    batch = _batch(2, 7)
    assert float(a.train_batch(batch)["loss"]) == float(
        b.train_batch(batch)["loss"])
    plain = tds.initialize(model=_port_model(other, cfg),
                           config=_config(tmp_path, stream=False),
                           device="cpu")
    d, _ = plain.load_checkpoint(str(tmp_path / "ck"))
    saved = consolidate(d)
    np.testing.assert_array_equal(
        plain.state.master["blocks"]["attn"]["wq"].numpy(),
        saved[".master['blocks']['attn']['wq']"])


def test_check_supported_refuses_moe_and_a_custom_eval_fn(tmp_path):
    moe = build_model("qwen2-moe-tiny", num_layers=2, d_model=64,
                      num_heads=4, vocab_size=128, d_ff=32, num_experts=4,
                      device="cpu")
    with pytest.raises(ConfigError, match="MoE"):
        tds.initialize(model=moe, config=_config(tmp_path), device="cpu")
    _, params, cfg = _models("gpt2")
    m = _port_model(params, cfg)
    with pytest.raises(ConfigError, match="custom eval_fn"):
        tds.initialize(model=m, config=_config(tmp_path), device="cpu",
                       eval_fn=m.loss_fn)

