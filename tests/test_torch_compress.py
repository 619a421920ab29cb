"""The port's compression suite, LoRA layers and fp8 quantization held
against the JAX package on the same seeded numpy inputs: the pruning
techniques and the config-driven scheduler (exact: comparisons and
selections on the same fp32 values), ``redundancy_clean``, layer
reduction and the distillation loss (rtol 1e-6), ``fp_quantize`` (codes
within one fp8 step of JAX's cast, dequantized values within that step's
scale), ``weight_quantization`` / ``activation_quantization`` (within
one code step), and LoRA: ``init_optimized_linear`` from a threefry key
(rtol 1e-5: ``prng.normal``'s erfinv agrees to a few ulps), the quantized
forward, ``trainable_filter``, ``merge_lora`` and the weight carrier on
``{base, lora_a, lora_b}`` nodes with int8 and fp8 bases (bitwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.compression import compress as jc
from deepspeed_tpu import linear as jl
from deepspeed_tpu.ops import quant as jq
from deepspeed_tpu_torch import compression as tc
from deepspeed_tpu_torch import linear as tl
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.ops import quant as tq
from deepspeed_tpu_torch.utils.prng import key_from_numpy
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)


def _w(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("sparse_pruning", (0.5,)), ("sparse_pruning", (0.0,)),
    ("row_pruning", (0.25,)), ("row_pruning", (0.6,)),
    ("head_pruning", (4, 0.5)), ("head_pruning", (8, 0.3))])
def test_pruning_equal(name, args):
    w = _w(0, (16, 8))
    got = getattr(tc, name)(torch.from_numpy(w), *args).numpy()
    want = np.asarray(getattr(jc, name)(jnp.asarray(w), *args))
    np.testing.assert_array_equal(got, want)


CC = {"weight_quantization": {
          "shared_parameters": {"enabled": True, "schedule_offset": 5},
          "different_groups": {"wq1": {
              "params": {"start_bits": 8, "target_bits": 8,
                         "quantization_groups": 4},
              "modules": ["w.*"]}}},
      "sparse_pruning": {
          "shared_parameters": {"enabled": True, "schedule_offset": 0},
          "different_groups": {"sp1": {"params": {"dense_ratio": 0.5},
                                       "modules": ["blk/w2"]}}},
      "row_pruning": {
          "shared_parameters": {"enabled": True, "schedule_offset": 2},
          "different_groups": {"rp1": {"params": {"ratio": 0.25},
                                       "modules": ["w1"]}}}}


@pytest.mark.parametrize("step", [0, 3, 10])
def test_scheduler_and_redundancy_clean(step):
    params = {"w1": _w(0, (32, 32)), "blk": {"w2": _w(1, (32, 32)),
                                             "bias": np.ones(32, np.float32)}}
    ts = tc.CompressionScheduler.from_config(CC)
    js = jc.CompressionScheduler.from_config(CC)
    assert [(s.pattern, s.method, s.bits, s.ratio) for s in ts.specs] == \
        [(s.pattern, s.method, s.bits, s.ratio) for s in js.specs]
    got = ts.apply(jax.tree.map(torch.from_numpy, params), step)
    want = js.apply(jax.tree.map(jnp.asarray, params), step)
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6)
    cfg = {"compression_training": CC}
    a = tc.redundancy_clean(jax.tree.map(torch.from_numpy, params), cfg)
    b = jc.redundancy_clean(jax.tree.map(jnp.asarray, params), cfg)
    np.testing.assert_allclose(a["blk"]["w2"].numpy(),
                               np.asarray(b["blk"]["w2"]), atol=1e-6)
    assert len(tc.init_compression(params, cfg).specs) == 3


def test_student_initialization_and_kd_loss():
    cfg = {"compression_training": {"layer_reduction": {
        "enabled": True, "keep_number_layer": 2, "teacher_layer": [1, 3]}}}
    teacher = {"blocks": {"w": _w(0, (4, 8, 8)), "b": _w(1, (4, 8))},
               "embed": {"table": _w(2, (16, 8))}, "head": _w(3, (8, 4))}
    student = {"blocks": {"w": _w(4, (2, 8, 8)), "b": _w(5, (2, 8))},
               "embed": {"table": _w(6, (16, 8))}, "head": _w(7, (8, 5))}
    tt = jax.tree.map(torch.from_numpy, teacher)
    got = tc.student_initialization(jax.tree.map(torch.from_numpy, student),
                                    tt, cfg)
    want = jc.student_initialization(jax.tree.map(jnp.asarray, student),
                                     jax.tree.map(jnp.asarray, teacher), cfg)
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    for bad in ({}, {"compression_training": {"layer_reduction": {
            "enabled": True, "keep_number_layer": 2,
            "teacher_layer": [1, 9]}}}):
        with pytest.raises(ValueError):
            tc.student_initialization(student, tt, bad)
    s, t = _w(8, (3, 5, 11)), _w(9, (3, 5, 11))
    np.testing.assert_allclose(
        float(tc.kd_loss(torch.from_numpy(s), torch.from_numpy(t), 2.0)),
        float(jc.kd_loss(jnp.asarray(s), jnp.asarray(t), 2.0)), rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantization_within_one_code_step(bits):
    x = _w(3, (24, 40))
    for groups in (1, 3, 10):
        got = tc.weight_quantization(torch.from_numpy(x), bits,
                                     groups).numpy()
        want = np.asarray(jc.weight_quantization(jnp.asarray(x), bits,
                                                 groups))
        step = np.abs(x).max() / (2 ** (bits - 1) - 1)
        assert np.abs(got - want).max() <= step * 1.0001
    got = tc.activation_quantization(torch.from_numpy(x), bits).numpy()
    want = np.asarray(jc.activation_quantization(jnp.asarray(x), bits))
    assert np.abs(got - want).max() <= np.abs(x).max() / (
        2 ** (bits - 1) - 1) * 1.0001


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
def test_fp_quantize(fmt):
    x = _w(4, (32, 64)) * 3
    got = tq.fp_quantize(torch.from_numpy(x), fmt=fmt, num_groups=4)
    want = jq.fp_quantize(jnp.asarray(x), fmt=fmt, num_groups=4)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    gc = got.data.float().numpy()
    wc = np.asarray(want.data).astype(np.float32)
    # one fp8 step: the cast may round differently where XLA narrows fp32
    # through an intermediate type
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wc), 1e-30)))
                  - (3 if fmt == "fp8_e4m3" else 2))
    assert (np.abs(gc - wc) <= ulp).all()
    assert np.mean(gc == wc) > 0.99
    deq = tq.dequantize(got).numpy()
    np.testing.assert_allclose(deq, np.asarray(jq.dequantize(want)),
                               atol=float(got.scale.max()) * 32)
    with pytest.raises(ValueError, match="unknown fp format"):
        tq.fp_quantize(torch.from_numpy(x), fmt="fp6_e3m2")


QUANTS = {"dense": None,
          "int8": dict(q_bits=8, group_size=128, format="int"),
          "fp8": dict(q_bits=8, group_size=128, format="fp8_e4m3")}


@pytest.mark.parametrize("quant", sorted(QUANTS))
def test_lora_init_apply_merge_and_carrier(quant):
    q = QUANTS[quant]
    lora_j, lora_t = jl.LoRAConfig(lora_r=8, lora_alpha=16.0), \
        tl.LoRAConfig(lora_r=8, lora_alpha=16.0)
    jp = jl.init_optimized_linear(
        jax.random.PRNGKey(0), 32, 64, lora=lora_j,
        quant=q and jl.QuantizationConfig(**q))
    tp = tl.init_optimized_linear(
        key_from_numpy(np.asarray(jax.random.PRNGKey(0))), 32, 64,
        lora=lora_t, quant=q and tl.QuantizationConfig(**q), device="cpu")
    np.testing.assert_allclose(tp["lora_a"].numpy(),
                               np.asarray(jp["lora_a"]), rtol=1e-5,
                               atol=1e-6)
    assert not tp["lora_b"].any()
    # the weight carrier: the JAX node (quantized base included) bitwise
    jp["lora_b"] = jnp.asarray(_w(5, (8, 64)) * 0.1)
    carried = params_from_numpy(jax.tree.map(np.asarray, {"proj": jp}),
                                device="cpu")["proj"]
    if q is None:
        np.testing.assert_array_equal(carried["base"].numpy(),
                                      np.asarray(jp["base"]))
    else:
        assert isinstance(carried["base"], tq.QuantizedTensor)
        np.testing.assert_array_equal(
            carried["base"].data.view(torch.uint8).numpy(),
            np.asarray(jp["base"].data).view(np.uint8))
        np.testing.assert_array_equal(carried["base"].scale.numpy(),
                                      np.asarray(jp["base"].scale))
    x = _w(6, (5, 32))
    np.testing.assert_allclose(
        tl.apply_optimized_linear(carried, torch.from_numpy(x),
                                  lora_t).numpy(),
        np.asarray(jl.apply_optimized_linear(jp, jnp.asarray(x), lora_j)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tl.merge_lora(carried, lora_t).numpy(),
        np.asarray(jl.merge_lora(jp, lora_j)), rtol=1e-6, atol=1e-6)
    assert jax.tree.map(bool, tl.trainable_filter(carried)) == \
        {"base": False, "lora_a": True, "lora_b": True}
    assert jl.trainable_filter(jp)["lora_a"]
