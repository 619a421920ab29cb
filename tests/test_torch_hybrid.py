"""The port's hybrid engine (``deepspeed_tpu_torch.HybridEngine``) and
``InferenceEngine.refresh_params`` held against the JAX package's on one
device: generate -> train x2 -> generate with the same weights and
batches (fp32 training; bf16 serving and int8 ``weight_quant`` serving),
the served weights after a refresh (bitwise ``compute_params``, or its
re-quantization), the lazy refresh, the checkpoint reload, the LoRA fuse,
the refusals, and the stale-prefix fault of the JAX engine, which the
port does not copy.

Tolerances: greedy streams equal token for token (the same weights and
the same inputs; a bf16 near-tie of the tiny random model would show as
a failure here, and none occurs on these seeds); trained masters atol
1e-5 (fp32; a NULL_GRAD_LEAVES note applies to the key bias); the LoRA
fuse rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm import MeshTopology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.inference import InferenceConfig as JIC
from deepspeed_tpu.inference import InferenceEngine as JIE
from deepspeed_tpu.inference import SamplingParams as JSP
from deepspeed_tpu_torch.inference import InferenceConfig as TIC
from deepspeed_tpu_torch.inference import InferenceEngine as TIE
from deepspeed_tpu_torch.inference import SamplingParams as TSP
from deepspeed_tpu_torch.models import Model
from deepspeed_tpu_torch.runtime.runtime_utils import tree_leaves
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)
from tests.test_torch_train import tiny_models

SPEC = ("gpt2", dict(vocab_size=128, num_layers=2, d_model=64, num_heads=4,
                     max_seq_len=96))
CONFIG = {"train_micro_batch_size_per_device": 4,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
          "steps_per_print": 1000, "mesh": {"data": 1}}
NEW = 6


def _icfgs(serving):
    """(JAX config, port config).  The JAX engine takes its XLA attention
    directly (``attn_impl="xla"``): what its probe picks on the CPU,
    without compiling the Pallas kernel in interpret mode to time it."""
    kw = dict(token_budget=64, max_seqs=4, kv_block_size=16,
              num_kv_blocks=32)
    jkw = dict(kw, attn_impl="xla")
    if serving == "fp32":
        return (JIC(kv_dtype=jnp.float32, param_dtype=jnp.float32, **jkw),
                TIC(kv_dtype=torch.float32, param_dtype=torch.float32, **kw))
    if serving == "int8":
        return JIC(weight_quant="int8", **jkw), TIC(weight_quant="int8", **kw)
    return JIC(**jkw), TIC(**kw)


def _topo():
    return MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])


def _hybrids(serving):
    jm, tm = tiny_models("gpt2", attention_impl="xla", spec=SPEC)
    jic, tic = _icfgs(serving)
    jh = jds.HybridEngine(jm, dict(CONFIG), inference_config=jic,
                          topology=_topo())
    th = tds.HybridEngine(tm, dict(CONFIG), inference_config=tic,
                          device="cpu")
    return jm, tm, jh, th


def _batch(seed):
    return {"input_ids": np.random.RandomState(seed).randint(0, 128,
                                                             (4, 32))}


GREEDY_J, GREEDY_T = JSP(temperature=0.0, max_new_tokens=NEW), \
    TSP(temperature=0.0, max_new_tokens=NEW)


NEAR_TIE = 0.05


def assert_streams_agree(cfg, params, prompts, got, want):
    """Equal token for token, but at a near-tie: where the streams first
    part, the fp32 dense forward of the served weights over the common
    context must put both tokens within NEAR_TIE of each other (bf16
    serving rounds the logits of a random tiny model to ~1e-2); the
    streams are not compared past that point."""
    from deepspeed_tpu_torch.models.transformer import apply
    fp32 = jax.tree.map(lambda x: x.float(), params)
    for uid, p in prompts.items():
        a, b = got[uid], want[uid]
        assert len(a) == len(b) == NEW
        i = next((i for i in range(NEW) if a[i] != b[i]), None)
        if i is None:
            continue
        ctx = torch.tensor([list(p) + a[:i]])
        logits = apply(cfg, fp32, ctx)[0, -1]
        gap = float((logits[a[i]] - logits[b[i]]).abs())
        assert gap <= NEAR_TIE, (uid, i, a[i], b[i], gap)


@pytest.mark.parametrize("serving", ["bf16", "int8"])
def test_generate_train_generate_matches_jax(serving):
    """Prompts shorter than a block (no prefix reuse): the rollouts of
    both hybrid engines before and after two actor steps (equal but at
    near-ties), the step losses, and the served weights after the
    refresh: bitwise ``compute_params`` in the serving dtype, or bitwise
    its re-quantization (and JAX's to a rounding tie)."""
    jm, tm, jh, th = _hybrids(serving)
    prompts = {u: list(np.random.RandomState(10 + u).randint(1, 128, 9))
               for u in range(3)}
    assert_streams_agree(tm.config, th.engine.compute_params, prompts,
                         th.generate(dict(prompts), GREEDY_T),
                         jh.generate(dict(prompts), GREEDY_J))
    for s in range(2):
        jl = float(jh.train_batch(_batch(s))["loss"])
        tl = float(th.train_batch(_batch(s))["loss"])
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    prompts = {u + 10: p for u, p in prompts.items()}
    assert_streams_agree(tm.config, th.engine.compute_params, prompts,
                         th.generate(dict(prompts), GREEDY_T),
                         jh.generate(dict(prompts), GREEDY_J))
    served = th.inference_engine
    cp = th.engine.compute_params
    if serving == "int8":
        from deepspeed_tpu_torch.inference.quantization import \
            quantize_model_params
        _, q = quantize_model_params(
            jax.tree.map(lambda x: x.to(torch.bfloat16), cp), bits=8)
        for name in ("wq", "wo"):
            got = served._quant["blocks"]["attn"][name]
            assert torch.equal(got.data, q["blocks"]["attn"][name].data)
            assert torch.equal(got.scale, q["blocks"]["attn"][name].scale)
        jq = jh.inference_engine._quant["blocks"]["attn"]["wq"]
        assert np.mean(served._quant["blocks"]["attn"]["wq"].data.numpy()
                       == np.asarray(jq.data)) > 0.99
    else:
        assert all(torch.equal(a, b.to(torch.bfloat16)) for a, b in zip(
            tree_leaves(served.params), tree_leaves(cp)))


def test_refresh_is_lazy_and_checkpoint_reload_invalidates(tmp_path):
    _, tm = tiny_models("gpt2", attention_impl="xla", spec=SPEC)
    th = tds.HybridEngine(tm, dict(CONFIG), inference_config=_icfgs(
        "fp32")[1], device="cpu")
    th.generate({0: [1, 2, 3]}, GREEDY_T)
    eng1, step1 = th.inference_engine, th._params_step
    th.generate({1: [4, 5]}, GREEDY_T)
    assert th._params_step == step1 and th.inference_engine is eng1
    assert len(th.refresh_seconds) == 1
    th.train_batch(_batch(0))
    th.generate({2: [4, 5]}, GREEDY_T)
    assert th.inference_engine is eng1 and th._params_step == 1
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng1.params), tree_leaves(th.engine.compute_params)))
    d = th.save_checkpoint(str(tmp_path))
    th.load_checkpoint(str(tmp_path))
    assert d and th._params_step == -1


def test_refresh_refusals(tmp_path):
    """A tree that does not match the served one, an engine on a pre-built
    quant_tree, an engine streaming its weights, and a hybrid engine
    asked for the card on a machine without one: each raises."""
    import dataclasses
    _, tm = tiny_models("gpt2", attention_impl="xla", spec=SPEC)
    fp32 = _icfgs("fp32")[1]
    with pytest.raises(NotImplementedError, match="weight_stream"):
        TIE(tm, dataclasses.replace(fp32, weight_stream=str(
            tmp_path / "ws"))).refresh_params(tm.params)
    eng = TIE(tm, fp32)
    bad = {**tm.params, "ln_f": {"scale": tm.params["ln_f"]["scale"]}}
    with pytest.raises(ValueError, match="refresh_params: params.ln_f"):
        eng.refresh_params(bad)
    short = jax.tree.map(lambda x: x, tm.params)
    short["blocks"]["attn"]["wq"] = short["blocks"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match=r"params.blocks.attn.wq is \(1,"):
        eng.refresh_params(short)
    from deepspeed_tpu_torch.inference.quantization import \
        quantize_model_params
    dense, q = quantize_model_params(tm.params, bits=8)
    with pytest.raises(ValueError, match="pre-built quant_tree"):
        TIE(Model.from_params(tm.config, dense), fp32,
            quant_tree=q).refresh_params(tm.params)
    from deepspeed_tpu_torch.platform.cuda import NoCudaDeviceError
    import unittest.mock as mock
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(NoCudaDeviceError):
            tds.HybridEngine(tm, dict(CONFIG))


def test_lora_fuse_tree_matches_jax():
    from deepspeed_tpu.linear.optimized_linear import LoRAConfig as JL
    from deepspeed_tpu.linear.optimized_linear import \
        init_optimized_linear as jinit
    from deepspeed_tpu.runtime.hybrid_engine import fuse_lora_tree as jfuse
    from deepspeed_tpu_torch.linear import LoRAConfig as TL
    from deepspeed_tpu_torch.models import params_from_numpy
    from deepspeed_tpu_torch.runtime.hybrid_engine import \
        fuse_lora_tree as tfuse
    p = jinit(jax.random.PRNGKey(0), 8, 8, lora=JL(lora_r=4, lora_alpha=8.0))
    p["lora_b"] = jnp.ones_like(p["lora_b"]) * 0.1
    tree = {"layer0": {"proj": p}, "other": jnp.ones((3,))}
    want = jfuse(tree, JL(lora_r=4, lora_alpha=8.0))
    got = tfuse(params_from_numpy(jax.tree.map(np.asarray, tree),
                                  device="cpu"), TL(lora_r=4, lora_alpha=8.0))
    assert sorted(got["layer0"]["proj"]) == ["base"]
    np.testing.assert_allclose(got["layer0"]["proj"]["base"].numpy(),
                               np.asarray(want["layer0"]["proj"]["base"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got["other"].numpy(), np.ones(3))


def test_stale_prefix_fault_of_the_reference():
    """A 40-token prompt (2 full 16-token blocks): generate, train two
    steps, generate it again.  The port's second stream equals a fresh
    engine's on the trained weights (refresh_params resets the prefix
    cache); the JAX engine reuses the 32 cached prompt tokens' KV,
    computed under the old weights, and its second stream differs from
    its own fresh engine's (ROADMAP Queue 3)."""
    jm, tm, jh, th = _hybrids("fp32")
    prompt = list(np.random.RandomState(3).randint(1, 128, 40))
    first_t = th.generate({0: prompt}, GREEDY_T)[0]
    first_j = jh.generate({0: prompt}, GREEDY_J)[0]
    assert first_t == first_j
    for s in range(2):
        th.train_batch(_batch(s))
        jh.train_batch(_batch(s))
    again_t = th.generate({1: prompt}, GREEDY_T)[1]
    again_j = jh.generate({1: prompt}, GREEDY_J)[1]
    fresh_t = TIE(Model.from_params(tm.config, th.engine.compute_params),
                  _icfgs("fp32")[1]).generate({0: prompt}, GREEDY_T)[0]
    jm.params = jh.engine.compute_params
    fresh_j = JIE(jm, _icfgs("fp32")[0]).generate({0: prompt}, GREEDY_J)[0]
    assert th.inference_engine.timings["cached_tokens"] == 0
    assert again_t == fresh_t
    assert fresh_t == fresh_j          # the two fresh engines agree
    assert jh.inference_engine.timings["cached_tokens"] >= 32
    assert again_j != fresh_j, (again_j, fresh_j)
