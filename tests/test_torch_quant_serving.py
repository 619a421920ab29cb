"""Quantized serving in the port held against the JAX package: the port's
``InferenceEngine`` with int8/int4 weights (``mixed_gemm`` on and off),
an int8/fp8 KV cache, quantized embeddings, a pre-built ``quant_tree``
and a copy-on-write prefix hit on a quantized cache must emit greedy
streams TOKEN-IDENTICAL to the JAX engine's on the same tiny llama (fp32
engines, JAX ``attn_impl="xla"``; JAX ``mixed_gemm="on"`` runs its
Pallas kernel in interpret mode), and the first step's logits of the
two ragged forwards must agree at 1e-4.

Tolerance: first-step fp32 logits at atol = rtol = 1e-4 (the same
quantized weights; with the mixed-input GEMM both sides round x and each
weight to bf16 at the same place; sums are taken in another order).  A
K/V value that lands on a rounding half of its code may round either way
on the two sides (its inputs differ in the last bits), moving that one
element by one quantization step: the caches are compared to within one
step, and a later step's logits, which read such codes, at 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.inference.model import ragged_forward as jax_forward
from deepspeed_tpu.inference.ragged.state import (KVCacheConfig as JaxKV,
                                                  StateManager as JaxSM)
from deepspeed_tpu.ops import quant as jquant
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference import quantization as pq
from deepspeed_tpu_torch.inference.model import ragged_forward
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy,
                                        quant_tree_from_numpy)
from deepspeed_tpu_torch.models.transformer import tree_leaves
from deepspeed_tpu_torch.ops.paged_attention import _dequant_ctx
from tests.test_torch_ragged_forward import _to_port
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
NEW = 8


def _prompts():
    r = np.random.RandomState(0)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    return {1: tok(12), 2: tok(40), 3: tok(5)}     # 40 > budget: chunked


@pytest.fixture(scope="module")
def models():
    jm = jax_inference.tiny_model()
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _jax_generate(jm, prompts, n=NEW, quant_tree=None, **over):
    from deepspeed_tpu.inference import InferenceConfig as JaxConfig
    from deepspeed_tpu.inference import InferenceEngine as JaxEngine
    kw = dict(ENGINE, kv_dtype=jnp.float32, param_dtype=jnp.float32,
              attn_impl="xla", pipeline_depth=1)
    kw.update(over)
    eng = JaxEngine(jm, JaxConfig(**kw), quant_tree=quant_tree)
    return eng.generate(prompts, JaxSampling(max_new_tokens=n))


def _port_engine(port, quant_tree=None, **over):
    kw = dict(ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(port, InferenceConfig(**kw),
                           quant_tree=quant_tree)


CASES = {
    "int8-on": dict(weight_quant="int8", mixed_gemm="on"),
    "int8-off-kv8": dict(weight_quant="int8", mixed_gemm="off",
                         kv_quant="int8"),
    "int4-on-fp8": dict(weight_quant="int4", mixed_gemm="on",
                        kv_quant="fp8"),
    "int4-off": dict(weight_quant="int4", mixed_gemm="off"),
    "int8-on-embed-kv8": dict(weight_quant="int8", mixed_gemm="on",
                              quantize_embeddings=True, kv_quant="int8"),
    "kv-fp8": dict(kv_quant="fp8"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_token_identical_to_jax(models, case):
    jm, port = models
    over = CASES[case]
    ref = _jax_generate(jm, _prompts(), **over)
    eng = _port_engine(port, **over)
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=NEW))
    assert out == ref
    assert eng._mixed_gemm_active == (over.get("mixed_gemm") == "on")
    assert isinstance(eng.state.kv, tuple) == ("kv_quant" in over)
    if "weight_quant" in over:
        assert "wq" not in eng.params["blocks"]["attn"]
        assert ("table" in eng.params["embed"]) != \
            over.get("quantize_embeddings", False)


def _forward_pair(jm, port, bits, mixed, kv_quant, embed):
    """The JAX and port ragged forwards over two steps from the same
    quantized weights and empty caches; returns per-step logits and the
    final caches."""
    jparams = jm.params
    jd, jqt = jq.quantize_model_params(jparams, bits=bits,
                                       quantize_embeddings=embed)
    pd, pqt = pq.quantize_model_params(port.params, bits=bits,
                                       quantize_embeddings=embed)
    cfg = jm.config
    sm = JaxSM(JaxKV(num_layers=cfg.num_layers,
                     num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                     block_size=16, num_blocks=8, dtype=jnp.float32,
                     quant=kv_quant or "none"), max_seqs=4)
    jkv = sm.kv
    pkv = tuple(params_from_numpy({"c": np.asarray(jkv[0]),
                                   "s": np.asarray(jkv[1])},
                                  device="cpu").values()) \
        if kv_quant else torch.zeros(np.asarray(jkv).shape)
    r = np.random.RandomState(4)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    steps = [[(0, tok(20)), (1, tok(9))], [(0, tok(1)), (1, tok(1))]]
    logits = []
    for step in steps:
        jb = sm.build_batch(step, token_budget=32)
        jl, jkv = jax_forward(cfg, jd, jkv, jb, 16, 4, attn_impl="xla",
                              quant=jqt, mixed_gemm=mixed)
        pl_, pkv = ragged_forward(port.config, pd, pkv, _to_port(jb), 16, 4,
                                  quant=pqt, mixed_gemm=mixed)
        rows = np.asarray(jb.logits_idx) >= 0
        logits.append((pl_.numpy()[rows], np.asarray(jl)[rows]))
    return logits, jkv, pkv


@pytest.mark.parametrize("bits, mixed, kv_quant, embed", [
    (8, True, "int8", False), (8, False, "fp8", True),
    (4, True, "fp8", False), (4, False, None, True), (8, True, None, True)])
def test_forward_logits_match_jax(models, bits, mixed, kv_quant, embed):
    jm, port = models
    logits, jkv, pkv = _forward_pair(jm, port, bits, mixed, kv_quant, embed)
    (got1, want1), (got2, want2) = logits
    np.testing.assert_allclose(got1, want1, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got2, want2, atol=1e-3, rtol=1e-3)
    if kv_quant:
        # the caches hold the same K/V up to a code flip at a rounding
        # half: one int8 step, or one fp8 step (at most |code| / 8 for
        # 3 mantissa bits); the trash row is skipped
        jc, js = params_from_numpy({"c": np.asarray(jkv[0]),
                                    "s": np.asarray(jkv[1])},
                                   device="cpu").values()
        pc, ps = pkv
        jf, pf = jc.float()[:, :-1], pc.float()[:, :-1]
        code_step = (torch.ones_like(jf) if kv_quant == "int8"
                     else torch.maximum(jf.abs(), pf.abs()) / 8 + 2.0 ** -9)
        diff = (_dequant_ctx(pc, ps, torch.float32)
                - _dequant_ctx(jc, js, torch.float32))[:, :-1]
        assert bool((diff.abs() <= code_step * ps[:, :-1, ..., None] * 1.001
                     + 1e-6).all())


def test_quant_tree_construction_path(models):
    """A quantized tree built once (here by the JAX package, as a
    quantized checkpoint would be) and carried over: the port's engine
    takes it with the matching dense remainder, re-applies nothing, and
    serves the same stream."""
    jm, port = models
    jd, jqt = jq.quantize_model_params(jm.params, bits=4)
    qt_port = quant_tree_from_numpy(jax.tree.map(np.asarray, jqt),
                                    device="cpu")
    dense = Model.from_params(port.config, params_from_numpy(
        jax.tree.map(np.asarray, jd), device="cpu"))
    eng = _port_engine(dense, quant_tree=qt_port, mixed_gemm="on",
                       kv_quant="int8")
    assert eng._quant is qt_port and eng._mixed_gemm_active
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=NEW))
    ref = _jax_generate(jm, _prompts(), weight_quant="int4",
                        mixed_gemm="on", kv_quant="int8")
    assert out == ref


def test_grouped_layout_is_dequantized_and_rejects_on(models):
    """A grouped-int8 tree is not a layout the kernel family takes:
    mixed_gemm='on' raises at construction, 'auto' dequantizes each layer
    and serves the JAX engine's stream."""
    jm, port = models

    def grouped(w):
        qts = [jquant.quantize(w[i], bits=8, num_groups=4)
               for i in range(w.shape[0])]
        return jquant.QuantizedTensor(
            jnp.stack([q.data for q in qts]),
            jnp.stack([q.scale for q in qts]), None, 8,
            (w.shape[0],) + qts[0].shape, qts[0].dtype)

    jd, jqt = jq.quantize_model_params(jm.params, bits=8)
    jqt["blocks"]["attn"]["wq"] = grouped(jm.params["blocks"]["attn"]["wq"])
    qt_port = quant_tree_from_numpy(jax.tree.map(np.asarray, jqt),
                                    device="cpu")
    dense = Model.from_params(port.config, params_from_numpy(
        jax.tree.map(np.asarray, jd), device="cpu"))
    with pytest.raises(ValueError, match="mixed_gemm"):
        _port_engine(dense, quant_tree=qt_port, mixed_gemm="on")
    eng = _port_engine(dense, quant_tree=qt_port)
    assert not eng._mixed_gemm_active
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=NEW))
    ref = _jax_generate(Model_like(jm, jd), _prompts(), quant_tree=jqt,
                        mixed_gemm="off")
    assert out == ref


def test_auto_dequantizes_shapes_the_kernel_does_not_take():
    """d_ff 576: the MLP's K (wo) and N (wi, wg) do not divide the 512
    block, as Llama-2-7B's d_ff 11008 does not.  'auto' resolves to the
    dequantize path at construction and serves the JAX engine's 'off'
    stream; 'on' raises at construction, not at the first step."""
    jm = jax_inference.tiny_model(d_ff=576)
    port = Model.from_params(
        TransformerConfig(**dataclasses.asdict(jm.config)),
        params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"))
    with pytest.raises(ValueError, match="mixed_gemm='on': mlp.* divide"):
        _port_engine(port, weight_quant="int8", mixed_gemm="on")
    eng = _port_engine(port, weight_quant="int8")
    assert not eng._mixed_gemm_active
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=NEW))
    assert out == _jax_generate(jm, _prompts(), weight_quant="int8",
                                mixed_gemm="off")


def Model_like(jm, params):
    """The JAX model with another parameter tree (the dense remainder)."""
    from deepspeed_tpu.models.transformer import Model as JaxModel
    m = JaxModel.__new__(JaxModel)
    m.__dict__.update(jm.__dict__)
    m.params = params
    return m


def test_cow_repeat_on_quantized_cache_matches_jax(models):
    """A repeat of a cached 32-token prompt (two full blocks) is a
    full-cover prefix hit: its last block becomes a private copy, and the
    copy must carry codes AND scales — the repeat then emits the first
    run's stream, as in the JAX engine."""
    jm, port = models
    over = dict(weight_quant="int8", mixed_gemm="on", kv_quant="int8")
    prompt = [int(x) for x in np.random.RandomState(3).randint(1, 128, 32)]
    eng = _port_engine(port, **over)
    copies = []
    take = eng.state.take_cow_copies

    def spy():
        got = take()
        for src, dst in got:
            copies.append((src, dst))
        return got

    eng.state.take_cow_copies = spy
    sp = SamplingParams(max_new_tokens=NEW)
    first = eng.generate({1: list(prompt)}, sp)[1]
    second = eng.generate({2: list(prompt)}, sp)[2]
    assert eng.timings["cached_tokens"] >= 16 and copies
    codes, scales = eng.state.kv
    for src, dst in copies:
        # the copied rows before the repeat's first write (offset 15 is
        # the re-fed last prompt token; every earlier row is untouched)
        assert torch.equal(codes[:, dst, :15], codes[:, src, :15])
        assert torch.equal(scales[:, dst, :15], scales[:, src, :15])
    assert second == first
    ref1 = _jax_generate(jm, {1: list(prompt)}, **over)
    assert first == ref1[1]


def test_minifloat_raises_and_resident_bytes_shrink(models):
    """The resident quantized weights shrink: int4 below 0.55x of the
    dense model, and the fp6 / fp12 block payloads (once refused here) to
    0.75 / 1.5 bytes a weight, one fp32 scale a (layer, row) beside."""
    _, port = models
    big = Model.from_params(
        dataclasses.replace(port.config, d_model=128, d_ff=512),
        jax.tree.map(lambda x: x, params_from_numpy(jax.tree.map(
            np.asarray, jax_inference.tiny_model(d_model=128,
                                                 d_ff=512).params),
            device="cpu")))

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if hasattr(tree, "tensors"):
            return sum(t.numel() * t.element_size() for t in tree.tensors())
        return tree.numel() * tree.element_size()

    dense = InferenceEngine(big, InferenceConfig(**ENGINE))
    quant = InferenceEngine(big, InferenceConfig(**ENGINE,
                                                 weight_quant="int4"))
    resident = nbytes(quant.params) + nbytes(quant._quant)
    assert resident < 0.55 * nbytes(dense.params), \
        (resident, nbytes(dense.params))
    assert len(tree_leaves(quant.params)) < len(tree_leaves(dense.params))
    blocks = dense.params["blocks"]
    for wq, per_weight in (("fp6", 0.75), ("fp12", 1.5)):
        eng = InferenceEngine(big, InferenceConfig(**ENGINE, weight_quant=wq))
        for g, grp in eng._quant["blocks"].items():
            for name, qt in grp.items():
                w = blocks[g][name]
                assert qt.data.numel() * qt.data.element_size() == \
                    w.numel() * per_weight, (wq, g, name)
                assert qt.scale.numel() == w.shape[0] * w.shape[1]
