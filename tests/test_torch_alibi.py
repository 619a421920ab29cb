"""ALiBi (BLOOM) in the port held against the JAX package on the same
numpy inputs: the slopes bit for bit; the plain paged attention with
slopes (one-shot and chunked, bf16 and fp32, rep 1 and 2, int8 and fp8
caches, an aliased block table) against the JAX Pallas kernel in
interpret mode and both XLA formulations; the dense forward of
``bloom-tiny``; greedy serving streams token for token (default path,
chunked path, GQA, int8 cache); an 8-step training trajectory; and a JAX
``bloom-tiny`` tree carried over unchanged.

Tolerances are those of tests/test_torch_paged_attention.py for the same
comparisons without slopes: fp32 1e-5 (the same sums in another order),
bf16 2e-2; the forward 1e-4 and the trajectory rtol 1e-4 as in
tests/test_torch_train.py.  The CUDA kernel with slopes is held against
the plain version by tests/test_torch_kernels_cuda.py on the card."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
import tests.test_paged_attention as jax_tests
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference import model as jax_im
from deepspeed_tpu.inference.model import (_paged_attention,
                                           _paged_attention_chunked,
                                           _quantize_kv)
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.models.layers import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.models.transformer import apply as jax_apply
from deepspeed_tpu.ops.paged_attention import \
    paged_attention as jax_pallas_paged_attention
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.models import (Model, TransformerConfig, apply,
                                        params_from_numpy)
from deepspeed_tpu_torch.models.layers import (alibi_slopes,
                                               causal_attention,
                                               make_alibi_attention)
from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_chunked,
                                                     paged_attention_plain)
from tests.test_torch_train import (  # noqa: F401 (one_thread: autouse)
    assert_trajectories_agree, one_thread, run_trajectories, tiny_models)

NB = 4            # max_blocks_per_seq of the reference cases
PA_MOD = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")


@pytest.mark.parametrize("H", [4, 8, 12, 16, 32, 71])
def test_slopes_are_jax_bits(H):
    ref = np.asarray(jax_alibi_slopes(H))
    got = alibi_slopes(H).numpy()
    assert got.dtype == np.float32 and got.shape == (H,)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


# --- paged attention with slopes ---------------------------------------------

def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _case(H, seed):
    kv, batch, bs = jax_tests._mixed_batch()
    D = kv.shape[4]
    q = np.random.RandomState(seed).randn(
        batch.token_ids.shape[0], H, D).astype(np.float32)
    return kv, jnp.asarray(q), batch, bs, 1.0 / np.sqrt(D)


def _args(q, batch, dtype):
    return (_t(np.asarray(q, np.float32), dtype), _t(batch.seq_slot),
            _t(batch.positions), _t(batch.block_tables))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jax_refs(kv, q, batch, bs, scale, slopes):
    """The Pallas kernel (interpret mode) and both XLA formulations."""
    return (jax_pallas_paged_attention(kv, q, batch.seq_slot,
                                       batch.positions, batch.block_tables,
                                       bs, NB, scale, slopes=slopes),
            _paged_attention(kv, q, batch, bs, NB, scale, slopes=slopes),
            _paged_attention_chunked(kv, q, batch, bs, NB, scale,
                                     slopes=slopes))


@pytest.mark.parametrize("H", [2, 4], ids=["rep1", "rep2"])
def test_plain_with_slopes_matches_jax_fp32(H):
    """fp32: the wrapper (plain version on the CPU), the one-shot and the
    chunked plain versions against the Pallas kernel and both XLA twins.
    The bias reaches several units here, so it moves the output."""
    kv, q, batch, bs, scale = _case(H, seed=1)
    jslopes = jax_alibi_slopes(H) * 4.0
    slopes = _t(np.asarray(jslopes))
    kv_t = _t(np.asarray(kv))
    args = (kv_t, *_args(q, batch, torch.float32), bs, NB, scale)
    outs = (paged_attention(*args, slopes), paged_attention_plain(*args,
                                                                  slopes),
            paged_attention_chunked(*args, slopes))
    valid = np.asarray(batch.token_valid)
    for ref in _jax_refs(kv, q, batch, bs, scale, jslopes):
        for got in outs:
            np.testing.assert_allclose(_f32(got)[valid], _f32(ref)[valid],
                                       atol=1e-5, rtol=1e-5)
    no_bias = paged_attention_plain(*args)
    assert np.abs(_f32(no_bias) - _f32(outs[0]))[valid].max() > 1e-2
    assert torch.isfinite(outs[0]).all()


@pytest.mark.parametrize("H", [2, 4], ids=["rep1", "rep2"])
def test_plain_with_slopes_matches_jax_bf16(H):
    kv, q, batch, bs, scale = _case(H, seed=2)
    kv16, q16 = kv.astype(jnp.bfloat16), q.astype(jnp.bfloat16)
    jslopes = jax_alibi_slopes(H)
    args = (_t(np.asarray(kv16, np.float32), torch.bfloat16),
            *_args(q16, batch, torch.bfloat16), bs, NB, scale)
    out = paged_attention(*args, _t(np.asarray(jslopes)))
    assert out.dtype == torch.bfloat16
    ref = jax_pallas_paged_attention(kv16, q16, batch.seq_slot,
                                     batch.positions, batch.block_tables,
                                     bs, NB, scale, slopes=jslopes)
    valid = np.asarray(batch.token_valid)
    np.testing.assert_allclose(_f32(out)[valid], _f32(ref)[valid],
                               atol=2e-2, rtol=2e-2)


_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


@pytest.mark.parametrize("code", sorted(_CODES))
@pytest.mark.parametrize("H", [2, 4], ids=["rep1", "rep2"])
def test_quantized_cache_with_slopes_matches_jax(code, H):
    """int8 / fp8 codes quantized by the JAX package and carried over bit
    for bit; slopes given as [Hkv, rep] (any shape of H values)."""
    kv, q, batch, bs, scale = _case(H, seed=7)
    codes, scales = _quantize_kv(jnp.asarray(kv), _CODES[code])
    pkv = tuple(params_from_numpy({"c": np.asarray(codes),
                                   "s": np.asarray(scales)},
                                  device="cpu").values())
    Hkv = kv.shape[3]
    jslopes = jax_alibi_slopes(H) * 3.0
    slopes = _t(np.asarray(jslopes)).reshape(Hkv, H // Hkv)
    args = (*_args(q, batch, torch.float32), bs, NB, scale, slopes)
    outs = (paged_attention(pkv, *args), paged_attention_chunked(pkv, *args))
    valid = np.asarray(batch.token_valid)
    for ref in _jax_refs((codes, scales), q, batch, bs, scale, jslopes):
        for got in outs:
            np.testing.assert_allclose(_f32(got)[valid], _f32(ref)[valid],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H", [2, 4], ids=["rep1", "rep2"])
def test_aliased_block_tables_with_slopes(H):
    """Two sequences' tables share a physical block: the same output as a
    de-aliased copy and as the JAX kernel, with slopes."""
    kv, aliased, dealiased, bs, valid = \
        jax_tests.TestAliasedBlockTables()._aliased_batch()
    D = kv.shape[4]
    q = jnp.asarray(np.random.RandomState(6).randn(
        aliased.token_ids.shape[0], H, D).astype(np.float32))
    scale = 1.0 / np.sqrt(D)
    jslopes = jax_alibi_slopes(H) * 2.0
    slopes = _t(np.asarray(jslopes))
    kv_t = _t(np.asarray(kv))
    out_alias = paged_attention(kv_t, *_args(q, aliased, torch.float32), bs,
                                NB, scale, slopes)
    out_dealias = paged_attention(kv_t, *_args(q, dealiased, torch.float32),
                                  bs, NB, scale, slopes)
    np.testing.assert_allclose(_f32(out_alias)[valid],
                               _f32(out_dealias)[valid], atol=1e-6,
                               rtol=1e-6)
    ref = jax_pallas_paged_attention(kv, q, aliased.seq_slot,
                                     aliased.positions, aliased.block_tables,
                                     bs, NB, scale, slopes=jslopes)
    np.testing.assert_allclose(_f32(out_alias)[valid], _f32(ref)[valid],
                               atol=1e-5, rtol=1e-5)


def test_cpu_launch_counts_nothing_and_slope_counter_exists():
    kv, q, batch, bs, scale = _case(4, seed=3)
    before = (paged_attention.launches, paged_attention.alibi_launches)
    paged_attention(_t(np.asarray(kv)), *_args(q, batch, torch.float32), bs,
                    NB, scale, alibi_slopes(4))
    assert (paged_attention.launches, paged_attention.alibi_launches) \
        == before


# --- the model: dense forward, carried weights, training ----------------------

BLOOM_TINY = ("bloom-tiny", dict(vocab_size=256, num_layers=2, d_model=128,
                                 num_heads=4, max_seq_len=128))


def test_dense_forward_matches_jax_apply():
    """``bloom-tiny`` (word-embedding LayerNorm, ALiBi, biases, tied
    embeddings) on the same noised weights: the port's ``apply`` (no
    attention passed: the bias comes from the config) and the model's
    resolved attention against the JAX ``apply``."""
    jm, tm = tiny_models("bloom", attention_impl="xla", spec=BLOOM_TINY)
    ids = np.random.RandomState(2).randint(0, 256, (2, 40))
    ref = np.asarray(jax_apply(jm.config, jm.params, jnp.asarray(ids)))
    for got in (apply(tm.config, tm.params, torch.from_numpy(ids)),
                tm.apply(tm.params, torch.from_numpy(ids))):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    # without the bias the logits are another function
    plain = apply(tm.config, tm.params, torch.from_numpy(ids),
                  attention_fn=causal_attention)
    assert np.abs(plain.numpy() - ref).max() > 1e-2


def test_jax_tree_carries_over_unchanged():
    """A JAX ``bloom-tiny`` tree through ``params_from_numpy``: the same
    keys (``ln_embed``, q/k/v/o and MLP biases, the tied table and no
    LM head), every leaf bit for bit, and the same logits."""
    jm = jax_build_model("bloom-tiny", seed=4, vocab_size=256, num_layers=2,
                         d_model=128, num_heads=4, max_seq_len=128)
    tree = jax.tree.map(np.asarray, jm.params)
    port = params_from_numpy(tree, device="cpu")
    flat_j = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat_p = {jax.tree_util.keystr(p): x for p, x in
              jax.tree_util.tree_flatten_with_path(port)[0]}
    assert sorted(flat_j) == sorted(flat_p)
    for key in ("['ln_embed']['scale']", "['ln_embed']['bias']",
                "['blocks']['attn']['bq']", "['blocks']['attn']['bo']",
                "['blocks']['mlp']['bi']", "['blocks']['mlp']['bo']",
                "['embed']['table']"):
        assert key in flat_p, key
    assert not any("lm_head" in k for k in flat_p)
    for key, a in flat_j.items():
        b = flat_p[key].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    ids = np.random.RandomState(3).randint(0, 256, (1, 24))
    np.testing.assert_allclose(
        apply(cfg, port, torch.from_numpy(ids)).numpy(),
        np.asarray(jax_apply(jm.config, jm.params, jnp.asarray(ids))),
        atol=1e-4, rtol=1e-4)


def test_flash_with_alibi_raises_and_shards_are_not_ported():
    _, tm = tiny_models("bloom", attention_impl="xla", spec=BLOOM_TINY)
    for impl in ("flash", "xla_flash"):
        with pytest.raises(ValueError, match="alibi"):
            Model.from_params(dataclasses.replace(tm.config,
                                                  attention_impl=impl),
                              tm.params)
    with pytest.raises(NotImplementedError, match="item 6"):
        make_alibi_attention(total_heads=8)


def test_training_trajectory_matches_jax():
    """8 AdamW steps of ``bloom-tiny`` (``attention_impl="xla"``, fp32)
    against the JAX engine: loss and grad norm rtol 1e-4, final params
    atol 1e-4."""
    assert_trajectories_agree(*run_trajectories(
        "bloom", 1, attention_impl="xla", spec=BLOOM_TINY), rtol=1e-4,
        atol=1e-4)


# --- greedy serving streams against the JAX engine ---------------------------

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)


def _prompts():
    r = np.random.RandomState(1)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    long = tok(40)                                 # > budget: chunked
    return {1: tok(7), 2: long, 3: tok(4), 4: long[:32] + tok(5)}


SERVING = {"default": ({}, {}), "chunked": ({}, {}),
           "gqa": ({"num_kv_heads": 2}, {}),
           "int8kv": ({}, {"kv_quant": "int8"})}


@pytest.mark.parametrize("case", sorted(SERVING))
def test_greedy_serving_matches_jax_engine(case, monkeypatch):
    """``bloom-tiny`` (2 layers, d_model 64, 4 heads, as the JAX package's
    TestAlibiServing) greedy through both engines, 10 new tokens: the
    default one-shot path, the chunked path (both gather caps at 0),
    GQA and an int8 cache, each at pipeline depth 1 and 2."""
    model_over, eng_over = SERVING[case]
    if case == "chunked":
        monkeypatch.setattr(jax_im, "_ONE_SHOT_GATHER_BYTES", 0)
        monkeypatch.setattr(PA_MOD, "_ONE_SHOT_GATHER_BYTES", 0)
    jm = jax_build_model("bloom-tiny", vocab_size=128, num_layers=2,
                         d_model=64, num_heads=4, max_seq_len=128,
                         **model_over)
    ref = jax_inference.make_fp32_engine(
        jm, attn_impl="xla", pipeline_depth=1, **eng_over).generate(
            _prompts(), JaxSampling(max_new_tokens=10))
    port = Model.from_params(
        TransformerConfig(**dataclasses.asdict(jm.config)),
        params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu"))
    for depth in (1, 2):
        eng = InferenceEngine(port, InferenceConfig(
            **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32,
            pipeline_depth=depth, **eng_over))
        assert eng.generate(_prompts(), SamplingParams(
            max_new_tokens=10)) == ref, depth
        assert eng.timings["prefix_hits"] >= 1
