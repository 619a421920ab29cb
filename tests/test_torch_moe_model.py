"""MoE models in the port held against the JAX package: mixtral-tiny and
qwen2-moe-tiny (its sigmoid-gated shared expert, raw top-k weights) —
``apply(with_aux=True)``, 8-step engine trajectories (one with Jitter
noise at gas 2: the training rng reaches the gating as the JAX engine
derives it), a quantized (int8) qwen2-moe-tiny served, the serving
capacity rule, the pad-row fault of the JAX serving MoE, and greedy
streams of the engines (stepwise, depth 2, a burst, speculation).

Tolerances: fp32 forward logits and aux loss rtol 1e-4 / atol 1e-5 (the
same arithmetic, sums in another order); trajectories as
tests/test_torch_train_gpt2.py (loss and grad norm rtol 1e-4, final
params atol 1e-4); the serving MoE's real rows rtol 1e-5 / atol 1e-5;
streams token-identical.

The stream tests set ``capacity_factor = eval_capacity_factor =
num_experts / moe_top_k``: capacity is then at least T at every T, so
no choice is ever dropped and the JAX engine's pad-row fault cannot
change a stream.  Drops are covered by the function-level tests here and
in tests/test_torch_moe.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.models.transformer import apply as jax_apply
from deepspeed_tpu.parallel import moe as jmoe
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference import model as port_model
from deepspeed_tpu_torch.models import (Model, TransformerConfig, apply,
                                        params_from_numpy)
from deepspeed_tpu_torch.parallel import moe as tmoe
from tests.test_torch_train import (assert_trajectories_agree,
                                    run_trajectories)

TINY = dict(vocab_size=256, num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, max_seq_len=128)
SPECS = {
    "mixtral": ("mixtral-tiny", dict(TINY, d_ff=96, num_experts=4)),
    "qwen2moe": ("qwen2-moe-tiny", dict(TINY, d_ff=96, moe_shared_ff=128)),
}
ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)


def _pair(name, **over):
    """The JAX model and the port's on the same (noised) fp32 weights."""
    preset, kw = SPECS[name]
    jm = jax_build_model(preset, seed=3, **dict(kw, **over))
    r = np.random.RandomState(7)
    params_np = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * r.randn(*x.shape)).astype(
            np.float32), jm.params)
    jm.params = jax.tree.map(jnp.asarray, params_np)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    return jm, Model.from_params(cfg, params_from_numpy(params_np,
                                                        device="cpu"))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_apply_with_aux_matches_jax(name):
    """Logits and the layers' mean aux loss and dropped fraction (at
    capacity factor 0.5 whole tokens drop)."""
    jm, tm = _pair(name, capacity_factor=0.5)
    ids = np.random.RandomState(2).randint(0, 256, (2, 48))
    jl, jaux = jax_apply(jm.config, jm.params, jnp.asarray(ids),
                         with_aux=True)
    tl, taux = apply(tm.config, tm.params, torch.from_numpy(ids),
                     with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert sorted(taux) == sorted(jaux) == ["moe_aux_loss", "moe_dropped"]
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4, atol=1e-6)
    assert float(jaux["moe_dropped"]) > 0
    np.testing.assert_array_equal(
        apply(tm.config, tm.params, torch.from_numpy(ids)).numpy(),
        tl.numpy())


@pytest.mark.parametrize("name,gas,noise", [("mixtral", 1, None),
                                            ("qwen2moe", 2, "Jitter")])
def test_training_trajectory_matches_jax(name, gas, noise):
    """8 AdamW steps of both engines from the same weights and batches:
    losses (which include the aux loss), grad norms and final params."""
    preset, kw = SPECS[name]
    jtraj, ttraj, jp, tp = run_trajectories(
        name, gas, spec=(preset, dict(kw, noise_policy=noise)),
        attention_impl="xla")
    assert_trajectories_agree(jtraj, ttraj, jp, tp, rtol=1e-4, atol=1e-4)
    assert any("['experts']" in k for k in tp)


def test_engine_reports_the_aux_loss():
    """The port engine's metrics carry ``aux/moe_aux_loss`` (and
    ``aux/moe_dropped``), and its loss includes ``aux_loss_coef`` times
    the aux loss."""
    import deepspeed_tpu_torch as tds
    _, tm = _pair("qwen2moe")
    eng = tds.initialize(model=tm, device="cpu", config={
        "train_micro_batch_size_per_device": 2})
    ids = np.random.RandomState(1).randint(0, 256, (2, 32)).astype(np.int32)
    met = eng.train_batch({"input_ids": ids})
    assert {"aux/moe_aux_loss", "aux/moe_dropped"} <= set(met)
    logits = apply(tm.config, tm.params, torch.from_numpy(ids))
    assert np.isfinite(float(met["loss"])) and logits.shape[-1] == 256


def _jax_engine(jm, quant_tree=None, **over):
    kw = dict(ENGINE, kv_dtype=jnp.float32, param_dtype=jnp.float32,
              attn_impl="xla")
    kw.update(over)
    return JaxEngine(jm, JaxConfig(**kw), quant_tree=quant_tree)


def _port_engine(tm, **over):
    kw = dict(ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(tm, InferenceConfig(**kw))


def _prompts():
    r = np.random.RandomState(0)
    return {1: [int(x) for x in r.randint(1, 256, 12)],
            2: [int(x) for x in r.randint(1, 256, 40)],   # chunked
            3: [int(x) for x in r.randint(1, 256, 5)]}


def _no_drops(name):
    """Capacity at least T everywhere: capacity_factor = E / k."""
    preset, kw = SPECS[name]
    E = kw.get("num_experts") or (4 if name == "qwen2moe" else 8)
    k = 2
    return dict(capacity_factor=E / k, eval_capacity_factor=E / k)


STREAMS = {
    "step": (dict(pipeline_depth=1), dict(pipeline_depth=1)),
    "depth2": (dict(pipeline_depth=2), dict(pipeline_depth=2)),
    "burst": (dict(decode_burst=4), dict(decode_burst=4)),
    "spec": (dict(spec_decode="on", spec_max_draft=3),
             dict(spec_decode="on", spec_max_draft=3)),
}


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("mode", sorted(STREAMS))
def test_greedy_streams_match_jax(name, mode):
    jm, tm = _pair(name, **_no_drops(name))
    jo, po = STREAMS[mode]
    prompts = _prompts()
    if mode == "spec":           # repetitive prompts give drafts to verify
        prompts = {u: (p[:4] * 4)[:len(p)] for u, p in prompts.items()}
    ref = _jax_engine(jm, **jo).generate(
        {u: list(p) for u, p in prompts.items()},
        JaxSampling(max_new_tokens=10))
    got = _port_engine(tm, **po).generate(
        {u: list(p) for u, p in prompts.items()},
        SamplingParams(max_new_tokens=10))
    assert got == ref


@pytest.mark.parametrize("mixed", ["off", "on"])
def test_quantized_qwen2_moe_serving_matches_jax(mixed):
    """int8 weights: the experts and the shared expert are served dense
    (``DENSE_ONLY_GROUPS``); with ``mixed_gemm="on"`` the attention
    projections go through the mixed-input GEMM (its plain version here)
    and the expert weights never do.  The stream equals the JAX
    engine's."""
    jm, tm = _pair("qwen2moe", **_no_drops("qwen2moe"))
    over = dict(weight_quant="int8", mixed_gemm=mixed)
    ref = _jax_engine(jm, **over).generate(_prompts(),
                                           JaxSampling(max_new_tokens=8))
    seen = []
    real = port_model.mixed_matmul

    def spy(x, w, **kw):
        seen.append(tuple(w.shape))
        return real(x, w, **kw)

    port_model.mixed_matmul = spy
    try:
        eng = _port_engine(tm, **over)
        got = eng.generate(_prompts(), SamplingParams(max_new_tokens=8))
    finally:
        port_model.mixed_matmul = real
    assert got == ref
    assert eng._mixed_gemm_active == (mixed == "on")
    c = tm.config
    attn = {(c.d_model, c.num_heads, c.head_dim),
            (c.d_model, c.num_kv_heads, c.head_dim),
            (c.num_heads, c.head_dim, c.d_model)}
    assert bool(seen) == (mixed == "on")
    assert set(seen) <= attn                  # the attention projections


def _all_to_one(name, cf):
    """A model whose gate is zero (every token's top choices are experts
    0, 1, ...: ties break to the first index) at capacity factor cf, with
    no capacity floor (min_capacity 1)."""
    jm, tm = _pair(name, eval_capacity_factor=cf, capacity_factor=cf,
                   min_capacity=1)
    jm.params["blocks"]["gate"]["kernel"] = jnp.zeros_like(
        jm.params["blocks"]["gate"]["kernel"])
    tm.params["blocks"]["gate"]["kernel"].zero_()
    return jm, tm


def test_capacity_rule_takes_the_jax_T_not_the_bucket():
    """Every token routes to expert 0 (then 1).  A step of 12 real tokens
    padded to a 16-token bucket, capacity factor 0.5: capacity from the
    bucket would be 4 and drop 8 tokens; the port takes it from the
    staged batch's 64 rows, the JAX engine's T (capacity 16), and equals
    the JAX ``moe_ffn`` on an unpadded batch of 64 real rows.  The
    engines' greedy streams agree too (a decode step of 3 tokens, bucket
    3, would keep 1 of them with the bucket's capacity)."""
    jm, tm = _all_to_one("qwen2moe", 0.5)
    cfg = tm.config
    lp = {k: {n: v[0] for n, v in g.items()}
          for k, g in tm.params["blocks"].items()}
    jlp = jax.tree.map(lambda a: a[0], jm.params["blocks"])
    r = np.random.RandomState(3)
    h = r.randn(64, cfg.d_model).astype(np.float32)
    act = torch.nn.functional.silu
    valid = torch.arange(16) < 12
    got = port_model._ffn(cfg, lp, torch.from_numpy(h[:16]), torch.float32,
                          act, valid=valid, tokens=64)
    assert tmoe.capacity_for(16, 4, 2, 0.5) == 4 < 12
    bucket = port_model._ffn(cfg, lp, torch.from_numpy(h[:16]),
                             torch.float32, act, valid=valid, tokens=16)
    ref, met = jmoe.moe_ffn(jlp["gate"], jlp["experts"],
                            jnp.asarray(h)[None], top_k=2,
                            capacity_factor=0.5, min_capacity=1,
                            activation=jax.nn.silu, gated=True,
                            norm_topk=False)
    from deepspeed_tpu.models.transformer import _shared_expert
    ref = ref[0] + _shared_expert(jlp["shared"], jnp.asarray(h),
                                  jax.nn.silu, True)
    np.testing.assert_allclose(got[:12].numpy(), np.asarray(ref)[:12],
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(bucket[:12].numpy(), np.asarray(ref)[:12],
                           atol=1e-3)
    jout = _jax_engine(jm, max_seqs=3, token_budget=64).generate(
        _prompts(), JaxSampling(max_new_tokens=6))
    pout = _port_engine(tm, max_seqs=3, token_budget=64).generate(
        _prompts(), SamplingParams(max_new_tokens=6))
    assert pout == jout


def test_pad_rows_take_capacity_in_jax_not_in_the_port():
    """The second reference fault: 8 real rows, with and without 1016
    identical pad rows, at E 60, top-4, capacity factor 2.0 (capacity 137
    at 1024 rows), a decisive gate (x100).  In the JAX ``moe_ffn`` the
    pads fill their experts first, so a real row's later choice that hits
    one is dropped: its real rows differ from the same 8 rows gated alone
    at the same capacity (capacity factor scaled by 1024 / 8).  The
    port's serving MoE, told which rows are real, gives those rows
    exactly, with or without the pads."""
    E, K, dm, ff = 60, 4, 16, 8
    r = np.random.RandomState(SEED_PAD_FAULT)
    gate = {"kernel": (r.randn(dm, E) * 100 / np.sqrt(dm)).astype(
        np.float32)}
    ex = {n: (r.randn(E, *s) * 0.3).astype(np.float32) for n, s in
          (("wi", (dm, ff)), ("wg", (dm, ff)), ("wo", (ff, dm)))}
    x = r.randn(8, dm).astype(np.float32)
    pad = np.repeat(r.randn(1, dm).astype(np.float32), 1016, 0)
    xp = np.concatenate([x, pad])

    def jrun(rows, cf):
        y, _ = jax.jit(lambda g, e, x: jmoe.moe_ffn(
            g, e, x, top_k=K, capacity_factor=cf, gated=True,
            activation=jax.nn.silu, norm_topk=False))(
            jax.tree.map(jnp.asarray, gate), jax.tree.map(jnp.asarray, ex),
            jnp.asarray(rows)[None])
        return np.asarray(y)[0, :8]

    assert jmoe.capacity_for(8, E, K, 2.0 * 1024 / 8) == \
        jmoe.capacity_for(1024, E, K, 2.0) == 137
    j_alone, j_padded = jrun(x, 2.0 * 1024 / 8), jrun(xp, 2.0)
    assert not np.allclose(j_alone, j_padded, atol=1e-4)    # the fault

    def prun(rows):
        valid = torch.arange(rows.shape[0]) < 8
        return tmoe.moe_serving(
            jax.tree.map(torch.from_numpy, gate),
            jax.tree.map(torch.from_numpy, ex), torch.from_numpy(rows),
            valid, 1024, top_k=K, capacity_factor=2.0,
            activation=torch.nn.functional.silu, gated=True,
            norm_topk=False)[:8].numpy()

    p_padded = prun(xp)
    np.testing.assert_array_equal(prun(x), p_padded)
    np.testing.assert_allclose(p_padded, j_alone, rtol=1e-5, atol=1e-5)


# a seed at which the JAX fault shows (seed 2 of 0-7 does)
SEED_PAD_FAULT = 2
