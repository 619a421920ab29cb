"""The port's data-efficiency suite held against the JAX package on the
same seeded inputs: the curriculum schedules, truncation and sampler, the
random-LTD schedule and token selection (kept indices bitwise), PLD's
theta schedule and layer coins (bitwise), the transformer forward with
PLD and random-LTD, 3-step fp32 engine trajectories with each feature
configured, clean evaluation, MoQ's bit schedule and fake quantization,
and the Hessian eigenvalue (quadratic, tiny GPT-2 under
``attention_impl="xla"``, and the refusal under ``"flash"``).

Tolerances: schedules, indices, coins and host arithmetic exact; forwards
atol 1e-5 (fp32, the same ops in another summation order); trajectory
losses and gradient norms rtol 1e-4, masters atol 5e-5 (5% of the
learning rate over three steps: an element whose gradient is near its
rounding noise moves by up to lr a step in either package, as Adam
normalises it, which the NULL_GRAD_LEAVES note of test_torch_train.py
explains; the other elements agree to ~1e-7); the fake
quantization within one code step (a rounding tie may fall either way
when the two packages' fp32 divisions differ in the last bit); the
eigenvalue rtol 1e-3 (three power iterations of fp32 Hessian-vector
products, forward-over-reverse against a double backward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm import MeshTopology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models.transformer import apply as jax_apply
from deepspeed_tpu.runtime import data_pipeline as jdp
from deepspeed_tpu_torch.models.transformer import (apply, layer_keys,
                                                    pld_drops)
from deepspeed_tpu_torch.runtime import data_pipeline as tdp
from deepspeed_tpu_torch.utils.prng import key_from_numpy
from tests.test_torch_train import (NULL_GRAD_LEAVES, jax_engine,
                                    tiny_models)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

SPEC = ("gpt2", dict(vocab_size=128, num_layers=2, d_model=32, num_heads=4,
                     max_seq_len=64))
LLAMA = ("llama-tiny", dict(vocab_size=128, num_layers=3, d_model=32,
                            num_heads=4, num_kv_heads=2, d_ff=64,
                            max_seq_len=64))


def tkey(seed):
    return key_from_numpy(np.asarray(jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

CURRICULA = {
    "fixed_linear": {"schedule_type": "fixed_linear", "min_difficulty": 8,
                     "max_difficulty": 128, "schedule_config": {
                         "total_curriculum_step": 100,
                         "difficulty_step": 8}},
    "fixed_root": {"schedule_type": "fixed_root", "min_difficulty": 10,
                   "max_difficulty": 100, "schedule_config": {
                       "total_curriculum_step": 100, "difficulty_step": 1,
                       "root_degree": 2}},
    "fixed_discrete": {"schedule_type": "fixed_discrete",
                       "min_difficulty": 2, "max_difficulty": 10,
                       "schedule_config": {"difficulty": [2, 5, 10],
                                           "max_step": [10, 20]}},
}


@pytest.mark.parametrize("kind", sorted(CURRICULA))
def test_curriculum_schedules_equal(kind):
    j = jdp.CurriculumScheduler(CURRICULA[kind])
    t = tdp.CurriculumScheduler(CURRICULA[kind])
    assert [t.get_difficulty(s) for s in range(0, 1200, 7)] == \
        [j.get_difficulty(s) for s in range(0, 1200, 7)]
    assert t.update_difficulty(25) == j.update_difficulty(25)


def test_truncation_sampler_and_small_analyzer():
    batch = {"input_ids": np.arange(4 * 64).reshape(4, 64),
             "labels": np.ones((4, 64), np.int32), "other": np.ones(4)}
    for kw in ({}, {"pad_to": 64}):
        got = tdp.truncate_to_difficulty(batch, 16, **kw)
        want = jdp.truncate_to_difficulty(batch, 16, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    metric = np.random.RandomState(0).permutation(100)
    cfg = {"schedule_type": "fixed_linear", "min_difficulty": 10,
           "max_difficulty": 100,
           "schedule_config": {"total_curriculum_step": 100}}
    ts = tdp.CurriculumDataSampler(metric, tdp.CurriculumScheduler(cfg), 8,
                                   seed=3)
    js = jdp.CurriculumDataSampler(metric, jdp.CurriculumScheduler(cfg), 8,
                                   seed=3)
    for step in (0, 1, 7, 50, 100, 400):
        np.testing.assert_array_equal(ts.batch_indices(step),
                                      js.batch_indices(step))
    assert metric[ts.batch_indices(1)].max() < 12
    np.testing.assert_array_equal(
        tdp.DataAnalyzer(len).run(["ab", "a", "abc"]),
        jdp.DataAnalyzer(len).run(["ab", "a", "abc"]))


def test_ltd_schedule_and_pld_theta_equal():
    from deepspeed_tpu.runtime.progressive_layer_drop import \
        ProgressiveLayerDrop as JPLD
    from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
        ProgressiveLayerDrop as TPLD
    args = dict(total_layers=12, start_tokens=128, max_tokens=512,
                schedule_steps=100, step_size=16)
    j, t = jdp.RandomLTDScheduler(**args), tdp.RandomLTDScheduler(**args)
    assert [t.kept_tokens(s) for s in range(130)] == \
        [j.kept_tokens(s) for s in range(130)]
    jp, tp = JPLD(theta=0.5, gamma=0.01), TPLD(theta=0.5, gamma=0.01)
    assert tp.get_theta() == jp.get_theta() == 1.0
    for s in (0, 3, 100, 10 ** 6):
        assert tp.update_state(s) == jp.update_state(s)
        assert [tp.layer_keep_prob(i, 12) for i in range(12)] == \
            [jp.layer_keep_prob(i, 12) for i in range(12)]
    assert tp.get_state() == jp.get_state()


# ---------------------------------------------------------------------------
# random-LTD selection and PLD coins, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("B,S,keep", [(2, 16, 8), (3, 64, 24), (1, 128, 127)])
def test_ltd_kept_indices_bitwise(seed, B, S, keep):
    x = np.random.RandomState(seed).randn(B, S, 5).astype(np.float32)
    jk = jax.random.PRNGKey(seed)
    jg, jidx = jdp.random_ltd_select(jnp.asarray(x), keep, jk)
    tg, tidx = tdp.random_ltd_select(torch.from_numpy(x), keep, tkey(seed))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    proc = np.asarray(jg) * 2 + 1
    np.testing.assert_array_equal(
        tdp.random_ltd_scatter(torch.from_numpy(x), torch.from_numpy(proc),
                               tidx).numpy(),
        np.asarray(jdp.random_ltd_scatter(jnp.asarray(x), jnp.asarray(proc),
                                          jidx)))


def _jax_coins(num_layers, rng, theta, ltd):
    """The JAX ``apply``'s per-layer drop decisions, drawn as it draws
    them (deepspeed_tpu/models/transformer.py:394-420)."""
    if ltd:
        rng, _ = jax.random.split(rng)
    out = []
    for li, r in enumerate(jax.random.split(rng, num_layers)):
        keep_p = 1.0 - (jnp.float32(li) / num_layers) * (
            1.0 - jnp.float32(theta))
        out.append(bool(jax.random.bernoulli(jax.random.fold_in(r, 1),
                                             1.0 - keep_p)))
    return out


@pytest.mark.parametrize("ltd", [False, True])
def test_pld_layer_coins_bitwise(ltd):
    from deepspeed_tpu_torch.models import TransformerConfig
    cfg = TransformerConfig(num_layers=12, d_model=32, num_heads=4)
    seen = set()
    for seed in range(12):
        for theta in (0.0, 0.37, 0.9):
            _, keys = layer_keys(cfg, tkey(seed), ltd, True)
            got = pld_drops(cfg, keys, theta)
            assert got == _jax_coins(12, jax.random.PRNGKey(seed), theta,
                                     ltd)
            seen.update(got)
    assert seen == {True, False}


# ---------------------------------------------------------------------------
# the forward with PLD / random-LTD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["gpt2", "llama"])
@pytest.mark.parametrize("kw", [dict(pld_theta=0.0), dict(ltd_keep=16),
                                dict(pld_theta=0.3, ltd_keep=8),
                                dict(pld_theta=1.0), dict(ltd_keep=32)],
                         ids=["pld0", "ltd16", "pld_ltd", "pld1", "ltd_all"])
def test_forward_matches_jax(spec, kw):
    jm, tm = tiny_models(spec, attention_impl="xla",
                         spec={"gpt2": SPEC, "llama": LLAMA}[spec])
    ids = np.random.RandomState(0).randint(0, 128, (2, 32))
    base = apply(tm.config, tm.params, torch.from_numpy(ids)).numpy()
    # the JAX forward compiled once for the case (theta is traced)
    jfwd = jax.jit(lambda p, x, r, th: jax_apply(
        jm.config, p, x, rng=r, ltd_keep=kw.get("ltd_keep"),
        pld_theta=th if "pld_theta" in kw else None))
    for seed in range(3):
        want = np.asarray(jfwd(jm.params, jnp.asarray(ids),
                               jax.random.PRNGKey(seed),
                               jnp.float32(kw.get("pld_theta", 0.0))))
        got = apply(tm.config, tm.params, torch.from_numpy(ids),
                    rng=tkey(seed), **kw).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        if kw in (dict(pld_theta=1.0), dict(ltd_keep=32)):
            # theta 1 keeps every layer; keeping every token drops none
            np.testing.assert_array_equal(got, base)
    with pytest.raises(ValueError, match="training rng"):
        apply(tm.config, tm.params, torch.from_numpy(ids), **kw)


# ---------------------------------------------------------------------------
# engine trajectories
# ---------------------------------------------------------------------------

FEATURES = {
    "pld": {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                       "gamma": 0.5}},
    "ltd": {"data_efficiency": {"enabled": True, "data_routing": {
        "enabled": True, "random_ltd": {
            "enabled": True, "min_value": 16, "max_value": 0,
            "require_steps": 4, "seq_per_step": 8}}}},
    "curriculum": {"curriculum_learning": {
        "enabled": True, "min_difficulty": 8, "max_difficulty": 32,
        "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 2,
                            "difficulty_step": 8}}},
    "moq_eig": {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                           "gamma": 0.5},
                "quantize_training": {
                    "enabled": True, "start_bits": 16, "target_bits": 4,
                    "quantize_period": 2,
                    "eigenvalue": {"enabled": True, "max_iter": 2}}},
}


def _engines(feature):
    # the eigenvalue's case at 1 layer: the JAX power iteration runs its
    # Hessian-vector products op by op
    spec = (("gpt2", {**SPEC[1], "num_layers": 1}) if feature == "moq_eig"
            else SPEC)
    jm, tm = tiny_models("gpt2", attention_impl="xla", spec=spec)
    config = {"train_batch_size": 4,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "steps_per_print": 1000,
              "mesh": {"data": 1}, **FEATURES[feature]}
    topo = MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])
    je = jax_engine(jm, config, topo)
    if feature == "moq_eig":
        # the JAX power iteration differentiates the loss op by op; under
        # jit each Hessian-vector product is one compiled program (the
        # same functions)
        je.loss_fn = jax.jit(je.loss_fn)
    return je, tds.initialize(model=tm, config=dict(config), device="cpu")


def _state(eng):
    return (getattr(eng, "_ltd_keep", None), eng.pld and eng.pld.current_theta,
            getattr(eng, "_moq_bits", None))


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_three_step_trajectories_match_jax(feature):
    je, te = _engines(feature)
    data = np.random.RandomState(1).randint(
        0, 128, (12, 16 if feature == "moq_eig" else 32))
    for s in range(3):
        batch = {"input_ids": data[4 * s:4 * s + 4]}
        jm = je.train_batch(dict(batch))
        tm = te.train_batch(dict(batch))
        assert _state(te) == _state(je), s
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} @ {s}")
    jp = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
          jax.tree_util.tree_flatten_with_path(je.state.master)[0]}

    def walk(t, pre=""):
        for k, v in t.items():
            yield from (walk(v, pre + f"['{k}']") if isinstance(v, dict)
                        else [(pre + f"['{k}']", v.numpy())])
    tp = dict(walk(te.state.master))
    assert sorted(tp) == sorted(jp)
    for key in jp:
        if key not in NULL_GRAD_LEAVES:
            np.testing.assert_allclose(tp[key], jp[key], atol=5e-5,
                                       err_msg=key)
    if feature == "moq_eig":
        assert te._moq_eig0 is not None and len(te.eigenvalue_seconds) == 1
        np.testing.assert_allclose(te._moq_eig0, je._moq_eig0, rtol=1e-3)
    if feature in ("pld", "ltd"):
        # evaluation runs the clean forward, deterministic, as JAX's
        ev = {"input_ids": data[:4]}
        a, b = float(te.eval_batch(dict(ev))), float(te.eval_batch(dict(ev)))
        assert a == b
        np.testing.assert_allclose(a, float(je.eval_batch(dict(ev))),
                                   rtol=1e-5)


def test_metric_curriculum_and_config_errors(tmp_path):
    from deepspeed_tpu.runtime.data_analyzer import DataAnalyzer
    from deepspeed_tpu_torch.config.config import ConfigError
    r = np.random.RandomState(0)
    ids = r.randint(0, 64, (64, 32))
    for i in range(64):
        k = int(i / 63 * 32)
        ids[i, :k] = r.randint(64, 128, k)
    DataAnalyzer([{"input_ids": x} for x in ids], {"rare": lambda s: float(
        (s["input_ids"] >= 64).mean())}, str(tmp_path)).run()
    cl = {"enabled": True, "curriculum_type": "rare",
          "data_analyzer_path": str(tmp_path), "min_difficulty": 0,
          "max_difficulty": 1, "schedule_type": "fixed_discrete",
          "schedule_config": {"difficulty": [0, 1], "max_step": [3]}}
    jm, tm = tiny_models("gpt2", attention_impl="xla", spec=SPEC)
    cfg = {"train_micro_batch_size_per_device": 4, "mesh": {"data": 1},
           "curriculum_learning": cl}
    te = tds.initialize(model=tm, config=dict(cfg), device="cpu")
    je = jds.initialize(model=jm, config=dict(cfg), topology=MeshTopology
                        .build(MeshConfig(data=1), devices=jax.devices()[:1]))
    assert te.curriculum is None and te.curriculum_sampler is not None
    tb = list(te.curriculum_dataloader({"input_ids": ids}))
    jb = list(je.curriculum_dataloader({"input_ids": ids}))
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    assert (tb[0]["input_ids"] >= 64).mean() < 0.25
    assert np.isfinite(float(te.train_batch(tb[0])["loss"]))
    for bad, match in (({"curriculum_type": "vocabularyrarity",
                         "data_analyzer_path": ""}, "data_analyzer_path"),
                       ({"curriculum_type": "nosuchmetric"},
                        "analyzer index")):
        with pytest.raises(ConfigError, match=match):
            tds.initialize(model=tm, device="cpu", config={
                **cfg, "curriculum_learning": {**cl, **bad}})
    with pytest.raises(ConfigError, match="model="):
        tds.initialize(loss_fn=lambda p, b, r: (p["w"] ** 2).sum(),
                       params={"w": torch.ones(4)}, device="cpu",
                       config={"train_micro_batch_size_per_device": 1,
                               "progressive_layer_drop": {"enabled": True}})
    with pytest.raises(ConfigError, match="curriculum_dataloader"):
        tds.initialize(model=tm, device="cpu", config={
            "train_micro_batch_size_per_device": 4}).curriculum_dataloader(
                {"input_ids": ids})


# ---------------------------------------------------------------------------
# MoQ and the eigenvalue
# ---------------------------------------------------------------------------

def test_moq_bits_and_quantize():
    """The bit schedule, and ``Quantizer.quantize`` at the schedule's bits
    (its fake quantization is ``compression.weight_quantization``, held
    against the JAX one in tests/test_torch_compress.py)."""
    from deepspeed_tpu.runtime.quantize import Quantizer as JQ
    from deepspeed_tpu_torch.compression.compress import \
        weight_quantization as twq
    from deepspeed_tpu_torch.runtime.quantize import Quantizer as TQ
    for args in ((16, 8, 10), (16, 4, 3), (16, 6, 2), (8, 8, 1)):
        j, t = JQ(*args), TQ(*args)
        assert t.target_bits == j.target_bits
        assert [t.current_bits(s) for s in range(40)] == \
            [j.current_bits(s) for s in range(40)]
    w = np.random.RandomState(0).randn(32, 48).astype(np.float32)
    q = TQ(16, 4, 10, q_groups=4)
    out = q.quantize({"w": torch.from_numpy(w), "b": torch.ones(3)}, step=50)
    assert q.qsteps == 51 and torch.equal(out["b"], torch.ones(3))
    assert torch.equal(out["w"], twq(torch.from_numpy(w), 4, 4))
    assert not np.array_equal(out["w"].numpy(), w)
    same = TQ(16, 8, 10).quantize({"w": torch.from_numpy(w)}, step=5)
    assert np.array_equal(same["w"].numpy(), w)       # 16 bits: untouched


def test_eigenvalue_quadratic():
    from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JE
    from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue as TE
    d = np.array([1.0, 5.0, 2.0], np.float32)
    eig, vec = TE(max_iter=200, tol=1e-4).compute_eigenvalue(
        lambda p: 0.5 * (torch.from_numpy(d) * p["x"] ** 2).sum(),
        {"x": torch.ones(3)}, tkey(0))
    jeig, _ = JE(max_iter=200, tol=1e-4).compute_eigenvalue(
        lambda p: 0.5 * jnp.sum(d * p["x"] ** 2), {"x": jnp.ones(3)},
        jax.random.PRNGKey(0))
    assert abs(eig - 5.0) < 0.05
    np.testing.assert_allclose(eig, jeig, rtol=1e-5)
    assert vec["x"].shape == (3,)

    # the tiny GPT-2 (attention_impl="xla") is the engine's eigenvalue in
    # test_three_step_trajectories_match_jax[moq_eig]


def test_eigenvalue_under_flash_raises_in_both():
    """Forward-over-reverse through the JAX flash attention differentiates
    its custom_vjp's backward, whose Pallas kernels have no JVP rule: an
    AssertionError inside pallas_call.  The port's hvp loss refuses the
    flash kernels before it starts, saying why."""
    from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JE
    from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue as TE
    jm, tm = tiny_models("gpt2", attention_impl="flash", spec=(
        "gpt2", {**SPEC[1], "num_layers": 1}))
    ids = np.random.RandomState(4).randint(0, 128, (2, 64))
    with pytest.raises(AssertionError):
        JE(max_iter=1).compute_eigenvalue(
            lambda p: jm.loss_fn(p, {"input_ids": jnp.asarray(ids)},
                                 jax.random.PRNGKey(0)),
            jm.params, jax.random.PRNGKey(1))
    with pytest.raises(TypeError, match="attention_impl='flash'.*no "
                       "derivative"):
        TE(max_iter=1).compute_eigenvalue(
            lambda p: tm.loss_fn.hvp_loss(p, {"input_ids": torch.from_numpy(
                ids)}, tkey(0)), tm.params, tkey(1))
