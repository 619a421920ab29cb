"""The port's training pieces held against the JAX package on the same
numpy inputs: every optimizer (three updates on a random tree), every
learning-rate schedule, the dynamic loss scaler, ``clip_by_global_norm``,
``rolled_lm_targets`` and ``cross_entropy_loss`` (value and gradient),
the forward split (``forward`` with autograd, ``apply`` without), the
unported engine features raising ``NotImplementedError``, and the
engine-trajectory helper that tests/test_torch_train_gpt2.py and
tests/test_torch_train_llama.py run.

Tolerances: fp32 rtol 1e-5 where the arithmetic is the same (the port
takes the schedules and bias corrections in float64 on the host, the JAX
package in float32); 1e-4 for losses and gradients of the LM loss (sums
over the vocabulary in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm import MeshTopology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.config.config import FP16Config as JaxFP16
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.models.transformer import apply as jax_apply
from deepspeed_tpu.models.transformer import \
    cross_entropy_loss as jax_cross_entropy
from deepspeed_tpu.models.transformer import \
    rolled_lm_targets as jax_rolled_targets
from deepspeed_tpu.runtime import loss_scaler as jax_ls
from deepspeed_tpu.runtime.dataloader import \
    synthetic_lm_data as jax_synthetic
from deepspeed_tpu.runtime.lr_schedules import \
    build_schedule as jax_build_schedule
from deepspeed_tpu.runtime.optimizers import \
    build_optimizer as jax_build_optimizer
from deepspeed_tpu.runtime.runtime_utils import \
    clip_by_global_norm as jax_clip
from deepspeed_tpu_torch.config.config import FP16Config
from deepspeed_tpu_torch.models import Model, TransformerConfig, apply
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.models.transformer import (cross_entropy_loss,
                                                    forward,
                                                    rolled_lm_targets)
from deepspeed_tpu_torch.runtime import (DataLoader, PrefetchingLoader,
                                         synthetic_lm_data)
from deepspeed_tpu_torch.runtime.loss_scaler import LossScaler
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.runtime_utils import (clip_by_global_norm,
                                                       tree_leaves)


def _tree(seed):
    r = np.random.RandomState(seed)
    return {"w": r.randn(6, 5).astype(np.float32),
            "blk": {"b": r.randn(5).astype(np.float32),
                    "s": (r.randn(2, 3, 4) * 1e-3).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves_np(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# optimizers, schedules, scaler, clipping
# ---------------------------------------------------------------------------

OPTIMIZER_CASES = {
    "adamw": {"lr": 1e-2, "weight_decay": 0.1},
    "adam": {"lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.99]},
    "lion": {"lr": 1e-3, "weight_decay": 0.1},
    "lamb": {"lr": 1e-2, "weight_decay": 0.01},
    "adagrad": {"lr": 1e-1, "weight_decay": 0.01},
    "sgd": {"lr": 1e-1, "momentum": 0.9, "nesterov": True},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_jax(name):
    """Three updates with a warmup schedule from the same params and
    grads: the deltas and the moments agree."""
    cfg = OPTIMIZER_CASES[name]
    sched = {"warmup_min_lr": 0.0, "warmup_max_lr": cfg["lr"],
             "warmup_num_steps": 4, "warmup_type": "linear"}
    jopt = jax_build_optimizer(name, jax_build_schedule("WarmupLR", sched),
                               cfg)
    topt = build_optimizer(name, build_schedule("WarmupLR", sched), cfg)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _to_torch(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in (1, 2, 3):
        g = _tree(step)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.asarray(step, jnp.int32))
        tu, ts = topt.update(_to_torch(g), ts, tp, step)
        for a, b in zip(jax.tree.leaves(ju), _leaves_np(tu)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                       atol=1e-8)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)
    for a, b in zip(jax.tree.leaves(js), _leaves_np(ts)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-8)


def test_onebit_optimizers_raise():
    for name in ("onebitadam", "zerooneadam", "onebitlamb"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            build_optimizer(name, 1e-3, {})


SCHEDULE_CASES = {
    "Constant": {"lr": 3e-4},
    "LRRangeTest": {"lr_range_test_min_lr": 1e-4,
                    "lr_range_test_step_size": 7,
                    "lr_range_test_staircase": True},
    "OneCycle": {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                 "cycle_first_step_size": 10, "cycle_second_step_size": 6,
                 "decay_step_size": 5, "decay_lr_rate": 0.5},
    "WarmupLR": {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                 "warmup_num_steps": 12},
    "WarmupDecayLR": {"total_num_steps": 30, "warmup_num_steps": 8,
                      "warmup_type": "linear"},
    "WarmupCosineLR": {"total_num_steps": 30, "warmup_num_steps": 5,
                       "warmup_min_ratio": 0.1, "lr": 2e-3},
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_CASES))
def test_schedule_matches_jax(name):
    jf = jax_build_schedule(name, SCHEDULE_CASES[name])
    tf = build_schedule(name, SCHEDULE_CASES[name])
    for step in range(0, 40):
        np.testing.assert_allclose(
            tf(float(step)), float(jf(jnp.float32(step))), rtol=1e-5,
            atol=1e-12, err_msg=f"step {step}")


@pytest.mark.parametrize("consecutive", [False, True])
def test_loss_scaler_matches_jax(consecutive):
    kw = dict(enabled=True, initial_scale_power=4, loss_scale_window=3,
              hysteresis=2, min_loss_scale=2.0,
              consecutive_hysteresis=consecutive)
    js_ = jax_ls.LossScaler.from_config(JaxFP16(**kw))
    ts_ = LossScaler.from_config(FP16Config(**kw))
    jst, tst = js_.init(), ts_.init()
    overflows = [0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 1, 1]
    for o in overflows:
        jst = js_.update(jst, jnp.asarray(bool(o)))
        tst = ts_.update(tst, bool(o))
        assert (tst.scale, tst.good_steps, tst.hysteresis) == (
            float(jst.scale), int(jst.good_steps), int(jst.hysteresis))


def test_all_finite_and_static_scaler():
    from deepspeed_tpu_torch.runtime import all_finite
    t = _to_torch(_tree(0))
    assert bool(all_finite(t))
    t["blk"]["b"][1] = float("inf")
    assert not bool(all_finite(t))
    st = LossScaler.from_config(FP16Config()).init()
    assert LossScaler.from_config(FP16Config()).update(st, True) == st


@pytest.mark.parametrize("max_norm", [0.0, 0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(9)
    jc, jn = jax_clip(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jc), _leaves_np(tc)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6)


# ---------------------------------------------------------------------------
# the LM loss and the forward split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
def test_lm_targets_and_cross_entropy_match_jax(with_mask):
    r = np.random.RandomState(3)
    ids = r.randint(0, 50, (3, 9))
    logits = r.randn(3, 9, 50).astype(np.float32) * 3
    mask = None
    if with_mask:
        mask = np.ones((3, 9), np.int64)
        mask[1, 5:] = 0
    jl, jm = jax_rolled_targets(jnp.asarray(ids),
                                None if mask is None else jnp.asarray(mask))
    tl, tm = rolled_lm_targets(torch.from_numpy(ids),
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    def jloss(x):
        return jax_cross_entropy(x, jl, jm)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tv = cross_entropy_loss(x, tl, tm)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-6)
    # without a mask it is the plain mean over every position
    ju = jax_cross_entropy(jnp.asarray(logits), jl)
    np.testing.assert_allclose(float(cross_entropy_loss(
        torch.from_numpy(logits), tl)), float(ju), rtol=1e-5)


def test_cross_entropy_bf16_keeps_logits_dtype():
    """bf16 logits: the loss is fp32 and the gradient comes back in bf16
    (the saved tensors are the bf16 logits and the fp32 LSE)."""
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(2, 5, 300).astype(np.float32)).to(
        torch.bfloat16).requires_grad_()
    labels = torch.from_numpy(r.randint(0, 300, (2, 5)))
    loss = cross_entropy_loss(x, labels)
    assert loss.dtype == torch.float32
    loss.backward()
    assert x.grad.dtype == torch.bfloat16
    ref = torch.nn.functional.cross_entropy(x.detach().float().reshape(
        -1, 300), labels.reshape(-1))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)


TINY = {
    "gpt2": ("gpt2", dict(vocab_size=256, num_layers=2, d_model=128,
                          num_heads=4, max_seq_len=128)),
    "llama": ("llama-tiny", dict(vocab_size=256, num_layers=2, d_model=128,
                                 num_heads=4, num_kv_heads=2, d_ff=256,
                                 max_seq_len=128)),
}


def tiny_models(name, attention_impl="flash", spec=None, **extra):
    """The JAX model and the port's, on the same (noised) weights.
    ``spec``: a (preset, overrides) pair in place of ``TINY[name]``."""
    preset, over = spec or TINY[name]
    jm = jax_build_model(preset, seed=3, attention_impl=attention_impl,
                         **over, **extra)
    r = np.random.RandomState(7)
    params_np = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * r.randn(*x.shape)).astype(
            np.float32), jm.params)
    jm.params = jax.tree.map(jnp.asarray, params_np)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    tm = Model.from_params(cfg, params_from_numpy(params_np, device="cpu"))
    return jm, tm


@pytest.mark.parametrize("name", sorted(TINY))
def test_apply_is_the_no_grad_forward_and_matches_jax(name):
    """The serving path's ``apply`` is unchanged by the split: it matches
    the JAX ``apply`` and builds no graph; ``forward`` gives the same
    logits with autograd."""
    jm, tm = tiny_models(name)
    ids = np.random.RandomState(2).randint(0, 256, (2, 24))
    ref = jax_apply(jm.config, jm.params, jnp.asarray(ids))
    params = jax.tree.map(lambda t: t.requires_grad_(), tm.params)
    got = apply(tm.config, params, torch.from_numpy(ids))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    fwd = forward(tm.config, params, torch.from_numpy(ids))
    assert fwd.requires_grad
    np.testing.assert_array_equal(fwd.detach().numpy(), got.numpy())


@pytest.mark.parametrize("name", sorted(TINY))
def test_lm_loss_and_grads_match_jax(name):
    """``Model.loss_fn`` (flash attention, the plain versions on the CPU)
    and its gradients against the JAX model's loss under ``jax.grad``;
    with remat the gradients are the same."""
    jm, tm = tiny_models(name)
    ids = np.random.RandomState(5).randint(0, 256, (2, 128))
    jl, jg = jax.value_and_grad(jm.loss_fn)(
        jm.params, {"input_ids": jnp.asarray(ids)}, jax.random.PRNGKey(0))
    remat = Model.from_params(
        dataclasses.replace(tm.config, remat=True, remat_policy="everything"),
        tm.params)
    for model in (tm, remat):
        params = jax.tree.map(lambda t: t.detach().requires_grad_(),
                              model.params)
        loss = model.loss_fn(params, {"input_ids": torch.from_numpy(ids)})
        grads = torch.autograd.grad(loss, tree_leaves(params))
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        for a, b in zip(jax.tree.leaves(jg), grads):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                       rtol=1e-4)


def test_attention_impl_mapping_and_unported_remat():
    from deepspeed_tpu_torch.models.layers import causal_attention
    from deepspeed_tpu_torch.ops import flash_attention
    _, tm = tiny_models("gpt2")
    assert tm.attention_fn is flash_attention
    for impl in ("xla", "xla_flash"):
        m = Model.from_params(dataclasses.replace(
            tm.config, attention_impl=impl), tm.params)
        assert m.attention_fn.func is causal_attention
    with pytest.raises(ValueError, match="attn_scale"):
        Model.from_params(dataclasses.replace(tm.config, attn_scale=1.0),
                          tm.params)
    # the selective remat policies run (tests/test_torch_remat.py holds
    # them bitwise against no remat and counts what they recompute)
    batch = {"input_ids": torch.zeros(1, 8, dtype=torch.long)}
    ref = tm.loss_fn(tm.params, batch)
    for policy in ("dots", "dots_no_batch", "flash", "xla_flash"):
        m = Model.from_params(dataclasses.replace(
            tm.config, remat=True, remat_policy=policy), tm.params)
        torch.testing.assert_close(m.loss_fn(m.params, batch), ref)
    with pytest.raises(ValueError, match="remat_policy"):
        Model.from_params(dataclasses.replace(
            tm.config, remat=True, remat_policy="bogus"), tm.params).loss_fn(
                tm.params, batch)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_data_and_loader_match_jax():
    t = synthetic_lm_data(100, 12, 16, seed=4)
    j = jax_synthetic(100, 12, 16, seed=4)
    np.testing.assert_array_equal(t["input_ids"], j["input_ids"])
    from deepspeed_tpu.runtime.dataloader import DataLoader as JaxLoader
    got = [b["input_ids"] for b in DataLoader(t, 4, seed=2)]
    ref = [b["input_ids"] for b in JaxLoader(j, 4, seed=2)]
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_prefetching_loader_stages_for_the_engine():
    _, tm = tiny_models("gpt2")
    eng = tds.initialize(model=tm, device="cpu", config={
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        "steps_per_print": 1000})
    data = synthetic_lm_data(256, 12, 128, seed=0)
    staged = list(PrefetchingLoader(DataLoader(data, 4, shuffle=False), eng))
    assert len(staged) == 3
    assert tuple(staged[0]["input_ids"].shape) == (2, 2, 128)
    np.testing.assert_array_equal(
        staged[2]["input_ids"].reshape(4, 128).numpy(),
        data["input_ids"][8:12])
    with pytest.raises(ValueError, match="staged"):
        eng.shard_batch(staged[0], accumulate=False)
    m = eng.train_batch(staged[0])
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(eng.eval_batch({"input_ids": data["input_ids"][:2]}))


# ---------------------------------------------------------------------------
# the engine: what is not ported raises
# ---------------------------------------------------------------------------

UNPORTED = {
    "dp": ({"mesh": {"data": 2}}, "item 6"),
    "fsdp": ({"mesh": {"fsdp": 2}}, "item 6"),
    "tensor": ({"tensor_parallel": {"size": 2}}, "item 6"),
    "pipeline": ({"pipeline": {"stages": 2}}, "item 6"),
    "sequence": ({"sequence_parallel": {"size": 2}}, "item 6"),
    "offload": ({"zero_optimization": {"stage": 1, "offload_optimizer": {
        "device": "cpu"}}}, "item 6"),
    "nvme": ({"zero_optimization": {"stage": 3, "offload_param": {
        "device": "nvme"}}}, "item 6"),
    "onebit": ({"optimizer": {"type": "onebitadam", "params": {}}},
               "item 6"),
    "qgz": ({"zero_optimization": {"zero_quantized_gradients": True}},
            "item 6"),
    "qwz": ({"zero_optimization": {"zero_quantized_weights": True}},
            "item 6"),
    "comm_overlap": ({"comm": {"overlap": True}}, "item 6"),
    "sparse_grads": ({"sparse_gradients": True}, "item 6"),
    "pld": ({"progressive_layer_drop": {"enabled": True}}, "item 7"),
    "curriculum": ({"curriculum_learning": {"enabled": True}}, "item 7"),
    "random_ltd": ({"data_efficiency": {"enabled": True}}, "item 7"),
    "moq": ({"quantize_training": {"enabled": True}}, "item 7"),
    "flops_profiler": ({"flops_profiler": {"enabled": True}}, "item 7"),
    "telemetry": ({"telemetry": {"trace": True}}, "item 5"),
    "monitor": ({"csv_monitor": {"enabled": True}}, "item 5"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_engine_features_raise(case):
    extra, item = UNPORTED[case]
    _, tm = tiny_models("gpt2")
    with pytest.raises(NotImplementedError, match=item):
        tds.initialize(model=tm, device="cpu", config={
            "train_micro_batch_size_per_device": 2, **extra})


def test_engine_runs_on_the_card_unless_asked(monkeypatch):
    from deepspeed_tpu_torch.platform.cuda import NoCudaDeviceError
    _, tm = tiny_models("gpt2")
    eng = tds.initialize(model=tm, device="cpu", config={
        "train_micro_batch_size_per_device": 2, "zero_optimization": {
            "stage": 3}})
    with pytest.raises(NotImplementedError, match="checkpoints"):
        eng.save_checkpoint("unused")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        tds.initialize(model=tm, config={
            "train_micro_batch_size_per_device": 2})


# ---------------------------------------------------------------------------
# engine trajectories (run by test_torch_train_gpt2.py / _llama.py)
# ---------------------------------------------------------------------------

STEPS = 8


def run_trajectories(name, gas, bf16=False, steps=STEPS,
                     attention_impl="flash", spec=None, fp16=None):
    """The JAX engine and the port's (``device="cpu"``) from the same
    weights on the same ``synthetic_lm_data`` batches, ``attention_impl``
    (default "flash"), AdamW at bench.py's lr 3e-4, clip 1.0; ``fp16``
    (the fp16 config's fields besides ``enabled``) trains in fp16 with the
    loss scaler.  Returns per-step (loss, grad_norm, lr, loss_scale,
    overflow) of both and both final masters as numpy lists.  ``spec`` as
    in :func:`tiny_models`."""
    jm, tm = tiny_models(name, attention_impl=attention_impl, spec=spec)
    config = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
              "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
              "gradient_clipping": 1.0, "steps_per_print": 1000,
              "mesh": {"data": 1}}
    if bf16:
        config["bf16"] = {"enabled": True}
    if fp16 is not None:
        config["fp16"] = {"enabled": True, **fp16}
    # one JAX device (the test suite's virtual CPU mesh has eight)
    topo = MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])
    je = jds.initialize(model=jm, config=dict(config), topology=topo)
    te = tds.initialize(model=tm, config=dict(config), device="cpu")
    n = 2 * gas
    data = synthetic_lm_data(256, n * steps, 128, seed=1)["input_ids"]
    jtraj, ttraj = [], []
    for s in range(steps):
        batch = {"input_ids": data[s * n:(s + 1) * n]}
        jmet = je.train_batch(dict(batch))
        tmet = te.train_batch(dict(batch))
        keys = ("loss", "grad_norm", "lr", "loss_scale", "overflow")
        jtraj.append([float(jmet[k]) for k in keys])
        ttraj.append([float(tmet[k]) for k in keys])
    jp = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
          jax.tree_util.tree_flatten_with_path(je.state.master)[0]}
    tp = {}

    def walk(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + f"['{k}']")
        else:
            tp[pre] = t.numpy()

    walk(te.state.master)
    assert te.state.step == int(je.state.step)
    assert te.state.step == steps - int(sum(row[4] for row in ttraj))
    return np.asarray(jtraj), np.asarray(ttraj), jp, tp


# The gradient of the attention's key bias is identically zero in exact
# arithmetic (a bias on every key adds q.b, the same for every key of a
# query, which the softmax cancels), so its computed gradient is rounding
# noise that Adam normalises into +-lr steps of arbitrary sign on both
# sides.  The final-parameter comparison leaves that one leaf out.
NULL_GRAD_LEAVES = ("['blocks']['attn']['bk']",)


def assert_trajectories_agree(jtraj, ttraj, jp, tp, rtol, atol):
    np.testing.assert_allclose(ttraj[:, 0], jtraj[:, 0], rtol=rtol,
                               err_msg="loss")
    np.testing.assert_allclose(ttraj[:, 1], jtraj[:, 1], rtol=rtol,
                               err_msg="grad_norm")
    np.testing.assert_allclose(ttraj[:, 2], jtraj[:, 2], rtol=1e-6,
                               err_msg="lr")
    assert sorted(jp) == sorted(tp)
    for key in jp:
        if key in NULL_GRAD_LEAVES:
            continue
        np.testing.assert_allclose(tp[key], jp[key], atol=atol, err_msg=key)
