"""ZeRO-Offload and ZeRO-Infinity's NVMe optimizer on the port's engine
(``deepspeed_tpu_torch/runtime/engine.py``), on the CPU, against the JAX
engine (``deepspeed_tpu/runtime/engine.py``) and against the port's own
plain engine.

On the CPU "host" and "device" are one memory: the offload paths run the
same code as on the card (the staging ring, the chunked host update, the
NVMe swap groups), nothing pinned.  Tolerances:
- trajectories against the JAX plain engine over STEPS steps (the
  reference's own offload tests check one step): ZeRO-Offload is the
  port's plain arithmetic, chunk by chunk: loss and grad norm rtol 1e-4,
  final params atol 1e-4, as tests/test_torch_train_gpt2.py; the NVMe
  optimizer is HostAdam's arithmetic (the reference's NVMe path): the
  same bars;
- ZeRO-Offload against the port's plain engine: bitwise (the same
  ``update_leaf`` on the same fp32 values, chunk by chunk).  Every test
  runs on one CPU thread (``one_thread``): the CPU embedding backward sums
  its rows in an order that depends on the thread split, so two plain
  runs on several threads already differ by an ulp;
- checkpoints crossing packages: the fp32 state bitwise, the next steps'
  losses rtol 1e-4.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm import MeshTopology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.runtime.dataloader import \
    synthetic_lm_data as jax_synthetic
from deepspeed_tpu_torch.config.config import ConfigError
from deepspeed_tpu_torch.runtime import engine as engine_mod
from deepspeed_tpu_torch.runtime.runtime_utils import (keep_host_heap,
                                                       tree_leaves)
from tests.test_torch_train import (  # noqa: F401 (one_thread: autouse)
    NULL_GRAD_LEAVES, assert_trajectories_agree, jax_engine, one_thread,
    tiny_models)

STEPS = 8
KEYS = ("loss", "grad_norm", "lr", "loss_scale", "overflow")


def _config(gas=1, zero=None, precision=None, fp16=None):
    cfg = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
           "gradient_clipping": 1.0, "steps_per_print": 1000,
           "mesh": {"data": 1}, "zero_optimization": {"stage": 1,
                                                      **(zero or {})}}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    if fp16 is not None:
        cfg["fp16"] = {"enabled": True, **fp16}
    return cfg


def _cpu(**kw):
    return {"offload_optimizer": {"device": "cpu", "buffer_count": 3,
                                  "buffer_size": 4096, **kw}}


def _nvme(path, **kw):
    return {"stage": 3, "offload_optimizer": {
        "device": "nvme", "nvme_path": str(path), "buffer_size": 60_000,
        **kw}}


def _batches(gas, steps, seed=1):
    n = 2 * gas
    data = jax_synthetic(256, n * steps, 128, seed=seed)["input_ids"]
    return [{"input_ids": data[s * n:(s + 1) * n]} for s in range(steps)]


def _run(engine, batches):
    out = []
    for b in batches:
        m = engine.train_batch(dict(b))
        out.append([float(m[k]) for k in KEYS])
    return np.asarray(out)


def _port_master(engine):
    out = {}

    def walk(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + f"['{k}']")
        else:
            out[pre] = t.detach().float().cpu().numpy()
    master = engine.state.master
    if engine._nvme is not None:
        master = engine._nvme.master_tree()
    walk(master)
    return out


_JAX = {}


def _jax_reference(name, gas=1):
    """The JAX plain engine's trajectory and final master (cached)."""
    if (name, gas) not in _JAX:
        jm, _ = tiny_models(name)
        topo = MeshTopology.build(MeshConfig(data=1),
                                  devices=jax.devices()[:1])
        je = jax_engine(jm, _config(gas), topo)
        traj = _run(je, _batches(gas, STEPS))
        jp = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(je.state.master)[0]}
        _JAX[name, gas] = (traj, jp)
    return _JAX[name, gas]


@pytest.mark.parametrize("mode", ["cpu", "nvme"])
@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_offload_trajectory_matches_jax(tmp_path, name, mode):
    jtraj, jp = _jax_reference(name)
    _, tm = tiny_models(name)
    zero = _cpu() if mode == "cpu" else _nvme(tmp_path)
    te = tds.initialize(model=tm, config=_config(zero=zero), device="cpu")
    assert te.offload_active
    ttraj = _run(te, _batches(1, STEPS))
    assert te.state.step == STEPS
    assert_trajectories_agree(jtraj, ttraj, jp, _port_master(te),
                              rtol=1e-4, atol=1e-4)
    if mode == "nvme":
        assert len(te._nvme.groups) > 1        # the prefetch ran


@pytest.mark.parametrize("span", [None, 100])
def test_offload_runs_the_plain_arithmetic_bitwise(monkeypatch, span):
    """ZeRO-Offload (several ring chunks a leaf, 2 slots; ``span``: each
    chunk updated in spans of that many elements) against the port's
    plain engine: losses, norms, masters and moments bitwise."""
    if span is not None:
        monkeypatch.setattr(engine_mod, "HOST_CHUNK", span)
    _, a = tiny_models("gpt2")
    _, b = tiny_models("gpt2")
    plain = tds.initialize(model=a, config=_config(), device="cpu")
    off = tds.initialize(model=b, config=_config(zero=_cpu(buffer_count=2)),
                         device="cpu")
    batches = _batches(1, 4)
    np.testing.assert_array_equal(_run(off, batches), _run(plain, batches))
    for x, y in zip(tree_leaves(off.state), tree_leaves(plain.state)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    times = off.offload_times
    assert times["d2h_bytes"] == 4 * sum(
        t.numel() for t in tree_leaves(off.state.master))
    assert set(times) >= {"fwd_bwd_s", "d2h_wait_s", "host_update_s"}
    assert keep_host_heap()             # glibc here: the heap is kept


@pytest.mark.parametrize("mode", ["cpu", "nvme"])
def test_fp16_loss_scaler_and_overflow_skip(tmp_path, mode):
    """fp16 with the dynamic loss scaler from 2^24: the first steps
    overflow and are skipped (the state untouched), then the scaled steps
    apply.  The loss-scale and skip sequences equal the plain engine's,
    the losses within rtol 1e-3 (the NVMe path's HostAdam rounds
    differently from the device optimizer)."""
    fp16 = {"initial_scale_power": 24, "loss_scale_window": 2,
            "hysteresis": 1}
    _, a = tiny_models("gpt2")
    _, b = tiny_models("gpt2")
    plain = tds.initialize(model=a, config=_config(fp16=fp16), device="cpu")
    zero = _cpu() if mode == "cpu" else _nvme(tmp_path)
    off = tds.initialize(model=b, config=_config(zero=zero, fp16=fp16),
                         device="cpu")
    batches = _batches(1, 6)
    want, got = _run(plain, batches), _run(off, batches)
    assert want[:, 4].sum() >= 1 and want[:, 4].sum() < len(batches)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-3)
    assert off.state.skipped == plain.state.skipped >= 1
    if mode == "cpu":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["cpu", "nvme"])
def test_gas_2_matches_the_plain_engine(tmp_path, mode):
    """gas 2 (the plain engine's gas-2 trajectory is held against the JAX
    engine by tests/test_torch_train_gpt2.py): ZeRO-Offload bitwise, the
    NVMe optimizer (HostAdam's rounding) within rtol 1e-4 on the loss and
    norm and atol 1e-4 on the master, the zero-gradient leaf left out (as
    in tests/test_torch_train.py)."""
    _, a = tiny_models("gpt2")
    _, b = tiny_models("gpt2")
    plain = tds.initialize(model=a, config=_config(gas=2), device="cpu")
    zero = _cpu() if mode == "cpu" else _nvme(tmp_path)
    off = tds.initialize(model=b, config=_config(gas=2, zero=zero),
                         device="cpu")
    batches = _batches(2, 4)
    got, want = _run(off, batches), _run(plain, batches)
    gm, wm = _port_master(off), _port_master(plain)
    if mode == "cpu":
        np.testing.assert_array_equal(got, want)
        assert all(np.array_equal(gm[k], wm[k]) for k in wm)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)
        for k in set(wm) - set(NULL_GRAD_LEAVES):
            np.testing.assert_allclose(gm[k], wm[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("case,zero,match", [
    ("lamb", _cpu(), "LAMB"),
    ("ratio", _cpu(ratio=0.5), "ratio"),
    ("param_ratio", {"offload_param": {"device": "cpu", "ratio": 0.3}},
     "ratio"),
    ("param_nvme_alone", {"offload_param": {"device": "nvme",
                                            "nvme_path": "/x"}},
     "needs offload_optimizer"),
    ("ring", _cpu(buffer_count=1), "buffer_count"),
    ("device", {"offload_optimizer": {"device": "disk"}}, "expected"),
    ("no_path", {"offload_optimizer": {"device": "nvme"}}, "nvme_path"),
])
def test_refused_settings(case, zero, match):
    _, tm = tiny_models("gpt2")
    cfg = _config(zero=zero)
    if case == "lamb":
        cfg["optimizer"]["type"] = "lamb"
    with pytest.raises(ConfigError, match=match):
        tds.initialize(model=tm, config=cfg, device="cpu")


def test_pin_memory_false_and_param_offload():
    """``pin_memory`` is read (False: pageable, nothing registered; on the
    CPU nothing is ever pinned); ``offload_param=cpu`` keeps the working
    copy in host memory and trains bitwise as the plain engine."""
    _, tm = tiny_models("gpt2")
    e = tds.initialize(model=tm, config=_config(zero=_cpu(
        pin_memory=False)), device="cpu")
    assert not e._pin_state and not e._host_params
    assert all(t.device.type == "cpu" and not t.is_pinned()
               for t in tree_leaves(e.state) if isinstance(t, torch.Tensor))
    _, a = tiny_models("gpt2")
    _, b = tiny_models("gpt2")
    plain = tds.initialize(model=a, config=_config(), device="cpu")
    po = tds.initialize(model=b, config=_config(zero={"offload_param": {
        "device": "cpu"}}), device="cpu")
    assert po._host_params and po._ring_cfg == (5, 100_000_000)
    batches = _batches(1, 3)
    np.testing.assert_array_equal(_run(po, batches), _run(plain, batches))
    assert po.offload_times["h2d_bytes"] == 0        # updated in place
    ids = {"input_ids": batches[0]["input_ids"]}
    assert po.eval_batch(ids) == plain.eval_batch(ids)
    for x, y in zip(tree_leaves(po.compute_params),
                    tree_leaves(plain.compute_params)):
        assert torch.equal(x, y)


def test_no_model_stages_the_working_copy_with_a_warning(tmp_path, caplog):
    """offload_param=nvme without a stacked-layer model: the JAX engine's
    documented mode, warning and all: the working copy in host memory."""
    _, tm = tiny_models("gpt2")
    zero = _nvme(tmp_path)
    zero["offload_param"] = {"device": "nvme", "nvme_path": str(tmp_path)}
    logging.getLogger("deepspeed_tpu_torch").propagate = True
    with caplog.at_level(logging.WARNING):
        e = tds.initialize(loss_fn=tm.loss_fn, params=tm.params,
                           config=_config(zero=zero), device="cpu")
    assert "without a stacked-layer model" in caplog.text
    assert e._stream is None and e._host_params
    m = _run(e, _batches(1, 2))
    assert np.isfinite(m[:, :2]).all() and e.state.step == 2


def _jax_nvme_engine(jm, path):
    topo = MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])
    return jds.initialize(model=jm, config=_config(zero=_nvme(path)),
                          topology=topo)


def test_nvme_checkpoints_cross_both_ways(tmp_path):
    """Port NVMe -> the JAX plain engine, and JAX NVMe -> the port's NVMe
    engine: the fp32 master and moments bitwise, and the next step on the
    other package's trajectory (rtol 1e-4)."""
    jm, tm = tiny_models("gpt2")
    batches = _batches(1, 4)
    # port NVMe, 3 steps, saved
    pe = tds.initialize(model=tm, config=_config(zero=_nvme(
        tmp_path / "swap_p")), device="cpu")
    _run(pe, batches[:3])
    pe.save_checkpoint(str(tmp_path / "ck_p"))
    master, m, v = pe._nvme.state_trees()
    topo = MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])
    je = jds.initialize(model=jm, config=_config(), topology=topo)
    je.load_checkpoint(str(tmp_path / "ck_p"))
    assert int(je.state.step) == 3 and je.global_steps == 3
    for tree, got in ((master, je.state.master), (m, je.state.opt_state.m),
                      (v, je.state.opt_state.v)):
        for a, (path, b) in zip(pe._nvme.flatten(tree),
                                jax.tree_util.tree_flatten_with_path(got)[0]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=str(path))
    np.testing.assert_allclose(_run(je, batches[3:])[:, :2],
                               _run(pe, batches[3:])[:, :2], rtol=1e-4)

    # JAX NVMe, 3 steps, saved; the port's NVMe engine loads it
    jm2, tm2 = tiny_models("gpt2")
    jn = _jax_nvme_engine(jm2, tmp_path / "swap_j")
    _run(jn, batches[:3])
    jn.save_checkpoint(str(tmp_path / "ck_j"))
    pn = tds.initialize(model=tm2, config=_config(zero=_nvme(
        tmp_path / "swap_p2")), device="cpu")
    pn.load_checkpoint(str(tmp_path / "ck_j"))
    assert pn.state.step == 3 and pn.global_steps == 3
    for a, b in zip(pn._nvme.state_trees(), jn._nvme.state_trees()):
        for x, y in zip(pn._nvme.flatten(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # the working copy follows the loaded master
    for w, p in zip(pn._nvme.flatten(pn.state.master),
                    pn._nvme.flatten(pn._nvme.master_tree())):
        assert torch.equal(w, p)
    np.testing.assert_allclose(_run(pn, batches[3:])[:, :2],
                               _run(jn, batches[3:])[:, :2], rtol=1e-4)


def test_offload_checkpoint_fills_host_state_in_place(tmp_path):
    """ZeRO-Offload: save, then a fresh offload engine loads: the master
    and moments land in its own host tensors (the same objects, filled in
    place), bitwise, and the next steps are bitwise the saved engine's;
    the checkpoint also loads into the JAX plain engine."""
    jm, a = tiny_models("gpt2")
    _, b = tiny_models("gpt2")
    for t in tree_leaves(b.params):          # other weights to overwrite
        t.add_(0.5)
    batches = _batches(1, 4)
    ea = tds.initialize(model=a, config=_config(zero=_cpu()), device="cpu")
    _run(ea, batches[:2])
    ea.save_checkpoint(str(tmp_path / "ck"))
    eb = tds.initialize(model=b, config=_config(zero=_cpu()), device="cpu")
    before = [id(t) for t in tree_leaves(eb.state.master)]
    eb.load_checkpoint(str(tmp_path / "ck"))
    assert [id(t) for t in tree_leaves(eb.state.master)] == before
    for x, y in zip(tree_leaves(ea.state), tree_leaves(eb.state)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    np.testing.assert_array_equal(_run(eb, batches[2:]),
                                  _run(ea, batches[2:]))
    topo = MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])
    je = jds.initialize(model=jm, config=_config(), topology=topo)
    je.load_checkpoint(str(tmp_path / "ck"))
    assert int(je.state.step) == 2


def test_async_save_of_nvme_state_is_refused(tmp_path):
    _, tm = tiny_models("gpt2")
    cfg = _config(zero=_nvme(tmp_path / "swap"))
    cfg["checkpoint"] = {"async_save": True}
    e = tds.initialize(model=tm, config=cfg, device="cpu")
    with pytest.raises(ConfigError, match="async_save"):
        e.save_checkpoint(str(tmp_path / "ck"))
    assert e.compute_params is not None

