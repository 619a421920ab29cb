"""The port's checkpoints (``deepspeed_tpu_torch.checkpoint.engine``) in
the JAX package's fragment format, held against the JAX package: leaf
round trips, the leaf keys (``jax.tree_util.keystr`` of the JAX
``TrainState``), checkpoints crossing between the two engines in both
directions with the training after them following the other engine's
trajectory, a checkpoint the JAX engine saved on the 8-device fsdp mesh,
``latest``, the async saver, ``consolidate``, the fp16 loss-scaler state
and bf16 moments (which the JAX reader cannot load back; the port can).

Tolerances: round trips and carried state are bitwise.  Trajectories
after a resume: fp32 loss and grad norm rtol 1e-4, final params atol 1e-4
(the engines' arithmetic is the same, sums in another order:
tests/test_torch_train_gpt2.py); fp16 loss rtol 2e-3 (fp16 activations
rounded at different places)."""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.checkpoint import engine as jck
from deepspeed_tpu.comm import MeshTopology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.checkpoint import engine as ck
from deepspeed_tpu_torch.models import Model, TransformerConfig
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.runtime.runtime_utils import tree_leaves
from tests.test_torch_train import jax_engine

SEQ = 32
VOCAB = 256
GPT2 = ("gpt2", dict(vocab_size=VOCAB, num_layers=2, d_model=64,
                     num_heads=4, max_seq_len=SEQ))
PHI = ("phi-tiny", dict(vocab_size=VOCAB, num_layers=2, d_model=64,
                        num_heads=4, max_seq_len=SEQ))


def _models(spec, seed=3):
    """The JAX model and the port's on the same weights (seed-noised)."""
    preset, over = spec
    jm = jax_build_model(preset, seed=seed, attention_impl="flash", **over)
    r = np.random.RandomState(seed + 4)
    params_np = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * r.randn(*x.shape)).astype(
            np.float32), jm.params)
    jm.params = jax.tree.map(jnp.asarray, params_np)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    return jm, Model.from_params(cfg, params_from_numpy(params_np,
                                                        device="cpu"))


def _config(**extra):
    return {"train_batch_size": 2, "steps_per_print": 1000,
            "optimizer": {"type": "adamw", "params": {"lr": 3e-3}},
            "gradient_clipping": 1.0, "mesh": {"data": 1}, **extra}


def _one_device():
    return MeshTopology.build(MeshConfig(data=1), devices=jax.devices()[:1])


def _batches(n, seed=1):
    r = np.random.RandomState(seed)
    return [{"input_ids": r.randint(0, VOCAB, (2, SEQ)).astype(np.int32)}
            for _ in range(n)]


def _jax_state(je):
    return {k: np.asarray(v) for k, v in jck._leaf_paths(je.state)}


def _port_state(te):
    out = {}
    for k, v in ck._leaf_paths(te.state):
        if isinstance(v, torch.Tensor):
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _metrics(met):
    return [float(met[k]) for k in ("loss", "grad_norm")]


# ---------------------------------------------------------------------------
# fragments and keys
# ---------------------------------------------------------------------------

LEAVES = {
    "fp32": lambda g: torch.randn(3, 5, generator=g),
    "bf16": lambda g: torch.randn(4, 6, generator=g).to(torch.bfloat16),
    "int32": lambda g: torch.randint(-9, 9, (7,), generator=g,
                                     dtype=torch.int32),
    "scalar": lambda g: 5,
}


@pytest.mark.parametrize("kind", sorted(LEAVES))
def test_fragment_round_trip(kind, tmp_path):
    """A leaf saved and loaded back is bitwise the same; the fragment's
    bytes are what the JAX package's ``np.save`` writes for the same
    values (bf16: ``'<V2'`` words, as of an ``ml_dtypes`` array)."""
    leaf = LEAVES[kind](torch.Generator().manual_seed(0))
    ck.save_tree({"x": leaf}, str(tmp_path / "t"))
    man = json.loads((tmp_path / "t" / "manifest.json").read_text())
    entry = man["leaves"]["['x']"]
    back, _ = ck.load_tree({"x": leaf}, None, str(tmp_path / "t"))
    if isinstance(leaf, torch.Tensor):
        assert back["x"].dtype == leaf.dtype
        assert torch.equal(back["x"].view(torch.uint8),
                           leaf.view(torch.uint8))
        ref = (leaf.float().numpy().astype(ml_dtypes.bfloat16)
               if leaf.dtype == torch.bfloat16 else leaf.numpy())
    else:
        assert back["x"] == leaf and type(back["x"]) is int
        ref = jnp.asarray(leaf)           # the JAX engine's int32 scalar
        assert entry["dtype"] == "int32" and entry["shape"] == []
    np.save(str(tmp_path / "ref.npy"), np.asarray(ref))
    got = (tmp_path / "t" / entry["fragments"][0]["file"]).read_bytes()
    assert got == (tmp_path / "ref.npy").read_bytes()


def test_keys_and_treedef_are_the_jax_engines(tmp_path):
    """The manifest's leaf keys, their order and the treedef string equal
    those of the JAX engine's ``TrainState`` for the same model, and each
    leaf's shape and dtype agree (bf16 moments included)."""
    jm, tm = _models(GPT2)
    cfg = _config(bf16={"enabled": True}, optimizer={
        "type": "adamw", "params": {"lr": 1e-3, "moment_dtype": "bfloat16"}})
    je = jds.initialize(model=jm, config=dict(cfg), topology=_one_device())
    te = tds.initialize(model=tm, config=dict(cfg), device="cpu")
    jdir = jck.save_checkpoint(je, str(tmp_path / "j"))
    tdir = te.save_checkpoint(str(tmp_path / "t"))
    jman = json.loads(open(os.path.join(jdir, "manifest.json")).read())
    tman = json.loads(open(os.path.join(tdir, "manifest.json")).read())
    assert list(tman["leaves"]) == list(jman["leaves"])
    assert ".master['blocks']['attn']['wq']" in tman["leaves"]
    assert ".loss_scale.scale" in tman["leaves"]
    for k, e in jman["leaves"].items():
        t = tman["leaves"][k]
        assert (t["shape"], t["dtype"], t["fragments"]) == (
            e["shape"], e["dtype"], e["fragments"]), k
    assert tman["treedef"] == jman["treedef"]
    assert {k: v for k, v in tman.items() if k not in ("leaves", "time")} \
        == {k: v for k, v in jman.items() if k not in ("leaves", "time")}
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))


# ---------------------------------------------------------------------------
# crossing between the engines
# ---------------------------------------------------------------------------

def _resume(src, dst, save_dir, batches, first=2):
    """``src`` takes ``first`` steps and saves; ``dst`` (other weights)
    loads; then both take the remaining steps.  Returns both metric
    trajectories after the resume."""
    for b in batches[:first]:
        src.train_batch(dict(b))
    src.save_checkpoint(save_dir)
    dst.load_checkpoint(save_dir)
    assert dst.global_steps == src.global_steps == first
    out_src, out_dst = [], []
    for b in batches[first:]:
        out_src.append(_metrics(src.train_batch(dict(b))))
        out_dst.append(_metrics(dst.train_batch(dict(b))))
    return np.asarray(out_src), np.asarray(out_dst)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_and_training_follows(direction, tmp_path):
    """A checkpoint saved by one engine after 2 steps loads into the
    other (which starts from other weights), and 3 more steps on both
    follow the same trajectory (fp32 state)."""
    jm, tm = _models(GPT2)
    jm2, tm2 = _models(GPT2, seed=11)
    cfg = _config()
    if direction == "jax_to_port":
        src = jax_engine(jm, cfg, _one_device())
        dst = tds.initialize(model=tm2, config=dict(cfg), device="cpu")
    else:
        src = tds.initialize(model=tm, config=dict(cfg), device="cpu")
        dst = jds.initialize(model=jm2, config=dict(cfg),
                             topology=_one_device())
    a, b = _resume(src, dst, str(tmp_path), _batches(5))
    np.testing.assert_allclose(b, a, rtol=1e-4)
    sa = _jax_state(src) if direction == "jax_to_port" else _port_state(src)
    sb = _port_state(dst) if direction == "jax_to_port" else _jax_state(dst)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        if "['attn']['bk']" in k:      # a zero-gradient leaf: rounding noise
            continue
        np.testing.assert_allclose(sb[k], sa[k], atol=1e-4, err_msg=k)


def test_jax_fsdp8_checkpoint_loads_into_the_port(fsdp8, tmp_path):
    """A checkpoint the JAX engine saved on the 8-device fsdp mesh (ZeRO-3:
    one fragment per shard) loads into the one-card port whole, bitwise,
    and the next step's loss matches."""
    jm, _ = _models(GPT2)
    _, tm2 = _models(GPT2, seed=11)
    cfg = _config(train_batch_size=8, zero_optimization={"stage": 3},
                  mesh={"data": 1, "fsdp": 8})
    je = jds.initialize(model=jm, config=dict(cfg), topology=fsdp8)
    r = np.random.RandomState(4)
    b = {"input_ids": r.randint(0, VOCAB, (8, SEQ)).astype(np.int32)}
    je.train_batch(dict(b))
    d = jck.save_checkpoint(je, str(tmp_path))
    man = json.loads(open(os.path.join(d, "manifest.json")).read())
    assert max(len(e["fragments"]) for e in man["leaves"].values()) == 8
    te = tds.initialize(model=tm2, config=_config(
        train_batch_size=8, zero_optimization={"stage": 3}), device="cpu")
    te.load_checkpoint(str(tmp_path))
    sj, st = _jax_state(je), _port_state(te)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    jl = float(je.train_batch(dict(b))["loss"])
    tl = float(te.train_batch(dict(b))["loss"])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_latest_pointer(tmp_path):
    """``latest`` names the last tag saved; ``load_checkpoint`` without a
    tag reads it, with a tag reads that one; no ``latest`` raises."""
    _, tm = _models(GPT2)
    te = tds.initialize(model=tm, config=_config(), device="cpu")
    with pytest.raises(FileNotFoundError):
        te.load_checkpoint(str(tmp_path))
    b = _batches(2)
    te.train_batch(dict(b[0]))
    d1 = te.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    te.train_batch(dict(b[1]))
    d2 = te.save_checkpoint(str(tmp_path), tag="second")
    assert (tmp_path / "latest").read_text() == "second"
    assert os.path.basename(d1) == "global_step1"
    _, tm2 = _models(GPT2, seed=11)
    te2 = tds.initialize(model=tm2, config=_config(), device="cpu")
    assert te2.load_checkpoint(str(tmp_path))[0] == d2
    assert te2.global_steps == 2 and te2.state.step == 2
    assert te2.load_checkpoint(str(tmp_path), tag="global_step1") == (
        d1, {"epoch": 3})
    assert te2.global_steps == 1


def test_async_save_matches_sync_and_writes_latest_last(tmp_path,
                                                         monkeypatch):
    """With ``checkpoint.async_save`` the call returns before any fragment
    is written (the writer waits on an event the test sets afterwards),
    the state keeps training meanwhile, ``latest`` appears only after
    every fragment, and the files hold the state of the save's moment,
    bitwise the same as a synchronous save's."""
    _, tm = _models(GPT2)
    te = tds.initialize(model=tm, config=_config(
        checkpoint={"async_save": True}), device="cpu")
    b = _batches(2)
    te.train_batch(dict(b[0]))
    sync_dir = ck.save_checkpoint(te, str(tmp_path / "sync"))
    go = threading.Event()
    order = []
    write, write_latest = ck._write_fragment, ck._write_latest

    def gated(path, data, dtype):
        assert go.wait(timeout=60)
        order.append(os.path.basename(path))
        write(path, data, dtype)

    def latest(save_dir, tag):
        order.append("latest")
        write_latest(save_dir, tag)

    monkeypatch.setattr(ck, "_write_fragment", gated)
    monkeypatch.setattr(ck, "_write_latest", latest)
    d = te.save_checkpoint(str(tmp_path / "async"))
    assert not os.path.exists(tmp_path / "async" / "latest")
    te.train_batch(dict(b[1]))           # the state moves on meanwhile
    go.set()
    te.wait_checkpoint()
    n = len(ck._leaf_paths(te.state))
    assert order[-1] == "latest" and len(order) == n + 1
    assert sorted(os.listdir(d)) == sorted(os.listdir(sync_dir))
    for fn in os.listdir(d):
        if fn.endswith(".npy"):
            assert (open(os.path.join(d, fn), "rb").read()
                    == open(os.path.join(sync_dir, fn), "rb").read()), fn


def test_consolidate_equals_the_jax_consolidate(tmp_path):
    """``consolidate`` of the port's checkpoint equals the JAX package's
    ``consolidate`` of the same files, and of the JAX engine's
    checkpoint of the same master."""
    jm, tm = _models(GPT2)
    te = tds.initialize(model=tm, config=_config(), device="cpu")
    te.train_batch(dict(_batches(1)[0]))
    d = te.save_checkpoint(str(tmp_path))
    got, ref = ck.consolidate(d), jck.consolidate(d)
    assert sorted(got) == sorted(ref) and len(got) == len(
        tree_leaves(te.state.master))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    je = jds.initialize(model=jm, config=_config(), topology=_one_device())
    jd = jck.save_checkpoint(je, str(tmp_path / "j"))
    got, ref = ck.consolidate(jd, prefix=""), jck.consolidate(jd, prefix="")
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_fp16_loss_scaler_state_carries_across(tmp_path):
    """phi-tiny in fp16 with the dynamic loss scaler (a small window, so
    the scale moves): the JAX engine's scale, good steps, hysteresis and
    skipped count load into the port exactly, and the next two steps
    agree."""
    jm, _ = _models(PHI)
    _, tm2 = _models(PHI, seed=11)
    cfg = _config(fp16={"enabled": True, "initial_scale_power": 20,
                        "loss_scale_window": 2, "hysteresis": 1})
    je = jax_engine(jm, cfg, _one_device())
    te = tds.initialize(model=tm2, config=dict(cfg), device="cpu")
    a, b = _resume(je, te, str(tmp_path), _batches(6), first=4)
    ls = je.state.loss_scale
    assert te.state.loss_scale == (float(ls.scale), int(ls.good_steps),
                                   int(ls.hysteresis))
    assert te.state.skipped == int(je.state.skipped)
    assert te.state.step == int(je.state.step)
    np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=2e-3)


def test_bf16_moments_round_trip_and_the_jax_reader_raises(tmp_path):
    """AdamW with bf16 moments: the port's save loads back bitwise into a
    fresh port engine, and a JAX-saved bf16 state loads into the port
    bitwise; the JAX reader raises on the port's files and its own (its
    cast of the '<V2' words into bfloat16)."""
    jm, tm = _models(GPT2)
    _, tm2 = _models(GPT2, seed=11)
    cfg = _config(bf16={"enabled": True}, optimizer={
        "type": "adamw", "params": {"lr": 1e-3, "moment_dtype": "bfloat16"}})
    te = tds.initialize(model=tm, config=dict(cfg), device="cpu")
    te.train_batch(dict(_batches(1)[0]))
    d = te.save_checkpoint(str(tmp_path / "t"))
    te2 = tds.initialize(model=tm2, config=dict(cfg), device="cpu")
    te2.load_checkpoint(str(tmp_path / "t"))
    m1, m2 = tree_leaves(te.state.opt_state), tree_leaves(te2.state.opt_state)
    assert m1[0].dtype == torch.bfloat16
    for x, y in zip(m1, m2):
        assert y.dtype == torch.bfloat16 and torch.equal(x.view(torch.int16),
                                                         y.view(torch.int16))
    je = jds.initialize(model=jm, config=dict(cfg), topology=_one_device())
    je.train_batch(dict(_batches(1)[0]))
    jd = jck.save_checkpoint(je, str(tmp_path / "j"))
    te2.load_checkpoint(str(tmp_path / "j"))
    sj, st = _jax_state(je), _port_state(te2)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k].astype(st[k].dtype),
                                      err_msg=k)
    for path in (d, jd):
        with pytest.raises(ValueError, match="cast"):
            jck.load_tree_host(je.state, path)
