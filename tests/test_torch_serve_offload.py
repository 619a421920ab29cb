"""Serving offload in the port held against the port's resident engine and
the JAX package's engine: the KV cache in host memory (``kv_offload``;
the JAX engine on the CPU keeps its cache on the device with a warning,
which computes the same numbers), the block weights streamed from an
NVMe store (``weight_stream``: plain, quantized with the mixed-input GEMM
off and on, MoE with the shared expert kept dense), both together, the
store itself and the needs-resident-weights gate.

Each mode's greedy streams equal the port's resident engine's and the
JAX engine's in the same mode, token for token (fp32 engines; the
mixed-input GEMM rounds x and each weight to bf16 on both sides), and
the forward's logits and caches are bitwise the resident forward's."""

import dataclasses
import functools
import importlib
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           NVMeWeightStore, SamplingParams)
from deepspeed_tpu_torch.inference.model import ragged_forward
from deepspeed_tpu_torch.inference.ragged.state import (KVCacheConfig,
                                                        StateManager,
                                                        kv_working_layer)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from tests.test_torch_moe_model import _no_drops, _pair
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
NEW = 6


def _prompts():
    r = np.random.RandomState(0)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    long = tok(40)                                 # > budget: chunked
    return {1: tok(12), 2: long, 3: tok(5), 4: long[:32] + tok(6)}


@functools.lru_cache(maxsize=None)
def _models(name="llama"):
    """(JAX model, port model) on the same fp32 weights."""
    if name != "llama":
        return _pair(name, **_no_drops(name))
    jm = jax_inference.tiny_model()
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _generate(eng, sampling):
    return eng.generate({u: list(p) for u, p in _prompts().items()},
                        sampling(max_new_tokens=NEW))


# the configurations: (model, engine fields); a JAX reference each
CASES = {
    "kv-int8w": ("llama", dict(weight_quant="int8", kv_offload=True)),
    "kv-bf16": ("llama", dict(kv_offload=True, dtype="bf16")),
    "kv-kv8": ("llama", dict(kv_quant="int8", kv_offload=True)),
    "ws-plain": ("llama", dict(weight_stream=True)),
    "ws-int8-off": ("llama", dict(weight_quant="int8", mixed_gemm="off",
                                  weight_stream=True)),
    "ws-int8-on": ("llama", dict(weight_quant="int8", mixed_gemm="on",
                                 weight_stream=True)),
    "ws-moe": ("qwen2moe", dict(weight_quant="int8", mixed_gemm="on",
                                weight_stream=True)),
    "both": ("llama", dict(weight_quant="int8", mixed_gemm="on",
                           weight_stream=True, kv_offload=True)),
}


def _fields(over, pkg, tmp):
    """An engine's config fields: fp32 (or bf16) in either package's
    dtypes, the store in ``tmp``."""
    over = dict(over)
    bf16 = over.pop("dtype", None) == "bf16"
    if pkg == "jax":
        dt = jnp.bfloat16 if bf16 else jnp.float32
        kw = dict(ENGINE, attn_impl="xla", param_dtype=dt, kv_dtype=dt)
    else:
        dt = torch.bfloat16 if bf16 else torch.float32
        kw = dict(ENGINE, param_dtype=dt, kv_dtype=dt)
    if over.pop("weight_stream", False):
        over["weight_stream"] = str(tmp / f"{pkg}_store")
    return dict(kw, **over)


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    """The JAX engine's streams in the case's mode (one per case).  With
    both modes the JAX engine raises at its first step on the CPU (a
    ValueError of its layer scan, after ``kv_offload`` fell back to a
    device cache): its ``weight_stream`` engine, whose cache is on the
    device either way, is the reference."""
    name, over = CASES[case]
    if "weight_stream" in over:
        over = {k: v for k, v in over.items() if k != "kv_offload"}
    jm, _ = _models(name)
    with tempfile.TemporaryDirectory() as tmp:
        eng = JaxEngine(jm, JaxConfig(**_fields(over, "jax", Path(tmp))))
        return _generate(eng, JaxSampling)


@pytest.mark.parametrize("case", sorted(CASES))
def test_streams_equal_resident_and_jax(case, tmp_path):
    name, over = CASES[case]
    _, port = _models(name)
    fields = _fields(over, "port", tmp_path)
    resident = {k: v for k, v in fields.items()
                if k not in ("kv_offload", "weight_stream")}
    want = _generate(InferenceEngine(port, InferenceConfig(**resident)),
                     SamplingParams)
    eng = InferenceEngine(port, InferenceConfig(**fields))
    got = _generate(eng, SamplingParams)
    assert got == want == _jax_reference(case)
    if "kv_offload" in fields:
        parts = (eng.state.kv if isinstance(eng.state.kv, tuple)
                 else (eng.state.kv,))
        work = (eng._kv_work if isinstance(eng._kv_work, tuple)
                else (eng._kv_work,))
        assert [tuple(w.shape) for w in work] == \
            [tuple(p.shape[1:]) for p in parts]
    if "weight_stream" in fields:
        # the block weights left the resident tree for the store's files
        assert "blocks" not in eng.params
        assert not eng._quant or eng._quant["blocks"] == {}
        files = os.listdir(fields["weight_stream"])
        assert any(f.startswith("layer") and f.endswith(".npy")
                   for f in files)
        mixed = over.get("mixed_gemm") == "on"
        assert eng._wstore.mixed_gemm_eligible == ("weight_quant" in over)
        assert eng._mixed_gemm_active == mixed
        assert eng.timings["eager_steps"] == 0      # the CPU route


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_kv_host_forward_is_the_resident_forward(kv_quant):
    """Two ragged steps with the cache in host memory through the working
    layer: logits and caches bitwise the resident forward's."""
    _, port = _models()
    cfg = port.config
    out = []
    for host in (False, True):
        sm = StateManager(KVCacheConfig(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, block_size=16,
            num_blocks=16, dtype=torch.float32, quant=kv_quant or "none",
            device="cpu", host=host), max_seqs=2)
        work = kv_working_layer(sm.kv, "cpu") if host else None
        logits = []
        for sched in ([(0, _prompts()[2][:20]), (1, _prompts()[1])],
                      [(0, [7]), (1, [9])]):
            batch = sm.build_batch(sched, 32)
            lg, _ = ragged_forward(cfg, port.params, sm.kv, batch, 16, 4,
                                   kv_host=work)
            logits.append(lg)
        out.append((logits, sm.kv if kv_quant else (sm.kv,)))
    (lr, kr), (lh, kh) = out
    assert all(torch.equal(a, b) for a, b in zip(lr, lh))
    assert all(torch.equal(a, b) for a, b in zip(kr, kh))


def test_store_spill_fetch_restore(tmp_path):
    """spill -> fetch_layer -> restore_stacked, bitwise, across dtypes
    (bf16 and float8 leaves are saved as integer words); every payload
    reads back with np.load; the two-slot pipeline serves layers out of
    order, and a layer fetched again after its slot was reused."""
    g = torch.Generator().manual_seed(0)
    tree = {"dense": {"ln": torch.randn(3, 5, generator=g),
                      "w": torch.randn(3, 4, 6, generator=g).bfloat16()},
            "quant": {"attn": {"wq": {
                "data": torch.randint(-127, 128, (3, 8, 4),
                                      dtype=torch.int8, generator=g),
                "scale": torch.rand(3, 8, 1, generator=g)}},
                "f8": torch.randn(3, 7, generator=g).to(
                    torch.float8_e4m3fn)}}
    store = NVMeWeightStore(str(tmp_path / "s"), 3, device="cpu")
    store.spill(tree)
    flat = [(("dense", "ln"), tree["dense"]["ln"]),
            (("dense", "w"), tree["dense"]["w"]),
            (("quant", "attn", "wq", "data"),
             tree["quant"]["attn"]["wq"]["data"]),
            (("quant", "attn", "wq", "scale"),
             tree["quant"]["attn"]["wq"]["scale"]),
            (("quant", "f8"), tree["quant"]["f8"])]
    assert store.layer_bytes == sum(t[0].numel() * t.element_size()
                                    for _, t in flat)

    def get(d, path):
        for k in path:
            d = d[k]
        return d

    for li in (0, 1, 2, 0, 2, 1):
        got = store.fetch_layer(li)
        for path, t in flat:
            x = get(got, path)
            assert x.dtype == t.dtype and torch.equal(
                x.view(torch.uint8), t[li].contiguous().view(torch.uint8))
        store.release_layer()
    back = store.restore_stacked()
    for path, t in flat:
        assert torch.equal(get(back, path).view(torch.uint8),
                           t.view(torch.uint8))
    files = sorted(os.listdir(tmp_path / "s"))
    assert len(files) == 3 * len(flat)
    # leaf order is the sorted key paths: leaf 1 is dense.w (bf16 words)
    a = np.load(tmp_path / "s" / "layer0002_leaf001.npy")
    assert a.dtype == np.int16 and a.tobytes() == \
        tree["dense"]["w"][2].view(torch.int16).numpy().tobytes()
    assert store.bytes_read == 6 * store.layer_bytes
    store.close()


def test_weight_stream_gate_and_single_steps(tmp_path, monkeypatch):
    """Under weight_stream, decode bursts and speculation are forced off
    with the JAX engine's warning; decode_burst() runs single steps under
    weight_stream and under kv_offload, each the step() a resident engine
    takes."""
    jm, port = _models()
    warnings = {}
    for pkg, module in (("jax", "deepspeed_tpu.inference.engine"),
                        ("port", "deepspeed_tpu_torch.inference.engine")):
        got = []
        monkeypatch.setattr(importlib.import_module(module).logger,
                            "warning", lambda msg, *a: got.append(msg % a))
        for over in (dict(decode_burst=4), dict(spec_decode="on")):
            fields = _fields(dict(over, weight_stream=True), pkg,
                             tmp_path / f"{pkg}{len(got)}")
            if pkg == "jax":
                eng = JaxEngine(jm, JaxConfig(**fields))
            else:
                eng = InferenceEngine(port, InferenceConfig(**fields))
            assert eng.icfg.decode_burst == 1
            assert eng.icfg.spec_decode in ("auto", "off")
        warnings[pkg] = [w for w in got if w.startswith("weight_stream")]
    assert len(warnings["port"]) == 2
    assert warnings["port"] == warnings["jax"]
    prompt = _prompts()[1]
    outs = []
    for over in ({}, dict(kv_offload=True),
                 dict(weight_stream=True, kv_offload=True)):
        eng = InferenceEngine(port, InferenceConfig(**_fields(
            over, "port", tmp_path / "b")))
        eng.put(0, prompt)
        first = eng.step()[0]
        eng.put(0, [first])
        step = eng.decode_burst(4) if over else {0: [eng.step()[0]]}
        outs.append((first, step))
    assert outs[0] == outs[1] == outs[2]
    assert len(outs[0][1][0]) == 1
