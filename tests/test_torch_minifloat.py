"""The fp6/fp12 minifloat weight layouts of the port held against the JAX
package: the format tables, the 24-bit packing, the emulated grouped codes
(``minifloat_quantize``) and the packed row-wise layouts
(``quantize_rowwise6`` / ``quantize_rowwise12``) at lead dims 0 and 1,
``selective_dequantize``, ``quantize_model_params(bits=6|12)`` tree by
tree, and the serving slice as a whole: the tiny Llama (2 layers, d_model
64, vocab 128) served greedily under ``weight_quant="fp6"`` and ``"fp12"``
by both engines on the same weights, resident and weight-streamed.

Tolerance: codes and scales bitwise; dequantized values bitwise in fp32
(the same table value times the same fp32 scale); the streams equal; the
first forward's fp32 logits within 1e-5 (the same dequantized weights,
sums taken in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.inference.model import ragged_forward as jax_forward
from deepspeed_tpu.inference.ragged.state import (KVCacheConfig as JaxKV,
                                                  StateManager as JaxSM)
from deepspeed_tpu.models import build_model as jax_build
from deepspeed_tpu.ops import quant as jquant
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference import quantization as pq
from deepspeed_tpu_torch.inference.model import ragged_forward
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy,
                                        quant_tree_from_numpy)
from deepspeed_tpu_torch.ops import quant as pquant
from tests.test_torch_ragged_forward import _to_port
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

FORMATS = ("fp6_e3m2", "fp12_e4m7")
LAYOUTS = {"rowwise6": (jquant.quantize_rowwise6, pquant.quantize_rowwise6),
           "rowwise12": (jquant.quantize_rowwise12,
                         pquant.quantize_rowwise12)}
ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
NEW = 8


def _weights(shape, seed=0):
    """Rows of very different magnitudes, one all-zero row (scale 1)."""
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * np.exp(2 * r.randn(*shape[:-1], 1)))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0
    return x


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_qt(got, want):
    """A port QuantizedTensor bitwise the JAX one: payload, scales, zero
    points, bit width, shape and layout."""
    _same_bits(_np(got.data), _np(want.data))
    _same_bits(_np(got.scale), _np(want.scale))
    assert (got.zero is None) == (want.zero is None)
    assert (got.bits, tuple(got.shape), got.layout) == \
        (want.bits, tuple(want.shape), want.layout)


@pytest.mark.parametrize("fmt", FORMATS)
def test_table_matches_jax(fmt):
    eb, mb, _ = pquant._MINIFLOAT_FORMATS[fmt]
    want = jquant._minifloat_table(eb, mb)
    _same_bits(pquant._minifloat_table(eb, mb), want)
    tabs = pquant.minifloat_tables(fmt, "cpu")
    _same_bits(tabs["mids"].numpy(), (want[1:] + want[:-1]) / 2.0)
    n = want.shape[0]
    assert tabs["signed"].shape == (2 * n,) == tabs["packed"].shape
    # the tables are made once per device
    assert pquant.minifloat_tables(fmt, "cpu") is tabs


@pytest.mark.parametrize("layout", sorted(pquant._PACKED_MINIFLOAT))
def test_pack_unpack_round_trip(layout):
    _, per_word, bits = pquant._PACKED_MINIFLOAT[layout]
    codes = np.random.RandomState(1).randint(
        0, 1 << bits, (3, 5, 8 * per_word)).astype(np.uint32)
    packed = pquant._pack_codes(torch.from_numpy(codes.astype(np.int32)),
                                per_word, bits)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, 24)
    _same_bits(packed.numpy(), jquant._pack_codes(jnp.asarray(codes),
                                                  per_word, bits))
    back = pquant._unpack_codes(packed, per_word, bits)
    assert back.dtype == torch.int32
    assert np.array_equal(back.numpy(), codes.astype(np.int32))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("groups", [None, 48])
def test_minifloat_quantize_bitwise(fmt, groups):
    x = _weights((3, 40, 64))
    want = jquant.minifloat_quantize(jnp.asarray(x), fmt, num_groups=groups)
    got = pquant.minifloat_quantize(torch.from_numpy(x), fmt,
                                    num_groups=groups)
    _same_qt(got, want)
    _same_bits(pquant.dequantize_any(got, torch.float32).numpy(),
               jquant.dequantize_any(want, jnp.float32))
    _same_bits(pquant.minifloat_dequantize(got).numpy(),
               jquant.minifloat_dequantize(want))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("lead_dims", [0, 1])
def test_rowwise_minifloat_bitwise(layout, lead_dims):
    jfn, pfn = LAYOUTS[layout]
    x = _weights((3, 40, 4, 16), seed=2)
    want = jfn(jnp.asarray(x), lead_dims=lead_dims)
    got = pfn(torch.from_numpy(x), lead_dims=lead_dims)
    _same_qt(got, want)
    per_word = pquant._PACKED_MINIFLOAT[layout][1]
    assert got.data.shape[-1] == 16 * 3 // per_word
    _same_bits(pquant.dequantize_any(got, torch.float32).numpy(),
               jquant.dequantize_any(want, jnp.float32))
    # the serving dtype: the fp32 product cast once, as in the JAX package
    _same_bits(pquant.dequantize_any(got, torch.bfloat16).float().numpy(),
               np.asarray(jquant.dequantize_any(want, jnp.bfloat16)
                          .astype(jnp.float32)))
    with pytest.raises(ValueError, match="divide"):
        pfn(torch.zeros(4, 3 * per_word + 1))


@pytest.mark.parametrize("fmt", FORMATS)
def test_selective_dequantize_matches_jax(fmt):
    x = _weights((6, 32, 64), seed=3)
    jqt = jquant.minifloat_quantize(jnp.asarray(x), fmt, num_groups=12)
    pqt = pquant.minifloat_quantize(torch.from_numpy(x), fmt, num_groups=12)
    rows = [4, 0, 4]
    _same_bits(pquant.selective_dequantize(pqt, rows, torch.float32).numpy(),
               jquant.selective_dequantize(jqt, jnp.asarray(rows),
                                           jnp.float32))
    with pytest.raises(ValueError, match="align"):
        pquant.selective_dequantize(pquant.minifloat_quantize(
            torch.from_numpy(x), fmt, num_groups=4), rows)


@pytest.mark.parametrize("bits", [6, 12])
def test_stacked_fallback_is_the_emulated_layout(bits):
    """A trailing dim that does not fill whole 24-bit words takes the
    emulated grouped codes, one minifloat_quantize a layer."""
    w = _weights((2, 8, 5), seed=4)
    want = jq._quantize_stacked(jnp.asarray(w), bits)
    got = pq._quantize_stacked(torch.from_numpy(w), bits)
    assert got.layout == "grouped" and got.bits == bits
    _same_qt(got, want)
    for i in range(2):
        _same_bits(pq.layer_weight(got, i, torch.float32).numpy(),
                   jq.layer_weight(want, i, jnp.float32))


@pytest.mark.parametrize("bits", [6, 12])
@pytest.mark.parametrize("shape", [(2, 8, 12), (2, 8, 4, 6), (2, 8, 5)])
def test_minifloat_layout_is_the_stacked_payloads(bits, shape):
    """``minifloat_layout`` names the layout ``_quantize_stacked`` takes
    for the shape (None: the emulated codes), ``minifloat_payload_bytes``
    the bytes of its payload."""
    got = pq._quantize_stacked(torch.from_numpy(_weights(shape, seed=6)),
                               bits)
    layout = pquant.minifloat_layout(bits, shape)
    assert got.layout == (layout or "grouped")
    assert got.data.numel() * got.data.element_size() == \
        pquant.minifloat_payload_bytes(bits, shape, layout)


@pytest.fixture(scope="module")
def llama():
    """The tiny Llama of the JAX package's packed-fp6 serving test: 2
    layers, d_model 64, 4 heads over 2 KV heads, d_ff 128, vocab 128."""
    jm = jax_build("llama-tiny", vocab_size=128, num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, max_seq_len=128)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


@pytest.mark.parametrize("bits", [6, 12])
@pytest.mark.parametrize("embed", [False, True])
def test_quantize_model_params_matches_jax(llama, bits, embed):
    jm, port = llama
    jd, jqt = jq.quantize_model_params(jm.params, bits=bits,
                                       quantize_embeddings=embed)
    pd, pqt = pq.quantize_model_params(port.params, bits=bits,
                                       quantize_embeddings=embed)
    layout = {6: "rowwise6", 12: "rowwise12"}[bits]
    for g, grp in jqt["blocks"].items():
        assert sorted(pqt["blocks"][g]) == sorted(grp)
        for name, want in grp.items():
            assert want.layout == layout
            _same_qt(pqt["blocks"][g][name], want)
            assert name not in pd["blocks"][g]
    assert ("embed" in pqt) == embed == ("table" not in pd["embed"])
    if embed:
        _same_qt(pqt["embed"]["table"], jqt["embed"]["table"])
    # the JAX tree carried over as numpy is the same tree
    carried = quant_tree_from_numpy(jax.tree.map(np.asarray, jqt),
                                    device="cpu")
    _same_qt(carried["blocks"]["attn"]["wq"], pqt["blocks"]["attn"]["wq"])


def _jax_generate(jm, prompts, **over):
    kw = dict(ENGINE, kv_dtype=jnp.float32, param_dtype=jnp.float32,
              attn_impl="xla", pipeline_depth=1)
    kw.update(over)
    return JaxEngine(jm, JaxConfig(**kw)).generate(
        prompts, JaxSampling(max_new_tokens=NEW))


def _port_engine(port, **over):
    kw = dict(ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(port, InferenceConfig(**kw))


def _prompts():
    r = np.random.RandomState(0)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    return {1: tok(12), 2: tok(40), 3: tok(5)}     # 40 > budget: chunked


SERVE = {"fp6": dict(weight_quant="fp6"),
         "fp6-embed": dict(weight_quant="fp6", quantize_embeddings=True),
         "fp12": dict(weight_quant="fp12"),
         "fp12-embed-kv8": dict(weight_quant="fp12", quantize_embeddings=True,
                                kv_quant="int8")}


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serving_streams_match_jax(llama, case):
    jm, port = llama
    over = SERVE[case]
    eng = _port_engine(port, **over)
    assert not eng._mixed_gemm_active
    fmt = pquant.MINIFLOAT_BY_BITS[pquant.WEIGHT_QUANT_BITS[
        over["weight_quant"]]]
    assert (fmt, "cpu") in pquant._TABLES
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=NEW))
    assert out == _jax_generate(jm, _prompts(), **over)


@pytest.mark.parametrize("bits", [6, 12])
def test_first_forward_logits_match_jax(llama, bits):
    jm, port = llama
    jd, jqt = jq.quantize_model_params(jm.params, bits=bits,
                                       quantize_embeddings=True)
    pd, pqt = pq.quantize_model_params(port.params, bits=bits,
                                       quantize_embeddings=True)
    cfg = jm.config
    sm = JaxSM(JaxKV(num_layers=cfg.num_layers,
                     num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                     block_size=16, num_blocks=8, dtype=jnp.float32),
               max_seqs=4)
    jkv, pkv = sm.kv, torch.zeros(np.asarray(sm.kv).shape)
    r = np.random.RandomState(4)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    for step in ([(0, tok(20)), (1, tok(9))], [(0, tok(1)), (1, tok(1))]):
        jb = sm.build_batch(step, token_budget=32)
        jl, jkv = jax_forward(cfg, jd, jkv, jb, 16, 4, attn_impl="xla",
                              quant=jqt)
        pl_, pkv = ragged_forward(port.config, pd, pkv, _to_port(jb), 16, 4,
                                  quant=pqt)
        rows = np.asarray(jb.logits_idx) >= 0
        np.testing.assert_allclose(pl_.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("wq", ["fp6", "fp12"])
def test_mixed_gemm_on_raises_as_in_jax(llama, wq):
    jm, port = llama
    with pytest.raises(ValueError, match="mixed_gemm='on'.*row-wise int8"):
        JaxEngine(jm, JaxConfig(**ENGINE, param_dtype=jnp.float32,
                                kv_dtype=jnp.float32, weight_quant=wq,
                                mixed_gemm="on"))
    with pytest.raises(ValueError, match="mixed_gemm='on'.*row-wise int8"):
        _port_engine(port, weight_quant=wq, mixed_gemm="on")


@pytest.mark.parametrize("wq", ["fp6", "fp12"])
def test_weight_stream_serves_as_jax(llama, wq, tmp_path):
    """The JAX engine streams minifloat payloads from its store; so does
    the port (the payloads and their layout tags spilled, each layer
    dequantized as it arrives)."""
    jm, port = llama
    eng = _port_engine(port, weight_quant=wq, quantize_embeddings=True,
                       weight_stream=str(tmp_path / "port"))
    assert eng._wstore is not None and not eng._mixed_gemm_active
    layouts = {m[3] for g in eng._wstore.qmeta.values() for m in g.values()}
    assert layouts == {{"fp6": "rowwise6", "fp12": "rowwise12"}[wq]}
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=NEW))
    assert out == _jax_generate(jm, _prompts(), weight_quant=wq,
                                quantize_embeddings=True,
                                weight_stream=str(tmp_path / "jax"))


@pytest.mark.parametrize("wq", ["fp6", "fp12"])
def test_refresh_params_requantizes(llama, wq):
    """refresh_params re-quantizes new dense weights under the minifloat
    layout, in place, as the JAX engine re-quantizes them: both serve
    the stream of an engine built on the new weights."""
    jm, port = llama
    new_j = jax.tree.map(lambda x: x * 0.5 + 0.01, jm.params)
    new_p = params_from_numpy(jax.tree.map(np.asarray, new_j), device="cpu")
    eng = _port_engine(port, weight_quant=wq)
    eng.generate(_prompts(), SamplingParams(max_new_tokens=2))
    data = eng._quant["blocks"]["mlp"]["wi"].data
    eng.refresh_params(new_p)
    assert eng._quant["blocks"]["mlp"]["wi"].data is data
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=NEW))
    je = JaxEngine(jm, JaxConfig(**ENGINE, param_dtype=jnp.float32,
                                 kv_dtype=jnp.float32, attn_impl="xla",
                                 pipeline_depth=1, weight_quant=wq))
    je.refresh_params(new_j)
    assert out == je.generate(_prompts(), JaxSampling(max_new_tokens=NEW))
    fresh = _port_engine(Model.from_params(port.config, new_p),
                         weight_quant=wq)
    assert out == fresh.generate(_prompts(),
                                 SamplingParams(max_new_tokens=NEW))
