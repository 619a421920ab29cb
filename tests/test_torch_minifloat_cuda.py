"""The fp6/fp12 minifloat weight layouts on the card against the CPU.

Marked ``cuda``: without a CUDA device every test here skips (what is
held is the card's own quantization and dequantization of the layouts:
its searchsorted, shifts and table gathers).  The payloads quantized on
the card (packed row-wise fp6 and fp12 at lead dims 0 and 1, the
emulated grouped codes) must be bitwise the CPU's, and so must their
dequantized values in fp32 and bf16 (the int8/int4 layouts too, and the
serving cache's int8/fp8 KV codes and scales: every scale is a division
by a constant, which the card must round once).  A
tiny Llama (2 layers, d_model 512, 8 heads of 64 over 2 KV heads) served
greedily under ``weight_quant="fp6"`` and ``"fp12"`` on the card, every
step a CUDA graph replay with paged attention in every layer and no
mixed-input GEMM, must emit the CPU engine's streams on the same
weights, or first differ at a near-tie: both tokens' fp32 logits of the common context within
NOISE_FACTOR x that row's bf16 noise floor (bf16 against fp32 of the
dense forward on the dequantized weights).  This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_minifloat_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference.quantization import (layer_weight,
                                                        quantize_model_params)
from deepspeed_tpu_torch.models import Model, apply, build_model
from deepspeed_tpu_torch.models.transformer import tree_map
from deepspeed_tpu_torch.ops import quant as pquant

pa_mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
mg_mod = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")

NOISE_FACTOR = 2.0
ENGINE = dict(token_budget=64, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
PROMPTS = {1: list(range(3, 40)), 2: [7, 7, 1], 3: list(range(100, 120))}
NEW = 16


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's minifloat arithmetic)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _same_bits(a, b, what):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8)), what


def _weights(shape, seed):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * np.exp(2 * r.randn(*shape[:-1], 1)))
    return torch.from_numpy(x.astype(np.float32))


QUANTIZERS = {
    "rowwise6-0": lambda x: pquant.quantize_rowwise6(x),
    "rowwise6-1": lambda x: pquant.quantize_rowwise6(x, lead_dims=1),
    "rowwise12-0": lambda x: pquant.quantize_rowwise12(x),
    "rowwise12-1": lambda x: pquant.quantize_rowwise12(x, lead_dims=1),
    "fp6-grouped": lambda x: pquant.minifloat_quantize(x, "fp6_e3m2"),
    "fp12-grouped": lambda x: pquant.minifloat_quantize(x, "fp12_e4m7"),
    # the int layouts divide by a scalar too (127, 7): on the card a
    # Python divisor would be multiplied in as its reciprocal
    "int8-rowwise": lambda x: pquant._quantize_leading(x, lead_dims=2),
    "int4-rowwise": lambda x: pquant.quantize_rowwise4(x, lead_dims=1),
    "int8-grouped": lambda x: pquant.quantize(x),
    "int4-asym": lambda x: pquant.quantize(x, bits=4, symmetric=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(QUANTIZERS))
def test_card_payloads_bitwise_the_cpus(name):
    x = _weights((4, 256, 8, 64), seed=len(name))
    got = QUANTIZERS[name](x.cuda())
    want = QUANTIZERS[name](x)
    _same_bits(got.data, want.data, f"{name} codes")
    _same_bits(got.scale, want.scale, f"{name} scales")
    if got.zero is not None:
        _same_bits(got.zero, want.zero, f"{name} zero points")
    for dt in (torch.float32, torch.bfloat16):
        _same_bits(pquant.dequantize_any(got, dt),
                   pquant.dequantize_any(want, dt), f"{name} {dt}")


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", [torch.int8, torch.float8_e4m3fn],
                         ids=["int8", "fp8"])
def test_card_kv_codes_bitwise_the_cpus(qdt):
    from deepspeed_tpu_torch.inference.model import _quantize_kv
    kv = _weights((2, 64, 2, 4, 64), seed=11).to(torch.bfloat16)
    got, want = _quantize_kv(kv.cuda(), qdt), _quantize_kv(kv, qdt)
    _same_bits(got[0], want[0], f"{qdt} KV codes")
    _same_bits(got[1], want[1], f"{qdt} KV scales")


@pytest.fixture(scope="module")
def tiny():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # K2 takes head dim 64
    return build_model("llama-tiny", seed=5, device="cpu",
                       dtype=torch.bfloat16, vocab_size=512, num_layers=2,
                       d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024,
                       max_seq_len=512)


def _near_tie(model_cpu, quant, bits, ctx, a, b):
    """Tokens ``a`` and ``b`` at a near-tie after ``ctx``: their fp32
    logits within NOISE_FACTOR x the bf16 noise floor of that row (the
    dense forward on the dequantized weights)."""
    cfg = model_cpu.config
    dense = {k: v for k, v in model_cpu.params.items()}
    blocks = {g: dict(grp) for g, grp in dense["blocks"].items()}
    for g, grp in quant["blocks"].items():
        for name, qt in grp.items():
            blocks[g][name] = torch.stack(
                [layer_weight(qt, i, torch.bfloat16)
                 for i in range(cfg.num_layers)])
    dense["blocks"] = blocks
    ids = torch.as_tensor([ctx])
    lo = apply(cfg, dense, ids)[0, -1].float()
    hi = apply(cfg, tree_map(lambda t: t.float(), dense), ids,
               dtype=torch.float32)[0, -1]
    tol = NOISE_FACTOR * float((lo - hi).abs().max())
    return abs(float(hi[a] - hi[b])) <= tol and \
        float(hi.max() - torch.maximum(hi[a], hi[b])) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("wq", ["fp6", "fp12"])
def test_tiny_engine_on_the_card_serves_the_cpus_streams(tiny, wq):
    bits = pquant.WEIGHT_QUANT_BITS[wq]
    card = Model.from_params(tiny.config,
                             tree_map(lambda t: t.cuda(), tiny.params))
    cfg = InferenceConfig(**ENGINE, weight_quant=wq)
    g = InferenceEngine(card, cfg)
    c = InferenceEngine(tiny, cfg)
    for grp, cgrp in zip(g._quant["blocks"].values(),
                         c._quant["blocks"].values()):
        for qt, cqt in zip(grp.values(), cgrp.values()):
            _same_bits(qt.data, cqt.data, f"{wq} engine payload")
            _same_bits(qt.scale, cqt.scale, f"{wq} engine scales")
    sp = SamplingParams(max_new_tokens=NEW)
    pa = pa_mod.paged_attention
    pa.launches = 0
    mg_mod.mixed_matmul_2d.launches = mg_mod.mixed4_matmul_2d.launches = 0
    out_g = g.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    torch.cuda.synchronize()
    tm = g.timings
    assert tm["graph_replays"] == tm["steps"]
    assert pa.launches == tiny.config.num_layers * (tm["steps"]
                                                    + tm["compiles"])
    assert mg_mod.mixed_matmul_2d.launches == 0 == \
        mg_mod.mixed4_matmul_2d.launches
    out_c = c.generate({u: list(p) for u, p in PROMPTS.items()}, sp)
    _, quant = quantize_model_params(tiny.params, bits=bits)
    for u, prompt in PROMPTS.items():
        a, b = out_g[u], out_c[u]
        if a == b:
            continue
        i = next(j for j in range(NEW) if a[j] != b[j])
        assert _near_tie(tiny, quant, bits, prompt + a[:i], a[i], b[i]), \
            (wq, u, i, a, b)
