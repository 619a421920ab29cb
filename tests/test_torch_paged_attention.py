"""The port's paged attention (``deepspeed_tpu_torch.ops.paged_attention``)
held against the JAX package on the same numpy inputs: the Pallas kernel
(interpret mode on the CPU, as tests/test_paged_attention.py runs it) and
its XLA formulations ``_paged_attention`` / ``_paged_attention_chunked``.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that plain version by tests/test_torch_kernels_cuda.py (and
by chip_smoke.py) on the card.

Tolerances: fp32 1e-5 (the same sums in a different order); bf16 2e-2
(the bar of tests/test_paged_attention.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_paged_attention as jax_tests
from deepspeed_tpu.inference.model import (_paged_attention,
                                           _paged_attention_chunked)
from deepspeed_tpu.ops.paged_attention import \
    paged_attention as jax_pallas_paged_attention
from deepspeed_tpu_torch.ops import paged_attention as pa_reexport
from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_chunked,
                                                     paged_attention_plain)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

NB = 4            # max_blocks_per_seq of the reference cases


def _torch_args(kv, q, batch, dtype):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return (t(np.asarray(kv, np.float32)).to(dtype),
            t(np.asarray(q, np.float32)).to(dtype),
            t(batch.seq_slot), t(batch.positions), t(batch.block_tables))


def _case(H, seed=1):
    kv, batch, bs = jax_tests._mixed_batch()
    D = kv.shape[4]
    q = np.random.RandomState(seed).randn(
        batch.token_ids.shape[0], H, D).astype(np.float32)
    return kv, jnp.asarray(q), batch, bs, 1.0 / np.sqrt(D)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("H", [4, 2])
def test_plain_matches_jax_kernel_and_xla_fp32(H):
    kv, q, batch, bs, scale = _case(H)
    kv_t, q_t, slot_t, pos_t, tab_t = _torch_args(kv, q, batch,
                                                  torch.float32)
    out = paged_attention(kv_t, q_t, slot_t, pos_t, tab_t, bs, NB, scale)
    pallas = jax_pallas_paged_attention(kv, q, batch.seq_slot,
                                        batch.positions, batch.block_tables,
                                        bs, NB, scale)
    xla = _paged_attention(kv, q, batch, bs, NB, scale)
    valid = np.asarray(batch.token_valid)
    np.testing.assert_allclose(_f32(out)[valid], _f32(pallas)[valid],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_f32(out)[valid], _f32(xla)[valid],
                               atol=1e-5, rtol=1e-5)
    # budget padding (slot 0, position 0) is finite garbage, never a fault
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("H", [4, 2])
def test_plain_matches_jax_bf16(H):
    kv, q, batch, bs, scale = _case(H, seed=2)
    kv16, q16 = kv.astype(jnp.bfloat16), q.astype(jnp.bfloat16)
    kv_t, q_t, slot_t, pos_t, tab_t = _torch_args(kv16, q16, batch,
                                                  torch.bfloat16)
    out = paged_attention(kv_t, q_t, slot_t, pos_t, tab_t, bs, NB, scale)
    assert out.dtype == torch.bfloat16
    pallas = jax_pallas_paged_attention(kv16, q16, batch.seq_slot,
                                        batch.positions, batch.block_tables,
                                        bs, NB, scale)
    valid = np.asarray(batch.token_valid)
    np.testing.assert_allclose(_f32(out)[valid], _f32(pallas)[valid],
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("H", [4, 2])
def test_chunked_matches_jax_chunked_and_one_shot(H):
    kv, q, batch, bs, scale = _case(H, seed=3)
    args = _torch_args(kv, q, batch, torch.float32)
    chunked = paged_attention_chunked(*args, bs, NB, scale)
    one_shot = paged_attention_plain(*args, bs, NB, scale)
    ref = _paged_attention_chunked(kv, q, batch, bs, NB, scale)
    valid = np.asarray(batch.token_valid)
    np.testing.assert_allclose(_f32(chunked)[valid], _f32(ref)[valid],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_f32(chunked)[valid], _f32(one_shot)[valid],
                               atol=1e-5, rtol=1e-5)


def test_gather_cap_switches_to_chunked(monkeypatch):
    """Past ``_ONE_SHOT_GATHER_BYTES`` the plain version streams one block
    at a time (as the JAX package does past the same cap)."""
    import importlib
    mod = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")
    kv, q, batch, bs, scale = _case(4, seed=4)
    args = _torch_args(kv, q, batch, torch.float32)
    calls = []
    real = mod.paged_attention_chunked

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mod, "paged_attention_chunked", spy)
    mod.paged_attention_plain(*args, bs, NB, scale)
    assert not calls
    monkeypatch.setattr(mod, "_ONE_SHOT_GATHER_BYTES", 0)
    out = mod.paged_attention_plain(*args, bs, NB, scale)
    assert calls
    ref = _paged_attention(kv, q, batch, bs, NB, scale)
    valid = np.asarray(batch.token_valid)
    np.testing.assert_allclose(_f32(out)[valid], _f32(ref)[valid],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H", [4, 2])
def test_aliased_block_tables_match_jax_and_dealiased(H):
    """Two sequences' tables share one physical block: the port reads the
    same KV as a de-aliased copy, and the same output as the JAX kernel."""
    kv, aliased, dealiased, bs, valid = \
        jax_tests.TestAliasedBlockTables()._aliased_batch()
    D = kv.shape[4]
    q = jnp.asarray(np.random.RandomState(6).randn(
        aliased.token_ids.shape[0], H, D).astype(np.float32))
    scale = 1.0 / np.sqrt(D)
    out_alias = paged_attention(*_torch_args(kv, q, aliased, torch.float32),
                                bs, NB, scale)
    out_dealias = paged_attention(
        *_torch_args(kv, q, dealiased, torch.float32), bs, NB, scale)
    np.testing.assert_allclose(_f32(out_alias)[valid],
                               _f32(out_dealias)[valid], atol=1e-6,
                               rtol=1e-6)
    ref = jax_pallas_paged_attention(kv, q, aliased.seq_slot,
                                     aliased.positions, aliased.block_tables,
                                     bs, NB, scale)
    np.testing.assert_allclose(_f32(out_alias)[valid], _f32(ref)[valid],
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    kv, q, batch, bs, scale = _case(4)
    args = _torch_args(kv, q, batch, torch.float32)
    before = paged_attention.launches
    out = paged_attention(*args, bs, NB, scale)
    assert paged_attention.launches == before
    torch.testing.assert_close(out, paged_attention_plain(*args, bs, NB,
                                                          scale))
    # the package re-exports the same wrapper (one launch counter)
    assert pa_reexport is paged_attention


def test_other_devices_raise_never_fall_back():
    kv, q, batch, bs, scale = _case(4)
    kv_t, q_t, slot_t, pos_t, tab_t = _torch_args(kv, q, batch,
                                                  torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(kv_t.to("meta"), q_t.to("meta"), slot_t.to("meta"),
                        pos_t.to("meta"), tab_t.to("meta"), bs, NB, scale)


# --- the quantized cache: (codes, scales) pairs -----------------------------

_CODES = {"int8": (jnp.int8, torch.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _quantized(kv, code):
    """(JAX (codes, scales), port (codes, scales)) of a cache, quantized
    by the JAX package's ``_quantize_kv`` and carried over bit for bit."""
    from deepspeed_tpu.inference.model import _quantize_kv
    from deepspeed_tpu_torch.models import params_from_numpy
    codes, scales = _quantize_kv(jnp.asarray(kv), _CODES[code][0])
    port = params_from_numpy({"c": np.asarray(codes),
                              "s": np.asarray(scales)}, device="cpu")
    assert port["c"].dtype == _CODES[code][1]
    return (codes, scales), (port["c"], port["s"])


@pytest.mark.parametrize("code", sorted(_CODES))
@pytest.mark.parametrize("H", [4, 2])
def test_quantized_cache_plain_matches_jax(code, H):
    """One-shot and chunked plain versions on an int8 / fp8 cache against
    the JAX Pallas kernel (interpret) and its XLA formulations, fp32 q:
    the same dequantized rows, sums in another order (1e-5)."""
    kv, q, batch, bs, scale = _case(H, seed=7)
    jkv, pkv = _quantized(kv, code)
    _, q_t, slot_t, pos_t, tab_t = _torch_args(kv, q, batch, torch.float32)
    args = (q_t, slot_t, pos_t, tab_t, bs, NB, scale)
    out = paged_attention(pkv, *args)
    chunked = paged_attention_chunked(pkv, *args)
    pallas = jax_pallas_paged_attention(jkv, q, batch.seq_slot,
                                        batch.positions, batch.block_tables,
                                        bs, NB, scale)
    xla = _paged_attention(jkv, q, batch, bs, NB, scale)
    xla_chunked = _paged_attention_chunked(jkv, q, batch, bs, NB, scale)
    valid = np.asarray(batch.token_valid)
    for got, ref in ((out, pallas), (out, xla), (chunked, xla_chunked),
                     (chunked, out)):
        np.testing.assert_allclose(_f32(got)[valid], _f32(ref)[valid],
                                   atol=1e-5, rtol=1e-5)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("code", sorted(_CODES))
def test_quantized_cache_bf16_q_matches_jax(code):
    """bf16 q (the serving dtype): the rows dequantize to bf16 on both
    sides; the bar of tests/test_paged_attention.py (2e-2)."""
    kv, q, batch, bs, scale = _case(4, seed=8)
    jkv, pkv = _quantized(kv, code)
    q16 = q.astype(jnp.bfloat16)
    _, q_t, slot_t, pos_t, tab_t = _torch_args(kv, q16, batch,
                                               torch.bfloat16)
    out = paged_attention(pkv, q_t, slot_t, pos_t, tab_t, bs, NB, scale)
    assert out.dtype == torch.bfloat16
    ref = jax_pallas_paged_attention(jkv, q16, batch.seq_slot,
                                     batch.positions, batch.block_tables,
                                     bs, NB, scale)
    valid = np.asarray(batch.token_valid)
    np.testing.assert_allclose(_f32(out)[valid], _f32(ref)[valid],
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("code", sorted(_CODES))
def test_quantized_cache_aliased_block_tables(code):
    kv, aliased, dealiased, bs, valid = \
        jax_tests.TestAliasedBlockTables()._aliased_batch()
    jkv, pkv = _quantized(kv, code)
    D = kv.shape[4]
    q = jnp.asarray(np.random.RandomState(9).randn(
        aliased.token_ids.shape[0], 4, D).astype(np.float32))
    scale = 1.0 / np.sqrt(D)
    a = _torch_args(kv, q, aliased, torch.float32)[1:]
    d = _torch_args(kv, q, dealiased, torch.float32)[1:]
    out_alias = paged_attention(pkv, *a, bs, NB, scale)
    out_dealias = paged_attention(pkv, *d, bs, NB, scale)
    np.testing.assert_allclose(_f32(out_alias)[valid],
                               _f32(out_dealias)[valid], atol=1e-6,
                               rtol=1e-6)
    ref = jax_pallas_paged_attention(jkv, q, aliased.seq_slot,
                                     aliased.positions, aliased.block_tables,
                                     bs, NB, scale)
    np.testing.assert_allclose(_f32(out_alias)[valid], _f32(ref)[valid],
                               atol=1e-5, rtol=1e-5)


def test_quantized_cache_counts_no_launch_on_cpu():
    kv, q, batch, bs, scale = _case(4)
    _, pkv = _quantized(kv, "int8")
    args = _torch_args(kv, q, batch, torch.float32)[1:]
    before = (paged_attention.launches, paged_attention.int8_launches,
              paged_attention.fp8_launches)
    paged_attention(pkv, *args, bs, NB, scale)
    assert (paged_attention.launches, paged_attention.int8_launches,
            paged_attention.fp8_launches) == before


# --- every head dim the kernel now takes, and an MQA group of 8 ---------------

@pytest.mark.parametrize("cache", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("D, H, Hkv", [(32, 4, 2), (80, 4, 2), (96, 4, 2),
                                       (256, 4, 2), (64, 8, 1)],
                         ids=["d32", "d80", "d96", "d256", "mqa-rep8"])
def test_plain_matches_jax_kernel_every_head_dim(D, H, Hkv, cache):
    """The plain version (the card kernel's reference) against the JAX
    Pallas kernel (interpret mode) at D 32, 80, 96 and 256 and an MQA rep
    of 8, bf16 q with a bf16 cache or an int8 / fp8 one (quantized by the
    JAX package and carried over bit for bit): the bar of
    tests/test_paged_attention.py (2e-2)."""
    kv, batch, bs = jax_tests._mixed_batch(Hkv=Hkv, D=D, seed=D + H)
    q = jnp.asarray(np.random.RandomState(D).randn(
        batch.token_ids.shape[0], H, D), jnp.bfloat16)
    scale = 1.0 / np.sqrt(D)
    _, q_t, slot_t, pos_t, tab_t = _torch_args(kv, q, batch, torch.bfloat16)
    if cache == "bf16":
        jkv = kv.astype(jnp.bfloat16)
        pkv = _torch_args(jkv, q, batch, torch.bfloat16)[0]
    else:
        jkv, pkv = _quantized(kv, cache)
    out = paged_attention(pkv, q_t, slot_t, pos_t, tab_t, bs, NB, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (q.shape[0], H, D)
    ref = jax_pallas_paged_attention(jkv, q, batch.seq_slot, batch.positions,
                                     batch.block_tables, bs, NB, scale)
    valid = np.asarray(batch.token_valid)
    np.testing.assert_allclose(_f32(out)[valid], _f32(ref)[valid],
                               atol=2e-2, rtol=2e-2)
