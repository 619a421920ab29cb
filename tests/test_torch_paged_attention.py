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
