"""The port's ragged serving forward (``deepspeed_tpu_torch.inference.
model.ragged_forward``) held against the JAX package's on the same
weights (carried over with ``params_from_numpy``), the same RaggedBatch
arrays and the same starting KV cache, step after step: a prefill step,
a step mixing a chunked-prefill continuation, a decode and a new prompt,
then a decode-only step.

Shapes: a tiny llama (GQA, rope, rmsnorm, gated silu MLP, untied head),
a tiny gpt2 (learned positions, layernorm, gelu_new, tied
embeddings, biases), a tiny falcon (MQA: one KV head, parallel block,
tied embeddings) and a tiny phi (partial rotary, parallel block, biased
head; head dim 32).  Every weight gets seeded noise so biases and norm
scales are not at their trivial init values.

Tolerance: fp32, atol = rtol = 1e-4 — the same arithmetic, but sums are
taken in another order (PyTorch's matmul and softmax reductions vs XLA's
on the CPU), and the errors compound over the layers and steps.  The KV
comparison skips the trash row: the JAX step writes its budget padding
there, the port computes only the real tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.model import ragged_forward as jax_forward
from deepspeed_tpu.inference.ragged.state import (KVCacheConfig as JaxKV,
                                                  StateManager as JaxSM)
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.model import ragged_forward
from deepspeed_tpu_torch.inference.ragged.state import RaggedBatch
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

BS = 16
NUM_BLOCKS = 24
MBS = 4

MODELS = {
    "llama": ("llama-tiny", dict(vocab_size=128, num_layers=2, d_model=64,
                                 num_heads=4, num_kv_heads=2, d_ff=128,
                                 max_seq_len=128)),
    "gpt2": ("gpt2", dict(vocab_size=128, num_layers=2, d_model=64,
                          num_heads=4, max_seq_len=64)),
    # the families whose widths the card's paged attention took last: MQA
    # with a parallel block (4 query heads over 1 KV head), and partial
    # rotary with a parallel block and a biased head at head dim 32
    "falcon": ("falcon-tiny", dict(vocab_size=128, num_layers=2,
                                   d_model=128, num_heads=4,
                                   max_seq_len=128)),
    "phi": ("phi-tiny", dict(vocab_size=128, num_layers=2, d_model=128,
                             num_heads=4, max_seq_len=128)),
}


def _models(name):
    preset, over = MODELS[name]
    jm = jax_build_model(preset, seed=3, **over)
    r = np.random.RandomState(7)
    params_np = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * r.randn(*x.shape)).astype(
            np.float32), jm.params)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    port = Model.from_params(cfg, params_from_numpy(params_np, device="cpu"))
    return jm.config, jax.tree.map(jnp.asarray, params_np), port


def _to_port(b) -> RaggedBatch:
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return RaggedBatch(
        token_ids=t(b.token_ids), positions=t(b.positions),
        seq_slot=t(b.seq_slot), token_valid=t(b.token_valid),
        block_tables=t(b.block_tables), context_lens=t(b.context_lens),
        logits_idx=t(b.logits_idx), n_tokens=b.n_tokens, n_seqs=b.n_seqs,
        feedback_src=t(b.feedback_src),
        seq_uids=t(np.asarray(b.seq_uids).view(np.int32)))


def _steps(vocab):
    r = np.random.RandomState(11)
    tok = lambda n: [int(x) for x in r.randint(1, vocab, n)]  # noqa: E731
    a, b, c = tok(32), tok(7), tok(5)
    return [
        [(0, a[:20]), (1, b)],                     # two prefills
        [(0, a[20:]), (1, tok(1)), (2, c)],        # chunk + decode + new
        [(0, tok(1)), (1, tok(1)), (2, tok(1))],   # decode only
    ]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ragged_forward_matches_jax(name):
    jcfg, jparams, port = _models(name)
    sm = JaxSM(JaxKV(num_layers=jcfg.num_layers,
                     num_kv_heads=jcfg.num_kv_heads, head_dim=jcfg.head_dim,
                     block_size=BS, num_blocks=NUM_BLOCKS,
                     dtype=jnp.float32), max_seqs=4)
    kv0 = np.random.RandomState(5).randn(*sm.kv.shape).astype(np.float32)
    jkv = jnp.asarray(kv0)
    pkv = torch.from_numpy(kv0.copy())
    trash = NUM_BLOCKS
    for step in _steps(jcfg.vocab_size):
        jb = sm.build_batch(step, token_budget=32)
        jlogits, jkv = jax_forward(jcfg, jparams, jkv, jb, BS, MBS)
        plogits, pkv = ragged_forward(port.config, port.params, pkv,
                                      _to_port(jb), BS, MBS)
        rows = np.asarray(jb.logits_idx) >= 0
        np.testing.assert_allclose(plogits.numpy()[rows],
                                   np.asarray(jlogits)[rows],
                                   atol=1e-4, rtol=1e-4)
        keep = np.arange(NUM_BLOCKS + 1) != trash
        np.testing.assert_allclose(pkv.numpy()[:, keep],
                                   np.asarray(jkv)[:, keep],
                                   atol=1e-4, rtol=1e-4)


def test_dense_apply_matches_jax():
    """The port's dense plain forward (the reference chip_smoke.py checks
    the kernel path against) matches the JAX ``apply``."""
    from deepspeed_tpu.models import apply as jax_apply
    from deepspeed_tpu_torch.models import apply
    for name in sorted(MODELS):
        jcfg, jparams, port = _models(name)
        ids = np.random.RandomState(2).randint(1, 128, (2, 24))
        ref = jax_apply(jcfg, jparams, jnp.asarray(ids))
        got = apply(port.config, port.params, torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


def test_bf16_params_carry_over_exactly():
    """bf16 JAX arrays (ml_dtypes) go through float32, which is exact."""
    x = jnp.asarray(np.random.RandomState(0).randn(3, 5), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
