"""The port's BERT-class encoder (``models/encoder.py``) and its HF
importers (``checkpoint/hf.py``: ``load_hf_bert``, ``load_hf_distilbert``)
held against ``transformers`` models built from config classes and
against the JAX package on the same weights: the converted trees bitwise
the JAX converters' (the dicts consumed), ``encode`` and ``pooled``
against HF's hidden states and pooler output and against JAX's, and
``encode_batch`` ("cls", "mean", "none") on mixed-length requests against
JAX's ``Encoder``, a request's embedding alone equal to it padded into a
batch.

Tolerances: against HF atol 2e-3 / rtol 1e-3 (fp32, another attention
and norm arithmetic: tests/test_hf_import.py's); against JAX a whole
model 1e-4 max|JAX| (the same ops in another summation order); trees
bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as tf

from deepspeed_tpu.checkpoint import hf as jhf
from deepspeed_tpu.models import encoder as je
from deepspeed_tpu_torch.checkpoint import hf as thf
from deepspeed_tpu_torch.models import encoder as te
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

DIMS = dict(vocab_size=256, d_model=64, num_layers=2, num_heads=4, d_ff=128,
            max_seq_len=64)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{pre}/{k}").items()}
    return {pre: tree}


def _pair(hf, jconv, tconv, **over):
    """(JAX Encoder, port Encoder) on ``hf``'s weights, the converted trees
    held bitwise and the port's dict consumed."""
    jcfg = je.EncoderConfig(**DIMS, **over)
    tcfg = te.EncoderConfig(**DIMS, **over)
    sd = hf.state_dict()
    jp = jconv(jcfg, {k: v.numpy() for k, v in sd.items()})
    mine = dict(sd)
    tp = tconv(tcfg, mine)
    assert not mine
    jf, tfl = _flat(jp), _flat(tp)
    assert sorted(jf) == sorted(tfl)
    for k in jf:
        np.testing.assert_array_equal(tfl[k], jf[k], err_msg=k)
    return (je.Encoder.from_params(jcfg, jax.tree.map(jnp.asarray, jp)),
            te.Encoder.from_params(tcfg, tp))


@pytest.fixture(scope="module")
def bert():
    hf = tf.BertModel(tf.BertConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()
    return (hf, *_pair(hf, jhf.load_hf_bert, thf.load_hf_bert))


def test_bert_hidden_and_pooled_match_hf_and_jax(bert):
    hf, jenc, tenc = bert
    r = np.random.RandomState(1)
    ids = r.randint(1, 250, (2, 12))
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    types = np.zeros_like(ids)
    types[0, 6:] = 1
    with torch.no_grad():
        out = hf(torch.tensor(ids), attention_mask=torch.tensor(mask),
                 token_type_ids=torch.tensor(types))
        h = te.encode(tenc.config, tenc.params, torch.tensor(ids),
                      attention_mask=torch.tensor(mask),
                      token_type_ids=torch.tensor(types))
        pool = te.pooled(tenc.config, tenc.params, h)
    jh = je.encode(jenc.config, jenc.params, jnp.asarray(ids),
                   attention_mask=jnp.asarray(mask),
                   token_type_ids=jnp.asarray(types))
    ref = out.last_hidden_state.numpy()
    # padded positions differ on every side; compare the live ones
    for row, n in ((0, 12), (1, 8)):
        np.testing.assert_allclose(h[row, :n].numpy(), ref[row, :n],
                                   atol=2e-3, rtol=1e-3)
        _close(h[row, :n].numpy(), np.asarray(jh)[row, :n])
    np.testing.assert_allclose(pool.numpy(), out.pooler_output.numpy(),
                               atol=2e-3, rtol=1e-3)
    _close(pool.numpy(), je.pooled(jenc.config, jenc.params, jh))


@pytest.mark.parametrize("pool", ["cls", "mean", "none"])
def test_encode_batch_matches_jax(bert, pool):
    """Mixed lengths padded into the 16- and the 32-token buckets."""
    _, jenc, tenc = bert
    r = np.random.RandomState(2)
    for lens in ((3, 8, 1), (20, 5, 31, 12)):
        reqs = [list(map(int, r.randint(1, 250, n))) for n in lens]
        types = [[0] * (n // 2) + [1] * (n - n // 2) for n in lens]
        want = jenc.encode_batch(reqs, token_type_ids=types, pool=pool)
        got = tenc.encode_batch(reqs, token_type_ids=types, pool=pool)
        if pool == "none":
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                _close(g.numpy(), w)
        else:
            assert got.shape == (len(reqs), 64)
            _close(got.numpy(), want)
            # padding does not leak: a request alone equals it in a batch
            solo = tenc.encode_batch([reqs[1]], token_type_ids=[types[1]],
                                     pool=pool)
            np.testing.assert_allclose(solo[0].numpy(), got[1].numpy(),
                                       atol=1e-5)
    with pytest.raises(ValueError, match="max_seq_len"):
        tenc.encode_batch([[1] * 65])


def test_distilbert_matches_hf_and_jax():
    hf = tf.DistilBertModel(tf.DistilBertConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
        max_position_embeddings=64, dropout=0.0,
        attention_dropout=0.0)).eval()
    jenc, tenc = _pair(hf, jhf.load_hf_distilbert, thf.load_hf_distilbert,
                       type_vocab_size=0, pooler=False)
    ids = np.random.RandomState(2).randint(1, 250, (2, 10))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).last_hidden_state.numpy()
        got = te.encode(tenc.config, tenc.params, torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=1e-3)
    _close(got.numpy(), je.encode(jenc.config, jenc.params,
                                  jnp.asarray(ids)))
    reqs = [[5, 3], [9, 8, 7]]
    _close(tenc.encode_batch(reqs, pool="mean").numpy(),
           jenc.encode_batch(reqs, pool="mean"))


def test_prefixed_checkpoint_and_missing_pooler():
    """A ``BertForMaskedLM`` dict (``bert.`` prefix, no pooler): converted
    with ``pooler=False``, and refused with a KeyError that says so
    under ``pooler=True``, as the JAX converter does."""
    hf = tf.BertForMaskedLM(tf.BertConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64)).eval()
    sd = hf.state_dict()
    with pytest.raises(KeyError, match="pooler"):
        thf.load_hf_bert(te.EncoderConfig(**DIMS), dict(sd))
    tree = thf.load_hf_bert(te.EncoderConfig(**DIMS, pooler=False),
                            dict(sd), dtype=torch.bfloat16)
    jtree = jhf.load_hf_bert(je.EncoderConfig(**DIMS, pooler=False),
                             {k: v.numpy() for k, v in sd.items()})
    assert "pooler" not in tree
    t, j = _flat(tree), _flat(jtree)
    assert sorted(t) == sorted(j)
    for k in j:                    # the JAX tree in fp32, rounded to bf16
        want = torch.from_numpy(np.asarray(j[k])).to(torch.bfloat16)
        assert t[k].dtype == torch.bfloat16 and torch.equal(t[k], want), k


def test_random_encoder_runs():
    enc = te.Encoder(te.EncoderConfig(vocab_size=64, d_model=32,
                                      num_layers=2, num_heads=2,
                                      max_seq_len=32), device="cpu")
    out = enc.encode_batch([[1, 2, 3], [4, 5]], pool="none")
    assert out[0].shape == (3, 32) and out[1].shape == (2, 32)
    assert enc.encode_batch([[1, 2, 3]]).shape == (1, 32)
    with pytest.raises(ValueError, match="pool"):
        enc.encode_batch([[1]], pool="max")
