"""The port's seeded sampling against the JAX package and jax 0.9 on the
same numpy inputs.

``deepspeed_tpu_torch.utils.prng`` (threefry keys, ``split``,
``fold_in``, bits, uniforms, Gumbel noise) must equal ``jax.random``
(threefry2x32, partitionable) BIT FOR BIT; the sampler's per-row keys
(``row_keys``, ``window_keys``) likewise; ``sample_rows`` and ``sample``
must pick the JAX package's tokens on the same fp32 logits; and seeded
``generate`` streams must be token-identical to the JAX engine's, with a
caller key and with the engine's own key stream, at pipeline depth 1 and
2, on a tiny Llama and a tiny BLOOM, and invariant to a prefix-cache hit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference import sampler as jax_sampler
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference import sampler as port_sampler
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 2**31 - 1, 2**31 + 5, 2**32 - 1, 2**40 + 3, -7]
# data folded into keys: positions, uids, and uids at or above 2**31
FOLD_DATA = [0, 1, 511, 2047, 2**31 - 1, 2**31, 3 * 2**30 + 17, 2**32 - 1]


def _words(key) -> np.ndarray:
    return prng.key_to_numpy(key)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_jax_bits(seed):
    """Each JAX draw below starts from a fresh ``PRNGKey(seed)``: the
    point is that the same key gives the same words on both sides."""
    pk = prng.PRNGKey(seed)
    _bits_equal(_words(pk), jax.random.PRNGKey(seed))
    for num in (2, 3, 8):
        _bits_equal(_words(prng.split(pk, num)),
                    jax.random.split(jax.random.PRNGKey(seed), num))
    for d in FOLD_DATA:
        _bits_equal(_words(prng.fold_in(pk, d)),
                    jax.random.fold_in(jax.random.PRNGKey(seed), d))
    # a chain: split, then fold, then split again
    j2 = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed))[1],
                            77)
    p2 = prng.fold_in(prng.split(pk)[1], 77)
    _bits_equal(_words(prng.split(p2, 4)), jax.random.split(j2, 4))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 1000)])
def test_bits_uniform_and_gumbel_are_jax_bits(seed, shape):
    pk = prng.PRNGKey(seed)
    _bits_equal(prng.random_bits(pk, shape).numpy().astype(np.uint32),
                jax.random.bits(jax.random.PRNGKey(seed), shape))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                   (-3.25, 7.1)):
        _bits_equal(prng.uniform(pk, shape, lo, hi).numpy(),
                    jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=lo, maxval=hi))
    _bits_equal(prng.gumbel(pk, shape).numpy(),
                jax.random.gumbel(jax.random.PRNGKey(seed), shape))


def test_log_matches_jax_cpu_log_over_the_uniform_range():
    """The logarithm behind the Gumbel noise: every 61st of the 2**23
    values a float32 uniform in [tiny, 1) can take, and their negated
    logs (the second log of -log(-log(u)))."""
    u = np.arange(1, 2**23, 61, dtype=np.float32) * np.float32(2.0**-23)
    u = np.concatenate([[np.finfo(np.float32).tiny], u]).astype(np.float32)
    ref = np.asarray(jnp.log(jnp.asarray(u)))
    _bits_equal(prng._log_xla(torch.from_numpy(u)).numpy(), ref)
    ref2 = np.asarray(jnp.log(jnp.asarray(-ref)))
    _bits_equal(prng._log_xla(torch.from_numpy(-ref)).numpy(), ref2)


@pytest.mark.parametrize("seed", [0, 5])
def test_keys_carry_over_from_jax(seed):
    """A JAX key's words (``np.asarray``) become a port key; ``fold_in``
    and ``split`` on it give the JAX keys."""
    def jkey():
        return jax.random.fold_in(jax.random.PRNGKey(seed), 2**31 + 9)

    words = np.asarray(jkey())
    pk = prng.key_from_numpy(words)
    _bits_equal(_words(pk), words)
    _bits_equal(_words(prng.split(pk, 3)), jax.random.split(jkey(), 3))
    _bits_equal(_words(prng.fold_in(pk, 123)),
                jax.random.fold_in(jkey(), 123))
    with pytest.raises(ValueError, match="uint32"):
        prng.key_from_numpy(words.astype(np.int64))


def _uids_ctx(r, S):
    uids = np.concatenate([[0, 2**31, 2**32 - 1],
                           r.randint(0, 2**32, S - 3, dtype=np.uint64)]
                          ).astype(np.uint32)
    return uids, r.randint(1, 4096, S).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 1])
def test_row_and_window_keys_are_jax_bits(seed):
    r = np.random.RandomState(seed % 1000)
    uids, ctx = _uids_ctx(r, 8)
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    # the serving state holds uids as the int32 view of their uint32 bits
    t_uids = torch.from_numpy(uids.view(np.int32))
    _bits_equal(_words(port_sampler.row_keys(pk, t_uids,
                                             torch.from_numpy(ctx))),
                jax_sampler.row_keys(jk, jnp.asarray(uids), jnp.asarray(ctx)))
    pos = ctx[:, None] + np.arange(4, dtype=np.int32)[None, :]
    _bits_equal(_words(port_sampler.window_keys(pk, t_uids,
                                                torch.from_numpy(pos))),
                jax_sampler.window_keys(jk, jnp.asarray(uids),
                                        jnp.asarray(pos)))


SAMPLING = {"temperature": dict(temperature=0.8),
            "top_k": dict(temperature=1.0, top_k=20),
            "top_p": dict(temperature=0.7, top_p=0.9),
            "all": dict(temperature=0.8, top_k=50, top_p=0.95)}


@pytest.mark.parametrize("case", sorted(SAMPLING))
def test_sample_rows_and_sample_pick_jax_tokens(case):
    """Over 12 draws of [6, 1000] fp32 logits: every token of
    ``sample_rows`` (per-row keys) and ``sample`` (one key) equals the
    JAX package's; greedy ignores the keys."""
    r = np.random.RandomState(len(case))
    jp, pp = JaxSampling(**SAMPLING[case]), SamplingParams(**SAMPLING[case])
    for trial in range(12):
        logits = (r.randn(6, 1000) * 3).astype(np.float32)
        uids, ctx = _uids_ctx(r, 6)
        jk, pk = jax.random.PRNGKey(trial), prng.PRNGKey(trial)
        jkeys = jax_sampler.row_keys(jk, jnp.asarray(uids), jnp.asarray(ctx))
        pkeys = port_sampler.row_keys(pk, torch.from_numpy(uids),
                                      torch.from_numpy(ctx))
        got = port_sampler.sample_rows(torch.from_numpy(logits), pp, pkeys)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_sampler.sample_rows(
                jnp.asarray(logits), jp, jkeys)))
        np.testing.assert_array_equal(
            port_sampler.sample(torch.from_numpy(logits), pp, pk).numpy(),
            np.asarray(jax_sampler.sample(jnp.asarray(logits), jp, jk)))
    greedy = port_sampler.sample_rows(torch.from_numpy(logits),
                                      SamplingParams(), None)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
    with pytest.raises(ValueError, match="keys"):
        port_sampler.sample_rows(torch.from_numpy(logits), pp, None)
    assert pp.needs_rng and pp.sampler_key == jp.sampler_key


# --- seeded engine streams against the JAX engine ---------------------------

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
SEEDED = dict(temperature=0.8, top_k=20, top_p=0.9, max_new_tokens=8)


def _prompts():
    r = np.random.RandomState(11)
    tok = lambda n: [int(x) for x in r.randint(1, 128, n)]  # noqa: E731
    long = tok(40)                                 # > budget: chunked
    return {1: tok(9), 2: long, 3: tok(5), 2**31 + 4: long[:32] + tok(3)}


def _jax_bloom():
    return jax_build_model("bloom-tiny", vocab_size=128, num_layers=2,
                           d_model=64, num_heads=4, max_seq_len=128)


@pytest.fixture(scope="module", params=["llama", "bloom"])
def models(request):
    jm = (jax_inference.tiny_model() if request.param == "llama"
          else _jax_bloom())
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _jax_stream(jm, rng, depth):
    eng = jax_inference.make_fp32_engine(jm, attn_impl="xla",
                                         pipeline_depth=depth)
    return eng.generate(_prompts(), JaxSampling(**SEEDED), rng=rng)


def _port_stream(port, rng, depth, **over):
    eng = InferenceEngine(port, InferenceConfig(
        **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32,
        pipeline_depth=depth, **over))
    return eng.generate(_prompts(), SamplingParams(**SEEDED), rng=rng), eng


@pytest.mark.parametrize("depth", [1, 2])
def test_seeded_stream_matches_jax_engine(models, depth):
    """``rng=PRNGKey(5)``: the port at depth 1 and 2 equals the JAX engine
    at depth 1, token for token; a prefix-cache hit (the last prompt
    shares 32 tokens with prompt 2) changes nothing."""
    jm, port = models
    ref = _jax_stream(jm, jax.random.PRNGKey(5), 1)
    for prefix_cache in ("on", "off"):
        out, eng = _port_stream(port, prng.PRNGKey(5), depth,
                                prefix_cache=prefix_cache)
        assert out == ref, prefix_cache
        assert (eng.timings["prefix_hits"] >= 1) == (prefix_cache == "on")
        assert all(0 <= t < 128 for toks in out.values() for t in toks)


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_key_stream_matches_jax_engine(models, depth):
    """No caller key: both engines split their own ``PRNGKey(0)`` stream
    once per dispatched step, so the streams agree at the same depth."""
    jm, port = models
    ref = _jax_stream(jm, None, depth)
    out, _ = _port_stream(port, None, depth)
    assert out == ref
    # a second generate continues the stream where the first left it
    eng = InferenceEngine(port, InferenceConfig(
        **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32,
        pipeline_depth=depth))
    first = eng.generate(_prompts(), SamplingParams(**SEEDED))
    assert first == ref
    assert eng.generate(_prompts(), SamplingParams(**SEEDED)) != first
