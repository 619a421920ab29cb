"""Decode bursts in the port (``InferenceEngine.decode_burst``, the burst
routing of ``generate`` and ``inference.model``'s ``snapshot_prefix``,
``decode_burst_forward`` and ``scatter_tail``) held against the JAX
package on the same fp32 weights: the three functions on numpy-seeded
inputs (prefix snapshot exact; logits and KV tail within rtol = atol =
1e-5: fp32 on both sides, sums in another order; tokens equal), and the
engine token for token — greedy and seeded, prefix cache on and off, a
direct ``decode_burst()`` call, a pool too small for the full burst (it
shrinks) and a stop token inside a burst.  A quantized model's burst
runs its projections through the mixed-input GEMM's plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference import model as jax_model
from deepspeed_tpu.inference.sampler import sample_rows as jax_sample_rows
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference import model as port_model
from deepspeed_tpu_torch.inference.sampler import sample_rows
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.utils import prng
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64)
PROMPTS = {0: [5, 9, 2, 17, 3], 1: [7, 7, 1], 2: list(range(3, 40))}
SEEDED = dict(temperature=0.8, top_k=20, max_new_tokens=13)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm = jax_inference.tiny_model()
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _port(port, **over):
    kw = dict(ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(port, InferenceConfig(**kw))


def _jax(jm, **over):
    return jax_inference.make_fp32_engine(jm, attn_impl="xla", **over)


def _prompts():
    return {u: list(p) for u, p in PROMPTS.items()}


@pytest.fixture(scope="module")
def greedy_ref(models):
    jm, _ = models
    return _jax(jm, decode_burst=4).generate(
        _prompts(), JaxSampling(max_new_tokens=13))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_burst_functions_match_jax(models, sampled):
    """One burst of 3 iterations over a random cache: the prefix snapshot
    bitwise, every iteration's logits and the KV tail within 1e-5, the
    tokens equal, and the tail scattered into the same cache rows."""
    jm, port = models
    cfg = port.config
    r = np.random.RandomState(1)
    nL, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    nblocks, bs, S, steps, P = 12, 16, 4, 3, 64
    kv = r.randn(nL, nblocks + 1, bs, 2, Hkv, D).astype(np.float32)
    tables = np.full((S, nblocks), -1, np.int32)
    perm = r.permutation(nblocks)
    tables[0, :3] = perm[:3]
    tables[1, :4] = perm[3:7]
    tables[3, :2] = perm[7:9]
    base = np.array([37, 60, 0, 20], np.int32)   # slot 2 is empty
    tok0 = r.randint(1, 128, S).astype(np.int32)
    uids = np.array([3, 11, 0, 12], np.uint32)
    sp = SamplingParams(**SEEDED) if sampled else SamplingParams()
    jsp = JaxSampling(**SEEDED) if sampled else JaxSampling()
    key = jax.random.PRNGKey(9)

    jlogits, plogits = [], []

    def jax_sample(logits, keys):
        jax.debug.callback(lambda x: jlogits.append(np.asarray(x)), logits,
                           ordered=True)
        return jax_sample_rows(logits, jsp, keys)

    def port_sample(logits, keys):
        plogits.append(logits.clone())
        return sample_rows(logits, sp, keys)

    jprefix = jax_model.snapshot_prefix(jnp.asarray(kv), jnp.asarray(tables),
                                        P, bs)
    jtoks, jtail = jax_model.decode_burst_forward(
        jm.config, jm.params, jprefix, jnp.asarray(base), jnp.asarray(tok0),
        steps, jax_sample, key, uids=jnp.asarray(uids))
    jkv = jax_model.scatter_tail(jnp.asarray(kv), jtail,
                                 jnp.asarray(tables), jnp.asarray(base), bs)

    pkv = torch.from_numpy(kv.copy())
    ptables = torch.from_numpy(tables)
    pbase = torch.from_numpy(base)
    pprefix = port_model.snapshot_prefix(pkv, ptables, P, bs)
    assert np.array_equal(pprefix.numpy(), np.asarray(jprefix))
    ptoks, ptail = port_model.decode_burst_forward(
        port.config, port.params, pprefix, pbase, torch.from_numpy(tok0),
        steps, port_sample,
        prng.key_from_numpy(np.asarray(key)) if sampled else None,
        uids=torch.from_numpy(uids.view(np.int32)))
    assert len(plogits) == len(jlogits) == steps
    for got, want in zip(plogits, jlogits):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(ptoks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(ptail.numpy(), np.asarray(jtail), **TOL)
    port_model.scatter_tail(pkv, ptail, ptables, pbase, bs)
    np.testing.assert_allclose(pkv.numpy(), np.asarray(jkv), **TOL)


def test_quantized_cache_burst_functions(models):
    """An int8 cache snapshots as (codes, scales) and the tail is
    quantized on scatter, as in the reference."""
    jm, port = models
    cfg = port.config
    r = np.random.RandomState(2)
    nL, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shape = (nL, 9, 16, 2, Hkv, D)
    codes = r.randint(-127, 128, shape).astype(np.int8)
    scales = (r.rand(*shape[:-1]) * 0.02).astype(np.float32)
    tables = np.full((2, 8), -1, np.int32)
    tables[0, :2] = [4, 1]
    tables[1, :1] = [6]
    base = np.array([20, 9], np.int32)
    tok0 = np.array([5, 77], np.int32)
    greedy = lambda logits, keys: jax_sample_rows(  # noqa: E731
        logits, JaxSampling(), keys)
    jkv = (jnp.asarray(codes), jnp.asarray(scales))
    jprefix = jax_model.snapshot_prefix(jkv, jnp.asarray(tables), 32, 16)
    jtoks, jtail = jax_model.decode_burst_forward(
        jm.config, jm.params, jprefix, jnp.asarray(base), jnp.asarray(tok0),
        2, greedy, jax.random.PRNGKey(0))
    jout = jax_model.scatter_tail(jkv, jtail, jnp.asarray(tables),
                                  jnp.asarray(base), 16)
    pkv = (torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy()))
    pprefix = port_model.snapshot_prefix(pkv, torch.from_numpy(tables), 32,
                                         16)
    for got, want in zip(pprefix, jprefix):
        assert np.array_equal(got.numpy(), np.asarray(want))
    ptoks, ptail = port_model.decode_burst_forward(
        port.config, port.params, pprefix, torch.from_numpy(base),
        torch.from_numpy(tok0), 2,
        lambda logits, keys: sample_rows(logits, SamplingParams(), keys),
        None)
    assert np.array_equal(ptoks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(ptail.numpy(), np.asarray(jtail), **TOL)
    port_model.scatter_tail(pkv, ptail, torch.from_numpy(tables),
                            torch.from_numpy(base), 16)
    # codes may differ by one step where a value sits on a rounding half
    dc = np.abs(pkv[0].numpy().astype(np.int32)
                - np.asarray(jout[0]).astype(np.int32))
    assert dc.max() <= 1
    np.testing.assert_allclose(pkv[1].numpy(), np.asarray(jout[1]), **TOL)


@pytest.mark.parametrize("prefix_cache", ["on", "off"])
def test_generate_with_bursts_matches_jax(models, greedy_ref, prefix_cache):
    """``decode_burst=4``: greedy streams equal the JAX engine's (which
    bursts too); the engine ran bursts at the full width only."""
    _, port = models
    eng = _port(port, decode_burst=4, prefix_cache=prefix_cache)
    out = eng.generate(_prompts(), SamplingParams(max_new_tokens=13))
    assert out == greedy_ref
    assert eng.timings["bursts"] >= 2
    assert eng.timings["burst_iterations"] == 4 * eng.timings["bursts"]
    eng.state.allocator.assert_invariants()
    assert eng.state.allocator.referenced_blocks == 0
    # the stepwise engine gives the same stream
    assert _port(port).generate(_prompts(), SamplingParams(
        max_new_tokens=13)) == greedy_ref


def test_seeded_generate_with_bursts_matches_jax(models):
    jm, port = models
    ref = _jax(jm, decode_burst=4).generate(
        _prompts(), JaxSampling(**SEEDED), rng=jax.random.PRNGKey(5))
    for prefix_cache in ("on", "off"):
        eng = _port(port, decode_burst=4, prefix_cache=prefix_cache)
        out = eng.generate(_prompts(), SamplingParams(**SEEDED),
                           rng=prng.PRNGKey(5))
        assert out == ref, prefix_cache
        assert eng.timings["bursts"] >= 1


def test_stop_token_inside_a_burst(models, greedy_ref):
    """A stop token that fires mid-burst truncates the stream there (each
    stream is the greedy reference cut at its first stop)."""
    _, port = models
    stop = greedy_ref[0][5]        # the 2nd token of request 0's 2nd burst
    want = {u: t[:t.index(stop) + 1] if stop in t else t
            for u, t in greedy_ref.items()}
    sp = SamplingParams(max_new_tokens=13, stop_token=stop)
    assert _port(port, decode_burst=4).generate(_prompts(), sp) == want


def _after_first_burst(eng, prompt, sp, rng=None):
    """Prefill ``prompt``, feed its first token, burst 5: the burst."""
    eng.put(0, prompt)
    eng.put(0, [eng.step(sampling=sp)[0]])
    return eng.decode_burst(5, sampling=sp, rng=rng)


def test_seeded_direct_decode_burst_matches_jax(models):
    """A seeded direct burst (``rng=PRNGKey(3)``; the prefill step draws
    from each engine's own key stream) equals the JAX engine's."""
    jm, port = models
    prompt = [2, 4, 6, 8]
    want = _after_first_burst(_jax(jm), prompt, JaxSampling(**SEEDED),
                              jax.random.PRNGKey(3))
    got = _after_first_burst(_port(port), prompt, SamplingParams(**SEEDED),
                             prng.PRNGKey(3))
    assert got == {0: [int(t) for t in want[0]]}


def test_direct_decode_burst_matches_jax(models):
    """``decode_burst(5)`` after the prefill: the tokens and the advanced
    context against the JAX engine's direct call; prefill steps are
    refused; a stop token at a burst's second token stops its tokens
    and its context there."""
    jm, port = models
    prompt = [2, 4, 6, 8]
    want = _after_first_burst(_jax(jm), prompt, JaxSampling())
    peng = _port(port)
    peng.put(0, prompt)
    with pytest.raises(ValueError, match="single-token"):
        peng.decode_burst(4)
    peng.flush(0)
    got = _after_first_burst(peng, prompt, SamplingParams())
    assert got == {0: [int(t) for t in want[0]]}
    assert peng.state.seqs[0].seen_tokens == 4 + 1 + 4
    peng.put(0, [got[0][-1]])
    nxt = peng.decode_burst(4)[0]
    stopped = _port(port)
    _after_first_burst(stopped, prompt, SamplingParams())
    stopped.put(0, [got[0][-1]])
    out = stopped.decode_burst(4, sampling=SamplingParams(stop_token=nxt[1]))
    assert out[0] == nxt[:nxt.index(nxt[1]) + 1]
    assert stopped.state.seqs[0].seen_tokens == 9 + len(out[0])


def test_burst_shrinks_under_pool_pressure(models):
    """8 blocks of 16 for two sequences and ``decode_burst=64``: the
    burst shrinks to what the pool holds (or to single steps), as in the
    JAX engine, and the streams agree."""
    jm, port = models
    prompts = {0: list(range(1, 30)), 1: list(range(30, 55))}
    kw = dict(num_kv_blocks=8, kv_block_size=16, decode_burst=64)
    ref = _jax(jm, **kw).generate({u: list(p) for u, p in prompts.items()},
                                  JaxSampling(max_new_tokens=40))
    eng = _port(port, **kw)
    out = eng.generate({u: list(p) for u, p in prompts.items()},
                       SamplingParams(max_new_tokens=40))
    assert out == ref
    assert len(out[0]) > 0 and len(out[1]) > 0


def test_quantized_burst_runs_the_mixed_gemm(models):
    """int8 weights, ``mixed_gemm="on"``: the burst's projections go
    through ``mixed_matmul`` (its plain version on the CPU) and its
    greedy stream equals the stepwise engine's on the same weights."""
    _, port = models
    calls = []
    real = port_model.mixed_matmul

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    kw = dict(weight_quant="int8", mixed_gemm="on")
    sp = SamplingParams(max_new_tokens=9)
    prompts = {0: [5, 9, 2, 17, 3], 1: [7, 7, 1]}
    ref = _port(port, **kw).generate(dict(prompts), sp)
    eng = _port(port, decode_burst=4, **kw)
    port_model.mixed_matmul = counting
    try:
        eng.put(0, prompts[0])
        eng.put(1, prompts[1])
        out = eng.step(sampling=sp)
        for u, t in out.items():
            eng.put(u, [t])
        calls.clear()
        burst = eng.decode_burst(4, sampling=sp)
    finally:
        port_model.mixed_matmul = real
    L = port.config.num_layers
    assert len(calls) == 7 * L * 4            # 7 projections, 4 iterations
    for u in prompts:
        assert [out[u]] + burst[u] == ref[u][:5]
