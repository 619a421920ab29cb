"""Speculative decoding in the port (``spec_decode="on"``: the copied
``inference.spec_decode.NgramProposer``, drafts in the scheduler, the
verify path of ``ragged_forward`` / ``pipelined_ragged_step`` and
acceptance at collect) held against the JAX package on the same fp32
weights: the proposer on the reference tests' inputs, the config gates,
the verify forward's logits (rtol = atol = 1e-5) and window samples, and
the served streams token for token — greedy and seeded, pipeline depth 1
and 2, prefix cache on and off, chunked prefill, a preemption, and a stop
token inside an accepted draft.  The parity bar is the tokens and the
port's own counters (drafted = accepted + rejected), never the
reference's per-request reconciliation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import KVCacheConfig as JaxKVConfig
from deepspeed_tpu.inference import NgramProposer as JaxProposer
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference import StateManager as JaxState
from deepspeed_tpu.inference import model as jax_model
from deepspeed_tpu.inference.overload import OverloadConfig as JaxOverload
from deepspeed_tpu.inference.sampler import sample_rows as jax_sample_rows
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           KVCacheConfig, NgramProposer,
                                           OverloadConfig, SamplingParams,
                                           StateManager)
from deepspeed_tpu_torch.inference import model as port_model
from deepspeed_tpu_torch.inference.sampler import sample_rows
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.utils import prng
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=16,
              num_kv_blocks=64, max_seq_len=256)
# a prompt whose n-grams recur (prompt-lookup territory) and two others
REPETITIVE = [5, 6, 7, 8] * 6
MIXED = {0: list(REPETITIVE), 1: [9, 2, 9, 2, 9, 2, 44],
         2: [3, 1, 4, 1, 5, 9, 2, 6]}
SEEDED = dict(temperature=1.0, top_k=8, max_new_tokens=16)
GREEDY_NEW = 24


@pytest.fixture(scope="module")
def models():
    jm = jax_inference.tiny_model(max_seq_len=256)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _port(port, **over):
    kw = dict(ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(port, InferenceConfig(**kw))


def _jax(jm, **over):
    kw = dict(ENGINE, attn_impl="xla", pipeline_depth=1)
    kw.update(over)
    return jax_inference.make_fp32_engine(jm, **kw)


def _mixed():
    return {u: list(p) for u, p in MIXED.items()}


@pytest.fixture(scope="module")
def greedy_ref(models):
    jm, _ = models
    return _jax(jm).generate(_mixed(), JaxSampling(max_new_tokens=GREEDY_NEW))


@pytest.fixture(scope="module")
def seeded_ref(models):
    jm, _ = models
    return _jax(jm).generate(_mixed(), JaxSampling(**SEEDED),
                             rng=jax.random.PRNGKey(7))


# ---------------------------------------------------------------------------
# the proposer: the reference tests' inputs through both classes
# ---------------------------------------------------------------------------

PROPOSALS = [
    # (max_draft, max_ngram, history, [(last_token, limit), ...])
    (3, 3, [10, 11, 12, 13, 10, 11], [(11, 3)]),
    (6, 3, [7, 7, 7], [(7, 6)]),
    (2, 3, [1, 2, 3, 1, 2], [(2, 5), (2, 1), (2, 0)]),
    (4, 3, [1, 2, 3, 4, 5], [(5, 4)]),
    (2, 3, [1, 2, 9, 50, 60, 2, 9, 70, 1, 2, 9], [(9, 2)]),
    (3, 3, [1, 2, -7, 1, 2], [(2, 3), (2, 2)]),
    (2, 3, [4, 5, 6, 4], [(5, 2)]),
]


@pytest.mark.parametrize("case", range(len(PROPOSALS)))
def test_proposer_matches_jax(case):
    max_draft, max_ngram, hist, calls = PROPOSALS[case]
    got = NgramProposer(max_draft, max_ngram=max_ngram)
    want = JaxProposer(max_draft, max_ngram=max_ngram)
    for p in (got, want):
        p.observe(1, hist)
    for last, limit in calls:
        assert got.propose(1, last, limit) == want.propose(1, last, limit)
        assert got.history_len(1) == want.history_len(1)
        assert got.lookahead(1) == want.lookahead(1)
    got.forget(1)
    assert got.history_len(1) == 0 and got.propose(1, 2, 2) == []
    with pytest.raises(ValueError, match="max_draft"):
        NgramProposer(0)
    with pytest.raises(ValueError, match="min_ngram"):
        NgramProposer(2, max_ngram=1, min_ngram=3)


# ---------------------------------------------------------------------------
# config gates (the reference's, tests/test_spec_decode.py)
# ---------------------------------------------------------------------------

def test_config_gates(models):
    _, port = models
    with pytest.raises(ValueError, match="spec_decode"):
        _port(port, spec_decode="maybe")
    with pytest.raises(ValueError, match="decode_burst"):
        _port(port, spec_decode="on", decode_burst=4)
    with pytest.raises(ValueError, match="spec_max_draft"):
        _port(port, spec_decode="on", spec_max_draft=0)
    for over in ({"spec_decode": "auto", "decode_burst": 4},
                 {"spec_decode": "auto"}, {"spec_decode": "off"}):
        eng = _port(port, **over)
        assert eng._spec is None and eng._n_verify == 1
    eng = _port(port, spec_decode="on", spec_max_draft=3)
    assert eng._spec is not None and eng._n_verify == 4
    # the token buckets start at max_seqs x the verify width
    assert eng.token_bucket(1) == 16 and eng.token_bucket(17) == 32


# ---------------------------------------------------------------------------
# the verify forward against the JAX verify path
# ---------------------------------------------------------------------------

def test_verify_forward_matches_jax(models):
    """A prefill of two prompts, then a verify batch (request 0 carries a
    3-token draft window, request 1 a plain decode token): the [S, W]
    logits within 1e-5 of the JAX ``ragged_forward``'s at every valid
    window position, and the seeded window samples (``window_keys``)
    equal to the JAX ``pipelined_ragged_step``'s."""
    jm, port = models
    cfg = port.config
    prompts = {0: [5, 6, 7, 8, 5, 6, 7], 1: [9, 2, 44]}
    verify = [(0, [8, 5, 6, 7]), (1, [31])]
    kw = dict(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, block_size=16, num_blocks=16)
    jsm = JaxState(JaxKVConfig(dtype=jnp.float32, **kw), max_seqs=4,
                   max_blocks_per_seq=8)
    psm = StateManager(KVCacheConfig(dtype=torch.float32, device="cpu",
                                     **kw), max_seqs=4, max_blocks_per_seq=8)
    jkv = jsm.kv
    b = jsm.build_batch(list(prompts.items()), 32)
    _, jkv = jax_model.ragged_forward(jm.config, jm.params, jkv, b, 16, 8)
    b = psm.build_batch(list(prompts.items()), 32)
    port_model.ragged_forward(cfg, port.params, psm.kv, b, 16, 8)
    jb = jsm.build_batch(verify, 32, draft_lens={0: 3}, n_verify=4)
    pb = psm.build_batch(verify, 32, draft_lens={0: 3}, n_verify=4)
    jlog, _ = jax_model.ragged_forward(jm.config, jm.params, jkv, jb, 16, 8)
    plog, _ = port_model.ragged_forward(cfg, port.params, psm.kv, pb, 16, 8)
    vidx = np.asarray(jb.verify_idx)
    assert np.array_equal(pb.verify_idx.numpy(), vidx)
    assert plog.shape == (4, 4, cfg.vocab_size)
    valid = vidx >= 0
    np.testing.assert_allclose(plog.numpy()[valid], np.asarray(jlog)[valid],
                               rtol=1e-5, atol=1e-5)

    key = jax.random.PRNGKey(3)
    sp, jsp = SamplingParams(**SEEDED), JaxSampling(**SEEDED)
    prev = np.zeros((4, 4), np.int32)
    jtoks, _ = jax_model.pipelined_ragged_step(
        jm.config, jm.params, None, jkv, jb, jnp.asarray(prev), key,
        lambda lg, k: jax_sample_rows(lg, jsp, k), 16, 8)
    ptoks, _ = port_model.pipelined_ragged_step(
        cfg, port.params, None, psm.kv, pb, torch.from_numpy(prev),
        prng.key_from_numpy(np.asarray(key)),
        lambda lg, k: sample_rows(lg, sp, k), 16, 8)
    assert ptoks.shape == (4, 4)
    assert np.array_equal(ptoks.numpy()[valid], np.asarray(jtoks)[valid])


# ---------------------------------------------------------------------------
# served streams
# ---------------------------------------------------------------------------

def _check_counters(eng):
    tm = eng.timings
    assert tm["spec_drafted_tokens"] == (tm["spec_accepted_tokens"]
                                         + tm["spec_rejected_tokens"])
    assert tm["spec_windows"] > 0 and tm["spec_accepted_tokens"] > 0
    assert not eng.state.seqs and not eng.state._slots
    eng.state.allocator.assert_invariants()


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("prefix_cache", ["on", "off"])
def test_greedy_streams_match_jax(models, greedy_ref, depth, prefix_cache):
    _, port = models
    eng = _port(port, spec_decode="on", spec_max_draft=4,
                pipeline_depth=depth, prefix_cache=prefix_cache)
    out = eng.generate(_mixed(), SamplingParams(max_new_tokens=GREEDY_NEW))
    assert out == greedy_ref
    _check_counters(eng)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("prefix_cache", ["on", "off"])
def test_seeded_streams_match_jax(models, seeded_ref, depth, prefix_cache):
    _, port = models
    eng = _port(port, spec_decode="on", spec_max_draft=4,
                pipeline_depth=depth, prefix_cache=prefix_cache)
    out = eng.generate(_mixed(), SamplingParams(**SEEDED),
                       rng=prng.PRNGKey(7))
    assert out == seeded_ref


def test_fewer_steps_on_a_repetitive_stream(models, greedy_ref):
    _, port = models
    sp = SamplingParams(max_new_tokens=GREEDY_NEW)
    steps = {}
    for spec in ("off", "on"):
        eng = _port(port, spec_decode=spec, pipeline_depth=1)
        assert eng.generate({0: list(REPETITIVE)}, sp) == {0: greedy_ref[0]}
        steps[spec] = eng.timings["steps"]
    assert steps["on"] < steps["off"]


def test_stop_token_inside_an_accepted_draft(models, greedy_ref):
    """Stop on the token whose first occurrence is deepest in request 0's
    stream: by then the windows accept, and the emission stops exactly
    at the stop token at depth 1 and 2."""
    _, port = models
    ref = greedy_ref[0]
    first = {}
    for i, t in enumerate(ref):
        first.setdefault(t, i)
    stop = max(first, key=first.get)
    want = ref[:ref.index(stop) + 1]
    sp = SamplingParams(max_new_tokens=GREEDY_NEW, stop_token=stop)
    for depth in (1, 2):
        eng = _port(port, spec_decode="on", spec_max_draft=4,
                    pipeline_depth=depth)
        assert eng.generate({0: list(REPETITIVE)}, sp)[0] == want, depth
        assert eng.timings["spec_accepted_tokens"] > 0


def test_chunked_prefill_matches_jax(models):
    """``prefill_chunk=4`` with a 16-token budget: drafts compete with
    prefill chunks for the budget; the streams equal the JAX engine's
    (without speculation)."""
    jm, port = models
    r = np.random.RandomState(3)
    prompts = {0: list(REPETITIVE), 1: [int(x) for x in r.randint(1, 128, 40)],
               2: [9, 2] * 8}
    kw = dict(token_budget=16, kv_block_size=8)
    sp = dict(max_new_tokens=12)
    ref = _jax(jm, overload=JaxOverload(prefill_chunk=4), **kw).generate(
        {u: list(p) for u, p in prompts.items()}, JaxSampling(**sp))
    eng = _port(port, overload=OverloadConfig(prefill_chunk=4),
                spec_decode="on", spec_max_draft=4, **kw)
    out = eng.generate({u: list(p) for u, p in prompts.items()},
                       SamplingParams(**sp))
    assert out == ref
    _check_counters(eng)


def _drive(eng, sp, plan, n_new):
    """Direct put/dispatch/collect loop keeping every emitted token; plan:
    {step: (uid, prompt, priority)} puts a request before that step."""
    done = {}
    n = 0
    while n <= max(plan) or any(len(t) < n_new for t in done.values()):
        if n in plan:
            uid, prompt, priority = plan[n]
            eng.put(uid, list(prompt), priority=priority)
            done[uid] = []
        st = eng._dispatch(sp, None)
        for uid, toks in (eng._collect(st) if st is not None else {}).items():
            done[uid] += toks[:n_new - len(done[uid])]
            if len(done[uid]) >= n_new:
                eng.flush(uid)
            else:
                eng.put(uid, [toks[-1]])
        n += 1
        assert n < 500
    return done


def test_preemption_matches_jax(models, greedy_ref):
    """A low-priority repetitive request is preempted by a high-priority
    one in a pool too small for both; with speculation on, both streams
    still equal the JAX engine's undisturbed greedy streams."""
    _, port = models
    plan = {0: (0, MIXED[0], 5), 3: (1, MIXED[1], 0)}
    sp = SamplingParams()
    eng = _port(port, spec_decode="on", spec_max_draft=4, num_kv_blocks=3,
                prefix_cache="on")
    preempted = []
    real = eng._preempt
    eng._preempt = lambda uid: (preempted.append(uid), real(uid))
    out = _drive(eng, sp, plan, 16)
    assert preempted == [0]
    assert out == {u: greedy_ref[u][:16] for u in (0, 1)}
    assert eng.timings["spec_windows"] > 0
    eng.state.allocator.assert_invariants()
