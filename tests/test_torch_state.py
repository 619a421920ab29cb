"""The port's ragged state (``deepspeed_tpu_torch.inference.ragged``)
held against the JAX package's: the same seeded sequence of admissions
(with prefix-cache matches), chunked prefills, decodes (concrete and
deferred feedback tokens), releases and copy-on-write drains drives a
JAX ``StateManager`` and the port's in lockstep, and every batch's
arrays, every allocation and every queued COW copy must be identical —
with the prefix cache on and off.  After every op the allocator
invariants hold (``referenced + cached_free + free == total``, refcounts
== holders).

Also ported from tests/test_scheduler_fuzz.py: the scheduler over-commit
fuzz and the prefix-cache accounting fuzz, on the port's engine (built
on the CPU; no step is dispatched)."""

import dataclasses
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.ragged.state import (KVCacheConfig as JaxKV,
                                                  StateManager as JaxSM)
from deepspeed_tpu_torch.inference import InferenceConfig, InferenceEngine
from deepspeed_tpu_torch.inference.ragged.state import (FEEDBACK_TOKEN,
                                                        BatchStager,
                                                        KVCacheConfig,
                                                        StateManager,
                                                        prefix_chain_digests)
from deepspeed_tpu_torch.models import build_model
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

BS = 4
BLOCKS = 24
SEQS = 4
BUDGET = 12
FIELDS = ("token_ids", "positions", "seq_slot", "token_valid",
          "block_tables", "context_lens", "logits_idx", "feedback_src")


def _pair(prefix_cache):
    jax_sm = JaxSM(JaxKV(num_layers=1, num_kv_heads=1, head_dim=8,
                         block_size=BS, num_blocks=BLOCKS,
                         dtype=jnp.float32), max_seqs=SEQS,
                   prefix_cache=prefix_cache)
    port_sm = StateManager(KVCacheConfig(num_layers=1, num_kv_heads=1,
                                         head_dim=8, block_size=BS,
                                         num_blocks=BLOCKS,
                                         dtype=torch.float32, device="cpu"),
                           max_seqs=SEQS, prefix_cache=prefix_cache)
    return jax_sm, port_sm


def _check_pool(sm):
    al = sm.allocator
    al.assert_invariants()
    held = Counter(b for seq in sm.seqs.values() for b in seq.blocks)
    for seq in sm.seqs.values():
        assert len(seq.blocks) == len(set(seq.blocks))
    for b, holders in held.items():
        assert al.refcount(b) == holders
    assert al.referenced_blocks == len(held)
    assert al.free_blocks + len(held) == al.total_blocks
    slots = list(sm._slots.values())
    assert len(slots) == len(set(slots))
    assert len(slots) + len(sm._free_slots) == sm.max_seqs
    for uid, _, dst in sm.cow_pending:
        assert uid in sm.seqs and dst in sm.seqs[uid].blocks
    ps = sm.pool_stats()
    assert ps["referenced"] + ps["cached_free"] + ps["free"] == ps["total"]


def _same_state(j, p):
    assert j.seqs.keys() == p.seqs.keys()
    for uid in j.seqs:
        js, ps = j.seqs[uid], p.seqs[uid]
        assert (js.blocks, js.seen_tokens, js.chain, js.chain_broken,
                js.cached_tokens, js.hashes) == \
            (ps.blocks, ps.seen_tokens, ps.chain, ps.chain_broken,
             ps.cached_tokens, ps.hashes)
    assert j._slots == p._slots and j._free_slots == p._free_slots
    assert j._hash_index == p._hash_index
    assert j.allocator._free == p.allocator._free
    assert j.allocator._refs == p.allocator._refs
    assert list(j.allocator._cached_free) == list(p.allocator._cached_free)


def _same_batch(jb, pb):
    assert (jb.n_tokens, jb.n_seqs) == (pb.n_tokens, pb.n_seqs)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(pb.seq_uids.numpy().view(np.uint32),
                                  np.asarray(jb.seq_uids))


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_state_manager_matches_jax_step_by_step(prefix_cache, seed):
    r = np.random.RandomState(seed)
    jsm, psm = _pair(prefix_cache)
    jstager = None
    pstager = BatchStager(BUDGET, SEQS, BLOCKS)
    shared = [int(t) for t in r.randint(1, 50, 9)]   # 2 full blocks + 1
    pending = {}                  # uid -> tokens not yet in a batch
    next_uid = 0
    hits = 0
    for _ in range(120):
        op = r.randint(6)
        if op == 0 and len(pending) + len(psm.seqs) < SEQS:
            toks = (shared if r.rand() < 0.5 else []) + \
                [int(t) for t in r.randint(1, 50, r.randint(1, 12))]
            uid = next_uid
            next_uid += 1
            jm = jsm.match_prefix(uid, toks)
            pm = psm.match_prefix(uid, toks)
            assert jm == pm
            hits += pm > 0
            pending[uid] = toks[pm:]
        elif op == 1 and psm.seqs:
            uid = sorted(psm.seqs)[r.randint(len(psm.seqs))]
            jsm.release(uid)
            psm.release(uid)
            pending.pop(uid, None)
        else:
            # one batch: continue prefills (chunked to the budget), then
            # decodes — concrete or deferred feedback tokens
            sched, budget, reserved = [], BUDGET, 0
            for uid in sorted(set(pending) | set(psm.seqs)):
                seq = psm.seqs.get(uid)
                rem = psm.context_remaining(uid)
                toks = pending.get(uid) or (
                    [FEEDBACK_TOKEN if r.rand() < 0.3
                     else int(r.randint(1, 50))] if seq else [])
                n = min(len(toks), budget, rem)
                if n <= 0:
                    continue
                need = seq.blocks_needed(n, BS) if seq else -(-n // BS)
                if reserved + need > psm.allocator.free_blocks:
                    continue
                sched.append((uid, toks[:n]))
                budget -= n
                reserved += need
                if uid in pending:
                    pending[uid] = pending[uid][n:]
                    if not pending[uid]:
                        del pending[uid]
            if not sched:
                continue
            assert jsm.take_cow_copies() == psm.take_cow_copies()
            jb = jsm.build_batch(sched, BUDGET, stager=jstager)
            pb = psm.build_batch(sched, BUDGET, stager=pstager)
            _same_batch(jb, pb)
            assert jsm.round_registered == psm.round_registered
        _same_state(jsm, psm)
        _check_pool(psm)
    if prefix_cache:
        assert hits > 0, "the sequence never exercised a prefix hit"
    for uid in list(psm.seqs):
        psm.release(uid)
    psm.allocator.assert_invariants()
    assert psm.allocator.free_blocks == BLOCKS


def test_prefix_digests_match_jax():
    from deepspeed_tpu.inference.ragged.state import \
        prefix_chain_digests as jax_digests
    toks = list(range(1, 40))
    assert prefix_chain_digests(toks, 8) == jax_digests(toks, 8)


def test_kv_cache_layout_and_unsupported_quant():
    cfg = KVCacheConfig(num_layers=3, num_kv_heads=2, head_dim=8,
                        block_size=4, num_blocks=5, dtype=torch.float32,
                        device="cpu")
    kv = cfg.kv_zeros()
    assert kv.shape == (3, 6, 4, 2, 2, 8)
    assert kv[1].is_contiguous()       # per-layer slices stay contiguous
    # a quantized cache is (codes, fp32 scales), as the JAX package's
    for quant, qdt, jdt in (("int8", torch.int8, jnp.int8),
                            ("fp8", torch.float8_e4m3fn, jnp.float8_e4m3fn)):
        codes, scales = dataclasses.replace(cfg, quant=quant).kv_zeros()
        jcodes, jscales = JaxKV(num_layers=3, num_kv_heads=2, head_dim=8,
                                block_size=4, num_blocks=5,
                                quant=quant).kv_zeros()
        assert codes.dtype == qdt and jcodes.dtype == jdt
        assert codes.shape == jcodes.shape == (3, 6, 4, 2, 2, 8)
        assert scales.dtype == torch.float32
        assert scales.shape == jscales.shape == (3, 6, 4, 2, 2)
        assert codes[1].is_contiguous() and scales[1].is_contiguous()
        sm = StateManager(dataclasses.replace(cfg, quant=quant), max_seqs=2)
        assert sm.device.type == "cpu" and isinstance(sm.kv, tuple)
    with pytest.raises(ValueError, match="kv_quant"):
        KVCacheConfig(num_layers=1, num_kv_heads=1, head_dim=8,
                      quant="int4", device="cpu")


# --- ported from tests/test_scheduler_fuzz.py ------------------------------

@pytest.fixture(scope="module")
def model():
    return build_model("llama-tiny", device="cpu", vocab_size=128,
                       num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, max_seq_len=256)


def _check_sched(eng, sched):
    st = eng.state
    bs = eng.icfg.kv_block_size
    assert sum(len(t) for _, t in sched) <= eng.icfg.token_budget
    need = 0
    for uid, toks in sched:
        seq = st.seqs.get(uid)
        seen = seq.seen_tokens if seq else 0
        have = len(seq.blocks) if seq else 0
        need += max(0, -(-(seen + len(toks)) // bs) - have)
        assert seen + len(toks) <= st.max_context_tokens
    assert need <= st.allocator.free_blocks
    new_seqs = {uid for uid, _ in sched if uid not in st._slots}
    assert len(new_seqs) <= len(st._free_slots)


@pytest.mark.parametrize("prefix_cache", ["off", "on"])
@pytest.mark.parametrize("seed", range(3))
def test_schedule_fuzz_invariants(model, prefix_cache, seed):
    r = np.random.RandomState(100 + seed)
    eng = InferenceEngine(model, InferenceConfig(
        token_budget=16, max_seqs=3, kv_block_size=8, num_kv_blocks=10,
        max_seq_len=48, prefix_cache=prefix_cache))
    prefixes = [list(r.randint(1, 128, n)) for n in (8, 16, 17, 24, 12)]
    next_uid = 0
    for _ in range(250):
        op = r.randint(5)
        live = list(eng.state.seqs)
        if op == 0:
            p = prefixes[r.randint(len(prefixes))]
            eng.put(next_uid, p + list(r.randint(1, 128, r.randint(0, 6))))
            next_uid += 1
        elif op == 1 and live:
            uid = live[r.randint(len(live))]
            if not eng._pending.get(uid):
                eng.put(uid, [int(r.randint(1, 128))])
        elif op == 2 and live:
            eng.flush(live[r.randint(len(live))])
        elif op == 3:
            eng.put(next_uid, list(r.randint(1, 128, r.randint(1, 40))))
            next_uid += 1
        else:
            sched = eng._schedule()
            _check_sched(eng, sched)
            if sched:
                eng.state.build_batch(sched, eng.icfg.token_budget,
                                      stager=eng._stager)
        _check_pool(eng.state)
    if prefix_cache == "on":
        assert eng.timings["prefix_hits"] > 0
    for uid in list(eng.state.seqs):
        eng.flush(uid)
    al = eng.state.allocator
    al.assert_invariants()
    assert al.referenced_blocks == 0 and al.free_blocks == al.total_blocks
    assert eng.state.cow_pending == []


# --- ported from tests/test_prefix_cache.py TestStateManagerMatching ------

def _sm():
    return StateManager(KVCacheConfig(num_layers=2, num_kv_heads=2,
                                      head_dim=16, block_size=4,
                                      num_blocks=16, dtype=torch.float32,
                                      device="cpu"),
                        max_seqs=2, prefix_cache=True)


def _release_then_match():
    sm = _sm()
    prompt = list(range(1, 11))               # 10 tokens, 2 full blocks
    sm.build_batch([(0, list(prompt))], token_budget=16)
    first = list(sm.seqs[0].blocks[:2])
    sm.release(0)
    assert sm.allocator.cached_free_blocks == 2
    assert sm.match_prefix(1, list(prompt)) == 8
    assert sm.seqs[1].blocks == first         # same physical ids
    assert sm.seqs[1].seen_tokens == sm.seqs[1].cached_tokens == 8
    return sm


def _live_sharing():
    sm = _sm()
    prompt = list(range(1, 11))
    sm.build_batch([(0, list(prompt))], token_budget=16)
    assert sm.match_prefix(1, list(prompt)) == 8
    shared = sm.seqs[1].blocks
    assert shared == sm.seqs[0].blocks[:2]
    assert all(sm.allocator.refcount(b) == 2 for b in shared)
    sm.release(0)
    assert all(sm.allocator.refcount(b) == 1 for b in shared)
    sm.release(1)
    assert sm.allocator.free_blocks == sm.allocator.total_blocks
    return sm


def _full_cover_cow():
    sm = _sm()
    prompt = list(range(1, 9))                # exactly 2 blocks
    sm.build_batch([(0, list(prompt))], token_budget=16)
    orig = list(sm.seqs[0].blocks)
    sm.release(0)
    assert sm.match_prefix(1, list(prompt)) == 7   # one token left
    seq = sm.seqs[1]
    assert seq.blocks[0] == orig[0] and seq.blocks[1] != orig[1]
    assert sm.cow_pending == [(1, orig[1], seq.blocks[1])]
    assert sm.take_cow_copies() == [(orig[1], seq.blocks[1])]
    assert sm.cow_pending == []
    return sm


def _release_drops_cow():
    sm = _sm()
    prompt = list(range(1, 9))
    sm.build_batch([(0, list(prompt))], token_budget=16)
    sm.release(0)
    sm.match_prefix(1, list(prompt))
    assert sm.cow_pending
    sm.release(1)                              # dst freed with its owner
    assert sm.cow_pending == []
    assert sm.allocator.free_blocks == sm.allocator.total_blocks
    return sm


def _eviction_leaf_first():
    sm = _sm()
    prompt = list(range(1, 11))
    sm.build_batch([(0, list(prompt))], token_budget=16)
    sm.release(0)
    sm.build_batch([(1, list(range(60, 119)))], token_budget=64)
    assert sm.allocator.cached_free_blocks == 1
    assert sm.match_prefix(2, list(prompt)) == 4   # the root survived
    return sm


def _evict_whole_chain():
    sm = _sm()
    prompt = list(range(1, 11))
    sm.build_batch([(0, list(prompt))], token_budget=16)
    sm.release(0)
    sm.build_batch([(1, list(range(60, 123)))], token_budget=64)
    assert sm.allocator.cached_free_blocks == 0
    assert set(sm._hash_index.values()) <= set(sm.seqs[1].blocks)
    assert sm.match_prefix(2, list(prompt)) == 0
    return sm


def _feedback_breaks_chain():
    sm = _sm()
    sm.build_batch([(0, [1, 2, 3])], token_budget=16)
    assert not sm.seqs[0].chain_broken
    sm.build_batch([(0, [FEEDBACK_TOKEN])], token_budget=16)
    assert sm.seqs[0].chain_broken
    assert sm.seqs[0].chain == [1, 2, 3]
    return sm


def _max_pool_take():
    sm = _sm()
    prompt = list(range(1, 14))               # 3 full blocks
    sm.build_batch([(0, list(prompt))], token_budget=16)
    sm.release(0)
    assert sm.allocator.cached_free_blocks == 3
    assert sm.match_prefix(1, list(prompt), max_pool_take=2) == 8
    return sm


@pytest.mark.parametrize("scenario", [
    _release_then_match, _live_sharing, _full_cover_cow, _release_drops_cow,
    _eviction_leaf_first, _evict_whole_chain, _feedback_breaks_chain,
    _max_pool_take], ids=lambda f: f.__name__.strip("_"))
def test_prefix_cache_matching(scenario):
    _check_pool(scenario())
