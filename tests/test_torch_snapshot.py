"""The port's serving seam held against the JAX engine's: snapshots,
restore, migration, health and drain (tests/test_failures.py's
``TestSnapshotRestore`` and ``TestHealthDrain``), in fp32 on the same
``llama-tiny`` weights (tests/test_torch_failures.py's fixtures).

A snapshot is plain host data with one schema (version 2) in both
packages: a JAX ``snapshot()`` restores onto the port's engine and a
port snapshot onto the JAX engine, each finishing the uninterrupted JAX
streams token for token, greedy and seeded.  Every request record of a
snapshot taken at the same point of the same run is equal across the
two engines, and so is ``health()``.
"""

import importlib

import pytest

from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.telemetry.lifecycle import \
    TERMINAL_STATUSES as JAX_TERMINAL_STATUSES
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.telemetry.lifecycle import TERMINAL_STATUSES
from tests.test_torch_failures import (GREEDY, SEEDED, jax_engine, key_for,
                                       models, pool_is_whole, port_engine,
                                       sampling_for)

__all__ = ["models"]          # the shared module-scoped fixture

BOTH = ("jax", "port")


def make(models, which, **kw):
    jm, pm = models
    return jax_engine(jm, **kw) if which == "jax" else port_engine(pm, **kw)


def steps(eng, prompts, n, sampling=None, seed=None, done=None):
    """``n`` step() rounds feeding tokens back; returns the output."""
    sp = sampling_for(eng, **(sampling or GREEDY))
    done = done if done is not None else {u: [] for u in prompts}
    for u, p in prompts.items():
        eng.put(u, list(p))
    for _ in range(n):
        for u, t in eng.step(rng=key_for(eng, seed), sampling=sp).items():
            done[u].append(int(t))
            eng.put(u, [int(t)])
    return done


def finish(eng, done, n_tok, sampling=None, seed=None):
    """Run the engine's open requests of ``done`` to ``n_tok`` tokens."""
    sp = sampling_for(eng, **(sampling or GREEDY))
    active = {u for u in done if len(done[u]) < n_tok}
    n = 0
    while active:
        n += 1
        assert n < 200, f"wedged with {active}"
        for u, t in eng.step(rng=key_for(eng, seed), sampling=sp).items():
            if u not in active:
                continue
            done[u].append(int(t))
            if len(done[u]) >= n_tok:
                active.discard(u)
                eng.flush(u)
            else:
                eng.put(u, [int(t)])
    return done


PROMPTS = {0: [3, 1, 4, 1, 5, 9, 2, 6], 1: [2, 7, 1, 8], 2: [11, 12, 13]}
# (sampling, seed) of the runs held against the JAX engine's streams
CROSS = {"greedy": (GREEDY, None), "seeded": (SEEDED, 7)}


def test_terminal_statuses_are_the_reference():
    assert TERMINAL_STATUSES == JAX_TERMINAL_STATUSES
    assert {"failed", "migrated", "handed_off"} <= set(TERMINAL_STATUSES)


def test_snapshot_schema_and_records_match_jax(models):
    """The same run on both engines snapshots to equal records (priority,
    remaining deadline present, exact streams, generated output, the
    SLO class) and the same schema; the port's restore resumes it."""
    snaps = {}
    for which in BOTH:
        eng = make(models, which)
        eng.put(0, [1, 2, 3, 4, 5], priority=1, deadline_ms=60_000.0,
                slo_class="interactive")
        eng.put(1, [7, 8, 9])
        eng.step()
        snaps[which] = (eng, eng.snapshot())
    (jeng, js), (peng, ps) = snaps["jax"], snaps["port"]
    assert set(ps) == set(js) and ps["version"] == js["version"] == 2
    assert ps["engine_version"]
    assert ps["counters"] == js["counters"]
    assert isinstance(ps["prefix_index"], list)

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "deadline_ms"}
                for r in recs]
    assert strip(ps["requests"]) == strip(js["requests"])
    recs = {r["uid"]: r for r in ps["requests"]}
    assert recs[0]["priority"] == 1 and recs[0]["slo"] == "interactive"
    assert 0 < recs[0]["deadline_ms"] <= 60_000.0
    assert recs[0]["exact"] and recs[1]["exact"]
    eng2 = InferenceEngine.restore(models[1], ps, peng.icfg)
    assert eng2.query(0)["status"] == "queued"
    assert eng2.query(0)["generated"] == peng.query(0)["generated"]
    assert eng2.requests.open[0].slo_class == "interactive"
    out = {}
    for _ in range(20):
        out.update(eng2.step())
        if len(out) == 2:
            break
    assert set(out) == {0, 1}


@pytest.mark.parametrize("bad", [1, 3, None])
def test_restore_rejects_wrong_version(models, bad):
    with pytest.raises(ValueError, match="version"):
        InferenceEngine.restore(models[1], {"version": bad, "requests": []})


def test_inexact_records_close_failed(models):
    eng = make(models, "port")
    eng.load_snapshot({"version": 2, "requests": [
        {"uid": 5, "tokens": None, "generated": [3], "exact": False},
        {"uid": 6, "tokens": [1, 2], "generated": [], "exact": True},
    ]})
    assert eng.query(5)["status"] == "failed"
    assert 5 in eng._drain_reaped()
    assert eng.query(6)["status"] == "queued"
    assert int(eng.timings["requests_failed"]) == 1


def test_snapshot_requests_extracts_subset(models):
    parts = {}
    for which in BOTH:
        eng = make(models, which)
        for uid in (0, 1, 2):
            eng.put(uid, [1 + uid, 2, 3, 4])
        eng.step()
        part = eng.snapshot_requests([1, 2, 777, 2])
        assert part["version"] == 2 and part["partial"]
        assert [r["uid"] for r in part["requests"]] == [1, 2]
        assert eng.query(1)["status"] in ("running", "queued")
        full = {r["uid"]: r for r in eng.snapshot()["requests"]}
        for r in part["requests"]:
            assert r == full[r["uid"]]
        parts[which] = part["requests"]
    assert parts["port"] == parts["jax"]


def test_load_snapshot_refuses_nonfresh_without_merge(models):
    src = make(models, "port")
    src.put(0, [1, 2, 3])
    snap = src.snapshot()
    dst = make(models, "port")
    dst.put(5, [9, 8, 7])
    with pytest.raises(ValueError, match="merge=True"):
        dst.load_snapshot(snap)
    dst.load_snapshot(snap, merge=True)
    assert dst.query(0)["status"] == "queued"
    assert dst.query(5)["status"] == "queued"


def test_merge_rejects_uid_collision_atomically(models):
    src = make(models, "port")
    src.put(0, [1, 2, 3])
    snap = src.snapshot()
    dst = make(models, "port")
    dst.put(0, [4, 5, 6])
    with pytest.raises(ValueError, match="already open"):
        dst.load_snapshot(snap, merge=True)
    rec = snap["requests"][0]
    with pytest.raises(ValueError, match="repeats"):
        make(models, "port").load_snapshot(
            {"version": 2, "requests": [rec, dict(rec)]}, merge=True)
    # a payload refused on its second record applies none of it
    src.put(7, [9, 9, 9])
    two = src.snapshot_requests([7, 0])
    dst3 = make(models, "port")
    dst3.put(0, [4, 5, 6])
    with pytest.raises(ValueError, match="already open"):
        dst3.load_snapshot(two, merge=True)
    assert dst3.query(7)["status"] == "unknown"


def test_migrate_out_skips_non_replayable_streams(models):
    eng = make(models, "port")
    eng.put(0, [1, 2, 3, 4])
    eng.step()
    eng.state.seqs[0].chain_broken = True   # e.g. after a decode burst
    assert eng.migrate_out([0])["requests"] == []
    assert eng.query(0)["status"] == "running"


@pytest.mark.parametrize("name", sorted(CROSS))
def test_migrate_out_moves_open_work_like_jax(models, jax_cross, name):
    """migrate_out() closes ``migrated`` on the source and frees its KV;
    load_snapshot(merge=True) re-opens on a destination already serving;
    the streams equal the unmigrated JAX run, and the destination writes
    no new cache tensor (its graphs stay valid)."""
    sampling, seed = CROSS[name]
    ref = jax_cross[name][0]
    src, dst = make(models, "port"), make(models, "port")
    kv_ptr = dst.state.kv.data_ptr()
    for u in (1, 2):
        dst.put(u, list(PROMPTS[u]))
    done = steps(src, {0: PROMPTS[0]}, 3, sampling, seed)
    done.update({1: [], 2: []})
    part = src.migrate_out([0])
    assert [r["uid"] for r in part["requests"]] == [0]
    assert src.query(0)["status"] == "migrated"
    assert 0 in src._drain_reaped()
    pool_is_whole(src)
    dst.load_snapshot(part, merge=True)
    assert dst.state.kv.data_ptr() == kv_ptr
    finish(dst, done, 6, sampling, seed)
    assert done == ref


def test_handoff_out_and_tier_seam(models, monkeypatch):
    """handoff_out closes ``handed_off`` (no KV tier: the decode side
    re-prefills); export_tier_chain is None with the tier off, and
    tier_blocks arriving in a payload are dropped with a warning."""
    src, dst = make(models, "port"), make(models, "port")
    src.put(0, PROMPTS[0])
    first = src.step()
    part = src.handoff_out([0])
    assert src.query(0)["status"] == "handed_off"
    assert src.export_tier_chain([b"\x00" * 32]) is None
    part["tier_blocks"] = [{"digest": "00"}]
    warned = []
    eng_mod = importlib.import_module("deepspeed_tpu_torch.inference.engine")
    monkeypatch.setattr(eng_mod.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    dst.load_snapshot(part, merge=True)
    assert len(warned) == 1 and "1 tier_blocks" in warned[0]
    assert dst.step() == first


@pytest.fixture(scope="module")
def jax_cross(models):
    """A JAX snapshot taken after 3 steps, and the streams of the same
    engine run on uninterrupted (a snapshot changes nothing), greedy and
    seeded."""
    out = {}
    for name, (sampling, seed) in CROSS.items():
        eng = make(models, "jax")
        done = steps(eng, PROMPTS, 3, sampling, seed)
        snap = eng.snapshot()
        partial = {u: list(v) for u, v in done.items()}
        out[name] = (finish(eng, done, 6, sampling, seed), partial, snap)
    return out


@pytest.mark.parametrize("name", sorted(CROSS))
def test_jax_snapshot_restores_on_port(models, jax_cross, name):
    sampling, seed = CROSS[name]
    ref, done, snap = jax_cross[name]
    eng = InferenceEngine.restore(models[1], snap,
                                  port_engine(models[1]).icfg)
    got = finish(eng, {u: list(v) for u, v in done.items()}, 6, sampling,
                 seed)
    assert got == ref
    pool_is_whole(eng)


@pytest.mark.parametrize("name", sorted(CROSS))
def test_port_snapshot_restores_on_jax(models, jax_cross, name):
    sampling, seed = CROSS[name]
    ref, jdone, jsnap = jax_cross[name]
    eng = make(models, "port")
    done = steps(eng, PROMPTS, 3, sampling, seed)
    assert done == jdone
    snap = eng.snapshot()
    assert snap["requests"] == jsnap["requests"]
    jeng = JaxEngine.restore(models[0], snap, make(models, "jax").icfg)
    got = finish(jeng, {u: list(v) for u, v in done.items()}, 6, sampling,
                 seed)
    assert got == ref


# --------------------------------------------------------------------------
# health and drain
# --------------------------------------------------------------------------

def test_health_ladder_matches_jax(models):
    """healthy -> degraded inside the window -> healthy after it ->
    draining; a dead engine reads dead.  health() is the JAX engine's
    dict, field for field."""
    seen = {}
    for which in BOTH:
        eng = make(models, which, failure=dict(health_window_steps=3))
        ladder = [eng.health()]
        eng.put(0, [1, 2, 3, 4])
        eng.put(1, [5, 6, 7])
        eng.failures.inject("crash")
        eng.step()
        ladder.append(eng.health())
        done = finish(eng, {0: [], 1: []}, 8)
        ladder.append(eng.health())
        assert eng.metrics.get("serving_health_state").value() == 0
        eng.drain(deadline_ms=1000.0)
        ladder.append(eng.health())
        dead = make(models, which, failure=dict(fatal_timeouts=1))
        dead.put(0, [1, 2])
        dead.failures.inject("timeout")
        with pytest.raises(Exception, match="dead"):
            dead.step()
        ladder.append(dead.health())
        seen[which] = (ladder, done)
    ladder, done = seen["port"]
    assert [h["state"] for h in ladder] == ["healthy", "degraded",
                                            "healthy", "draining", "dead"]
    assert ladder[1]["step_retries"] == 1 and ladder[1]["probing"]
    # the auto deadline scales with each engine's own measured step time
    # (the JAX engine's first steps carry its compiles): not compared
    for which in BOTH:
        for h in seen[which][0]:
            t = h.pop("dispatch_deadline_ms")
            assert t is None or t >= 10_000.0
    assert seen["port"] == seen["jax"]


def test_drain_contract(models):
    eng = make(models, "port")
    eng.put(0, [1, 2, 3, 4])
    eng.put(1, [5, 6, 7])
    eng.step()
    snap = eng.drain(deadline_ms=30_000.0)
    assert eng.health()["state"] == "draining"
    assert {r["uid"] for r in snap["requests"]} == {0, 1}
    assert snap["shed_uids"] == [0, 1] and snap["completed_uids"] == []
    assert all(eng.query(u)["status"] == "shed" for u in (0, 1))
    assert eng.requests.aggregate()["open"] == 0
    v = eng.put(9, [1])
    assert not v.admitted and "draining" in v.reason
    pool_is_whole(eng)
    eng2 = InferenceEngine.restore(models[1], snap, eng.icfg)
    assert eng2.query(0)["status"] == "queued"


def test_drain_respects_deadline(models):
    eng = make(models, "port")
    eng.put(0, list(range(1, 30)))
    snap = eng.drain(deadline_ms=0.0)
    assert eng.query(0)["status"] == "shed"
    assert {r["uid"]: r for r in snap["requests"]}[0]["exact"]
    assert snap["shed_uids"] == [0]


def test_drain_splits_completed_from_shed(models):
    eng = make(models, "port")
    eng.put(0, [1, 2, 3, 4])
    eng.put(1, [5, 6, 7], deadline_ms=0.0)
    snap = eng.drain(deadline_ms=30_000.0)
    assert snap["shed_uids"] == [0] and snap["completed_uids"] == [1]
    assert eng.query(1)["status"] == "deadline_exceeded"
    assert {r["uid"] for r in snap["requests"]} == {0}


@pytest.mark.parametrize("name", sorted(CROSS))
def test_replaced_drained_requests_keep_parity(models, jax_cross, name):
    """Drain a replica mid-decode, re-place exactly its ``shed_uids``
    on a live one (merge=True): the streams equal an undisturbed JAX
    run."""
    sampling, seed = CROSS[name]
    ref = jax_cross[name][0]
    src = make(models, "port")
    done = steps(src, PROMPTS, 3, sampling, seed)
    snap = src.drain(deadline_ms=30_000.0)
    assert set(snap["shed_uids"]) == set(PROMPTS)
    dst = make(models, "port")
    dst.put(9, [1, 2, 3])
    recs = {r["uid"]: r for r in snap["requests"]}
    dst.load_snapshot({"version": 2, "requests": [recs[u] for u in
                                                  snap["shed_uids"]]},
                      merge=True)
    finish(dst, done, 6, sampling, seed)
    assert done == ref
