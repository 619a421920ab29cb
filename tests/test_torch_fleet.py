"""The port's fleet layer (``deepspeed_tpu_torch.serving``: the router,
replicas, placement, the fleet telemetry plane) held against the JAX
package's.

One seeded trace from ``tools/loadgen.make_trace`` (pure Python) with a
replica kill, a quarantine and a live migration runs through a JAX fleet
and a port fleet of two ``llama-tiny`` replicas each (2 layers, d 64,
fp32, the port's weights carried over from the JAX model), replayed by
``tools/loadgen.replay_fleet`` with the fleet chaos bar checked after
every step (``check_fleet_invariants``: allocator partitions, one owner
per open request, records reconciled with the counters).  Placements,
verdicts, tokens, terminal statuses, migrations, the reconciled statuses
and every integer-valued series of the fleet exposition must be equal:
the JAX side is deterministic (greedy, fp32) and so is the port's CPU
path, so every comparison is exact.  Each fleet runs once, in a
module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import serving as jserving
from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.telemetry import parse_prometheus_text as jparse
from deepspeed_tpu_torch import serving as tserving
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.telemetry import parse_prometheus_text as tparse
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)
from tools.loadgen import Fault, make_trace, replay_fleet

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=8,
              num_kv_blocks=24, max_seq_len=96)
FAULTS = [Fault("migrate", step=6), Fault("quarantine", step=9),
          Fault("kill", step=14)]


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model("llama-tiny", vocab_size=128, num_layers=2,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         max_seq_len=96)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _fleet(pkg, model, n=2, **fleet_kw):
    if pkg == "jax":
        engines = {f"r{i}": JaxEngine(model, JaxConfig(
            **ENGINE, kv_dtype=jnp.float32, param_dtype=jnp.float32,
            attn_impl="xla")) for i in range(n)}
        return jserving.FleetRouter(engines,
                                    jserving.FleetConfig(**fleet_kw))
    engines = {f"r{i}": InferenceEngine(model, InferenceConfig(
        **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32))
        for i in range(n)}
    return tserving.FleetRouter(engines, tserving.FleetConfig(**fleet_kw))


def _trace():
    trace = make_trace(seed=5, n_requests=14, qps=6.0, prompt_lens=(4, 30),
                       out_lens=(3, 7), vocab=120)
    # two requests share a 2-block prefix with an earlier one, arriving
    # once its blocks are indexed: affinity
    src = max(trace[:4], key=lambda q: len(q.prompt))
    for q in (trace[5], trace[9]):
        q.prompt[:0] = src.prompt[:16]
        q.step = max(q.step, src.step + 3)
    return sorted(trace, key=lambda q: q.step)


def _int_series(text, parse):
    """Integer-valued samples of the counter and gauge families, without
    the timing-derived ones (their values are clocks) and the compile
    counters (the JAX engines compile on the CPU; the port captures CUDA
    graphs on the card only)."""
    out = {}
    for name, fam in parse(text).items():
        if fam["type"] == "histogram" or "compile" in name \
                or "_ms" in name or name.endswith(("_util", "_mfu")) \
                or "rate" in name or "seconds" in name:
            continue
        for key, v in fam["samples"].items():
            if float(v).is_integer():
                out[key] = v
    return out


@pytest.fixture(scope="module")
def replays(models):
    jm, pm = models
    out = {}
    for pkg, model, sp in (("jax", jm, JaxSampling),
                           ("port", pm, SamplingParams)):
        router = _fleet(pkg, model, telemetry="on")
        res = replay_fleet(router, _trace(), FAULTS,
                           sampling=sp(max_new_tokens=1 << 30),
                           check_invariants=True)
        out[pkg] = res
    return out


def test_fleet_replay_matches_jax(replays):
    j, t = replays["jax"], replays["port"]
    for key in ("steps", "verdicts", "placements", "tokens", "status",
                "faults_fired"):
        assert t[key] == j[key], key
    assert t["faults_fired"] == len(FAULTS)
    jr, tr = j["router"], t["router"]
    assert tr.replica(tr.replica_names[0]).dead \
        or tr.replica(tr.replica_names[1]).dead
    assert [n for n in tr.replica_names if tr.replica(n).dead] \
        == [n for n in jr.replica_names if jr.replica(n).dead]
    for name in ("serving_fleet_migrations_total",
                 "serving_fleet_placements_total",
                 "serving_fleet_placement_affinity_hits_total"):
        assert tr.metrics.series_sum(name) == jr.metrics.series_sum(name)
    assert tr.metrics.series_sum("serving_fleet_migrations_total") > 0
    assert tr.metrics.series_sum(
        "serving_fleet_placement_affinity_hits_total") > 0
    assert tserving.reconciled_terminal_statuses(tr) \
        == jserving.reconciled_terminal_statuses(jr)
    assert tr.request_metrics()["aggregate"]["statuses"] \
        == jr.request_metrics()["aggregate"]["statuses"]


def test_fleet_exposition_integer_series_match(replays):
    jr, tr = replays["jax"]["router"], replays["port"]["router"]
    jint = _int_series(jr.fleet_registry.prometheus_text(), jparse)
    tint = _int_series(tr.fleet_registry.prometheus_text(), tparse)
    missing = set(jint) - set(tint)
    assert not missing, sorted(missing)[:10]
    assert {k: tint[k] for k in jint} == jint
    assert any(k[0] == "serving_fleet_migrations_total" for k in jint)


def test_fleet_dump_and_journeys(replays, tmp_path):
    import json
    jr, tr = replays["jax"]["router"], replays["port"]["router"]
    tdump = tr.debug_dump(str(tmp_path / "t"))
    jdump = jr.debug_dump(str(tmp_path / "j"))
    for dump in (tdump, jdump):
        assert tserving.validate_fleet_dump(dump) == []
        assert jserving.validate_fleet_dump(dump) == []
    written = json.loads((tmp_path / "t" / "fleet.json").read_text())
    assert jserving.validate_fleet_dump(written) == []
    for name in tr.replica_names:
        flight = json.loads((tmp_path / "t" / "replicas" / name
                             / "flight.json").read_text())
        from deepspeed_tpu.telemetry import validate_flight_dump
        assert validate_flight_dump(flight) == []
    # every request's journey has the same events in both fleets
    def events(router, uid):
        return [(e.get("event"), e.get("replica"), e.get("step"))
                for e in router._ftel.journey(uid) or []]
    trace = _trace()
    tj = {q.uid: events(tr, q.uid) for q in trace}
    assert tj == {q.uid: events(jr, q.uid) for q in trace}
    assert any(ev == "migrated" or ev == "placed" and step > 0
               for j in tj.values() for ev, _, step in j)


# --------------------------------------------------------------------------
# units: placement, the breaker, ranking
# --------------------------------------------------------------------------

def test_placement_digests_and_ranking_match():
    r = np.random.RandomState(0)
    toks = [int(x) for x in r.randint(0, 128, 45)]
    for bs in (4, 8, 16):
        assert tserving.prompt_digests(toks, bs) \
            == jserving.prompt_digests(toks, bs)
    dig = tserving.prompt_digests(toks, 8)
    cands = [("a", set(dig[:2]), 3), ("b", set(dig[:4]), 5),
             ("c", set(), 0), ("d", set(dig[1:]), 1)]
    for policy in ("affinity", "least_loaded", "round_robin"):
        for rr in range(3):
            assert tserving.rank_replicas(policy, dig, cands, rr) \
                == jserving.rank_replicas(policy, dig, cands, rr)
    roles = {"a": "prefill", "b": "decode", "c": "mixed"}
    for pool in (None, "prefill", "decode"):
        assert tserving.split_by_pool(list("abcd"), roles, pool) \
            == jserving.split_by_pool(list("abcd"), roles, pool)


def test_circuit_breaker_walk_matches():
    walks = {}
    for name, pkg in (("jax", jserving), ("port", tserving)):
        b = pkg.CircuitBreaker(threshold=2, probe_interval=3)
        seen = []
        for step in range(30):
            if step % 7 in (1, 2) or step in (11, 12, 13):
                seen.append(("f", b.record_failure(step)))
            else:
                b.record_success()
            seen.append((b.state, b.routable))
        walks[name] = seen
    assert walks["port"] == walks["jax"]


class _ScriptedRouter:
    """What ``Autoscaler`` reads and calls on a router, driven by a
    scripted series: each evaluation sets the prefill and decode pools'
    total loads (spread over their members) and may fire fleet
    anomalies; scale-ups, drains, flight notes and counter increments
    are recorded."""

    def __init__(self):
        from types import SimpleNamespace
        self._steps = 0
        self._ftel = SimpleNamespace(monitor=SimpleNamespace(counts={}))
        self.members = {"prefill": ["p0"], "decode": ["d0"]}
        self.loads = {}
        self.log = []
        self.flight = SimpleNamespace(
            note=lambda kind, **kw: self.log.append(("note", kind, kw)))
        self._c_scale_ups = SimpleNamespace(
            inc=lambda **kw: self.log.append(("up", kw)))
        self._c_scale_downs = SimpleNamespace(
            inc=lambda **kw: self.log.append(("down", kw)))

    def enable_telemetry(self):
        self.log.append(("telemetry",))

    def pool_members(self, pool):
        from types import SimpleNamespace
        return [SimpleNamespace(name=n, load=lambda n=n: self.loads[n])
                for n in self.members[pool]]

    def add_replica(self, name, engine, role):
        self.members[role].append(name)
        self.log.append(("add", name, engine, role))

    def scale_down(self, name):
        for names in self.members.values():
            if name in names:
                names.remove(name)
        self.log.append(("drain", name))

    def advance(self, totals, fired):
        self._steps += 1
        for pool, total in totals.items():
            names = self.members[pool]
            for i, n in enumerate(names):
                self.loads[n] = total // len(names) \
                    + (i < total % len(names))
        for sig in fired:
            counts = self._ftel.monitor.counts
            counts[sig] = counts.get(sig, 0) + 1


_SIGNALS = ["placement_imbalance", "affinity_hit_rate", "ttft_divergence",
            "failover_migration_storm", "slo_burn_rate_interactive",
            "slo_burn_rate_batch", "slo_burn_rate_custom",
            "kv_pool_pressure"]


def _load_script(signals, n=160):
    """Pool loads in phases (idle, a prefill surge, a decode surge, a
    fall back to idle) with seeded noise, and fleet anomalies drawn from
    ``signals`` at seeded steps."""
    r = np.random.RandomState(3)
    script = []
    for step in range(n):
        phase = step * 4 // n
        base = {0: (0, 1), 1: (18, 2), 2: (3, 16), 3: (0, 0)}[phase]
        totals = {"prefill": base[0] + int(r.randint(0, 3)),
                  "decode": base[1] + int(r.randint(0, 3))}
        fired = [signals[int(r.randint(len(signals)))]] \
            if r.rand() < 0.06 else []
        script.append((totals, fired))
    return script


@pytest.mark.parametrize("knobs, signals", [
    (dict(), _SIGNALS),
    (dict(hysteresis_steps=1, cooldown_steps=0), ["slo_burn_rate_batch"]),
    (dict(evaluate_every=3, max_prefill=3, max_decode=2),
     ["ttft_divergence", "failover_migration_storm"]),
    (dict(min_prefill=2, up_load=2.0, down_load=1.0, cooldown_steps=4),
     ["slo_burn_rate_custom", "kv_pool_pressure"])],
    ids=["default", "eager", "sparse", "floor2"])
def test_autoscaler_decisions_match_jax(knobs, signals):
    """The same load and anomaly series through the JAX and the port
    ``Autoscaler`` (over one scripted router each) gives equal
    decisions, replicas minted and drained, flight notes, counter
    increments, streaks and summaries, step by step.  The decisions are
    integer step counts and loads, so the comparison is exact."""
    runs = {}
    for name, pkg in (("jax", jserving), ("port", tserving)):
        router = _ScriptedRouter()
        for pool in ("prefill", "decode"):
            lo = knobs.get(f"min_{pool}", 1)
            router.members[pool] = [f"{pool[0]}{i}" for i in range(lo)]
        scaler = pkg.Autoscaler(router, lambda pool: f"engine-{pool}",
                                pkg.AutoscalerConfig(**knobs))
        trail = []
        for totals, fired in _load_script(signals):
            router.advance(totals, fired)
            scaler.on_router_step()
            trail.append((dict(scaler._up_streak),
                          dict(scaler._down_streak),
                          {k: list(v) for k, v in router.members.items()}))
        runs[name] = (trail, router.log, scaler.summary())
    assert runs["port"] == runs["jax"]
    summary = runs["port"][2]
    assert summary["scale_ups"] > 0 and summary["scale_downs"] > 0


@pytest.mark.parametrize("knobs", [
    dict(min_prefill=0), dict(max_decode=0), dict(hysteresis_steps=0),
    dict(cooldown_steps=-1), dict(evaluate_every=0),
    dict(up_load=1.0, down_load=1.0)])
def test_autoscaler_config_refusals_match_jax(knobs):
    """The same invalid knobs raise the same ``ValueError`` in both."""
    msgs = []
    for pkg in (jserving, tserving):
        with pytest.raises(ValueError) as e:
            pkg.AutoscalerConfig(**knobs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_scale_up_cold_start_restores_weights_bitwise(models, tmp_path):
    """``WeightStreamColdStart`` spills the template's stacked blocks to
    the port's NVMe store once and restores them resident into every
    minted replica: bit for bit the template's, and the minted engine
    serves the template's stream."""
    from deepspeed_tpu_torch.models.transformer import tree_leaves
    _, pm = models

    def build():
        return InferenceEngine(pm, InferenceConfig(
            **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32))
    template = build()
    cold = tserving.WeightStreamColdStart(template, build,
                                          str(tmp_path / "store"))
    minted = cold()
    assert cold.restores == 1
    for a, b in zip(tree_leaves(template.params["blocks"]),
                    tree_leaves(minted.params["blocks"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    sp = SamplingParams(max_new_tokens=4)
    prompt = {0: [int(t) for t in range(3, 20)]}
    assert minted.generate(prompt, sp) == template.generate(prompt, sp)


def test_fleet_bundle_merges_through_tracemerge(models, tmp_path):
    """A port fleet with its telemetry plane on and a capture window on
    each replica: ``FleetRouter.debug_dump`` writes the JAX package's
    bundle layout, and the unchanged ``tools/tracemerge.py --fleet``
    merge puts the router's spans and both replicas' captures on one
    timeline (the second window, opened while the first held the
    process's profiler session, carries host spans only)."""
    import json

    from tools.tracemerge import merge_fleet, validate_merged_trace
    _, pm = models
    router = _fleet("port", pm, telemetry="on")
    for name in router.replica_names:
        router.replica(name).engine.capture(
            2, reason=name, out_dir=str(tmp_path / "cap" / name))
    res = replay_fleet(router, _trace()[:6],
                       sampling=SamplingParams(max_new_tokens=1 << 30))
    assert all(s == "finished" for s in res["status"].values())
    for name in router.replica_names:
        router.replica(name).engine.finish_capture()
        assert len(router.replica(name).engine.capture_dirs) == 1
    dump = router.debug_dump(str(tmp_path / "bundle"))
    assert tserving.validate_fleet_dump(dump) == []
    merged = json.loads(open(merge_fleet(str(tmp_path / "bundle"))).read())
    assert validate_merged_trace(merged, require_replicas=2) == []
    assert merged["otherData"]["replica_groups"] == 2
    assert not merged["otherData"]["device_absent"]
