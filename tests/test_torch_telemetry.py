"""The port's telemetry (``deepspeed_tpu_torch.telemetry``, the engines'
telemetry methods and ``monitor``) held against the JAX package's.

Units feed the same inputs to both packages: the same metric updates give
byte-equal Prometheus text and equal JSONL snapshots; the same value
series give equal anomaly events from the detector catalogs; the same
request stamps give equal SLO scorecards; the same spans give equal
Chrome traces.  The engines (``llama-tiny``, 2 layers, d 64, fp32, the
port's weights carried over from the JAX model) serve the same traffic
with tracing, anomaly detection, SLOs and device telemetry on: their
integer-valued series and terminal statuses are equal, and so are the
span names by step.  Device telemetry off, anomaly detection off and
SLOs off add no clock read to a step; a CPU ``torch.profiler`` capture
of either engine merges through the unchanged ``tools/tracemerge.py``.
Tolerances: everything compared here is exact (integers, strings, and
floats computed from equal inputs by the same host arithmetic), except
where a test states otherwise.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference import (FailureConfig, InferenceConfig,
                                           InferenceEngine, SamplingParams)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)
from tools.tracemerge import merge_capture, validate_merged_trace

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=8,
              num_kv_blocks=24, max_seq_len=96)
TELEMETRY = dict(trace=True, anomaly="on", slo="on",
                 device_telemetry="on")


# --------------------------------------------------------------------------
# registries, detectors, SLO trackers, tracers: same inputs, equal outputs
# --------------------------------------------------------------------------

def _fill(pkg):
    """One registry of every metric kind, updated identically."""
    reg = pkg.MetricsRegistry()
    c = reg.counter("serving_steps_total", "steps", int_valued=True)
    f = reg.counter("serving_stage_ms_total", "stage ms")
    g = reg.gauge("serving_health_state", "health")
    h = reg.histogram("serving_ttft_ms", (1.0, 10.0, 100.0), "ttft")
    reg.gauge_fn("serving_kv_blocks_free", lambda: 17, "free blocks")
    reg.gauge_fn("serving_prefix_hit_rate", lambda: None, "absent")
    for i in range(7):
        c.inc()
        f.inc(0.25 * i)
        h.observe(3.0 * i * i)
        c.inc(2, kind="quant" if i % 2 else "exact")
    g.set(1)
    g.set(3, device="0")
    return reg


def test_equal_registries_give_byte_equal_exposition(tmp_path):
    j, t = _fill(jtel), _fill(ttel)
    text = t.prometheus_text()
    assert text == j.prometheus_text()
    assert ttel.parse_prometheus_text(text) \
        == jtel.parse_prometheus_text(text)
    # the parser of each package reads the other's text
    assert ttel.parse_prometheus_text(j.prometheus_text())[
        "serving_steps_total"]["samples"]
    snap_t, snap_j = t.snapshot(), j.snapshot()
    snap_t.pop("time", None), snap_j.pop("time", None)
    assert snap_t == snap_j
    t.write_jsonl(str(tmp_path / "t.jsonl"))
    j.write_jsonl(str(tmp_path / "j.jsonl"))
    lt = json.loads((tmp_path / "t.jsonl").read_text())
    lj = json.loads((tmp_path / "j.jsonl").read_text())
    lt.pop("time", None), lj.pop("time", None)
    assert lt == lj
    assert t.scalar_events(5) == j.scalar_events(5)


def _series(seed, n=400):
    r = np.random.RandomState(seed)
    x = 10.0 + r.normal(0, 0.3, n)
    x[150] += 40.0              # a spike
    x[260:300] += 25.0          # a level shift
    x[350] = -20.0
    return [float(v) for v in x]


@pytest.mark.parametrize("catalog", ["serving", "training"])
def test_same_series_give_equal_anomaly_events(catalog):
    events = {}
    for name, pkg in (("jax", jtel), ("port", ttel)):
        cfg = pkg.AnomalyConfig(warmup=8, cooldown=4)
        reg = pkg.MetricsRegistry()
        mon = pkg.AnomalyMonitor(cfg, reg, catalog)
        dets = (pkg.default_serving_detectors(cfg) if catalog == "serving"
                else pkg.default_training_detectors(cfg))
        mon.watch_all(dets)
        fired = []
        for k, signal in enumerate(sorted(dets)):
            for step, v in enumerate(_series(k)):
                ev = mon.observe(signal, v * (1 if k % 2 else 0.01), step)
                if ev is not None:
                    fired.append(ev.as_dict())
        events[name] = (fired, mon.summary(), reg.prometheus_text(),
                        mon.sustained(399))
    assert events["port"] == events["jax"]
    assert events["port"][0], "the series must fire some detector"


def _stamp(pkg, with_slo: bool):
    """A request tracker driven through one fixed stamp sequence (the
    engine's stamp sites), with an SLO tracker attached."""
    reg = pkg.MetricsRegistry()
    tr = pkg.RequestTracker(reg, max_finished=16)
    if with_slo:
        tr.slo = pkg.SloTracker(pkg.default_slo_objectives(), reg)
    classes = ("interactive", "standard", "batch", None)
    statuses = ("finished", "finished", "shed", "cancelled",
                "deadline_exceeded", "finished", "failed")
    t = 100.0
    for uid in range(21):
        t += 0.013 * (uid % 5)
        tr.on_arrival(uid, t, slo_class=classes[uid % 4])
        status = statuses[uid % len(statuses)]
        if status != "shed":
            tr.on_admitted(uid, 16 + uid, uid % 3 * 8, t + 0.002)
            tr.on_prefill_start(uid, t + 0.004)
            for k in range(1 + uid % 4):
                tr.on_tokens(uid, 1, t + 0.05 * (k + 1) * (1 + uid % 3))
        tr.on_finish(uid, t + 0.9, status=status)
    return tr, reg


def test_same_stamps_give_equal_slo_scorecards():
    jt, jreg = _stamp(jtel, True)
    tt, treg = _stamp(ttel, True)
    assert tt.slo.scorecard() == jt.slo.scorecard()
    assert tt.aggregate() == jt.aggregate()
    assert [r.as_dict() for r in tt.records()] \
        == [r.as_dict() for r in jt.records()]
    assert treg.prometheus_text() == jreg.prometheus_text()
    merged = ttel.merge_scorecards({"a": tt.slo.scorecard(),
                                    "b": tt.slo.scorecard()})
    assert merged == jtel.merge_scorecards({"a": jt.slo.scorecard(),
                                            "b": jt.slo.scorecard()})


def test_same_spans_give_equal_chrome_traces(tmp_path):
    traces = {}
    for name, pkg in (("jax", jtel), ("port", ttel)):
        tr = pkg.SpanTracer(capacity=8, enabled=True)
        t0 = 1000.0
        for sid in range(6):
            for k, phase in enumerate(("schedule", "stage", "dispatch")):
                tr.record(phase, t0 + sid + 0.1 * k, t0 + sid + 0.1 * k
                          + 0.05, track=phase, sid=sid)
        tr.disable()
        tr.record("dropped", t0, t0 + 1)       # off: nothing recorded
        traces[name] = (tr.chrome_trace(), tr.events(), tr.dropped)
        tr.export_chrome_trace(str(tmp_path / f"{name}.json"))
    assert traces["port"] == traces["jax"]
    assert json.loads((tmp_path / "port.json").read_text()) \
        == json.loads((tmp_path / "jax.json").read_text())
    assert traces["port"][2] == 18 - 8


def test_flight_recorder_validates_in_both_packages():
    t = ttel.FlightRecorder(capacity=4)
    for i in range(6):
        t.note("step_failure", step=i)
    snap = t.snapshot("unit", metrics=_fill(ttel),
                      tracer=ttel.SpanTracer(enabled=True), steps=3)
    assert ttel.validate_flight_dump(snap) == []
    assert jtel.validate_flight_dump(snap) == []
    assert [e["step"] for e in snap["events"]] == [2, 3, 4, 5]
    fp = ttel.config_fingerprint()
    assert fp["engine_version"] and len(fp["config_hash"]) == 16
    bad = dict(snap, version=99)
    del bad["spans"]
    assert ttel.validate_flight_dump(bad) == jtel.validate_flight_dump(bad)


def test_device_telemetry_gauges_from_reckoned_costs():
    """Explicit peaks: the utilization gauges divide the reckoned
    flops/bytes by the busy ms; the CPU polls no memory (absent series,
    never zeros)."""
    reg = ttel.MetricsRegistry()
    busy = [0.0]
    dt = ttel.DeviceTelemetry(reg, "serving", lambda: busy[0],
                              peak_flops=1e12, peak_hbm_bw=1e11,
                              device="cpu")
    cost = ttel.step_cost(param_count=1000, weight_bytes=4000, tokens=8,
                          attn_pairs=100, kv_keys=40, layers=2, heads=4,
                          kv_heads=2, head_dim=16, kv_elem_bytes=2)
    assert cost == {"flops": 2 * 1000 * 8 + 4 * 4 * 16 * 100 * 2,
                    "bytes_accessed": 4000 + 2 * 2 * 16 * 2 * 40 * 2}
    dt.probe_program("k", lambda: cost)
    dt.probe_program("k", lambda: 1 / 0)         # memoized: not called
    assert dt.snapshot()["mfu"] is None          # no busy time yet
    for _ in range(3):
        dt.on_dispatch("k")
    busy[0] = 2.0
    snap = dt.snapshot()
    assert snap["mfu"] == round(3 * cost["flops"] / 2e-3 / 1e12, 6)
    assert snap["hbm_bw_util"] == round(
        3 * cost["bytes_accessed"] / 2e-3 / 1e11, 6)
    assert snap["memory"] == {} and ttel.poll_memory_stats() == {}
    text = reg.prometheus_text()
    assert "serving_mfu " in text and "serving_hbm_bytes_in_use" not in text
    assert ttel.peak_flops("cpu") is None
    from deepspeed_tpu_torch.telemetry import device as dev
    assert dev._match_peak(dev.PEAK_FLOPS, "NVIDIA H100 80GB HBM3") == 989e12
    assert dev._match_peak(dev.PEAK_HBM_BW, "nvidia h100 80gb hbm3") \
        == 3.35e12


# --------------------------------------------------------------------------
# the engines: same traffic, telemetry on
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) with the same weights."""
    jm = jax_build_model("llama-tiny", vocab_size=128, num_layers=2,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         max_seq_len=256)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _prompts():
    r = np.random.RandomState(3)
    ps = [list(map(int, r.randint(1, 128, n))) for n in (20, 9, 27, 14)]
    ps[2][:16] = ps[0][:16]                       # a 2-block prefix hit
    return dict(enumerate(ps))


def jax_engine(jm, **over):
    return JaxEngine(jm, JaxConfig(**ENGINE, kv_dtype=jnp.float32,
                                   param_dtype=jnp.float32, attn_impl="xla",
                                   **over))


def port_engine(pm, **over):
    return InferenceEngine(pm, InferenceConfig(
        **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32, **over))


def _int_series(text, parse):
    """Every sample of an integer-valued counter or gauge family, by
    (sample name, labels).  Timing-derived families (ms, latency
    histograms, utilization) are left out: their values are clocks; and
    the compile counters (the JAX engine compiles its programs on the
    CPU, the port captures CUDA graphs on the card only)."""
    out = {}
    for name, fam in parse(text).items():
        if fam["type"] == "histogram" or "compile" in name \
                or "_ms" in name or name.endswith(("_util", "_mfu")) \
                or "rate" in name or "flops" in name or "bytes" in name:
            continue
        for key, v in fam["samples"].items():
            if float(v).is_integer():
                out[key] = v
    return out


@pytest.fixture(scope="module")
def served(models):
    """Both engines after the same traffic with every telemetry plane on:
    (engine, streams) by package."""
    jm, pm = models
    out = {}
    for name, make, sp in (("jax", jax_engine, JaxSampling),
                           ("port", port_engine, SamplingParams)):
        eng = make(jm if name == "jax" else pm, **TELEMETRY)
        streams = eng.generate(_prompts(), sp(max_new_tokens=6))
        out[name] = (eng, streams)
    return out


def test_engines_telemetry_matches_under_the_same_traffic(served):
    (je, js), (te, ts) = served["jax"], served["port"]
    assert ts == js
    jint = _int_series(je.metrics.prometheus_text(),
                       jtel.parse_prometheus_text)
    tint = _int_series(te.metrics.prometheus_text(),
                       ttel.parse_prometheus_text)
    missing = set(jint) - set(tint)
    assert not missing, sorted(missing)
    assert {k: tint[k] for k in jint} == jint
    for k in ("steps", "prompt_tokens", "cached_tokens", "prefix_hits",
              "generated_tokens"):
        assert te.timings[k] == je.timings[k]
        assert te.timings[k] > 0 or k in ("cached_tokens", "prefix_hits")
    assert te.request_metrics()["aggregate"]["statuses"] \
        == je.request_metrics()["aggregate"]["statuses"]
    jcard, tcard = je.slo_scorecard(), te.slo_scorecard()
    assert tcard["enabled"] and tcard.keys() == jcard.keys()
    for cls, entry in jcard["classes"].items():
        for oname, o in entry["objectives"].items():
            got = tcard["classes"][cls]["objectives"][oname]
            # latency objectives compare wall clocks of two engines;
            # availability and deadline-met are exact
            assert got["evaluated"] == o["evaluated"]
            if oname in ("availability", "deadline_met"):
                assert got["good"] == o["good"]
    assert te.anomaly_summary()["total"] >= 0
    assert te.metrics_snapshot().keys() \
        >= {"serving_steps_total", "serving_ttft_ms"}


def test_engines_record_the_same_spans_by_step(served):
    """The same span names on the same steps (the JAX engine's
    ``compile`` spans mark XLA compiles; the port on the CPU captures no
    graph)."""
    def by_sid(eng):
        out = {}
        for ev in eng.tracer.events():
            if ev["name"] == "compile":
                continue
            key = (ev.get("args") or {}).get("sid")
            out.setdefault(key, []).append((ev["name"], ev["track"]))
        return {k: sorted(v) for k, v in out.items()}
    je, te = served["jax"][0], served["port"][0]
    assert by_sid(te) == by_sid(je)
    names = {ev["name"] for ev in te.tracer.events()}
    assert {"schedule", "stage", "dispatch", "wait", "readback",
            "prefix_match"} <= names
    trace = te.tracer.chrome_trace()
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"} \
        >= {"schedule", "dispatch", "readback"}


def test_device_snapshot_reckons_each_step_key_once(served):
    te = served["port"][0]
    snap = te.device_snapshot()
    assert snap["programs"] and all(
        c["flops"] > 0 and c["bytes_accessed"] > 0
        for c in snap["programs"].values())
    assert snap["model_flops_total"] > 0 and snap["memory"] == {}
    assert snap["mfu"] is None          # no published peak for the CPU
    health = te.health()
    assert health["state"] in ("healthy", "degraded")
    assert health["anomalies"] == te.anomaly_summary()["total"]


@pytest.mark.parametrize("plane", ["device_telemetry", "anomaly", "slo"])
def test_telemetry_adds_no_clock_reads_per_warm_step(models, plane):
    """A plane turned on adds no ``time.perf_counter`` call to a warm
    step: the detectors and the SLO tracker ride the timestamps the loop
    already takes, and device telemetry reckons a key's cost once."""
    _, pm = models
    sp = SamplingParams(max_new_tokens=1 << 30)
    counts = {}
    for mode in ("off", "on"):
        eng = port_engine(pm, **{plane: mode})
        eng.put(0, _prompts()[0])
        tok = None
        while tok is None:
            tok = eng.step(sampling=sp).get(0)
        eng.put(0, [tok])
        eng.step(sampling=sp)            # warm: this key reckoned
        eng.put(0, [tok])
        real, n = time.perf_counter, [0]

        def counting():
            n[0] += 1
            return real()
        time.perf_counter = counting
        try:
            eng.step(sampling=sp)
        finally:
            time.perf_counter = real
        counts[mode] = n[0]
    assert counts["on"] == counts["off"] > 0, counts


def test_off_planes_build_nothing(models, monkeypatch):
    from deepspeed_tpu_torch.telemetry import anomaly, device, profiler

    def forbidden(*a, **k):
        raise AssertionError("a telemetry hook ran with its plane off")
    monkeypatch.setattr(device.DeviceTelemetry, "probe_program", forbidden)
    monkeypatch.setattr(device, "poll_memory_stats", forbidden)
    monkeypatch.setattr(anomaly.AnomalyMonitor, "observe", forbidden)
    monkeypatch.setattr(profiler.ProfilerCapture, "begin", forbidden)
    eng = port_engine(models[1])
    assert eng.devtel is None and eng._anom is None and eng._cap is None \
        and eng._slo is None and not eng.tracer.enabled
    eng.generate({0: _prompts()[0]}, SamplingParams(max_new_tokens=3))
    eng.health()
    assert eng.device_snapshot() is None and eng.anomaly_summary() is None
    assert eng.slo_scorecard() == {"enabled": False}
    assert eng.capture_dirs == [] and eng.tracer.events() == []


def test_capture_window_merges_through_tracemerge(models, tmp_path):
    """A CPU ``torch.profiler`` window over 2 steps of the port's engine
    writes the JAX package's capture layout; the unchanged tracemerge
    puts the profiler's events on the host spans' timeline."""
    _, pm = models
    eng = port_engine(pm, failure=FailureConfig(
        flight_dir=str(tmp_path / "flight")))
    cdir = eng.capture(2, out_dir=str(tmp_path / "cap"))
    assert cdir.startswith(str(tmp_path / "cap"))
    eng.generate(_prompts(), SamplingParams(max_new_tokens=5))
    assert eng.capture_dirs == [cdir] and not eng.tracer.enabled
    meta = json.loads(open(f"{cdir}/meta.json").read())
    assert meta["profiler"] and meta["device_dir"] == "device"
    assert meta["sid_end"] - meta["sid_start"] == 1
    flight = json.loads(open(f"{cdir}/flight.json").read())
    assert ttel.validate_flight_dump(flight) == []
    merged = json.loads(open(merge_capture(cdir)).read())
    assert validate_merged_trace(merged) == []
    host = [e for e in merged["traceEvents"]
            if e.get("pid") == 1 and e.get("ph") == "X"]
    dev = [e for e in merged["traceEvents"]
           if e.get("pid", 0) >= 10_000 and e.get("ph") == "X"]
    assert {e["name"] for e in host} >= {"schedule", "dispatch", "wait"}
    # the profiler's events land inside the window on the host clock
    # (tolerance: the 50 ms the profiler takes to start and stop)
    lo = meta["t_start_perf_ns"] / 1e3 - 5e4
    hi = meta["t_stop_perf_ns"] / 1e3 + 5e4
    assert dev and all(lo <= e["ts"] <= hi for e in dev)
    # a second explicit window, and ops/debug dumps into flight_dir
    assert eng.ops_dump().startswith(str(tmp_path / "flight"))
    snap = eng.debug_dump(str(tmp_path / "d.json"))
    assert jtel.validate_flight_dump(snap) == []
    assert eng.capture(2) is not None and eng.finish_capture() is None


def test_flight_dumps_on_failures_and_death(models, tmp_path):
    """The engine's three dump triggers, as the JAX engine's: the first
    failure of a window (health_degraded), a watchdog expiry and the
    fatal engine-dead transition, each a valid artifact."""
    from deepspeed_tpu_torch.inference import EngineDeadError
    _, pm = models
    d = tmp_path / "flight"
    eng = port_engine(pm, failure=FailureConfig(flight_dir=str(d)))
    sp = SamplingParams(max_new_tokens=1 << 30)
    prompts = _prompts()

    def serve(steps):
        for _ in range(steps):
            for uid, tok in eng.step(sampling=sp).items():
                eng.put(uid, [tok])
    for uid in (0, 1):
        eng.put(uid, prompts[uid])
    eng.failures.inject("transient")
    serve(2)
    eng.failures.inject("timeout")
    serve(4)
    eng.failures.inject("fatal")
    with pytest.raises(EngineDeadError):
        serve(20)
    reasons = sorted(p.name.split("_s")[0] for p in d.glob("*.json"))
    assert reasons == ["flight_engine_dead", "flight_health_degraded",
                       "flight_watchdog_expiry"]
    for p in d.glob("*.json"):
        assert ttel.validate_flight_dump(json.loads(p.read_text())) == []
    kinds = [e["kind"] for e in eng.flight.events()]
    assert kinds.count("step_failure") == 3 and "engine_dead" in kinds
    assert eng.health()["state"] == "dead"


# --------------------------------------------------------------------------
# training: telemetry, capture, monitor
# --------------------------------------------------------------------------

def test_training_telemetry_capture_and_monitor(tmp_path):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.monitor import CSVMonitor, MonitorMaster
    m = build_model("gpt2", num_layers=2, d_model=64, num_heads=4,
                    vocab_size=128, max_seq_len=32, device="cpu")
    eng = tds.initialize(model=m, device="cpu", config={
        "train_micro_batch_size_per_device": 2, "steps_per_print": 2,
        "telemetry": {"trace": True, "anomaly": True, "device": True,
                      "profile": str(tmp_path / "cap"), "profile_steps": 2},
        "csv_monitor": {"enabled": True, "output_path": str(tmp_path),
                        "job_name": "job"}})
    assert isinstance(eng.monitor, MonitorMaster)
    assert isinstance(eng.monitor.writers[0], CSVMonitor)
    batch = {"input_ids": np.random.RandomState(0).randint(
        0, 128, (2, 16)).astype(np.int64)}
    for _ in range(4):
        eng.train_batch(batch)
    snap = eng.metrics_snapshot()
    assert snap["training_steps_total"] == 4
    assert len(eng.capture_dirs) == 1
    merged = json.loads(open(merge_capture(eng.capture_dirs[0])).read())
    assert validate_merged_trace(merged) == []
    names = {e["name"] for e in eng.tracer.events()}
    assert {"pre_step", "stage", "dispatch", "fetch"} <= names
    dsnap = eng.devtel.snapshot()
    assert dsnap["programs"]["train_step"]["flops"] == \
        6.0 * eng.num_params * 2 * 16
    assert eng.anomaly_summary()["captures"] == eng.capture_dirs
    eng.monitor.flush()
    written = {p.name for p in (tmp_path / "job").iterdir()}
    assert {"Train_loss.csv", "Train_lr.csv"} <= written
    assert any(n.startswith("training_steps_total") for n in written)
