"""The port's HTTP gateway (``deepspeed_tpu_torch.gateway``) held against
the JAX package's, over loopback.

The same requests go to a JAX gateway over a JAX engine and to the port's
gateway over the port's engine (``llama-tiny``, 2 layers, d 64, fp32, the
port's weights carried over from the JAX model; an admission bound of 24
queued tokens with the reject policy).  Sent one at a time, so both
engines see the same schedule: the SSE token streams, the non-streaming
bodies, the status codes (429 on a shed with its ``Retry-After``, 503
from a dead backend), ``/healthz`` and the gateway's integer-valued
counters must be equal.  A seeded temperature gateway (``GatewayConfig.
seed``) streams the same tokens in both packages: the port's threefry
key for the seed is bit for bit JAX's.  The same gateway over a
two-replica fleet, with one replica killed between requests, gives equal
streams, SLO evaluation counts and fleet series in both packages.  Every
comparison is exact.  The wire client is ``tools/loadgen.py``'s (pure
Python).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.gateway import GatewayConfig as JaxGatewayConfig
from deepspeed_tpu.gateway import spawn_gateway as jax_spawn
from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference.overload import OverloadConfig as JaxOverload
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.telemetry import parse_prometheus_text as jparse
from deepspeed_tpu_torch.gateway import GatewayConfig, spawn_gateway
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           OverloadConfig, SamplingParams)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from deepspeed_tpu_torch.telemetry import parse_prometheus_text as tparse
from deepspeed_tpu_torch.utils.prng import PRNGKey, key_to_numpy
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)
from tools.loadgen import http_completion, http_get

ENGINE = dict(token_budget=32, max_seqs=4, kv_block_size=8,
              num_kv_blocks=24, max_seq_len=96)
QUEUED_TOKENS = 24
SEEDED = dict(temperature=0.8, top_k=20, max_new_tokens=1 << 30)


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model("llama-tiny", vocab_size=128, num_layers=2,
                         d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                         max_seq_len=96)
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _gateway(pkg, models, seed=None):
    """(handle, engine) of one package's gateway."""
    jm, pm = models
    if pkg == "jax":
        eng = JaxEngine(jm, JaxConfig(
            **ENGINE, kv_dtype=jnp.float32, param_dtype=jnp.float32,
            attn_impl="xla", overload=JaxOverload(
                max_queued_tokens=QUEUED_TOKENS, shed_policy="reject")))
        cfg = JaxGatewayConfig(
            install_signals=False, check_invariants=True, seed=seed,
            sampling=JaxSampling(**SEEDED) if seed is not None else None)
        return jax_spawn(eng, cfg), eng
    eng = InferenceEngine(pm, InferenceConfig(
        **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32,
        overload=OverloadConfig(max_queued_tokens=QUEUED_TOKENS,
                                shed_policy="reject")))
    cfg = GatewayConfig(
        install_signals=False, check_invariants=True, seed=seed,
        sampling=SamplingParams(**SEEDED) if seed is not None else None)
    return spawn_gateway(eng, cfg), eng


def _prompts():
    r = np.random.RandomState(11)
    return [[int(t) for t in r.randint(1, 128, n)] for n in (5, 12, 20, 9)]


def _wire(h, prompts, max_tokens=6):
    """One request at a time: streamed, then non-streaming, then a shed."""
    out = {}
    for i, p in enumerate(prompts):
        r = http_completion(h.host, h.port, {
            "uid": 100 + i, "prompt": p, "max_tokens": max_tokens,
            "stream": True})
        out[f"stream{i}"] = (r["code"], r["tokens"], r["finish_reason"])
    r = http_completion(h.host, h.port, {"uid": 200, "prompt": prompts[0],
                                         "max_tokens": 3})
    out["plain"] = (r["code"], r["tokens"], r["finish_reason"])
    r = http_completion(h.host, h.port, {
        "uid": 201, "prompt": list(range(1, QUEUED_TOKENS + 8)),
        "max_tokens": 3, "stream": True})
    out["shed"] = (r["code"], r["retry_after"], r["tokens"])
    return out


def _gateway_series(h):
    code, _, body = http_get(h.host, h.port, "/metrics")
    assert code == 200
    parse = tparse if "deepspeed_tpu_torch" in type(h).__module__ \
        else jparse
    return {key: v for name, fam in parse(body.decode()).items()
            if name.startswith("serving_gateway_")
            and fam["type"] != "histogram"
            for key, v in fam["samples"].items() if float(v).is_integer()}


@pytest.fixture(scope="module")
def wired(models):
    """Both gateways after the same requests: (wire results, /healthz,
    gateway counters, dead-backend results) by package."""
    out = {}
    for pkg in ("jax", "port"):
        h, eng = _gateway(pkg, models)
        res = _wire(h, _prompts())
        code, _, body = http_get(h.host, h.port, "/healthz")
        health = (code, json.loads(body)["state"])
        series = _gateway_series(h)
        eng._health = "dead"
        r = http_completion(h.host, h.port, {"prompt": [1, 2, 3],
                                             "max_tokens": 2})
        code, _, body = http_get(h.host, h.port, "/healthz")
        dead = (r["code"], r["retry_after"] is not None, code,
                json.loads(body)["state"])
        h.stop()
        out[pkg] = (res, health, series, dead)
    return out


def test_streams_and_bodies_match_jax(wired):
    jres, tres = wired["jax"][0], wired["port"][0]
    assert tres == jres
    for i in range(len(_prompts())):
        code, toks, finish = tres[f"stream{i}"]
        assert code == 200 and len(toks) == 6 and finish == "length"
    assert tres["plain"][0] == 200 and len(tres["plain"][1]) == 3


def test_shed_is_429_with_retry_after_in_both(wired):
    code, retry, toks = wired["port"][0]["shed"]
    assert code == 429 and retry is not None and retry >= 1 and toks == []
    assert wired["port"][0]["shed"] == wired["jax"][0]["shed"]


def test_healthz_and_gateway_counters_match(wired):
    assert wired["port"][1] == wired["jax"][1] == (200, "healthy")
    jser, tser = wired["jax"][2], wired["port"][2]
    assert tser == jser
    assert any(k[0].startswith("serving_gateway_requests") for k in tser)


def test_dead_backend_is_503_with_retry_after_in_both(wired):
    assert wired["port"][3] == wired["jax"][3]
    code, retry, hcode, state = wired["port"][3]
    assert code == 503 and retry and hcode == 503 and state == "dead"


def test_seeded_gateway_streams_match_jax(models):
    """A temperature gateway seeded 7: the port's key is JAX's bit for
    bit, and the streams sampled with it are equal."""
    assert (key_to_numpy(PRNGKey(7))
            == np.asarray(jax.random.PRNGKey(7))).all()
    streams = {}
    for pkg in ("jax", "port"):
        h, _ = _gateway(pkg, models, seed=7)
        streams[pkg] = [http_completion(h.host, h.port, {
            "uid": 300 + i, "prompt": p, "max_tokens": 8,
            "stream": True})["tokens"] for i, p in enumerate(_prompts()[:3])]
        h.stop()
    assert streams["port"] == streams["jax"]
    assert all(len(s) == 8 for s in streams["port"])


def test_gateway_entry_point_raises_without_a_card(monkeypatch):
    """``python -m deepspeed_tpu_torch.gateway`` builds its demo engine
    on the card unless given ``--device cpu``."""
    from deepspeed_tpu_torch.gateway.__main__ import main
    from deepspeed_tpu_torch.platform.cuda import NoCudaDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        main(["--port", "0"])


def _fleet_gateway(pkg, models):
    """(handle, router) of a gateway over a two-replica fleet with SLO
    scorecards on, the ops plane on."""
    jm, pm = models
    if pkg == "jax":
        from deepspeed_tpu.serving import FleetRouter as JaxRouter
        router = JaxRouter({f"r{i}": JaxEngine(jm, JaxConfig(
            **ENGINE, kv_dtype=jnp.float32, param_dtype=jnp.float32,
            attn_impl="xla", slo="on")) for i in range(2)})
        return jax_spawn(router, JaxGatewayConfig(
            install_signals=False, ops="on")), router
    from deepspeed_tpu_torch.serving import FleetRouter
    router = FleetRouter({f"r{i}": InferenceEngine(pm, InferenceConfig(
        **ENGINE, kv_dtype=torch.float32, param_dtype=torch.float32,
        slo="on")) for i in range(2)})
    return spawn_gateway(router, GatewayConfig(
        install_signals=False, ops="on")), router


def test_fleet_backed_gateway_matches_jax(models):
    """The gateway over a two-replica fleet in both packages: the same
    requests (two sharing a prefix, so affinity places them together),
    then one replica killed and two more requests: equal streams and
    placements, equal ``/debug/slo`` evaluation counts, equal
    ``/healthz`` states, equal integer gateway and fleet series (but
    the compile counters: the JAX engines compile on the CPU, the port
    captures CUDA graphs on the card only)."""
    prompts = _prompts()
    prompts.append(prompts[2][:16] + [3, 4, 5])        # shares 2 blocks
    out = {}
    for pkg in ("jax", "port"):
        h, router = _fleet_gateway(pkg, models)
        res = []
        for i, p in enumerate(prompts):
            r = http_completion(h.host, h.port, {
                "uid": 400 + i, "prompt": p, "max_tokens": 5,
                "stream": True})
            res.append((r["code"], r["tokens"]))
        router.replica("r0").engine.failures.inject("fatal")
        for i, p in enumerate(prompts[:2]):
            r = http_completion(h.host, h.port, {
                "uid": 500 + i, "prompt": p, "max_tokens": 4,
                "stream": True})
            res.append((r["code"], r["tokens"]))
        code, _, body = http_get(h.host, h.port, "/debug/slo")
        card = json.loads(body)
        evaluated = {cls: {o: v["evaluated"]
                           for o, v in c["objectives"].items()}
                     for cls, c in card["classes"].items()}
        code_h, _, body_h = http_get(h.host, h.port, "/healthz")
        series = _gateway_series(h)
        code_m, _, text = http_get(h.host, h.port, "/metrics")
        parse = jparse if pkg == "jax" else tparse
        fleet = {k: v for name, fam in parse(text.decode()).items()
                 if name.startswith("serving_fleet_")
                 and fam["type"] != "histogram" and "_ms" not in name
                 and "compile" not in name
                 for k, v in fam["samples"].items()
                 if float(v).is_integer()}
        h.stop()
        out[pkg] = (res, evaluated, code_h, json.loads(body_h)["state"],
                    series, fleet, router.replica("r0").dead)
    for got, want in zip(out["port"], out["jax"]):
        if isinstance(want, dict):
            assert {k: got.get(k) for k in want} == want
        else:
            assert got == want
    res, evaluated, code_h, state, _, fleet, dead = out["port"]
    assert all(code == 200 for code, _ in res) and dead
    assert code_h == 200 and state in ("healthy", "degraded")
    assert any(v for c in evaluated.values() for v in c.values())
    assert any(k[0] == "serving_fleet_placement_affinity_hits_total"
               and v > 0 for k, v in fleet.items())
