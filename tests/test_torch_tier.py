"""The KV block tier in the port held against the JAX package's: the same
operations on ``KVBlockTier`` of both packages (the host ring, the
checksum contract, export and import, the NVMe spill through each
package's aio pool) give the same events, digests, payload bytes and
``stats()``; the engine's config gates; and engines with
``kv_tier="on"``: an evicted chain demoted and revived gives the streams
of a pool that never evicts, and the JAX engine's streams and tier
counters on the same traffic; ``handoff_out`` -> ``export_tier_chain``
-> ``load_snapshot(tier_blocks)`` moves the prefilled blocks into a
second engine (from a JAX engine too), and a tampered record is refused.
Streams token-identical (fp32 engines)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import tests.test_inference as jax_inference
from deepspeed_tpu.inference import InferenceConfig as JaxConfig
from deepspeed_tpu.inference import InferenceEngine as JaxEngine
from deepspeed_tpu.inference import SamplingParams as JaxSampling
from deepspeed_tpu.inference.ragged import tier as jax_tier
from deepspeed_tpu.inference.ragged.state import \
    chain_hash as jax_chain_hash
from deepspeed_tpu_torch.inference import (InferenceConfig, InferenceEngine,
                                           SamplingParams)
from deepspeed_tpu_torch.inference.ragged import tier as port_tier
from deepspeed_tpu_torch.inference.ragged.state import (chain_hash,
                                                        prefix_chain_digests)
from deepspeed_tpu_torch.models import (Model, TransformerConfig,
                                        params_from_numpy)
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

_ROOT = b"\x00" * 16
TIERS = {"jax": jax_tier, "port": port_tier}


def _leaves(seed, nbytes=512):
    r = np.random.RandomState(seed)
    return [r.randn(nbytes // 8).astype(np.float32),
            r.randn(nbytes // 8).astype(np.float32)]


ONE = sum(a.nbytes for a in _leaves(0))


def _put(tier, seed, parent=_ROOT):
    tokens = [seed, seed + 1]
    d = chain_hash(parent, tokens)
    return d, tier.put(parent, d, tokens, _leaves(seed))


def _revive(tier, d):
    """(source, leaves' bytes) of a revive of ``d``, or None."""
    op = tier.begin_revive(d)
    if op is None:
        return None
    out = tier.resolve(op)
    return op.source, None if out is None else [a.tobytes() for a in out]


def _nvme(mod, tmp, n_ram=1, nvme=1 << 20):
    return mod.KVBlockTier(ram_bytes=n_ram * ONE, nvme_dir=str(tmp),
                           nvme_bytes=nvme)


def _corrupt(path, at, data):
    with open(path, "r+b") as f:
        f.seek(at)
        f.write(data)


# each scenario runs on one package's tier module and returns a transcript
def s_roundtrip(mod, tmp):
    tier = mod.KVBlockTier(ram_bytes=1 << 20)
    d, ev = _put(tier, 1)
    t = [ev, d in tier, len(tier), sorted(tier.digests())]
    return t + [_revive(tier, d), d in tier, len(tier), tier.stats()]


def s_duplicate(mod, tmp):
    tier = mod.KVBlockTier(ram_bytes=1 << 20)
    d, _ = _put(tier, 2)
    return [tier.put(_ROOT, d, [2, 3], _leaves(2)), len(tier)]


def s_ring_overflow(mod, tmp):
    tier = mod.KVBlockTier(ram_bytes=2 * ONE)
    ds = [_put(tier, s) for s in (10, 20, 30)]
    return [ev for _, ev in ds] + [d in tier for d, _ in ds] + [tier.stats()]


def s_oversize(mod, tmp):
    tier = mod.KVBlockTier(ram_bytes=64)
    return [_put(tier, 3)[1], len(tier)]


def s_miss(mod, tmp):
    return [mod.KVBlockTier(ram_bytes=1 << 20).begin_revive(b"\x01" * 16)]


def s_tampered_ram(mod, tmp):
    tier = mod.KVBlockTier(ram_bytes=1 << 20)
    d, _ = _put(tier, 4)
    tier._ram[d].leaves[0][0] += 1.0
    return [_revive(tier, d), tier.stats()]


def s_verify_record(mod, tmp):
    tokens, leaves = [5, 6], _leaves(5)
    rec = {"digest": chain_hash(_ROOT, tokens), "parent": _ROOT,
           "tokens": tokens, "leaves": leaves,
           "checksum": mod.payload_checksum(leaves)}
    v = mod.KVBlockTier.verify_record
    return [rec["checksum"], v(rec),
            v(dict(rec, digest=chain_hash(_ROOT, [9, 9]))),
            v(dict(rec, leaves=[leaves[0] + 1, leaves[1]])), v({}),
            v(dict(rec, tokens="xx"))]


def s_export_insert(mod, tmp):
    src = mod.KVBlockTier(ram_bytes=1 << 20)
    dst = mod.KVBlockTier(ram_bytes=1 << 20)
    d, _ = _put(src, 7)
    rec = src.export(d)
    return [d in src, mod.KVBlockTier.verify_record(rec),
            [a.tobytes() for a in rec["leaves"]], dst.insert_record(rec),
            _revive(dst, d), src.export(b"\x02" * 16)]


def s_nvme_spill_revive(mod, tmp):
    tier = _nvme(mod, tmp)
    d0, _ = _put(tier, 40)
    _, ev = _put(tier, 50)
    tier._drain_io()
    path = os.path.join(str(tmp), d0.hex() + ".kv")
    t = [ev, os.path.exists(path), tier.stats()]
    with open(path, "rb") as f:
        t.append(f.read())
    return t + [_revive(tier, d0), os.path.exists(path), tier.stats()]


def s_corrupted_spill(mod, tmp):
    tier = _nvme(mod, tmp)
    d0, _ = _put(tier, 60)
    _put(tier, 70)
    tier._drain_io()
    _corrupt(tier._nvme[d0].path, 100, b"\xff\xff")
    return [_revive(tier, d0), tier.stats()]


def s_corrupted_export(mod, tmp):
    tier = _nvme(mod, tmp)
    d0, _ = _put(tier, 80)
    _put(tier, 90)
    tier._drain_io()
    _corrupt(tier._nvme[d0].path, 50, b"\x00\x00\x00")
    return [tier.export(d0), d0 in tier, tier.stats()]


def s_missing_file(mod, tmp):
    tier = _nvme(mod, tmp)
    d0, _ = _put(tier, 95)
    _put(tier, 96)
    tier._drain_io()
    os.remove(tier._nvme[d0].path)
    return [_revive(tier, d0), tier.stats()]


def s_drop_in_flight(mod, tmp):
    tier = _nvme(mod, tmp)
    d0, _ = _put(tier, 300)
    _put(tier, 310)
    ent = tier._nvme[d0]
    t = [ent.iobuf is not None]
    tier._drop(d0)
    t += [d0 in tier, tier._io_pending]
    tier._drain_io()
    return t + [os.path.exists(ent.path), tier.stats()]


def s_nvme_budget(mod, tmp):
    tier = _nvme(mod, tmp, nvme=2 * ONE)
    ds = [_put(tier, 100 + 10 * i)[0] for i in range(5)]
    tier._drain_io()
    return [d in tier for d in ds] + [tier.stats()]


SCENARIOS = {f.__name__[2:]: f for f in (
    s_roundtrip, s_duplicate, s_ring_overflow, s_oversize, s_miss,
    s_tampered_ram, s_verify_record, s_export_insert, s_nvme_spill_revive,
    s_corrupted_spill, s_corrupted_export, s_missing_file, s_drop_in_flight,
    s_nvme_budget)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tier_matches_jax(name, tmp_path):
    """The same operations on both packages' tiers: equal transcripts
    (events, membership, payload and spill-file bytes, stats), and the
    JAX package's chain digests."""
    got = {pkg: SCENARIOS[name](mod, tmp_path / pkg)
           for pkg, mod in TIERS.items()}
    assert got["port"] == got["jax"]
    assert chain_hash(_ROOT, [1, 2]) == jax_chain_hash(_ROOT, [1, 2])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

ENGINE = dict(token_budget=32, max_seqs=2, kv_block_size=8)
SP = dict(max_new_tokens=4)


@pytest.fixture(scope="module")
def models():
    jm = jax_inference.tiny_model()
    cfg = TransformerConfig(**dataclasses.asdict(jm.config))
    params = params_from_numpy(jax.tree.map(np.asarray, jm.params),
                               device="cpu")
    return jm, Model.from_params(cfg, params)


def _port(port, **over):
    kw = dict(ENGINE, num_kv_blocks=64, kv_dtype=torch.float32,
              param_dtype=torch.float32)
    kw.update(over)
    return InferenceEngine(port, InferenceConfig(**kw))


def _jax(jm, **over):
    kw = dict(ENGINE, num_kv_blocks=64, kv_dtype=jax.numpy.float32,
              param_dtype=jax.numpy.float32, attn_impl="xla")
    kw.update(over)
    return JaxEngine(jm, JaxConfig(**kw))


def _traffic():
    """A 4-block family prompt, fillers that evict it from a 12-block
    pool, then the family again."""
    r = np.random.RandomState(41)
    fam = [int(x) for x in r.randint(1, 120, 32)]
    fill = [[int(x) for x in np.random.RandomState(600 + i).randint(
        1, 120, 44)] for i in range(3)]
    return [{0: fam + [5, 6, 7]}] + [{1 + i: f} for i, f in
                                     enumerate(fill)] + [{9: fam + [5, 6, 9]}]


def _run(eng, sp):
    out = {}
    for batch in _traffic():
        out.update(eng.generate({u: list(p) for u, p in batch.items()}, sp))
    return out


TIER_KW = dict(num_kv_blocks=12, kv_tier="on")
RING = 6.5          # blocks the host ring holds: the family's newest two
COUNTERS = ("kv_tier_demotions", "kv_tier_spills", "kv_tier_drops",
            "kv_tier_revives_ram", "kv_tier_revives_nvme",
            "kv_tier_revives_remote", "kv_tier_restage_overlap_hits",
            "kv_tier_verify_failures", "kv_tier_demoted_bytes",
            "kv_tier_spilled_bytes")


@pytest.fixture(scope="module")
def jax_tiered(models, tmp_path_factory):
    """The JAX engine with the tier on over the traffic: its streams and
    counters, the ring holding 6 blocks and spilling to files."""
    jm, _ = models
    eng = _jax(jm, **TIER_KW, kv_tier_ram_mb=RING * _block_bytes(jm) / 2**20,
               kv_tier_dir=str(tmp_path_factory.mktemp("jax_tier")))
    out = _run(eng, JaxSampling(**SP))
    return out, {k: int(eng.timings[k]) for k in COUNTERS}


def _block_bytes(jm):
    c = jm.config
    return c.num_layers * 8 * 2 * c.num_kv_heads * c.head_dim * 4


@pytest.mark.parametrize("offload", [False, True], ids=["device", "host"])
def test_evicted_chain_revives_as_jax(models, jax_tiered, offload, tmp_path):
    """The family's chain is evicted, demoted (the newest blocks into the
    ring, the oldest spilled to files) and revived from both when it
    returns: the streams equal a 64-block pool's (no eviction) and the
    JAX engine's, and the tier counters equal the JAX engine's (the cache
    in host memory too)."""
    jm, port = models
    want = _run(_port(port), SamplingParams(**SP))
    eng = _port(port, **TIER_KW, kv_offload=offload,
                kv_tier_ram_mb=RING * _block_bytes(jm) / 2**20,
                kv_tier_dir=str(tmp_path / "tier"))
    got = _run(eng, SamplingParams(**SP))
    jout, jcount = jax_tiered
    assert got == want == jout
    counts = {k: int(eng.timings[k]) for k in COUNTERS}
    assert counts == jcount
    assert counts["kv_tier_revives_ram"] and counts["kv_tier_revives_nvme"]
    assert eng.metrics.get("serving_kv_tier_demotions_total").value() == \
        counts["kv_tier_demotions"]
    eng.state.allocator.assert_invariants()


def test_config_gates(models):
    jm, port = models
    with pytest.raises(ValueError, match="kv_tier"):
        _port(port, kv_tier="always")
    with pytest.raises(ValueError, match="prefix"):
        _port(port, kv_tier="on", prefix_cache="off")
    assert _port(port, kv_tier="auto").state.tier is None
    assert _port(port, kv_tier="on").state.tier is not None


def _handoff(src, prompt, sp):
    """Prefill ``prompt`` on ``src`` and hand it off: (the partial
    snapshot with the exported tier chain, the first token)."""
    src.put(0, prompt)
    out = {}
    while 0 not in out:                 # the prompt is chunked: 2 steps
        out = src.step(sampling=sp)
    first = out[0]
    src.put(0, [first])
    part = src.handoff_out([0])
    exp = src.export_tier_chain(prefix_chain_digests(prompt, 8))
    part["tier_blocks"] = exp["tier_blocks"]
    return part, first


@pytest.mark.parametrize("source", ["port", "jax"])
def test_handoff_ships_the_prefilled_chain(models, source):
    """handoff_out stages the request's indexed blocks into the tier,
    export_tier_chain ships them, load_snapshot(merge=True) imports them
    into a second port engine, which restages them (remote revives) and
    finishes the stream as an uninterrupted run; a tampered record makes
    load_snapshot refuse the whole payload."""
    jm, port = models
    prompt = [int(x) for x in np.random.RandomState(3).randint(1, 120, 35)]
    sp = SamplingParams(max_new_tokens=6)
    want = _port(port).generate({0: list(prompt)}, sp)[0]
    if source == "port":
        part, first = _handoff(_port(port, kv_tier="on"), prompt, sp)
    else:
        part, first = _handoff(_jax(jm, kv_tier="on"), prompt,
                               JaxSampling(max_new_tokens=6))
    assert len(part["tier_blocks"]) == 4 and first == want[0]
    dst = _port(port, kv_tier="on")
    bad = dict(part, tier_blocks=[dict(part["tier_blocks"][0], leaves=[
        a + 1 for a in part["tier_blocks"][0]["leaves"]])])
    with pytest.raises(ValueError, match="tier_blocks"):
        dst.load_snapshot(bad, merge=True)
    assert not dst._pending and len(dst.state.tier) == 0
    dst.load_snapshot(part, merge=True)
    assert dst.timings["kv_tier_remote_blocks"] == 4
    out = [first]
    while len(out) < 6:
        res = dst.step(sampling=sp)
        if 0 in res:
            out.append(res[0])
            dst.put(0, [res[0]])
    assert out == want
    assert dst.timings["kv_tier_revives_remote"] == 4
    assert dst.timings["cached_tokens"] == 32
