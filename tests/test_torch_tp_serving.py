"""Tensor-parallel serving in the port: ``InferenceEngine(model, cfg,
topology=...)`` on gloo ranks, held against the JAX engine on the same
topology over the virtual CPU mesh (``tests/test_inference_tp.py``'s
cases).  Two topologies: ``tensor=2`` on two ranks and ``tensor=2,
fsdp=2`` on four (rank r is JAX device r).  fp32, as the JAX tests run:
greedy tokens equal on every rank, prefill logits within 1e-4, and
``comm_overlap="on"`` bitwise ``"off"``.

The ranks are spawned once per topology for the module
(``tests/torch_ranks.py``, which imports no JAX) and the JAX references
are computed once per case."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.mesh import MeshTopology as JaxTopology
from deepspeed_tpu.config.config import MeshConfig as JaxMeshConfig
from deepspeed_tpu.inference.engine import InferenceConfig as JaxInference
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.sampler import SamplingParams as JaxSampling
from deepspeed_tpu.models.transformer import Model as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.models import build_config
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)
from tests.torch_ranks import rank_pool

PROMPTS = {0: list(range(1, 20)), 1: list(range(30, 37)),
           2: list(range(100, 103))}
NEW = 8
TOPOLOGIES = {"tp2": (2, dict(tensor=2)), "tp2fsdp2": (4, dict(tensor=2,
                                                               fsdp=2))}


def _cfg(**kw):
    base = dict(vocab_size=256, d_model=64, num_layers=2, num_heads=4,
                num_kv_heads=4, d_ff=128, max_seq_len=128)
    base.update(kw)
    return base


def _icfg(**kw):
    base = dict(token_budget=32, max_seqs=4, kv_block_size=8,
                num_kv_blocks=32)
    base.update(kw)
    return base


# name -> (model config, seed, inference config)
CASES = {
    "dense": (_cfg(), 0, _icfg()),
    "gqa_burst": (_cfg(num_heads=8, num_kv_heads=4), 1,
                  _icfg(decode_burst=4)),
    "alibi": (_cfg(position="alibi", embed_norm=True, attention_impl="xla"),
              2, _icfg()),
    "kv_int8": (_cfg(), 0, _icfg(kv_quant="int8")),
    "weights_int8": (_cfg(), 0, _icfg(weight_quant="int8")),
    "indivisible_heads": (_cfg(d_model=96, num_heads=3, num_kv_heads=3), 2,
                          _icfg()),
}


@functools.lru_cache(maxsize=None)
def _jax_model(case):
    cfg, seed, _ = CASES[case]
    return JaxModel(JaxConfig(**cfg), seed=seed)


def _spec(case, topo, **over):
    cfg, _, icfg = CASES[case]
    jm = _jax_model(case)
    return dict(cfg=cfg, params=jax.tree.map(np.asarray, jm.params),
                axes=jm.param_axes,
                icfg=dict(param_dtype="float32", kv_dtype="float32",
                          **{**icfg, **over}),
                mesh=TOPOLOGIES[topo][1], prompts=PROMPTS, new=NEW)


@functools.lru_cache(maxsize=None)
def _jax_engine_out(case, topo, logits=False):
    """The JAX engine on the same topology: greedy tokens, or the first
    prefill step's logits (row 0), and its cache's per-device shape."""
    n, mesh = TOPOLOGIES[topo]
    _, _, icfg = CASES[case]
    t = JaxTopology.build(JaxMeshConfig(**mesh), devices=jax.devices()[:n])
    eng = JaxEngine(_jax_model(case), JaxInference(
        param_dtype=jnp.float32, kv_dtype=jnp.float32, attn_impl="xla",
        **icfg), topology=t)
    kv = eng.state.kv[0] if isinstance(eng.state.kv, tuple) else eng.state.kv
    shard_shape = tuple(kv.addressable_shards[0].data.shape)
    if logits:
        uid, prompt = next(iter(PROMPTS.items()))
        eng.put(uid, list(prompt))
        b = eng._stage(eng.state.build_batch(eng._schedule(),
                                             eng.icfg.token_budget))
        lg, _ = eng._build_step()(eng.params, eng._quant, eng.state.kv, b)
        return np.asarray(lg)[0], shard_shape
    toks = eng.generate({u: list(p) for u, p in PROMPTS.items()},
                        JaxSampling(temperature=0.0, max_new_tokens=NEW))
    return {u: list(v) for u, v in toks.items()}, shard_shape


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_store")
    made = {}

    def get(topo):
        if topo not in made:
            made[topo] = rank_pool(TOPOLOGIES[topo][0], d)
        return made[topo]

    yield get
    for p in made.values():
        p.close()


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_tokens_match_jax_engine(pools, case, topo, devices):
    """Greedy streams equal the JAX engine's on the same topology, on
    every rank; the cache holds each rank's Hkv/tp heads where the heads
    divide, else all of them (as the JAX engine keeps it replicated)."""
    out = pools(topo).run("serve", _spec(case, topo))
    ref, jshape = _jax_engine_out(case, topo)
    cfg = CASES[case][0]
    split = cfg["num_kv_heads"] % 2 == 0 and cfg["num_heads"] % 2 == 0
    for r, o in enumerate(out):
        assert o["tokens"] == ref, (case, topo, r)
        assert o["kv_shape"][4] == cfg["num_kv_heads"] // (2 if split else 1)
        assert o["kv_shape"][4] == jshape[4]


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_tp_prefill_logits_within_1e4_and_overlap_bitwise(pools, topo,
                                                          devices):
    """The first prefill step's logits within 1e-4 of the JAX engine's;
    the tile-decomposed collectives (``comm_overlap="on"``) bitwise the
    serial ones, on every rank."""
    ref, _ = _jax_engine_out("dense", topo, logits=True)
    pool = pools(topo)
    on = pool.run("serve", {**_spec("dense", topo, comm_overlap="on"),
                            "logits": True})
    off = pool.run("serve", {**_spec("dense", topo, comm_overlap="off"),
                             "logits": True})
    for a, b in zip(on, off):
        assert a["comm"] and not b["comm"]
        np.testing.assert_array_equal(a["logits"], b["logits"])
        np.testing.assert_allclose(a["logits"], ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a["logits"], on[0]["logits"])


def test_chip_smoke_times_k2_at_a_rank_head_group():
    """chip_smoke.py times K2-TP at what serve-tp (a) launches on a rank:
    Llama-3-8B's heads halved (16 query heads over 4 KV heads of 128),
    on the mixed batch (both designs) and the decode batch (the decode
    design alone), as the plan gives them."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tp", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = build_config("llama3-8b")
    tp = cs.TP_MESH["tensor"]
    for name, (H, Hkv, D, bs, nblk, _) in cs.K2_TP_CASES:
        assert (H, Hkv, D) == (cfg.num_heads // tp, cfg.num_kv_heads // tp,
                               cfg.head_dim)
        make = cs.decode_batch if "decode" in name else cs.mixed_batch
        batch = make(torch, H, Hkv, 8, bs, nblk, 0, "cpu")
        label = cs.k2_plan(torch, batch, H, Hkv)[0]
        assert label == ("decode" if "decode" in name else "chunk+decode")


class _Tally:
    def __init__(self):
        self.by_kind = {}

    def inc(self, x, kind=None):
        self.by_kind[kind] = self.by_kind.get(kind, 0) + x


@pytest.mark.parametrize("n", [2, 4, 8])
def test_comm_bytes_count_what_the_rank_ordered_sum_sends(n):
    """``serving_comm_bytes_total`` counts the down-projection's sum as
    the all-gather of every rank's partial that the rank-ordered sum
    sends ((n-1) x the payload a rank), and the logits' all-gather as
    (n-1)/n of the gathered logits."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    L, rows, dm, vocab, lrows = 3, 8, 16, 64, 4
    eng = SimpleNamespace(
        _serving_comm=SimpleNamespace(downproj=True, unembed=True, tiles=2),
        topology=SimpleNamespace(tp_size=n),
        icfg=SimpleNamespace(param_dtype=torch.float32),
        cfg=SimpleNamespace(num_layers=L, d_model=dm, vocab_size=vocab),
        _c_comm_ops=_Tally(), _c_comm_bytes=_Tally(), _c_comm_tiles=_Tally())
    InferenceEngine._count_comm(eng, rows, lrows)
    assert eng._c_comm_bytes.by_kind["exact"] == (
        L * (n - 1) * rows * dm * 4 + (n - 1) / n * lrows * vocab * 4)
    assert eng._c_comm_ops.by_kind["exact"] == L + 1
