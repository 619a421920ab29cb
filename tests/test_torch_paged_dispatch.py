"""K2's plan (which tokens go to which design of
``deepspeed_tpu_torch/ops/csrc/paged_attention.cu``), read on the CPU
through its PyTorch twin ``plan_plain``; the card test
``test_paged_attention_device_plan_equals_plan_plain``
(tests/test_torch_kernels_cuda.py) holds the plan kernel equal to it.

* Over the layouts ``build_batch`` makes (prefill chunks, a chunk beside
  decode tokens, decode only, a verify window, an aliased prefix), every
  (token, head) row is covered by exactly one tile, a tile never spans two
  runs, and a split tile's splits cover its blocks 0 .. pos // bs in
  order, once each.
* Every serving preset's head dim and GQA ratio passes the wrapper's
  shape checks and has a design, falcon-7b's rep 71 and D 32 / 80 / 96 /
  256 among them.
* ``chip_smoke.py`` names the designs the plan gives at each phase-3 K2
  case, and the kernels its profile groups are the ones the C entries
  launch.
"""

import functools
import importlib
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from deepspeed_tpu_torch.inference.ragged.state import (KVCacheConfig,
                                                        StateManager)
from deepspeed_tpu_torch.models.presets import PRESETS, build_config
from deepspeed_tpu_torch.ops.builder import CSRC_DIR

# the module (the package re-exports the wrapper under the same name)
pa = importlib.import_module("deepspeed_tpu_torch.ops.paged_attention")

REPO = Path(__file__).resolve().parent.parent
BS = 8
SMS = (132, 66)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_paged",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source():
    return (CSRC_DIR / "paged_attention.cu").read_text()


def _state():
    return StateManager(KVCacheConfig(num_layers=1, num_kv_heads=1,
                                      head_dim=8, block_size=BS,
                                      num_blocks=96, dtype=torch.float32,
                                      device="cpu"),
                        max_seqs=6, prefix_cache=True)


def _toks(n, start=1):
    return list(range(start, start + n))


def _layouts():
    """name -> (seq_slot, positions) of the batches build_batch lays out."""
    out = {}
    sm = _state()
    b = sm.build_batch([(0, _toks(40)), (1, _toks(21, 100))], 128)
    out["prefill chunks"] = b
    b = sm.build_batch([(0, _toks(1, 7)), (1, _toks(30, 200)),
                        (2, _toks(5, 300))], 128)
    out["chunk + decode"] = b
    b = sm.build_batch([(0, _toks(1, 8)), (1, _toks(1, 9)),
                        (2, _toks(1, 10))], 128)
    out["decode only"] = b
    b = sm.build_batch([(0, _toks(4, 11)), (2, _toks(1, 12))], 128)
    out["verify window"] = b
    # a new sequence whose first 4 blocks alias sequence 0's
    prompt = _toks(32) + _toks(9, 500)
    cached = sm.match_prefix(3, prompt)
    assert cached == 32
    b = sm.build_batch([(3, prompt[cached:]), (1, _toks(1, 13))], 128)
    out["aliased prefix"] = b
    return {k: (v.seq_slot[:v.n_tokens], v.positions[:v.n_tokens],
                v.block_tables) for k, v in out.items()}


LAYOUTS = _layouts()


def _runs(slots, pos):
    """[(t0, n)] of maximal runs: same slot, consecutive positions."""
    runs, t0 = [], 0
    for t in range(1, len(pos) + 1):
        if t == len(pos) or slots[t] != slots[t - 1] \
                or pos[t] != pos[t - 1] + 1:
            runs.append((t0, t - t0))
            t0 = t
    return runs


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("rep, Hkv", [(1, 4), (4, 2), (7, 2), (71, 1)])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_covers_every_row_once_within_runs(layout, rep, Hkv, sms):
    slots, pos, tables = LAYOUTS[layout]
    slots, pos = slots.tolist(), pos.tolist()
    nb = tables.shape[1]
    items = pa.plan_plain(slots, pos, rep, BS, nb, pa.items_target(Hkv, sms))
    assert items.shape[0] <= pa.max_items(len(pos), rep,
                                          pa.items_target(Hkv, sms))
    runs = dict(_runs(slots, pos))
    covered = {}
    units = {}
    for t0, n, row0, b0, b1, split, nsplit, slot in items.tolist():
        # a tile's tokens are one run, as the plan's runs are build_batch's
        assert runs.get(t0) == n
        design = pa.design_for(n, rep)
        tile = pa.DECODE_ROWS if design == "decode" else pa.CHUNK_ROWS
        assert row0 % tile == 0 and row0 < n * rep
        units.setdefault((t0, row0), []).append((split, nsplit, b0, b1,
                                                 slot))
        if split:
            continue
        for f in range(row0, min(row0 + tile, n * rep)):
            key = (t0 + f // rep, f % rep)
            covered[key] = covered.get(key, 0) + 1
    assert covered == {(t, r): 1 for t in range(len(pos))
                       for r in range(rep)}
    slots_used = []
    for (t0, row0), splits in units.items():
        n = runs[t0]
        nsplit = splits[0][1]
        assert [s for s, *_ in splits] == list(range(nsplit))
        rows = min(pa.DECODE_ROWS if pa.design_for(n, rep) == "decode"
                   else pa.CHUNK_ROWS, n * rep - row0)
        last = pos[t0 + min(n - 1, (row0 + rows - 1) // rep)]
        need = min(last // BS + 1, nb)
        # the splits cover blocks 0 .. need - 1 in order, once each
        edges = [(b0, b1) for _, _, b0, b1, _ in splits]
        assert edges[0][0] == 0 and edges[-1][1] == need
        assert all(a[1] == b[0] and a[0] < a[1]
                   for a, b in zip(edges, edges[1:]))
        if nsplit > 1:
            # only a decode tile or a single token's tiles split
            assert pa.design_for(n, rep) == "decode" or n == 1
            slots_used += [slot for *_, slot in splits]
        else:
            assert splits[0][4] == -1
    # each split item has a workspace slot of its own, within the bound
    assert sorted(slots_used) == list(range(len(slots_used)))
    assert len(slots_used) <= 2 * pa.items_target(Hkv, sms)


def test_plan_splits_decode_tokens_to_fill_the_card():
    """8 decode tokens of Llama-3-8B (8 KV heads) at ~520 keys: 24 items a
    head, 192 blocks on 132 SMs; falcon-7b (1 KV head, 71 rows a token):
    two chunk tiles a token, split one block each."""
    pos = [512 + 4 * i for i in range(8)]
    items = pa.plan_plain(range(8), pos, 4, 64, 16, pa.items_target(8, 132))
    assert pa.designs_of(items, 4) == {"chunk": 0, "decode": 24}
    assert set(items[:, 6].tolist()) == {3}
    items = pa.plan_plain(range(8), pos, 71, 64, 16, pa.items_target(1, 132))
    assert pa.designs_of(items, 71) == {"chunk": 144, "decode": 0}
    assert set(items[:, 6].tolist()) == {9}
    assert set((items[:, 4] - items[:, 3]).tolist()) == {1}


def _serving_presets():
    out = {}
    for name in sorted(PRESETS):
        cfg = build_config(name)
        out[name] = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    return out


def test_every_preset_head_dim_and_gqa_ratio_has_a_design():
    shapes = _serving_presets()
    seen_d = {D for _, _, D in shapes.values()}
    assert seen_d == {32, 64, 80, 96, 128, 256} == set(pa.HEAD_DIMS)
    assert shapes["falcon-7b"] == (71, 1, 64)
    assert shapes["qwen2-7b"] == (28, 4, 128)
    for name, (H, Hkv, D) in shapes.items():
        for bs in (1, 16, 64, 256):
            assert pa.shape_error(H, Hkv, D, bs) is None, name
        rep = H // Hkv
        # a decode token and a prefill chunk each have a design
        assert pa.design_for(1, rep) in pa.DESIGNS
        assert pa.design_for(512, rep) == "chunk"
    assert pa.shape_error(8, 1, 48, 16) is not None          # no such D
    assert pa.shape_error(8, 3, 64, 16) is not None          # H % Hkv
    assert pa.shape_error(pa.MAX_REP + 1, 1, 64, 16) is not None
    assert pa.shape_error(8, 1, 64, pa.MAX_BLOCK_SIZE + 1) is not None


def test_c_source_matches_the_wrapper():
    src = _source()
    for const, value in (("kChunkRows", pa.CHUNK_ROWS),
                         ("kDecodeRows", pa.DECODE_ROWS),
                         ("kItemInts", pa.ITEM_INTS),
                         ("kHeaderInts", pa._HEADER_INTS),
                         ("kMaxBlockSize", pa.MAX_BLOCK_SIZE)):
        assert re.search(rf"constexpr int {const} = {value};", src), const
    for D in pa.HEAD_DIMS:
        assert f"case {D}: return launch_d<{D}>(" in src
    for entry in ("paged_attention_bf16", "paged_attention_quant",
                  "paged_attention_plan"):
        assert f'extern "C" int {entry}(' in src


@pytest.mark.parametrize("case", range(14))
def test_chip_smoke_names_the_designs_the_plan_gives(case):
    """Each phase-3 K2 line names the designs the plan gives its batch:
    both designs on a mixed batch at rep <= 16, the decode design alone on
    a decode batch, split into one wave of two blocks an SM at most;
    chunk tiles alone at falcon-7b's rep 71."""
    cs = _chip_smoke()
    assert len(cs.K2_CASES) == 14
    name, (H, Hkv, D, bs, nblk, _), _ = cs.K2_CASES[case]
    make = cs.decode_batch if "decode" in name else cs.mixed_batch
    # the plan reads slots and positions only: a narrow cache will do
    batch = make(torch, H, Hkv, 8, bs, nblk, 0, "cpu")
    label, by, splits = cs.k2_plan(torch, batch, H, Hkv)
    rep = H // Hkv
    if rep > pa.DECODE_ROWS:
        assert label == "chunk" and by["decode"] == 0
    elif "decode" in name:
        assert label == "decode"
        assert 8 <= by["decode"] * Hkv <= 2 * 132
        assert splits in (0, by["decode"])
    else:
        assert label == "chunk+decode"


def test_chip_smoke_covers_every_head_dim_and_profiles_the_kernels():
    cs = _chip_smoke()
    dims = {D for _, (_, _, D, *_), _ in cs.K2_CASES}
    assert dims == set(pa.HEAD_DIMS) - {32}      # 32: the card tests
    assert any(H // Hkv == 71 for _, (H, Hkv, *_), _ in cs.K2_CASES)
    src = _source()
    for kernel in ("paged_attention_plan_kernel", "paged_attention_kernel"):
        assert re.search(rf"__global__ void[^;]*\n{kernel}\(", src)
        group = next(g for g, subs in cs.KERNEL_GROUPS
                     if any(s in kernel for s in subs))
        assert group == "paged attention"
