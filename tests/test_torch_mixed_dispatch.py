"""Which K3 design (the int8/int4 mixed-input GEMM of
``deepspeed_tpu_torch/ops/csrc/mixed_gemm.cu``) runs at which shape, read
from the wrapper and the sources on the CPU (the kernels themselves run
only on the card: tests/test_torch_kernels_cuda.py).

* Every ``[K, N]`` that ``shape_error`` accepts has a design at every M,
  and the decode design's plan (M tiles, split along K, workspace) is one
  the C entry takes.
* ``chip_smoke.py`` names the design ``design_for`` picks at every phase-3
  shape, and the kernel names its profile groups by are the ones the C
  entry launches for each design.
* ``sm90_wgmma.cuh`` is what ``gen_sm90_wgmma.py`` writes.
"""

import functools
import importlib
import importlib.util
import inspect
import re
from pathlib import Path

import pytest

from deepspeed_tpu_torch.ops.builder import CSRC_DIR
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

# the module (the package re-exports its functions under other names)
mg = importlib.import_module("deepspeed_tpu_torch.ops.mixed_gemm")

REPO = Path(__file__).resolve().parent.parent
# the H100's SM count, and a smaller card's
SMS = (132, 66)
MS = (1, 8, 9, 16, 17, 32, 33, 64, 77, 1024)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mixed",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source():
    return (CSRC_DIR / "mixed_gemm.cu").read_text()


def _function_body(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("N", [16, 48, 128, 512, 1024, 4096, 14336])
@pytest.mark.parametrize("K", [32, 64, 96, 128, 512, 1024, 4096, 14336])
def test_every_accepted_shape_has_a_design(K, N, int4):
    if mg.shape_error(K, N, int4) is not None:
        # of this grid only int4 at K % 64 != 0 is refused
        assert int4 and K % 64
        return
    rows = K // 2 if int4 else K
    for M in MS:
        design = mg.design_for(M)
        assert design in mg.DESIGNS
        if design == "prefill":
            assert M > mg.DECODE_MAX_M
            for sms in SMS:
                rows = mg.prefill_rows(M, N, sms)
                assert rows in mg.PREFILL_ROWS
                # 256-row tiles only where M needs more than one 128-row
                # tile and a tile is left for every two SMs
                tiles = -(-M // rows) * -(-N // mg.PREFILL_COLS)
                assert rows == 128 or (M > 128 and 2 * tiles >= sms)
            continue
        # the decode design holds M in up to 4 tiles of 8 rows
        assert 1 <= M <= mg.DECODE_MAX_M <= 32
        for sms in SMS:
            split = mg.decode_split(M, K, N, int4, sms)
            # at least one 32-row code tile a block
            assert 1 <= split <= rows // mg.DECODE_ROWS
            # the fp32 partials (8 split M bytes a column, written and
            # read) within a quarter of the code bytes, unless the split
            # is 1 (no partials)
            assert split == 1 or 32 * split * M <= rows


def test_decode_threshold_and_limits_match_the_c_entry():
    body = _function_body(_source(), "cudaError_t launch(")
    # design 1 is the prefill launcher at 128- or 256-row tiles (one or
    # two 64-row products a warpgroup); the decode launcher takes M <= 32
    # in tiles of 8, 16 and 32 rows and a split of 1..stages
    assert "if (design == 1) {" in body
    assert "if (tile_m == 256)\n      return prefill_launch<INT4, 2, OutT>" in body
    assert "if (tile_m == 128)\n      return prefill_launch<INT4, 1, OutT>" in body
    assert mg.PREFILL_ROWS == (128, 256)
    assert mg.DESIGNS == {"decode": 0, "prefill": 1}
    assert "M > 32" in body and "split > stages" in body
    for mt, bound in ((1, "M <= 8"), (2, "M <= 16"), (4, None)):
        assert f"decode_launch<{mt}, INT4, OutT>" in body
        if bound:
            assert bound in body
    assert mg.DECODE_MAX_M <= 32
    src = _source()
    assert f"constexpr int kStrip = {mg.DECODE_STRIP};" in src
    assert f"constexpr int kRows = {mg.DECODE_ROWS};" in src
    assert f"constexpr int BN = {mg.PREFILL_COLS}, BK = 64;" in src
    assert "static constexpr int BM = 128 * MI;" in src


@pytest.mark.parametrize("M", [8, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_chip_smoke_names_the_design_design_for_picks(bits, M):
    cs = _chip_smoke()
    assert M in cs.MIXED_M
    # each phase-3 line names the design the wrapper picks
    assert "design = mg.design_for(M)" in inspect.getsource(
        cs.check_mixed_case)
    design = mg.design_for(M)
    assert design == ("decode" if M <= 32 else "prefill")
    # the profile's group of that design is the kernel its launcher runs
    kernel = cs.MIXED_KERNELS[design]
    launcher = _function_body(_source(), f"cudaError_t {design}_launch(")
    assert f"auto kernel = {kernel}<" in launcher
    assert re.search(rf"__global__ void[^;]*\n{kernel}\(", _source())
    groups = [g for g, _ in cs.KERNEL_GROUPS]
    assert groups.index(f"mixed gemm {design}") < groups.index("GEMM")


def test_chip_smoke_times_every_projection_of_a_llama_layer():
    cs = _chip_smoke()
    names = {name for name, _, _ in cs.MIXED_PROJECTIONS}
    assert names == {"wi", "mlp wo", "wq", "wk", "attn wo"}
    assert cs.PROJECTIONS_PER_LAYER == 7     # wq wk wv wo wi wg mlp-wo


def test_sm90_wgmma_header_is_what_the_generator_writes():
    spec = importlib.util.spec_from_file_location(
        "gen_sm90_wgmma", CSRC_DIR / "gen_sm90_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (CSRC_DIR / "sm90_wgmma.cuh").read_text() == gen.render()
