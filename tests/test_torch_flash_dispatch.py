"""What the flash-attention libraries are built from and which kernel each
variant runs, read from the sources on the CPU (the kernels themselves run
only on the card: tests/test_torch_kernels_cuda.py).

* Each library's cache key covers every header its sources include,
  directly or through another header: a header left out would leave a
  stale library in ``build/kernels/`` after an edit.
* The design that ``chip_smoke.py`` names for a (kernel, dtype, head dim)
  is the one the C entry points dispatch to.
"""

import functools
import importlib
import importlib.util
import re
from pathlib import Path

import pytest

from deepspeed_tpu_torch.ops.builder import CSRC_DIR

# the module (the package re-exports its function under the same name)
fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")

REPO = Path(__file__).resolve().parent.parent
KINDS = ("fwd", "dq", "dkv")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_dispatch",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _includes(name, seen=None):
    """The repo's headers ``name`` includes, transitively."""
    seen = set() if seen is None else seen
    for inc in re.findall(r'#include "([^"]+)"',
                          (CSRC_DIR / name).read_text()):
        if inc not in seen:
            seen.add(inc)
            _includes(inc, seen)
    return seen


def _function_body(src, signature):
    """The text of the C++ function that starts at ``signature``, up to its
    closing brace at the start of a line."""
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("builder", fa.BUILDERS, ids=lambda b: b.name)
def test_cache_key_covers_every_included_header(builder):
    included = set()
    for source in builder.sources:
        included |= _includes(source)
    assert included <= set(builder.headers), (
        f"{builder.name}: {sorted(included - set(builder.headers))} are "
        "included but not in its cache key")


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_chip_smoke_names_the_design_the_entry_points_run(dtype, D):
    design = _chip_smoke().flash_design
    if dtype == "float32":
        src = (CSRC_DIR / "flash_attention_fp32.cu").read_text()
        # all three register-blocked at every head dim: fwd and dq with the
        # query tiles resident (Rq), dk/dv with the key tiles (Rb)
        for kind, cfg, name in (("fwd", "Rq<D, false>", "fp32-rbq"),
                                ("dq", "Rq<D, true>", "fp32-rbq"),
                                ("dkv", "Rb<D>", "fp32-rb")):
            body = _function_body(src, f"cudaError_t {kind}_launch(")
            assert f"using R = {cfg};" in body
            assert "const int smem = R::SMEM;" in body
            assert f"{kind}32_kernel<D, C><<<" in body
            assert design(f"flash_{kind}", dtype, D) == name
        return
    src = (CSRC_DIR / "flash_attention.cuh").read_text()
    for kind in KINDS:
        body = _function_body(src, f"int {kind}_entry(")
        # D 256 takes the WMMA launcher of this file, every other head dim
        # the wgmma one of flash_attention_sm90.cuh
        wmma, sm90 = body.split("else", 1)
        assert "if constexpr (DD == 256)" in wmma
        assert f"{kind}_launch<T, DD" in wmma and "flash90::" not in wmma
        assert f"flash90::{kind}_launch<T, DD" in sm90
        assert design(f"flash_{kind}", dtype, D) == (
            "wmma" if D == 256 else "wgmma")
